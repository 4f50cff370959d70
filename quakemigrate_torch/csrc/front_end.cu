// FE1 and FE2: the onset front ends of detect's fused window, for Hopper
// (sm_90a).
//
// Replace no Pallas kernel: the JAX package computes both front ends as
// XLA code traced into its one jitted detect window,
// quakemigrate_tpu/ops/scan_window.py:123 (fused_onsets, FE1: signal
// transform -> per-slot STA/LTA -> RMS channel combine -> clip) and :166
// (fused_kurtosis_onsets, FE2: the kurtosis characteristic function of
// ops/kurtosis.py:112 -> tapered edges set to 1 -> RMS combine -> clip).
// Their plain versions are quakemigrate_torch/ops/scan_window.py's
// fused_onsets and fused_kurtosis_onsets, in the reference's order of
// additions.
//
// Contract. The order of additions: every windowed sum is a difference
// of a running sum, and the running sum is added as XLA's CPU cumsum adds
// it (ops/rolling.py's blocked_cumsum, the specification): the row padded
// to a multiple of 16, sequential additions inside each block of 16, the
// block totals scanned by the same rule recursively (levels of T/16,
// T/256, ... down to one sequential scan of at most 16), each block's
// exclusive prefix then added to its sums (a zero to the first block's).
// After an event the kurtosis moments cancel, and another order differs
// by ~4e-3 relative, so this order is what makes the card's values the
// CPU's. Every operation rounds where the plain version rounds: the
// arithmetic goes through the _rn intrinsics, which nvcc never contracts
// into an FMA, in the plain version's term order.
//
// Bound. Launches: one a window in place of the plain chain's ~60 (FE1)
// or ~80 plus nsmooth (FE2). The work is a few hundred kB a window (the
// channels read once, the combined onsets written once) and a few dozen
// operations a sample, microseconds of either at the card's rates, so one
// block a slot (26 at Icequake) is enough and the kernel is latency-bound.
//
// Design. One block a slot. Phase 1: a thread a (row, power, block of 16)
// adds its block's total; the totals of all rows of the slot, and their
// levels, are scanned in place in shared memory by the rule above (a
// thread a block of 16 at each level, one thread at the top). Shared
// memory holds only the levels, T/16 * 16/15 values a row and power, so
// day-scale rows (30,000 samples) stage as easily as the archive window's
// 2,038. Phase 2 never stores a running sum: each sum an output needs is
// its block's scanned prefix plus the block's own sequential sum up to
// the sample, recomputed by a walker that moves one sample at a time
// (one addition a step, at most 15 where it enters a block mid-way),
// from the channels, which stay in L1/L2. FE1 gives each thread a block
// of 16 outputs, walks the row's three sums (the sample's, and the
// STA's and LTA's other ends) for every channel in channel order and
// keeps the 16 squared-onset accumulators in registers. FE2 first writes
// each row's rectified kurtosis gradient to a workspace (a thread a row
// and block of 16, walking four powers at both ends of the window, one
// sample of the block before included for the gradient), then after a
// barrier each thread smooths, edges and combines its samples. A live
// slot whose window length is below 1 gets NaN (the kernel reads nothing
// out of its row); a dead slot's onsets are 1.

#include <cuda_runtime.h>

#include "front_end_math.cuh"

#define FE_THREADS 256

// Scan each of the n_arrays stretches of lv's layout in place, level 0
// (the block totals) becoming blocked_cumsum of the totals. Called by the
// whole block, which it leaves synchronised.
template <typename T>
__device__ void fe_scan_levels(T* levels, int n_arrays, const FeLevels& lv) {
  for (int l = 0; l + 1 < lv.count; ++l) {
    const int n = lv.n[l], nt = lv.n[l + 1];
    for (int item = threadIdx.x; item < n_arrays * nt; item += blockDim.x) {
      const int s = item / nt, q = item - s * nt;
      T* a = levels + s * lv.stride + lv.off[l];
      const int end = min(n, (q + 1) * FE_BLOCK);
      T acc = a[q * FE_BLOCK];
      for (int m = q * FE_BLOCK + 1; m < end; ++m) {
        acc = fe_add(a[m], acc);
        a[m] = acc;
      }
      levels[s * lv.stride + lv.off[l + 1] + q] = acc;
    }
    __syncthreads();
  }
  const int top = lv.count - 1;
  for (int s = threadIdx.x; s < n_arrays; s += blockDim.x) {
    T* a = levels + s * lv.stride + lv.off[top];
    for (int m = 1; m < lv.n[top]; ++m) a[m] = fe_add(a[m], a[m - 1]);
  }
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    const int n = lv.n[l];
    for (int item = threadIdx.x; item < n_arrays * n; item += blockDim.x) {
      const int s = item / n, m = item - s * n, q = m / FE_BLOCK;
      T* a = levels + s * lv.stride + lv.off[l];
      const T before =
          q == 0 ? T(0) : levels[s * lv.stride + lv.off[l + 1] + q - 1];
      a[m] = fe_add(a[m], before);
    }
    __syncthreads();
  }
}

// Running sum of one row at a position that moves forward: the block's
// sequential sum up to the sample plus the block's scanned prefix.
template <typename T>
struct FeWalk {
  int k;
  T inner;
};

template <typename T>
__device__ __forceinline__ T fe1_sum_at(FeWalk<T>& w, int k, const T* x,
                                        int mode, const T* prefix,
                                        bool outer) {
  if (k != w.k) {
    if (k == w.k + 1 && (k % FE_BLOCK) != 0) {
      w.inner = fe_add(fe_transform(x[k], mode), w.inner);
    } else {
      const int start = k - k % FE_BLOCK;
      T acc = fe_transform(x[start], mode);
      for (int m = start + 1; m <= k; ++m) {
        acc = fe_add(fe_transform(x[m], mode), acc);
      }
      w.inner = acc;
    }
    w.k = k;
  }
  if (!outer) return w.inner;
  const int q = k / FE_BLOCK;
  return fe_add(w.inner, q == 0 ? T(0) : prefix[q - 1]);
}

template <typename T>
__device__ __forceinline__ void fe_finish(T* out_row, const T* acc, int b,
                                          int t, T n_live, T min_onset) {
#pragma unroll
  for (int j = 0; j < FE_BLOCK; ++j) {
    const int i = b * FE_BLOCK + j;
    if (i < t) {
      out_row[i] = fe_clamp_min(fe_sqrt(fe_div(acc[j], n_live)), min_onset);
    }
  }
}

// The block's preamble: available (block 0), and the slot's fate. Returns
// true where the slot needs its onsets computed.
template <typename T>
__device__ bool fe_slot_live(const T* slot_mask, T* available, T* out_row,
                             int n_slots, int t, bool lengths_ok) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    T sum = T(0);
    for (int s = 0; s < n_slots; ++s) sum = fe_add(sum, slot_mask[s]);
    *available = sum;
  }
  if (slot_mask[blockIdx.x] != T(1)) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) out_row[i] = T(1);
    return false;
  }
  if (!lengths_ok) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) out_row[i] = T(NAN);
    return false;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T fe_n_live(const T* mask, int c_max) {
  T sum = T(0);
  for (int c = 0; c < c_max; ++c) sum = fe_add(sum, mask[c]);
  return fe_clamp_min(sum, T(1));
}

// FE1: channels [n_slots, c_max, t], chan_mask [n_slots, c_max],
// slot_mask [n_slots], nsta, nlta [n_slots] int32 -> out [n_slots, t],
// available [1].
template <typename T>
__global__ void __launch_bounds__(FE_THREADS)
qm_fe1_stalta_kernel(const T* __restrict__ channels,
                  const T* __restrict__ chan_mask,
                  const T* __restrict__ slot_mask,
                  const int* __restrict__ nsta_in,
                  const int* __restrict__ nlta_in, T* __restrict__ out,
                  T* __restrict__ available, int n_slots, int c_max, int t,
                  int centred, int mode, T min_onset, T tiny) {
  extern __shared__ __align__(16) unsigned char fe_smem[];
  T* levels = reinterpret_cast<T*>(fe_smem);
  const int slot = blockIdx.x;
  const int nsta = nsta_in[slot], nlta = nlta_in[slot];
  T* out_row = out + (long long)slot * t;
  if (!fe_slot_live(slot_mask, available, out_row, n_slots, t,
                    nsta >= 1 && nlta >= 1)) {
    return;
  }
  const T* rows = channels + (long long)slot * c_max * t;
  const T* mask = chan_mask + (long long)slot * c_max;
  const FeLevels lv = fe_levels(t);
  const int nb = lv.n[0];
  const bool outer = t > FE_BLOCK;

  // Phase 1: each row's block totals, then their scan.
  for (int item = threadIdx.x; item < c_max * nb; item += blockDim.x) {
    const int c = item / nb, b = item - c * nb;
    const T* x = rows + (long long)c * t;
    const int end = min(t, (b + 1) * FE_BLOCK);
    T acc = fe_transform(x[b * FE_BLOCK], mode);
    for (int m = b * FE_BLOCK + 1; m < end; ++m) {
      acc = fe_add(fe_transform(x[m], mode), acc);
    }
    levels[c * lv.stride + b] = acc;
  }
  __syncthreads();
  fe_scan_levels(levels, c_max, lv);

  // Phase 2: a block of 16 outputs a thread, every channel in order.
  const T frac = fe_div((T)nlta, (T)nsta);
  const T n_live = fe_n_live(mask, c_max);
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    T acc[FE_BLOCK];
#pragma unroll
    for (int j = 0; j < FE_BLOCK; ++j) acc[j] = T(0);
    for (int c = 0; c < c_max; ++c) {
      const T* x = rows + (long long)c * t;
      const T* prefix = levels + c * lv.stride;
      const T weight = mask[c];
      FeWalk<T> hi_w = {-2, T(0)}, sta_w = {-2, T(0)}, lta_w = {-2, T(0)};
#pragma unroll
      for (int j = 0; j < FE_BLOCK; ++j) {
        const int i = b * FE_BLOCK + j;
        if (i >= t) break;
        const T hi = fe1_sum_at(hi_w, i, x, mode, prefix, outer);
        const T lta = fe_sub(
            hi, i - nlta >= 0
                    ? fe1_sum_at(lta_w, i - nlta, x, mode, prefix, outer)
                    : T(0));
        T onset;
        if (!centred) {
          const T sta = fe_sub(
              hi, i - nsta >= 0
                      ? fe1_sum_at(sta_w, i - nsta, x, mode, prefix, outer)
                      : T(0));
          const T ratio =
              lta < tiny
                  ? T(1)
                  : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
          onset = i >= nlta - 1 ? ratio : T(1);
        } else {
          const int up = min(i + nsta, t - 1);
          const T sta =
              fe_sub(fe1_sum_at(sta_w, up, x, mode, prefix, outer), hi);
          const T ratio =
              lta <= T(0)
                  ? T(1)
                  : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
          onset = (i >= nlta - 1 && i < t - nsta) ? ratio : T(1);
        }
        acc[j] = fe_add(acc[j], fe_mul(fe_mul(onset, onset), weight));
      }
    }
    fe_finish(out_row, acc, b, t, n_live, min_onset);
  }
}

// Four running sums (x, x^2, x^3, x^4 as JAX's integer power forms them)
// of one row at a position that moves forward.
template <typename T>
struct FeWalk4 {
  int k;
  T inner[4];
};

// levels: the row's four stretches, power-major (stride apart)
template <typename T>
__device__ __forceinline__ void fe2_sums_at(FeWalk4<T>& w, int k, const T* x,
                                            const T* levels, int stride,
                                            bool outer, T* sums) {
  if (k != w.k) {
    T p[4];
    if (k == w.k + 1 && (k % FE_BLOCK) != 0) {
      fe_powers(x[k], p);
#pragma unroll
      for (int e = 0; e < 4; ++e) w.inner[e] = fe_add(p[e], w.inner[e]);
    } else {
      const int start = k - k % FE_BLOCK;
      fe_powers(x[start], w.inner);
      for (int m = start + 1; m <= k; ++m) {
        fe_powers(x[m], p);
#pragma unroll
        for (int e = 0; e < 4; ++e) w.inner[e] = fe_add(p[e], w.inner[e]);
      }
    }
    w.k = k;
  }
  const int q = k / FE_BLOCK;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sums[e] = !outer ? w.inner[e]
                     : fe_add(w.inner[e], q == 0 ? T(0)
                                                 : levels[e * stride + q - 1]);
  }
}

// The kurtosis of the window ending at sample i (ops/kurtosis.py's
// _kurtosis_from_sums, term by term), 0 before the first whole window.
template <typename T>
__device__ __forceinline__ T fe2_kurtosis_at(FeWalk4<T>& hi_w,
                                             FeWalk4<T>& lo_w, int i,
                                             int nkurt, T n, const T* x,
                                             const T* levels, int stride,
                                             bool outer, T sqrt_tiny) {
  T hi[4], lo[4] = {T(0), T(0), T(0), T(0)}, s[4];
  fe2_sums_at(hi_w, i, x, levels, stride, outer, hi);
  if (i - nkurt >= 0) fe2_sums_at(lo_w, i - nkurt, x, levels, stride, outer,
                                  lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = fe_sub(hi[e], lo[e]);
  const T kurt = fe_kurtosis_from_sums(s, n, sqrt_tiny);
  return i >= nkurt - 1 ? kurt : T(0);
}

// FE2: channels [n_slots, c_max, t], chan_mask, slot_mask, nkurt
// [n_slots] int32, work [n_slots, c_max, t] (the rectified gradients) ->
// out [n_slots, t], available [1].
template <typename T>
__global__ void __launch_bounds__(FE_THREADS)
qm_fe2_kurtosis_kernel(const T* __restrict__ channels,
                    const T* __restrict__ chan_mask,
                    const T* __restrict__ slot_mask,
                    const int* __restrict__ nkurt_in, T* __restrict__ work,
                    T* __restrict__ out, T* __restrict__ available,
                    int n_slots, int c_max, int t, int nsmooth, int taper_pad,
                    T min_onset, T sqrt_tiny, T smooth_weight) {
  extern __shared__ __align__(16) unsigned char fe_smem[];
  T* levels = reinterpret_cast<T*>(fe_smem);
  const int slot = blockIdx.x;
  const int nkurt = nkurt_in[slot];
  T* out_row = out + (long long)slot * t;
  if (!fe_slot_live(slot_mask, available, out_row, n_slots, t, nkurt >= 1)) {
    return;
  }
  const T* rows = channels + (long long)slot * c_max * t;
  T* cf_rows = work + (long long)slot * c_max * t;
  const T* mask = chan_mask + (long long)slot * c_max;
  const FeLevels lv = fe_levels(t);
  const int nb = lv.n[0];
  const bool outer = t > FE_BLOCK;

  // Phase 1: the block totals of each row's four powers, then their scan
  // (stretch (c, e) at (4c + e) * stride).
  for (int item = threadIdx.x; item < c_max * nb; item += blockDim.x) {
    const int c = item / nb, b = item - c * nb;
    const T* x = rows + (long long)c * t;
    const int end = min(t, (b + 1) * FE_BLOCK);
    T acc[4], p[4];
    fe_powers(x[b * FE_BLOCK], acc);
    for (int m = b * FE_BLOCK + 1; m < end; ++m) {
      fe_powers(x[m], p);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fe_add(p[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) levels[(4 * c + e) * lv.stride + b] = acc[e];
  }
  __syncthreads();
  fe_scan_levels(levels, 4 * c_max, lv);

  // Phase 2a: the rectified gradient of each row's kurtosis, a block of
  // 16 samples a thread, with the sample before the block.
  const T n = (T)nkurt;
  for (int item = threadIdx.x; item < c_max * nb; item += blockDim.x) {
    const int c = item / nb, b = item - c * nb;
    const T* x = rows + (long long)c * t;
    const T* lev = levels + 4 * c * lv.stride;
    T* cf = cf_rows + (long long)c * t;
    FeWalk4<T> hi_w = {-2, {}}, lo_w = {-2, {}};
    const int first = b * FE_BLOCK;
    const int end = min(t, first + FE_BLOCK);
    T prev = fe2_kurtosis_at(hi_w, lo_w, first == 0 ? 0 : first - 1, nkurt,
                             n, x, lev, lv.stride, outer, sqrt_tiny);
    for (int i = first; i < end; ++i) {
      const T kurt =
          i == 0 ? prev
                 : fe2_kurtosis_at(hi_w, lo_w, i, nkurt, n, x, lev,
                                   lv.stride, outer, sqrt_tiny);
      cf[i] = fe_clamp_min(fe_sub(kurt, prev), T(0));
      prev = kurt;
    }
  }
  __syncthreads();

  // Phase 2b: smoothing (numpy.convolve's "same" alignment), 1 + cf, the
  // tapered edges, the RMS combine in channel order and the clip.
  const T n_live = fe_n_live(mask, c_max);
  const int half = nsmooth / 2;
  const int lo_edge = taper_pad + nkurt - 1;
  const int hi_edge = t - max(taper_pad, 1);
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    T acc = T(0);
    for (int c = 0; c < c_max; ++c) {
      const T* cf = cf_rows + (long long)c * t;
      T v;
      if (nsmooth > 1) {
        int k = i - half;
        v = fe_mul(k >= 0 && k < t ? cf[k] : T(0), smooth_weight);
        for (int j = 1; j < nsmooth; ++j) {
          ++k;
          v = fe_add(v, fe_mul(k >= 0 && k < t ? cf[k] : T(0),
                               smooth_weight));
        }
      } else {
        v = cf[i];
      }
      v = fe_add(T(1), v);
      if (i < lo_edge || i >= hi_edge) v = T(1);
      acc = fe_add(acc, fe_mul(fe_mul(v, v), mask[c]));
    }
    out_row[i] = fe_clamp_min(fe_sqrt(fe_div(acc, n_live)), min_onset);
  }
}

// The shared memory a launch stages: the levels of every stretch.
static size_t fe_stage_bytes(int t, int stretches, size_t item) {
  return (size_t)fe_levels(t).stride * stretches * item;
}

template <typename Kernel>
static int fe_prepare(Kernel kernel, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  return (int)err;
}

template <typename T>
static int fe1_launch(const void* channels, const void* chan_mask,
                      const void* slot_mask, const void* nsta,
                      const void* nlta, void* out, void* available,
                      int n_slots, int c_max, int t, int centred, int mode,
                      int min_lo, int min_hi, void* stream) {
  if (n_slots < 1 || c_max < 1 || t < 1 || mode < FE_SQUARE ||
      mode > FE_IDENTITY) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fe_stage_bytes(t, c_max, sizeof(T));
  const int err = fe_prepare(qm_fe1_stalta_kernel<T>, smem);
  if (err != 0) return err;
  qm_fe1_stalta_kernel<T><<<n_slots, FE_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(channels), static_cast<const T*>(chan_mask),
      static_cast<const T*>(slot_mask), static_cast<const int*>(nsta),
      static_cast<const int*>(nlta), static_cast<T*>(out),
      static_cast<T*>(available), n_slots, c_max, t, centred, mode,
      (T)fe_bits_to_double(min_lo, min_hi),
      std::numeric_limits<T>::min());
  return (int)cudaGetLastError();
}

template <typename T>
static int fe2_launch(const void* channels, const void* chan_mask,
                      const void* slot_mask, const void* nkurt, void* work,
                      void* out, void* available, int n_slots, int c_max,
                      int t, int nsmooth, int taper_pad, int min_lo,
                      int min_hi, void* stream) {
  if (n_slots < 1 || c_max < 1 || t < 1 || nsmooth < 1 || taper_pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fe_stage_bytes(t, 4 * c_max, sizeof(T));
  const int err = fe_prepare(qm_fe2_kurtosis_kernel<T>, smem);
  if (err != 0) return err;
  // sqrt(tiny) is a power of two in both types, so exact
  const T sqrt_tiny = (T)std::sqrt((double)std::numeric_limits<T>::min());
  qm_fe2_kurtosis_kernel<T><<<n_slots, FE_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(channels), static_cast<const T*>(chan_mask),
      static_cast<const T*>(slot_mask), static_cast<const int*>(nkurt),
      static_cast<T*>(work), static_cast<T*>(out),
      static_cast<T*>(available), n_slots, c_max, t, nsmooth, taper_pad,
      (T)fe_bits_to_double(min_lo, min_hi), sqrt_tiny,
      (T)(1.0 / nsmooth));
  return (int)cudaGetLastError();
}

// All arrays contiguous on the device, in the entry's float type; the
// window lengths int32. min_onset_value is a double passed as its two
// 32-bit halves (low, high). mode: 0 square, 1 abs, 2 identity.
extern "C" int qm_front_end_stalta_f32(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nsta, const void* nlta, void* out, void* available,
    int n_slots, int c_max, int t, int centred, int mode, int min_lo,
    int min_hi, void* stream) {
  return fe1_launch<float>(channels, chan_mask, slot_mask, nsta, nlta, out,
                           available, n_slots, c_max, t, centred, mode,
                           min_lo, min_hi, stream);
}

extern "C" int qm_front_end_stalta_f64(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nsta, const void* nlta, void* out, void* available,
    int n_slots, int c_max, int t, int centred, int mode, int min_lo,
    int min_hi, void* stream) {
  return fe1_launch<double>(channels, chan_mask, slot_mask, nsta, nlta, out,
                            available, n_slots, c_max, t, centred, mode,
                            min_lo, min_hi, stream);
}

extern "C" int qm_front_end_kurtosis_f32(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nkurt, void* work, void* out, void* available, int n_slots,
    int c_max, int t, int nsmooth, int taper_pad, int min_lo, int min_hi,
    void* stream) {
  return fe2_launch<float>(channels, chan_mask, slot_mask, nkurt, work, out,
                           available, n_slots, c_max, t, nsmooth, taper_pad,
                           min_lo, min_hi, stream);
}

extern "C" int qm_front_end_kurtosis_f64(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nkurt, void* work, void* out, void* available, int n_slots,
    int c_max, int t, int nsmooth, int taper_pad, int min_lo, int min_hi,
    void* stream) {
  return fe2_launch<double>(channels, chan_mask, slot_mask, nkurt, work, out,
                            available, n_slots, c_max, t, nsmooth, taper_pad,
                            min_lo, min_hi, stream);
}
