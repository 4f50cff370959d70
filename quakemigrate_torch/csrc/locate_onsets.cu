// ON1 and ON2: the onset functions of locate, of the standard detect path
// and of core.compat on Hopper (sm_90a), one launch a call.
//
// Replace no Pallas kernel: the JAX package computes them as jitted XLA
// code, quakemigrate_tpu/ops/stalta.py:39 (overlapping_sta_lta) and :57
// (centred_sta_lta) for ON1, quakemigrate_tpu/ops/kurtosis.py:69
// (kurtosis_onset, with rolling_kurtosis, :32) for ON2. The plain versions
// are ops/stalta.py's overlapping_sta_lta_plain, centred_sta_lta_plain and
// station_sta_lta_plain, and ops/kurtosis.py's kurtosis_onset_plain and
// station_kurtosis_onset_plain.
//
// Contract. Per row of x [rows, t], static window lengths: ON1 the
// classic or centred STA/LTA of the row's transform (the square, the
// magnitude, or the row as it is), ON2 the kurtosis onset (the trailing
// kurtosis from the four power sums, the rectified gradient with its
// first sample 0, the box smoothing in numpy.convolve's "same" alignment,
// 1 + cf). Every running sum is added as ops/rolling.py's blocked_cumsum
// adds it (sequentially inside each block of 16 samples, each block's
// exclusive prefix being the running sum of the block totals taken by the
// same rule recursively; a zero added where the block is a level's first,
// none at the top level, which has at most 16 values), and every operation
// rounds where the plain version rounds (front_end_math.cuh's _rn
// operations, in its term order). Two output modes: rows (offsets NULL),
// the onset of every row; stations (offsets [units + 1], each station's
// rows in order), the per-station epilogue of locate's onsets: the first
// lo_edge and the samples from hi_edge set to 1, the squares added in row
// order (the first row's square as it is), divided by the row count, the
// square root, the clamp to min_onset_value. So the output is the plain
// version's bit for bit.
//
// Bound. The rows are read once and the onsets written once: rows x t x
// the item size each way, a few dozen operations a sample.
//
// Design (a simple first form). One block a unit (a row, or a station's
// rows in turn) walks its rows: the row is staged through shared memory
// in tiles of 4,096 samples (coalesced loads, each thread then a block of
// 16 samples, padded to 17 against bank conflicts); the block totals of
// every level are added into a workspace of the launch in device memory,
// level by level, then their running sums top down (the top level by one
// thread), then each block's running sums C_0 are written back through
// the tile (coalesced) into the workspace, one power at a time; the
// outputs are then a thread a sample, reading C_0 at the window ends. ON2
// writes the kurtosis and then its rectified gradient to the workspace and
// smooths from there. Any row length: nothing of a row has to fit shared
// memory. One block a unit leaves SMs idle where units are few (locate:
// 12-13 stations a phase); spreading a row over blocks is later work.

#include <cuda_runtime.h>

#include "front_end_math.cuh"

#define ON_THREADS 256
// Samples a tile stages, and its shared values (a padding value every 16)
#define ON_TILE 4096
#define ON_STAGE (ON_TILE + ON_TILE / FE_BLOCK)

// ON1's transformed sample, or ON2's four powers
template <typename T>
struct OnTransform {
  static constexpr int P = 1;
  int mode;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    p[0] = fe_transform(v, mode);
  }
};

template <typename T>
struct OnPowers {
  static constexpr int P = 4;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    fe_powers(v, p);
  }
};

// The len samples at x into the tile (a padding value after every 16),
// the block synchronised before and after.
template <typename T>
__device__ __forceinline__ void on_stage(const T* x, int len, T* tile) {
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    tile[k + k / FE_BLOCK] = x[k];
  }
  __syncthreads();
}

// The running sums of the transformed row x (t samples) in blocked_cumsum's
// order: c + e t holds power e's at every sample, lev + e lv.stride its
// levels' (the block totals' running sums); tile: ON_STAGE shared values.
// Leaves the block synchronised.
template <typename T, class S>
__device__ void on_scan(const S& f, const T* x, int t, const FeLevels& lv,
                        T* c, T* lev, T* tile) {
  constexpr int P = S::P;
  const bool outer = t > FE_BLOCK;
  if (outer) {
    // Level 0: the totals of the row's blocks of 16, every power at once
    for (int tb = 0; tb < t; tb += ON_TILE) {
      const int len = min(ON_TILE, t - tb);
      on_stage(x + tb, len, tile);
      for (int b = threadIdx.x; b * FE_BLOCK < len; b += blockDim.x) {
        const int m = min(FE_BLOCK, len - b * FE_BLOCK);
        const T* v = tile + b * (FE_BLOCK + 1);
        T acc[P], p[P];
        f(v[0], acc);
        for (int r = 1; r < m; ++r) {
          f(v[r], p);
#pragma unroll
          for (int e = 0; e < P; ++e) acc[e] = fe_add(p[e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < P; ++e) {
          lev[e * lv.stride + tb / FE_BLOCK + b] = acc[e];
        }
      }
    }
    __syncthreads();
    // Levels 1 and up: the totals of the blocks of 16 of the level below
    for (int l = 1; l < lv.count; ++l) {
      for (int item = threadIdx.x; item < P * lv.n[l]; item += blockDim.x) {
        const int e = item / lv.n[l], j = item - e * lv.n[l];
        const T* below = lev + e * lv.stride + lv.off[l - 1] + j * FE_BLOCK;
        const int m = min(FE_BLOCK, lv.n[l - 1] - j * FE_BLOCK);
        T acc = below[0];
        for (int r = 1; r < m; ++r) acc = fe_add(below[r], acc);
        lev[e * lv.stride + lv.off[l] + j] = acc;
      }
      __syncthreads();
    }
    // Running sums, top down: the top level's (at most 16 values) in
    // sequence; below it each block's partial sums plus the running sum of
    // the blocks before it (a zero for a level's first block), in place
    const int top = lv.count - 1;
    for (int e = threadIdx.x; e < P; e += blockDim.x) {
      T* v = lev + e * lv.stride + lv.off[top];
      for (int j = 1; j < lv.n[top]; ++j) v[j] = fe_add(v[j], v[j - 1]);
    }
    __syncthreads();
    for (int l = top - 1; l >= 0; --l) {
      const int nb = (lv.n[l] + FE_BLOCK - 1) / FE_BLOCK;
      for (int item = threadIdx.x; item < P * nb; item += blockDim.x) {
        const int e = item / nb, b = item - e * nb;
        T* v = lev + e * lv.stride + lv.off[l] + b * FE_BLOCK;
        const T before =
            b == 0 ? T(0) : lev[e * lv.stride + lv.off[l + 1] + b - 1];
        const int m = min(FE_BLOCK, lv.n[l] - b * FE_BLOCK);
        T acc = v[0];
        v[0] = fe_add(acc, before);
        for (int r = 1; r < m; ++r) {
          acc = fe_add(v[r], acc);
          v[r] = fe_add(acc, before);
        }
      }
      __syncthreads();
    }
  }
  // C_0, a power at a time: each block's partial sums plus the running
  // sum of the blocks before it, written over the tile, then stored
  for (int e = 0; e < P; ++e) {
    for (int tb = 0; tb < t; tb += ON_TILE) {
      const int len = min(ON_TILE, t - tb);
      on_stage(x + tb, len, tile);
      for (int b = threadIdx.x; b * FE_BLOCK < len; b += blockDim.x) {
        const int m = min(FE_BLOCK, len - b * FE_BLOCK);
        const int q = tb / FE_BLOCK + b;
        const T before =
            outer && q > 0 ? lev[e * lv.stride + q - 1] : T(0);
        T* v = tile + b * (FE_BLOCK + 1);
        T p[P];
        f(v[0], p);
        T acc = p[e];
        v[0] = outer ? fe_add(acc, before) : acc;
        for (int r = 1; r < m; ++r) {
          f(v[r], p);
          acc = fe_add(p[e], acc);
          v[r] = outer ? fe_add(acc, before) : acc;
        }
      }
      __syncthreads();
      for (int k = threadIdx.x; k < len; k += blockDim.x) {
        c[(long long)e * t + tb + k] = tile[k + k / FE_BLOCK];
      }
    }
  }
  __syncthreads();
}

// A unit's rows [*r0, *r1): a station's (offsets) or the row u
__device__ __forceinline__ void on_rows(const int* offsets, int u, int* r0,
                                        int* r1) {
  *r0 = offsets != nullptr ? offsets[u] : u;
  *r1 = offsets != nullptr ? offsets[u + 1] : u + 1;
}

// A station's output at sample i from row r's onset (r0 its first row):
// the edges set to 1, the square added to the rows before it
template <typename T>
__device__ __forceinline__ void on_accumulate(T* out_row, int i, T onset,
                                              int r, int r0, int lo_edge,
                                              int hi_edge) {
  if (i < lo_edge || i >= hi_edge) onset = T(1);
  const T sq = fe_mul(onset, onset);
  out_row[i] = r == r0 ? sq : fe_add(out_row[i], sq);
}

// The station's epilogue after its rows: the mean square's root, clamped
template <typename T>
__device__ __forceinline__ void on_finish(T* out_row, int t, int n_rows,
                                          T min_onset) {
  const T n = (T)n_rows;
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    out_row[i] = fe_clamp_min(fe_sqrt(fe_div(out_row[i], n)), min_onset);
  }
}

// ON1: x [rows, t] -> out [units, t]; ws: ws_unit values a unit (its
// running sums, then its levels).
template <typename T>
__global__ void __launch_bounds__(ON_THREADS)
qm_on1_stalta_kernel(const T* __restrict__ x, const int* __restrict__ offsets,
                     T* out, T* ws, int t, long long ws_unit, int nsta,
                     int nlta, int centred, int mode, int lo_edge,
                     int hi_edge, T frac, T tiny, T min_onset) {
  extern __shared__ __align__(16) unsigned char on_smem[];
  T* tile = reinterpret_cast<T*>(on_smem);
  const int u = blockIdx.x;
  int r0, r1;
  on_rows(offsets, u, &r0, &r1);
  const FeLevels lv = fe_levels(t);
  T* c = ws + u * ws_unit;
  T* lev = c + t;
  T* out_row = out + (long long)u * t;
  const OnTransform<T> f{mode};
  const int nsta_c = min(nsta, t);
  for (int r = r0; r < r1; ++r) {
    on_scan(f, x + (long long)r * t, t, lv, c, lev, tile);
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      const T hi = c[i];
      const T lta = fe_sub(hi, i - nlta >= 0 ? c[i - nlta] : T(0));
      T onset;
      if (!centred) {
        const T sta = fe_sub(hi, i - nsta >= 0 ? c[i - nsta] : T(0));
        const T ratio =
            lta < tiny ? T(1)
                       : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
        onset = i >= nlta - 1 ? ratio : T(1);
      } else {
        const T sta = fe_sub(c[min(i + nsta_c, t - 1)], hi);
        const T ratio =
            lta <= T(0) ? T(1)
                        : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
        onset = (i >= nlta - 1 && i < t - nsta_c) ? ratio : T(1);
      }
      if (offsets == nullptr) {
        out_row[i] = onset;
      } else {
        on_accumulate(out_row, i, onset, r, r0, lo_edge, hi_edge);
      }
    }
    // the workspace is the next row's
    __syncthreads();
  }
  if (offsets != nullptr) on_finish(out_row, t, r1 - r0, min_onset);
}

// ON2: x [rows, t] -> out [units, t]; ws: ws_unit values a unit (the four
// powers' running sums, their levels, then the kurtosis; the rectified
// gradient goes over the first power's running sums).
template <typename T>
__global__ void __launch_bounds__(ON_THREADS)
qm_on2_kurtosis_kernel(const T* __restrict__ x,
                       const int* __restrict__ offsets, T* out, T* ws, int t,
                       long long ws_unit, int nkurt, int nsmooth, int lo_edge,
                       int hi_edge, T min_onset, T sqrt_tiny,
                       T smooth_weight) {
  extern __shared__ __align__(16) unsigned char on_smem[];
  T* tile = reinterpret_cast<T*>(on_smem);
  const int u = blockIdx.x;
  int r0, r1;
  on_rows(offsets, u, &r0, &r1);
  const FeLevels lv = fe_levels(t);
  T* c = ws + u * ws_unit;
  T* lev = c + 4LL * t;
  T* kurt = lev + 4LL * lv.stride;
  T* cf = c;
  T* out_row = out + (long long)u * t;
  const OnPowers<T> f;
  const T n = (T)nkurt;
  const int half = nsmooth / 2;
  for (int r = r0; r < r1; ++r) {
    on_scan(f, x + (long long)r * t, t, lv, c, lev, tile);
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      T sums[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* ce = c + (long long)e * t;
        sums[e] = fe_sub(ce[i], i - nkurt >= 0 ? ce[i - nkurt] : T(0));
      }
      const T k = fe_kurtosis_from_sums(sums, n, sqrt_tiny);
      kurt[i] = i >= nkurt - 1 ? k : T(0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      cf[i] = fe_clamp_min(fe_sub(kurt[i], kurt[i == 0 ? 0 : i - 1]), T(0));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      T v;
      if (nsmooth == 1) {
        v = cf[i];
      } else {
        // the taps in smooth_same's order, zeros beyond the row
        for (int j = 0; j < nsmooth; ++j) {
          const int k = i - half + j;
          const T term = fe_mul(k >= 0 && k < t ? cf[k] : T(0), smooth_weight);
          v = j == 0 ? term : fe_add(v, term);
        }
      }
      v = fe_add(T(1), v);
      if (offsets == nullptr) {
        out_row[i] = v;
      } else {
        on_accumulate(out_row, i, v, r, r0, lo_edge, hi_edge);
      }
    }
    __syncthreads();
  }
  if (offsets != nullptr) on_finish(out_row, t, r1 - r0, min_onset);
}

// Values of a unit's workspace at row length t (kurtosis 0 for ON1)
static long long on_unit_values(int t, bool kurtosis) {
  const FeLevels lv = fe_levels(t);
  const long long p = kurtosis ? 4 : 1;
  return p * ((long long)t + lv.stride) + (kurtosis ? t : 0);
}

static int on_check(int units, int t, long long ws_unit, bool kurtosis,
                    int lo_edge, int hi_edge) {
  if (units < 1 || t < 1 || ws_unit < on_unit_values(t, kurtosis) ||
      lo_edge < 0 || hi_edge < 0 || hi_edge > t) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
static int on1_launch(const void* x, const void* offsets, void* out,
                      void* ws, int units, int t, int ws_unit, int nsta,
                      int nlta, int centred, int mode, int lo_edge,
                      int hi_edge, int frac_lo, int frac_hi, int min_lo,
                      int min_hi, void* stream) {
  if (on_check(units, t, ws_unit, false, lo_edge, hi_edge) != 0 ||
      nsta < 1 || nlta < 1 || mode < FE_SQUARE || mode > FE_IDENTITY) {
    return (int)cudaErrorInvalidValue;
  }
  qm_on1_stalta_kernel<T><<<units, ON_THREADS, ON_STAGE * sizeof(T),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(offsets),
      static_cast<T*>(out), static_cast<T*>(ws), t, ws_unit, nsta, nlta,
      centred, mode, lo_edge, hi_edge, (T)fe_bits_to_double(frac_lo, frac_hi),
      std::numeric_limits<T>::min(), (T)fe_bits_to_double(min_lo, min_hi));
  return (int)cudaGetLastError();
}

template <typename T>
static int on2_launch(const void* x, const void* offsets, void* out,
                      void* ws, int units, int t, int ws_unit, int nkurt,
                      int nsmooth, int lo_edge, int hi_edge, int min_lo,
                      int min_hi, void* stream) {
  if (on_check(units, t, ws_unit, true, lo_edge, hi_edge) != 0 ||
      nkurt < 1 || nsmooth < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // sqrt(tiny) is a power of two in both types, so exact
  const T sqrt_tiny = (T)std::sqrt((double)std::numeric_limits<T>::min());
  qm_on2_kurtosis_kernel<T><<<units, ON_THREADS, ON_STAGE * sizeof(T),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(offsets),
      static_cast<T*>(out), static_cast<T*>(ws), t, ws_unit, nkurt, nsmooth,
      lo_edge, hi_edge, (T)fe_bits_to_double(min_lo, min_hi), sqrt_tiny,
      (T)(1.0 / nsmooth));
  return (int)cudaGetLastError();
}

// All arrays contiguous on the device: x [rows, t] and out [units, t] of
// the entry's float type; offsets NULL (rows mode: units = rows) or int32
// [units + 1] (stations mode, each station at least one row); ws at least
// ws_unit values a unit, ws_unit at least the values a unit needs (else
// the launch is refused). frac and min_onset_value are doubles passed as
// their two 32-bit halves (low, high). mode: 0 square, 1 abs, 2 identity.
// lo_edge, hi_edge: stations mode's samples set to 1 before the combine
// ([0, lo_edge) and [hi_edge, t)).
extern "C" int qm_onset_stalta_f32(const void* x, const void* offsets,
                                   void* out, void* ws, int units, int t,
                                   int ws_unit, int nsta, int nlta,
                                   int centred, int mode, int lo_edge,
                                   int hi_edge, int frac_lo, int frac_hi,
                                   int min_lo, int min_hi, void* stream) {
  return on1_launch<float>(x, offsets, out, ws, units, t, ws_unit, nsta,
                           nlta, centred, mode, lo_edge, hi_edge, frac_lo,
                           frac_hi, min_lo, min_hi, stream);
}

extern "C" int qm_onset_stalta_f64(const void* x, const void* offsets,
                                   void* out, void* ws, int units, int t,
                                   int ws_unit, int nsta, int nlta,
                                   int centred, int mode, int lo_edge,
                                   int hi_edge, int frac_lo, int frac_hi,
                                   int min_lo, int min_hi, void* stream) {
  return on1_launch<double>(x, offsets, out, ws, units, t, ws_unit, nsta,
                            nlta, centred, mode, lo_edge, hi_edge, frac_lo,
                            frac_hi, min_lo, min_hi, stream);
}

extern "C" int qm_onset_kurtosis_f32(const void* x, const void* offsets,
                                     void* out, void* ws, int units, int t,
                                     int ws_unit, int nkurt, int nsmooth,
                                     int lo_edge, int hi_edge, int min_lo,
                                     int min_hi, void* stream) {
  return on2_launch<float>(x, offsets, out, ws, units, t, ws_unit, nkurt,
                           nsmooth, lo_edge, hi_edge, min_lo, min_hi, stream);
}

extern "C" int qm_onset_kurtosis_f64(const void* x, const void* offsets,
                                     void* out, void* ws, int units, int t,
                                     int ws_unit, int nkurt, int nsmooth,
                                     int lo_edge, int hi_edge, int min_lo,
                                     int min_hi, void* stream) {
  return on2_launch<double>(x, offsets, out, ws, units, t, ws_unit, nkurt,
                            nsmooth, lo_edge, hi_edge, min_lo, min_hi,
                            stream);
}

#ifdef __CUDACC__
// Resident blocks per SM of ON1 (kurtosis 0) or ON2 in float32 (f64 0) or
// float64; a negative CUDA error on failure.
extern "C" int qm_onset_blocks_per_sm(int kurtosis, int f64) {
  const size_t smem = ON_STAGE * (f64 ? sizeof(double) : sizeof(float));
  int blocks = 0;
  cudaError_t err;
  if (kurtosis) {
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_on2_kurtosis_kernel<double>, ON_THREADS, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_on2_kurtosis_kernel<float>, ON_THREADS, smem);
  } else {
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_on1_stalta_kernel<double>, ON_THREADS, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_on1_stalta_kernel<float>, ON_THREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}
#endif
