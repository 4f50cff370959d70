// FE1 v2 and FE2 v2: the onset front ends of detect's fused window
// redesigned for Hopper (sm_90a) as a grid of row segments.
//
// Replace no Pallas kernel: the JAX package computes both front ends as
// XLA code in its jitted detect window, quakemigrate_tpu/ops/scan_window.py
// :123 (fused_onsets) and :166 (fused_kurtosis_onsets). FE1 and FE2
// (csrc/front_end.cu, one block a slot) were their first forms and stay
// as the yardstick. The plain versions are ops/scan_window.py's
// fused_onsets and fused_kurtosis_onsets.
//
// Contract (FE1's and FE2's). Every running sum is added as
// ops/rolling.py's blocked_cumsum adds it: sequentially inside each block
// of 16 samples, each block's exclusive prefix being the running sum of
// the block totals taken by the same rule recursively (C_0(p) = I_0(p) +
// C_1(p / 16 - 1), C_1(j) = I_1(j) + C_2(j / 16 - 1), ..., I_l a block's
// sequential partial sum at level l; the addition of a zero where the
// block is a level's first, none at the top level, which has at most 16
// values). Every operation rounds where the plain version rounds (the _rn
// intrinsics, in its term order). So the output is the plain version's
// bit for bit. Dead slots give 1, a live slot with a window length below
// 1 NaN; available is written.
//
// Bound. The block is read once and the onsets written once: a few
// hundred kB a window, a few dozen operations a sample. One block a slot
// (v1) left 106 of 132 SMs idle and walked 16 samples a thread in
// sequence, with its levels capped by a block's shared memory.
//
// Design. A segment is 256 samples (16 blocks of 16), so levels 0 and 1
// of the rule are local to it. The grid has a tile a slot and segment;
// tiles take their (slot, segment) from a counter of the launch (zeroed
// on its stream before the kernel), slot-minor, so a tile waits only on
// tiles already running. Phase 1: the tile adds its segment's level-1
// values (a thread a row and block of 16) and their sequential partial
// sums I_1. The segment's total is its entry of level 2, which lives in
// a workspace with a flag an entry: the tile publishes it (release),
// waits (acquire) for the entries before it in its block of 16 (or in
// the block before, for a block's first segment) and adds C_2 of the
// segment before, with C_3 of the block of 16 before published by the
// tile that closed that block; where its own entry closes a block of 16
// it climbs: it publishes the block's total one level up and that
// entry's running sum, and so on. So every running sum is the rule's,
// in the rule's order, whatever the row's length. C_1 of the segment
// (I_1 plus C_2 of the segment before) goes to the workspace with a
// flag. Phase 2: a running sum C_0 at a position p is a block's
// sequential sum I_0(p) plus C_1(p / 16 - 1); each window of positions
// an output needs (FE1: the sample's, the LTA's and the STA's other
// ends; FE2: the kurtosis windows' two ends) is staged from the
// channels, a thread a block of 16 and row, 17 blocks a window, and the
// outputs are then a thread a sample, the channels added in channel
// order. FE2 writes the rectified kurtosis gradient of its own segment
// to the workspace with a flag and smooths from shared memory. The
// centred STA and FE2's smoothing read ahead of a sample: a tile's
// outputs lag its segment by as many segments as they read ahead (the
// last tile of a slot takes the rest), so every window lies in segments
// already published. Shared memory holds one round of channels' windows
// (at most FV_BUDGET bytes), so no window length is capped by it. Every
// load of a 16-sample block or 16 entries is issued before the first
// use and every block's waits are spread over its threads: a tile is a
// chain of about ten dependent round trips to L2, not of arithmetic.

#include <cuda_runtime.h>

#include "front_end_math.cuh"

#define FV_THREADS 256
// Samples of a segment: 16 blocks of 16
#define FV_SEG 256
// Samples a window stages: 17 blocks of 16 hold any 257 positions
#define FV_SPAN 272
#define FV_WIN_BLOCKS 17
// Shared bytes of a round of channels' windows
#define FV_BUDGET (40 * 1024)
// Smoothing taps loaded at a time
#define FV_TAPS 8
// Resident blocks an SM each kernel asks the compiler to allow (the
// registers that leave no spill): the tiles are latency-bound, so the
// more resident, the more in flight
#define FV1_MIN_BLOCKS_F32 4
#define FV1_MIN_BLOCKS_F64 3
#define FV2_MIN_BLOCKS_F32 3
#define FV2_MIN_BLOCKS_F64 3

#ifdef __CUDACC__
__device__ __forceinline__ int fv_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void fv_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void fv_wait(const int* flag, int at_least) {
  while (fv_acquire(flag) < at_least) __nanosleep(64);
}
#endif

// Called by the whole block after it wrote what the flag covers: the
// barrier orders the block's writes before thread 0's release.
__device__ __forceinline__ void fv_publish(int* flag, int value) {
  __syncthreads();
  if (threadIdx.x == 0) fv_release(flag, value);
}

// Each thread waits on every blockDim.x-th of the flags [first, last] of
// this list's calls (nw counts them), so the block's waits overlap.
__device__ __forceinline__ void fv_wait_share(const int* flags, int first,
                                              int last, int at_least,
                                              int* nw) {
  for (int x = first; x <= last; ++x, ++*nw) {
    if (*nw % blockDim.x == threadIdx.x) fv_wait(flags + x, at_least);
  }
}

// The n (at most 16) values at x, all loads in flight before the first
// use, the rest zero
template <typename T>
__device__ __forceinline__ void fv_load16(const T* x, int n, T* v) {
#pragma unroll
  for (int r = 0; r < FE_BLOCK; ++r) v[r] = r < n ? x[r] : T(0);
}

template <typename T>
__device__ __forceinline__ void fv_load16_cg(const T* x, int n, T* v) {
#pragma unroll
  for (int r = 0; r < FE_BLOCK; ++r) v[r] = r < n ? __ldcg(x + r) : T(0);
}

// The workspace of a launch: ints (the tiles' counter, then the flags),
// then values of the block's type. Levels 2 and up of a row (those of
// fe_levels from its second) hold, per slot and running sum, each entry's
// value (up_val) and, from level 3, its running sum (up_run; a level 2
// running sum is added by the tile that needs it), with one flag an entry
// and slot (1: the value is published, 2: the running sum too); c1 holds
// level 1's running sums (16 a segment) with a flag a segment; FE2's cf
// the rectified gradients [n_slots, c_max, t] with a flag a segment.
struct FvLayout {
  int n_seg, n1, rows;
  int up_count, up_stride;
  int up_n[FE_MAX_LEVELS], up_off[FE_MAX_LEVELS];
  long long flags_c1, flags_cf, n_ints, int_bytes;
  long long up_run, c1, cf, n_vals;
};

static FvLayout fv_layout(int n_slots, int c_max, int t, int powers,
                          bool with_cf) {
  FvLayout ly;
  memset(&ly, 0, sizeof ly);
  const FeLevels lv = fe_levels(t);
  ly.n_seg = (t + FV_SEG - 1) / FV_SEG;
  ly.n1 = ly.n_seg * FE_BLOCK;
  ly.rows = c_max * powers;
  ly.up_count = lv.count - 1;
  for (int u = 0; u < ly.up_count; ++u) {
    ly.up_n[u] = lv.n[u + 1];
    ly.up_off[u] = lv.off[u + 1] - lv.off[1];
  }
  ly.up_stride = ly.up_count > 0 ? lv.stride - lv.off[1] : 0;
  const long long slots = n_slots;
  ly.flags_c1 = 1 + slots * ly.up_stride;
  ly.flags_cf = ly.flags_c1 + slots * ly.n_seg;
  ly.n_ints = ly.flags_cf + (with_cf ? slots * ly.n_seg : 0);
  ly.int_bytes = (ly.n_ints * 4 + 15) / 16 * 16;
  ly.up_run = slots * ly.rows * ly.up_stride;
  ly.c1 = 2 * ly.up_run;
  ly.cf = ly.c1 + slots * ly.rows * ly.n1;
  ly.n_vals = ly.cf + (with_cf ? slots * c_max * (long long)t : 0);
  return ly;
}

// FE1's transformed sample, or FE2's four powers
template <typename T>
struct FvTransform {
  static constexpr int P = 1;
  int mode;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    p[0] = fe_transform(v, mode);
  }
};

template <typename T>
struct FvPowers {
  static constexpr int P = 4;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    fe_powers(v, p);
  }
};

// A tile's slot and segment, from the launch's counter (slot-minor). The
// ticket goes through the first 16 bytes of shared memory.
struct FvTile {
  int slot, g;
};

__device__ __forceinline__ FvTile fv_tile(int* counter, int* ticket,
                                          int n_slots) {
  if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1);
  __syncthreads();
  const int k = *ticket;
  return {k % n_slots, k / n_slots};
}

// Whether the slot needs its onsets; else its segment's outputs are
// written (1 for a dead slot, NaN for a window length below 1). The first
// tile writes available: the slot mask's sum in slot order, the mask
// loaded a block's width at a time into scratch (shared memory of at
// least blockDim.x values), so that no load waits on another.
template <typename T>
__device__ bool fv_slot_live(const T* slot_mask, T* available, T* out_row,
                             int n_slots, int t, FvTile tile, bool lengths_ok,
                             T* scratch) {
  if (tile.slot == 0 && tile.g == 0) {
    T sum = T(0);
    for (int s0 = 0; s0 < n_slots; s0 += blockDim.x) {
      const int n = min((int)blockDim.x, n_slots - s0);
      if ((int)threadIdx.x < n) scratch[threadIdx.x] = slot_mask[s0 + threadIdx.x];
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int s = 0; s < n; ++s) sum = fe_add(sum, scratch[s]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) *available = sum;
  }
  const bool dead = slot_mask[tile.slot] != T(1);
  if (!dead && lengths_ok) return true;
  const int end = min(t, (tile.g + 1) * FV_SEG);
  for (int i = tile.g * FV_SEG + threadIdx.x; i < end; i += blockDim.x) {
    out_row[i] = dead ? T(1) : T(NAN);
  }
  return false;
}

// The slot's running sums of its tile's segment. rows: the slot's
// channels; flags: the slot's level flags; up_val, up_run, c1: the slot's
// (rows of ly.up_stride, ly.up_stride and ly.n1 values); stage: shared
// memory for cpr channels' level-1 values. Leaves C_1 of the segment in
// c1 and its flag published.
template <typename T, class S>
__device__ void fv_phase1(const S& f, const T* rows, int c_max, int t, int g,
                          const FvLayout& ly, int* flags, int* flag_c1,
                          T* up_val, T* up_run, T* c1, T* stage, int cpr) {
  constexpr int P = S::P;
  const int seg0 = g * FV_SEG;
  const int nb = min(FE_BLOCK, (t - seg0 + FE_BLOCK - 1) / FE_BLOCK);
  for (int c0 = 0; c0 < c_max; c0 += cpr) {
    const int nc = min(cpr, c_max - c0);
    for (int item = threadIdx.x; item < nc * nb; item += blockDim.x) {
      const int cc = item / nb, b = item - cc * nb;
      const T* x = rows + (long long)(c0 + cc) * t;
      const int start = seg0 + b * FE_BLOCK;
      T v[FE_BLOCK];
      fv_load16(x + start, min(FE_BLOCK, t - start), v);
      T acc[P], p[P];
      f(v[0], acc);
#pragma unroll
      for (int r = 1; r < FE_BLOCK; ++r) {
        if (start + r < t) {
          f(v[r], p);
#pragma unroll
          for (int e = 0; e < P; ++e) acc[e] = fe_add(p[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < P; ++e) stage[(cc * P + e) * FE_BLOCK + b] = acc[e];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nc * P; r += blockDim.x) {
      const int rp = c0 * P + r;
      const T* v = stage + r * FE_BLOCK;
      T* dst = c1 + (long long)rp * ly.n1 + g * FE_BLOCK;
      T acc = v[0];
      dst[0] = acc;
      for (int b = 1; b < nb; ++b) {
        acc = fe_add(v[b], acc);
        dst[b] = acc;
      }
      if (ly.up_count > 0) up_val[(long long)rp * ly.up_stride + g] = acc;
    }
    __syncthreads();
  }

  // Levels 2 and up. Level 2's entries are the segments' totals: publish
  // this one, then add C_2 of the segment before (its block of 16's
  // entries up to it, then C_3 of the block of 16 before, from the tile
  // that closed that block) to I_1. A tile whose entry closes a block of
  // 16 climbs: it publishes the block's total one level up, then that
  // entry's running sum, and so on while its entry closes a block.
  if (ly.up_count > 0) {
    fv_publish(flags + g, 1);
    const bool outer = ly.up_count > 1;
    const int m = g - 1, m0 = g >= 1 ? m - m % FE_BLOCK : 0;
    const int j0 = g - g % FE_BLOCK;
    const bool climb =
        outer && (g % FE_BLOCK == FE_BLOCK - 1 || g == ly.up_n[0] - 1);
    int nw = 0;
    fv_wait_share(flags, min(m0, j0), g - 1, 1, &nw);
    if (outer && m >= FE_BLOCK) {
      fv_wait_share(flags + ly.up_off[1], m / FE_BLOCK - 1, m / FE_BLOCK - 1,
                    2, &nw);
    }
    __syncthreads();
    for (int rp = threadIdx.x; rp < ly.rows; rp += blockDim.x) {
      const long long row = (long long)rp * ly.up_stride;
      T v[FE_BLOCK];
      T before = T(0);
      if (g >= 1) {
        fv_load16_cg(up_val + row + m0, m - m0 + 1, v);
        T acc = v[0];
#pragma unroll
        for (int r = 1; r < FE_BLOCK; ++r) {
          if (m0 + r <= m) acc = fe_add(v[r], acc);
        }
        before = !outer ? acc
                        : fe_add(acc, m >= FE_BLOCK
                                          ? __ldcg(up_run + row +
                                                   ly.up_off[1] +
                                                   m / FE_BLOCK - 1)
                                          : T(0));
      }
      T* dst = c1 + (long long)rp * ly.n1 + g * FE_BLOCK;
      fv_load16_cg(dst, nb, v);
#pragma unroll
      for (int b = 0; b < FE_BLOCK; ++b) {
        if (b < nb) dst[b] = fe_add(v[b], before);
      }
      if (climb) {
        fv_load16_cg(up_val + row + j0, g - j0 + 1, v);
        T acc = v[0];
#pragma unroll
        for (int r = 1; r < FE_BLOCK; ++r) {
          if (j0 + r <= g) acc = fe_add(v[r], acc);
        }
        up_val[row + ly.up_off[1] + g / FE_BLOCK] = acc;
      }
    }
    for (int u = 1, j = g / FE_BLOCK; climb; ++u, j /= FE_BLOCK) {
      // entry j of level u + 2, written above (or by the step before)
      fv_publish(flags + ly.up_off[u] + j, 1);
      const int i0 = j - j % FE_BLOCK;
      const bool above = u + 1 < ly.up_count;
      nw = 0;
      fv_wait_share(flags + ly.up_off[u], i0, j - 1, 1, &nw);
      if (above && j >= FE_BLOCK) {
        fv_wait_share(flags + ly.up_off[u + 1], j / FE_BLOCK - 1,
                      j / FE_BLOCK - 1, 2, &nw);
      }
      __syncthreads();
      const bool up =
          above && (j % FE_BLOCK == FE_BLOCK - 1 || j == ly.up_n[u] - 1);
      for (int rp = threadIdx.x; rp < ly.rows; rp += blockDim.x) {
        const long long row = (long long)rp * ly.up_stride;
        T v[FE_BLOCK];
        fv_load16_cg(up_val + row + ly.up_off[u] + i0, j - i0 + 1, v);
        T acc = v[0];
#pragma unroll
        for (int r = 1; r < FE_BLOCK; ++r) {
          if (i0 + r <= j) acc = fe_add(v[r], acc);
        }
        up_run[row + ly.up_off[u] + j] =
            !above ? acc
                   : fe_add(acc, j >= FE_BLOCK
                                     ? __ldcg(up_run + row +
                                              ly.up_off[u + 1] +
                                              j / FE_BLOCK - 1)
                                     : T(0));
        if (up) up_val[row + ly.up_off[u + 1] + j / FE_BLOCK] = acc;
      }
      fv_publish(flags + ly.up_off[u] + j, 2);
      if (!up) break;
    }
  }
  fv_publish(flag_c1 + g, 1);
}

// A window of positions [first, last] of the slot's rows (empty where last
// < first), staged from the start of first's block of 16.
struct FvWin {
  int first, last;
  __device__ __forceinline__ bool empty() const { return last < first; }
  __device__ __forceinline__ int base() const {
    return first - first % FE_BLOCK;
  }
};

// Wait for C_1 of every segment before g that the windows read (the
// tile's own is in place after the barrier of its publication), then
// synchronise the block.
template <int W>
__device__ void fv_wait_windows(const FvWin* win, const int* flag_c1, int t,
                                int g) {
  int nw = 0;
  for (int w = 0; w < W && t > FE_BLOCK; ++w) {
    if (win[w].empty() || win[w].last < FE_BLOCK) continue;
    const int q0 = max(win[w].first / FE_BLOCK, 1) - 1;
    const int q1 = win[w].last / FE_BLOCK - 1;
    fv_wait_share(flag_c1, q0 / FE_BLOCK, min(q1 / FE_BLOCK, g - 1), 1,
                  &nw);
  }
  __syncthreads();
}

// Stage the running sums C_0 of W windows of channels [c0, c0 + nc): a
// thread a (channel, window, block of 16) adds the block's samples in
// sequence and adds C_1 of the block before to each partial sum. Window
// (cc, w)'s power e at position p is stage[((cc W + w) P + e) FV_SPAN + p
// - win[w].base()]. Leaves the block synchronised.
template <typename T, class S, int W>
__device__ void fv_stage(const S& f, const T* rows, const T* c1, int n1,
                         int t, int c0, int nc, const FvWin* win, T* stage) {
  constexpr int P = S::P;
  for (int item = threadIdx.x; item < nc * W * FV_WIN_BLOCKS;
       item += blockDim.x) {
    const int blk = item % FV_WIN_BLOCKS, jw = item / FV_WIN_BLOCKS;
    const int w = jw % W, cc = jw / W;
    if (win[w].empty()) continue;
    const int q = win[w].first / FE_BLOCK + blk;
    if (q > win[w].last / FE_BLOCK) continue;
    const int c = c0 + cc;
    const T* x = rows + (long long)c * t;
    const long long at = (long long)(cc * W + w) * P * FV_SPAN - win[w].base();
    T before[P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      before[e] = q >= 1 ? __ldcg(c1 + (long long)(c * P + e) * n1 + q - 1)
                         : T(0);
    }
    const bool outer = t > FE_BLOCK;
    const int start = q * FE_BLOCK;
    T v[FE_BLOCK];
    fv_load16(x + start, min(FE_BLOCK, t - start), v);
    T acc[P], p[P];
    f(v[0], acc);
#pragma unroll
    for (int e = 0; e < P; ++e) {
      stage[at + e * FV_SPAN + start] =
          outer ? fe_add(acc[e], before[e]) : acc[e];
    }
#pragma unroll
    for (int r = 1; r < FE_BLOCK; ++r) {
      if (start + r < t) {
        f(v[r], p);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          acc[e] = fe_add(p[e], acc[e]);
          stage[at + e * FV_SPAN + start + r] =
              outer ? fe_add(acc[e], before[e]) : acc[e];
        }
      }
    }
  }
  __syncthreads();
}

// The live channels' count, clamped to 1, in channel order (the weights
// loaded 16 at a time)
template <typename T>
__device__ __forceinline__ T fv_n_live(const T* mask, int c_max) {
  T sum = T(0);
  for (int c0 = 0; c0 < c_max; c0 += FE_BLOCK) {
    T v[FE_BLOCK];
    fv_load16(mask + c0, min(FE_BLOCK, c_max - c0), v);
#pragma unroll
    for (int r = 0; r < FE_BLOCK; ++r) {
      if (c0 + r < c_max) sum = fe_add(sum, v[r]);
    }
  }
  return fe_clamp_min(sum, T(1));
}

// The output segments of tile g: g - lag, and for the slot's last tile
// every segment after it too (empty where g < lag).
__device__ __forceinline__ void fv_outputs(int g, int lag, int n_seg,
                                           int* o0, int* o1) {
  *o0 = max(g - lag, 0);
  *o1 = g == n_seg - 1 ? n_seg - 1 : g - lag;
}

// FE1 v2: channels [n_slots, c_max, t], chan_mask [n_slots, c_max],
// slot_mask [n_slots], nsta, nlta [n_slots] int32 -> out [n_slots, t],
// available [1]; ints, vals: the launch's workspace (fv_layout, powers 1).
template <typename T>
__global__ void __launch_bounds__(FV_THREADS, sizeof(T) == 8
                                                  ? FV1_MIN_BLOCKS_F64
                                                  : FV1_MIN_BLOCKS_F32)
qm_fv1_stalta_kernel(const T* __restrict__ channels,
                     const T* __restrict__ chan_mask,
                     const T* __restrict__ slot_mask,
                     const int* __restrict__ nsta_in,
                     const int* __restrict__ nlta_in, T* __restrict__ out,
                     T* __restrict__ available, int* ints, T* vals,
                     FvLayout ly, int n_slots, int c_max, int t, int centred,
                     int mode, int cpr, T min_onset, T tiny) {
  extern __shared__ __align__(16) unsigned char fv_smem[];
  const FvTile tile = fv_tile(ints, reinterpret_cast<int*>(fv_smem), n_slots);
  T* acc_s = reinterpret_cast<T*>(fv_smem + 16);
  T* stage = acc_s + FV_SEG;
  const int slot = tile.slot, g = tile.g;
  const int nsta = nsta_in[slot], nlta = nlta_in[slot];
  const T* rows = channels + (long long)slot * c_max * t;
  const FvTransform<T> f{mode};
  T* c1 = vals + ly.c1 + (long long)slot * ly.rows * ly.n1;
  int* flag_c1 = ints + ly.flags_c1 + (long long)slot * ly.n_seg;
  // Every tile publishes its segment, the slot's fate read meanwhile
  fv_phase1(f, rows, c_max, t, g, ly, ints + 1 + (long long)slot * ly.up_stride,
            flag_c1, vals + (long long)slot * ly.rows * ly.up_stride,
            vals + ly.up_run + (long long)slot * ly.rows * ly.up_stride, c1,
            stage, cpr);
  T* out_row = out + (long long)slot * t;
  if (!fv_slot_live(slot_mask, available, out_row, n_slots, t, tile,
                    nsta >= 1 && nlta >= 1, stage)) {
    return;
  }
  const T* mask = chan_mask + (long long)slot * c_max;

  const T frac = fe_div((T)nlta, (T)nsta);
  const T n_live = fv_n_live(mask, c_max);
  const int nsta_c = min(nsta, t);
  // The centred STA reads nsta samples ahead
  const int lag = centred ? nsta_c / FV_SEG + (nsta_c % FV_SEG != 0) : 0;
  int o0, o1;
  fv_outputs(g, lag, ly.n_seg, &o0, &o1);
  for (int o = o0; o <= o1; ++o) {
    const int i0 = o * FV_SEG, i1 = min(t, i0 + FV_SEG);
    // The sample's running sums, the LTA's other end and the STA's
    FvWin win[3];
    win[0] = {i0, i1 - 1};
    win[1] = {max(i0 - nlta, 0), i1 - 1 - nlta};
    win[2] = centred ? FvWin{min(i0 + nsta_c, t - 1), min(i1 - 1 + nsta_c,
                                                           t - 1)}
                     : FvWin{max(i0 - nsta, 0), i1 - 1 - nsta};
    fv_wait_windows<3>(win, flag_c1, t, g);
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      acc_s[i - i0] = T(0);
    }
    for (int c0 = 0; c0 < c_max; c0 += cpr) {
      const int nc = min(cpr, c_max - c0);
      fv_stage<T, FvTransform<T>, 3>(f, rows, c1, ly.n1, t, c0, nc, win,
                                     stage);
      for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
        T acc = acc_s[i - i0];
        for (int cc = 0; cc < nc; ++cc) {
          const T* s = stage + cc * 3 * FV_SPAN;
          const T hi = s[i - win[0].base()];
          const T lta = fe_sub(
              hi, i - nlta >= 0 ? s[FV_SPAN + i - nlta - win[1].base()] : T(0));
          T onset;
          if (!centred) {
            const T sta = fe_sub(
                hi, i - nsta >= 0 ? s[2 * FV_SPAN + i - nsta - win[2].base()]
                                  : T(0));
            const T ratio =
                lta < tiny
                    ? T(1)
                    : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
            onset = i >= nlta - 1 ? ratio : T(1);
          } else {
            const int up = min(i + nsta_c, t - 1);
            const T sta = fe_sub(s[2 * FV_SPAN + up - win[2].base()], hi);
            const T ratio =
                lta <= T(0)
                    ? T(1)
                    : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
            onset = (i >= nlta - 1 && i < t - nsta) ? ratio : T(1);
          }
          acc = fe_add(acc, fe_mul(fe_mul(onset, onset), mask[c0 + cc]));
        }
        acc_s[i - i0] = acc;
      }
      __syncthreads();
    }
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      out_row[i] =
          fe_clamp_min(fe_sqrt(fe_div(acc_s[i - i0], n_live)), min_onset);
    }
  }
}

// FE2 v2: channels [n_slots, c_max, t], chan_mask, slot_mask, nkurt
// [n_slots] int32 -> out [n_slots, t], available [1]; ints, vals: the
// launch's workspace (fv_layout, powers 4, with cf).
template <typename T>
__global__ void __launch_bounds__(FV_THREADS, sizeof(T) == 8
                                                  ? FV2_MIN_BLOCKS_F64
                                                  : FV2_MIN_BLOCKS_F32)
qm_fv2_kurtosis_kernel(const T* __restrict__ channels,
                       const T* __restrict__ chan_mask,
                       const T* __restrict__ slot_mask,
                       const int* __restrict__ nkurt_in, T* __restrict__ out,
                       T* __restrict__ available, int* ints, T* vals,
                       FvLayout ly, int n_slots, int c_max, int t,
                       int nsmooth, int taper_pad, int cpr, T min_onset,
                       T sqrt_tiny, T smooth_weight) {
  extern __shared__ __align__(16) unsigned char fv_smem[];
  const FvTile tile = fv_tile(ints, reinterpret_cast<int*>(fv_smem), n_slots);
  T* stage = reinterpret_cast<T*>(fv_smem + 16);
  // a round's kurtosis, 257 values a channel, after its windows
  T* kurt_s = stage + (long long)cpr * 2 * 4 * FV_SPAN;
  const int slot = tile.slot, g = tile.g;
  const int nkurt = nkurt_in[slot];
  const T* rows = channels + (long long)slot * c_max * t;
  const FvPowers<T> f;
  T* c1 = vals + ly.c1 + (long long)slot * ly.rows * ly.n1;
  int* flag_c1 = ints + ly.flags_c1 + (long long)slot * ly.n_seg;
  // Every tile publishes its segment, the slot's fate read meanwhile
  fv_phase1(f, rows, c_max, t, g, ly, ints + 1 + (long long)slot * ly.up_stride,
            flag_c1, vals + (long long)slot * ly.rows * ly.up_stride,
            vals + ly.up_run + (long long)slot * ly.rows * ly.up_stride, c1,
            stage, cpr);
  T* out_row = out + (long long)slot * t;
  if (!fv_slot_live(slot_mask, available, out_row, n_slots, t, tile,
                    nkurt >= 1, stage)) {
    return;
  }
  const T* mask = chan_mask + (long long)slot * c_max;
  T* cf_rows = vals + ly.cf + (long long)slot * c_max * t;
  int* flag_cf = ints + ly.flags_cf + (long long)slot * ly.n_seg;

  // The rectified gradient of the segment's kurtosis, with the sample
  // before the segment
  const T n = (T)nkurt;
  const int k0 = g * FV_SEG, k1 = min(t, k0 + FV_SEG);
  const int kf = max(k0 - 1, 0);
  FvWin win[2];
  win[0] = {kf, k1 - 1};
  win[1] = {max(kf - nkurt, 0), k1 - 1 - nkurt};
  fv_wait_windows<2>(win, flag_c1, t, g);
  for (int c0 = 0; c0 < c_max; c0 += cpr) {
    const int nc = min(cpr, c_max - c0);
    fv_stage<T, FvPowers<T>, 2>(f, rows, c1, ly.n1, t, c0, nc, win, stage);
    for (int item = threadIdx.x; item < nc * (k1 - kf); item += blockDim.x) {
      const int cc = item / (k1 - kf), k = kf + item - cc * (k1 - kf);
      const T* s = stage + (long long)cc * 2 * 4 * FV_SPAN;
      T sums[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T hi = s[e * FV_SPAN + k - win[0].base()];
        const T lo = k - nkurt >= 0
                         ? s[(4 + e) * FV_SPAN + k - nkurt - win[1].base()]
                         : T(0);
        sums[e] = fe_sub(hi, lo);
      }
      const T kurt = fe_kurtosis_from_sums(sums, n, sqrt_tiny);
      kurt_s[cc * (FV_SEG + 1) + k - kf] = k >= nkurt - 1 ? kurt : T(0);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < nc * (k1 - k0); item += blockDim.x) {
      const int cc = item / (k1 - k0), k = k0 + item - cc * (k1 - k0);
      const T* ks = kurt_s + cc * (FV_SEG + 1);
      const T prev = ks[(k == 0 ? 0 : k - 1) - kf];
      cf_rows[(long long)(c0 + cc) * t + k] =
          fe_clamp_min(fe_sub(ks[k - kf], prev), T(0));
    }
    __syncthreads();
  }
  fv_publish(flag_cf + g, 1);

  // Smoothing (numpy.convolve's "same" alignment), 1 + cf, the tapered
  // edges, the RMS combine in channel order and the clip, for segments
  // that lag this one by the samples the smoothing reads ahead
  const T n_live = fv_n_live(mask, c_max);
  const int half = nsmooth / 2;
  const int ahead = nsmooth - 1 - half;
  const int lag = ahead / FV_SEG + (ahead % FV_SEG != 0);
  const int lo_edge = taper_pad + nkurt - 1;
  const int hi_edge = t - max(taper_pad, 1);
  int o0, o1;
  fv_outputs(g, lag, ly.n_seg, &o0, &o1);
  // The gradients the outputs read, span a channel: staged in shared
  // memory after the accumulators, as many channels at a time as fit
  // (smoothing up to ~1,900 samples), else read from L2 a few taps at a
  // time
  const int span = FV_SEG - 1 + nsmooth;
  const int room = cpr * (2 * 4 * FV_SPAN + FV_SEG + 1) - FV_SEG;
  const int per_round = span <= room ? min(c_max, room / span) : 1;
  const bool staged = span <= room;
  T* acc_s = stage;
  T* cf_s = stage + FV_SEG;
  for (int o = o0; o <= o1; ++o) {
    const int i0 = o * FV_SEG, i1 = min(t, i0 + FV_SEG);
    int nw = 0;
    fv_wait_share(flag_cf, max(i0 - half, 0) / FV_SEG,
                  min(min(i1 - 1 + ahead, t - 1) / FV_SEG, g - 1), 1, &nw);
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      acc_s[i - i0] = T(0);
    }
    __syncthreads();
    for (int c0 = 0; c0 < c_max; c0 += per_round) {
      const int nc = min(per_round, c_max - c0);
      if (staged) {
        for (int x = threadIdx.x; x < nc * span; x += blockDim.x) {
          const int cc = x / span, k = i0 - half + x - cc * span;
          cf_s[x] = k >= 0 && k < t
                        ? __ldcg(cf_rows + (long long)(c0 + cc) * t + k)
                        : T(0);
        }
        __syncthreads();
      }
      for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
        T acc = acc_s[i - i0];
        for (int cc = 0; cc < nc; ++cc) {
          const T* cf = cf_rows + (long long)(c0 + cc) * t;
          const T* taps = cf_s + cc * span + i - i0;
          T v = T(0);
          if (nsmooth == 1) {
            v = staged ? taps[0] : __ldcg(cf + i);
          } else if (staged) {
            v = fe_mul(taps[0], smooth_weight);
            for (int j = 1; j < nsmooth; ++j) {
              v = fe_add(v, fe_mul(taps[j], smooth_weight));
            }
          } else {
            // the taps in order, eight loads in flight at a time
            for (int j0 = 0; j0 < nsmooth; j0 += FV_TAPS) {
              T tap[FV_TAPS];
#pragma unroll
              for (int r = 0; r < FV_TAPS; ++r) {
                const int k = i - half + j0 + r;
                tap[r] = j0 + r < nsmooth && k >= 0 && k < t
                             ? __ldcg(cf + k)
                             : T(0);
              }
#pragma unroll
              for (int r = 0; r < FV_TAPS; ++r) {
                if (j0 + r < nsmooth) {
                  const T term = fe_mul(tap[r], smooth_weight);
                  v = j0 + r == 0 ? term : fe_add(v, term);
                }
              }
            }
          }
          v = fe_add(T(1), v);
          if (i < lo_edge || i >= hi_edge) v = T(1);
          acc = fe_add(acc, fe_mul(fe_mul(v, v), mask[c0 + cc]));
        }
        acc_s[i - i0] = acc;
      }
      __syncthreads();
    }
    for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
      out_row[i] =
          fe_clamp_min(fe_sqrt(fe_div(acc_s[i - i0], n_live)), min_onset);
    }
  }
}

// Shared memory of a launch: the ticket, then (FE1) the outputs'
// accumulators and a round of cpr channels' three windows, or (FE2) a
// round's two windows of four powers and its kurtosis.
static size_t fv_channel_values(bool kurtosis) {
  return kurtosis ? 2 * 4 * FV_SPAN + FV_SEG + 1 : 3 * FV_SPAN;
}

static int fv_cpr(bool kurtosis, int c_max, size_t item) {
  const size_t fit = FV_BUDGET / (fv_channel_values(kurtosis) * item);
  return (int)std::max<size_t>(1, std::min<size_t>(fit, (size_t)c_max));
}

static size_t fv_smem_bytes(bool kurtosis, int cpr, size_t item) {
  return 16 + ((kurtosis ? 0 : FV_SEG) + cpr * fv_channel_values(kurtosis)) *
                  item;
}

static int fv_check(int n_slots, int c_max, int t, const FvLayout& ly) {
  if (n_slots < 1 || c_max < 1 || t < 1 ||
      (long long)n_slots * ly.n_seg > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
static int fv1_launch(const void* channels, const void* chan_mask,
                      const void* slot_mask, const void* nsta,
                      const void* nlta, void* out, void* available,
                      void* workspace, int n_slots, int c_max, int t,
                      int centred, int mode, int min_lo, int min_hi,
                      void* stream) {
  const FvLayout ly = fv_layout(n_slots, c_max, t, 1, false);
  if (fv_check(n_slots, c_max, t, ly) != 0 || mode < FE_SQUARE ||
      mode > FE_IDENTITY) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ints = static_cast<int*>(workspace);
  cudaError_t err = cudaMemsetAsync(ints, 0, ly.n_ints * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int cpr = fv_cpr(false, c_max, sizeof(T));
  qm_fv1_stalta_kernel<T><<<n_slots * ly.n_seg, FV_THREADS,
                            fv_smem_bytes(false, cpr, sizeof(T)), s>>>(
      static_cast<const T*>(channels), static_cast<const T*>(chan_mask),
      static_cast<const T*>(slot_mask), static_cast<const int*>(nsta),
      static_cast<const int*>(nlta), static_cast<T*>(out),
      static_cast<T*>(available), ints,
      reinterpret_cast<T*>(static_cast<char*>(workspace) + ly.int_bytes), ly,
      n_slots, c_max, t, centred, mode, cpr,
      (T)fe_bits_to_double(min_lo, min_hi), std::numeric_limits<T>::min());
  return (int)cudaGetLastError();
}

template <typename T>
static int fv2_launch(const void* channels, const void* chan_mask,
                      const void* slot_mask, const void* nkurt, void* out,
                      void* available, void* workspace, int n_slots,
                      int c_max, int t, int nsmooth, int taper_pad,
                      int min_lo, int min_hi, void* stream) {
  const FvLayout ly = fv_layout(n_slots, c_max, t, 4, true);
  if (fv_check(n_slots, c_max, t, ly) != 0 || nsmooth < 1 || taper_pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ints = static_cast<int*>(workspace);
  cudaError_t err = cudaMemsetAsync(ints, 0, ly.n_ints * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int cpr = fv_cpr(true, c_max, sizeof(T));
  // sqrt(tiny) is a power of two in both types, so exact
  const T sqrt_tiny = (T)std::sqrt((double)std::numeric_limits<T>::min());
  qm_fv2_kurtosis_kernel<T><<<n_slots * ly.n_seg, FV_THREADS,
                              fv_smem_bytes(true, cpr, sizeof(T)), s>>>(
      static_cast<const T*>(channels), static_cast<const T*>(chan_mask),
      static_cast<const T*>(slot_mask), static_cast<const int*>(nkurt),
      static_cast<T*>(out), static_cast<T*>(available), ints,
      reinterpret_cast<T*>(static_cast<char*>(workspace) + ly.int_bytes), ly,
      n_slots, c_max, t, nsmooth, taper_pad, cpr,
      (T)fe_bits_to_double(min_lo, min_hi), sqrt_tiny, (T)(1.0 / nsmooth));
  return (int)cudaGetLastError();
}

// Bytes of a launch's workspace (kurtosis 0 for FE1 v2, 1 for FE2 v2);
// -1 for a shape the kernels do not take.
extern "C" long long qm_front_end_v2_workspace_bytes(int kurtosis,
                                                     int n_slots, int c_max,
                                                     int t, int itemsize) {
  if (n_slots < 1 || c_max < 1 || t < 1) return -1;
  const FvLayout ly =
      fv_layout(n_slots, c_max, t, kurtosis ? 4 : 1, kurtosis != 0);
  return ly.int_bytes + ly.n_vals * itemsize;
}

// All arrays contiguous on the device, in the entry's float type; the
// window lengths int32; workspace of qm_front_end_v2_workspace_bytes
// bytes, 16-byte aligned (the kernel zeroes its ints on the stream first).
// min_onset_value is a double passed as its two 32-bit halves (low,
// high). mode: 0 square, 1 abs, 2 identity.
extern "C" int qm_front_end_stalta_v2_f32(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nsta, const void* nlta, void* out, void* available,
    void* workspace, int n_slots, int c_max, int t, int centred, int mode,
    int min_lo, int min_hi, void* stream) {
  return fv1_launch<float>(channels, chan_mask, slot_mask, nsta, nlta, out,
                           available, workspace, n_slots, c_max, t, centred,
                           mode, min_lo, min_hi, stream);
}

extern "C" int qm_front_end_stalta_v2_f64(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nsta, const void* nlta, void* out, void* available,
    void* workspace, int n_slots, int c_max, int t, int centred, int mode,
    int min_lo, int min_hi, void* stream) {
  return fv1_launch<double>(channels, chan_mask, slot_mask, nsta, nlta, out,
                            available, workspace, n_slots, c_max, t, centred,
                            mode, min_lo, min_hi, stream);
}

extern "C" int qm_front_end_kurtosis_v2_f32(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nkurt, void* out, void* available, void* workspace,
    int n_slots, int c_max, int t, int nsmooth, int taper_pad, int min_lo,
    int min_hi, void* stream) {
  return fv2_launch<float>(channels, chan_mask, slot_mask, nkurt, out,
                           available, workspace, n_slots, c_max, t, nsmooth,
                           taper_pad, min_lo, min_hi, stream);
}

extern "C" int qm_front_end_kurtosis_v2_f64(
    const void* channels, const void* chan_mask, const void* slot_mask,
    const void* nkurt, void* out, void* available, void* workspace,
    int n_slots, int c_max, int t, int nsmooth, int taper_pad, int min_lo,
    int min_hi, void* stream) {
  return fv2_launch<double>(channels, chan_mask, slot_mask, nkurt, out,
                            available, workspace, n_slots, c_max, t, nsmooth,
                            taper_pad, min_lo, min_hi, stream);
}

#ifdef __CUDACC__
// Resident blocks per SM of FE1 v2 (kurtosis 0) or FE2 v2 at c_max
// channels in float32 (f64 0) or float64; a negative CUDA error on failure.
extern "C" int qm_front_end_v2_blocks_per_sm(int kurtosis, int f64,
                                             int c_max) {
  const size_t item = f64 ? sizeof(double) : sizeof(float);
  const size_t smem =
      fv_smem_bytes(kurtosis != 0, fv_cpr(kurtosis != 0, c_max, item), item);
  int blocks = 0;
  cudaError_t err;
  if (kurtosis) {
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_fv2_kurtosis_kernel<double>, FV_THREADS, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_fv2_kurtosis_kernel<float>, FV_THREADS, smem);
  } else {
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_fv1_stalta_kernel<double>, FV_THREADS, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, qm_fv1_stalta_kernel<float>, FV_THREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}
#endif
