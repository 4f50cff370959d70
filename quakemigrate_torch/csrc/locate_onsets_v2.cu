// ON1 v2 and ON2 v2: the onset functions of locate, of the standard detect
// path and of core.compat redesigned for Hopper (sm_90a) as a grid of row
// segments, one launch a call.
//
// Replace no Pallas kernel: the JAX package computes them as jitted XLA
// code, quakemigrate_tpu/ops/stalta.py:39 (overlapping_sta_lta) and :57
// (centred_sta_lta) for ON1 v2, quakemigrate_tpu/ops/kurtosis.py:69
// (kurtosis_onset, with rolling_kurtosis, :32) for ON2 v2. ON1 and ON2
// (csrc/locate_onsets.cu, one block a row or station) were their first
// forms and stay as the yardstick. The plain versions are ops/stalta.py's
// overlapping_sta_lta_plain, centred_sta_lta_plain and
// station_sta_lta_plain, and ops/kurtosis.py's kurtosis_onset_plain and
// station_kurtosis_onset_plain.
//
// Contract (ON1's and ON2's). Per row of x [rows, t], static window
// lengths: ON1 v2 the classic or centred STA/LTA of the row's transform,
// ON2 v2 the kurtosis onset (the trailing kurtosis from the four power
// sums, the rectified gradient with its first sample 0, the box smoothing
// in numpy.convolve's "same" alignment, 1 + cf). Every running sum is
// added as ops/rolling.py's blocked_cumsum adds it (C_0(p) = I_0(p) +
// C_1(p / 16 - 1), C_1(j) = I_1(j) + C_2(j / 16 - 1), ..., I_l a block's
// sequential partial sum at level l; a zero added where the block is a
// level's first, none at the top level, which has at most 16 values), and
// every operation rounds where the plain version rounds
// (front_end_math.cuh). Rows mode (offsets NULL) writes every row's onset;
// stations mode (offsets [units + 1]) sets each row's first lo_edge and
// its samples from hi_edge to 1, adds the squares of a station's rows in
// row order, divides by the row count, takes the root and clamps to
// min_onset_value. So the output is the plain version's bit for bit, for
// any row length and window.
//
// Bound. The rows are read once and the onsets written once: rows x t x
// the item size each way, a few dozen operations a sample. ON1 and ON2
// walked a row on one SM, four times over for ON2's powers, through a
// workspace the size of the row.
//
// Design. A tile is a unit (a row, or a station's rows) and a segment of
// its rows; it does its segment for all of the unit's rows, the combine
// per sample in row order. Short rows (t <= 4,096): levels 0-2 of the
// rule hold the whole row (level 2 is the top), so a tile rebuilds what
// it reads: it stages the row's samples up to the last position its
// outputs read, adds their level-1 and level-2 totals and the top's
// running sum, and so C_1 of every block. No flag, workspace or memset;
// the segment is chosen on the host so that units x segments tiles fill
// the card. Long rows (t > 4,096): a tile is 4,096 samples, one level-2
// block whole, so levels 0-2 are local and its total is one entry of
// level 3. Levels 3 and up go through a workspace with release / acquire
// flags in the rule's order, as FE1 v2's levels 2 and up
// (csrc/front_end_v2.cu): tiles take their index from a counter of the
// launch (zeroed by a memset on the stream first: the long form only runs
// where a call moves at least 4,096 samples a row, and a workspace kept
// between calls would tie the wrapper to one stream), unit-minor, so a
// tile waits only on tiles already running. A tile writes its level-1
// partial sums I_1, publishes its level-3 values, waits for the entries
// of its block of 16 before it (and the running sum of the block before,
// published by the tile that closed it), takes C_3 of the two tiles
// before it and from them C_2 of the level-2 value before each of its
// blocks of 16, which it publishes; C_1 is I_1 plus that C_2, added by the
// tile that reads it. The tile that closes a block of 16 climbs. No tile
// waits on another's C_1 to form its own, so no chain runs along a row.
// The outputs: each pass covers a chunk of outputs (ON1 4,096, ON2 1,024
// and at most 64 smoothing taps a pass); every position it reads (the
// sample, the LTA's, STA's and kurtosis windows' other ends, the centred
// STA's end and the smoothing's taps ahead) lies in a window of at most a
// chunk and a block. All the windows' samples (and a short row's) are
// copied at once into shared memory (cp.async, coalesced 16-byte chunks
// where the row is aligned), long rows' flags awaited meanwhile; a thread
// a block of 16 then reads its samples once (16-byte shared loads; the
// chunks of a block are permuted so that neither these nor a thread a
// sample conflict on banks) and, a power at a time, adds I_0 and C_1 of
// the block before in place; then a thread an output. Where outputs read
// ahead, a long row's tile outputs lag it by as many tiles as they read
// ahead (the unit's last tile takes the rest), so every C_1 a window
// reads is published. No instance may spill: a spilling build of ON2 v2
// in float64 gave wrong onsets on the card.

#include <cuda_runtime.h>

#include "front_end_math.cuh"

#define OV_THREADS 256
// A long row's tile: one level-2 block of the rule (16 segments of 256)
#define OV_TILE 4096
// Level-1 values (blocks of 16) and level-2 values of a tile
#define OV_L1 256
#define OV_L2 16
// Outputs of a pass of ON1 v2 and of ON2 v2, and ON2 v2's taps a pass
#define OV_CH1 4096
#define OV_CH2 1024
#define OV_KC 64
// Short rows' segments are at least this many samples
#define OV_MIN_SEG 256
// Resident blocks an SM each kernel asks the compiler to allow: as many
// as leave the registers each instance needs without a spill (a tile is a
// chain of dependent round trips, so the more resident, the more in
// flight; ON1 v2 in float32 at 4 spills 36 bytes)
#define OV1_MIN_BLOCKS_F32 3
#define OV1_MIN_BLOCKS_F64 2
#define OV2_MIN_BLOCKS_F32 2
#define OV2_MIN_BLOCKS_F64 1

#ifdef __CUDACC__
__device__ __forceinline__ int ov_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void ov_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void ov_wait(const int* flag, int at_least) {
  while (ov_acquire(flag) < at_least) __nanosleep(64);
}

// Asynchronous copies into shared memory: 16 bytes (both addresses
// 16-byte aligned), or one value; then the wait for this thread's copies
__device__ __forceinline__ void ov_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void ov_cp1(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void ov_cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
#else
inline void ov_cp16(void* dst, const void* src) { memcpy(dst, src, 16); }
template <typename T>
inline void ov_cp1(T* dst, const T* src) {
  *dst = *src;
}
inline void ov_cp_wait() {}
#endif

// Called by the whole block after it wrote what the flag covers: the
// barrier orders the block's writes before thread 0's release.
__device__ __forceinline__ void ov_publish(int* flag, int value) {
  __syncthreads();
  if (threadIdx.x == 0) ov_release(flag, value);
}

// Each thread waits on every blockDim.x-th of the flags [first, last] of
// this list's calls (nw counts them), so the block's waits overlap.
__device__ __forceinline__ void ov_wait_share(const int* flags, int first,
                                              int last, int at_least,
                                              int* nw) {
  for (int x = first; x <= last; ++x, ++*nw) {
    if (*nw % blockDim.x == threadIdx.x) ov_wait(flags + x, at_least);
  }
}

// The n (at most 16) workspace values at x, all loads in flight before
// the first use, the rest zero
template <typename T>
__device__ __forceinline__ void ov_load16_cg(const T* x, int n, T* v) {
#pragma unroll
  for (int r = 0; r < FE_BLOCK; ++r) v[r] = r < n ? __ldcg(x + r) : T(0);
}

// The sequential partial sums of the n (1 to 16) values at v into out
// (in place where out is v), every value read before the first addition;
// returns the last
template <typename T>
__device__ __forceinline__ T ov_walk16(const T* v, int n, T* out) {
  T a[FE_BLOCK];
#pragma unroll
  for (int r = 0; r < FE_BLOCK; ++r) a[r] = r < n ? v[r] : T(0);
  T acc = a[0];
  out[0] = acc;
#pragma unroll
  for (int r = 1; r < FE_BLOCK; ++r) {
    if (r < n) {
      acc = fe_add(a[r], acc);
      out[r] = acc;
    }
  }
  return acc;
}

// Staged samples and running sums in shared memory: blocks of 16 values,
// unpadded, the 16-byte chunks of block b permuted by ov_swz(b), so that
// a 16-byte copy lands whole, a thread reading its block of 16 chunk by
// chunk (8 threads a phase) and consecutive threads reading consecutive
// values each hit distinct banks.
template <typename T>
struct OvChunk {
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int N = FE_BLOCK / VW;
};

template <typename T>
__device__ __forceinline__ int ov_swz(int b) {
  return sizeof(T) == 8 ? (b & 7) : ((b >> 1) & 3);
}

// Index of offset k of a window (from its block-aligned start)
template <typename T>
__device__ __forceinline__ int ov_at(int k) {
  constexpr int VW = OvChunk<T>::VW;
  const int b = k >> 4, r = k & 15;
  return (b << 4) + (((r / VW) ^ ov_swz<T>(b)) * VW) + r % VW;
}

// Block b's 16 values of a window into v, or v into them
template <typename T>
__device__ __forceinline__ void ov_ld_block(const T* buf, int b, T* v) {
  constexpr int VW = OvChunk<T>::VW;
#pragma unroll
  for (int c = 0; c < OvChunk<T>::N; ++c) {
    const T* p = buf + (b << 4) + ((c ^ ov_swz<T>(b)) * VW);
#ifdef __CUDACC__
    if constexpr (sizeof(T) == 8) {
      const double2 a = *reinterpret_cast<const double2*>(p);
      v[c * VW] = a.x;
      v[c * VW + 1] = a.y;
    } else {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[c * VW] = a.x;
      v[c * VW + 1] = a.y;
      v[c * VW + 2] = a.z;
      v[c * VW + 3] = a.w;
    }
#else
    memcpy(v + c * VW, p, 16);
#endif
  }
}

template <typename T>
__device__ __forceinline__ void ov_st_block(T* buf, int b, const T* v) {
  constexpr int VW = OvChunk<T>::VW;
#pragma unroll
  for (int c = 0; c < OvChunk<T>::N; ++c) {
    T* p = buf + (b << 4) + ((c ^ ov_swz<T>(b)) * VW);
#ifdef __CUDACC__
    if constexpr (sizeof(T) == 8) {
      *reinterpret_cast<double2*>(p) = make_double2(v[c * VW], v[c * VW + 1]);
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(
          v[c * VW], v[c * VW + 1], v[c * VW + 2], v[c * VW + 3]);
    }
#else
    memcpy(p, v + c * VW, 16);
#endif
  }
}

// The workspace of a long-row launch: ints (the tiles' counter, then a
// flag an entry of levels 3 and up a unit (1: the value is published, 2:
// its running sum too), then a flag a tile for its level-1 values), then
// values of the rows' type: each row and power's level-3-and-up entries
// (up_val) and, from level 4, their running sums (up_run); each tile's
// I_2, then C_2 of the level-2 value before each of its blocks of 16 (i2,
// 16 a tile); the level-1 partial sums I_1 (c1, OV_L1 a tile). C_1(j) is
// I_1(j) plus its block's i2, added by the tile that reads it.
struct OvWs {
  int n_tiles, up_count, up_stride;
  int up_n[FE_MAX_LEVELS], up_off[FE_MAX_LEVELS];
  long long n1, flags_c1, n_ints, int_bytes;
  long long up_run, i2, c1, n_vals;
};

static OvWs ov_ws(int units, int rows, int t, int powers) {
  OvWs ws;
  memset(&ws, 0, sizeof ws);
  if (t <= OV_TILE) return ws;
  const FeLevels lv = fe_levels(t);
  ws.n_tiles = (t + OV_TILE - 1) / OV_TILE;
  ws.n1 = (long long)ws.n_tiles * OV_L1;
  ws.up_count = lv.count - 2;
  for (int u = 0; u < ws.up_count; ++u) {
    ws.up_n[u] = lv.n[u + 2];
    ws.up_off[u] = lv.off[u + 2] - lv.off[2];
  }
  ws.up_stride = lv.stride - lv.off[2];
  ws.flags_c1 = 1 + (long long)units * ws.up_stride;
  ws.n_ints = ws.flags_c1 + (long long)units * ws.n_tiles;
  ws.int_bytes = (ws.n_ints * 4 + 15) / 16 * 16;
  const long long rp = (long long)rows * powers;
  ws.up_run = rp * ws.up_stride;
  ws.i2 = 2 * ws.up_run;
  ws.c1 = ws.i2 + rp * ws.n_tiles * OV_L2;
  ws.n_vals = ws.c1 + rp * ws.n1;
  return ws;
}

// A launch's grid and shared memory (values of the rows' type). Short
// rows: tiles of seg outputs, a pass each; long rows: tiles of OV_TILE
// samples whose outputs lag them by lag tiles, in passes of chunk. A
// window holds wcap values, its blocks' C_1 bcap; region holds the
// windows (nbuf of them, a power of a window each) and, for short rows
// after them, the row's staged samples (for long rows those alias the
// windows).
struct OvGrid {
  int long_form, n_tiles, seg, chunk, lag;
  int wcap, nbuf, region, bcap, kcap;
};

// ON1's transformed sample, or ON2's four powers: all at once, or power
// e alone (the same operations)
template <typename T>
struct OvTransform {
  static constexpr int P = 1;
  int mode;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    p[0] = fe_transform(v, mode);
  }
  __device__ __forceinline__ T power(T v, int) const {
    return fe_transform(v, mode);
  }
};

template <typename T>
struct OvPowers {
  static constexpr int P = 4;
  __device__ __forceinline__ void operator()(T v, T* p) const {
    fe_powers(v, p);
  }
  __device__ __forceinline__ T power(T v, int e) const {
    if (e == 0) return v;
    const T v2 = fe_mul(v, v);
    return e == 1 ? v2 : (e == 2 ? fe_mul(v, v2) : fe_mul(v2, v2));
  }
};

// A window: positions [lo, hi) of a row, lo a multiple of 16 (empty where
// hi <= lo)
struct OvWin {
  int lo, hi;
};

// The positions [first, last] within the row, from first's block
__device__ __forceinline__ OvWin ov_window(long long first, long long last,
                                           int t) {
  first = first < 0 ? 0 : first;
  last = last > t - 1 ? t - 1 : last;
  if (last < first) return {0, 0};
  const int f = (int)first;
  return {f - f % FE_BLOCK, (int)last + 1};
}

__device__ __forceinline__ int ov_blocks(OvWin w) {
  return w.hi > w.lo ? (w.hi - w.lo + FE_BLOCK - 1) / FE_BLOCK : 0;
}

template <typename T>
__device__ __forceinline__ T ov_get(const T* buf, OvWin w, int p) {
  return buf[ov_at<T>(p - w.lo)];
}

// Start the copy of window w's samples of a row into buf: 16-byte copies,
// coalesced, where the window's start is aligned, else one value a copy
// (also for the last values short of a chunk)
template <typename T>
__device__ void ov_stage_x(const T* row, OvWin w, T* buf) {
  constexpr int VW = OvChunk<T>::VW;
  const int n = w.hi - w.lo;
  const T* src = row + w.lo;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / VW;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      ov_cp16(buf + ov_at<T>(v * VW), src + v * VW);
    }
    done = nv * VW;
  }
  for (int k = done + threadIdx.x; k < n; k += blockDim.x) {
    ov_cp1(buf + ov_at<T>(k), src + k);
  }
}

// The level-1 values (each block of 16's total, every power) of the len
// staged samples xs into tot[e OV_L1 + b]
template <typename T, class S>
__device__ void ov_block_totals(const S& f, const T* xs, int len, T* tot) {
  constexpr int P = S::P;
  for (int b = threadIdx.x; b * FE_BLOCK < len; b += blockDim.x) {
    const int m = min(FE_BLOCK, len - b * FE_BLOCK);
    T v[FE_BLOCK];
    ov_ld_block(xs, b, v);
    T acc[P], p[P];
    f(v[0], acc);
#pragma unroll
    for (int r = 1; r < FE_BLOCK; ++r) {
      if (r < m) {
        f(v[r], p);
#pragma unroll
        for (int e = 0; e < P; ++e) acc[e] = fe_add(p[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < P; ++e) tot[e * OV_L1 + b] = acc[e];
  }
}

// Short rows: C_1 of the row's blocks [0, ceil(len / 16)) into tot[e OV_L1
// + j] (tot then holds P OV_L2 more values), from its first len samples
// staged in xs. Leaves the block synchronised.
template <typename T, class S>
__device__ void ov_scan_short(const S& f, int t, int len, const T* xs,
                              T* tot) {
  constexpr int P = S::P;
  T* top = tot + P * OV_L1;
  const int nb = (len + FE_BLOCK - 1) / FE_BLOCK;
  const int ng = (nb + FE_BLOCK - 1) / FE_BLOCK;
  ov_block_totals(f, xs, len, tot);
  __syncthreads();
  // I_1 in groups of 16, in place; each group's total (level 2) to top
  for (int item = threadIdx.x; item < P * ng; item += blockDim.x) {
    const int e = item / ng, g = item - e * ng;
    T* v = tot + e * OV_L1 + g * FE_BLOCK;
    top[e * OV_L2 + g] = ov_walk16(v, min(FE_BLOCK, nb - g * FE_BLOCK), v);
  }
  __syncthreads();
  if ((t + FE_BLOCK - 1) / FE_BLOCK > FE_BLOCK) {
    // Level 2 is the top: its running sum in sequence; then C_1 is I_1
    // plus C_2 of the group before (a zero for the first)
    for (int e = threadIdx.x; e < P; e += blockDim.x) {
      ov_walk16(top + e * OV_L2, ng, top + e * OV_L2);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < P * nb; item += blockDim.x) {
      const int e = item / nb, j = item - e * nb;
      const T before = j >= FE_BLOCK ? top[e * OV_L2 + j / FE_BLOCK - 1]
                                     : T(0);
      tot[e * OV_L1 + j] = fe_add(tot[e * OV_L1 + j], before);
    }
    __syncthreads();
  }
}

// C_3(h) of a row and power from its level-3 entries (val) and level-4
// running sums (run) in the workspace
template <typename T>
__device__ T ov_c3(const T* val, const T* run, const OvWs& ws, int h) {
  const int h0 = h - h % FE_BLOCK;
  T v[FE_BLOCK];
  ov_load16_cg(val + h0, h - h0 + 1, v);
  T acc = v[0];
#pragma unroll
  for (int r = 1; r < FE_BLOCK; ++r) {
    if (h0 + r <= h) acc = fe_add(v[r], acc);
  }
  if (ws.up_count <= 1) return acc;
  return fe_add(acc, h >= FE_BLOCK
                         ? __ldcg(run + ws.up_off[1] + h / FE_BLOCK - 1)
                         : T(0));
}

// Long rows: tile g of the unit's rows [r0, r1). Adds its local levels
// (I_1 to the workspace), publishes its level-3 values, forms C_2 of the
// level-2 value before each of its blocks of 16 and publishes them
// (flag_c1). flags: the unit's level flags; xs: shared values for a
// tile's samples; tot: P (OV_L1 + OV_L2) values.
template <typename T, class S>
__device__ void ov_scan_long(const S& f, const T* x, int r0, int r1, int t,
                             int g, const OvWs& ws, int* flags, int* flag_c1,
                             T* vals, T* xs, T* tot) {
  constexpr int P = S::P;
  T* top = tot + P * OV_L1;
  T* up_val = vals;
  T* up_run = vals + ws.up_run;
  T* i2 = vals + ws.i2;
  T* c1 = vals + ws.c1;
  const int start = g * OV_TILE;
  const int len = min(OV_TILE, t - start);
  const int nb = (len + FE_BLOCK - 1) / FE_BLOCK;
  const int ng = (nb + FE_BLOCK - 1) / FE_BLOCK;
  const int n_rp = (r1 - r0) * P;
  for (int r = r0; r < r1; ++r) {
    // the last row's I_1 and I_2 stay in tot and top until the level-3
    // entries are published, so that the release waits on those alone
    const bool last = r == r1 - 1;
    __syncthreads();
    ov_stage_x(x + (long long)r * t, OvWin{start, start + len}, xs);
    ov_cp_wait();
    __syncthreads();
    ov_block_totals(f, xs, len, tot);
    __syncthreads();
    // I_1 in groups of 16 to the workspace; each group's total to top
    for (int item = threadIdx.x; item < P * ng; item += blockDim.x) {
      const int e = item / ng, j = item - e * ng;
      T* v = tot + e * OV_L1 + j * FE_BLOCK;
      T* dst = last ? v
                    : c1 + (long long)(r * P + e) * ws.n1 + g * OV_L1 +
                          j * FE_BLOCK;
      top[e * OV_L2 + j] = ov_walk16(v, min(FE_BLOCK, nb - j * FE_BLOCK), dst);
    }
    __syncthreads();
    // I_2; its last value is the tile's entry of level 3
    for (int e = threadIdx.x; e < P; e += blockDim.x) {
      const long long rp = (long long)r * P + e;
      T* v = top + e * OV_L2;
      up_val[rp * ws.up_stride + g] =
          ov_walk16(v, ng, last ? v : i2 + (rp * ws.n_tiles + g) * OV_L2);
    }
  }
  ov_publish(flags + g, 1);
  for (int item = threadIdx.x; item < P * nb; item += blockDim.x) {
    const int e = item / nb, j = item - e * nb;
    const long long rp = (long long)(r1 - 1) * P + e;
    c1[rp * ws.n1 + g * OV_L1 + j] = tot[e * OV_L1 + j];
    if (j < ng) i2[(rp * ws.n_tiles + g) * OV_L2 + j] = top[e * OV_L2 + j];
  }

  // Levels 3 and up. This tile's entries are published; wait for the
  // entries of the blocks of 16 before tiles g - 1 and g - 2 (and C_4 of
  // the blocks before those, from the tiles that closed them); a tile
  // whose entry closes a block of 16 climbs, as FE1 v2's segments do a
  // level lower.
  const bool outer = ws.up_count > 1;
  const int j0 = g - g % FE_BLOCK;
  const bool climb =
      outer && (g % FE_BLOCK == FE_BLOCK - 1 || g == ws.up_n[0] - 1);
  int nw = 0;
  if (g >= 1) {
    const int m = g >= 2 ? g - 2 : g - 1;
    ov_wait_share(flags, m - m % FE_BLOCK, g - 1, 1, &nw);
    for (int h = g - 1; outer && h >= m; --h) {
      if (h >= FE_BLOCK) {
        ov_wait_share(flags + ws.up_off[1], h / FE_BLOCK - 1,
                      h / FE_BLOCK - 1, 2, &nw);
      }
    }
  }
  __syncthreads();
  // C_2 of the level-2 value before each of the tile's blocks of 16, over
  // i2: I_2 plus C_3(g - 1), and for its first block the tile before's
  // total plus C_3(g - 2) (zeros where the row begins)
  for (int item = threadIdx.x; item < n_rp; item += blockDim.x) {
    const long long rp = (long long)r0 * P + item;
    const T* val = up_val + rp * ws.up_stride;
    const T* run = up_run + rp * ws.up_stride;
    T* d = i2 + (rp * ws.n_tiles + g) * OV_L2;
    // one array of 16 live at a time, so that no instance spills
    const T c3 = g >= 1 ? ov_c3(val, run, ws, g - 1) : T(0);
    const T first = g >= 1 ? fe_add(__ldcg(val + g - 1),
                                    g >= 2 ? ov_c3(val, run, ws, g - 2)
                                           : T(0))
                           : T(0);
    T i2v[OV_L2];
    ov_load16_cg(d, ng, i2v);
    d[0] = first;
#pragma unroll
    for (int j = 1; j < OV_L2; ++j) {
      if (j < ng) d[j] = fe_add(i2v[j - 1], c3);
    }
  }
  for (int item = threadIdx.x; climb && item < n_rp; item += blockDim.x) {
    const long long rp = (long long)r0 * P + item;
    T v[FE_BLOCK];
    ov_load16_cg(up_val + rp * ws.up_stride + j0, g - j0 + 1, v);
    T acc = v[0];
#pragma unroll
    for (int r = 1; r < FE_BLOCK; ++r) {
      if (j0 + r <= g) acc = fe_add(v[r], acc);
    }
    up_val[rp * ws.up_stride + ws.up_off[1] + g / FE_BLOCK] = acc;
  }
  ov_publish(flag_c1 + g, 1);
  for (int u = 1, j = g / FE_BLOCK; climb; ++u, j /= FE_BLOCK) {
    // entry j of level u + 3, written above (or by the step before)
    ov_publish(flags + ws.up_off[u] + j, 1);
    const int i0 = j - j % FE_BLOCK;
    const bool above = u + 1 < ws.up_count;
    nw = 0;
    ov_wait_share(flags + ws.up_off[u], i0, j - 1, 1, &nw);
    if (above && j >= FE_BLOCK) {
      ov_wait_share(flags + ws.up_off[u + 1], j / FE_BLOCK - 1,
                    j / FE_BLOCK - 1, 2, &nw);
    }
    __syncthreads();
    const bool up =
        above && (j % FE_BLOCK == FE_BLOCK - 1 || j == ws.up_n[u] - 1);
    for (int item = threadIdx.x; item < n_rp; item += blockDim.x) {
      const long long row = ((long long)r0 * P + item) * ws.up_stride;
      T v[FE_BLOCK];
      ov_load16_cg(up_val + row + ws.up_off[u] + i0, j - i0 + 1, v);
      T acc = v[0];
#pragma unroll
      for (int r = 1; r < FE_BLOCK; ++r) {
        if (i0 + r <= j) acc = fe_add(v[r], acc);
      }
      up_run[row + ws.up_off[u] + j] =
          !above ? acc
                 : fe_add(acc, j >= FE_BLOCK
                                   ? __ldcg(up_run + row + ws.up_off[u + 1] +
                                            j / FE_BLOCK - 1)
                                   : T(0));
      if (up) up_val[row + ws.up_off[u + 1] + j / FE_BLOCK] = acc;
    }
    ov_publish(flags + ws.up_off[u] + j, 2);
    if (!up) break;
  }
}

// Where a row's windows find C_1 of the block before each of their
// blocks: the row's C_1 in shared memory (short rows, OV_L1 a power), or
// its I_1 (c1, n1 a power) plus its block of 16's C_2 before (i2, 16 a
// tile of a power) in the workspace (long rows); outer: t > 16 (else C_0
// is I_0).
template <typename T>
struct OvC1 {
  const T* s;
  const T* c1;
  const T* i2;
  long long n1;
  int n_tiles;
  bool outer;
  __device__ __forceinline__ T before(int e, int q) const {
    if (q == 0) return T(0);
    if (s != nullptr) return s[e * OV_L1 + q - 1];
    const int p = q - 1;
    return fe_add(__ldcg(c1 + e * n1 + p),
                  __ldcg(i2 + ((long long)e * n_tiles + p / OV_L1) * OV_L2 +
                         (p % OV_L1) / FE_BLOCK));
  }
};

// Long rows: wait for C_1 of the tiles before g whose blocks the windows'
// blocks follow (tile g's own is in place after the barrier of its
// publication); synchronises the block.
__device__ void ov_wait_c1(const OvWin* w, int n_win, const int* flag_c1,
                           int g) {
  int nw = 0;
  for (int k = 0; k < n_win; ++k) {
    if (w[k].hi <= w[k].lo) continue;
    const int q1 = (w[k].hi - 1) / FE_BLOCK;
    if (q1 < 1) continue;
    const int q0 = max(w[k].lo / FE_BLOCK, 1);
    ov_wait_share(flag_c1, (q0 - 1) / OV_L1, min((q1 - 1) / OV_L1, g - 1), 1,
                  &nw);
  }
  __syncthreads();
}

// Window k's blocks' C_1 of the block before (power e's at bw[(k P + e)
// bcap + b])
template <typename T, int P>
__device__ void ov_stage_before(const OvWin* w, int n_win, const OvC1<T>& c1,
                                T* bw, int bcap) {
  if (!c1.outer) return;
  for (int k = 0; k < n_win; ++k) {
    const int nb = ov_blocks(w[k]), q0 = w[k].lo / FE_BLOCK;
    for (int item = threadIdx.x; item < P * nb; item += blockDim.x) {
      const int e = item / nb, b = item - e * nb;
      bw[(k * P + e) * bcap + b] = c1.before(e, q0 + b);
    }
  }
}

// Where a pass stages its windows: the windows' buffers (window k's power
// e at region + (k P + e) wcap), their blocks' C_1 (bw), and for short
// rows the row's samples up to what the pass reads (xs, scanned into tot)
// or, for long rows, the published C_1's flags (flag_c1, tile g's)
template <typename T>
struct OvStage {
  T* region;
  int wcap;
  T* bw;
  int bcap;
  T* xs;
  int len;
  T* tot;
  const int* flag_c1;
  int g;
  // a window whose samples window 0's buffer holds already (a one-row
  // unit's tile, staged by its scan), else empty
  OvWin kept;
};

// Stage a pass's n_win windows of a row (and, with scan, a short row's
// samples, scanned): every copy in flight at once, the flags (long rows)
// awaited meanwhile; then the windows' blocks' C_1. Leaves the block
// synchronised.
template <typename T, class S>
__device__ void ov_stage(const S& f, const T* row, int t, const OvWin* w,
                         int n_win, const OvC1<T>& c1, const OvStage<T>& st,
                         bool scan) {
  constexpr int P = S::P;
  __syncthreads();
  for (int k = 0; k < n_win; ++k) {
    if (k == 0 && w[0].lo == st.kept.lo && w[0].hi == st.kept.hi) continue;
    ov_stage_x(row, w[k], st.region + k * P * st.wcap);
  }
  if (scan) ov_stage_x(row, OvWin{0, st.len}, st.xs);
  if (st.flag_c1 != nullptr) ov_wait_c1(w, n_win, st.flag_c1, st.g);
  if (!scan) ov_stage_before<T, P>(w, n_win, c1, st.bw, st.bcap);
  ov_cp_wait();
  __syncthreads();
  if (scan) {
    ov_scan_short(f, t, st.len, st.xs, st.tot);
    ov_stage_before<T, P>(w, n_win, c1, st.bw, st.bcap);
    __syncthreads();
  }
}

// C_0 of every power over n_win staged windows, in place: window k's power
// e at region + (k P + e) wcap, its samples staged as power 0's. A thread
// a block of 16 reads its samples once, then a power at a time adds its
// I_0 in sequence and C_1 of the block before (a power's 16 sums in
// registers at a time, so that no instance spills).
template <typename T, class S>
__device__ void ov_sums(const S& f, const OvWin* w, int n_win,
                        const OvStage<T>& st, bool outer) {
  constexpr int P = S::P;
  const OvWin w0 = w[0];
  const OvWin w1 = n_win > 1 ? w[1] : OvWin{0, 0};
  const OvWin w2 = n_win > 2 ? w[2] : OvWin{0, 0};
  const int n0 = ov_blocks(w0), n1 = ov_blocks(w1);
  const int total = n0 + n1 + ov_blocks(w2);
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    const int k = item < n0 ? 0 : (item < n0 + n1 ? 1 : 2);
    const int b = item - (k == 0 ? 0 : (k == 1 ? n0 : n0 + n1));
    const OvWin wk = k == 0 ? w0 : (k == 1 ? w1 : w2);
    T* buf = st.region + k * P * st.wcap;
    const int m = min(FE_BLOCK, wk.hi - (wk.lo + b * FE_BLOCK));
    T xv[FE_BLOCK];
    ov_ld_block(buf, b, xv);
#pragma unroll 1
    for (int e = 0; e < P; ++e) {
      const T before = outer ? st.bw[(k * P + e) * st.bcap + b] : T(0);
      // one power: the sums over the samples, in the same registers
      T cs[P == 1 ? 1 : FE_BLOCK];
      T* c = P == 1 ? xv : cs;
      T acc = f.power(xv[0], e);
      c[0] = outer ? fe_add(acc, before) : acc;
#pragma unroll
      for (int r = 1; r < FE_BLOCK; ++r) {
        if (r < m) {
          acc = fe_add(f.power(xv[r], e), acc);
          c[r] = outer ? fe_add(acc, before) : acc;
        } else {
          c[r] = T(0);
        }
      }
      ov_st_block(buf + e * st.wcap, b, c);
    }
  }
}

// A unit's rows [*r0, *r1): a station's (offsets) or the row u
__device__ __forceinline__ void ov_rows(const int* offsets, int u, int* r0,
                                        int* r1) {
  *r0 = offsets != nullptr ? offsets[u] : u;
  *r1 = offsets != nullptr ? offsets[u + 1] : u + 1;
}

// A row's onset at sample i into the unit's output: as it is (rows mode),
// or the edges set to 1 and its square added to the rows before it, the
// last row's sum divided, rooted and clamped (stations mode)
template <typename T>
struct OvEmit {
  T* out_row;
  bool stations;
  int lo_edge, hi_edge, r0, r1;
  T min_onset;
  __device__ __forceinline__ void operator()(int i, T onset, int r) const {
    if (!stations) {
      out_row[i] = onset;
      return;
    }
    if (i < lo_edge || i >= hi_edge) onset = T(1);
    const T sq = fe_mul(onset, onset);
    const T acc = r == r0 ? sq : fe_add(out_row[i], sq);
    out_row[i] = r == r1 - 1 ? fe_clamp_min(fe_sqrt(fe_div(acc, (T)(r1 - r0))),
                                            min_onset)
                             : acc;
  }
};

// A tile's place: its unit and its segment (short rows) or tile (long
// rows, from the launch's counter, unit-minor; the ticket goes through
// the first 16 bytes of shared memory)
struct OvTile {
  int u, s;
};

__device__ __forceinline__ OvTile ov_tile(const OvGrid& gr, int* counter,
                                          int* ticket, int units) {
  int k = blockIdx.x;
  if (gr.long_form) {
    if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1);
    __syncthreads();
    k = *ticket;
  }
  return {k % units, k / units};
}

// A long row's output tiles of tile g: g - lag, and for the unit's last
// tile every tile after it too (none where g < lag but for the last)
__device__ __forceinline__ void ov_outputs(int g, int lag, int n_tiles,
                                           int* o0, int* o1) {
  *o0 = max(g - lag, 0);
  *o1 = g == n_tiles - 1 ? n_tiles - 1 : g - lag;
}

// ON1 v2's settings and its pass over outputs [c0, c1) of one row
template <typename T>
struct Ov1 {
  int t, nsta, nlta, nsta_c, centred;
  T frac, tiny;

  // The windows of C_0 the outputs [c0, c1) read: the sample's, the LTA's
  // far end's, the STA's other end's
  __device__ __forceinline__ void windows(int c0, int c1, OvWin* w) const {
    w[0] = ov_window(c0, c1 - 1, t);
    w[1] = ov_window((long long)c0 - nlta, (long long)c1 - 1 - nlta, t);
    w[2] = centred ? ov_window(min(c0 + nsta_c, t - 1),
                               min(c1 - 1 + nsta_c, t - 1), t)
                   : ov_window((long long)c0 - nsta,
                               (long long)c1 - 1 - nsta, t);
  }

  __device__ __forceinline__ int reach(int c1) const {
    return centred ? min(t, c1 + nsta_c) : c1;
  }

  template <class S>
  __device__ void pass(const S& f, const T* row, int c0, int c1, int r,
                       const OvC1<T>& sums, const OvStage<T>& st,
                       const OvEmit<T>& emit) const {
    OvWin w[3];
    windows(c0, c1, w);
    ov_stage(f, row, t, w, 3, sums, st, st.xs != nullptr);
    ov_sums(f, w, 3, st, sums.outer);
    __syncthreads();
    const T* ca = st.region;
    const T* cb = st.region + st.wcap;
    const T* cc = st.region + 2 * st.wcap;
    // one output at a time: its IEEE division's temporaries alone live
#pragma unroll 1
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
      const T hi = ov_get(ca, w[0], i);
      const T lta =
          fe_sub(hi, i - nlta >= 0 ? ov_get(cb, w[1], i - nlta) : T(0));
      T onset;
      if (!centred) {
        const T sta =
            fe_sub(hi, i - nsta >= 0 ? ov_get(cc, w[2], i - nsta) : T(0));
        const T ratio =
            lta < tiny ? T(1)
                       : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
        onset = i >= nlta - 1 ? ratio : T(1);
      } else {
        const T sta = fe_sub(ov_get(cc, w[2], min(i + nsta_c, t - 1)), hi);
        const T ratio =
            lta <= T(0) ? T(1)
                        : fe_mul(fe_div(sta, fe_clamp_min(lta, tiny)), frac);
        onset = (i >= nlta - 1 && i < t - nsta_c) ? ratio : T(1);
      }
      emit(i, onset, r);
    }
  }
};

// ON2 v2's settings and its pass over outputs [c0, c1) of one row: in
// passes of at most OV_KC taps, the kurtosis over the positions the taps
// and the gradient read (kbuf), the rectified gradient (cfbuf), the taps'
// partial sums carried between passes (vbuf)
template <typename T>
struct Ov2 {
  int t, nkurt, nsmooth, half;
  T n, sqrt_tiny, weight;
  T *kbuf, *cfbuf, *vbuf;

  __device__ __forceinline__ int reach(int c1) const {
    return min(t, c1 + max(nsmooth - 1 - half, 0));
  }

  template <class S>
  __device__ void pass(const S& f, const T* row, int c0, int c1, int r,
                       const OvC1<T>& sums, const OvStage<T>& st,
                       const OvEmit<T>& emit) const {
    for (int j0 = 0; j0 < nsmooth; j0 += OV_KC) {
      // the kurtosis at [kl, kh): what taps j0 .. j0 + kc and the
      // gradient read
      const int kc = min(OV_KC, nsmooth - j0);
      const int kl = c0 - half + j0 - 1, kh = c1 - half + j0 + kc - 1;
      const OvWin w[2] = {
          ov_window(kl, kh - 1, t),
          ov_window((long long)kl - nkurt, (long long)kh - 1 - nkurt, t)};
      ov_stage(f, row, t, w, 2, sums, st, st.xs != nullptr && j0 == 0);
      ov_sums(f, w, 2, st, sums.outer);
      __syncthreads();
      const T* ca = st.region;
      const T* cb = st.region + 4 * st.wcap;
      for (int k = max(kl, 0) + threadIdx.x; k < min(kh, t);
           k += blockDim.x) {
        T s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] = fe_sub(ov_get(ca + e * st.wcap, w[0], k),
                        k - nkurt >= 0
                            ? ov_get(cb + e * st.wcap, w[1], k - nkurt)
                            : T(0));
        }
        const T kv = fe_kurtosis_from_sums(s, n, sqrt_tiny);
        kbuf[k - kl] = k >= nkurt - 1 ? kv : T(0);
      }
      __syncthreads();
      for (int k = max(kl + 1, 0) + threadIdx.x; k < min(kh, t);
           k += blockDim.x) {
        cfbuf[k - kl] = fe_clamp_min(
            fe_sub(kbuf[k - kl], kbuf[(k == 0 ? 0 : k - 1) - kl]), T(0));
      }
      __syncthreads();
      const bool last = j0 + kc >= nsmooth;
      for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
        T v;
        if (nsmooth == 1) {
          v = cfbuf[i - kl];
        } else {
          // the taps in smooth_same's order, zeros beyond the row
          v = j0 == 0 ? T(0) : vbuf[i - c0];
          for (int j = j0; j < j0 + kc; ++j) {
            const int k = i - half + j;
            const T term =
                fe_mul(k >= 0 && k < t ? cfbuf[k - kl] : T(0), weight);
            v = j == 0 ? term : fe_add(v, term);
          }
        }
        if (last) {
          emit(i, fe_add(T(1), v), r);
        } else {
          vbuf[i - c0] = v;
        }
      }
    }
  }
};

// The tile's work, for either function: short rows a segment (each row's
// samples up to what the outputs read staged with the windows, scanned,
// then its pass), long rows a tile (every row's levels published, then the
// output tiles' passes, rows in turn within each pass)
template <typename T, class S, class Op>
__device__ void ov_tile_work(const S& f, const Op& op, const T* x,
                             const int* offsets, T* out, int* ints, T* vals,
                             const OvWs& ws, const OvGrid& gr, int units,
                             int t, int lo_edge, int hi_edge, T min_onset,
                             unsigned char* smem) {
  constexpr int P = S::P;
  const OvTile tile = ov_tile(gr, ints, reinterpret_cast<int*>(smem), units);
  T* region = reinterpret_cast<T*>(smem + 16);
  T* tot = region + gr.region;
  int r0, r1;
  ov_rows(offsets, tile.u, &r0, &r1);
  const OvEmit<T> emit{out + (long long)tile.u * t, offsets != nullptr,
                       lo_edge, hi_edge, r0, r1, min_onset};
  OvStage<T> st{region, gr.wcap, tot + P * (OV_L1 + OV_L2), gr.bcap,
                nullptr, 0, tot, nullptr, 0, OvWin{0, 0}};
  if (!gr.long_form) {
    const int c0 = tile.s * gr.seg, c1 = min(t, c0 + gr.seg);
    st.xs = region + gr.nbuf * gr.wcap;
    st.len = min(t, (op.reach(c1) + FE_BLOCK - 1) / FE_BLOCK * FE_BLOCK);
    const OvC1<T> sums{tot, nullptr, nullptr, 0, 0, t > FE_BLOCK};
    for (int r = r0; r < r1; ++r) {
      op.pass(f, x + (long long)r * t, c0, c1, r, sums, st, emit);
    }
    return;
  }
  const int g = tile.s;
  int* flag_c1 = ints + ws.flags_c1 + (long long)tile.u * ws.n_tiles;
  ov_scan_long(f, x, r0, r1, t, g, ws,
               ints + 1 + (long long)tile.u * ws.up_stride, flag_c1, vals,
               region, tot);
  st.flag_c1 = flag_c1;
  st.g = g;
  // a one-row unit's tile is still staged where a pass's window 0 goes
  if (r1 - r0 == 1) st.kept = OvWin{g * OV_TILE, min(t, (g + 1) * OV_TILE)};
  int o0, o1;
  ov_outputs(g, gr.lag, ws.n_tiles, &o0, &o1);
  for (int h = o0; h <= o1; ++h) {
    const int end = min(t, (h + 1) * OV_TILE);
    for (int c0 = h * OV_TILE; c0 < end; c0 += gr.chunk) {
      const int c1 = min(end, c0 + gr.chunk);
      for (int r = r0; r < r1; ++r) {
        const long long rp = (long long)r * P;
        const OvC1<T> sums{nullptr, vals + ws.c1 + rp * ws.n1,
                           vals + ws.i2 + rp * ws.n_tiles * OV_L2, ws.n1,
                           ws.n_tiles, true};
        op.pass(f, x + (long long)r * t, c0, c1, r, sums, st, emit);
        // the pass turned window 0's samples into running sums
        st.kept = OvWin{0, 0};
      }
    }
  }
}

// ON1 v2: x [rows, t] -> out [units, t]; ints, vals: a long-row launch's
// workspace (OvWs), else unused.
template <typename T>
__global__ void __launch_bounds__(OV_THREADS, sizeof(T) == 8
                                                  ? OV1_MIN_BLOCKS_F64
                                                  : OV1_MIN_BLOCKS_F32)
qm_ov1_stalta_kernel(const T* __restrict__ x, const int* __restrict__ offsets,
                     T* out, int* ints, T* vals, OvWs ws, OvGrid gr,
                     int units, int t, int nsta, int nlta, int centred,
                     int mode, int lo_edge, int hi_edge, T frac, T tiny,
                     T min_onset) {
  extern __shared__ __align__(16) unsigned char ov_smem[];
  Ov1<T> op;
  op.t = t;
  op.nsta = nsta;
  op.nlta = nlta;
  op.nsta_c = min(nsta, t);
  op.centred = centred;
  op.frac = frac;
  op.tiny = tiny;
  ov_tile_work(OvTransform<T>{mode}, op, x, offsets, out, ints, vals, ws, gr,
               units, t, lo_edge, hi_edge, min_onset, ov_smem);
}

// ON2 v2: x [rows, t] -> out [units, t], as ON1 v2.
template <typename T>
__global__ void __launch_bounds__(OV_THREADS, sizeof(T) == 8
                                                  ? OV2_MIN_BLOCKS_F64
                                                  : OV2_MIN_BLOCKS_F32)
qm_ov2_kurtosis_kernel(const T* __restrict__ x,
                       const int* __restrict__ offsets, T* out, int* ints,
                       T* vals, OvWs ws, OvGrid gr, int units, int t,
                       int nkurt, int nsmooth, int lo_edge, int hi_edge,
                       T min_onset, T sqrt_tiny, T weight) {
  extern __shared__ __align__(16) unsigned char ov_smem[];
  T* kbuf = reinterpret_cast<T*>(ov_smem + 16) + gr.region +
            4 * (OV_L1 + OV_L2) + 8 * gr.bcap;
  Ov2<T> op;
  op.t = t;
  op.nkurt = nkurt;
  op.nsmooth = nsmooth;
  op.half = nsmooth / 2;
  op.n = (T)nkurt;
  op.sqrt_tiny = sqrt_tiny;
  op.weight = weight;
  op.kbuf = kbuf;
  op.cfbuf = kbuf + gr.kcap;
  op.vbuf = kbuf + 2 * gr.kcap;
  ov_tile_work(OvPowers<T>{}, op, x, offsets, out, ints, vals, ws, gr, units,
               t, lo_edge, hi_edge, min_onset, ov_smem);
}

// The grid of a launch: the short rows' segment fills the card (twice its
// SMs in tiles where the rows allow), at least OV_MIN_SEG samples and at
// most a pass; long rows' tiles lag by the tiles their outputs read ahead
static OvGrid ov_grid(bool kurtosis, int units, int t, int ahead, int kc,
                      int n_sm) {
  OvGrid gr;
  memset(&gr, 0, sizeof gr);
  const int cap = kurtosis ? OV_CH2 : OV_CH1;
  int stage;
  if (t <= OV_TILE) {
    const long long want = ((long long)2 * n_sm + units - 1) / units;
    const int most = (t + OV_MIN_SEG - 1) / OV_MIN_SEG;
    const int n = (int)std::max<long long>(1, std::min<long long>(want, most));
    int seg = ((t + n - 1) / n + FE_BLOCK - 1) / FE_BLOCK * FE_BLOCK;
    gr.seg = std::min(seg, cap);
    gr.n_tiles = (t + gr.seg - 1) / gr.seg;
    gr.chunk = gr.seg;
    stage = (t + FE_BLOCK - 1) / FE_BLOCK * FE_BLOCK;
  } else {
    gr.long_form = 1;
    gr.n_tiles = (t + OV_TILE - 1) / OV_TILE;
    gr.chunk = cap;
    gr.lag = (int)(((long long)ahead + OV_TILE - 1) / OV_TILE);
    stage = OV_TILE;
  }
  // a window: a pass's outputs (and ON2's taps) from the first's block
  gr.wcap = (gr.chunk + kc + 2 * FE_BLOCK - 1) / FE_BLOCK * FE_BLOCK;
  gr.nbuf = kurtosis ? 8 : 3;
  gr.region = gr.long_form ? std::max(gr.nbuf * gr.wcap, stage)
                           : gr.nbuf * gr.wcap + stage;
  gr.bcap = gr.wcap / FE_BLOCK;
  gr.kcap = kurtosis ? gr.chunk + kc : 0;
  return gr;
}

// The ticket; the windows (region); the levels of a tile (tot); the
// windows' blocks' C_1 (bw); ON2's kurtosis, gradient and partial sums
static size_t ov_smem_bytes(bool kurtosis, const OvGrid& gr, size_t item) {
  const size_t p = kurtosis ? 4 : 1;
  const size_t bw = (kurtosis ? 2 : 3) * p * (size_t)gr.bcap;
  const size_t extra = kurtosis ? 2 * (size_t)gr.kcap + gr.chunk : 0;
  return 16 + (gr.region + p * (OV_L1 + OV_L2) + bw + extra) * item;
}

static int ov_check(int units, int rows, int t, int lo_edge, int hi_edge) {
  if (units < 1 || rows < units || t < 1 || t >= (1 << 30) || lo_edge < 0 ||
      hi_edge < 0 || hi_edge > t) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Zero a long-row launch's ints, pick the grid, allow its shared memory
template <typename T>
static int ov_prepare(bool kurtosis, void* ws_ptr, const OvWs& ws,
                      int units, int t, int ahead, int kc, void* kernel,
                      cudaStream_t s, OvGrid* gr, size_t* smem,
                      long long* tiles) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  *gr = ov_grid(kurtosis, units, t, ahead, kc, n_sm);
  *smem = ov_smem_bytes(kurtosis, *gr, sizeof(T));
  *tiles = (long long)units * gr->n_tiles;
  if (*tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (gr->long_form) {
    if (ws_ptr == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(ws_ptr, 0, ws.n_ints * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
static int ov1_launch(const void* x, const void* offsets, void* out,
                      void* workspace, int units, int rows, int t, int nsta,
                      int nlta, int centred, int mode, int lo_edge,
                      int hi_edge, int frac_lo, int frac_hi, int min_lo,
                      int min_hi, void* stream) {
  if (ov_check(units, rows, t, lo_edge, hi_edge) != 0 || nsta < 1 ||
      nlta < 1 || mode < FE_SQUARE || mode > FE_IDENTITY ||
      (offsets == nullptr && rows != units)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OvWs ws = ov_ws(units, rows, t, 1);
  OvGrid gr;
  size_t smem;
  long long tiles;
  const int err = ov_prepare<T>(
      false, workspace, ws, units, t, centred ? std::min(nsta, t) : 0, 0,
      reinterpret_cast<void*>(qm_ov1_stalta_kernel<T>), s, &gr, &smem,
      &tiles);
  if (err != 0) return err;
  qm_ov1_stalta_kernel<T><<<(int)tiles, OV_THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(offsets),
      static_cast<T*>(out), static_cast<int*>(workspace),
      gr.long_form
          ? reinterpret_cast<T*>(static_cast<char*>(workspace) + ws.int_bytes)
          : nullptr,
      ws, gr, units, t, nsta, nlta, centred, mode, lo_edge, hi_edge,
      (T)fe_bits_to_double(frac_lo, frac_hi), std::numeric_limits<T>::min(),
      (T)fe_bits_to_double(min_lo, min_hi));
  return (int)cudaGetLastError();
}

template <typename T>
static int ov2_launch(const void* x, const void* offsets, void* out,
                      void* workspace, int units, int rows, int t, int nkurt,
                      int nsmooth, int lo_edge, int hi_edge, int min_lo,
                      int min_hi, void* stream) {
  if (ov_check(units, rows, t, lo_edge, hi_edge) != 0 || nkurt < 1 ||
      nsmooth < 1 || (offsets == nullptr && rows != units)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OvWs ws = ov_ws(units, rows, t, 4);
  OvGrid gr;
  size_t smem;
  long long tiles;
  const int err = ov_prepare<T>(
      true, workspace, ws, units, t, nsmooth - 1 - nsmooth / 2,
      std::min(nsmooth, OV_KC),
      reinterpret_cast<void*>(qm_ov2_kurtosis_kernel<T>), s, &gr, &smem,
      &tiles);
  if (err != 0) return err;
  // sqrt(tiny) is a power of two in both types, so exact
  const T sqrt_tiny = (T)std::sqrt((double)std::numeric_limits<T>::min());
  qm_ov2_kurtosis_kernel<T><<<(int)tiles, OV_THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(offsets),
      static_cast<T*>(out), static_cast<int*>(workspace),
      gr.long_form
          ? reinterpret_cast<T*>(static_cast<char*>(workspace) + ws.int_bytes)
          : nullptr,
      ws, gr, units, t, nkurt, nsmooth, lo_edge, hi_edge,
      (T)fe_bits_to_double(min_lo, min_hi), sqrt_tiny, (T)(1.0 / nsmooth));
  return (int)cudaGetLastError();
}

// Bytes of a launch's workspace (kurtosis 0 for ON1 v2, 1 for ON2 v2): 0
// for rows of at most 4,096 samples, which need none; -1 for a shape the
// kernels do not take.
extern "C" long long qm_onset_v2_workspace_bytes(int kurtosis, int units,
                                                 int rows, int t,
                                                 int itemsize) {
  if (units < 1 || rows < units || t < 1 || t >= (1 << 30)) return -1;
  const OvWs ws = ov_ws(units, rows, t, kurtosis ? 4 : 1);
  if (ws.n_tiles == 0) return 0;
  return ws.int_bytes + ws.n_vals * itemsize;
}

// All arrays contiguous on the device: x [rows, t] and out [units, t] of
// the entry's float type; offsets NULL (rows mode: units = rows) or int32
// [units + 1] (stations mode, each station at least one row, the last
// offset rows); workspace NULL where t <= 4,096, else
// qm_onset_v2_workspace_bytes bytes, 16-byte aligned (its ints zeroed on
// the stream first). frac and min_onset_value are doubles passed as their
// two 32-bit halves (low, high). mode: 0 square, 1 abs, 2 identity.
// lo_edge, hi_edge: stations mode's samples set to 1 before the combine
// ([0, lo_edge) and [hi_edge, t)).
extern "C" int qm_onset_stalta_v2_f32(const void* x, const void* offsets,
                                      void* out, void* workspace, int units,
                                      int rows, int t, int nsta, int nlta,
                                      int centred, int mode, int lo_edge,
                                      int hi_edge, int frac_lo, int frac_hi,
                                      int min_lo, int min_hi, void* stream) {
  return ov1_launch<float>(x, offsets, out, workspace, units, rows, t, nsta,
                           nlta, centred, mode, lo_edge, hi_edge, frac_lo,
                           frac_hi, min_lo, min_hi, stream);
}

extern "C" int qm_onset_stalta_v2_f64(const void* x, const void* offsets,
                                      void* out, void* workspace, int units,
                                      int rows, int t, int nsta, int nlta,
                                      int centred, int mode, int lo_edge,
                                      int hi_edge, int frac_lo, int frac_hi,
                                      int min_lo, int min_hi, void* stream) {
  return ov1_launch<double>(x, offsets, out, workspace, units, rows, t, nsta,
                            nlta, centred, mode, lo_edge, hi_edge, frac_lo,
                            frac_hi, min_lo, min_hi, stream);
}

extern "C" int qm_onset_kurtosis_v2_f32(const void* x, const void* offsets,
                                        void* out, void* workspace,
                                        int units, int rows, int t,
                                        int nkurt, int nsmooth, int lo_edge,
                                        int hi_edge, int min_lo, int min_hi,
                                        void* stream) {
  return ov2_launch<float>(x, offsets, out, workspace, units, rows, t, nkurt,
                           nsmooth, lo_edge, hi_edge, min_lo, min_hi, stream);
}

extern "C" int qm_onset_kurtosis_v2_f64(const void* x, const void* offsets,
                                        void* out, void* workspace,
                                        int units, int rows, int t,
                                        int nkurt, int nsmooth, int lo_edge,
                                        int hi_edge, int min_lo, int min_hi,
                                        void* stream) {
  return ov2_launch<double>(x, offsets, out, workspace, units, rows, t,
                            nkurt, nsmooth, lo_edge, hi_edge, min_lo, min_hi,
                            stream);
}

#ifdef __CUDACC__
// Resident blocks per SM of ON1 v2 (kurtosis 0) or ON2 v2 in float32 (f64
// 0) or float64 at its long rows' shared memory (ON2 v2 at 12 taps); a
// negative CUDA error on failure.
extern "C" int qm_onset_v2_blocks_per_sm(int kurtosis, int f64) {
  const size_t item = f64 ? sizeof(double) : sizeof(float);
  const OvGrid gr = ov_grid(kurtosis != 0, 1, OV_TILE + 1, 0,
                            kurtosis ? 12 : 0, 132);
  const size_t smem = ov_smem_bytes(kurtosis != 0, gr, item);
  void* kernel =
      kurtosis ? (f64 ? reinterpret_cast<void*>(qm_ov2_kurtosis_kernel<double>)
                      : reinterpret_cast<void*>(qm_ov2_kurtosis_kernel<float>))
               : (f64 ? reinterpret_cast<void*>(qm_ov1_stalta_kernel<double>)
                      : reinterpret_cast<void*>(qm_ov1_stalta_kernel<float>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        OV_THREADS, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}
#endif
