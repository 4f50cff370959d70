// K1 v2's gather core (migrate_detect_v2.cu), shared by the kernels
// built on it: K1 v2 itself, the pipelined detect kernel v2
// (migrate_detect_pipelined_v2.cu) and the resident-staging kernel v2
// (migrate_detect_resident_v2.cu).
//
// A tile's residuals arrive as a uint16 slab [tile, qv_row(O)] whose
// entry (n, o) is the offset, in floats, of node n's onset-o read in the
// staged windows; a warp reads a node's row as broadcast 16-byte chunks
// (8 onsets a chunk) and its lanes read the window at that offset, 4-byte
// conflict-free loads. The epilogue folds nodes in K1's order (each
// warp's nodes ascending, then warps 0..7), so every kernel built on it
// gives K1's tmax, targ and tsum bit for bit.

#pragma once

#include "detect_core.cuh"

// Entries of one node's slab row: O rounded up to 8 (16 bytes).
__host__ __device__ __forceinline__ int qv_row(int n_onsets) {
  return (n_onsets + 7) & ~7;
}

// Entry j (0..7) of a 16-byte slab chunk.
__device__ __forceinline__ unsigned qv_entry(const uint4& q, int j) {
  const unsigned w = j < 2 ? q.x : j < 4 ? q.y : j < 6 ? q.z : q.w;
  return (j & 1) ? w >> 16 : w & 0xffffu;
}

// Adds onset j of node a's slab chunk qa into `a` and, for NN = 2, of
// node b's chunk qb into `b`: lane reads samples lane + 32k of the
// onset's window at the node's residual, 4-byte conflict-free loads.
template <int NN>
__device__ __forceinline__ void qv_add_onset(const float* wl, const uint4& qa,
                                             const uint4& qb, int j,
                                             float (&a)[QM_SPT],
                                             float (&b)[QM_SPT]) {
  const float* sa = wl + qv_entry(qa, j);
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) a[k] += sa[32 * k];
  if (NN == 2) {
    const float* sb = wl + qv_entry(qb, j);
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) b[k] += sb[32 * k];
  }
}

// The gather of node a (slab row ra) and, for NN = 2, node b (row rb)
// together: onsets in order o = 0..O-1 for each node, 8 onsets per
// 16-byte row chunk.
template <int NN>
__device__ __forceinline__ void qv_gather(const float* wl, const uint4* ra,
                                          const uint4* rb, int n_onsets,
                                          float (&a)[QM_SPT],
                                          float (&b)[QM_SPT]) {
  const int chunks = n_onsets >> 3;
  for (int c = 0; c < chunks; ++c) {
    const uint4 qa = ra[c];
    const uint4 qb = NN == 2 ? rb[c] : qa;
#pragma unroll
    for (int j = 0; j < 8; ++j) qv_add_onset<NN>(wl, qa, qb, j, a, b);
  }
  const int rest = n_onsets & 7;
  if (rest) {
    const uint4 qa = ra[chunks];
    const uint4 qb = NN == 2 ? rb[chunks] : qa;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (j < rest) qv_add_onset<NN>(wl, qa, qb, j, a, b);
    }
  }
}

// K1's epilogue (qm_reduce_nodes, detect_core.cuh) node by node, so that
// a warp can fold two nodes an iteration: the same operations in the same
// order, so v2's outputs equal K1's. K1, E1 and E2 keep their own copy:
// moving them onto these functions changed their machine code (E2's
// copy-major layout ran 89 ms instead of 53.5 at 30,000 samples on the
// H100).
//
// One thread's part of the reduction over a warp's nodes: per register
// k (block sample lane + 32k), the largest coalescence, the first node
// attaining it, and the sum.
struct QvPartial {
  float best[QM_SPT];
  float total[QM_SPT];
  int arg[QM_SPT];

  __device__ __forceinline__ QvPartial() {
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) {
      best[k] = -INFINITY;
      total[k] = 0.0f;
      arg[k] = 0;
    }
  }
};

// Node n, whose onset sums are `acc` and weight `v` (valid[n]), folded
// into `p`. A warp folds its nodes in ascending order, so a strict >
// keeps the first node attaining each thread's max.
template <int V>
__device__ __forceinline__ void qv_fold(QvPartial& p,
                                        const float (&acc)[QM_SPT], int n,
                                        float v, float inv) {
  if (V == QM_NOREDUCE) {
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) {
      if (n == 0) {
        p.best[k] = acc[k];
      } else if (n == 1) {
        p.total[k] = acc[k];
      } else {
        qm_keep(acc[k]);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) {
    // __fmul_rn: no contraction into expf's range reduction, so the
    // exponent argument is rounded exactly as in the plain version.
    const float coa = __fmul_rn(expf(__fmul_rn(acc[k], inv)), v);
    if (coa > p.best[k]) {
      p.best[k] = coa;
      p.arg[k] = n;
    }
    p.total[k] += coa;
  }
}

// The cross-warp reduction of the partials: thread tid < QM_SBLK stores
// sample s0 + tid of row `out_row`. `red` holds QM_RED_FLOATS floats and
// may alias the staged data: the first barrier ends every read of it.
template <int V>
__device__ __forceinline__ void qv_reduce_warps(
    const QvPartial& p, float* red, float* __restrict__ tmax,
    int* __restrict__ targ, float* __restrict__ tsum, long long out_row,
    int s0, int nsamples) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();

  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + QM_NWARPS * QM_SBLK);
  float* red_sum = red + 2 * QM_NWARPS * QM_SBLK;
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) {
    const int s = warp * QM_SBLK + lane + 32 * k;
    red_max[s] = p.best[k];
    red_arg[s] = p.arg[k];
    red_sum[s] = p.total[k];
  }
  __syncthreads();

  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = 0;
    float s;
    if (V == QM_NOREDUCE) {
      // node 0 belongs to warp 0, node 1 to warp 1
      s = red_sum[QM_SBLK + tid];
    } else {
      a = red_arg[tid];
      s = red_sum[tid];
      for (int w = 1; w < QM_NWARPS; ++w) {
        const float mw = red_max[w * QM_SBLK + tid];
        const int aw = red_arg[w * QM_SBLK + tid];
        if (mw > m || (mw == m && aw < a)) {
          m = mw;
          a = aw;
        }
        s += red_sum[w * QM_SBLK + tid];
      }
    }
    tmax[out_row + s0 + tid] = m;
    targ[out_row + s0 + tid] = a;
    tsum[out_row + s0 + tid] = s;
  }
}

// K1 v2's node loop over one tile, from the windows `win` through the
// slab `slab` [tile, qv_row(O)] and `vld` (valid), folded into `p`: warp
// w takes the pairs (n, n + 8) for n = w, w + 16, ..., gathers both
// (only the nodes with valid != 0; a padding node's sums stay 0) and
// folds n, then n + 8. K1 v2 keeps its own inline copy of this loop, so
// that its machine code stays as it was measured.
//
// QM_NOREDUCE keeps only nodes 0 and 1 (qv_fold), and qm_keep emits no
// instruction, so the compiler may drop the other nodes' gathers, and
// did for this loop where it kept K1 v2's inline copy's. Here every
// node's sums also enter a sink that reaches a partial only if it is
// -inf, which finite onsets never give, so the gathers stay and the
// outputs do not change.
template <int V>
__device__ __forceinline__ void qv_sweep_tile(QvPartial& p, const float* win,
                                              const unsigned short* slab,
                                              const float* vld, int n_onsets,
                                              int tile, float inv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = qv_row(n_onsets);
  const float* wl = win + lane;
  float sink = 0.0f;
  for (int n = warp; n < tile; n += 2 * QM_NWARPS) {
    const int m = n + QM_NWARPS;
    const float va = vld[n];
    const float vb = vld[m];
    float acc_n[QM_SPT], acc_m[QM_SPT];
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) acc_n[k] = acc_m[k] = 0.0f;
    const uint4* rn = reinterpret_cast<const uint4*>(slab + n * row);
    const uint4* rm = reinterpret_cast<const uint4*>(slab + m * row);
    if (va != 0.0f && vb != 0.0f) {
      qv_gather<2>(wl, rn, rm, n_onsets, acc_n, acc_m);
    } else if (va != 0.0f) {
      qv_gather<1>(wl, rn, rn, n_onsets, acc_n, acc_n);
    } else if (vb != 0.0f) {
      qv_gather<1>(wl, rm, rm, n_onsets, acc_m, acc_m);
    }
    if (V == QM_NOREDUCE) {
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) sink += acc_n[k] + acc_m[k];
    }
    qv_fold<V>(p, acc_n, n, va, inv);
    qv_fold<V>(p, acc_m, m, vb, inv);
  }
  if (V == QM_NOREDUCE && sink == -INFINITY) p.best[0] = sink;
}
