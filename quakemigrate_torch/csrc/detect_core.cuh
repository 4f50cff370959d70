// Shared pieces of the detect kernels for Hopper (sm_90a): the block
// geometry of the K1-family kernels, cp.async helpers, and the per-tile
// gather-and-reduce that K1 (migrate_detect.cu), its ablations, the
// resident-staging kernel (migrate_detect_resident.cu), the pipelined
// kernel (migrate_detect_pipelined.cu) and, with its own gather, the
// shifted-copy kernel (migrate_detect_x16.cu) run on their staged windows.
//
// Contract of qm_reduce_tile<QM_FULL>, per node tile and scan sample t of
// the block's QM_SBLK samples starting at s0:
//   coa[n,t]  = exp(sum_o win_o[fine[o,n] + t] * inv) * valid[n]
//   tmax[t]   = max_n coa;  targ[t] = smallest n attaining it;
//   tsum[t]   = sum_n coa
// where win_o = win + woff(o) is onset o's staged window, whose sample 0
// is L[o, fsmp + base[tile, o] + s0]. The onsets are summed in order
// o = 0..O-1, as the plain versions do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define QM_SBLK 128
#define QM_NWARPS 8
#define QM_THREADS (32 * QM_NWARPS)
#define QM_SPT (QM_SBLK / 32)
// Floats of the cross-warp reduction scratch (max, arg, sum per warp).
#define QM_RED_FLOATS (3 * QM_NWARPS * QM_SBLK)

// Variants of the reduction. QM_FULL is the contract above; the others
// remove one piece each, for the cost breakdown of the kernel (the
// counterpart of the `ablate` options of the TPU breakdown experiment).
enum QmVariant {
  QM_FULL = 0,      // the contract
  QM_NOEXP = 1,     // coa = acc * inv * valid
  QM_NOARGMAX = 2,  // targ = 0
  QM_NOREDUCE = 3,  // tmax = acc of node 0, tsum = acc of node 1, targ = 0
  QM_NOGATHER = 4,  // tmax = tsum = sum_o win_o[t], targ = 0
};

// Keeps a value live without emitting an instruction, so that a variant
// that drops a value's use does not also drop the work that made it.
__device__ __forceinline__ void qm_keep(float x) { asm volatile("" ::"f"(x)); }

// 4-byte asynchronous copy global -> shared; with `pred` false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void qm_cp_async4(float* dst, const float* src,
                                             bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void qm_cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void qm_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void qm_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Window offsets: onset o's window at o * width (one stride for all).
struct QmStride {
  int width;
  __device__ __forceinline__ int operator()(int o) const { return o * width; }
};

// Window offsets read from a table in shared memory.
struct QmTable {
  const int* off;
  __device__ __forceinline__ int operator()(int o) const { return off[o]; }
};

// The QM_NOGATHER variant: the staged windows stay live, each output
// reading every onset's window at residual 0, with no per-node reads.
template <class Offsets>
__device__ __forceinline__ void qm_staged_sum(
    const float* win, Offsets woff, int n_onsets, float* __restrict__ tmax,
    int* __restrict__ targ, float* __restrict__ tsum, long long out_row,
    int s0, int nsamples) {
  const int tid = threadIdx.x;
  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float v = 0.0f;
    for (int o = 0; o < n_onsets; ++o) v += win[woff(o) + tid];
    tmax[out_row + s0 + tid] = v;
    targ[out_row + s0 + tid] = 0;
    tsum[out_row + s0 + tid] = v;
  }
}

// K1's gather of one node: lane reads samples lane + 32k (k < QM_SPT) of
// each onset's staged window with 4-byte loads. A warp owns one node at
// a time and its lanes read consecutive samples, so every shared-memory
// read is free of bank conflicts.
template <class Offsets>
struct QmLaneGather {
  const float* win;
  Offsets woff;
  const int* fine_i;
  int n_onsets;
  int tile;

  // The block sample that register k of lane `lane` holds.
  static __device__ __forceinline__ int sample(int lane, int k) {
    return lane + 32 * k;
  }

  __device__ __forceinline__ void operator()(int n, float (&acc)[QM_SPT]) const {
    const int lane = threadIdx.x & 31;
    for (int o = 0; o < n_onsets; ++o) {
      const float* w = win + woff(o) + __ldg(fine_i + o * tile + n) + lane;
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) acc[k] += w[32 * k];
    }
  }
};

// Epilogue and cross-warp reduction of one node tile over the block's
// QM_SBLK samples, for every variant but QM_NOGATHER, with the per-node
// sums of `gather` (a QmLaneGather or the like: `gather(n, acc)` adds the
// onsets of node n in order o = 0..O-1 into acc, whose register k holds
// block sample Gather::sample(lane, k)). Thread tid < QM_SBLK stores
// sample s0 + tid of row `out_row` (element offset of the tile's output
// row). `red` holds QM_RED_FLOATS floats and may alias the staged
// windows: they are last read before the first barrier. Every thread of
// the block must call it.
template <int V, class Gather>
__device__ __forceinline__ void qm_reduce_nodes(
    const Gather& gather, const float* __restrict__ valid_i, float inv,
    int tile, float* red, float* __restrict__ tmax, int* __restrict__ targ,
    float* __restrict__ tsum, long long out_row, int s0, int nsamples) {
  static_assert(V != QM_NOGATHER, "QM_NOGATHER is qm_staged_sum");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float best[QM_SPT], total[QM_SPT];
  int arg[QM_SPT];
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) {
    best[k] = -INFINITY;
    total[k] = 0.0f;
    arg[k] = 0;
  }

  // Warp w takes nodes w, w + QM_NWARPS, ... in ascending order, so a
  // strict > keeps the first node attaining each thread's max.
  for (int n = warp; n < tile; n += QM_NWARPS) {
    float acc[QM_SPT];
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) acc[k] = 0.0f;
    gather(n, acc);
    if (V == QM_NOREDUCE) {
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) {
        if (n == 0) {
          best[k] = acc[k];
        } else if (n == 1) {
          total[k] = acc[k];
        } else {
          qm_keep(acc[k]);
        }
      }
      continue;
    }
    const float v = __ldg(valid_i + n);
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) {
      // __fmul_rn: no contraction into expf's range reduction, so the
      // exponent argument is rounded exactly as in the plain version.
      const float scaled = __fmul_rn(acc[k], inv);
      const float coa =
          __fmul_rn(V == QM_NOEXP ? scaled : expf(scaled), v);
      if (V == QM_NOARGMAX) {
        best[k] = fmaxf(best[k], coa);
      } else if (coa > best[k]) {
        best[k] = coa;
        arg[k] = n;
      }
      total[k] += coa;
    }
  }
  __syncthreads();  // all reads of the staged windows are done

  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + QM_NWARPS * QM_SBLK);
  float* red_sum = red + 2 * QM_NWARPS * QM_SBLK;
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) {
    const int s = warp * QM_SBLK + Gather::sample(lane, k);
    red_max[s] = best[k];
    red_arg[s] = arg[k];
    red_sum[s] = total[k];
  }
  __syncthreads();

  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float m, s;
    int a = 0;
    if (V == QM_NOREDUCE) {
      // node 0 belongs to warp 0, node 1 to warp 1
      m = red_max[tid];
      s = red_sum[QM_SBLK + tid];
    } else {
      m = red_max[tid];
      a = V == QM_NOARGMAX ? 0 : red_arg[tid];
      s = red_sum[tid];
      for (int w = 1; w < QM_NWARPS; ++w) {
        const float mw = red_max[w * QM_SBLK + tid];
        if (V == QM_NOARGMAX) {
          m = fmaxf(m, mw);
        } else {
          const int aw = red_arg[w * QM_SBLK + tid];
          if (mw > m || (mw == m && aw < a)) {
            m = mw;
            a = aw;
          }
        }
        s += red_sum[w * QM_SBLK + tid];
      }
    }
    tmax[out_row + s0 + tid] = m;
    targ[out_row + s0 + tid] = a;
    tsum[out_row + s0 + tid] = s;
  }
}

// qm_reduce_nodes with K1's gather from the staged windows `win`, onset
// o's at woff(o).
template <int V, class Offsets>
__device__ __forceinline__ void qm_reduce_tile(
    const float* win, Offsets woff, const int* __restrict__ fine_i,
    const float* __restrict__ valid_i, float inv, int n_onsets, int tile,
    float* red, float* __restrict__ tmax, int* __restrict__ targ,
    float* __restrict__ tsum, long long out_row, int s0, int nsamples) {
  qm_reduce_nodes<V>(QmLaneGather<Offsets>{win, woff, fine_i, n_onsets, tile},
                     valid_i, inv, tile, red, tmax, targ, tsum, out_row, s0,
                     nsamples);
}
