// Fused migrate-and-reduce for the detect stage with the onset rows read
// from global memory: K3, for the plans no staged kernel takes.
//
// Replaces the XLA shift-table kernel of the JAX package, detect_reduce
// (quakemigrate_tpu/ops/migrate.py:124), which migrate_detect (:190) and
// the fused detect windows reach where the Pallas plan is refused
// (_mxu_kernel returns None, quakemigrate_tpu/signal/scan.py:380-423) or
// kernel="xla" forces it. It has no pallas_call. Contract, per node tile i
// of K3_TILE consecutive flat nodes and scan sample t < nsamples:
//
//   coa[n, t]  = exp(sum_{o<O} L[o, fsmp + tc[n, o] + t] * inv_available)
//   tc[n, o]   = clamp(tt[n, o], 0, d_max),  d_max = t_len - fsmp - nsamples
//   tmax[i, t] = max over the real nodes n of the tile (n < n_nodes)
//   targ[i, t] = the smallest flat index n attaining it
//   tsum[i, t] = sum over the real nodes of the tile
//
// with L the clipped, logged and masked onsets and tt the flat-order
// int32 traveltimes [n_nodes, O], the layout of the plain version
// (ops/migrate.py::detect_reduce) and of the reference, clamped as they
// clamp them. The onsets are summed in order o = 0..O-1 in float32, as
// the plain version sums them, so each exponent is the plain version's;
// each value is expf(__fmul_rn(acc, inv)), K1 v2's fold (no contraction
// into expf). The host combine takes the first tile on equal maxima, so
// ties follow the reference's XLA rule, the first flat index.
//
// Bound on the card: the gather of n_nodes x O x S 4-byte onset values.
// No shared-memory window holds the onset rows, so no residual span
// bounds the plan; the rows (O x t_len x 4 bytes, 1.6 MB at 24 onsets
// and 17,000 samples) stay in L2, and the gather is held by L2's rate
// and the latency of a warp's dependent loads. The design is the simple
// one, right first:
// - one block a node tile x QG_SBLK-sample block, 8 warps; warp w takes
//   nodes w, w + 8, ... of the tile, in increasing order;
// - lane j loads the (clamped) traveltime of onset c + j of the node for
//   a chunk of 32 onsets, coalesced from the node's row, and the warp
//   passes them round with __shfl_sync;
// - lane j takes the block's samples j + 32 k, k < QG_SPL: a warp's read
//   of one onset row is 32 consecutive floats, one 128-byte line;
// - each lane keeps its samples' running max (strict >, so the warp's
//   first node wins), argmax and sum over its nodes in registers; the 8
//   warps' partials meet in shared memory, where thread t folds sample t
//   over the warps: the larger value, or on equal values the smaller
//   flat index, and the sums in warp order.
//
// Its Hopper redesign is K3 v2 (migrate_detect_global_v2.cu: the brick
// plan's onset windows streamed through an mbarrier ring and gathered
// from shared memory), which DetectScan's "k3" route runs wherever its
// ring holds the plan's widest window; this kernel stays for the wider
// plans and as K3 v2's yardstick.
//
// K3 f64 (qm_migrate_detect_global_f64): the same kernel on double, for
// QuakeScan(precision="double"), where the reference keeps detect_reduce
// in float64. The onsets, the sums and the outputs are double; each value
// is exp(__dmul_rn(acc, inv)); the block's scratch takes 20 KB of static
// shared memory (12 KB in float). It runs on the plans too wide for K3
// v2 f64's ring of doubles. Bound as above with 8-byte reads, and the
// card's FP64 rate for the adds and exp.

#include <cuda_runtime.h>

#define QG_WARPS 8
#define QG_THREADS (32 * QG_WARPS)
// Samples a lane takes, and a block's samples
#define QG_SPL 4
#define QG_SBLK (32 * QG_SPL)
// Consecutive flat nodes a block takes (ops/cuda_migrate.py: K3_TILE)
#define QG_TILE 256

// -inf, and a node's coalescence exp(acc * inv) with the product rounded
// on its own (__fmul_rn, __dmul_rn: no contraction into exp's range
// reduction, K1 v2's fold), in each element type
__device__ __forceinline__ float qg_neg_inf(float) {
  return __int_as_float(0xff800000);
}
__device__ __forceinline__ double qg_neg_inf(double) {
  return __longlong_as_double(0xfff0000000000000ll);
}
__device__ __forceinline__ float qg_coa(float acc, float inv) {
  return expf(__fmul_rn(acc, inv));
}
__device__ __forceinline__ double qg_coa(double acc, double inv) {
  return exp(__dmul_rn(acc, inv));
}

template <typename T>
__global__ void __launch_bounds__(QG_THREADS)
qm_migrate_detect_global_kernel(const T* __restrict__ L, int t_len,
                                const int* __restrict__ tt,
                                const T* __restrict__ inv_available,
                                T* __restrict__ tmax,
                                int* __restrict__ targ,
                                T* __restrict__ tsum, int n_nodes,
                                int n_onsets, int fsmp, int nsamples) {
  __shared__ T red_max[QG_WARPS][QG_SBLK];
  __shared__ int red_arg[QG_WARPS][QG_SBLK];
  __shared__ T red_sum[QG_WARPS][QG_SBLK];

  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QG_SBLK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d_max = t_len - fsmp - nsamples;
  const T inv = *inv_available;
  const int n_end = min(n_nodes, (tile_i + 1) * QG_TILE);

  T best[QG_SPL], sum[QG_SPL];
  int arg[QG_SPL];
#pragma unroll
  for (int k = 0; k < QG_SPL; ++k) {
    best[k] = qg_neg_inf(T());
    arg[k] = 0x7fffffff;
    sum[k] = T(0);
  }
  // This lane's samples s0 + lane + 32 k that lie in the scan
  bool live[QG_SPL];
#pragma unroll
  for (int k = 0; k < QG_SPL; ++k) live[k] = s0 + lane + 32 * k < nsamples;
  const T* base = L + fsmp + s0 + lane;

  for (int n = tile_i * QG_TILE + warp; n < n_end; n += QG_WARPS) {
    const int* tt_n = tt + (long long)n * n_onsets;
    T acc[QG_SPL];
#pragma unroll
    for (int k = 0; k < QG_SPL; ++k) acc[k] = T(0);
    for (int c = 0; c < n_onsets; c += 32) {
      // Lane j's clamped traveltime of onset c + j, passed round the warp
      const int mine =
          c + lane < n_onsets ? min(max(tt_n[c + lane], 0), d_max) : 0;
      const int m = min(32, n_onsets - c);
      const T* rows = base + (long long)c * t_len;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const T* row =
            rows + (long long)j * t_len + __shfl_sync(0xffffffffu, mine, j);
#pragma unroll
        for (int k = 0; k < QG_SPL; ++k) {
          if (live[k]) acc[k] += row[32 * k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < QG_SPL; ++k) {
      const T coa = qg_coa(acc[k], inv);
      if (coa > best[k]) {
        best[k] = coa;
        arg[k] = n;
      }
      sum[k] += coa;
    }
  }

#pragma unroll
  for (int k = 0; k < QG_SPL; ++k) {
    red_max[warp][lane + 32 * k] = best[k];
    red_arg[warp][lane + 32 * k] = arg[k];
    red_sum[warp][lane + 32 * k] = sum[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < QG_SBLK && s0 + t < nsamples) {
    T m = red_max[0][t];
    int a = red_arg[0][t];
    T total = red_sum[0][t];
#pragma unroll
    for (int w = 1; w < QG_WARPS; ++w) {
      const T v = red_max[w][t];
      const int b = red_arg[w][t];
      if (v > m || (v == m && b < a)) {
        m = v;
        a = b;
      }
      total += red_sum[w][t];
    }
    const long long out = (long long)tile_i * nsamples + s0 + t;
    tmax[out] = m;
    targ[out] = a;
    tsum[out] = total;
  }
}

template <typename T>
static int qg_launch(const void* L, int t_len, const void* tt,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_nodes, int n_onsets, int tile,
                     int fsmp, int nsamples, void* stream) {
  if (n_nodes < 1 || n_onsets < 1 || tile != QG_TILE || fsmp < 0 ||
      nsamples < 1 || t_len < fsmp + nsamples ||
      (nsamples + QG_SBLK - 1) / QG_SBLK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (n_nodes + QG_TILE - 1) / QG_TILE;
  const dim3 grid(n_tiles, (nsamples + QG_SBLK - 1) / QG_SBLK);
  qm_migrate_detect_global_kernel<T><<<grid, QG_THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), t_len, static_cast<const int*>(tt),
      static_cast<const T*>(inv_available), static_cast<T*>(tmax),
      static_cast<int*>(targ), static_cast<T*>(tsum), n_nodes, n_onsets,
      fsmp, nsamples);
  return (int)cudaGetLastError();
}

// L: f32 [n_onsets, t_len]; tt: int32 [n_nodes, n_onsets], flat node
// order; inv_available: f32 [1]; tmax, tsum: f32 and targ: int32, each
// [ceil(n_nodes / tile), nsamples], targ holding flat node indices. tile
// must be QG_TILE, and t_len at least fsmp + nsamples.
extern "C" int qm_migrate_detect_global(const void* L, int t_len,
                                        const void* tt,
                                        const void* inv_available,
                                        void* tmax, void* targ, void* tsum,
                                        int n_nodes, int n_onsets, int tile,
                                        int fsmp, int nsamples,
                                        void* stream) {
  return qg_launch<float>(L, t_len, tt, inv_available, tmax, targ, tsum,
                          n_nodes, n_onsets, tile, fsmp, nsamples, stream);
}

// K3 f64: as qm_migrate_detect_global with L, inv_available, tmax and
// tsum float64.
extern "C" int qm_migrate_detect_global_f64(const void* L, int t_len,
                                            const void* tt,
                                            const void* inv_available,
                                            void* tmax, void* targ,
                                            void* tsum, int n_nodes,
                                            int n_onsets, int tile, int fsmp,
                                            int nsamples, void* stream) {
  return qg_launch<double>(L, t_len, tt, inv_available, tmax, targ, tsum,
                           n_nodes, n_onsets, tile, fsmp, nsamples, stream);
}
