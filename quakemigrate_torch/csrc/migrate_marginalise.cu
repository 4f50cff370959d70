// Migration marginalised over a sample window, for locate's second pass:
// M1. At the end of the file, the simple form of M2 (the coalescence map
// of locate's map path) on M1's gather.
//
// Replaces the XLA function migrate_marginalise
// (quakemigrate_tpu/ops/migrate.py:291), which has no Pallas kernel: it
// builds every node tile's coalescence over the whole scan window and
// multiplies it by a 0/1 window vector (coa @ in_window). Contract, per
// node n of the detect plan (DetectPlan, the plan pass 1 runs on):
//
//   out[perm[n]] = sum_{t=0}^{len-1} exp(inv_available *
//                    sum_{o=0}^{O-1} L[o, col0 + base[i,o] + fine[i,o,n] + t])
//
// for every real node (valid[i, n] != 0) of tile i, with col0 = fsmp +
// window_start and L the clipped, logged and masked onsets; padding nodes
// write nothing. The onsets are summed in order o = 0..O-1 in float32, as
// the plain version (ops/migrate.py::migrate_marginalise) sums them, so
// each sample's exponent equals the plain version's; the samples are then
// summed per lane, across the warp and over the chunks in order, in
// another order than the plain version's.
//
// Bound on the card: at a locate window (tens of samples) the bytes the
// function must move (real nodes x O x 4 B of traveltimes, the onset
// columns the window touches, the [n_nodes] output), then the gather of
// node x onset x sample values from the onset rows, which stay in L2 (a
// few hundred KB). What holds it is latency: a warp takes its nodes one
// after another, and a node's onset reads wait on each other (PERF.md
// section 6 gives its times on an H100 against that bound).
// The design is the simple one, right first:
// - one block a node tile x sample chunk of QM1_CHUNK samples, 8 warps;
//   warp w takes nodes w, w + 8, ... of the tile, so the 8 warps of a
//   block read neighbouring residuals of each onset (one cache line);
// - lane j loads the column offset of onset c + j (the tile's base plus
//   the node's residual) for a chunk of 32 onsets, and the warp passes
//   them round with __shfl_sync: one residual load a lane per 32 onsets,
//   not one ahead of each onset read;
// - lane j takes the chunk's samples j + 32 k, k < QM1_SPL, and adds up
//   to QM1_SPL onset samples an onset, 32 consecutive samples a warp
//   load;
// - then exp, the lane's sum, a shuffle sum over the warp and one store
//   a node, scattered through perm to its flat index: into out where the
//   window is one chunk, else into row `chunk` of a [chunks, n_nodes]
//   partial table, whose rows a second kernel adds in chunk order.
// It reads the onset rows from global memory (no shared-memory slab, no
// int16 table), so it takes every plan pass 1 can run, whatever the
// onset count or residual span. Its fast form, M1 v2
// (migrate_marginalise_v2.cu: K1 v2's gather core on its uint16 slab,
// the onsets from shared windows, several nodes a warp in flight), is
// locate's pass 2 on K1 v2's route; M1 stays for the plans K1 v2 refuses
// (CudaDetectVPU's route) and as M1 v2's yardstick, equal to it bit for
// bit at windows of up to 128 samples.
//
// M1 f64 and M2 simple f64 (qm_migrate_marginalise_f64, qm_migrate_map_f64):
// the same kernels on double, for QuakeScan(precision="double"), where the
// reference keeps migrate_marginalise and migrate_map in float64. The
// onsets, the sums, exp and the outputs are double, the chunk sum too;
// the gather reads 8-byte values (a warp's read of a row is two 128-byte
// lines). Bound as for float with 8-byte values, and the card's FP64 rate
// for the adds and exp.

#include <cuda_runtime.h>

#include "marginalise_chunks.cuh"

#define QM1_WARPS 8
#define QM1_THREADS (32 * QM1_WARPS)
// Samples a lane adds per pass over the onsets, and the samples of a
// block's chunk
#define QM1_SPL 8
#define QM1_CHUNK (32 * QM1_SPL)

// exp, and exp of a product rounded on its own (M2's value: no
// contraction into exp's range reduction), in each element type
__device__ __forceinline__ float qm1_exp(float x) { return expf(x); }
__device__ __forceinline__ double qm1_exp(double x) { return exp(x); }
__device__ __forceinline__ float qm1_exp_rn(float acc, float inv) {
  return expf(__fmul_rn(acc, inv));
}
__device__ __forceinline__ double qm1_exp_rn(double acc, double inv) {
  return exp(__dmul_rn(acc, inv));
}

// Node n's onset sums for the lane's samples t_begin + lane + 32 k of the
// chunk (k < nk, lane + 32 k < t_count): onsets in order o = 0..O-1, lane
// j loading the column offset of onset c + j (the tile's column col[c + j]
// plus the node's residual) for a chunk of 32 onsets and the warp passing
// them round with __shfl_sync.
template <typename T>
__device__ __forceinline__ void qm1_gather(T (&acc)[QM1_SPL],
                                           const T* __restrict__ L,
                                           int t_len, const int* col,
                                           const int* __restrict__ fine_i,
                                           int tile, int n, int n_onsets,
                                           int t_begin, int t_count, int nk,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < QM1_SPL; ++k) acc[k] = T(0);
  for (int c = 0; c < n_onsets; c += 32) {
    // Lane j's column offset of onset c + j, passed round the warp
    const int mine = c + lane < n_onsets
        ? col[c + lane] + fine_i[(long long)(c + lane) * tile + n]
        : 0;
    const int m = min(32, n_onsets - c);
    const T* rows = L + (long long)c * t_len + t_begin + lane;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const T* row =
          rows + (long long)j * t_len + __shfl_sync(0xffffffffu, mine, j);
#pragma unroll
      for (int k = 0; k < QM1_SPL; ++k) {
        if (k < nk && lane + 32 * k < t_count) acc[k] += row[32 * k];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(QM1_THREADS)
qm_migrate_marginalise_kernel(const T* __restrict__ L, int t_len,
                              const int* __restrict__ base,
                              const int* __restrict__ fine,
                              const float* __restrict__ valid,
                              const int* __restrict__ perm,
                              const T* __restrict__ inv_available,
                              T* __restrict__ dst, int n_nodes,
                              int n_onsets, int tile, int col0,
                              int window_length) {
  // The tile's first column of each onset row: col0 + base[i, o]
  extern __shared__ int qm1_col[];
  const int tile_i = blockIdx.x;
  const int chunk = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* base_i = base + (long long)tile_i * n_onsets;
  for (int o = threadIdx.x; o < n_onsets; o += QM1_THREADS) {
    qm1_col[o] = col0 + base_i[o];
  }
  __syncthreads();

  const T inv = *inv_available;
  const int* fine_i = fine + (long long)tile_i * n_onsets * tile;
  const float* valid_i = valid + (long long)tile_i * tile;
  // This chunk's samples [t_begin, t_begin + t_count) of the window, and
  // the slots k that hold a sample for some lane: block-uniform
  const int t_begin = chunk * QM1_CHUNK;
  const int t_count = min(QM1_CHUNK, window_length - t_begin);
  const int nk = (t_count + 31) / 32;
  T* dst_c = dst + (long long)chunk * n_nodes;
  for (int n = warp; n < tile; n += QM1_WARPS) {
    if (valid_i[n] == 0.0f) continue;  // a padding node: warp-uniform
    T acc[QM1_SPL];
    qm1_gather(acc, L, t_len, qm1_col, fine_i, tile, n, n_onsets, t_begin,
               t_count, nk, lane);
    T total = T(0);
#pragma unroll
    for (int k = 0; k < QM1_SPL; ++k) {
      if (k < nk && lane + 32 * k < t_count) total += qm1_exp(acc[k] * inv);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    if (lane == 0) dst_c[perm[(long long)tile_i * tile + n]] = total;
  }
}

template <typename T>
static int qm1_launch(const void* L, int t_len, const void* base,
                      const void* fine, const void* valid, const void* perm,
                      const void* inv_available, void* out, void* partial,
                      int partial_rows, int n_nodes, int n_onsets,
                      int n_tiles, int tile, int col0, int window_length,
                      void* stream) {
  const int n_chunks =
      window_length > QM1_CHUNK ? (window_length + QM1_CHUNK - 1) / QM1_CHUNK
                                : 1;
  if (n_onsets < 1 || n_tiles < 1 || tile < 1 || n_nodes < 1 || col0 < 0 ||
      window_length < 0 || n_onsets * (int)sizeof(int) > 48 * 1024 ||
      (n_chunks > 1 && (partial == nullptr || partial_rows < n_chunks))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* dst = static_cast<T*>(n_chunks > 1 ? partial : out);
  qm_migrate_marginalise_kernel<T><<<dim3(n_tiles, n_chunks), QM1_THREADS,
                                     n_onsets * sizeof(int), s>>>(
      static_cast<const T*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const int*>(perm), static_cast<const T*>(inv_available),
      dst, n_nodes, n_onsets, tile, col0, window_length);
  if (n_chunks > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    qm_marginalise_sum_chunks_kernel<T><<<(n_nodes + 255) / 256, 256, 0, s>>>(
        static_cast<const T*>(partial), n_chunks, n_nodes,
        static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

// L: f32 [n_onsets, t_len]; base: int32 [n_tiles, n_onsets]; fine: int32
// [n_tiles, n_onsets, tile]; valid: f32 [n_tiles, tile]; perm: int32
// [n_tiles * tile], each real node's flat index; inv_available: f32 [1];
// out: f32 [n_nodes], every real node written once; partial: f32
// [partial_rows, n_nodes], used where the window spans more than one
// chunk of QM1_CHUNK samples (partial_rows at least the chunk count),
// else unread and may be null. The host checks that col0 + max(base +
// fine) + window_length <= t_len.
extern "C" int qm_migrate_marginalise(const void* L, int t_len,
                                      const void* base, const void* fine,
                                      const void* valid, const void* perm,
                                      const void* inv_available, void* out,
                                      void* partial, int partial_rows,
                                      int n_nodes, int n_onsets, int n_tiles,
                                      int tile, int col0, int window_length,
                                      void* stream) {
  return qm1_launch<float>(L, t_len, base, fine, valid, perm, inv_available,
                           out, partial, partial_rows, n_nodes, n_onsets,
                           n_tiles, tile, col0, window_length, stream);
}

// M1 f64: as qm_migrate_marginalise with L, inv_available, out and
// partial float64 (valid stays float32).
extern "C" int qm_migrate_marginalise_f64(const void* L, int t_len,
                                          const void* base, const void* fine,
                                          const void* valid, const void* perm,
                                          const void* inv_available,
                                          void* out, void* partial,
                                          int partial_rows, int n_nodes,
                                          int n_onsets, int n_tiles, int tile,
                                          int col0, int window_length,
                                          void* stream) {
  return qm1_launch<double>(L, t_len, base, fine, valid, perm, inv_available,
                            out, partial, partial_rows, n_nodes, n_onsets,
                            n_tiles, tile, col0, window_length, stream);
}

// M2's simple form: the coalescence map of locate's map path on M1's
// code, for the plans K1 v2 (and so M2) cannot stage, CudaDetectVPU's
// route. Replaces, as M2 (migrate_marginalise_v2.cu) does, the XLA
// function migrate_map (quakemigrate_tpu/ops/migrate.py:264), with M2's
// contract: per real node n of tile i and scan sample t < nsamples,
//
//   map[perm[n], t] = exp(inv_available *
//                      sum_{o=0}^{O-1} L[o, col0 + base[i,o] + fine[i,o,n] + t])
//
// each value expf(__fmul_rn(acc, inv)) of the onsets summed in order, as
// M2 and K1 v2 compute it. One block a node tile x chunk of QM1_CHUNK
// samples, warp w taking nodes w, w + 8, ... (M1's gather, qm1_gather),
// and each lane storing its samples into the node's row: a warp writes 32
// consecutive floats of a row a store.
template <typename T>
__global__ void __launch_bounds__(QM1_THREADS)
qm_migrate_map_kernel(const T* __restrict__ L, int t_len,
                      const int* __restrict__ base,
                      const int* __restrict__ fine,
                      const float* __restrict__ valid,
                      const int* __restrict__ perm,
                      const T* __restrict__ inv_available,
                      T* __restrict__ map, int n_onsets, int tile,
                      int col0, int nsamples) {
  extern __shared__ int qm1_col[];
  const int tile_i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* base_i = base + (long long)tile_i * n_onsets;
  for (int o = threadIdx.x; o < n_onsets; o += QM1_THREADS) {
    qm1_col[o] = col0 + base_i[o];
  }
  __syncthreads();

  const T inv = *inv_available;
  const int* fine_i = fine + (long long)tile_i * n_onsets * tile;
  const float* valid_i = valid + (long long)tile_i * tile;
  const int t_begin = blockIdx.y * QM1_CHUNK;
  const int t_count = min(QM1_CHUNK, nsamples - t_begin);
  const int nk = (t_count + 31) / 32;
  for (int n = warp; n < tile; n += QM1_WARPS) {
    if (valid_i[n] == 0.0f) continue;  // a padding node: warp-uniform
    T acc[QM1_SPL];
    qm1_gather(acc, L, t_len, qm1_col, fine_i, tile, n, n_onsets, t_begin,
               t_count, nk, lane);
    T* out = map + (long long)perm[(long long)tile_i * tile + n] *
                           nsamples + t_begin + lane;
#pragma unroll
    for (int k = 0; k < QM1_SPL; ++k) {
      if (k < nk && lane + 32 * k < t_count) {
        out[32 * k] = qm1_exp_rn(acc[k], inv);
      }
    }
  }
}

template <typename T>
static int qm_map_launch(const void* L, int t_len, const void* base,
                         const void* fine, const void* valid,
                         const void* perm, const void* inv_available,
                         void* map, int n_onsets, int n_tiles, int tile,
                         int col0, int nsamples, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 1 || col0 < 0 || nsamples < 1 ||
      n_onsets * (int)sizeof(int) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = (nsamples + QM1_CHUNK - 1) / QM1_CHUNK;
  qm_migrate_map_kernel<T><<<dim3(n_tiles, n_chunks), QM1_THREADS,
                             n_onsets * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const int*>(perm), static_cast<const T*>(inv_available),
      static_cast<T*>(map), n_onsets, tile, col0, nsamples);
  return (int)cudaGetLastError();
}

// L, t_len, base, fine, valid, perm and inv_available as for
// qm_migrate_marginalise; map: f32 [n_nodes, nsamples], each real node's
// row written whole. The host checks that col0 + max(base + fine) +
// nsamples <= t_len.
extern "C" int qm_migrate_map(const void* L, int t_len, const void* base,
                              const void* fine, const void* valid,
                              const void* perm, const void* inv_available,
                              void* map, int n_onsets, int n_tiles, int tile,
                              int col0, int nsamples, void* stream) {
  return qm_map_launch<float>(L, t_len, base, fine, valid, perm,
                              inv_available, map, n_onsets, n_tiles, tile,
                              col0, nsamples, stream);
}

// M2 simple f64: as qm_migrate_map with L, inv_available and map float64.
extern "C" int qm_migrate_map_f64(const void* L, int t_len, const void* base,
                                  const void* fine, const void* valid,
                                  const void* perm,
                                  const void* inv_available, void* map,
                                  int n_onsets, int n_tiles, int tile,
                                  int col0, int nsamples, void* stream) {
  return qm_map_launch<double>(L, t_len, base, fine, valid, perm,
                               inv_available, map, n_onsets, n_tiles, tile,
                               col0, nsamples, stream);
}
