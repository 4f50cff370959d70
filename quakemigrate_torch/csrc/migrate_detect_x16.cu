// Shifted-copy ("X16") variant of the detect kernel, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel _x16_kernel
// (experiments/exp_x16.py:46). The TPU kernel keeps a stride-16 table
// X16[o, a, u] = L[o, fsmp + 16 a + u] and rebuilds the shifted operand of
// its one-hot matmul in VMEM with static lane-offset copies, so that the
// DMA engine moves 16x fewer bytes. On the card the question becomes
// whether wider shared-memory reads cut K1's gather (E1: 93.5 % of K1).
//
// Contract: K1's (migrate_detect.cu), exactly. Per
// sample the nodes are visited in the same order and the onsets summed in
// the same order, so tmax, targ and tsum equal K1's bit for bit.
//
// Design. K1's grid and block: one block per (node tile, QM_SBLK-sample
// block), 8 warps, a warp on one node at a time. The block stages each
// onset's window once (cp.async, 4-byte), then rebuilds three more copies
// of it shifted by 1, 2 and 3 floats with shared -> shared copies:
//   copy_c[x] = win[x + c],  c = 0..3, x < wp = round_up(r_span + QM_SBLK, 4)
// (the counterpart of the TPU kernel's static lane-offset rebuild). For
// node n and onset o with residual f = fine[o, n], lane l then needs
// win[f + 4l + j], j = 0..3, which is copy_{f mod 4}[(f - f mod 4) + 4l + j]:
// ONE aligned 16-byte load per (node, onset) instead of K1's four 4-byte
// loads, with register j holding block sample 4l + j. A warp reads 512
// contiguous bytes, four conflict-free wavefronts, as K1 does.
//
// The copies' order in shared memory is the template's LAYOUT, the
// counterpart of the TPU operand layouts:
//   QX_COPY_MAJOR (x16a): copy c of onset o at (c * O + o) * wp;
//   QX_ONSET_MAJOR (x16b): copy c of onset o at (4 o + c) * wp.
// Each copy starts at a multiple of wp floats, so every read is aligned.
//
// Bound on the card: the same shared-memory wavefronts as K1 (16 bytes a
// lane, 4 wavefronts per (node, onset, 128 samples)) with a quarter of the
// load instructions; four copies of the windows (66 KB at tile 512, r_span
// 43, 24 onsets) cut the resident blocks per SM from K1's 8 to 3.

#include "detect_core.cuh"

enum QxLayout { QX_COPY_MAJOR = 0, QX_ONSET_MAJOR = 1 };

template <int LAYOUT>
__device__ __forceinline__ int qx_off(int c, int o, int n_onsets, int wp) {
  return LAYOUT == QX_COPY_MAJOR ? (c * n_onsets + o) * wp : (4 * o + c) * wp;
}

// The gather of qm_reduce_nodes from the four shifted copies: one 16-byte
// load per (node, onset), register k holding block sample 4 * lane + k.
template <int LAYOUT>
struct QxQuadGather {
  const float* copies;
  const int* fine_i;
  int n_onsets;
  int tile;
  int wp;

  static __device__ __forceinline__ int sample(int lane, int k) {
    return 4 * lane + k;
  }

  __device__ __forceinline__ void operator()(int n, float (&acc)[QM_SPT]) const {
    static_assert(QM_SPT == 4, "one float4 per lane covers QM_SBLK samples");
    const int lane4 = 4 * (threadIdx.x & 31);
    for (int o = 0; o < n_onsets; ++o) {
      const int f = __ldg(fine_i + o * tile + n);
      const int c = f & 3;
      const float4 v = *reinterpret_cast<const float4*>(
          copies + qx_off<LAYOUT>(c, o, n_onsets, wp) + (f - c) + lane4);
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }
};

template <int LAYOUT>
__global__ void __launch_bounds__(QM_THREADS)
qm_migrate_detect_x16_kernel(const float* __restrict__ L, int t_len,
                             const int* __restrict__ base,
                             const int* __restrict__ fine,
                             const float* __restrict__ valid,
                             const float* __restrict__ inv_available,
                             float* __restrict__ tmax, int* __restrict__ targ,
                             float* __restrict__ tsum, int n_onsets, int tile,
                             int fsmp, int nsamples, int wp) {
  extern __shared__ __align__(16) float qx_smem[];
  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Copy 0: warp w stages onsets w, w + QM_NWARPS, ..., its lanes
  // consecutive samples. Reads past the row end are zero-filled; they
  // feed only samples at or beyond nsamples (the host checks
  // fsmp + nsamples + max shift <= t_len).
  const int* base_i = base + (long long)tile_i * n_onsets;
  for (int o = warp; o < n_onsets; o += QM_NWARPS) {
    const long long col0 = (long long)fsmp + base_i[o] + s0;
    const float* row = L + (long long)o * t_len;
    float* dst = qx_smem + qx_off<LAYOUT>(0, o, n_onsets, wp);
    for (int x = lane; x < wp; x += 32) {
      const long long col = col0 + x;
      const bool in_row = col < t_len;
      qm_cp_async4(dst + x, row + (in_row ? col : 0), in_row);
    }
  }
  qm_cp_async_commit();
  qm_cp_async_wait<0>();
  __syncthreads();

  // Copies 1..3, shifted by c floats. The tail x + c >= wp is never read
  // (the largest read of copy c is at r_span - 1 - c + QM_SBLK - 1 < wp - c)
  // and is zeroed.
  for (int r = warp; r < 3 * n_onsets; r += QM_NWARPS) {
    const int c = 1 + r / n_onsets;
    const int o = r - (c - 1) * n_onsets;
    const float* src = qx_smem + qx_off<LAYOUT>(0, o, n_onsets, wp);
    float* dst = qx_smem + qx_off<LAYOUT>(c, o, n_onsets, wp);
    for (int x = lane; x < wp; x += 32) dst[x] = x + c < wp ? src[x + c] : 0.0f;
  }
  __syncthreads();

  // The cross-warp reduction reuses the copies' shared memory.
  qm_reduce_nodes<QM_FULL>(
      QxQuadGather<LAYOUT>{qx_smem, fine + (long long)tile_i * n_onsets * tile,
                           n_onsets, tile, wp},
      valid + (long long)tile_i * tile, *inv_available, tile, qx_smem, tmax,
      targ, tsum, (long long)tile_i * nsamples, s0, nsamples);
}

static int qx_smem_bytes(int n_onsets, int r_span) {
  const int wp = (r_span + QM_SBLK + 3) & ~3;
  int floats = 4 * n_onsets * wp;
  if (floats < QM_RED_FLOATS) floats = QM_RED_FLOATS;
  return floats * (int)sizeof(float);
}

template <int LAYOUT>
static int qx_launch(const void* L, int t_len, const void* base,
                     const void* fine, const void* valid,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int tile, int fsmp,
                     int nsamples, int r_span, void* stream) {
  const int wp = (r_span + QM_SBLK + 3) & ~3;
  const int smem = qx_smem_bytes(n_onsets, r_span);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_x16_kernel<LAYOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_migrate_detect_x16_kernel<LAYOUT><<<grid, QM_THREADS, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, wp);
  return (int)cudaGetLastError();
}

// layout: 0 = x16a (copy-major), 1 = x16b (onset-major).
extern "C" int qm_migrate_detect_x16(const void* L, int t_len,
                                     const void* base, const void* fine,
                                     const void* valid,
                                     const void* inv_available, void* tmax,
                                     void* targ, void* tsum, int n_onsets,
                                     int n_tiles, int tile, int fsmp,
                                     int nsamples, int r_span, int layout,
                                     void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QM_NWARPS ||
      tile % QM_NWARPS != 0 || nsamples < 1 || r_span < 1) {
    return (int)cudaErrorInvalidValue;
  }
  switch (layout) {
    case QX_COPY_MAJOR:
      return qx_launch<QX_COPY_MAJOR>(L, t_len, base, fine, valid,
                                      inv_available, tmax, targ, tsum,
                                      n_onsets, n_tiles, tile, fsmp, nsamples,
                                      r_span, stream);
    case QX_ONSET_MAJOR:
      return qx_launch<QX_ONSET_MAJOR>(L, t_len, base, fine, valid,
                                       inv_available, tmax, targ, tsum,
                                       n_onsets, n_tiles, tile, fsmp, nsamples,
                                       r_span, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the layout's kernel at this plan, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_x16_blocks_per_sm(int n_onsets, int r_span,
                                                   int layout) {
  const int smem = qx_smem_bytes(n_onsets, r_span);
  const void* kernel =
      layout == QX_COPY_MAJOR
          ? (const void*)qm_migrate_detect_x16_kernel<QX_COPY_MAJOR>
          : (const void*)qm_migrate_detect_x16_kernel<QX_ONSET_MAJOR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
