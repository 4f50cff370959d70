// Fused migrate-and-reduce for the detect stage, for Hopper (sm_90a).
//
// Replaces the TPU kernel _mxu_detect_kernel
// (quakemigrate_tpu/ops/pallas_migrate.py:399), which selects each
// node's shifted onset samples with a one-hot matmul over Hankel-table
// slices because the TPU has no vector gather. Here the selection is a
// gather from shared memory.
//
// Contract, per node tile i (brick order) and scan sample t:
//   coa[n,t]  = exp(sum_o L[o, fsmp + base[i,o] + fine[i,o,n] + t]
//                   * inv_available) * valid[i,n]
//   tmax[i,t] = max_n coa[n,t]
//   targ[i,t] = smallest local n with coa[n,t] == tmax[i,t]
//   tsum[i,t] = sum_n coa[n,t]
// L is the clipped, logged and masked onset block [O, t_len]. The tiles
// are combined on the host side (combine_tiles): the first tile wins
// ties and the plan's permutation maps the local index to the flat node
// index, so ties follow brick order.
//
// Design. One block per (node tile, block of QM_SBLK samples). For each
// onset the block stages the row window L[o, fsmp+base[i,o]+s0 :
// + r_span + QM_SBLK] in shared memory once; every node of the tile then
// reads its shifted samples from it (qm_reduce_tile, detect_core.cuh).
// A warp owns one node at a time and its 32 lanes read 32 consecutive
// samples, so each shared-memory read is conflict-free; each thread
// keeps QM_SBLK/32 sums in registers and adds the onsets in order
// o = 0..O-1, the same order as the plain version. The epilogue takes
// exp, applies valid, and reduces the tile's nodes per sample: first per
// thread over its nodes, then across warps.
//
// Bound on the card: shared-memory gather bandwidth. A block makes
// O * tile * QM_SBLK 4-byte shared reads against O * (r_span + QM_SBLK)
// floats staged, so each staged value is read about `tile` times and
// device-memory traffic is small (L is a few hundred KB and stays in
// L2). The staging has no double buffering (no cp.async or TMA yet).
//
// The kernel is a template on the reduction variant (QmVariant):
// QM_FULL is K1 (qm_migrate_detect); the others are
// its ablations for the cost breakdown (qm_migrate_detect_ablate), the
// counterpart of the TPU experiment kernel _kernel
// (experiments/exp_kernel_breakdown.py:36). Being the same template,
// they cannot drift from it.

#include "detect_core.cuh"

template <int V>
__global__ void __launch_bounds__(QM_THREADS)
qm_migrate_detect_kernel(const float* __restrict__ L, int t_len,
                         const int* __restrict__ base,
                         const int* __restrict__ fine,
                         const float* __restrict__ valid,
                         const float* __restrict__ inv_available,
                         float* __restrict__ tmax, int* __restrict__ targ,
                         float* __restrict__ tsum, int n_onsets, int tile,
                         int fsmp, int nsamples, int width) {
  extern __shared__ float smem[];
  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int tid = threadIdx.x;

  // Stage every onset's row window; reads past the row end become 0.
  // They feed only samples at or beyond nsamples, which are not stored
  // (the host checks fsmp + nsamples + max shift <= t_len).
  const int* base_i = base + (long long)tile_i * n_onsets;
  const int staged = n_onsets * width;
  for (int k = tid; k < staged; k += QM_THREADS) {
    const int o = k / width;
    const long long col = (long long)fsmp + base_i[o] + s0 + (k - o * width);
    smem[k] = col < t_len ? L[(long long)o * t_len + col] : 0.0f;
  }
  __syncthreads();

  const long long out_row = (long long)tile_i * nsamples;
  if constexpr (V == QM_NOGATHER) {
    qm_staged_sum(smem, QmStride{width}, n_onsets, tmax, targ, tsum, out_row,
                  s0, nsamples);
  } else {
    // The cross-warp reduction reuses the windows' shared memory.
    qm_reduce_tile<V>(smem, QmStride{width},
                      fine + (long long)tile_i * n_onsets * tile,
                      valid + (long long)tile_i * tile, *inv_available,
                      n_onsets, tile, smem, tmax, targ, tsum, out_row, s0,
                      nsamples);
  }
}

template <int V>
static int qm_launch_detect(const void* L, int t_len, const void* base,
                            const void* fine, const void* valid,
                            const void* inv_available, void* tmax, void* targ,
                            void* tsum, int n_onsets, int n_tiles, int tile,
                            int fsmp, int nsamples, int r_span, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QM_NWARPS ||
      tile % QM_NWARPS != 0 || nsamples < 1 || r_span < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int width = r_span + QM_SBLK;
  int floats = n_onsets * width;
  if (floats < QM_RED_FLOATS) floats = QM_RED_FLOATS;
  const int smem = floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_migrate_detect_kernel<V><<<grid, QM_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, width);
  return (int)cudaGetLastError();
}

extern "C" int qm_migrate_detect(const void* L, int t_len, const void* base,
                                 const void* fine, const void* valid,
                                 const void* inv_available, void* tmax,
                                 void* targ, void* tsum, int n_onsets,
                                 int n_tiles, int tile, int fsmp, int nsamples,
                                 int r_span, void* stream) {
  return qm_launch_detect<QM_FULL>(L, t_len, base, fine, valid, inv_available,
                                   tmax, targ, tsum, n_onsets, n_tiles, tile,
                                   fsmp, nsamples, r_span, stream);
}

// The same launch with the reduction variant `variant` (a QmVariant).
extern "C" int qm_migrate_detect_ablate(
    const void* L, int t_len, const void* base, const void* fine,
    const void* valid, const void* inv_available, void* tmax, void* targ,
    void* tsum, int n_onsets, int n_tiles, int tile, int fsmp, int nsamples,
    int r_span, int variant, void* stream) {
#define QM_ABLATE_CASE(V)                                                   \
  case V:                                                                   \
    return qm_launch_detect<V>(L, t_len, base, fine, valid, inv_available, \
                               tmax, targ, tsum, n_onsets, n_tiles, tile,  \
                               fsmp, nsamples, r_span, stream);
  switch (variant) {
    QM_ABLATE_CASE(QM_FULL)
    QM_ABLATE_CASE(QM_NOEXP)
    QM_ABLATE_CASE(QM_NOARGMAX)
    QM_ABLATE_CASE(QM_NOREDUCE)
    QM_ABLATE_CASE(QM_NOGATHER)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QM_ABLATE_CASE
}

// Resident blocks per SM of K1 at this plan, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_blocks_per_sm(int n_onsets, int r_span) {
  int floats = n_onsets * (r_span + QM_SBLK);
  if (floats < QM_RED_FLOATS) floats = QM_RED_FLOATS;
  const int smem = floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_kernel<QM_FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qm_migrate_detect_kernel<QM_FULL>, QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* qm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
