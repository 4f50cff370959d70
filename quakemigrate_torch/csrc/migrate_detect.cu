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
// reads its shifted samples from it. A warp owns one node at a time and
// its 32 lanes read 32 consecutive samples, so each shared-memory read
// is conflict-free; each thread keeps QM_SBLK/32 sums in registers and
// adds the onsets in order o = 0..O-1, the same order as the plain
// version. The epilogue takes exp, applies valid, and reduces the tile's
// nodes per sample: first per thread over its nodes, then across warps.
//
// Bound on the card: shared-memory gather bandwidth. A block makes
// O * tile * QM_SBLK 4-byte shared reads against O * (r_span + QM_SBLK)
// floats staged, so each staged value is read about `tile` times and
// device-memory traffic is small (L is a few hundred KB and stays in
// L2). The staging has no double buffering (no cp.async or TMA yet).

#include <cuda_runtime.h>
#include <math.h>

#define QM_SBLK 128
#define QM_NWARPS 8
#define QM_THREADS (32 * QM_NWARPS)
#define QM_SPT (QM_SBLK / 32)

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
  const int lane = tid & 31;
  const int warp = tid >> 5;

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

  const float inv = *inv_available;
  const int* fine_i = fine + (long long)tile_i * n_onsets * tile;
  const float* valid_i = valid + (long long)tile_i * tile;

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
    for (int o = 0; o < n_onsets; ++o) {
      const float* w = smem + o * width + __ldg(fine_i + o * tile + n) + lane;
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) acc[k] += w[32 * k];
    }
    const float v = __ldg(valid_i + n);
#pragma unroll
    for (int k = 0; k < QM_SPT; ++k) {
      // __fmul_rn: no contraction into expf's range reduction, so the
      // exponent argument is rounded exactly as in the plain version.
      const float coa = __fmul_rn(expf(__fmul_rn(acc[k], inv)), v);
      if (coa > best[k]) {
        best[k] = coa;
        arg[k] = n;
      }
      total[k] += coa;
    }
  }
  __syncthreads();  // all reads of the staged windows are done

  // Cross-warp reduction through shared memory (reusing the windows).
  float* red_max = smem;
  int* red_arg = reinterpret_cast<int*>(smem + QM_NWARPS * QM_SBLK);
  float* red_sum = smem + 2 * QM_NWARPS * QM_SBLK;
#pragma unroll
  for (int k = 0; k < QM_SPT; ++k) {
    const int s = warp * QM_SBLK + lane + 32 * k;
    red_max[s] = best[k];
    red_arg[s] = arg[k];
    red_sum[s] = total[k];
  }
  __syncthreads();

  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = red_arg[tid];
    float s = red_sum[tid];
    for (int w = 1; w < QM_NWARPS; ++w) {
      const float mw = red_max[w * QM_SBLK + tid];
      const int aw = red_arg[w * QM_SBLK + tid];
      if (mw > m || (mw == m && aw < a)) {
        m = mw;
        a = aw;
      }
      s += red_sum[w * QM_SBLK + tid];
    }
    const long long out = (long long)tile_i * nsamples + s0 + tid;
    tmax[out] = m;
    targ[out] = a;
    tsum[out] = s;
  }
}

extern "C" int qm_migrate_detect(const void* L, int t_len, const void* base,
                                 const void* fine, const void* valid,
                                 const void* inv_available, void* tmax,
                                 void* targ, void* tsum, int n_onsets,
                                 int n_tiles, int tile, int fsmp, int nsamples,
                                 int r_span, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QM_NWARPS ||
      tile % QM_NWARPS != 0 || nsamples < 1 || r_span < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int width = r_span + QM_SBLK;
  int floats = n_onsets * width;
  if (floats < 3 * QM_NWARPS * QM_SBLK) floats = 3 * QM_NWARPS * QM_SBLK;
  const int smem = floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_migrate_detect_kernel<<<grid, QM_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, width);
  return (int)cudaGetLastError();
}

extern "C" const char* qm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
