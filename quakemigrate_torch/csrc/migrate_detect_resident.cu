// Resident-staging variant of the detect kernel, for Hopper (sm_90a):
// the counterpart of the TPU experiment kernel _resident_kernel
// (experiments/exp_kernel_breakdown.py:261), which parks a whole column
// block of the table in VMEM once per sweep and lets the node tiles
// slice it.
//
// Contract: K1's (migrate_detect.cu), exactly.
//
// Design. One block per (group of `group` consecutive node tiles, block
// of QM_SBLK samples). For each onset the block stages the group's union
// window L[o, fsmp + gbase[g,o] + s0 : + gwidth] once, where gbase is the
// group's smallest base and gwidth = (largest base - smallest base over
// any group) + r_span + QM_SBLK, the one stride of every onset's window.
// It then sweeps the group's tiles, each reading its windows at offset
// base[i,o] - gbase[g,o] into the union (an offset table in shared
// memory), with K1's gather and reduction
// (qm_reduce_tile). The host sizes `group` so the union fits shared
// memory; every read stays inside the staged union by construction.
//
// Question it answers on the card: how much of K1's
// time is staging (O * (r_span + QM_SBLK) floats per tile and sample
// block, from L2) rather than the gather. Cost of the design: a larger
// block footprint (fewer resident blocks per SM) and one more shared
// read (the offset) per node and onset.

#include "detect_core.cuh"

__global__ void __launch_bounds__(QM_THREADS)
qm_resident_kernel(const float* __restrict__ L, int t_len,
                   const int* __restrict__ base,
                   const int* __restrict__ gbase,
                   const int* __restrict__ fine,
                   const float* __restrict__ valid,
                   const float* __restrict__ inv_available,
                   float* __restrict__ tmax, int* __restrict__ targ,
                   float* __restrict__ tsum, int n_onsets, int n_tiles,
                   int tile, int group, int fsmp, int nsamples, int gwidth) {
  extern __shared__ float smem[];
  float* win = smem;                          // n_onsets * gwidth
  float* red = win + n_onsets * gwidth;       // QM_RED_FLOATS
  int* woff = reinterpret_cast<int*>(red + QM_RED_FLOATS);  // n_onsets
  const int g = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int tid = threadIdx.x;
  const int* gbase_g = gbase + (long long)g * n_onsets;

  // Stage the union windows; reads past the row end become 0 (they feed
  // only samples at or beyond nsamples, which are not stored).
  const int staged = n_onsets * gwidth;
  for (int k = tid; k < staged; k += QM_THREADS) {
    const int o = k / gwidth;
    const long long col =
        (long long)fsmp + gbase_g[o] + s0 + (k - o * gwidth);
    win[k] = col < t_len ? L[(long long)o * t_len + col] : 0.0f;
  }

  const float inv = *inv_available;
  const int i_end = min(n_tiles, (g + 1) * group);
  for (int i = g * group; i < i_end; ++i) {
    // The previous tile's readers of woff and red are past both barriers
    // of qm_reduce_tile, so the table can be rewritten here.
    for (int o = tid; o < n_onsets; o += QM_THREADS) {
      woff[o] = o * gwidth + base[(long long)i * n_onsets + o] - gbase_g[o];
    }
    __syncthreads();  // staging (first tile) and this tile's offsets
    qm_reduce_tile<QM_FULL>(win, QmTable{woff},
                            fine + (long long)i * n_onsets * tile,
                            valid + (long long)i * tile, inv, n_onsets, tile,
                            red, tmax, targ, tsum, (long long)i * nsamples,
                            s0, nsamples);
  }
}

// Shared-memory bytes of one block.
static int qm_resident_smem(int n_onsets, int gwidth) {
  return (n_onsets * gwidth + QM_RED_FLOATS + n_onsets) * (int)sizeof(float);
}

extern "C" int qm_migrate_detect_resident(
    const void* L, int t_len, const void* base, const void* gbase,
    const void* fine, const void* valid, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles, int tile,
    int group, int fsmp, int nsamples, int gwidth, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QM_NWARPS ||
      tile % QM_NWARPS != 0 || nsamples < 1 || group < 1 ||
      gwidth < QM_SBLK + 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = qm_resident_smem(n_onsets, gwidth);
  cudaError_t err = cudaFuncSetAttribute(
      qm_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tiles + group - 1) / group,
                  (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_resident_kernel<<<grid, QM_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(gbase), static_cast<const int*>(fine),
      static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, n_tiles,
      tile, group, fsmp, nsamples, gwidth);
  return (int)cudaGetLastError();
}
