// Multi-stage (pipelined) variant of the detect kernel, for Hopper
// (sm_90a): the counterpart of the TPU experiment kernel _deep_kernel
// (experiments/exp_kernel_breakdown.py:459), which keeps an n_slots-deep
// queue of table-slice DMAs in flight so the copy engine never idles.
//
// Contract: the production kernel's (migrate_detect.cu), exactly.
//
// Design. A persistent grid (about one to two blocks per SM, set by the
// host) walks the (node tile, sample block) steps in tile-major order:
// block b takes steps b, b + gridDim.x, ... Each block keeps a ring of
// NS slots in shared memory; one slot holds one step's staged windows,
// onset o's at offset span_off[o] (span_off[o+1] - span_off[o] =
// r_spans[o] + QM_SBLK per onset, or the uniform r_span + QM_SBLK).
// While it gathers step k from slot k % NS, the cp.async copies of step
// k + NS - 1 are in flight into the slot step k - 1 used. Each step's
// copies are one commit group; `cp.async.wait_group NS-1` then a barrier
// make step k's slot complete and visible, and a barrier after the step
// keeps the slot from being overwritten while any warp still reads it.
// The gather and reduction are the production kernel's (qm_reduce_tile).
//
// Question it answers on the card: whether overlapping the staging with
// the gather, instead of staging then gathering in each block, moves the
// kernel; and (per-onset spans) whether staging fewer floats does. The
// cost: a persistent grid holds fewer warps per SM than the production
// kernel's many short blocks, so it hides less shared-memory latency.

#include "detect_core.cuh"

// Queue the copies of one step into `slot`: warp w stages onsets w,
// w + QM_NWARPS, ..., its lanes consecutive samples. Reads past the row
// end are zero-filled (they feed only samples at or beyond nsamples).
__device__ __forceinline__ void qm_stage_step(
    float* slot, const int* off, const float* __restrict__ L, int t_len,
    const int* __restrict__ base_i, int n_onsets, int fsmp, int s0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = warp; o < n_onsets; o += QM_NWARPS) {
    const int width = off[o + 1] - off[o];
    const long long col0 = (long long)fsmp + base_i[o] + s0;
    const float* row = L + (long long)o * t_len;
    float* dst = slot + off[o];
    for (int c = lane; c < width; c += 32) {
      const long long col = col0 + c;
      const bool in_row = col < t_len;
      qm_cp_async4(dst + c, row + (in_row ? col : 0), in_row);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(QM_THREADS)
qm_pipelined_kernel(const float* __restrict__ L, int t_len,
                    const int* __restrict__ base,
                    const int* __restrict__ span_off,
                    const int* __restrict__ fine,
                    const float* __restrict__ valid,
                    const float* __restrict__ inv_available,
                    float* __restrict__ tmax, int* __restrict__ targ,
                    float* __restrict__ tsum, int n_onsets, int n_tiles,
                    int tile, int fsmp, int nsamples, int n_sblocks) {
  extern __shared__ float smem[];
  const int off_floats = (n_onsets + 4) & ~3;  // keeps the ring 16-aligned
  int* off = reinterpret_cast<int*>(smem);     // n_onsets + 1
  float* red = smem + off_floats;              // QM_RED_FLOATS
  float* ring = red + QM_RED_FLOATS;           // NS * slot_floats
  const int tid = threadIdx.x;

  for (int o = tid; o <= n_onsets; o += QM_THREADS) off[o] = span_off[o];
  __syncthreads();
  const int slot_floats = off[n_onsets];
  const float inv = *inv_available;

  const long long n_steps = (long long)n_tiles * n_sblocks;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  const int my_steps =
      first < n_steps ? (int)((n_steps - first + stride - 1) / stride) : 0;

  // Prologue: steps 0 .. NS-2 of this block, one commit group each
  // (empty groups too, so that group k always holds step k).
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < my_steps) {
      const long long step = first + k * stride;
      const int i = (int)(step / n_sblocks);
      const int s0 = (int)(step % n_sblocks) * QM_SBLK;
      qm_stage_step(ring + k * slot_floats, off, L, t_len,
                    base + (long long)i * n_onsets, n_onsets, fsmp, s0);
    }
    qm_cp_async_commit();
  }

  for (int k = 0; k < my_steps; ++k) {
    const int ahead = k + NS - 1;
    if (ahead < my_steps) {
      const long long step = first + ahead * stride;
      const int i = (int)(step / n_sblocks);
      const int s0 = (int)(step % n_sblocks) * QM_SBLK;
      qm_stage_step(ring + (ahead % NS) * slot_floats, off, L, t_len,
                    base + (long long)i * n_onsets, n_onsets, fsmp, s0);
    }
    qm_cp_async_commit();
    qm_cp_async_wait<NS - 1>();  // this thread's copies of step k landed
    __syncthreads();             // ... and every thread's

    const long long step = first + k * stride;
    const int i = (int)(step / n_sblocks);
    const int s0 = (int)(step % n_sblocks) * QM_SBLK;
    qm_reduce_tile<QM_FULL>(ring + (k % NS) * slot_floats, QmTable{off},
                            fine + (long long)i * n_onsets * tile,
                            valid + (long long)i * tile, inv, n_onsets, tile,
                            red, tmax, targ, tsum, (long long)i * nsamples,
                            s0, nsamples);
    __syncthreads();  // slot k % NS is refilled at step k + 1
  }
  qm_cp_async_wait<0>();
}

static int qm_pipelined_smem(int n_onsets, int slot_floats, int n_stages) {
  const int off_floats = (n_onsets + 4) & ~3;
  return (off_floats + QM_RED_FLOATS + n_stages * slot_floats) *
         (int)sizeof(float);
}

template <int NS>
static int qm_launch_pipelined(const void* L, int t_len, const void* base,
                               const void* span_off, const void* fine,
                               const void* valid, const void* inv_available,
                               void* tmax, void* targ, void* tsum,
                               int n_onsets, int n_tiles, int tile, int fsmp,
                               int nsamples, int slot_floats,
                               int blocks_per_sm, void* stream) {
  const int smem = qm_pipelined_smem(n_onsets, slot_floats, NS);
  cudaError_t err = cudaFuncSetAttribute(
      qm_pipelined_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qm_pipelined_kernel<NS>, QM_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (blocks_per_sm > 0 && blocks_per_sm < per_sm) per_sm = blocks_per_sm;
  const int n_sblocks = (nsamples + QM_SBLK - 1) / QM_SBLK;
  const long long n_steps = (long long)n_tiles * n_sblocks;
  long long blocks = (long long)n_sm * per_sm;
  if (blocks > n_steps) blocks = n_steps;
  qm_pipelined_kernel<NS><<<(unsigned)blocks, QM_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(span_off), static_cast<const int*>(fine),
      static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, n_tiles,
      tile, fsmp, nsamples, n_sblocks);
  return (int)cudaGetLastError();
}

// span_off: int32 [n_onsets + 1] on the device, span_off[0] = 0 and
// span_off[n_onsets] = slot_floats. blocks_per_sm caps the resident
// blocks per SM of the persistent grid (0: as many as fit).
extern "C" int qm_migrate_detect_pipelined(
    const void* L, int t_len, const void* base, const void* span_off,
    const void* fine, const void* valid, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles, int tile,
    int fsmp, int nsamples, int slot_floats, int n_stages, int blocks_per_sm,
    void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QM_NWARPS ||
      tile % QM_NWARPS != 0 || nsamples < 1 || slot_floats < QM_SBLK) {
    return (int)cudaErrorInvalidValue;
  }
#define QM_STAGES_CASE(NS)                                                    \
  case NS:                                                                    \
    return qm_launch_pipelined<NS>(L, t_len, base, span_off, fine, valid,    \
                                   inv_available, tmax, targ, tsum,          \
                                   n_onsets, n_tiles, tile, fsmp, nsamples,  \
                                   slot_floats, blocks_per_sm, stream);
  switch (n_stages) {
    QM_STAGES_CASE(2)
    QM_STAGES_CASE(3)
    QM_STAGES_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QM_STAGES_CASE
}
