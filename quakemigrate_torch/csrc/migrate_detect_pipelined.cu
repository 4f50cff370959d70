// Multi-stage (pipelined) variant of the detect kernel, for Hopper
// (sm_90a): the counterpart of the TPU experiment kernel _deep_kernel
// (experiments/exp_kernel_breakdown.py:459), which keeps an n_slots-deep
// queue of table-slice DMAs in flight so the copy engine never idles;
// and, as two template flags on it, of the staging probe _probe_kernel
// (experiments/exp_dma_probe.py:117).
//
// Contract: K1's (migrate_detect.cu), exactly; with
// PACKED, the contract on all-zero windows (below).
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
// The gather and reduction are K1's (qm_reduce_tile).
//
// Question it answers on the card: whether overlapping the staging with
// the gather, instead of staging then gathering in each block, moves the
// kernel; and (per-onset spans) whether staging fewer floats does. The
// cost: a persistent grid holds fewer warps per SM than the production
// kernel's many short blocks, so it hides less shared-memory latency.
//
// The staging probe (NS = 2), the TPU probe's two modes:
// - STATIC_SLOTS ("static2"): the step loop unrolled by two, so each half
//   gathers from and stages into a slot fixed at compile time instead of
//   ring + (k % NS) * slot_floats. The contract is unchanged.
// - PACKED ("packed", with STATIC_SLOTS): each step stages ONE contiguous
//   run of slot_floats floats with 16-byte cp.async from a zero-filled
//   table, at offset (sample block) * slot_floats, in place of the
//   per-onset 4-byte copies. Timing only: with zero windows the contract
//   reduces to coa = valid, so tmax = max_n valid, targ = the first node
//   attaining it and tsum = the number of valid nodes.

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

// Queue one contiguous copy of slot_floats floats (a multiple of 4, both
// ends 16-byte aligned) from `src` into `slot`, 16 bytes a thread.
__device__ __forceinline__ void qm_stage_packed(float* slot,
                                                const float* __restrict__ src,
                                                int slot_floats) {
  for (int c = 4 * threadIdx.x; c < slot_floats; c += 4 * QM_THREADS) {
    qm_cp_async16(slot + c, src + c);
  }
}

template <int NS, bool STATIC_SLOTS, bool PACKED>
__global__ void __launch_bounds__(QM_THREADS)
qm_pipelined_kernel(const float* __restrict__ L, int t_len,
                    const int* __restrict__ base,
                    const int* __restrict__ span_off,
                    const int* __restrict__ fine,
                    const float* __restrict__ valid,
                    const float* __restrict__ inv_available,
                    const float* __restrict__ zeros,
                    float* __restrict__ tmax, int* __restrict__ targ,
                    float* __restrict__ tsum, int n_onsets, int n_tiles,
                    int tile, int fsmp, int nsamples, int n_sblocks) {
  static_assert(!STATIC_SLOTS || NS == 2, "the static unroll is two slots");
  static_assert(!PACKED || STATIC_SLOTS, "the packed probe is static2's");
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

  // Queue the copies of this block's k-th step into `slot`.
  auto stage = [&](int k, float* slot) {
    const long long step = first + k * stride;
    const int i = (int)(step / n_sblocks);
    const int j = (int)(step % n_sblocks);
    if (PACKED) {
      qm_stage_packed(slot, zeros + (long long)j * slot_floats, slot_floats);
    } else {
      qm_stage_step(slot, off, L, t_len, base + (long long)i * n_onsets,
                    n_onsets, fsmp, j * QM_SBLK);
    }
  };

  // Step k: queue step k + NS - 1 into `ahead`, wait for step k's copies
  // into `slot`, gather and reduce it.
  auto run_step = [&](int k, const float* slot, float* ahead) {
    if (k + NS - 1 < my_steps) stage(k + NS - 1, ahead);
    qm_cp_async_commit();
    qm_cp_async_wait<NS - 1>();  // this thread's copies of step k landed
    __syncthreads();             // ... and every thread's

    const long long step = first + k * stride;
    const int i = (int)(step / n_sblocks);
    const int s0 = (int)(step % n_sblocks) * QM_SBLK;
    qm_reduce_tile<QM_FULL>(slot, QmTable{off},
                            fine + (long long)i * n_onsets * tile,
                            valid + (long long)i * tile, inv, n_onsets, tile,
                            red, tmax, targ, tsum, (long long)i * nsamples,
                            s0, nsamples);
    __syncthreads();  // the slot is refilled at the next step
  };

  // Prologue: steps 0 .. NS-2 of this block, one commit group each
  // (empty groups too, so that group k always holds step k).
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < my_steps) stage(k, ring + k * slot_floats);
    qm_cp_async_commit();
  }

  if constexpr (STATIC_SLOTS) {
    float* const slot0 = ring;
    float* const slot1 = ring + slot_floats;
    for (int k = 0; k < my_steps; k += 2) {
      run_step(k, slot0, slot1);
      if (k + 1 < my_steps) run_step(k + 1, slot1, slot0);
    }
  } else {
    for (int k = 0; k < my_steps; ++k) {
      run_step(k, ring + (k % NS) * slot_floats,
               ring + ((k + NS - 1) % NS) * slot_floats);
    }
  }
  qm_cp_async_wait<0>();
}

static int qm_pipelined_smem(int n_onsets, int slot_floats, int n_stages) {
  const int off_floats = (n_onsets + 4) & ~3;
  return (off_floats + QM_RED_FLOATS + n_stages * slot_floats) *
         (int)sizeof(float);
}

template <int NS, bool STATIC_SLOTS, bool PACKED>
static int qm_launch_pipelined(const void* L, int t_len, const void* base,
                               const void* span_off, const void* fine,
                               const void* valid, const void* inv_available,
                               const void* zeros, void* tmax, void* targ,
                               void* tsum, int n_onsets, int n_tiles, int tile,
                               int fsmp, int nsamples, int slot_floats,
                               int blocks_per_sm, void* stream) {
  const auto kernel = qm_pipelined_kernel<NS, STATIC_SLOTS, PACKED>;
  const int smem = qm_pipelined_smem(n_onsets, slot_floats, NS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      QM_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (blocks_per_sm > 0 && blocks_per_sm < per_sm) per_sm = blocks_per_sm;
  const int n_sblocks = (nsamples + QM_SBLK - 1) / QM_SBLK;
  const long long n_steps = (long long)n_tiles * n_sblocks;
  long long blocks = (long long)n_sm * per_sm;
  if (blocks > n_steps) blocks = n_steps;
  kernel<<<(unsigned)blocks, QM_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(span_off), static_cast<const int*>(fine),
      static_cast<const float*>(valid),
      static_cast<const float*>(inv_available),
      static_cast<const float*>(zeros), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, n_tiles,
      tile, fsmp, nsamples, n_sblocks);
  return (int)cudaGetLastError();
}

static bool qm_pipelined_args_ok(int n_onsets, int n_tiles, int tile,
                                 int nsamples, int slot_floats) {
  return n_onsets >= 1 && n_tiles >= 1 && tile >= QM_NWARPS &&
         tile % QM_NWARPS == 0 && nsamples >= 1 && slot_floats >= QM_SBLK;
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
  if (!qm_pipelined_args_ok(n_onsets, n_tiles, tile, nsamples, slot_floats)) {
    return (int)cudaErrorInvalidValue;
  }
#define QM_STAGES_CASE(NS)                                                    \
  case NS:                                                                    \
    return qm_launch_pipelined<NS, false, false>(                             \
        L, t_len, base, span_off, fine, valid, inv_available, nullptr, tmax,  \
        targ, tsum, n_onsets, n_tiles, tile, fsmp, nsamples, slot_floats,     \
        blocks_per_sm, stream);
  switch (n_stages) {
    QM_STAGES_CASE(2)
    QM_STAGES_CASE(3)
    QM_STAGES_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QM_STAGES_CASE
}

// The staging probe at 2 stages, as many blocks per SM as fit: packed = 0
// is "static2" (zeros unused, may be null), packed = 1 is "packed",
// staging from `zeros`, a zero-filled float table of at least
// ceil(nsamples / QM_SBLK) * slot_floats floats, 16-byte aligned;
// slot_floats must then be a multiple of 4.
extern "C" int qm_migrate_detect_probe(
    const void* L, int t_len, const void* base, const void* span_off,
    const void* fine, const void* valid, const void* inv_available,
    const void* zeros, void* tmax, void* targ, void* tsum, int n_onsets,
    int n_tiles, int tile, int fsmp, int nsamples, int slot_floats,
    int packed, void* stream) {
  if (!qm_pipelined_args_ok(n_onsets, n_tiles, tile, nsamples, slot_floats)) {
    return (int)cudaErrorInvalidValue;
  }
  if (packed) {
    if (slot_floats % 4 != 0 || zeros == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    return qm_launch_pipelined<2, true, true>(
        L, t_len, base, span_off, fine, valid, inv_available, zeros, tmax,
        targ, tsum, n_onsets, n_tiles, tile, fsmp, nsamples, slot_floats, 0,
        stream);
  }
  return qm_launch_pipelined<2, true, false>(
      L, t_len, base, span_off, fine, valid, inv_available, zeros, tmax, targ,
      tsum, n_onsets, n_tiles, tile, fsmp, nsamples, slot_floats, 0, stream);
}
