// The staging probes redesigned for Hopper (sm_90a): E4b v2, the two
// modes of the TPU probe on E1c v2's TMA ring (migrate_detect_pipelined_v2.cu).
//
// Replaces the TPU experiment kernel _probe_kernel
// (experiments/exp_dma_probe.py:117), which asks two questions of a
// double-buffered pipeline, as v1 (migrate_detect_pipelined.cu, flags
// STATIC_SLOTS and PACKED) does. v1 asked them of E1c v1, whose own
// staging was the problem (4-byte cp.async by the gathering warps, two
// block barriers a step, 1-2 blocks an SM); E1c v2 replaced that
// pipeline, so the probe asks them here of E1c v2's schedule: persistent
// and tile-major, K1 v2's gather core (detect_v2_core.cuh) through E1c
// v2's slab (entry o * stride + ((fsmp + base[i, o]) & 3) + fine),
// the tile's slab and valid by bulk copy once a tile, a 2-slot ring with
// a full and an empty mbarrier a slot, refilled by warp 0.
//
// - "static2" (PACKED false): the step loop unrolled so that every step
//   has a constant slot pointer, constant full and empty barrier
//   addresses and a constant phase parity, where E1c v2 computes k % NS
//   and (k / NS) & 1 each step (the TPU probe's two pl.when branches
//   with constant slots, exp_dma_probe.py:185-187). With two slots the
//   parity of a slot flips every other step, so a loop trip runs four
//   steps: slot 0 and 1 at parity 0, then at parity 1. Each onset's
//   window arrives as one TMA box, as in E1c v2. Contract: K1's
//   (migrate_detect.cu), bit for bit, with K1 v2's one exception
//   (padding nodes are not gathered).
// - "packed" (PACKED true): the same loop, each step staging its slot
//   with ONE bulk copy of O x stride floats from a zero table (at
//   sample block j x O x stride), in place of O tensor-map boxes (the
//   TPU's single descriptor in place of 48, exp_dma_probe.py:133-141).
//   Timing only: with every window zero, coa = exp(0) * valid, so tmax is
//   the largest valid, targ the first node attaining it and tsum the sum
//   of valid, at every sample.
//
// Bound on the card: the shared-memory pipe of the gather, as E1c v2's.
// Shared memory a block, as E1c v2's at 2 stages: 128 bytes of slack, 2
// slots of max(O x stride, QM_RED_FLOATS) floats, the slab, valid and 5
// mbarriers: 63,656 bytes at 24 onsets, stride 192 and tile 512, so 3
// blocks (24 warps) an SM, as E1c v2 at that plan.

#include "detect_v2_core.cuh"
#include "tma_rows.cuh"

// Resident blocks per SM the kernel is built for: E1c v2's
// (QP_MIN_BLOCKS), so that the two compare at one register budget; at
// tile 512 shared memory holds either to 3.
#define QB_MIN_BLOCKS 4

// Bytes of one ring slot: the windows, or the reduction scratch that
// aliases them, whichever is larger.
__host__ __device__ __forceinline__ int qb_slot_bytes(int n_onsets,
                                                    int stride) {
  const int win = 4 * n_onsets * stride;
  return win > 4 * QM_RED_FLOATS ? win : 4 * QM_RED_FLOATS;
}

static int qb_smem_bytes(int n_onsets, int tile, int stride) {
  return 128 + 2 * qb_slot_bytes(n_onsets, stride) +
         2 * tile * qv_row(n_onsets) + 4 * tile + 8 * 5;
}

template <bool PACKED>
__global__ void __launch_bounds__(QM_THREADS, QB_MIN_BLOCKS)
qm_probe_v2_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ base,
                   const unsigned short* __restrict__ slab_g,
                   const float* __restrict__ valid,
                   const float* __restrict__ inv_available,
                   const float* __restrict__ zeros,
                   float* __restrict__ tmax, int* __restrict__ targ,
                   float* __restrict__ tsum, int n_onsets, int tile,
                   int fsmp, int nsamples, int n_sblocks, long long n_steps,
                   int stride, int box) {
  extern __shared__ unsigned char qb_raw[];
  unsigned char* smem = qb_raw + ((128 - (wg_smem(qb_raw) & 127)) & 127);
  const int row = qv_row(n_onsets);
  const int slot_floats = qb_slot_bytes(n_onsets, stride) / 4;
  float* const slot0 = reinterpret_cast<float*>(smem);
  float* const slot1 = slot0 + slot_floats;
  unsigned short* slab =
      reinterpret_cast<unsigned short*>(slot1 + slot_floats);
  float* vld = reinterpret_cast<float*>(slab + tile * row);
  uint64_t* full = reinterpret_cast<uint64_t*>(vld + tile);  // two
  uint64_t* empty = full + 2;                                 // two
  uint64_t* slab_bar = empty + 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long first = blockIdx.x * n_steps / gridDim.x;
  const int my_steps =
      (int)((blockIdx.x + 1) * n_steps / gridDim.x - first);
  const uint32_t slab_bytes = 2 * tile * row;
  const uint32_t vld_bytes = 4 * tile;
  const uint32_t win_bytes =
      PACKED ? 4 * n_onsets * stride : 4 * n_onsets * box;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      wg_bar_init(&full[s], 1);
      wg_bar_init(&empty[s], QM_THREADS);
    }
    wg_bar_init(slab_bar, 1);
    wg_bar_init_fence();
    if (!PACKED) wg_prefetch_map(&map);
  }
  __syncthreads();

  // Lane 0 of warp 0: tile i's slab and valid.
  auto stage_tile = [&](int i) {
    wg_bar_expect_tx(slab_bar, slab_bytes + vld_bytes);
    qt_bulk_load(slab, slab_g + (long long)i * tile * row, slab_bytes,
                 slab_bar);
    qt_bulk_load(vld, valid + (long long)i * tile, vld_bytes, slab_bar);
  };
  // Every lane of warp 0, after lane 0 armed `bar`: the windows of `step`
  // into `slot`, one box per onset, or (PACKED) lane 0's one bulk copy of
  // the slot from the zero table. The map's parameter-space address, not
  // a reference to the parameter (E1c v2: a reference lets the compiler
  // copy the map to local memory, from which TMA cannot load).
  const CUtensorMap* tmap = &map;
  auto stage_step = [&](long long step, float* slot, uint64_t* bar) {
    const int i = (int)(step / n_sblocks);
    const int j = (int)(step - (long long)i * n_sblocks);
    if (PACKED) {
      if (lane == 0) {
        qt_bulk_load(slot, zeros + (long long)j * n_onsets * stride,
                     win_bytes, bar);
      }
    } else {
      const int col = fsmp + j * QM_SBLK;
      const int* base_i = base + (long long)i * n_onsets;
      for (int o = lane; o < n_onsets; o += 32) {
        wg_tma_load_2d(slot + o * stride, tmap, bar, (col + base_i[o]) & ~3,
                       o);
      }
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      if (my_steps > 0) stage_tile((int)(first / n_sblocks));
      if (my_steps > 0) wg_bar_expect_tx(&full[0], win_bytes);
      if (my_steps > 1) wg_bar_expect_tx(&full[1], win_bytes);
    }
    __syncwarp();
    if (my_steps > 0) stage_step(first, slot0, &full[0]);
    if (my_steps > 1) stage_step(first + 1, slot1, &full[1]);
  }

  const float inv = *inv_available;
  uint32_t slab_uses = 0;
  // Step k of this block from `win`, whose barriers are `full_s` and
  // `empty_s` at parity `phase`; then warp 0 refills the slot with step
  // k + 2. Every argument but k is a constant at each call site below.
  auto run_step = [&](int k, float* win, uint64_t* full_s, uint64_t* empty_s,
                      uint32_t phase) {
    const long long step = first + k;
    const int i = (int)(step / n_sblocks);
    const int s0 = (int)(step - (long long)i * n_sblocks) * QM_SBLK;
    if (k == 0 || s0 == 0) {
      wg_bar_wait(slab_bar, slab_uses & 1u);
      ++slab_uses;
    }
    wg_bar_wait(full_s, phase);
    QvPartial p;
    qv_sweep_tile<QM_FULL>(p, win, slab, vld, n_onsets, tile, inv);
    // The scratch aliases the slot: its first barrier ends every read of
    // the windows, the slab and valid.
    qv_reduce_warps<QM_FULL>(p, win, tmax, targ, tsum,
                             (long long)i * nsamples, s0, nsamples);
    wg_fence_proxy_async();
    wg_bar_arrive(empty_s);

    if (warp == 0) {
      if (lane == 0 && k + 1 < my_steps && (step + 1) % n_sblocks == 0) {
        stage_tile(i + 1);  // the next step starts a tile
      }
      if (k + 2 < my_steps) {
        if (lane == 0) {
          wg_bar_wait(empty_s, phase);
          wg_bar_expect_tx(full_s, win_bytes);
        }
        __syncwarp();
        stage_step(step + 2, win, full_s);
      }
    }
  };

  for (int k = 0; k < my_steps; k += 4) {
    run_step(k, slot0, &full[0], &empty[0], 0);
    if (k + 1 < my_steps) run_step(k + 1, slot1, &full[1], &empty[1], 0);
    if (k + 2 < my_steps) run_step(k + 2, slot0, &full[0], &empty[0], 1);
    if (k + 3 < my_steps) run_step(k + 3, slot1, &full[1], &empty[1], 1);
  }
}

template <bool PACKED>
static int qb_launch(const CUtensorMap& map, const void* base,
                     const void* slab, const void* valid,
                     const void* inv_available, const void* zeros,
                     void* tmax, void* targ, void* tsum, int n_onsets,
                     int n_tiles, int tile, int fsmp, int nsamples,
                     int stride, int box, cudaStream_t stream) {
  const auto kernel = qm_probe_v2_kernel<PACKED>;
  const int smem = qb_smem_bytes(n_onsets, tile, stride);
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
  const int n_sblocks = (nsamples + QM_SBLK - 1) / QM_SBLK;
  const long long n_steps = (long long)n_tiles * n_sblocks;
  long long blocks = (long long)n_sm * per_sm;
  if (blocks > n_steps) blocks = n_steps;
  kernel<<<(unsigned)blocks, QM_THREADS, smem, stream>>>(
      map, static_cast<const int*>(base),
      static_cast<const unsigned short*>(slab),
      static_cast<const float*>(valid),
      static_cast<const float*>(inv_available),
      static_cast<const float*>(zeros), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, n_sblocks, n_steps, stride, box);
  return (int)cudaGetLastError();
}

// E1c v2's arguments (qm_migrate_detect_pipelined_v2) at 2 stages: L
// float32 [n_onsets, ld] (row pitch ld >= t_len, a multiple of 4, 16-byte
// aligned); base int32 [n_tiles, n_onsets]; slab uint16 [n_tiles, tile,
// round_up(n_onsets, 8)], entry o * stride + ((fsmp + base[i, o]) & 3) +
// fine, each at most o * stride + box - QM_SBLK; valid float32 [n_tiles,
// tile]. packed = 0 is "static2" (zeros unused, may be null); packed = 1
// is "packed", staging from `zeros`, a zero-filled float table of at
// least ceil(nsamples / QM_SBLK) * n_onsets * stride floats, 16-byte
// aligned.
extern "C" int qm_migrate_detect_probe_v2(
    const void* L, int t_len, int ld, const void* base, const void* slab,
    const void* valid, const void* inv_available, const void* zeros,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles, int tile,
    int fsmp, int nsamples, int stride, int box, int packed, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 2 * QM_NWARPS ||
      tile % (2 * QM_NWARPS) != 0 || nsamples < 1 ||
      stride % QT_ALIGN_FLOATS != 0 || box < QM_SBLK + 1 || box > stride ||
      box > 256 || box % 4 != 0 || n_onsets * stride > 65535 ||
      4 * n_onsets * stride > QT_MAX_TX_BYTES ||
      (packed && (zeros == nullptr ||
                  reinterpret_cast<uintptr_t>(zeros) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const int err = qt_row_map(&map, L, n_onsets, t_len, ld, box);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    return qb_launch<true>(map, base, slab, valid, inv_available, zeros, tmax,
                           targ, tsum, n_onsets, n_tiles, tile, fsmp,
                           nsamples, stride, box, s);
  }
  return qb_launch<false>(map, base, slab, valid, inv_available, zeros, tmax,
                          targ, tsum, n_onsets, n_tiles, tile, fsmp, nsamples,
                          stride, box, s);
}

// Resident blocks per SM of the static2 kernel at this geometry, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_probe_v2_blocks_per_sm(int n_onsets,
                                                        int tile,
                                                        int stride) {
  const int smem = qb_smem_bytes(n_onsets, tile, stride);
  cudaError_t err = cudaFuncSetAttribute(
      qm_probe_v2_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qm_probe_v2_kernel<false>, QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
