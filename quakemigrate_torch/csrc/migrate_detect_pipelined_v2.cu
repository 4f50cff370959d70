// Pipelined detect kernel redesigned for Hopper (sm_90a): E1c v2, on K1
// v2's gather core (detect_v2_core.cuh) with TMA-fed window staging.
//
// Replaces the TPU experiment kernel _deep_kernel
// (experiments/exp_kernel_breakdown.py:459), which keeps an n_slots-deep
// queue of table-slice DMAs in flight, as v1 (migrate_detect_pipelined.cu)
// does. Contract: K1's (migrate_detect.cu), bit for bit (tmax, targ,
// tsum), with K1 v2's one exception (migrate_detect_v2.cu: padding nodes
// are not gathered).
//
// Bound on the card: the shared-memory pipe of the gather, as K1 v2's
// (22.27 ms of 4-byte reads at 30,000 samples on the day-scale window).
// v1 lost to K1 by staging with the gathering warps themselves (4-byte
// cp.async per element, two block barriers a step, the residuals
// re-read from global memory a step) and by holding 8-16 warps an SM.
// What this design does about it:
//
// 1. Persistent and tile-major: block b takes the consecutive (node tile,
//    128-sample block) steps [b S / B, (b + 1) S / B) of the S steps, so a
//    tile's sample blocks follow one another. The tile's slab (uint16
//    [tile, qv_row(O)], entry o * stride + a[i, o] + fine[n, o], built on
//    the host, a[i, o] = (fsmp + base[i, o]) & 3 below)
//    and its `valid` are staged once per tile by two bulk copies, not per
//    step.
// 2. Windows fed by TMA: warp 0 issues one tiled load per onset (lane o
//    takes onsets o, o + 32, ...) from a tensor map over L [O, t_len]:
//    a box of 1 x `box` floats (the largest r_spans[o] + 3 + QM_SBLK,
//    rounded up to 4) at column fsmp + base[i, o] + s0 rounded down to a
//    multiple of 4 (a tiled load's inner coordinate must be 16-byte
//    aligned, tma_rows.cuh); the slab's a[i, o] skips the 0-3 floats
//    that rounding adds. Columns past t_len arrive as 0, K1 v2's rule.
//    Loads go into an NS-deep ring with a full and an empty mbarrier a
//    slot, so step k + NS's windows land while step k gathers. Onset
//    o's window sits at o * stride in its slot, `stride` a multiple of 32
//    floats: a tiled load's destination must be 128-byte aligned, and
//    one map has one box width.
// 3. Synchronisation: every thread waits on its slot's full barrier and
//    arrives on the empty barrier when done with the slot; the only block
//    barriers left are the cross-warp reduction's two. The reduction's
//    12 KB scratch aliases the slot just gathered (its first barrier ends
//    every read of the windows), and warp 0 refills the slot only after
//    every thread's arrival, so no region of its own is needed.
// 4. Occupancy: shared memory a block = NS slots of max(O * stride,
//    QM_RED_FLOATS) floats + the slab + valid + 2 NS + 1 mbarriers. At
//    24 onsets, stride 192, tile 256 and NS = 2 that is 50,344 bytes, so
//    4 blocks (32 warps) fit an SM, against v1's 1-2 blocks; NS = 3
//    fits 3.
//
// The kernel is a template on the reduction variant, as K1 v2 is:
// QM_FULL, QM_NOREDUCE (tmax = acc of node 0, tsum = acc of node 1, 0
// at padding nodes) and QM_NOGATHER (the staged windows at residual 0).

#include "detect_v2_core.cuh"
#include "tma_rows.cuh"

// Resident blocks per SM the kernel is built for.
#define QP_MIN_BLOCKS 4

// Onset o's window at residual 0 (QM_NOGATHER): its slot offset plus the
// 0-3 floats by which the window's first column lies past the multiple
// of 4 that the load started from.
struct QpOffsets {
  int stride;
  int lead;  // fsmp
  const int* base_i;
  __device__ __forceinline__ int operator()(int o) const {
    return o * stride + ((lead + base_i[o]) & 3);
  }
};

// Bytes of one ring slot: the windows, or the reduction scratch that
// aliases them, whichever is larger.
__host__ __device__ __forceinline__ int qp_slot_bytes(int n_onsets,
                                                    int stride) {
  const int win = 4 * n_onsets * stride;
  return win > 4 * QM_RED_FLOATS ? win : 4 * QM_RED_FLOATS;
}

// Dynamic shared memory of a block: 128 bytes of alignment slack, the
// ring, the slab, valid and the mbarriers.
static int qp_smem_bytes(int n_onsets, int tile, int stride, int n_stages) {
  return 128 + n_stages * qp_slot_bytes(n_onsets, stride) +
         2 * tile * qv_row(n_onsets) + 4 * tile + 8 * (2 * n_stages + 1);
}

template <int V, int NS>
__global__ void __launch_bounds__(QM_THREADS, QP_MIN_BLOCKS)
qm_pipelined_v2_kernel(const __grid_constant__ CUtensorMap map,
                       const int* __restrict__ base,
                       const unsigned short* __restrict__ slab_g,
                       const float* __restrict__ valid,
                       const float* __restrict__ inv_available,
                       float* __restrict__ tmax, int* __restrict__ targ,
                       float* __restrict__ tsum, int n_onsets, int tile,
                       int fsmp, int nsamples, int n_sblocks,
                       long long n_steps, int stride, int box) {
  static_assert(V == QM_FULL || V == QM_NOREDUCE || V == QM_NOGATHER,
                "built for FULL, NOREDUCE and NOGATHER");
  extern __shared__ unsigned char qp_raw[];
  unsigned char* smem = qp_raw + ((128 - (wg_smem(qp_raw) & 127)) & 127);
  const int row = qv_row(n_onsets);
  const int slot_floats = qp_slot_bytes(n_onsets, stride) / 4;
  float* ring = reinterpret_cast<float*>(smem);
  unsigned short* slab =
      reinterpret_cast<unsigned short*>(ring + NS * slot_floats);
  float* vld = reinterpret_cast<float*>(slab + tile * row);
  uint64_t* full = reinterpret_cast<uint64_t*>(vld + tile);
  uint64_t* empty = full + NS;
  uint64_t* slab_bar = empty + NS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long first = blockIdx.x * n_steps / gridDim.x;
  const int my_steps =
      (int)((blockIdx.x + 1) * n_steps / gridDim.x - first);
  const uint32_t slab_bytes = 2 * tile * row;
  const uint32_t vld_bytes = 4 * tile;
  const uint32_t win_bytes = 4 * n_onsets * box;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      wg_bar_init(&full[s], 1);
      wg_bar_init(&empty[s], QM_THREADS);
    }
    wg_bar_init(slab_bar, 1);
    wg_bar_init_fence();
    wg_prefetch_map(&map);
  }
  __syncthreads();

  // Lane 0 of warp 0: tile i's slab and valid.
  auto stage_tile = [&](int i) {
    wg_bar_expect_tx(slab_bar, slab_bytes + vld_bytes);
    qt_bulk_load(slab, slab_g + (long long)i * tile * row, slab_bytes,
                 slab_bar);
    qt_bulk_load(vld, valid + (long long)i * tile, vld_bytes, slab_bar);
  };
  // Every lane of warp 0, after lane 0 armed full[s]: the windows of
  // `step` into slot s, one box per onset. The lambda holds the map's
  // parameter-space address, not a reference to the parameter: a
  // reference would let the compiler copy the map to local memory, from
  // which TMA cannot load.
  const CUtensorMap* tmap = &map;
  auto stage_step = [&](long long step, int s) {
    const int i = (int)(step / n_sblocks);
    const int col = fsmp + (int)(step - (long long)i * n_sblocks) * QM_SBLK;
    const int* base_i = base + (long long)i * n_onsets;
    float* slot = ring + s * slot_floats;
    for (int o = lane; o < n_onsets; o += 32) {
      wg_tma_load_2d(slot + o * stride, tmap, &full[s],
                     (col + base_i[o]) & ~3, o);
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      if (my_steps > 0) stage_tile((int)(first / n_sblocks));
      for (int k = 0; k < NS && k < my_steps; ++k) {
        wg_bar_expect_tx(&full[k], win_bytes);
      }
    }
    __syncwarp();
    for (int k = 0; k < NS && k < my_steps; ++k) stage_step(first + k, k);
  }

  const float inv = *inv_available;
  uint32_t slab_uses = 0;
  for (int k = 0; k < my_steps; ++k) {
    const long long step = first + k;
    const int i = (int)(step / n_sblocks);
    const int s0 = (int)(step - (long long)i * n_sblocks) * QM_SBLK;
    const int s = k % NS;
    const uint32_t phase = (uint32_t)(k / NS) & 1u;
    if (k == 0 || s0 == 0) {
      wg_bar_wait(slab_bar, slab_uses & 1u);
      ++slab_uses;
    }
    wg_bar_wait(&full[s], phase);
    float* win = ring + s * slot_floats;
    const long long out_row = (long long)i * nsamples;
    if constexpr (V == QM_NOGATHER) {
      const QpOffsets offsets{stride, fsmp, base + (long long)i * n_onsets};
      qm_staged_sum(win, offsets, n_onsets, tmax, targ, tsum, out_row, s0,
                    nsamples);
    } else {
      QvPartial p;
      qv_sweep_tile<V>(p, win, slab, vld, n_onsets, tile, inv);
      // The scratch aliases the slot: its first barrier ends every
      // read of the windows, the slab and valid.
      qv_reduce_warps<V>(p, win, tmax, targ, tsum, out_row, s0, nsamples);
    }
    // This thread is done with the slot (the scratch's stores included):
    // order its accesses before the TMA refill, then release the slot.
    wg_fence_proxy_async();
    wg_bar_arrive(&empty[s]);

    if (warp == 0) {
      if (lane == 0 && k + 1 < my_steps && (step + 1) % n_sblocks == 0) {
        stage_tile(i + 1);  // the next step starts a tile
      }
      if (k + NS < my_steps) {
        if (lane == 0) {
          wg_bar_wait(&empty[s], phase);
          wg_bar_expect_tx(&full[s], win_bytes);
        }
        __syncwarp();
        stage_step(step + NS, s);
      }
    }
  }
}

template <int V, int NS>
static int qp_launch(const CUtensorMap& map, const void* base,
                     const void* slab, const void* valid,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int tile,
                     int fsmp, int nsamples, int stride, int box,
                     cudaStream_t stream) {
  const auto kernel = qm_pipelined_v2_kernel<V, NS>;
  const int smem = qp_smem_bytes(n_onsets, tile, stride, NS);
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
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, n_sblocks, n_steps, stride, box);
  return (int)cudaGetLastError();
}

static bool qp_args_ok(int n_onsets, int n_tiles, int tile, int nsamples,
                       int stride, int box) {
  return n_onsets >= 1 && n_tiles >= 1 && tile >= 2 * QM_NWARPS &&
         tile % (2 * QM_NWARPS) == 0 && nsamples >= 1 &&
         stride % QT_ALIGN_FLOATS == 0 && box >= QM_SBLK + 1 &&
         box <= stride && box <= 256 && box % 4 == 0 &&
         n_onsets * stride <= 65535 && 4 * n_onsets * box <= QT_MAX_TX_BYTES;
}

// L: float32 [n_onsets, ld] (row pitch ld >= t_len, a multiple of 4,
// 16-byte aligned); base int32 [n_tiles, n_onsets]; slab uint16
// [n_tiles, tile, round_up(n_onsets, 8)], entry o * stride + ((fsmp +
// base[i, o]) & 3) + fine, each at most o * stride + box - QM_SBLK;
// valid float32 [n_tiles, tile]. n_stages 2, 3 or
// 4; variant QM_FULL, QM_NOREDUCE or QM_NOGATHER (a QmVariant).
extern "C" int qm_migrate_detect_pipelined_v2(
    const void* L, int t_len, int ld, const void* base, const void* slab,
    const void* valid, const void* inv_available, void* tmax, void* targ,
    void* tsum, int n_onsets, int n_tiles, int tile, int fsmp, int nsamples,
    int stride, int box, int n_stages, int variant, void* stream) {
  if (!qp_args_ok(n_onsets, n_tiles, tile, nsamples, stride, box)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const int err = qt_row_map(&map, L, n_onsets, t_len, ld, box);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QP_CASE(V, NS)                                                        \
  if (variant == V && n_stages == NS) {                                       \
    return qp_launch<V, NS>(map, base, slab, valid, inv_available, tmax,      \
                            targ, tsum, n_onsets, n_tiles, tile, fsmp,        \
                            nsamples, stride, box, s);                        \
  }
  QP_CASE(QM_FULL, 2)
  QP_CASE(QM_FULL, 3)
  QP_CASE(QM_FULL, 4)
  QP_CASE(QM_NOREDUCE, 2)
  QP_CASE(QM_NOGATHER, 2)
#undef QP_CASE
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the FULL kernel at n_stages (2, 3 or 4) and
// this geometry, from the occupancy API; a negative value is minus a CUDA
// error code.
extern "C" int qm_migrate_detect_pipelined_v2_blocks_per_sm(int n_onsets,
                                                            int tile,
                                                            int stride,
                                                            int n_stages) {
  const int smem = qp_smem_bytes(n_onsets, tile, stride, n_stages);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define QP_OCC(NS)                                                            \
  if (n_stages == NS) {                                                       \
    err = cudaFuncSetAttribute(qm_pipelined_v2_kernel<QM_FULL, NS>,           \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               smem);                                         \
    if (err == cudaSuccess) {                                                 \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
          &blocks, qm_pipelined_v2_kernel<QM_FULL, NS>, QM_THREADS, smem);    \
    }                                                                         \
  }
  QP_OCC(2)
  QP_OCC(3)
  QP_OCC(4)
#undef QP_OCC
  return err == cudaSuccess ? blocks : -(int)err;
}
