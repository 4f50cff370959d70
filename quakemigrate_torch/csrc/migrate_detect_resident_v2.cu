// Resident-staging detect kernel redesigned for Hopper (sm_90a): E1b v2,
// on K1 v2's gather core (detect_v2_core.cuh) with TMA-fed staging.
//
// Replaces the TPU experiment kernel _resident_kernel
// (experiments/exp_kernel_breakdown.py:261), which parks a whole column
// block of the table in VMEM once per sweep and lets the node tiles slice
// it, as v1 (migrate_detect_resident.cu) does. Contract: K1's
// (migrate_detect.cu), bit for bit (tmax, targ, tsum), with K1 v2's one
// exception (migrate_detect_v2.cu: padding nodes are not gathered).
//
// Bound on the card: the shared-memory pipe of the gather, as K1 v2's.
// v1 read one more shared word per node and onset (the window offset),
// gave every onset's union window the one width of the widest, and
// staged everything before it swept. What this design does about it:
//
// 1. Grid (group of `group` consecutive node tiles, 128-sample block),
//    the TPU's sample-block-outer sweep. Each onset's union window,
//    L[o, c + s0 :] with c = fsmp + gbase[g, o] rounded down to a multiple
//    of 4 (a tiled load's inner coordinate must be 16-byte aligned,
//    tma_rows.cuh), is staged once a block at uoff[o] in shared memory,
//    with its own width uoff[o + 1] - uoff[o]: the largest base spread of
//    onset o over the groups + 3 + r_spans[o] + QM_SBLK, rounded up to 32
//    floats. Warp 0 issues it as tiled TMA
//    boxes of 1 x 32 floats (lane o takes onsets o, o + 32, ...), each
//    landing 128-byte aligned; columns past t_len arrive as 0.
// 2. The residuals as K1 v2 reads them: a host slab [n_tiles, tile,
//    qv_row(O)] whose entry is woff[i, o] + fine[n, o], woff[i, o] =
//    uoff[o] + fsmp + base[i, o] - c: the offset of the read inside the
//    union, so the node
//    loop reads the slab and the windows and nothing else.
// 3. Overlap: each tile's slab and valid arrive by bulk copy into a double
//    buffer, tile i + 1's while tile i gathers; tile i + 2's is issued
//    once tile i's reduction is done, whose scratch aliases tile i's
//    slab buffer.
// 4. Shared memory a block: uoff[O] floats of windows + 2 x (the larger
//    of the slab and the reduction scratch, + valid) + 3 mbarriers. The
//    host picks `group` so that at least 4 blocks fit an SM.
//
// QM_NOGATHER reads tile i's windows at residual 0 through the host
// table woff [n_tiles, O]; the other variants do not read it. The kernel
// is a template on the variant, as K1 v2 is: QM_FULL, QM_NOREDUCE and
// QM_NOGATHER.

#include "detect_v2_core.cuh"
#include "tma_rows.cuh"

// Resident blocks per SM the kernel is built for.
#define QR_MIN_BLOCKS 4

// Width, in floats, of one TMA box of a union window.
#define QR_BOX 32

// Bytes of one slab buffer: the slab, or the reduction scratch that
// aliases it, whichever is larger.
__host__ __device__ __forceinline__ int qr_buf_bytes(int n_onsets,
                                                   int tile) {
  const int slab = 2 * tile * qv_row(n_onsets);
  return slab > 4 * QM_RED_FLOATS ? slab : 4 * QM_RED_FLOATS;
}

// Dynamic shared memory of a block: 128 bytes of alignment slack, the
// union windows, two slab buffers, two valid buffers and 3 mbarriers.
static int qr_smem_bytes(int n_onsets, int tile, int win_floats) {
  return 128 + 4 * win_floats + 2 * qr_buf_bytes(n_onsets, tile) +
         8 * tile + 3 * 8;
}

template <int V>
__global__ void __launch_bounds__(QM_THREADS, QR_MIN_BLOCKS)
qm_resident_v2_kernel(const __grid_constant__ CUtensorMap map,
                      const int* __restrict__ gbase,
                      const int* __restrict__ uoff,
                      const unsigned short* __restrict__ slab_g,
                      const float* __restrict__ valid,
                      const int* __restrict__ woff,
                      const float* __restrict__ inv_available,
                      float* __restrict__ tmax, int* __restrict__ targ,
                      float* __restrict__ tsum, int n_onsets, int n_tiles,
                      int tile, int group, int fsmp, int nsamples,
                      int win_floats) {
  static_assert(V == QM_FULL || V == QM_NOREDUCE || V == QM_NOGATHER,
                "built for FULL, NOREDUCE and NOGATHER");
  extern __shared__ unsigned char qr_raw[];
  unsigned char* smem = qr_raw + ((128 - (wg_smem(qr_raw) & 127)) & 127);
  const int row = qv_row(n_onsets);
  const int buf_bytes = qr_buf_bytes(n_onsets, tile);
  float* win = reinterpret_cast<float*>(smem);
  unsigned char* bufs = smem + 4 * win_floats;
  float* vlds = reinterpret_cast<float*>(bufs + 2 * buf_bytes);
  uint64_t* win_bar = reinterpret_cast<uint64_t*>(vlds + 2 * tile);
  uint64_t* slab_bar = win_bar + 1;  // two

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int i0 = g * group;
  const int count = min(group, n_tiles - i0);
  const uint32_t slab_bytes = 2 * tile * row;
  const uint32_t vld_bytes = 4 * tile;

  if (tid == 0) {
    wg_bar_init(win_bar, 1);
    wg_bar_init(&slab_bar[0], 1);
    wg_bar_init(&slab_bar[1], 1);
    wg_bar_init_fence();
    wg_prefetch_map(&map);
  }
  __syncthreads();

  // Tile i0 + t's slab and valid into buffer b (one thread).
  auto stage_tile = [&](int t, int b) {
    const long long i = i0 + t;
    wg_bar_expect_tx(&slab_bar[b], slab_bytes + vld_bytes);
    qt_bulk_load(bufs + b * buf_bytes, slab_g + i * tile * row, slab_bytes,
                 &slab_bar[b]);
    qt_bulk_load(vlds + b * tile, valid + i * tile, vld_bytes, &slab_bar[b]);
  };

  if (warp == 0) {
    if (lane == 0) {
      wg_bar_expect_tx(win_bar, 4 * win_floats);
      stage_tile(0, 0);
      if (count > 1) stage_tile(1, 1);
    }
    __syncwarp();
    const int* gbase_g = gbase + (long long)g * n_onsets;
    for (int o = lane; o < n_onsets; o += 32) {
      const int col = ((fsmp + gbase_g[o]) & ~3) + s0;
      const int w0 = uoff[o];
      const int w1 = uoff[o + 1];
      for (int f = w0; f < w1; f += QR_BOX) {
        wg_tma_load_2d(win + f, &map, win_bar, col + (f - w0), o);
      }
    }
  }

  const float inv = *inv_available;
  wg_bar_wait(win_bar, 0);
  for (int t = 0; t < count; ++t) {
    const int b = t & 1;
    const int i = i0 + t;
    wg_bar_wait(&slab_bar[b], (uint32_t)(t >> 1) & 1u);
    const long long out_row = (long long)i * nsamples;
    unsigned char* buf = bufs + b * buf_bytes;
    if constexpr (V == QM_NOGATHER) {
      qm_staged_sum(win, QmTable{woff + (long long)i * n_onsets}, n_onsets,
                    tmax, targ, tsum, out_row, s0, nsamples);
    } else {
      QvPartial p;
      qv_sweep_tile<V>(p, win, reinterpret_cast<unsigned short*>(buf),
                       vlds + b * tile, n_onsets, tile, inv);
      // The scratch aliases the slab: its first barrier ends every read
      // of it.
      qv_reduce_warps<V>(p, reinterpret_cast<float*>(buf), tmax, targ, tsum,
                         out_row, s0, nsamples);
    }
    if (t + 2 < count) {
      // Every thread's reads and stores of buffer b are done (and ordered
      // before the async proxy's refill) at the barrier.
      wg_fence_proxy_async();
      __syncthreads();
      if (tid == 0) stage_tile(t + 2, b);
    }
  }
}

template <int V>
static int qr_launch(const CUtensorMap& map, const void* gbase,
                     const void* uoff, const void* slab, const void* valid,
                     const void* woff, const void* inv_available, void* tmax,
                     void* targ, void* tsum, int n_onsets, int n_tiles,
                     int tile, int group, int fsmp, int nsamples,
                     int win_floats, cudaStream_t stream) {
  const auto kernel = qm_resident_v2_kernel<V>;
  const int smem = qr_smem_bytes(n_onsets, tile, win_floats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tiles + group - 1) / group,
                  (nsamples + QM_SBLK - 1) / QM_SBLK);
  kernel<<<grid, QM_THREADS, smem, stream>>>(
      map, static_cast<const int*>(gbase), static_cast<const int*>(uoff),
      static_cast<const unsigned short*>(slab),
      static_cast<const float*>(valid), static_cast<const int*>(woff),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, n_tiles,
      tile, group, fsmp, nsamples, win_floats);
  return (int)cudaGetLastError();
}

// L: float32 [n_onsets, ld] (row pitch ld >= t_len, a multiple of 4,
// 16-byte aligned); gbase int32 [ceil(n_tiles / group), n_onsets]; uoff
// int32 [n_onsets + 1], uoff[0] = 0, each a multiple of 32, uoff[n_onsets]
// = win_floats; woff int32 [n_tiles, n_onsets] = uoff[o] + fsmp + base[i,
// o] - ((fsmp + gbase[g, o]) & ~3); slab uint16 [n_tiles, tile,
// round_up(n_onsets, 8)], entry woff[i, o] + fine with entry + QM_SBLK <=
// uoff[o + 1]; valid float32 [n_tiles, tile]. variant QM_FULL,
// QM_NOREDUCE or QM_NOGATHER (a QmVariant).
extern "C" int qm_migrate_detect_resident_v2(
    const void* L, int t_len, int ld, const void* gbase, const void* uoff,
    const void* slab, const void* valid, const void* woff,
    const void* inv_available, void* tmax, void* targ, void* tsum,
    int n_onsets, int n_tiles, int tile, int group, int fsmp, int nsamples,
    int win_floats, int variant, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 2 * QM_NWARPS ||
      tile % (2 * QM_NWARPS) != 0 || nsamples < 1 || group < 1 ||
      win_floats < n_onsets * (QM_SBLK + 1) ||
      win_floats % QT_ALIGN_FLOATS != 0 || win_floats > 65535 ||
      4 * win_floats > QT_MAX_TX_BYTES) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const int err = qt_row_map(&map, L, n_onsets, t_len, ld, QR_BOX);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QR_CASE(V)                                                            \
  case V:                                                                     \
    return qr_launch<V>(map, gbase, uoff, slab, valid, woff, inv_available,   \
                        tmax, targ, tsum, n_onsets, n_tiles, tile, group,     \
                        fsmp, nsamples, win_floats, s);
  switch (variant) {
    QR_CASE(QM_FULL)
    QR_CASE(QM_NOREDUCE)
    QR_CASE(QM_NOGATHER)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QR_CASE
}

// Resident blocks per SM of the FULL kernel at this geometry, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_resident_v2_blocks_per_sm(int n_onsets,
                                                           int tile,
                                                           int win_floats) {
  const int smem = qr_smem_bytes(n_onsets, tile, win_floats);
  cudaError_t err = cudaFuncSetAttribute(
      qm_resident_v2_kernel<QM_FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qm_resident_v2_kernel<QM_FULL>, QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
