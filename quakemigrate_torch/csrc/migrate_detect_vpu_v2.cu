// Fused migrate-and-reduce on the VPU plan layout, redesigned for Hopper
// (sm_90a): K2 v2, on an mbarrier ring fed by TMA.
//
// Replaces the TPU kernel _detect_kernel
// (quakemigrate_tpu/ops/pallas_migrate.py:242), reached through
// PallasDetect, as v1 (migrate_detect_vpu.cu) does. That kernel holds a
// (tile, samples) accumulator across a sequential onset axis of its grid;
// here the onset axis is a loop inside the block and the accumulators
// stay in registers while the onsets stream past.
//
// Contract (K1's, migrate_detect.cu), per node tile i (brick order) and
// scan sample t:
//   coa[n,t]  = exp(sum_o L[o, fsmp + base[i,o] + fine[i,o,n] + t]
//                   * inv_available) * valid[i,n]
//   tmax[i,t] = max_n coa;  targ[i,t] = smallest local n attaining it;
//   tsum[i,t] = sum_n coa
// with v1's node order, so tmax, targ and tsum equal v1's bit for bit:
// warp w of 16 owns the NPT = tile / 16 nodes w NPT .. w NPT + NPT - 1,
// each thread folds its nodes in ascending order with a strict >
// (__fmul_rn(expf(__fmul_rn(acc, inv)), valid), as v1), then the warps
// are folded 0..15, the smaller node winning a tie. Padding nodes are
// gathered, as in v1 (at residual 0): skipping them by a branch per node
// (uniform in the warp, as K1 v2 skips them) cuts the unrolled gather
// into one basic block a node, and in this kernel it spilled registers
// and ran slower.
//
// Bound on the card: the shared-memory pipe of the gather, tile x 128
// 4-byte reads per onset and block. v1 lost to it on three counts: one
// sample a thread (every gather paid its own residual and address, and
// the fine column cost a quarter as many broadcast reads again), two
// block barriers per onset behind a one-deep cp.async prefetch, and an
// int32 fine column staged anew for every 32-sample block. This design:
//
// 1. A block takes (tile i, 128 samples); lane l holds samples s0 + l +
//    32 k, k = 0..3, so one residual read and one address serve four
//    gathers at immediate offsets +0/+32/+64/+96 floats, conflict-free.
// 2. Passes: warp w takes its NPT nodes in NPT / NPP passes of NPP nodes
//    (NPP = 8, 4 at tile 64; NPP x 4 accumulators a thread), the onsets streaming once per
//    pass, in order. After each pass a thread folds its NPP nodes into a
//    running (max, arg, sum) per sample, kept in the cross-warp
//    reduction's scratch (each thread owns its entries until the final
//    barrier), so the fold stays ascending and bit-equal to v1's.
// 3. Residuals: a host table uint16 [tiles, passes, O, 16 NPP]
//    (ops/cuda_migrate.py vpu_v2_residuals) in the order the kernel
//    reads it, entry ((fsmp + base[i,o]) & 3) + fine: one (pass, onset)
//    slice is 16 NPP contiguous entries (256 bytes at NPP 8), one
//    16-byte broadcast read for 8 nodes x 4 samples, and a pass's
//    consecutive onsets are contiguous.
// 4. Ring: n_stages stages (2-4), each holding QW_GRP consecutive onsets
//    of a pass: their windows, TMA boxes of L [O, t_len] from the column
//    fsmp + base[i,o] + s0 rounded down to a multiple of 4 (a tiled
//    load's inner start must be 16-byte aligned; the table's & 3 skips
//    the 0-3 floats; columns past t_len arrive as 0), and their residual
//    slices by one bulk copy. Every warp waits on the stage's full
//    mbarrier and its lane 0 arrives on the stage's empty mbarrier; at
//    iteration k, lane 0 of warp (k - 1) % 16 refills the previous
//    iteration's stage, so a copy has n_stages - 1 iterations to land
//    and the producer's work rotates over the warps. No block barrier in
//    the onset loop. A group of onsets a stage amortises the waits and the
//    bookkeeping: on an H100 at the Icequake plan 1, 2, 4 and 8 onsets a
//    stage took 1.13, 0.91, 0.76 and 0.72 ms (recorded in PERF.md), so the
//    kernel is built for 8.
// 5. Shared memory per block: n_stages x QW_GRP x (window + slice) + the
//    24 KB fold and reduction scratch + the barriers, independent of O
//    (57,536 bytes at r_span 43, NPP 8, 4 stages: 2 blocks an
//    SM, as the 64-register cap allows), where K1 and K1 v2 stage every
//    onset's window at once.

#include "tma_rows.cuh"

#define QW_WARPS 16
#define QW_THREADS (32 * QW_WARPS)
#define QW_SBLK 128
#define QW_SPT (QW_SBLK / 32)
#define QW_RED_FLOATS (3 * QW_WARPS * QW_SBLK)
#define QW_GRP 8

// Bytes of one ring stage: QW_GRP windows (stride floats each, a
// multiple of 32) and their pass residual slices (16 NPP uint16 each),
// rounded up to 128 so every stage's windows land 128-byte aligned.
__host__ __device__ __forceinline__ int qw_stage_bytes(int stride, int npp) {
  return (QW_GRP * (4 * stride + 2 * QW_WARPS * npp) + 127) & ~127;
}

// Dynamic shared memory of a block: 128 bytes of alignment slack, the
// ring, the fold and reduction scratch and 2 n_stages mbarriers.
static int qw_smem_bytes(int stride, int npp, int n_stages) {
  return 128 + n_stages * qw_stage_bytes(stride, npp) + 4 * QW_RED_FLOATS +
         16 * n_stages;
}

// One onset of a pass: adds the window at each of this warp's NPP
// residuals `r` into acc, lane reading samples lane + 32 k (w is the
// window plus lane).
template <int NPP>
__device__ __forceinline__ void qw_gather(const float* w,
                                          const unsigned short* r,
                                          float (&acc)[NPP][QW_SPT]) {
  if constexpr (NPP % 8 == 0) {
#pragma unroll
    for (int q = 0; q < NPP / 8; ++q) {
      const uint4 c = reinterpret_cast<const uint4*>(r)[q];
      const unsigned e[8] = {c.x & 0xffffu, c.x >> 16, c.y & 0xffffu,
                             c.y >> 16,     c.z & 0xffffu, c.z >> 16,
                             c.w & 0xffffu, c.w >> 16};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* src = w + e[j];
#pragma unroll
        for (int k = 0; k < QW_SPT; ++k) acc[8 * q + j][k] += src[32 * k];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < NPP / 4; ++q) {
      const uint2 c = reinterpret_cast<const uint2*>(r)[q];
      const unsigned e[4] = {c.x & 0xffffu, c.x >> 16, c.y & 0xffffu,
                             c.y >> 16};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* src = w + e[j];
#pragma unroll
        for (int k = 0; k < QW_SPT; ++k) acc[4 * q + j][k] += src[32 * k];
      }
    }
  }
}

// Two blocks per SM (64 registers a thread).
template <int NPT, int NPP>
__global__ void __launch_bounds__(QW_THREADS, 2)
qm_vpu_v2_kernel(const __grid_constant__ CUtensorMap map,
                 const int* __restrict__ base,
                 const unsigned short* __restrict__ res,
                 const float* __restrict__ valid,
                 const float* __restrict__ inv_available,
                 float* __restrict__ tmax, int* __restrict__ targ,
                 float* __restrict__ tsum, int n_onsets, int fsmp,
                 int nsamples, int stride, int box, int n_boxes,
                 int n_stages) {
  static_assert(NPT % NPP == 0 && NPP % 4 == 0, "NPP divides NPT, 4 | NPP");
  constexpr int TILE = QW_WARPS * NPT;
  constexpr int PASSES = NPT / NPP;
  constexpr int SLICE = QW_WARPS * NPP;  // residuals of one onset a pass
  extern __shared__ unsigned char qw_raw[];
  unsigned char* ring = qw_raw + ((128 - (wg_smem(qw_raw) & 127)) & 127);
  constexpr int GRP = QW_GRP;
  const int stage_bytes = qw_stage_bytes(stride, NPP);
  float* red = reinterpret_cast<float*>(ring + n_stages * stage_bytes);
  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + QW_WARPS * QW_SBLK);
  float* red_sum = red + 2 * QW_WARPS * QW_SBLK;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + QW_RED_FLOATS);
  uint64_t* empty = full + n_stages;

  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QW_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (n_onsets + GRP - 1) / GRP;  // stages a pass
  const int n_iter = PASSES * groups;
  const int* base_i = base + (long long)tile_i * n_onsets;
  const unsigned short* res_i = res + (long long)tile_i * n_onsets * TILE;
  // The map's parameter-space address: a reference would let the
  // compiler copy the map to local memory, from which TMA cannot load.
  const CUtensorMap* tmap = &map;

  // Stage iteration j (pass j / groups, onsets from (j % groups) GRP)
  // into stage s, from one thread: a window per onset, then the group's
  // residual slices (contiguous in the [passes, O, slice] table) by one
  // bulk copy.
  auto stage = [&](int j, int s) {
    const int p = j / groups;
    const int o0 = (j - p * groups) * GRP;
    const int cnt = min(GRP, n_onsets - o0);
    unsigned char* st = ring + s * stage_bytes;
    float* win = reinterpret_cast<float*>(st);
    wg_bar_expect_tx(&full[s], cnt * (4 * box * n_boxes + 2 * SLICE));
    for (int g = 0; g < cnt; ++g) {
      const int o = o0 + g;
      const int col = (fsmp + base_i[o] + s0) & ~3;
      for (int b = 0; b < n_boxes; ++b) {
        wg_tma_load_2d(win + g * stride + b * box, tmap, &full[s],
                       col + b * box, o);
      }
    }
    qt_bulk_load(st + 4 * GRP * stride,
                 res_i + ((long long)p * n_onsets + o0) * SLICE,
                 2 * cnt * SLICE, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      wg_bar_init(&full[s], 1);
      wg_bar_init(&empty[s], QW_WARPS);
    }
    wg_bar_init_fence();
    wg_prefetch_map(tmap);
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < n_stages && j < n_iter; ++j) stage(j, j);
  }

  const float inv = *inv_available;
  const float* valid_i = valid + (long long)tile_i * TILE;
  int k = 0;              // this iteration
  int s = 0, prev_s = 0;  // its stage and the previous iteration's
  uint32_t phase = 0, prev_phase = 0;
#pragma unroll 1
  for (int p = 0; p < PASSES; ++p) {
    float acc[NPP][QW_SPT];
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
#pragma unroll
      for (int q = 0; q < QW_SPT; ++q) acc[j][q] = 0.0f;
    }
#pragma unroll 1
    for (int o0 = 0; o0 < n_onsets; o0 += GRP, ++k) {
      // Lane 0 of warp (k - 1) % 16 refills the previous iteration's
      // stage once every warp is done with it (its copy then has
      // n_stages - 1 iterations to land): the producer's work and its
      // wait for the slowest warp rotate over the warps.
      if (k > 0 && warp == ((k - 1) & (QW_WARPS - 1)) &&
          k - 1 + n_stages < n_iter) {
        if (lane == 0) {
          wg_bar_wait(&empty[prev_s], prev_phase);
          stage(k - 1 + n_stages, prev_s);
        }
        __syncwarp();
      }
      wg_bar_wait(&full[s], phase);
      const unsigned char* st = ring + s * stage_bytes;
      const float* wl = reinterpret_cast<const float*>(st) + lane;
      const unsigned short* rw =
          reinterpret_cast<const unsigned short*>(st + 4 * GRP * stride) +
          warp * NPP;
      // Onsets in order: o0, o0 + 1, ... of the group.
#pragma unroll
      for (int g = 0; g < GRP; ++g) {
        if (g == 0 || o0 + g < n_onsets) {
          qw_gather<NPP>(wl + g * stride, rw + g * SLICE, acc);
        }
      }
      __syncwarp();
      if (lane == 0) wg_bar_arrive(&empty[s]);
      prev_s = s;
      prev_phase = phase;
      if (++s == n_stages) {
        s = 0;
        phase ^= 1u;
      }
    }

    // This pass's nodes, ascending, into the thread's running fold.
#pragma unroll
    for (int q = 0; q < QW_SPT; ++q) {
      const int idx = warp * QW_SBLK + 32 * q + lane;
      float best = -INFINITY, total = 0.0f;
      int arg = 0;
      if (p > 0) {
        best = red_max[idx];
        arg = red_arg[idx];
        total = red_sum[idx];
      }
#pragma unroll
      for (int j = 0; j < NPP; ++j) {
        const int n = warp * NPT + p * NPP + j;
        // __fmul_rn: no contraction into expf's range reduction, so the
        // exponent argument is rounded exactly as in the plain version.
        const float coa =
            __fmul_rn(expf(__fmul_rn(acc[j][q], inv)), __ldg(valid_i + n));
        if (coa > best) {
          best = coa;
          arg = n;
        }
        total += coa;
      }
      red_max[idx] = best;
      red_arg[idx] = arg;
      red_sum[idx] = total;
    }
  }
  __syncthreads();

  if (tid < QW_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = red_arg[tid];
    float sum = red_sum[tid];
    for (int v = 1; v < QW_WARPS; ++v) {
      const float mv = red_max[v * QW_SBLK + tid];
      const int av = red_arg[v * QW_SBLK + tid];
      if (mv > m || (mv == m && av < a)) {
        m = mv;
        a = av;
      }
      sum += red_sum[v * QW_SBLK + tid];
    }
    const long long out = (long long)tile_i * nsamples + s0 + tid;
    tmax[out] = m;
    targ[out] = a;
    tsum[out] = sum;
  }
}

static bool qw_layout_ok(int stride, int box, int n_boxes, int npp,
                         int n_stages) {
  return stride % QT_ALIGN_FLOATS == 0 && box >= 4 && box % 4 == 0 &&
         box <= 256 && n_boxes >= 1 && box * n_boxes >= QW_SBLK + 4 &&
         box * n_boxes <= stride &&
         (n_boxes == 1 || box % QT_ALIGN_FLOATS == 0) && n_stages >= 2 &&
         n_stages <= 4 &&
         QW_GRP * (4 * box * n_boxes + 2 * QW_WARPS * npp) <= QT_MAX_TX_BYTES;
}

template <int NPT, int NPP>
static int qw_launch(const CUtensorMap& map, const void* base,
                     const void* res, const void* valid,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int fsmp,
                     int nsamples, int stride, int box, int n_boxes,
                     int n_stages, cudaStream_t stream) {
  if (!qw_layout_ok(stride, box, n_boxes, NPP, n_stages)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = qm_vpu_v2_kernel<NPT, NPP>;
  const int smem = qw_smem_bytes(stride, NPP, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QW_SBLK - 1) / QW_SBLK);
  kernel<<<grid, QW_THREADS, smem, stream>>>(
      map, static_cast<const int*>(base),
      static_cast<const unsigned short*>(res),
      static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, fsmp,
      nsamples, stride, box, n_boxes, n_stages);
  return (int)cudaGetLastError();
}

// The shapes K2 v2 is built for, one a tile: X(NPT, NPP), tile = 16 NPT,
// NPP nodes a warp a pass.
#define QW_SHAPES(X) X(4, 4) X(8, 8) X(16, 8) X(32, 8)

// L: float32 [n_onsets, ld] (row pitch ld >= t_len, a multiple of 4,
// 16-byte aligned); base int32 [n_tiles, n_onsets]; res uint16
// [n_tiles, tile / (16 npp), n_onsets, 16 npp] (16-byte aligned):
// per pass and onset the pass's residual slice, entry ((fsmp + base[i,
// o]) & 3) + fine, each below box * n_boxes - QW_SBLK + 1; valid float32
// [n_tiles, tile]. tile 64, 128, 256 or 512, whose pass takes npp 4, 8,
// 8 or 8 nodes a warp (QW_SHAPES); n_stages 2-4.
extern "C" int qm_migrate_detect_vpu_v2(
    const void* L, int t_len, int ld, const void* base, const void* res,
    const void* valid, const void* inv_available, void* tmax, void* targ,
    void* tsum, int n_onsets, int n_tiles, int tile, int fsmp, int nsamples,
    int stride, int box, int n_boxes, int n_stages, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || nsamples < 1 ||
      (nsamples + QW_SBLK - 1) / QW_SBLK > 65535 ||
      reinterpret_cast<uintptr_t>(res) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const int err = qt_row_map(&map, L, n_onsets, t_len, ld, box);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QW_CASE(NPT, NPP)                                                   \
  if (tile == QW_WARPS * NPT) {                                             \
    return qw_launch<NPT, NPP>(map, base, res, valid, inv_available, tmax,  \
                               targ, tsum, n_onsets, n_tiles, fsmp,         \
                               nsamples, stride, box, n_boxes, n_stages,    \
                               s);                                          \
  }
  QW_SHAPES(QW_CASE)
#undef QW_CASE
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of K2 v2 at this tile, window stride and ring
// depth, from the occupancy API; a negative value is minus a CUDA error
// code.
extern "C" int qm_migrate_detect_vpu_v2_blocks_per_sm(int tile, int stride,
                                                      int n_stages) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define QW_OCC(NPT, NPP)                                                   \
  if (tile == QW_WARPS * NPT) {                                            \
    const int smem = qw_smem_bytes(stride, NPP, n_stages);                 \
    err = cudaFuncSetAttribute(qm_vpu_v2_kernel<NPT, NPP>,                 \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               smem);                                      \
    if (err == cudaSuccess) {                                              \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          &blocks, qm_vpu_v2_kernel<NPT, NPP>, QW_THREADS, smem);          \
    }                                                                      \
  }
  QW_SHAPES(QW_OCC)
#undef QW_OCC
  return err == cudaSuccess ? blocks : -(int)err;
}
