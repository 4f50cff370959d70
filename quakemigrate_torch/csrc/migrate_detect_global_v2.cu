// Fused migrate-and-reduce for the detect stage on the brick plan, with
// the onset windows streamed through an mbarrier ring (sm_90a): K3 v2,
// the Hopper redesign of K3 (migrate_detect_global.cu).
//
// Replaces, as K3 does, the XLA shift-table kernel of the JAX package,
// detect_reduce (quakemigrate_tpu/ops/migrate.py:124), which the fused
// detect windows reach where the Pallas plan is refused
// (quakemigrate_tpu/signal/scan.py:380-423) or kernel="xla" forces it.
// K3's contract, per node tile i of the DetectPlan (brick order, 256
// nodes) and scan sample t < nsamples:
//
//   coa[n, t]  = expf(__fmul_rn(sum_{o<O} L[o, fsmp + tt[n, o] + t],
//                               inv_available))
//   tmax[i, t] = max over the real nodes n of the tile
//   targ[i, t] = the smallest FLAT index attaining it
//   tsum[i, t] = sum over the real nodes of the tile
//
// with tt[n, o] = base[i, o] + fine[i, o, n] the plan's traveltimes
// (clamped at 0; the wrapper checks that fsmp + nsamples + the largest
// of them fits the onset block, so K3's clamp at the top is the
// identity). The onsets are summed in order o = 0..O-1 in float32, as
// the plain version sums them, so each node's value is K3's; the fold
// takes, on equal values, the smaller flat index (not the brick
// position), and the host combine (ops/cuda_migrate.py:
// combine_brick_tiles) the smallest flat index among the tiles that
// attain the max, so ties go to the first flat index, the XLA rule.
//
// Bound on the card: the shared-memory pipe of the gather, as for K1 v2
// and K2 v2 (n_nodes x O x S 4-byte reads). K3 read every node-onset-
// sample from global memory at an address that depends on a traveltime
// (its flat tiles of 256 nodes spanned up to 11,821 samples at the F3
// geometry, about 355 KB of rows a tile, so the reads lived in L2). This
// design:
//
// 1. Tiles from the brick plan: a tile's residuals span r_o <= r_span
//    samples per onset (2,990 at F3), so one window of r_o + 131 floats
//    of each onset feeds all 256 nodes of the tile.
// 2. A ring of n_stages stages (2-4), each holding G consecutive onsets
//    of a pass: their windows, one cp.async.bulk copy each of
//    width_o = round_up(r_o + 3 + 128, 4) floats from the column fsmp +
//    base[i,o] + s0 rounded down to a multiple of 4 (a bulk copy moves
//    16-byte units; the table's residual carries the 0-3 floats), cut at
//    the end of the onset row, and the group's residual slices by one
//    more. Every warp waits on the stage's full mbarrier and its lane 0
//    arrives on the stage's empty mbarrier; lane 0 of warp (k - 1) % W
//    refills the stage of iteration k - 1, as in K2 v2
//    (migrate_detect_vpu_v2.cu). G and the window offsets in a stage
//    come from the host (ops/cuda_migrate.py: global_v2_layout): the
//    windows' widths differ per onset.
// 3. The gather reads shared memory with K1 v2's lane layout: lane l
//    holds samples s0 + l + 32 k, k < 4, so one residual serves four
//    conflict-free reads. A residual entry (uint16) is the read's offset
//    in the stage: the window's offset, its 0-3 floats of alignment and
//    fine. A warp reads its NPP nodes' entries of an onset as 16-byte
//    broadcast loads.
// 4. The accumulators stay in registers while the onsets stream past:
//    warp w takes NPP nodes a pass (PASSES = 256 / (W NPP) passes, the
//    onsets streaming once a pass), then folds them into a running
//    (max, flat arg, sum) per sample in the cross-warp scratch, which
//    each thread owns until the final barrier.
//
// Shapes (GV_SHAPES): W warps x NPP nodes a warp a pass, and the blocks
// per SM it is built for: (32, 8, 1) one pass, (16, 8, 2) two passes,
// (16, 16, 1) one pass. Padding nodes (flat index -1) are gathered at
// residual 0 and left out of the fold.

#include "tma_rows.cuh"

#define GV_SBLK 128
#define GV_SPT (GV_SBLK / 32)
#define GV_TILE 256

// Bytes of one ring stage: `stage_floats` floats of windows and G
// residual slices of slice uint16 each, rounded up to 128.
__host__ __device__ __forceinline__ int gv_stage_bytes(int stage_floats,
                                                       int group, int slice) {
  return (4 * stage_floats + 2 * group * slice + 127) & ~127;
}

// Dynamic shared memory of a block: the ring, the fold and reduction
// scratch (3 x W x 128 4-byte entries) and 2 n_stages mbarriers.
static int gv_smem_bytes(int warps, int stage_floats, int group, int slice,
                         int n_stages) {
  return n_stages * gv_stage_bytes(stage_floats, group, slice) +
         12 * warps * GV_SBLK + 16 * n_stages;
}

// One onset of a pass: adds the stage at each of this warp's NPP
// residual entries `r` into acc, lane reading samples lane + 32 k (`w` is
// the stage plus lane).
template <int NPP>
__device__ __forceinline__ void gv_gather(const float* w,
                                          const unsigned short* r,
                                          float (&acc)[NPP][GV_SPT]) {
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
      for (int k = 0; k < GV_SPT; ++k) acc[8 * q + j][k] += src[32 * k];
    }
  }
}

template <int W, int NPP, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
qm_global_v2_kernel(const float* __restrict__ L, int ld,
                    const int* __restrict__ base,
                    const unsigned short* __restrict__ res,
                    const int* __restrict__ flat,
                    const int2* __restrict__ win,
                    const float* __restrict__ inv_available,
                    float* __restrict__ tmax, int* __restrict__ targ,
                    float* __restrict__ tsum, int n_onsets, int fsmp,
                    int nsamples, int group, int stage_floats,
                    int n_stages) {
  static_assert(NPP % 8 == 0 && GV_TILE % (W * NPP) == 0,
                "8 | NPP and W NPP | 256");
  constexpr int PASSES = GV_TILE / (W * NPP);
  constexpr int SLICE = W * NPP;  // residuals of one onset a pass
  extern __shared__ __align__(128) unsigned char gv_raw[];
  const int stage_bytes = gv_stage_bytes(stage_floats, group, SLICE);
  float* red = reinterpret_cast<float*>(gv_raw + n_stages * stage_bytes);
  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + W * GV_SBLK);
  float* red_sum = red + 2 * W * GV_SBLK;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 3 * W * GV_SBLK);
  uint64_t* empty = full + n_stages;

  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * GV_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (n_onsets + group - 1) / group;  // stages a pass
  const int n_iter = PASSES * groups;
  const int* base_i = base + (long long)tile_i * n_onsets;
  const unsigned short* res_i = res + (long long)tile_i * n_onsets * GV_TILE;

  // Stage iteration j (pass j / groups, onsets from (j % groups) G) into
  // stage s, from one thread: each onset's window from its 16-byte
  // aligned column, cut at the row's end (the columns past it feed only
  // samples at or beyond nsamples), at its offset in the stage, then the
  // group's residual slices (contiguous in the [passes, O, slice] table).
  auto stage = [&](int j, int s) {
    const int p = j / groups;
    const int o0 = (j - p * groups) * group;
    const int cnt = min(group, n_onsets - o0);
    unsigned char* st = gv_raw + s * stage_bytes;
    int bytes = 2 * cnt * SLICE;
    for (int g = 0; g < cnt; ++g) {
      const int col = (fsmp + base_i[o0 + g] + s0) & ~3;
      bytes += 4 * min(win[o0 + g].y, ld - col);
    }
    wg_bar_expect_tx(&full[s], bytes);
    for (int g = 0; g < cnt; ++g) {
      const int o = o0 + g;
      const int col = (fsmp + base_i[o] + s0) & ~3;
      qt_bulk_load(st + 4 * win[o].x, L + (long long)o * ld + col,
                   4 * min(win[o].y, ld - col), &full[s]);
    }
    qt_bulk_load(st + 4 * stage_floats,
                 res_i + ((long long)p * n_onsets + o0) * SLICE,
                 2 * cnt * SLICE, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      wg_bar_init(&full[s], 1);
      wg_bar_init(&empty[s], W);
    }
    wg_bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < n_stages && j < n_iter; ++j) stage(j, j);
  }

  const float inv = *inv_available;
  const int* flat_i = flat + (long long)tile_i * GV_TILE;
  int k = 0;              // this iteration
  int s = 0, prev_s = 0;  // its stage and the previous iteration's
  uint32_t phase = 0, prev_phase = 0;
#pragma unroll 1
  for (int p = 0; p < PASSES; ++p) {
    float acc[NPP][GV_SPT];
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
#pragma unroll
      for (int q = 0; q < GV_SPT; ++q) acc[j][q] = 0.0f;
    }
#pragma unroll 1
    for (int o0 = 0; o0 < n_onsets; o0 += group, ++k) {
      // Lane 0 of warp (k - 1) % W refills the previous iteration's
      // stage once every warp is done with it.
      if (k > 0 && warp == (k - 1) % W && k - 1 + n_stages < n_iter) {
        if (lane == 0) {
          wg_bar_wait(&empty[prev_s], prev_phase);
          stage(k - 1 + n_stages, prev_s);
        }
        __syncwarp();
      }
      wg_bar_wait(&full[s], phase);
      const unsigned char* st = gv_raw + s * stage_bytes;
      const float* wl = reinterpret_cast<const float*>(st) + lane;
      const unsigned short* rw =
          reinterpret_cast<const unsigned short*>(st + 4 * stage_floats) +
          warp * NPP;
      // Onsets in order: o0, o0 + 1, ... of the group.
      const int cnt = min(group, n_onsets - o0);
#pragma unroll 1
      for (int g = 0; g < cnt; ++g) gv_gather<NPP>(wl, rw + g * SLICE, acc);
      __syncwarp();
      if (lane == 0) wg_bar_arrive(&empty[s]);
      prev_s = s;
      prev_phase = phase;
      if (++s == n_stages) {
        s = 0;
        phase ^= 1u;
      }
    }

    // This pass's nodes into the thread's running fold: the larger value,
    // or on equal values the smaller flat index; padding (-1) left out.
    int node[NPP];
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
      node[j] = __ldg(flat_i + p * SLICE + warp * NPP + j);
    }
#pragma unroll
    for (int q = 0; q < GV_SPT; ++q) {
      const int idx = warp * GV_SBLK + 32 * q + lane;
      float best = -INFINITY, total = 0.0f;
      int arg = 0x7fffffff;
      if (p > 0) {
        best = red_max[idx];
        arg = red_arg[idx];
        total = red_sum[idx];
      }
#pragma unroll
      for (int j = 0; j < NPP; ++j) {
        if (node[j] >= 0) {
          // __fmul_rn: no contraction into expf's range reduction, so the
          // exponent argument is rounded exactly as in the plain version.
          const float coa = expf(__fmul_rn(acc[j][q], inv));
          if (coa > best || (coa == best && node[j] < arg)) {
            best = coa;
            arg = node[j];
          }
          total += coa;
        }
      }
      red_max[idx] = best;
      red_arg[idx] = arg;
      red_sum[idx] = total;
    }
  }
  __syncthreads();

  if (tid < GV_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = red_arg[tid];
    float sum = red_sum[tid];
    for (int v = 1; v < W; ++v) {
      const float mv = red_max[v * GV_SBLK + tid];
      const int av = red_arg[v * GV_SBLK + tid];
      if (mv > m || (mv == m && av < a)) {
        m = mv;
        a = av;
      }
      sum += red_sum[v * GV_SBLK + tid];
    }
    const long long out = (long long)tile_i * nsamples + s0 + tid;
    tmax[out] = m;
    targ[out] = a;
    tsum[out] = sum;
  }
}

// The shapes K3 v2 is built for: X(W, NPP, MINB).
#define GV_SHAPES(X) X(32, 8, 1) X(16, 8, 2) X(16, 16, 1)

template <int W, int NPP, int MINB>
static int gv_launch(const void* L, int ld, const void* base,
                     const void* res, const void* flat, const void* win,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int fsmp,
                     int nsamples, int group, int stage_floats, int n_stages,
                     cudaStream_t stream) {
  const auto kernel = qm_global_v2_kernel<W, NPP, MINB>;
  const int smem =
      gv_smem_bytes(W, stage_floats, group, W * NPP, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + GV_SBLK - 1) / GV_SBLK);
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const float*>(L), ld, static_cast<const int*>(base),
      static_cast<const unsigned short*>(res),
      static_cast<const int*>(flat), static_cast<const int2*>(win),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, fsmp,
      nsamples, group, stage_floats, n_stages);
  return (int)cudaGetLastError();
}

// L: float32 [n_onsets, ld] (ld a multiple of 4, L 16-byte aligned,
// fsmp + nsamples + every traveltime of the plan at most t_len <= ld);
// base int32 [n_tiles, n_onsets]; res uint16 [n_tiles, passes,
// n_onsets, 256 / passes] (16-byte aligned), passes = 256 / (warps npp):
// entry win[o].x + ((fsmp + base[i, o]) & 3) + fine[i, o, n] for node n
// = p (256 / passes) + q of the brick-order tile; flat int32 [n_tiles,
// 256], the flat index of each brick-order node or -1 for padding; win
// int32 [n_onsets, 2]: onset o's window offset in its stage and width
// in floats, both multiples of 4, within stage_floats; group onsets a
// stage, n_stages 2-4. Returns a CUDA error code.
extern "C" int qm_migrate_detect_global_v2(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles,
    int fsmp, int nsamples, int group, int stage_floats, int n_stages,
    int warps, int npp, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || nsamples < 1 || fsmp < 0 ||
      ld % 4 != 0 || (nsamples + GV_SBLK - 1) / GV_SBLK > 65535 ||
      group < 1 || stage_floats < 4 || stage_floats % 4 != 0 ||
      stage_floats > 65535 || n_stages < 2 || n_stages > 4 ||
      reinterpret_cast<uintptr_t>(L) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(res) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GV_CASE(W, NPP, MINB)                                             \
  if (warps == W && npp == NPP) {                                         \
    if (4 * stage_floats + 2 * group * W * NPP > QT_MAX_TX_BYTES) {       \
      return (int)cudaErrorInvalidValue;                                  \
    }                                                                     \
    return gv_launch<W, NPP, MINB>(L, ld, base, res, flat, win,           \
                                   inv_available, tmax, targ, tsum,       \
                                   n_onsets, n_tiles, fsmp, nsamples,     \
                                   group, stage_floats, n_stages, s);     \
  }
  GV_SHAPES(GV_CASE)
#undef GV_CASE
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of K3 v2 at a shape and ring, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_global_v2_blocks_per_sm(int warps, int npp,
                                                         int group,
                                                         int stage_floats,
                                                         int n_stages) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define GV_OCC(W, NPP, MINB)                                               \
  if (warps == W && npp == NPP) {                                          \
    const int smem =                                                       \
        gv_smem_bytes(W, stage_floats, group, W * NPP, n_stages);          \
    err = cudaFuncSetAttribute(qm_global_v2_kernel<W, NPP, MINB>,          \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               smem);                                      \
    if (err == cudaSuccess) {                                              \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          &blocks, qm_global_v2_kernel<W, NPP, MINB>, 32 * W, smem);       \
    }                                                                      \
  }
  GV_SHAPES(GV_OCC)
#undef GV_OCC
  return err == cudaSuccess ? blocks : -(int)err;
}
