// Fused migrate-and-reduce in float64 for the detect stage on the brick
// plan, on a persistent ring that stages each tile's windows once (sm_90a):
// K3 v3 f64, the redesign of K3 v2 f64 (migrate_detect_global_v2.cu on
// double) for doubles.
//
// Replaces, as K3 v2 f64 does, the JAX package's detect_reduce
// (quakemigrate_tpu/ops/migrate.py:124) in float64: under
// precision="double" the reference keeps that XLA function in float64
// (quakemigrate_tpu/signal/scan.py:341-350), and QuakeScan's detect
// windows and locate's pass 1 run it. K3 v2 f64's contract, per node tile
// i of the DetectPlan (brick order, 256 nodes) and scan sample t <
// nsamples:
//
//   coa[n, t]  = exp(__dmul_rn(sum_{o<O} L[o, fsmp + tt[n, o] + t],
//                              inv_available))
//   tmax[i, t] = max over the real nodes n of the tile
//   targ[i, t] = the smallest FLAT index attaining it
//   tsum[i, t] = sum over the real nodes of the tile
//
// with the onsets added in order o = 0..O-1 in float64, so each node's
// value, and so tmax, is K3 v2 f64's and the plain float64 version's bit
// for bit; padding nodes (flat index -1) are left out. It reads K3 v2
// f64's tables as they are (ops/cuda_migrate.py: global_v2_tables at the
// layout of shape (16, 8)): res uint16 [n_tiles, 2, O, 128] (entry
// win[o].x + ((fsmp + base[i, o]) & 1) + fine[i, o, n] for node n = 128 p
// + q), flat and win, the tables M1 ring f64 and M2 ring f64 read too.
// combine_brick_tiles finishes the reduction.
//
// Bound on the card: the shared-memory pipe of the gather, 8-byte reads,
// real nodes x O x S of them (1.005 ms at the archive window: 259,008
// nodes, 26 onsets, 625 samples, at 33.5 TB/s), above the contract's FP64
// operations bound. What held K3 v2 f64 at 58 % of that rate, and what
// this design does about it:
//
// 1. Its ring did not stream. At the archive window one stage holds every
//    window (G = O), so a block (one tile x 128 samples) copied the same
//    windows once a pass, waited cold for them, and two of its four stages
//    stayed empty. Here, where one stage holds all O windows and the
//    residual slices of both passes (stage_passes = 2), a work item
//    (tile, 128-sample block) is staged once and every round gathers from
//    it. Where it does not (F3's 24 windows of ~3,000 doubles), a stage
//    holds G windows and one pass's slices, as in K3 v2 f64, and each of
//    the item's rounds streams the item's groups again: 256 nodes x 128
//    samples of float64 accumulators are the whole register file, so no
//    round can take the tile at once.
// 2. One block an SM started cold and ended on a barrier 5,000 times.
//    Here the grid is persistent: one block an SM walks the items
//    blockIdx.x, + gridDim.x, ..., and the ring streams across them. No
//    warp is set aside to produce: the warp whose release of a stage is
//    the 16th (a shared-memory counter a stage) refills it at once with
//    the block's stage n_stages later, its lanes computing the windows'
//    columns and issuing a cp.async.bulk a window from its 16-byte aligned
//    column, cut at the row's end, and one more a pass of residual slices,
//    completing on the stage's full mbarrier. So the next items' stages
//    are in flight while the current one is gathered, and only the first
//    item of a block waits on a cold fill. A 17th warp would cost every
//    thread 32 of its registers (five warps on one of the SM's four
//    register files: 96 a thread, and spills).
// 3. Its exps and fold ran on every warp at once after each pass, with no
//    warp of the SM gathering: a __syncthreads closed every block. Here
//    no barrier joins the warps: each thread keeps its running (max, flat
//    arg, sum) of its 4 samples in registers and folds each round's sums
//    at the round's end, and after an item's last round writes them to the
//    scratch (16 warps x 128 samples); the warp whose write is the 16th (a
//    counter) folds the 16 rows in warp order into the item's outputs and
//    frees the scratch on the red_empty mbarrier. A warp waits only for a
//    stage's data or for the scratch an item later, so one warp's exps
//    run while the others gather. Folding a round's sums during the next
//    round's gather instead (keeping them in 16 more doubles) was measured
//    slower: its registers spilled and it cut the loads in flight.
// 4. What held the gather itself is the loads in flight (K1 v2, with more
//    warps, reaches 83 % of its floor): with 8 nodes a warp, 32 doubles of
//    sums leave no registers for a second onset's loads. In the form one
//    stage an item takes, a warp takes NPP = 4 nodes a round (4 rounds an
//    item), loads the next onset's entries ahead and unrolls the onset
//    loop twice, so two onsets' 32 reads are in flight (a sweep of forms:
//    experiments/exp_double.py --forms). The streamed form keeps 8 nodes
//    and 2 rounds, one a pass: 4 rounds would stream its windows 4 times.
// 5. K1 v2's lanes on samples: lane l holds samples s0 + l + 32 k, k < 4,
//    so a warp's read of a window is two 128-byte halves, conflict-free
//    (no gain from 16- or 128-byte aligned entries: exp_double --align); a
//    warp reads its NPP nodes' entries of an onset as one 4-, 8- or
//    16-byte broadcast load.
//
// Registers: 16 warps, one block an SM, at most 128 a thread, no spills
// in any form of GW_FORMS.

#include <type_traits>

#include "tma_rows.cuh"

#define GW_SBLK 128
#define GW_SPT (GW_SBLK / 32)
#define GW_TILE 256
// The passes of K3 v2 f64's tables (shape (16, 8)) and a pass's nodes
#define GW_PASSES 2
#define GW_SLICE (GW_TILE / GW_PASSES)
// Warps of a block
#define GW_WARPS 16
#define GW_THREADS (32 * GW_WARPS)

// Bytes of one ring stage: `stage_floats` doubles of windows and
// `stage_passes` x `group` residual slices of 128 uint16, rounded up to
// 128.
__host__ __device__ __forceinline__ int gw_stage_bytes(int stage_floats,
                                                       int group,
                                                       int stage_passes) {
  return (8 * stage_floats + 2 * stage_passes * group * GW_SLICE + 127) &
         ~127;
}

// Dynamic shared memory of a block: the ring, the scratch (16 warps x 128
// samples of a max and a sum of 8 bytes and a 4-byte argmax), n_stages +
// 1 mbarriers and n_stages + 1 counters (8 bytes each).
static int gw_smem_bytes(int stage_floats, int group, int stage_passes,
                         int n_stages) {
  return n_stages * gw_stage_bytes(stage_floats, group, stage_passes) +
         20 * GW_WARPS * GW_SBLK + 8 * (2 * n_stages + 2);
}

// A warp's NPP residual entries of one onset (16-bit each), as one 4-, 8-
// or 16-byte broadcast load from `r`
template <int NPP>
using GwRaw = typename std::conditional<
    NPP == 2, unsigned,
    typename std::conditional<NPP == 4, uint2, uint4>::type>::type;

template <int NPP>
__device__ __forceinline__ GwRaw<NPP> gw_entries(const unsigned short* r) {
  return *reinterpret_cast<const GwRaw<NPP>*>(r);
}

// One onset of a round: adds the stage at each of this warp's NPP residual
// entries `c` into acc, the lane reading samples lane + 32 k (`w` is the
// stage plus lane).
template <int NPP>
__device__ __forceinline__ void gw_gather(const double* w, GwRaw<NPP> c,
                                          double (&acc)[NPP][GW_SPT]) {
  unsigned e[NPP];
  if constexpr (NPP == 2) {
    e[0] = c & 0xffffu;
    e[1] = c >> 16;
  } else {
    e[0] = c.x & 0xffffu;
    e[1] = c.x >> 16;
    e[2] = c.y & 0xffffu;
    e[3] = c.y >> 16;
  }
  if constexpr (NPP == 8) {
    e[4] = c.z & 0xffffu;
    e[5] = c.z >> 16;
    e[6] = c.w & 0xffffu;
    e[7] = c.w >> 16;
  }
#pragma unroll
  for (int j = 0; j < NPP; ++j) {
    const double* src = w + e[j];
#pragma unroll
    for (int k = 0; k < GW_SPT; ++k) acc[j][k] += src[32 * k];
  }
}

// A round's sums `x` of the nodes whose flat indices start at `nodes` into
// the thread's running fold: exp(__dmul_rn(acc, inv)), the larger value or
// on equal values the smaller flat index; padding (-1) left out.
template <int NPP>
__device__ __forceinline__ void gw_fold(const double (&x)[NPP][GW_SPT],
                                        const int* nodes, double inv,
                                        double (&best)[GW_SPT],
                                        int (&arg)[GW_SPT],
                                        double (&total)[GW_SPT]) {
  int node[NPP];
#pragma unroll
  for (int j = 0; j < NPP; ++j) node[j] = __ldg(nodes + j);
#pragma unroll
  for (int q = 0; q < GW_SPT; ++q) {
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
      if (node[j] >= 0) {
        const double coa = exp(__dmul_rn(x[j][q], inv));
        if (coa > best[q] || (coa == best[q] && node[j] < arg[q])) {
          best[q] = coa;
          arg[q] = node[j];
        }
        total[q] += coa;
      }
    }
  }
}

// The sum of `x` over the warp's lanes
__device__ __forceinline__ int gw_warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Whether this warp's arrival on the shared counter `count` is the
// GW_WARPS-th; the last arrival resets it. With `fence`, each lane's
// earlier shared-memory writes are ordered before the arrival and the
// last warp's later reads after every warp's writes. A release of a stage
// needs no fence: its reads have returned (the adds used them) before the
// warp arrives, and the refill is the async proxy's copy after it.
template <bool FENCE>
__device__ __forceinline__ bool gw_last_arrival(int* count, int lane) {
  if constexpr (FENCE) __threadfence_block();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(count, 1) == GW_WARPS - 1;
    if (last) *count = 0;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if constexpr (FENCE) __threadfence_block();
  return last != 0;
}

// NPP nodes a warp a round, the onset loop unrolled UNROLL times.
template <int NPP, int UNROLL>
__global__ void __launch_bounds__(GW_THREADS, 1)
qm_global_v3_f64_kernel(const double* __restrict__ L, int ld,
                        const int* __restrict__ base,
                        const unsigned short* __restrict__ res,
                        const int* __restrict__ flat,
                        const int2* __restrict__ win,
                        const double* __restrict__ inv_available,
                        double* __restrict__ tmax, int* __restrict__ targ,
                        double* __restrict__ tsum, int n_onsets,
                        int n_tiles, int fsmp, int nsamples, int group,
                        int stage_floats, int stage_passes, int n_stages) {
  static_assert(NPP == 2 || NPP == 4 || NPP == 8,
                "2, 4 or 8 nodes a warp a round");
  constexpr int NR = GW_WARPS * NPP;  // nodes a round
  constexpr int ROUNDS = GW_TILE / NR;
  constexpr int RPP = GW_SLICE / NR;  // rounds a pass
  extern __shared__ __align__(128) unsigned char gw_raw[];
  const int stage_bytes = gw_stage_bytes(stage_floats, group, stage_passes);
  unsigned char* scratch = gw_raw + n_stages * stage_bytes;
  double* red_max = reinterpret_cast<double*>(scratch);
  double* red_sum = red_max + GW_WARPS * GW_SBLK;
  int* red_arg = reinterpret_cast<int*>(red_sum + GW_WARPS * GW_SBLK);
  uint64_t* full = reinterpret_cast<uint64_t*>(red_arg + GW_WARPS * GW_SBLK);
  uint64_t* red_empty = full + n_stages;
  // Releases of each stage and writes of the scratch, counted
  int* released = reinterpret_cast<int*>(red_empty + 1);
  int* written = released + n_stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // One stage an item (every window, both passes' slices), or the item's
  // rounds x groups stages
  const bool single = stage_passes == GW_PASSES;
  const int n_groups = (n_onsets + group - 1) / group;
  const int units = single ? 1 : ROUNDS * n_groups;
  const int n_sblk = (nsamples + GW_SBLK - 1) / GW_SBLK;
  const int n_items = n_tiles * n_sblk;
  const int n_local = (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int n_units = n_local * units;

  // Stage u of the block (item u / units; in the streamed form round
  // k / n_groups, group k % n_groups of it) into ring stage u % n_stages,
  // by the whole warp: each onset's window from its 16-byte aligned column,
  // cut at the row's end (the columns past it feed only samples at or
  // beyond nsamples), at its offset in the stage, a lane an onset; then a
  // pass's residual slices of the stage's onsets (contiguous in the
  // [passes, O, 128] table) a copy.
  auto fill = [&](int u) {
    const int j = u / units;
    const int k = u - j * units;
    const int it = blockIdx.x + j * gridDim.x;
    const int tile = it / n_sblk;
    const int s0 = (it - tile * n_sblk) * GW_SBLK;
    const int o0 = (single ? 0 : k % n_groups) * group;
    const int p0 = single ? 0 : (k / n_groups) / RPP;
    const int cnt = min(group, n_onsets - o0);
    const int s = u % n_stages;
    unsigned char* st = gw_raw + s * stage_bytes;
    const int* base_i = base + (long long)tile * n_onsets;
    int bytes = 0;
    for (int g = lane; g < cnt; g += 32) {
      const int col = (fsmp + __ldg(base_i + o0 + g) + s0) & ~1;
      bytes += 8 * min(win[o0 + g].y, ld - col);
    }
    bytes = gw_warp_sum(bytes);
    if (lane == 0) {
      wg_bar_expect_tx(&full[s], bytes + 2 * stage_passes * cnt * GW_SLICE);
    }
    __syncwarp();
    for (int g = lane; g < cnt; g += 32) {
      const int o = o0 + g;
      const int col = (fsmp + __ldg(base_i + o) + s0) & ~1;
      qt_bulk_load(st + 8 * win[o].x, L + (long long)o * ld + col,
                   8 * min(win[o].y, ld - col), &full[s]);
    }
    if (lane < stage_passes) {
      qt_bulk_load(
          st + 8 * stage_floats + 2 * lane * cnt * GW_SLICE,
          res + (((long long)tile * GW_PASSES + p0 + lane) * n_onsets + o0) *
                    GW_SLICE,
          2 * cnt * GW_SLICE, &full[s]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      wg_bar_init(&full[s], 1);
      released[s] = 0;
    }
    wg_bar_init(red_empty, 1);
    *written = 0;
    wg_bar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    for (int u = 0; u < n_stages && u < n_units; ++u) fill(u);
  }

  const double inv = *inv_available;
  double best[GW_SPT], total[GW_SPT];
  int arg[GW_SPT];
#pragma unroll
  for (int q = 0; q < GW_SPT; ++q) {
    best[q] = -INFINITY;
    arg[q] = 0x7fffffff;
    total[q] = 0.0;
  }
  // The thread's running fold of item j into the scratch, then reset; the
  // 16th warp to write folds the 16 rows in warp order (the larger value,
  // or on equal values the smaller flat index; sums in warp order), each
  // lane taking samples lane + 32 k, into the item's outputs, and frees
  // the scratch.
  auto write_partials = [&](int j) {
    if (j > 0) wg_bar_wait(red_empty, (uint32_t)((j - 1) & 1));
#pragma unroll
    for (int q = 0; q < GW_SPT; ++q) {
      const int idx = warp * GW_SBLK + 32 * q + lane;
      red_max[idx] = best[q];
      red_arg[idx] = arg[q];
      red_sum[idx] = total[q];
      best[q] = -INFINITY;
      arg[q] = 0x7fffffff;
      total[q] = 0.0;
    }
    if (!gw_last_arrival<true>(written, lane)) return;
    const int it = blockIdx.x + j * gridDim.x;
    const int tile = it / n_sblk;
    const int s0 = (it - tile * n_sblk) * GW_SBLK;
#pragma unroll 1
    for (int k = 0; k < GW_SPT; ++k) {
      const int t = lane + 32 * k;
      double m = red_max[t];
      int a = red_arg[t];
      double sum = red_sum[t];
      for (int v = 1; v < GW_WARPS; ++v) {
        const double mv = red_max[v * GW_SBLK + t];
        const int av = red_arg[v * GW_SBLK + t];
        if (mv > m || (mv == m && av < a)) {
          m = mv;
          a = av;
        }
        sum += red_sum[v * GW_SBLK + t];
      }
      if (s0 + t < nsamples) {
        const long long out = (long long)tile * nsamples + s0 + t;
        tmax[out] = m;
        targ[out] = a;
        tsum[out] = sum;
      }
    }
    __syncwarp();
    if (lane == 0) wg_bar_arrive(red_empty);
  };

  int u = 0;  // the block's stage being read
  for (int j = 0; j < n_local; ++j) {
    const int it = blockIdx.x + j * gridDim.x;
    const int tile = it / n_sblk;
    const int* flat_i = flat + (long long)tile * GW_TILE;
    int s = 0;
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      const int p = r / RPP;
      const int q0 = (r % RPP) * NR + warp * NPP;  // within the pass
      double acc[NPP][GW_SPT];
#pragma unroll
      for (int jj = 0; jj < NPP; ++jj) {
#pragma unroll
        for (int k = 0; k < GW_SPT; ++k) acc[jj][k] = 0.0;
      }
#pragma unroll 1
      for (int c = 0; c < (single ? 1 : n_groups); ++c) {
        if (!single || r == 0) {
          s = u % n_stages;
          wg_bar_wait(&full[s], (uint32_t)((u / n_stages) & 1));
        }
        const unsigned char* st = gw_raw + s * stage_bytes;
        const double* wl = reinterpret_cast<const double*>(st) + lane;
        const int o0 = c * group;
        const int cnt = min(group, n_onsets - o0);
        const unsigned short* rw =
            reinterpret_cast<const unsigned short*>(st + 8 * stage_floats) +
            (single ? p * n_onsets * GW_SLICE : 0) + q0;
        // Onsets in order: o0, o0 + 1, ... of the stage, the next onset's
        // entries loaded ahead.
        GwRaw<NPP> cur = gw_entries<NPP>(rw);
#pragma unroll(UNROLL)
        for (int g = 0; g < cnt; ++g) {
          const GwRaw<NPP> next =
              gw_entries<NPP>(rw + min(g + 1, cnt - 1) * GW_SLICE);
          gw_gather<NPP>(wl, cur, acc);
          cur = next;
        }
        // Released by every warp: the 16th refills it
        if (!single || r == ROUNDS - 1) {
          if (gw_last_arrival<false>(&released[s], lane) &&
              u + n_stages < n_units) {
            fill(u + n_stages);
          }
          ++u;
        }
      }
      gw_fold<NPP>(acc, flat_i + p * GW_SLICE + q0, inv, best, arg, total);
      if (r == ROUNDS - 1) write_partials(j);
    }
  }
}

// The forms K3 v3 f64 is built for, X(NPP, UNROLL): (4, 2), one stage an
// item's, (8, 1), the streamed form's, and the others of the sweep that
// chose them (ops/cuda_migrate.py: GLOBAL_V3_FORM)
#define GW_FORMS(X) X(4, 2) X(8, 1) X(8, 2) X(4, 4) X(2, 4)

template <int NPP, int UNROLL>
static cudaError_t gw_grid(int smem, int n_items, int* blocks) {
  const auto kernel = qm_global_v3_f64_kernel<NPP, UNROLL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      GW_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms < n_items ? per_sm * sms : n_items;
  return cudaSuccess;
}

#define GW_CASE(NPP, UNROLL)                                                \
  if (npp == NPP && unroll == UNROLL) {                                     \
    int blocks = 0;                                                         \
    cudaError_t err = gw_grid<NPP, UNROLL>(smem, n_items, &blocks);          \
    if (err != cudaSuccess) return (int)err;                                \
    qm_global_v3_f64_kernel<NPP, UNROLL><<<blocks, GW_THREADS, smem, s>>>(   \
        static_cast<const double*>(L), ld, static_cast<const int*>(base),   \
        static_cast<const unsigned short*>(res),                            \
        static_cast<const int*>(flat), static_cast<const int2*>(win),       \
        static_cast<const double*>(inv_available),                          \
        static_cast<double*>(tmax), static_cast<int*>(targ),                \
        static_cast<double*>(tsum), n_onsets, n_tiles, fsmp, nsamples,      \
        group, stage_floats, stage_passes, n_stages);                       \
    return (int)cudaGetLastError();                                         \
  }

// L: float64 [n_onsets, ld] (ld a multiple of 2, L 16-byte aligned, fsmp +
// nsamples + every traveltime of the plan at most t_len <= ld); base int32
// [n_tiles, n_onsets]; res uint16 [n_tiles, 2, n_onsets, 128] (16-byte
// aligned), flat int32 [n_tiles, 256] and win int32 [n_onsets, 2]: K3 v2
// f64's tables at shape (16, 8) (qm_migrate_detect_global_v2_f64), built
// for its group G and stage_floats; stage_passes 2 (one stage an item: G
// the whole of n_onsets) or 1 (G onsets and one pass a stage); n_stages
// 2-4; npp and unroll a form of GW_FORMS. Returns a CUDA error code.
extern "C" int qm_migrate_detect_global_v3_f64(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles,
    int fsmp, int nsamples, int group, int stage_floats, int stage_passes,
    int n_stages, int npp, int unroll, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || nsamples < 1 || fsmp < 0 ||
      ld % 2 != 0 || group < 1 || stage_floats < 2 ||
      stage_floats % 2 != 0 || stage_floats > 65535 || n_stages < 2 ||
      n_stages > 4 || (stage_passes != 1 && stage_passes != GW_PASSES) ||
      (stage_passes == GW_PASSES && group < n_onsets) ||
      8 * stage_floats + 2 * stage_passes * group * GW_SLICE >
          QT_MAX_TX_BYTES ||
      (long long)n_tiles * ((nsamples + GW_SBLK - 1) / GW_SBLK) >
          0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(L) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(res) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_items = n_tiles * ((nsamples + GW_SBLK - 1) / GW_SBLK);
  const int smem =
      gw_smem_bytes(stage_floats, group, stage_passes, n_stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GW_FORMS(GW_CASE)
  return (int)cudaErrorInvalidValue;
}
#undef GW_CASE

// Resident blocks per SM of K3 v3 f64 at a form and ring, from the
// occupancy API; a negative value is minus a CUDA error code.
#define GW_OCC(NPP, UNROLL)                                                 \
  if (npp == NPP && unroll == UNROLL) {                                     \
    const auto kernel = qm_global_v3_f64_kernel<NPP, UNROLL>;                \
    err = cudaFuncSetAttribute(                                             \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    if (err == cudaSuccess) {                                               \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
          &blocks, kernel, GW_THREADS, smem);                               \
    }                                                                       \
  }

extern "C" int qm_migrate_detect_global_v3_f64_blocks_per_sm(
    int npp, int unroll, int group, int stage_floats, int stage_passes,
    int n_stages) {
  const int smem =
      gw_smem_bytes(stage_floats, group, stage_passes, n_stages);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  GW_FORMS(GW_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}
#undef GW_OCC
