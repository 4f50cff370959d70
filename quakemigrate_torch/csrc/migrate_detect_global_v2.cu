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
//
// K3 v2 f64 (qm_migrate_detect_global_v2_f64): the same kernel on double,
// for QuakeScan(precision="double"), where the reference keeps
// detect_reduce in float64 (quakemigrate_tpu/signal/scan.py:341-350).
// Sized in bytes of the element: a 16-byte bulk copy moves 2 doubles, so
// a window is r_o + 1 + 128 doubles from the column rounded down to a
// multiple of 2, rounded up to 2, and the ring holds about half the
// samples of float's; the fold and reduction scratch is (8 + 4 + 8) x W
// x 128 bytes. Its accumulators take NPP x 4 x 2 registers, so it is
// built for one shape, (16, 8, 1): two passes of 16 warps x 8 nodes, one
// block an SM, which leaves 128 registers a thread (GV_SHAPES_F64). Each
// value is exp(__dmul_rn(acc, inv)). Bound: 8-byte gather reads from
// shared memory, and the card's FP64 rate for the adds and exp.

#include "tma_rows.cuh"

#define GV_SBLK 128
#define GV_SPT (GV_SBLK / 32)
#define GV_TILE 256

// Bytes of one ring stage: `stage_floats` elements of `elem` bytes of
// windows and G residual slices of slice uint16 each, rounded up to 128.
__host__ __device__ __forceinline__ int gv_stage_bytes(int elem,
                                                       int stage_floats,
                                                       int group, int slice) {
  return (elem * stage_floats + 2 * group * slice + 127) & ~127;
}

// Dynamic shared memory of a block: the ring, the fold and reduction
// scratch (W x 128 entries of a max and a sum of `elem` bytes and a
// 4-byte argmax) and 2 n_stages mbarriers.
static int gv_smem_bytes(int elem, int warps, int stage_floats, int group,
                         int slice, int n_stages) {
  return n_stages * gv_stage_bytes(elem, stage_floats, group, slice) +
         (2 * elem + 4) * warps * GV_SBLK + 16 * n_stages;
}

// A node's coalescence exp(acc * inv), the product rounded on its own
// (no contraction into exp's range reduction, so the exponent argument is
// rounded exactly as in the plain version)
__device__ __forceinline__ float gv_coa(float acc, float inv) {
  return expf(__fmul_rn(acc, inv));
}
__device__ __forceinline__ double gv_coa(double acc, double inv) {
  return exp(__dmul_rn(acc, inv));
}

// One onset of a pass: adds the stage at each of this warp's NPP
// residual entries `r` into acc, lane reading samples lane + 32 k (`w` is
// the stage plus lane).
template <int NPP, typename T>
__device__ __forceinline__ void gv_gather(const T* w,
                                          const unsigned short* r,
                                          T (&acc)[NPP][GV_SPT]) {
#pragma unroll
  for (int q = 0; q < NPP / 8; ++q) {
    const uint4 c = reinterpret_cast<const uint4*>(r)[q];
    const unsigned e[8] = {c.x & 0xffffu, c.x >> 16, c.y & 0xffffu,
                           c.y >> 16,     c.z & 0xffffu, c.z >> 16,
                           c.w & 0xffffu, c.w >> 16};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* src = w + e[j];
#pragma unroll
      for (int k = 0; k < GV_SPT; ++k) acc[8 * q + j][k] += src[32 * k];
    }
  }
}

template <int W, int NPP, int MINB, typename T>
__global__ void __launch_bounds__(32 * W, MINB)
qm_global_v2_kernel(const T* __restrict__ L, int ld,
                    const int* __restrict__ base,
                    const unsigned short* __restrict__ res,
                    const int* __restrict__ flat,
                    const int2* __restrict__ win,
                    const T* __restrict__ inv_available,
                    T* __restrict__ tmax, int* __restrict__ targ,
                    T* __restrict__ tsum, int n_onsets, int fsmp,
                    int nsamples, int group, int stage_floats,
                    int n_stages) {
  static_assert(NPP % 8 == 0 && GV_TILE % (W * NPP) == 0,
                "8 | NPP and W NPP | 256");
  constexpr int PASSES = GV_TILE / (W * NPP);
  constexpr int SLICE = W * NPP;  // residuals of one onset a pass
  constexpr int ELEM = sizeof(T);
  // Elements of a 16-byte bulk-copy unit: windows start at a column
  // rounded down to a multiple of it
  constexpr int UNIT = 16 / ELEM;
  extern __shared__ __align__(128) unsigned char gv_raw[];
  const int stage_bytes = gv_stage_bytes(ELEM, stage_floats, group, SLICE);
  unsigned char* scratch = gv_raw + n_stages * stage_bytes;
  T* red_max = reinterpret_cast<T*>(scratch);
  int* red_arg = reinterpret_cast<int*>(scratch + ELEM * W * GV_SBLK);
  T* red_sum = reinterpret_cast<T*>(scratch + (ELEM + 4) * W * GV_SBLK);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(scratch + (2 * ELEM + 4) * W * GV_SBLK);
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
      const int col = (fsmp + base_i[o0 + g] + s0) & ~(UNIT - 1);
      bytes += ELEM * min(win[o0 + g].y, ld - col);
    }
    wg_bar_expect_tx(&full[s], bytes);
    for (int g = 0; g < cnt; ++g) {
      const int o = o0 + g;
      const int col = (fsmp + base_i[o] + s0) & ~(UNIT - 1);
      qt_bulk_load(st + ELEM * win[o].x, L + (long long)o * ld + col,
                   ELEM * min(win[o].y, ld - col), &full[s]);
    }
    qt_bulk_load(st + ELEM * stage_floats,
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

  const T inv = *inv_available;
  const int* flat_i = flat + (long long)tile_i * GV_TILE;
  int k = 0;              // this iteration
  int s = 0, prev_s = 0;  // its stage and the previous iteration's
  uint32_t phase = 0, prev_phase = 0;
#pragma unroll 1
  for (int p = 0; p < PASSES; ++p) {
    T acc[NPP][GV_SPT];
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
#pragma unroll
      for (int q = 0; q < GV_SPT; ++q) acc[j][q] = T(0);
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
      const T* wl = reinterpret_cast<const T*>(st) + lane;
      const unsigned short* rw =
          reinterpret_cast<const unsigned short*>(st + ELEM * stage_floats) +
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
      T best = -INFINITY, total = T(0);
      int arg = 0x7fffffff;
      if (p > 0) {
        best = red_max[idx];
        arg = red_arg[idx];
        total = red_sum[idx];
      }
#pragma unroll
      for (int j = 0; j < NPP; ++j) {
        if (node[j] >= 0) {
          const T coa = gv_coa(acc[j][q], inv);
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
    T m = red_max[tid];
    int a = red_arg[tid];
    T sum = red_sum[tid];
    for (int v = 1; v < W; ++v) {
      const T mv = red_max[v * GV_SBLK + tid];
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

// The shapes K3 v2 is built for, X(W, NPP, MINB): on float, and on double
// (K3 v2 f64, whose accumulators take twice the registers).
#define GV_SHAPES(X) X(32, 8, 1) X(16, 8, 2) X(16, 16, 1)
#define GV_SHAPES_F64(X) X(16, 8, 1)

template <int W, int NPP, int MINB, typename T>
static int gv_launch(const void* L, int ld, const void* base,
                     const void* res, const void* flat, const void* win,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int fsmp,
                     int nsamples, int group, int stage_floats, int n_stages,
                     cudaStream_t stream) {
  const auto kernel = qm_global_v2_kernel<W, NPP, MINB, T>;
  const int smem = gv_smem_bytes(sizeof(T), W, stage_floats, group,
                                 W * NPP, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + GV_SBLK - 1) / GV_SBLK);
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const T*>(L), ld, static_cast<const int*>(base),
      static_cast<const unsigned short*>(res),
      static_cast<const int*>(flat), static_cast<const int2*>(win),
      static_cast<const T*>(inv_available), static_cast<T*>(tmax),
      static_cast<int*>(targ), static_cast<T*>(tsum), n_onsets, fsmp,
      nsamples, group, stage_floats, n_stages);
  return (int)cudaGetLastError();
}

// The checks of the C entries, in elements of T: ld and stage_floats
// multiples of a 16-byte unit, L and res 16-byte aligned.
template <typename T>
static bool gv_args_ok(const void* L, int ld, const void* res, int n_onsets,
                       int n_tiles, int fsmp, int nsamples, int group,
                       int stage_floats, int n_stages) {
  constexpr int unit = 16 / sizeof(T);
  return !(n_onsets < 1 || n_tiles < 1 || nsamples < 1 || fsmp < 0 ||
           ld % unit != 0 || (nsamples + GV_SBLK - 1) / GV_SBLK > 65535 ||
           group < 1 || stage_floats < unit || stage_floats % unit != 0 ||
           stage_floats > 65535 || n_stages < 2 || n_stages > 4 ||
           reinterpret_cast<uintptr_t>(L) % 16 != 0 ||
           reinterpret_cast<uintptr_t>(res) % 16 != 0);
}

#define GV_CASE(W, NPP, MINB)                                             \
  if (warps == W && npp == NPP) {                                         \
    if ((int)sizeof(T) * stage_floats + 2 * group * W * NPP >             \
        QT_MAX_TX_BYTES) {                                                \
      return (int)cudaErrorInvalidValue;                                  \
    }                                                                     \
    return gv_launch<W, NPP, MINB, T>(L, ld, base, res, flat, win,        \
                                      inv_available, tmax, targ, tsum,    \
                                      n_onsets, n_tiles, fsmp, nsamples,  \
                                      group, stage_floats, n_stages, s);  \
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
  using T = float;
  if (!gv_args_ok<T>(L, ld, res, n_onsets, n_tiles, fsmp, nsamples, group,
                     stage_floats, n_stages)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GV_SHAPES(GV_CASE)
  return (int)cudaErrorInvalidValue;
}

// K3 v2 f64: as qm_migrate_detect_global_v2 with L, inv_available, tmax
// and tsum float64, ld a multiple of 2, each window's offset and width
// and stage_floats in doubles (multiples of 2), the residual entry
// win[o].x + ((fsmp + base[i, o]) & 1) + fine[i, o, n], and the shapes
// of GV_SHAPES_F64.
extern "C" int qm_migrate_detect_global_v2_f64(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles,
    int fsmp, int nsamples, int group, int stage_floats, int n_stages,
    int warps, int npp, void* stream) {
  using T = double;
  if (!gv_args_ok<T>(L, ld, res, n_onsets, n_tiles, fsmp, nsamples, group,
                     stage_floats, n_stages)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GV_SHAPES_F64(GV_CASE)
  return (int)cudaErrorInvalidValue;
}
#undef GV_CASE

// Resident blocks per SM of K3 v2 on T at a shape and ring, from the
// occupancy API; a negative value is minus a CUDA error code.
#define GV_OCC(W, NPP, MINB)                                               \
  if (warps == W && npp == NPP) {                                          \
    const int smem = gv_smem_bytes(sizeof(T), W, stage_floats, group,      \
                                   W * NPP, n_stages);                     \
    err = cudaFuncSetAttribute(qm_global_v2_kernel<W, NPP, MINB, T>,       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               smem);                                      \
    if (err == cudaSuccess) {                                              \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          &blocks, qm_global_v2_kernel<W, NPP, MINB, T>, 32 * W, smem);    \
    }                                                                      \
  }

extern "C" int qm_migrate_detect_global_v2_blocks_per_sm(int warps, int npp,
                                                         int group,
                                                         int stage_floats,
                                                         int n_stages) {
  using T = float;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  GV_SHAPES(GV_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int qm_migrate_detect_global_v2_f64_blocks_per_sm(
    int warps, int npp, int group, int stage_floats, int n_stages) {
  using T = double;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  GV_SHAPES_F64(GV_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}
#undef GV_OCC
