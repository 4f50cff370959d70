// Locate's pass 2 and map on K3 v2's ring of onset windows (sm_90a): M1
// ring and M2 ring, the redesign of M1 and of M2's simple form
// (migrate_marginalise.cu) for the plans K1 v2, and so M1 v2 and M2, does
// not stage: CudaDetectGlobal's route ("k3") and CudaDetectVPU's
// ("k2_v2").
//
// Replace, as M1 and M2 do, the XLA functions migrate_marginalise
// (quakemigrate_tpu/ops/migrate.py:291) and migrate_map
// (quakemigrate_tpu/ops/migrate.py:264). Contracts, per node n of plan
// tile i (brick order, tile nodes) with flat index flat[i, n] (-1 for
// padding, which writes nothing):
//
//   M1 ring: out[flat[i, n]] = sum_{t < len} expf(acc(n, start + t) * inv)
//   M2 ring: map[flat[i, n], s] = expf(__fmul_rn(acc(n, s), inv)), s < S
//   acc(n, s) = sum_{o<O} L[o, fsmp + base[i, o] + fine[i, o, n] + s]
//
// the onsets summed in order o = 0..O-1 in float32 as the plain versions
// (ops/migrate.py) sum them. M1 ring's exp is M1's (qm1_exp: expf of the
// product, rounded as M1 rounds it), a lane adds its samples in k order,
// the warp's lanes go through M1's xor tree and the chunks' sums are added
// in chunk order (marginalise_chunks.cuh), so a window of one chunk
// (MR_CHUNK samples or fewer) gives M1's result bit for bit. M2 ring's
// value is M2 simple's (expf(__fmul_rn(acc, inv))), so its per-sample max
// is K3 v2's tmax bit for bit.
//
// Bound on the card: at a locate window the bytes are small (the plan's
// residuals, the onset columns the window touches, the output; the map
// adds its n_nodes x S floats), and what held M1 and M2 simple was
// latency: a warp took its nodes one at a time and each onset read from
// the rows in L2 waited on a residual load, with one live accumulator a
// lane at a 30-sample window. This design takes K3 v2's
// (migrate_detect_global_v2.cu), whose staging is copied here unchanged in
// what it reads, so that K3 v2's machine code stays as it is:
//
// 1. Staging: the ring of K3 v2's tables (ops/cuda_migrate.py:
//    global_v2_layout, global_v2_tables): res uint16 [n_tiles, passes, O,
//    W NPP] (entry win[o].x + ((fsmp + base[i, o]) & 3) + fine[i, o, n]),
//    flat and win. A stage holds G onsets: each window one cp.async.bulk
//    and the group's residual slices one more; full and empty mbarriers
//    gate the stages and the producer rotates over the warps.
// 2. Gather: K3 v2's lanes. Lane l holds samples d + l + 32 k, k < KS (d
//    the block's first sample), a warp reads its NPP nodes' residual
//    entries as 16-byte broadcast loads and keeps NPP x KS accumulators in
//    registers while the onsets stream past. KS is 1, 2 or 4: the k slots
//    a chunk of the window needs, so a 30-sample window gathers one slot
//    of NPP nodes a lane, not four.
// 3. M1 ring's epilogue: exp, the lane's samples in k order, the xor
//    tree, one store a node through flat: into out for a one-chunk window,
//    else into row `chunk` of the [chunks, n_nodes] partials.
// 4. M2 ring's epilogue: each lane stores its samples into the node's
//    row: a warp writes 128 contiguous bytes of a row a store. The map
//    takes K3 v2's blocks of 128 samples from sample 0 (1 or 2 k slots
//    where the scan is one block of 32 or 64 samples or fewer).
//
// The window's alignment. K3 v2's entries carry (fsmp + base) & 3, right
// for blocks that start at multiples of 128 samples. A marginal window
// starts anywhere: block c of M1 ring starts at d = start + c MR_CHUNK. It
// copies each window from the column ((fsmp + base) & ~3) + (d & ~3), a
// multiple of 4 (16 bytes) at most 6 below fsmp + base + d, and reads the
// entry plus d & 3. Why no read of a sample the window needs leaves the
// staged window: a read's offset in onset o's window is at most
// 3 + 3 + (r_o - 1) + (MR_CHUNK - 1) = r_o + 128 (the table's lead, d & 3,
// the largest residual, the chunk's last sample), and the window holds
// width_o = round_up(r_o + 131, 4) > r_o + 130 floats: hence chunks of
// MR_CHUNK = 124 samples, not 128. A block of a window shorter than that
// copies only the floats its samples need, width_o - 128 + round_up(cw +
// 2, 4) (cw its samples), and the lanes past cw read stale floats of the
// stage whose sums are never used. On M2 ring d = s0 is a multiple of 128,
// d & 3 = 0, and its reads are K3 v2's.
//
// Shapes (MR_SHAPES): K3 v2's route shapes, (16, 8) two blocks an SM and
// (16, 16) one; passes = tile / (W NPP) at run time, so the tables of any
// tile that W NPP divides (256 on "k3", 256 or 512 on "k2_v2") are taken.
// With `split` the passes go over the grid's z axis, one a block (each
// block streams the windows once for its W NPP nodes), else a block takes
// its tile's passes one after another, as K3 v2 does, loading the next
// pass's windows while it gathers this one's (the wrapper splits where one
// pass alone fills the ring: ops/cuda_migrate.py: ring_split).
//
// M1 ring f64 and M2 ring f64 (qm_migrate_marginalise_ring_f64,
// qm_migrate_map_ring_f64): the same kernel on double, for
// QuakeScan(precision="double"), on K3 v2 f64's tables (its ring of
// doubles), the redesign of M1 f64 and M2 simple f64. Sized in elements of
// T: a 16-byte bulk copy moves UNIT = 16 / sizeof(T) elements, so a block
// copies from ((fsmp + base) & ~(UNIT - 1)) + (d & ~(UNIT - 1)) and reads
// the entry plus d & (UNIT - 1). K3 v2 f64's window holds width_o =
// round_up(r_o + 129, 2) doubles and a read's offset is at most 1 + 1 +
// (r_o - 1) + (chunk - 1) = r_o + chunk, so a chunk of MR_CHUNK_F64 = 128
// samples keeps every read inside it; a block copies width_o - 128 +
// round_up(cw, 2) doubles. Its values are M1 f64's (exp of the product)
// and M2 simple f64's (exp(__dmul_rn(acc, inv))), so a window of one
// chunk gives M1 f64's result bit for bit, the map M2 simple f64's, and
// its max K3 v2 f64's tmax. It is built for K3 v2 f64's one shape, 16
// warps x 8 nodes (MR_SHAPES_F64): its accumulators take NPP x KS x 2
// registers, so two blocks an SM at 1 or 2 k slots and one at 4.

#include "marginalise_chunks.cuh"
#include "tma_rows.cuh"

// Samples a block of M2 ring takes (K3 v2's GV_SBLK), the k slots a lane
// holds at most, and the window samples a block of M1 ring takes on
// float and on double
#define MR_SBLK 128
#define MR_SPT 4
#define MR_CHUNK 124
#define MR_CHUNK_F64 128

// The window samples a block of M1 ring takes on T
template <typename T>
__host__ __device__ constexpr int mr_chunk() {
  return sizeof(T) == 8 ? MR_CHUNK_F64 : MR_CHUNK;
}

// The blocks an SM a shape built for `minb` is built for at 4 k slots on
// T: on double the accumulators (NPP x 4 x 2 registers) take one block
template <typename T>
constexpr int mr_minb4(int minb) {
  return sizeof(T) == 8 ? 1 : minb;
}

// Bytes of one ring stage: stage_floats elements of `elem` bytes of
// windows and G residual slices of `slice` uint16 each, rounded up to 128
// (K3 v2's gv_stage_bytes).
__host__ __device__ __forceinline__ int mr_stage_bytes(int elem,
                                                       int stage_floats,
                                                       int group, int slice) {
  return (elem * stage_floats + 2 * group * slice + 127) & ~127;
}

// Dynamic shared memory of a block: the ring and 2 n_stages mbarriers
// (no fold scratch: the epilogues store to global memory).
static int mr_smem_bytes(int elem, int stage_floats, int group, int slice,
                         int n_stages) {
  return n_stages * mr_stage_bytes(elem, stage_floats, group, slice) +
         16 * n_stages;
}

// exp of the product (M1's and M1 f64's: qm1_exp in
// migrate_marginalise.cu), and exp of the product rounded on its own (M2
// simple's, K3 v2's), in each element type
__device__ __forceinline__ float mr_exp(float x) { return expf(x); }
__device__ __forceinline__ double mr_exp(double x) { return exp(x); }
__device__ __forceinline__ float mr_exp_rn(float acc, float inv) {
  return expf(__fmul_rn(acc, inv));
}
__device__ __forceinline__ double mr_exp_rn(double acc, double inv) {
  return exp(__dmul_rn(acc, inv));
}

// One onset of a pass: adds the stage at each of this warp's NPP residual
// entries `r` into acc, lane reading samples lane + 32 k, k < KS (`w` is
// the stage plus lane plus the block's d & (UNIT - 1)).
template <int NPP, int KS, typename T>
__device__ __forceinline__ void mr_gather(const T* w,
                                          const unsigned short* r,
                                          T (&acc)[NPP][KS]) {
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
      for (int k = 0; k < KS; ++k) acc[8 * q + j][k] += src[32 * k];
    }
  }
}

// M1 ring (MAP false): block (tile i, chunk c) sums the window's samples
// [c chunk, c chunk + cw) into dst[c n_nodes + flat]. M2 ring (MAP
// true): block (tile i, sample block c) stores samples [128 c, 128 c + cw)
// of the scan into dst[flat * count + s]. `start` is the window's first
// scan sample (0 for the map) and `count` its samples (the scan's for the
// map).
template <int W, int NPP, int MINB, int KS, bool MAP, typename T>
__global__ void __launch_bounds__(32 * W, MINB)
qm_ring_kernel(const T* __restrict__ L, int ld,
               const int* __restrict__ base,
               const unsigned short* __restrict__ res,
               const int* __restrict__ flat, const int2* __restrict__ win,
               const T* __restrict__ inv_available,
               T* __restrict__ dst, int n_nodes, int n_onsets, int tile,
               int fsmp, int start, int count, int group, int stage_floats,
               int n_stages, int split) {
  static_assert(NPP % 8 == 0 && KS >= 1 && KS <= MR_SPT, "NPP, KS");
  constexpr int SLICE = W * NPP;  // residuals of one onset a pass
  constexpr int ELEM = sizeof(T);
  // Elements of a 16-byte bulk-copy unit
  constexpr int UNIT = 16 / ELEM;
  constexpr int STEP = MAP ? MR_SBLK : mr_chunk<T>();
  extern __shared__ __align__(128) unsigned char mr_raw[];
  const int stage_bytes = mr_stage_bytes(ELEM, stage_floats, group, SLICE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(mr_raw + n_stages * stage_bytes);
  uint64_t* empty = full + n_stages;

  const int tile_i = blockIdx.x;
  const int chunk = blockIdx.y;
  // The block's first sample after fsmp, and its sample count
  const int d = start + chunk * STEP;
  const int cw = min(STEP, count - chunk * STEP);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The block's passes: pass blockIdx.z alone where the passes are split
  // over the grid, else all of the tile's
  const int p0 = split ? blockIdx.z : 0;
  const int passes = split ? 1 : tile / SLICE;
  const int groups = (n_onsets + group - 1) / group;  // stages a pass
  const int n_iter = passes * groups;
  const int* base_i = base + (long long)tile_i * n_onsets;
  const unsigned short* res_i = res + (long long)tile_i * n_onsets * tile;
  // Elements of a window the block's samples do not need (see the
  // header): it copies width_o - need of them, round_up(cw + 2, 4) of the
  // last 128 floats or round_up(cw, 2) of the last 128 doubles
  const int need =
      max(0, MR_SBLK - ((cw + 2 * UNIT - 3) & ~(UNIT - 1)));

  // Stage iteration j (pass j / groups, onsets from (j % groups) G) into
  // stage s, from one thread: each onset's window from the 16-byte column
  // ((fsmp + base) & ~(UNIT - 1)) + (d & ~(UNIT - 1)), cut to the elements
  // the block needs and at the row's end, at its offset in the stage, then
  // the group's residual slices (contiguous in the [passes, O, slice]
  // table).
  auto stage = [&](int j, int s) {
    const int pj = j / groups;
    const int o0 = (j - pj * groups) * group;
    const int p = p0 + pj;
    const int cnt = min(group, n_onsets - o0);
    unsigned char* st = mr_raw + s * stage_bytes;
    int bytes = 2 * cnt * SLICE;
    for (int g = 0; g < cnt; ++g) {
      const int col =
          ((fsmp + base_i[o0 + g]) & ~(UNIT - 1)) + (d & ~(UNIT - 1));
      bytes += ELEM * min(win[o0 + g].y - need, ld - col);
    }
    wg_bar_expect_tx(&full[s], bytes);
    for (int g = 0; g < cnt; ++g) {
      const int o = o0 + g;
      const int col = ((fsmp + base_i[o]) & ~(UNIT - 1)) + (d & ~(UNIT - 1));
      qt_bulk_load(st + ELEM * win[o].x, L + (long long)o * ld + col,
                   ELEM * min(win[o].y - need, ld - col), &full[s]);
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
  const int* flat_i = flat + (long long)tile_i * tile;
  T* dst_c = dst + (long long)chunk * n_nodes;
  int k = 0;              // this iteration
  int s = 0, prev_s = 0;  // its stage and the previous iteration's
  uint32_t phase = 0, prev_phase = 0;
#pragma unroll 1
  for (int p = p0; p < p0 + passes; ++p) {
    T acc[NPP][KS];
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
#pragma unroll
      for (int q = 0; q < KS; ++q) acc[j][q] = T(0);
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
      const unsigned char* st = mr_raw + s * stage_bytes;
      const T* wl =
          reinterpret_cast<const T*>(st) + lane + (d & (UNIT - 1));
      const unsigned short* rw =
          reinterpret_cast<const unsigned short*>(st + ELEM * stage_floats) +
          warp * NPP;
      // Onsets in order: o0, o0 + 1, ... of the group.
      const int cnt = min(group, n_onsets - o0);
#pragma unroll 1
      for (int g = 0; g < cnt; ++g) {
        mr_gather<NPP, KS>(wl, rw + g * SLICE, acc);
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

    // This pass's nodes: padding (-1, warp-uniform) stores nothing.
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
      const int node = __ldg(flat_i + p * SLICE + warp * NPP + j);
      if (node < 0) continue;
      if (MAP) {
        T* row = dst + (long long)node * count + d + lane;
#pragma unroll
        for (int q = 0; q < KS; ++q) {
          if (lane + 32 * q < cw) {
            row[32 * q] = mr_exp_rn(acc[j][q], inv);
          }
        }
      } else {
        // M1's sum: exp(acc * inv) as M1 writes it, the lane's samples
        // in k order, then the warp's xor tree
        T total = T(0);
#pragma unroll
        for (int q = 0; q < KS; ++q) {
          if (lane + 32 * q < cw) total += mr_exp(acc[j][q] * inv);
        }
#pragma unroll
        for (int x = 16; x > 0; x >>= 1) {
          total += __shfl_xor_sync(0xffffffffu, total, x);
        }
        if (lane == 0) dst_c[node] = total;
      }
    }
  }
}

// The shapes M1 ring and M2 ring are built for, X(W, NPP, MINB): K3 v2's
// route shapes (ops/cuda_migrate.py: GLOBAL_V2_SHAPE, GLOBAL_V2_WIDE_SHAPE)
// on float, and K3 v2 f64's one shape on double (GV_SHAPES_F64), two
// blocks an SM at 1 or 2 k slots (mr_minb4: one at 4)
#define MR_SHAPES(X) X(16, 8, 2) X(16, 16, 1)
#define MR_SHAPES_F64(X) X(16, 8, 2)

template <int W, int NPP, int MINB, int KS, bool MAP, typename T>
static int mr_launch(const void* L, int ld, const void* base, const void* res,
                     const void* flat, const void* win,
                     const void* inv_available, void* dst, int n_nodes,
                     int n_onsets, int n_tiles, int tile, int fsmp, int start,
                     int count, int n_blocks, int group, int stage_floats,
                     int n_stages, int split, cudaStream_t stream) {
  const auto kernel = qm_ring_kernel<W, NPP, MINB, KS, MAP, T>;
  const int smem =
      mr_smem_bytes(sizeof(T), stage_floats, group, W * NPP, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, n_blocks, split ? tile / (W * NPP) : 1);
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const T*>(L), ld, static_cast<const int*>(base),
      static_cast<const unsigned short*>(res), static_cast<const int*>(flat),
      static_cast<const int2*>(win), static_cast<const T*>(inv_available),
      static_cast<T*>(dst), n_nodes, n_onsets, tile, fsmp, start, count,
      group, stage_floats, n_stages, split);
  return (int)cudaGetLastError();
}

// The checks of the C entries, in elements of T: ld and stage_floats
// multiples of a 16-byte unit, L and res 16-byte aligned, whole passes of
// the shape, a stage within one mbarrier phase's byte count.
template <typename T>
static bool mr_args_ok(const void* L, int ld, const void* res, int n_onsets,
                       int n_tiles, int tile, int fsmp, int start, int count,
                       int n_blocks, int group, int stage_floats,
                       int n_stages, int warps, int npp) {
  constexpr int unit = 16 / sizeof(T);
  return !(n_onsets < 1 || n_tiles < 1 || tile < warps * npp ||
           tile % (warps * npp) != 0 || fsmp < 0 || start < 0 || count < 0 ||
           n_blocks < 1 || n_blocks > 65535 || ld % unit != 0 ||
           group < 1 || stage_floats < unit || stage_floats % unit != 0 ||
           stage_floats > 65535 || n_stages < 2 || n_stages > 4 ||
           (int)sizeof(T) * stage_floats + 2 * group * warps * npp >
               QT_MAX_TX_BYTES ||
           reinterpret_cast<uintptr_t>(L) % 16 != 0 ||
           reinterpret_cast<uintptr_t>(res) % 16 != 0);
}

// The k slots a lane of M1 ring holds at a window of `len` samples (its
// chunk width, at most the chunk): 1, 2 or 4
static int mr_slots(int len) { return len <= 32 ? 1 : len <= 64 ? 2 : 4; }

#define MR_M1_LAUNCH(W, NPP, MINB, KS)                                    \
  mr_launch<W, NPP, MINB, KS, false, T>(                                  \
      L, ld, base, res, flat, win, inv_available, dst, n_nodes, n_onsets, \
      n_tiles, tile, fsmp, window_start, window_length, n_chunks, group,  \
      stage_floats, n_stages, split, s)
#define MR_M1_CASE(W, NPP, MINB)                                          \
  if (warps == W && npp == NPP) {                                         \
    switch (mr_slots(window_length)) {                                    \
      case 1:                                                             \
        err = MR_M1_LAUNCH(W, NPP, MINB, 1);                              \
        break;                                                            \
      case 2:                                                             \
        err = MR_M1_LAUNCH(W, NPP, MINB, 2);                              \
        break;                                                            \
      default:                                                            \
        err = MR_M1_LAUNCH(W, NPP, mr_minb4<T>(MINB), MR_SPT);            \
    }                                                                     \
  }

// M1 ring on T, for the shapes of MR_SHAPES (float) or MR_SHAPES_F64
// (double): the C entries' body.
#define MR_M1_BODY(SHAPES)                                                 \
  constexpr int chunk = mr_chunk<T>();                                     \
  const int n_chunks =                                                     \
      window_length > chunk ? (window_length + chunk - 1) / chunk : 1;     \
  if (n_nodes < 1 ||                                                       \
      !mr_args_ok<T>(L, ld, res, n_onsets, n_tiles, tile, fsmp,            \
                     window_start, window_length, n_chunks, group,         \
                     stage_floats, n_stages, warps, npp) ||                \
      (n_chunks > 1 && (partial == nullptr || partial_rows < n_chunks))) { \
    return (int)cudaErrorInvalidValue;                                     \
  }                                                                        \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
  void* dst = n_chunks > 1 ? partial : out;                                \
  int err = (int)cudaErrorInvalidValue;                                    \
  SHAPES(MR_M1_CASE)                                                       \
  if (err != 0 || n_chunks == 1) return err;                               \
  qm_marginalise_sum_chunks_kernel<T><<<(n_nodes + 255) / 256, 256, 0,     \
                                        s>>>(                              \
      static_cast<const T*>(partial), n_chunks, n_nodes,                   \
      static_cast<T*>(out));                                               \
  return (int)cudaGetLastError();

// M1 ring. L: float32 [n_onsets, ld] (ld a multiple of 4, 16-byte
// aligned; fsmp + the scan + every traveltime of the plan within the
// rows); base int32 [n_tiles, n_onsets]; res uint16 [n_tiles, passes,
// n_onsets, warps npp] (passes = tile / (warps npp), 16-byte aligned),
// flat int32 [n_tiles, tile] and win int32 [n_onsets, 2], K3 v2's tables
// for scans from fsmp (global_v2_tables, any tile); the window [start,
// start + window_length) of the scan; out float32 [n_nodes], every real
// node written once; partial float32 [partial_rows, n_nodes], used where
// the window spans more than one chunk of MR_CHUNK samples (partial_rows
// at least the chunk count), else unread and may be null; split 1 puts
// the passes on the grid's z axis, 0 in each block. Returns a CUDA error
// code.
extern "C" int qm_migrate_marginalise_ring(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available, void* out,
    void* partial, int partial_rows, int n_nodes, int n_onsets, int n_tiles,
    int tile, int fsmp, int window_start, int window_length, int group,
    int stage_floats, int n_stages, int warps, int npp, int split,
    void* stream) {
  using T = float;
  MR_M1_BODY(MR_SHAPES)
}

// M1 ring f64: as qm_migrate_marginalise_ring with L, inv_available, out
// and partial float64, ld a multiple of 2, K3 v2 f64's tables (windows and
// stage_floats in doubles, the entry's lead (fsmp + base) & 1), chunks of
// MR_CHUNK_F64 samples and the shapes of MR_SHAPES_F64.
extern "C" int qm_migrate_marginalise_ring_f64(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available, void* out,
    void* partial, int partial_rows, int n_nodes, int n_onsets, int n_tiles,
    int tile, int fsmp, int window_start, int window_length, int group,
    int stage_floats, int n_stages, int warps, int npp, int split,
    void* stream) {
  using T = double;
  MR_M1_BODY(MR_SHAPES_F64)
}
#undef MR_M1_BODY
#undef MR_M1_CASE
#undef MR_M1_LAUNCH

#define MR_MAP_LAUNCH(W, NPP, MINB, KS)                                    \
  mr_launch<W, NPP, MINB, KS, true, T>(L, ld, base, res, flat, win,        \
                                       inv_available, map, 0, n_onsets,    \
                                       n_tiles, tile, fsmp, 0, nsamples,   \
                                       n_blocks, group, stage_floats,      \
                                       n_stages, split, s)
#define MR_MAP_CASE(W, NPP, MINB)                                          \
  if (warps == W && npp == NPP) {                                          \
    switch (mr_slots(nsamples)) {                                          \
      case 1:                                                              \
        return MR_MAP_LAUNCH(W, NPP, MINB, 1);                             \
      case 2:                                                              \
        return MR_MAP_LAUNCH(W, NPP, MINB, 2);                             \
      default:                                                             \
        return MR_MAP_LAUNCH(W, NPP, mr_minb4<T>(MINB), MR_SPT);           \
    }                                                                      \
  }
#define MR_MAP_BODY(SHAPES)                                                \
  const int n_blocks = (nsamples + MR_SBLK - 1) / MR_SBLK;                 \
  if (nsamples < 1 ||                                                      \
      !mr_args_ok<T>(L, ld, res, n_onsets, n_tiles, tile, fsmp, 0,         \
                     nsamples, n_blocks, group, stage_floats, n_stages,    \
                     warps, npp)) {                                        \
    return (int)cudaErrorInvalidValue;                                     \
  }                                                                        \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
  SHAPES(MR_MAP_CASE)                                                      \
  return (int)cudaErrorInvalidValue;

// M2 ring. L, ld, base, res, flat, win and inv_available as for
// qm_migrate_marginalise_ring; map float32 [n_nodes, nsamples], each real
// node's row written whole. A scan of up to 64 samples is one block of
// 128 whose lanes hold 1 or 2 k slots (mr_slots), not 4. Returns a CUDA
// error code.
extern "C" int qm_migrate_map_ring(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available, void* map,
    int n_onsets, int n_tiles, int tile, int fsmp, int nsamples, int group,
    int stage_floats, int n_stages, int warps, int npp, int split,
    void* stream) {
  using T = float;
  MR_MAP_BODY(MR_SHAPES)
}

// M2 ring f64: as qm_migrate_map_ring with L, inv_available and map
// float64 and the tables of qm_migrate_marginalise_ring_f64.
extern "C" int qm_migrate_map_ring_f64(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* win, const void* inv_available, void* map,
    int n_onsets, int n_tiles, int tile, int fsmp, int nsamples, int group,
    int stage_floats, int n_stages, int warps, int npp, int split,
    void* stream) {
  using T = double;
  MR_MAP_BODY(MR_SHAPES_F64)
}
#undef MR_MAP_BODY
#undef MR_MAP_CASE
#undef MR_MAP_LAUNCH

// Resident blocks per SM of M1 ring (map 0) or M2 ring (map 1) on T at
// `slots` k slots (1, 2 or 4), a shape and a ring, from the occupancy
// API; a negative value is minus a CUDA error code.
template <int W, int NPP, int MINB, int KS, bool MAP, typename T>
static cudaError_t mr_occupancy(int* blocks, int smem) {
  const auto kernel = qm_ring_kernel<W, NPP, MINB, KS, MAP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       32 * W, smem);
}

#define MR_OCC(W, NPP, MINB)                                               \
  if (warps == W && npp == NPP) {                                          \
    const int smem = mr_smem_bytes(sizeof(T), stage_floats, group,         \
                                   W * NPP, n_stages);                     \
    constexpr int MINB4 = mr_minb4<T>(MINB);                               \
    if (map && slots == 1) {                                               \
      err = mr_occupancy<W, NPP, MINB, 1, true, T>(&blocks, smem);         \
    } else if (map && slots == 2) {                                        \
      err = mr_occupancy<W, NPP, MINB, 2, true, T>(&blocks, smem);         \
    } else if (map) {                                                      \
      err = mr_occupancy<W, NPP, MINB4, MR_SPT, true, T>(&blocks, smem);   \
    } else if (slots == 1) {                                               \
      err = mr_occupancy<W, NPP, MINB, 1, false, T>(&blocks, smem);        \
    } else if (slots == 2) {                                               \
      err = mr_occupancy<W, NPP, MINB, 2, false, T>(&blocks, smem);        \
    } else {                                                               \
      err = mr_occupancy<W, NPP, MINB4, 4, false, T>(&blocks, smem);       \
    }                                                                      \
  }

extern "C" int qm_migrate_ring_blocks_per_sm(int warps, int npp, int slots,
                                             int map, int group,
                                             int stage_floats,
                                             int n_stages) {
  using T = float;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  MR_SHAPES(MR_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}

// As qm_migrate_ring_blocks_per_sm for M1 ring f64 and M2 ring f64
// (stage_floats in doubles).
extern "C" int qm_migrate_ring_f64_blocks_per_sm(int warps, int npp,
                                                 int slots, int map,
                                                 int group, int stage_floats,
                                                 int n_stages) {
  using T = double;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  MR_SHAPES_F64(MR_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}
#undef MR_OCC
