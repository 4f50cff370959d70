// Locate's coalescence map on K1 v2's route, redesigned as a persistent
// ring (sm_90a): M2 v2, the redesign of M2 (migrate_marginalise_v2.cu:
// qm_migrate_map_v2_kernel, a store epilogue on M1 v2's staging).
//
// Replaces, as M2 does, the XLA function migrate_map
// (quakemigrate_tpu/ops/migrate.py:264), which has no Pallas kernel: the
// flat-node map4d [N, S] of locate's map path (QuakeScan.locate with
// write_coalescence or plot_event_video). M2's contract, per real node n
// of tile i of the detect plan (DetectPlan, the plan K1 v2 runs on) and
// scan sample t < nsamples:
//
//   map[perm[n], t] = expf(__fmul_rn(acc, inv_available))
//   acc = sum_{o=0}^{O-1} L[o, fsmp + base[i, o] + fine[i, n, o] + t]
//
// the onsets added in order o = 0..O-1 in float32 from 0, every real
// node's row written whole, padding written nowhere. So the map equals
// M2's bit for bit, its per-sample max K1 v2's tmax (detect_v2_core.cuh:
// qv_fold computes the same value) and its window sums M1 v2's up to the
// order of the additions.
//
// Bound on the card: the bytes are the map, N x S floats written once
// (63.2 MB at the Icequake locate window: 259,008 nodes x 61 samples,
// 0.0189 ms at 3.35 TB/s; with the inputs 0.0229 ms), but the work is a
// gather, N x O x S 4-byte reads from the staged windows, which the
// shared-memory pipe bounds: the gather floor, 0.0490 ms at Icequake (26
// onsets) at 33.5 TB/s (132 SMs x 32 banks x 4 bytes x 1.98 GHz), above
// the bytes. What held M2 at half that rate, and what this design does:
//
// 1. Each M2 block staged, then gathered: 4-byte cp.async windows, the
//    uint16 slab decoded element by element with off[o] added, a barrier,
//    and nothing of the block overlapped it. Here a ring of n_stages
//    stages is filled ahead by bulk copies (cp.async.bulk) that complete
//    on the stage's full mbarrier: each onset's window in one copy from
//    the 16-byte unit that holds its first sample, the rows read where
//    they lie (their length need not be a multiple of 4: padding them
//    cost the host a copy each call), and the item's residual entries and
//    flat indices in two more. The entries come from a table built from
//    fine16 at a detector's first map by the tables' kernel at the end of
//    this file (ops/cuda_migrate.py: map_persistent_tables, 0.05-0.07 ms
//    on the H100 at the Icequake plan, 15.5 MB on the card):
//    uint16 [n_tiles, parts, O, npi], entry
//    woff[o] + ((o ld + fsmp + base[i, o]) & 3) + fine, so the window's
//    offset in the stage and the first sample's place in its unit are in
//    the entry and nothing is decoded in the block. (fine16's own rows are
//    O int16 a node, 52 bytes at 26 onsets: no 16-byte vector of a node's
//    entries is aligned, and the onset-major order gives a warp its nodes'
//    entries of an onset in one broadcast load.) The stage n_stages later
//    is copied while the warps gather this one; no block barrier joins
//    the warps after the start: the warp whose release of a stage is the
//    16th (a counter in shared memory) refills it, as K3 v3 f64 does
//    (migrate_detect_global_v3.cu), and the item's groups go to the warps
//    as they ask for them, so that warp takes fewer of the next item's.
// 2. M2's grid of (1,080 tiles) x chunks ran 1.4-1.6 waves at 5-6 blocks
//    an SM, the last with 2-3 blocks an SM. Here the grid is persistent
//    (the resident blocks an SM, from the occupancy API, times the SMs) and
//    the items come from a counter in global memory (atomicAdd by the
//    refilling warp), which the C entry zeroes on the launch's stream
//    (cudaMemsetAsync: no host wait, and a graph captures it) and which
//    the wrapper allocates a launch, so launches on two streams never
//    share one. A block that finishes early takes the next item and the
//    tail is at most one item a block. An item is
//    a part of a tile (`parts` of them, tile / parts nodes: the real
//    nodes first, see 4) x a run of the scan; parts
//    with no real node are not items (the host lists the rest, `items`).
//    A tile split into parts stages its windows once a part: at Icequake
//    about 20 KB a part against 13 KB of entries a whole tile, and the
//    stage's bulk writes are 2-4 % of the shared-memory pipe's cycles
//    beside the gather's reads at 2 or 4 parts.
// 3. Slots past the window: a lane takes samples lane + 32 k, k < SPN, and
//    a run is 32 SPN samples, SPN the fewest of 1, 2, 4, 7 and 8 that
//    cover the scan (runs of 256 beyond). So a scan of 61 samples reads 64
//    slots a node (4.9 % wasted; M2 64), one of 201 samples one run of 7
//    slots, 224 (10.3 %; M2 two chunks of 4 slots, 256, 21.5 %, and every
//    window and the slab staged twice).
// 4. M2's warp took the nodes w, w + 8, w + 16, w + 24 of a tile and wrote
//    their 244-byte rows through perm, rows that lie next to each other in
//    the map written by other warps and blocks at other times. Here a
//    warp takes NIF consecutive nodes of the table's order: within a tile
//    the real nodes first, in brick order, and in the plan's bricks of 8 x
//    8 x 4 four consecutive nodes are one z-run, four consecutive rows of
//    the flat map, so a warp's stores of a group make one span of full
//    128-byte lines. In turns on the H100 the z-runs took 0.0844 ms of
//    device time at the Icequake plan against 0.0882 for M2's spread
//    groups (nodes a quarter tile apart) on the same ring, and the two
//    were within 1 % at the VT-sized plan: the z-runs are kept, and the
//    spread order is not built. Real nodes first also puts a tile's
//    padding in groups of its own, skipped whole.
// 5. The gather is M2's: lanes on samples, NIF nodes a warp in flight, the
//    onsets in order with the next onset's entries loaded ahead, one
//    4-, 8- or 16-byte broadcast load of the group's entries an onset.
//    The shape a scan takes (MP_SHAPES, ops/cuda_migrate.py:
//    MAP_PERSISTENT_SHAPE) is the fastest of a sweep on the H100: 8
//    nodes of 2 slots, two blocks an SM at 64 registers, at 61 samples;
//    4 nodes of 7 slots, one block an SM at 100 registers with four
//    onsets in flight, at 201. The other shapes of the sweep lost and are
//    not built: at the Icequake plan 4 nodes of 2 slots took 0.0853 ms of
//    device time against 0.0844, at the VT-sized plan 4 nodes of 7 slots
//    at two blocks an SM (64 registers) 0.1134 against 0.1102.
//
// What still holds it (PERF.md section 6): at the Icequake plan the
// kernel runs at 58 % of the gather floor's rate, 0.0844 ms of device
// time against M2's 0.0973. Staging alone takes 0.023 ms and overlaps;
// the gather without the stores 0.078, against the 0.0547 ms that the
// shared-memory reads it issues need at the pipe's rate. A shared read
// costs about three instructions (the entry's unpacking and address, the
// add), so the issue slots run near the pipe's rate as well: three
// blocks an SM at 40 registers (48 warps) ran slower, 0.095 ms.
//
// Ablations (VARIANT, for experiments/exp_map_v2.py): MP_NOSTORE computes
// every value and keeps a sum of them a thread, storing it only where it
// is negative (never); MP_NOGATHER stages and stores exp(0) (no onset
// read); MP_STAGE only stages (each warp waits for and releases the
// stages).
//
// Shared memory of a block: n_stages stages of round_up(16 + 4
// stage_floats + 2 O npi + 4 npi, 128) bytes (the header: the counter
// value, the item and t0; the windows at woff[o]; the entries; the flat
// indices), then n_stages mbarriers and two counters a stage, 16 bytes.

#include "tma_rows.cuh"

#define MP_WARPS 16
#define MP_THREADS (32 * MP_WARPS)
// Bytes of a stage before its windows: the item's counter value (or -1)
#define MP_HEADER 16

#define MP_FULL 0
#define MP_NOSTORE 1
#define MP_NOGATHER 2
#define MP_STAGE 3

__host__ __device__ __forceinline__ int mp_stage_bytes(int stage_floats,
                                                       int n_onsets,
                                                       int npi) {
  return (MP_HEADER + 4 * stage_floats + 2 * n_onsets * npi + 4 * npi +
          127) &
         ~127;
}

static int mp_smem_bytes(int stage_floats, int n_onsets, int npi,
                         int n_stages) {
  return n_stages * (mp_stage_bytes(stage_floats, n_onsets, npi) + 16);
}

// A warp's NIF entries of one onset, one 4-, 8- or 16-byte broadcast load
template <int NIF>
struct MpRaw;
template <>
struct MpRaw<2> {
  typedef unsigned T;
};
template <>
struct MpRaw<4> {
  typedef uint2 T;
};
template <>
struct MpRaw<8> {
  typedef uint4 T;
};

template <int NIF>
__device__ __forceinline__ typename MpRaw<NIF>::T mp_entries(
    const unsigned short* r) {
  return *reinterpret_cast<const typename MpRaw<NIF>::T*>(r);
}

template <int NIF>
__device__ __forceinline__ void mp_unpack(typename MpRaw<NIF>::T c,
                                          unsigned (&e)[NIF]) {
  if constexpr (NIF == 2) {
    e[0] = c & 0xffffu;
    e[1] = c >> 16;
  } else {
    e[0] = c.x & 0xffffu;
    e[1] = c.x >> 16;
    e[2] = c.y & 0xffffu;
    e[3] = c.y >> 16;
  }
  if constexpr (NIF == 8) {
    e[4] = c.z & 0xffffu;
    e[5] = c.z >> 16;
    e[6] = c.w & 0xffffu;
    e[7] = c.w >> 16;
  }
}

// The group's NIF flat indices (-1: padding), one 8-, 16- or two 16-byte
// broadcast loads from the stage
template <int NIF>
__device__ __forceinline__ void mp_nodes(const int* f, int (&node)[NIF]) {
  if constexpr (NIF == 2) {
    const int2 a = *reinterpret_cast<const int2*>(f);
    node[0] = a.x;
    node[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < NIF / 4; ++q) {
      const int4 a = reinterpret_cast<const int4*>(f)[q];
      node[4 * q] = a.x;
      node[4 * q + 1] = a.y;
      node[4 * q + 2] = a.z;
      node[4 * q + 3] = a.w;
    }
  }
}

// The gather of a group: for o = 0..O-1 in order, node i's lane adds the
// stage's window at its entry plus lane + 32 k, k < SPN. `ent` is the
// group's entries of onset 0; onset o's lie npi further each. Every slot
// is read: a slot test (a run shorter than 32 SPN samples) made each read
// a branch of its own, its add waiting on it, and took 0.108 ms at the
// Icequake plan against 0.099 for M2 (experiments/exp_map_v2.py, the
// H100), so the shapes include 7 slots, 201 samples' run.
template <int NIF, int SPN, int UNROLL>
__device__ __forceinline__ void mp_gather(const float* wl,
                                          const unsigned short* ent, int npi,
                                          int n_onsets,
                                          float (&acc)[NIF][SPN]) {
  typename MpRaw<NIF>::T cur = mp_entries<NIF>(ent);
#pragma unroll(UNROLL)
  for (int o = 0; o < n_onsets; ++o) {
    const typename MpRaw<NIF>::T next =
        mp_entries<NIF>(ent + min(o + 1, n_onsets - 1) * npi);
    unsigned e[NIF];
    mp_unpack<NIF>(cur, e);
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
      const float* src = wl + e[i];
#pragma unroll
      for (int k = 0; k < SPN; ++k) acc[i][k] += src[32 * k];
    }
    cur = next;
  }
}

__device__ __forceinline__ int mp_warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Whether this warp's release of a stage (a shared counter) is the
// MP_WARPS-th; the last resets the counter. No fence: the stage's reads
// have returned (the adds used them) before the warp arrives, and the
// refill is the async proxy's copy after it (K3 v3 f64's gw_last_arrival).
__device__ __forceinline__ bool mp_last_release(int* count, int lane) {
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(count, 1) == MP_WARPS - 1;
    if (last) *count = 0;
  }
  return __shfl_sync(0xffffffffu, last, 0) != 0;
}

// NIF consecutive nodes of the table a warp's group, runs of up to 32 SPN
// samples, built for MINB blocks an SM (its registers), VARIANT one of
// MP_FULL .. MP_STAGE.
template <int NIF, int SPN, int MINB, int VARIANT>
__global__ void __launch_bounds__(MP_THREADS, MINB)
qm_map_persistent_kernel(const float* __restrict__ L, int ld,
                         const int* __restrict__ base,
                         const unsigned short* __restrict__ res,
                         const int* __restrict__ flat,
                         const int* __restrict__ items,
                         const int* __restrict__ woff,
                         const float* __restrict__ inv_available,
                         float* __restrict__ map, int* __restrict__ counter,
                         int n_onsets, int n_items, int runs, int parts,
                         int npi, int fsmp, int nsamples, int stage_floats,
                         int n_stages) {
  constexpr int RUN = 32 * SPN;
  extern __shared__ __align__(128) unsigned char mp_raw[];
  const int stage_bytes = mp_stage_bytes(stage_floats, n_onsets, npi);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(mp_raw + n_stages * stage_bytes);
  // Releases of each stage, and its groups handed out
  int* released = reinterpret_cast<int*>(full + n_stages);
  int* taken = released + n_stages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = npi / NIF;

  // Stage s filled by one warp with the grid's next item (counter value
  // k: entry k / runs of `items`, run k % runs): each onset's window, a
  // lane an onset, from the element a = o ld + ((fsmp + base[i, o]) + t0)
  // of the rows, copied from a & ~3 (16 bytes; the entries hold a & 3),
  // cut to the floats the run's samples read (the lanes past them read
  // stale floats of the stage, whose values are never stored) and at the
  // rows' end, the 0-3 floats before the end that the last 16-byte unit
  // leaves by the lane's own loads; then the item's entries and flat
  // indices. The header holds k, the item and t0, or -1 past the last
  // item. The full mbarrier takes two arrivals: one that announces the
  // copies' bytes, one after the lanes' stores.
  auto fill = [&](int s) {
    unsigned char* st = mp_raw + s * stage_bytes;
    int* head = reinterpret_cast<int*>(st);
    int k = 0;
    if (lane == 0) k = atomicAdd(counter, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= n_items) {
      if (lane == 0) {
        head[0] = -1;
        wg_bar_arrive(&full[s]);
        wg_bar_arrive(&full[s]);
      }
      return;
    }
    const int item = __ldg(items + k / runs);
    const int t0 = (k % runs) * RUN;
    const int cut = RUN - ((min(RUN, nsamples - t0) + 3) & ~3);
    const int* base_i = base + (long long)(item / parts) * n_onsets;
    const long long total = (long long)n_onsets * ld;
    int bytes = 0;
    for (int o = lane; o < n_onsets; o += 32) {
      const long long a4 =
          ((long long)o * ld + fsmp + __ldg(base_i + o) + t0) & ~3LL;
      const long long want = __ldg(woff + o + 1) - __ldg(woff + o) - cut;
      bytes += 4 * (int)min(want, (total - a4) & ~3LL);
    }
    bytes = mp_warp_sum(bytes);
    if (lane == 0) {
      head[0] = k;
      head[1] = item;
      head[2] = t0;
      taken[s] = 0;
      wg_bar_expect_tx(&full[s], bytes + 2 * n_onsets * npi + 4 * npi);
    }
    __syncwarp();
    float* win = reinterpret_cast<float*>(st + MP_HEADER);
    for (int o = lane; o < n_onsets; o += 32) {
      const long long a4 =
          ((long long)o * ld + fsmp + __ldg(base_i + o) + t0) & ~3LL;
      const int w0 = __ldg(woff + o);
      const long long want = __ldg(woff + o + 1) - w0 - cut;
      const int n = (int)min(want, (total - a4) & ~3LL);
      if (n > 0) qt_bulk_load(win + w0, L + a4, 4 * n, &full[s]);
      for (int e = n; e < min(want, total - a4); ++e) {
        win[w0 + e] = __ldg(L + a4 + e);
      }
    }
    // The tail floats are generic stores to bytes that a later refill of
    // the stage writes through the async proxy: order them first
    wg_fence_proxy_async();
    if (lane == 0) {
      unsigned char* ent = st + MP_HEADER + 4 * stage_floats;
      qt_bulk_load(ent, res + (long long)item * n_onsets * npi,
                   2 * n_onsets * npi, &full[s]);
      qt_bulk_load(ent + 2 * n_onsets * npi, flat + (long long)item * npi,
                   4 * npi, &full[s]);
    }
    __syncwarp();
    if (lane == 0) wg_bar_arrive(&full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      wg_bar_init(&full[s], 2);
      released[s] = 0;
    }
    wg_bar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    for (int s = 0; s < n_stages; ++s) fill(s);
  }

  const float inv = *inv_available;
  float keep = 0.0f;
#pragma unroll 1
  for (int u = 0;; ++u) {
    const int s = u % n_stages;
    wg_bar_wait(&full[s], (uint32_t)((u / n_stages) & 1));
    const unsigned char* st = mp_raw + s * stage_bytes;
    const volatile int* head = reinterpret_cast<const volatile int*>(st);
    if (head[0] < 0) break;
    if (VARIANT != MP_STAGE) {
      const int t0 = head[2];
      const int cw = min(RUN, nsamples - t0);
      const float* wl = reinterpret_cast<const float*>(st + MP_HEADER) + lane;
      const unsigned short* ent = reinterpret_cast<const unsigned short*>(
          st + MP_HEADER + 4 * stage_floats);
      const int* flat_s = reinterpret_cast<const int*>(ent + n_onsets * npi);
      // The item's groups go to the warps as they ask (a counter a stage),
      // so a warp that refilled a stage takes fewer, not the same share
#pragma unroll 1
      for (;;) {
        int g = 0;
        if (lane == 0) g = atomicAdd(&taken[s], 1);
        g = __shfl_sync(0xffffffffu, g, 0);
        if (g >= groups) break;
        int node[NIF];
        mp_nodes<NIF>(flat_s + g * NIF, node);
        if (node[0] < 0) continue;  // real nodes first: all padding
        float acc[NIF][SPN];
#pragma unroll
        for (int i = 0; i < NIF; ++i) {
#pragma unroll
          for (int q = 0; q < SPN; ++q) acc[i][q] = 0.0f;
        }
        if (VARIANT != MP_NOGATHER) {
          // One block an SM leaves the registers for twice the onsets
          // in flight
          mp_gather<NIF, SPN, MINB == 1 ? 4 : 2>(wl, ent + g * NIF, npi,
                                                 n_onsets, acc);
        }
        // Each real node's samples into its row: lane j writes t0 + j +
        // 32 q, a warp 32 consecutive floats of the row a store
#pragma unroll
        for (int i = 0; i < NIF; ++i) {
          if (node[i] < 0) continue;  // warp-uniform
          float* row = map + (long long)node[i] * nsamples + t0 + lane;
#pragma unroll
          for (int q = 0; q < SPN; ++q) {
            if (lane + 32 * q < cw) {
              // __fmul_rn: no contraction into expf's range reduction, as
              // in K1 v2's fold and M2
              const float v = expf(__fmul_rn(acc[i][q], inv));
              if (VARIANT == MP_NOSTORE) {
                keep += v;
              } else {
                row[32 * q] = v;
              }
            }
          }
        }
      }
    }
    // Released by every warp: the 16th refills it
    if (mp_last_release(&released[s], lane)) fill(s);
  }
  if (VARIANT == MP_NOSTORE && keep < 0.0f) map[0] = keep;
}

// The shapes M2 v2 is built for, X(NIF, SPN, MINB): nodes a warp's group,
// slots a lane and blocks an SM (ops/cuda_migrate.py:
// MAP_PERSISTENT_SHAPES); the shape a scan takes is MAP_PERSISTENT_SHAPE's
// for its slots
#define MP_SHAPES(X) \
  X(8, 1, 2) X(8, 2, 2) X(4, 4, 2) X(4, 7, 1) X(4, 8, 2)
// The shapes whose ablations are built, X(NIF, SPN, MINB)
#define MP_ABLATED(X) X(8, 2, 2) X(4, 7, 1)

template <int NIF, int SPN, int MINB, int VARIANT>
static cudaError_t mp_configure(int smem, int* per_sm) {
  const auto kernel = qm_map_persistent_kernel<NIF, SPN, MINB, VARIANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       MP_THREADS, smem);
}

template <int NIF, int SPN, int MINB, int VARIANT>
static int mp_launch(const void* L, int ld, const void* base,
                     const void* res, const void* flat, const void* items,
                     const void* woff, const void* inv_available, void* map,
                     void* counter, int n_onsets, int n_items, int runs,
                     int parts, int npi, int fsmp, int nsamples,
                     int stage_floats, int n_stages, int smem,
                     cudaStream_t stream) {
  // The grid of the last launch of this kernel, kept with its device and
  // shared memory: the attribute and the occupancy query cost the host
  // more than the kernel's run at a locate window
  static int last_dev = -1, last_smem = -1, last_grid = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev || smem != last_smem) {
    int per_sm = 0, sms = 0;
    err = mp_configure<NIF, SPN, MINB, VARIANT>(smem, &per_sm);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    last_grid = per_sm * sms;
  }
  const int blocks = last_grid < n_items ? last_grid : n_items;
  err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  qm_map_persistent_kernel<NIF, SPN, MINB, VARIANT>
      <<<blocks, MP_THREADS, smem, stream>>>(
          static_cast<const float*>(L), ld, static_cast<const int*>(base),
          static_cast<const unsigned short*>(res),
          static_cast<const int*>(flat), static_cast<const int*>(items),
          static_cast<const int*>(woff),
          static_cast<const float*>(inv_available), static_cast<float*>(map),
          static_cast<int*>(counter), n_onsets, n_items, runs, parts, npi,
          fsmp, nsamples, stage_floats, n_stages);
  return (int)cudaGetLastError();
}

#define MP_CASE(NIF, SPN, MINB)                                              \
  if (nif == NIF && spn == SPN && minb == MINB && variant == MP_FULL) {      \
    return mp_launch<NIF, SPN, MINB, MP_FULL>(                               \
        L, ld, base, res, flat, items, woff, inv_available, map, counter,    \
        n_onsets, n_items, runs, parts, npi, fsmp, nsamples, stage_floats,   \
        n_stages, smem, s);                                                  \
  }
#define MP_ABLATION(NIF, SPN, MINB, V)                                       \
  if (nif == NIF && spn == SPN && minb == MINB && variant == V) {            \
    return mp_launch<NIF, SPN, MINB, V>(                                     \
        L, ld, base, res, flat, items, woff, inv_available, map, counter,    \
        n_onsets, n_items, runs, parts, npi, fsmp, nsamples, stage_floats,   \
        n_stages, smem, s);                                                  \
  }
#define MP_ABLATIONS(NIF, SPN, MINB)         \
  MP_ABLATION(NIF, SPN, MINB, MP_NOSTORE)    \
  MP_ABLATION(NIF, SPN, MINB, MP_NOGATHER)   \
  MP_ABLATION(NIF, SPN, MINB, MP_STAGE)

// L: float32 [n_onsets, ld] (16-byte aligned; fsmp + nsamples + every
// traveltime of the plan within a row); base int32 [n_tiles, n_onsets];
// res uint16 [n_tiles, parts, n_onsets, npi] (16-byte aligned), entry
// woff[o] + ((o ld + fsmp + base[i, o]) & 3) + fine of the table's node
// (map_persistent_tables at rows of ld's residue mod 4); flat int32
// [n_tiles, parts, npi], each table node's flat index or -1 (padding,
// after the part's real nodes); items int32 [n_items / runs], the
// (tile x parts + part) of each part with a real node; woff int32
// [n_onsets + 1], the windows' offsets in a stage (multiples of 4 floats,
// onset o's window at least round_up(r_o + 2 + 32 spn, 4) floats,
// stage_floats = woff[n_onsets]); map float32 [n_nodes, nsamples], each
// real node's row written whole; counter int32 [1], the items' counter,
// zeroed here on the stream before the launch (one a launch in flight);
// runs = ceil(nsamples / (32 spn)); (nif, spn, minb) a shape of MP_SHAPES and
// variant MP_FULL, or an ablation of MP_ABLATED. Returns a CUDA error
// code.
extern "C" int qm_migrate_map_persistent(
    const void* L, int ld, const void* base, const void* res,
    const void* flat, const void* items, const void* woff,
    const void* inv_available, void* map, void* counter, int n_onsets,
    int n_items, int runs, int parts, int npi, int fsmp, int nsamples,
    int stage_floats, int n_stages, int nif, int spn, int minb,
    int variant, void* stream) {
  if (n_onsets < 1 || n_items < 1 || runs < 1 || parts < 1 || npi < 8 ||
      npi % 8 != 0 || npi % nif != 0 || fsmp < 0 || nsamples < 1 ||
      runs != (nsamples + 32 * spn - 1) / (32 * spn) || n_items % runs != 0 ||
      ld < fsmp + nsamples || stage_floats < 4 || stage_floats % 4 != 0 ||
      stage_floats > 65536 || n_stages < 2 || n_stages > 4 ||
      4 * stage_floats + 2 * n_onsets * npi + 4 * npi > QT_MAX_TX_BYTES ||
      reinterpret_cast<uintptr_t>(L) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(res) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(flat) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = mp_smem_bytes(stage_floats, n_onsets, npi, n_stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MP_SHAPES(MP_CASE)
  MP_ABLATED(MP_ABLATIONS)
  return (int)cudaErrorInvalidValue;
}
#undef MP_ABLATIONS
#undef MP_ABLATION
#undef MP_CASE

// Resident blocks per SM of M2 v2 at a shape and ring (its full form),
// from the occupancy API; a negative value is minus a CUDA error code.
#define MP_OCC(NIF, SPN, MINB)                                          \
  if (nif == NIF && spn == SPN && minb == MINB) {                       \
    err = mp_configure<NIF, SPN, MINB, MP_FULL>(smem, &blocks);         \
  }

extern "C" int qm_migrate_map_persistent_blocks_per_sm(
    int nif, int spn, int minb, int n_onsets, int npi, int stage_floats,
    int n_stages) {
  const int smem = mp_smem_bytes(stage_floats, n_onsets, npi, n_stages);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  MP_SHAPES(MP_OCC)
  return err == cudaSuccess ? blocks : -(int)err;
}
#undef MP_OCC

// M2 v2's tables, built on the card from K1 v2's where they lie (ops/
// cuda_migrate.py: map_persistent_tables; its plain version
// map_persistent_tables_reference), so that a detector's first map makes
// no pass over them on the host. A block a tile: its nodes in the
// table's order, the real nodes first in brick order, then the padding (a
// stable partition: node n takes the place p = the real nodes before it,
// or n_real + the padding nodes before it), place p the node q = p % npi
// of part p / npi. flat: the node's flat index perm[i tile + n], or -1 for
// padding; res, onset o: woff[o] + ((o t_len4 + fsmp + base[i, o]) & 3) +
// fine16[i, n, o], below 2^16 (the stage's floats). Reads fine16 once and
// writes res once, a warp's stores of an onset mostly one span of npi.
#define MPT_THREADS 256

__global__ void __launch_bounds__(MPT_THREADS)
qm_map_persistent_tables_kernel(const short* __restrict__ fine16,
                                const int* __restrict__ base,
                                const float* __restrict__ valid,
                                const int* __restrict__ perm,
                                const int* __restrict__ woff,
                                unsigned short* __restrict__ res,
                                int* __restrict__ flat, int n_onsets,
                                int tile, int parts, int npi, int fsmp,
                                int t_len4) {
  __shared__ int warp_real[MPT_THREADS / 32];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* valid_i = valid + (long long)i * tile;
  int n_real = 0;
  for (int n0 = 0; n0 < tile; n0 += MPT_THREADS) {
    const int n = n0 + threadIdx.x;
    n_real += __syncthreads_count(n < tile && valid_i[n] > 0.0f);
  }
  // The real nodes of the chunks before this one
  int before = 0;
  for (int n0 = 0; n0 < tile; n0 += MPT_THREADS) {
    const int n = n0 + threadIdx.x;
    const bool real = n < tile && valid_i[n] > 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (lane == 0) warp_real[warp] = __popc(ballot);
    __syncthreads();
    // The real nodes before n
    int ahead = before + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < MPT_THREADS / 32; ++w) {
      const int c = warp_real[w];
      if (w < warp) ahead += c;
      before += c;
    }
    __syncthreads();  // warp_real is the next chunk's
    if (n < tile) {
      const int p = real ? ahead : n_real + (n - ahead);
      const long long part = (long long)i * parts + p / npi;
      const int q = p % npi;
      flat[part * npi + q] = real ? perm[(long long)i * tile + n] : -1;
      const short* f = fine16 + ((long long)i * tile + n) * n_onsets;
      const int* b = base + (long long)i * n_onsets;
      unsigned short* r = res + part * n_onsets * npi + q;
      for (int o = 0; o < n_onsets; ++o) {
        r[(long long)o * npi] = (unsigned short)(
            woff[o] + ((o * t_len4 + fsmp + b[o]) & 3) + f[o]);
      }
    }
  }
}

// fine16 int16 [n_tiles, tile, n_onsets], base int32 [n_tiles, n_onsets],
// valid float32 [n_tiles, tile], perm int32 [n_tiles x tile], woff int32
// [n_onsets + 1]; res uint16 [n_tiles, parts, n_onsets, npi] and flat
// int32 [n_tiles, parts, npi] written whole; tile = parts x npi, t_len4
// the onset rows' length mod 4. Returns a CUDA error code.
extern "C" int qm_migrate_map_persistent_tables(
    const void* fine16, const void* base, const void* valid, const void* perm,
    const void* woff, void* res, void* flat, int n_onsets, int n_tiles,
    int tile, int parts, int npi, int fsmp, int t_len4, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || parts < 1 || npi < 1 ||
      parts * npi != tile || fsmp < 0 || t_len4 < 0 || t_len4 > 3) {
    return (int)cudaErrorInvalidValue;
  }
  qm_map_persistent_tables_kernel<<<n_tiles, MPT_THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(fine16), static_cast<const int*>(base),
      static_cast<const float*>(valid), static_cast<const int*>(perm),
      static_cast<const int*>(woff), static_cast<unsigned short*>(res),
      static_cast<int*>(flat), n_onsets, tile, parts, npi, fsmp, t_len4);
  return (int)cudaGetLastError();
}
