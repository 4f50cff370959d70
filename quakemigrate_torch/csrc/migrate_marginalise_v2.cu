// Migration marginalised over a sample window, for locate's second pass,
// redesigned on K1 v2's gather core: M1 v2. At the end of the file, M2,
// the coalescence map of locate's map path, on the same staging.
//
// Replaces the XLA function migrate_marginalise
// (quakemigrate_tpu/ops/migrate.py:291), as M1 (migrate_marginalise.cu)
// does, with M1's contract: per node n of tile i of the detect plan
// (DetectPlan, the plan pass 1 runs on),
//
//   out[perm[n]] = sum_{t=0}^{len-1} exp(inv_available *
//                    sum_{o=0}^{O-1} L[o, col0 + base[i,o] + fine[i,o,n] + t])
//
// for every real node (valid[i, n] != 0), with col0 = fsmp + window_start;
// padding nodes write nothing. The onsets are summed in order o = 0..O-1
// in float32, each sample's exp is expf(acc * inv) as in M1, a lane adds
// its samples lane + 32 k in k order, the warp adds the lanes by M1's
// xor-shuffle tree, and a window of several chunks adds the chunks' rows
// in chunk order. So for a window of one chunk (QM2_CHUNK samples or
// fewer) the output equals M1's bit for bit; beyond, the chunks are half
// as long as M1's and the sums round in another order.
//
// Bound on the card: M1 is latency-bound. Each of its warps walks its
// nodes one after another, every onset read waiting on a residual loaded
// from global memory, and at a locate window (30 samples) one of a
// lane's eight accumulators is live: 2 % of the function's bound on the
// H100 (PERF.md section 6). The work itself is K1 v2's gather: node x
// onset x sample 4-byte reads from the onsets' windows, which the
// shared-memory pipe bounds (the gather floor). What each design item
// does about it:
//
// 1. K1 v2's staging. One block takes a (node tile, chunk of QM2_CHUNK
//    samples) and stages, once, the tile's uint16 slab [tile,
//    qv_row(O)] of off[o] + fine16[n, o] (the plan's node-major int16
//    table, 2 bytes a node-onset against M1's 4), `valid`, and each
//    onset's window of r_spans[o] + cw floats. cw is the window's chunk
//    width, min(len, QM2_CHUNK), so a 30-sample window stages 30 + r
//    floats an onset, not K1 v2's 128 + r: the offsets are K1 v2's
//    span_off less o (QM2_CHUNK - cw), made in the block. The windows
//    come by 4-byte asynchronous copies while the slab is staged from
//    16-byte loads, QM2_STAGE in flight a thread, and each node's perm
//    entry is loaded before its gather (together 8 % faster at 30
//    samples than K1 v2's staging, one load at a time, on the H100).
//    After the staging the gather issues no global load.
// 2. Several nodes a warp in flight. Lanes stay on samples (lane j takes
//    samples j + 32 k, k < SPN), and a warp gathers NIF nodes together,
//    NIF x SPN independent shared-memory reads a lane an onset (K1 v2:
//    two nodes x four samples). The kernel is a template on (NIF, SPN),
//    built for one shape a slot count (qm2_kernel), the fastest of a
//    sweep on the H100 at the Icequake plan (PERF.md section 6): at a
//    window of up to 32 samples each of a lane's accumulators holds
//    another node, (4, 1) (8, 1 took 64 registers and 4 blocks an SM,
//    and was no faster); up to 64 samples (4, 2); up to 128 (2, 4).
//    Warp w takes the nodes w, w + 8,
//    ... of the tile, as M1, NIF at a time; nodes past the tile or
//    padding read a real row and store nothing, so the gather has no
//    per-node branch.
// 3. The epilogue: expf(acc * inv) a slot, the lane's sum in k order, one
//    xor tree a node, and lane q stores node q of the group through perm
//    (NIF stores in one instruction): into out where the window is one
//    chunk, else into row `chunk` of a [chunks, n_nodes] partial table
//    whose rows M1's chunk sum (marginalise_chunks.cuh) adds in chunk
//    order.
// 4. No tensor cores: there is no product to feed them. The one-hot
//    product form of this gather (E3 v2, 102.8 ms at 30,000 samples)
//    loses to the shared-memory gather (K1 v2, 27.2 ms) on this card.
//
// Shared memory of a block (bytes, all regions 16-byte aligned):
//   off  int32 [O + 1, rounded up to 4]     window offsets
//   vld  f32   [tile]                       valid (tile % 16 == 0)
//   slab u16   [tile, round_up(O, 8)]       off[o] + fine16[n, o]
//   win  f32   [off[O] + 32 SPN - cw]       the windows, then zeros that
//                                           the lanes past cw may read
// The slab entries are below off[O], which the host keeps under 2^16.
// Since 32 SPN <= QM2_CHUNK, a block never needs more shared memory than
// K1 v2's at the same plan, so M1 v2 takes every plan K1 v2 takes.
//
// M1 (migrate_marginalise.cu) stays for the plans K1 v2 refuses (its
// int16 table or shared memory), which CudaDetectVPU's route takes.

#include "detect_v2_core.cuh"
#include "marginalise_chunks.cuh"

// Window samples of a block: K1 v2's sample block
#define QM2_CHUNK QM_SBLK
// 16-byte residual loads a thread keeps in flight while staging the slab
#define QM2_STAGE 4

// The window's chunk width, min(len, QM2_CHUNK)
__host__ __device__ __forceinline__ int qm2_chunk_width(int window_length) {
  return window_length < QM2_CHUNK ? window_length : QM2_CHUNK;
}

// Samples a lane adds a node (1, 2 or 4) at chunk width cw
__host__ __device__ __forceinline__ int qm2_slots(int cw) {
  return cw <= 32 ? 1 : cw <= 64 ? 2 : 4;
}

// Floats of a block's windows and the zeros after them at this window
// length: K1 v2's win_floats less O (QM2_CHUNK - cw), plus 32 SPN - cw.
static int qm2_win_floats(int n_onsets, int win_floats, int window_length) {
  const int cw = qm2_chunk_width(window_length);
  return win_floats - n_onsets * (QM2_CHUNK - cw) + 32 * qm2_slots(cw) - cw;
}

// Shared memory of a block whose windows and zeros hold win2 floats
static int qm2_smem_bytes(int n_onsets, int tile, int win2) {
  return 4 * (((n_onsets + 4) & ~3) + tile) + 2 * tile * qv_row(n_onsets) +
         4 * win2;
}

// Adds onset j of the NIF nodes' slab chunks q into acc: node i's lane
// reads samples lane + 32 k of the onset's window at its residual.
template <int NIF, int SPN>
__device__ __forceinline__ void qm2_add_onset(const float* wl,
                                              const uint4 (&q)[NIF], int j,
                                              float (&acc)[NIF][SPN]) {
#pragma unroll
  for (int i = 0; i < NIF; ++i) {
    const float* s = wl + qv_entry(q[i], j);
#pragma unroll
    for (int k = 0; k < SPN; ++k) acc[i][k] += s[32 * k];
  }
}

// The gather of NIF nodes together, slab rows r[i] (16-byte chunks of 8
// onsets): onsets in order o = 0..O-1 for each node.
template <int NIF, int SPN>
__device__ __forceinline__ void qm2_gather(const float* wl,
                                           const uint4* const (&r)[NIF],
                                           int n_onsets,
                                           float (&acc)[NIF][SPN]) {
  const int chunks = n_onsets >> 3;
  for (int c = 0; c < chunks; ++c) {
    uint4 q[NIF];
#pragma unroll
    for (int i = 0; i < NIF; ++i) q[i] = r[i][c];
#pragma unroll
    for (int j = 0; j < 8; ++j) qm2_add_onset<NIF, SPN>(wl, q, j, acc);
  }
  const int rest = n_onsets & 7;
  if (rest) {
    uint4 q[NIF];
#pragma unroll
    for (int i = 0; i < NIF; ++i) q[i] = r[i][chunks];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (j < rest) qm2_add_onset<NIF, SPN>(wl, q, j, acc);
    }
  }
}

// The staging of one block of the window [col0, col0 + window_length)'s
// chunk from sample t_begin on, for node tile tile_i: the window offsets
// `off`, `valid` into `vld`, the uint16 slab and each onset's window of
// r_spans[o] + cw floats, then the zeros the lanes past cw read (32 SPN -
// cw floats). Ends with every copy landed and a barrier. M1 v2 and M2
// share it.
template <int SPN>
__device__ __forceinline__ void qm2_stage(
    int* off, float* vld, unsigned short* slab, float* win,
    const float* __restrict__ L, int t_len, const int* __restrict__ base,
    const short* __restrict__ fine16, const float* __restrict__ valid,
    const int* __restrict__ span_off, int n_onsets, int tile, int col0,
    int window_length, int tile_i, int t_begin) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = qv_row(n_onsets);
  // Onset o's window spans r_spans[o] + cw floats: K1 v2's offsets, each
  // window QM2_CHUNK - cw floats narrower
  const int shrink = QM2_CHUNK - qm2_chunk_width(window_length);

  for (int o = tid; o <= n_onsets; o += QM_THREADS) {
    off[o] = span_off[o] - o * shrink;
  }
  for (int n = tid; n < tile; n += QM_THREADS) {
    vld[n] = valid[(long long)tile_i * tile + n];
  }
  // Onset o's window, warp o % QM_NWARPS, lanes on consecutive samples,
  // by 4-byte asynchronous copies that land while the slab is staged.
  // Reads past the row end become 0: they feed only samples beyond the
  // window (the host checks col0 + max shift + len <= t_len).
  const int* base_i = base + (long long)tile_i * n_onsets;
  for (int o = warp; o < n_onsets; o += QM_NWARPS) {
    const int w0 = span_off[o] - o * shrink;
    const int width = span_off[o + 1] - span_off[o] - shrink;
    const long long c0 = (long long)col0 + base_i[o] + t_begin;
    const float* src = L + (long long)o * t_len;
    for (int c = lane; c < width; c += 32) {
      const long long col = c0 + c;
      const bool inside = col < t_len;
      qm_cp_async4(win + w0 + c, src + (inside ? col : 0), inside);
    }
  }
  qm_cp_async_commit();
  __syncthreads();
  // The lanes of samples at or past cw read up to 32 SPN - cw floats
  // past the last window: zeros, whose sums no lane keeps.
  for (int c = tid; c < 32 * SPN - (QM2_CHUNK - shrink); c += QM_THREADS) {
    win[off[n_onsets] + c] = 0.0f;
  }
  // The slab, from 16-byte loads of the tile's [tile, O] residuals (8
  // elements each; tile % 16 == 0 keeps them aligned), QM2_STAGE a thread
  // in flight: element k is (n, o) = (k / O, k % O).
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        fine16 + (long long)tile_i * tile * n_onsets);
    const int n16 = tile * n_onsets / 8;
    for (int b = tid; b < n16; b += QM2_STAGE * QM_THREADS) {
      uint4 v[QM2_STAGE];
#pragma unroll
      for (int u = 0; u < QM2_STAGE; ++u) {
        const int j = b + u * QM_THREADS;
        v[u] = j < n16 ? src[j] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < QM2_STAGE; ++u) {
        const int j = b + u * QM_THREADS;
        if (j >= n16) break;
        int n = (8 * j) / n_onsets;
        int o = 8 * j - n * n_onsets;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          slab[n * row + o] =
              static_cast<unsigned short>(off[o] + qv_entry(v[u], e));
          if (++o == n_onsets) {
            o = 0;
            ++n;
          }
        }
      }
    }
  }
  qm_cp_async_wait<0>();
  __syncthreads();
}

template <int NIF, int SPN>
__global__ void __launch_bounds__(QM_THREADS)
qm_migrate_marginalise_v2_kernel(const float* __restrict__ L, int t_len,
                                 const int* __restrict__ base,
                                 const short* __restrict__ fine16,
                                 const float* __restrict__ valid,
                                 const int* __restrict__ perm,
                                 const float* __restrict__ inv_available,
                                 const int* __restrict__ span_off,
                                 float* __restrict__ dst, int n_nodes,
                                 int n_onsets, int tile, int col0,
                                 int window_length) {
  extern __shared__ __align__(16) unsigned char qm2_smem[];
  const int row = qv_row(n_onsets);
  int* off = reinterpret_cast<int*>(qm2_smem);
  float* vld = reinterpret_cast<float*>(off + ((n_onsets + 4) & ~3));
  unsigned short* slab = reinterpret_cast<unsigned short*>(vld + tile);
  float* win = reinterpret_cast<float*>(slab + tile * row);
  const int tile_i = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // This chunk's samples [t_begin, t_begin + t_count) of the window
  const int t_begin = chunk * QM2_CHUNK;
  const int t_count = min(QM2_CHUNK, window_length - t_begin);
  qm2_stage<SPN>(off, vld, slab, win, L, t_len, base, fine16, valid,
                 span_off, n_onsets, tile, col0, window_length, tile_i,
                 t_begin);

  const float inv = *inv_available;
  const float* wl = win + lane;
  const uint4* slab4 = reinterpret_cast<const uint4*>(slab);
  const int row4 = row >> 3;
  const int* perm_i = perm + (long long)tile_i * tile;
  float* dst_c = dst + (long long)chunk * n_nodes;
  // Warp w's group: nodes n0 + QM_NWARPS i, i < NIF
  for (int n0 = warp; n0 < tile; n0 += QM_NWARPS * NIF) {
    const uint4* r[NIF];
    bool real[NIF];
    bool any = false;
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
      const int n = n0 + QM_NWARPS * i;
      real[i] = n < tile && vld[n] != 0.0f;
      any |= real[i];
      r[i] = slab4 + (n < tile ? n : n0) * row4;
    }
    if (!any) continue;  // warp-uniform: a group of padding nodes
    // Lane i's node's flat index, loaded before the gather
    const int mine_n = n0 + QM_NWARPS * lane;
    const int flat = lane < NIF && mine_n < tile ? perm_i[mine_n] : 0;
    float acc[NIF][SPN];
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
#pragma unroll
      for (int k = 0; k < SPN; ++k) acc[i][k] = 0.0f;
    }
    qm2_gather<NIF, SPN>(wl, r, n_onsets, acc);

    float total[NIF];
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
      total[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < SPN; ++k) {
        if (lane + 32 * k < t_count) total[i] += expf(acc[i][k] * inv);
      }
    }
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        total[i] += __shfl_xor_sync(0xffffffffu, total[i], d);
      }
    }
    // Lane i stores node i of the group
    float mine = total[0];
    bool store = real[0];
#pragma unroll
    for (int i = 1; i < NIF; ++i) {
      if (lane == i) {
        mine = total[i];
        store = real[i];
      }
    }
    if (lane < NIF && store) dst_c[flat] = mine;
  }
}

// The kernel of (nodes in flight, slots a node) at this window length:
// (4, 1) up to 32 samples, (4, 2) up to 64, (2, 4) beyond.
typedef void (*Qm2Kernel)(const float*, int, const int*, const short*,
                          const float*, const int*, const float*, const int*,
                          float*, int, int, int, int, int);

static Qm2Kernel qm2_kernel(int window_length) {
  switch (qm2_slots(qm2_chunk_width(window_length))) {
    case 1:
      return qm_migrate_marginalise_v2_kernel<4, 1>;
    case 2:
      return qm_migrate_marginalise_v2_kernel<4, 2>;
    default:
      return qm_migrate_marginalise_v2_kernel<2, 4>;
  }
}

// L: f32 [n_onsets, t_len]; base: int32 [n_tiles, n_onsets]; fine16:
// int16 [n_tiles, tile, n_onsets]; valid: f32 [n_tiles, tile]; perm:
// int32 [n_tiles * tile], each real node's flat index; inv_available: f32
// [1]; span_off: K1 v2's int32 [n_onsets + 1] window offsets (span_off[0]
// = 0, span_off[o + 1] - span_off[o] >= r_spans[o] + QM_SBLK,
// span_off[n_onsets] = win_floats); out: f32 [n_nodes], every real node
// written once; partial: f32 [partial_rows, n_nodes], used where the
// window spans more than one chunk of QM2_CHUNK samples (partial_rows at
// least the chunk count), else unread and may be null. The host checks
// that col0 + max(base + fine) + window_length <= t_len.
extern "C" int qm_migrate_marginalise_v2(
    const void* L, int t_len, const void* base, const void* fine16,
    const void* valid, const void* perm, const void* inv_available,
    const void* span_off, void* out, void* partial, int partial_rows,
    int n_nodes, int n_onsets, int n_tiles, int tile, int col0,
    int window_length, int win_floats, void* stream) {
  const int n_chunks =
      window_length > QM2_CHUNK ? (window_length + QM2_CHUNK - 1) / QM2_CHUNK
                                : 1;
  const int win2 = qm2_win_floats(n_onsets, win_floats, window_length);
  const Qm2Kernel kernel = qm2_kernel(window_length);
  if (n_onsets < 1 || n_tiles < 1 || tile < 16 || tile % 16 != 0 ||
      n_nodes < 1 || col0 < 0 || window_length < 0 ||
      win_floats < n_onsets * (QM_SBLK + 1) || win_floats > 65535 ||
      (n_chunks > 1 && (partial == nullptr || partial_rows < n_chunks))) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = qm2_smem_bytes(n_onsets, tile, win2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(n_chunks > 1 ? partial : out);
  kernel<<<dim3(n_tiles, n_chunks), QM_THREADS, smem, s>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const short*>(fine16), static_cast<const float*>(valid),
      static_cast<const int*>(perm),
      static_cast<const float*>(inv_available),
      static_cast<const int*>(span_off), dst, n_nodes, n_onsets, tile, col0,
      window_length);
  if (n_chunks > 1) {
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    qm_marginalise_sum_chunks_kernel<<<(n_nodes + 255) / 256, 256, 0,
                                          s>>>(
        static_cast<const float*>(partial), n_chunks, n_nodes,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel a launch at this geometry takes,
// from the occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_marginalise_v2_blocks_per_sm(int n_onsets,
                                                       int tile,
                                                       int win_floats,
                                                       int window_length) {
  const Qm2Kernel kernel = qm2_kernel(window_length);
  const int smem = qm2_smem_bytes(
      n_onsets, tile, qm2_win_floats(n_onsets, win_floats, window_length));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// ---------------------------------------------------------------------------
// M2: the coalescence map of locate's map path, a store epilogue on M1 v2's
// staging.
//
// Replaces the XLA function migrate_map (quakemigrate_tpu/ops/migrate.py:264),
// which has no Pallas kernel: it builds every node tile's coalescence over
// the scan window and keeps it, the flat-node map4d [N, S]. Contract, per
// real node n of tile i of the detect plan and scan sample t < nsamples:
//
//   map[perm[n], t] = exp(inv_available *
//                      sum_{o=0}^{O-1} L[o, col0 + base[i,o] + fine[i,o,n] + t])
//
// with col0 = fsmp; padding nodes write nothing, and every real node's row
// is written whole. The onsets are summed in order o = 0..O-1 in float32
// and each sample's value is expf(__fmul_rn(acc, inv)), as K1 v2's fold
// (detect_v2_core.cuh: qv_fold) computes it, so the per-sample max over
// the map's nodes equals K1 v2's tmax bit for bit, and a sum over a window
// of the map equals M1 v2's up to the order of the additions.
//
// Bound on the card: the output, N x S floats written once (63 MB at the
// Icequake locate window), then the gather (node x onset x sample 4-byte
// reads from the staged windows). The design is M1 v2's: one block a
// (node tile, chunk of QM2_CHUNK samples), the staging of qm2_stage, lanes
// on samples and NIF nodes a warp in flight (qm2_map_kernel: M1 v2's shape
// a slot count); in place of the chunk sum each lane stores its samples
// straight into its node's row, so a warp writes 32 consecutive floats of
// one row a store. There is no chunk sum: a window of several chunks takes
// one block a chunk, each writing its own columns.
template <int NIF, int SPN>
__global__ void __launch_bounds__(QM_THREADS)
qm_migrate_map_v2_kernel(const float* __restrict__ L, int t_len,
                         const int* __restrict__ base,
                         const short* __restrict__ fine16,
                         const float* __restrict__ valid,
                         const int* __restrict__ perm,
                         const float* __restrict__ inv_available,
                         const int* __restrict__ span_off,
                         float* __restrict__ map, int n_onsets, int tile,
                         int col0, int nsamples) {
  extern __shared__ __align__(16) unsigned char qm2_smem[];
  const int row = qv_row(n_onsets);
  int* off = reinterpret_cast<int*>(qm2_smem);
  float* vld = reinterpret_cast<float*>(off + ((n_onsets + 4) & ~3));
  unsigned short* slab = reinterpret_cast<unsigned short*>(vld + tile);
  float* win = reinterpret_cast<float*>(slab + tile * row);
  const int tile_i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This chunk's samples [t_begin, t_begin + t_count) of the scan
  const int t_begin = blockIdx.y * QM2_CHUNK;
  const int t_count = min(QM2_CHUNK, nsamples - t_begin);
  qm2_stage<SPN>(off, vld, slab, win, L, t_len, base, fine16, valid,
                 span_off, n_onsets, tile, col0, nsamples, tile_i, t_begin);

  const float inv = *inv_available;
  const float* wl = win + lane;
  const uint4* slab4 = reinterpret_cast<const uint4*>(slab);
  const int row4 = row >> 3;
  const int* perm_i = perm + (long long)tile_i * tile;
  // Warp w's group: nodes n0 + QM_NWARPS i, i < NIF
  for (int n0 = warp; n0 < tile; n0 += QM_NWARPS * NIF) {
    const uint4* r[NIF];
    bool real[NIF];
    bool any = false;
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
      const int n = n0 + QM_NWARPS * i;
      real[i] = n < tile && vld[n] != 0.0f;
      any |= real[i];
      r[i] = slab4 + (n < tile ? n : n0) * row4;
    }
    if (!any) continue;  // warp-uniform: a group of padding nodes
    // Lane i's node's flat index, loaded before the gather
    const int mine_n = n0 + QM_NWARPS * lane;
    const int flat = lane < NIF && mine_n < tile ? perm_i[mine_n] : 0;
    float acc[NIF][SPN];
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
#pragma unroll
      for (int k = 0; k < SPN; ++k) acc[i][k] = 0.0f;
    }
    qm2_gather<NIF, SPN>(wl, r, n_onsets, acc);

    // Each real node's samples into its row: lane j writes t_begin + j +
    // 32 k, so a warp stores 32 consecutive floats of the row at once
#pragma unroll
    for (int i = 0; i < NIF; ++i) {
      const int node_row = __shfl_sync(0xffffffffu, flat, i);
      if (!real[i]) continue;  // warp-uniform
      float* out = map + (long long)node_row * nsamples + t_begin + lane;
#pragma unroll
      for (int k = 0; k < SPN; ++k) {
        // __fmul_rn: no contraction into expf's range reduction, as in
        // K1 v2's fold
        if (lane + 32 * k < t_count) {
          out[32 * k] = expf(__fmul_rn(acc[i][k], inv));
        }
      }
    }
  }
}

typedef void (*Qm2MapKernel)(const float*, int, const int*, const short*,
                             const float*, const int*, const float*,
                             const int*, float*, int, int, int, int);

// M2's kernel at a scan of nsamples samples: M1 v2's shape for the chunk
// width min(nsamples, QM2_CHUNK) (qm2_kernel).
static Qm2MapKernel qm2_map_kernel(int nsamples) {
  switch (qm2_slots(qm2_chunk_width(nsamples))) {
    case 1:
      return qm_migrate_map_v2_kernel<4, 1>;
    case 2:
      return qm_migrate_map_v2_kernel<4, 2>;
    default:
      return qm_migrate_map_v2_kernel<2, 4>;
  }
}

// L, t_len, base, fine16, valid, perm, inv_available and span_off as for
// qm_migrate_marginalise_v2; map: f32 [n_nodes, nsamples], each real
// node's row written whole (rows of nodes no tile holds are not touched).
// The host checks that col0 + max(base + fine) + nsamples <= t_len.
extern "C" int qm_migrate_map_v2(const void* L, int t_len, const void* base,
                                 const void* fine16, const void* valid,
                                 const void* perm, const void* inv_available,
                                 const void* span_off, void* map,
                                 int n_onsets, int n_tiles, int tile,
                                 int col0, int nsamples, int win_floats,
                                 void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 16 || tile % 16 != 0 ||
      col0 < 0 || nsamples < 1 || win_floats < n_onsets * (QM_SBLK + 1) ||
      win_floats > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = (nsamples + QM2_CHUNK - 1) / QM2_CHUNK;
  const int smem = qm2_smem_bytes(
      n_onsets, tile, qm2_win_floats(n_onsets, win_floats, nsamples));
  const Qm2MapKernel kernel = qm2_map_kernel(nsamples);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_tiles, n_chunks), QM_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const short*>(fine16), static_cast<const float*>(valid),
      static_cast<const int*>(perm),
      static_cast<const float*>(inv_available),
      static_cast<const int*>(span_off), static_cast<float*>(map), n_onsets,
      tile, col0, nsamples);
  return (int)cudaGetLastError();
}
