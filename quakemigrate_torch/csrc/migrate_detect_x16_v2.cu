// Shifted-copy detect kernel redesigned for Hopper (sm_90a): E2 v2, on
// K1 v2's slab (detect_v2_core.cuh) with one 16-byte read a node-onset.
//
// Replaces the TPU experiment kernel _x16_kernel
// (experiments/exp_x16.py:46), which keeps a stride-16 table so that its
// matmul operand can be rebuilt with static lane-offset copies, as v1
// (migrate_detect_x16.cu) does. Contract: K1's (migrate_detect.cu), bit
// for bit (tmax, targ, tsum), with K1 v2's one exception
// (migrate_detect_v2.cu: padding nodes are not gathered).
//
// Bound on the card: the shared-memory pipe of the gather. A 16-byte read
// by 32 lanes is four wavefronts, as many as four 4-byte reads, so the
// shared-read floor of the function (22.27 ms at 30,000 samples on the
// day-scale window) is K1 v2's. What a 16-byte read can save is
// instructions: v1 spent 16 a node-onset (a warp-uniform LDG of the
// residual, `f & 3` and the copy's offset per node-onset) and held 3
// blocks an SM behind two block barriers of its own staging. What this
// design does about it:
//
// 1. The address leaves the loop. A host slab, uint16 [n_tiles, tile,
//    qv_row(O)], holds for node n and onset o the float offset of its
//    aligned 16-byte read in the block's copies: with a = (fsmp +
//    base[i, o]) & 3, u = a + fine and c = u & 3, the entry is
//    coff[c][o] + u - c. Lane l reads copies[entry + 4 l .. + 3], which
//    is copy c's window at u - c + 4 l, the staged samples u + 4 l .. + 3:
//    register k of lane l holds block sample 4 l + k. The loop reads a
//    node's row as broadcast 16-byte chunks (8 onsets a chunk) and
//    runs one LDS.128 and four FADDs a node-onset, no other load and no
//    arithmetic beyond the entry's extraction and the address.
// 2. Two nodes a warp iteration, K1 v2's pairs (n, n + 8), folded n then
//    n + 8, so each thread sees its nodes in K1's order.
// 3. Per-onset widths w_o = round_up(r_spans[o] + 3 + QM_SBLK, 4) for each
//    shifted copy; the layout (copy-major x16a or onset-major x16b) lives
//    only in the host's copy-offset table coff [4, O] and in the slab.
// 4. Staging: copy 0 of every onset arrives by TMA from the column
//    fsmp + base[i, o] + s0 rounded down to 4 (a tiled load's inner start
//    must be 16-byte aligned, tma_rows.cuh), in boxes of 32 floats at
//    128-byte-aligned offsets, with `valid` by one bulk copy, all on one
//    mbarrier; columns past t_len arrive as 0. No asynchronous copy
//    shifts by 4 bytes, so copies 1-3 (copy_c[x] = copy_0[x + c]) are
//    built shared-to-shared by all 8 warps, 4-byte conflict-free reads
//    and writes, behind one block barrier. That pass moves 3 x sum(w_o)
//    floats, about 1.5 % of the block's gather reads, and the other
//    blocks resident on the SM gather meanwhile; a single warp doing it
//    would make the other seven wait eight times as long.
// 5. Occupancy: the four copies take 4 x sum(w_o) floats plus copy 0's
//    rounding to 32 (64.7 KB at 24 onsets, tile 512, sum r_o = 779, in
//    x16a; 66.0 KB in x16b), valid 2 KB. The slab stays in global memory,
//    read through L1 as broadcast uint4 (1/256 of the gather's bytes):
//    in shared memory it would add 24.6 KB and leave 2 blocks (16 warps)
//    an SM instead of 3 (24). The cross-warp reduction's 12 KB scratch
//    aliases the copies after the gather's last read.
// 6. The epilogue: register k holds block sample 4 l + k (K1 v2's holds
//    l + 32 k), so the cross-warp reduction here stores its partials by
//    that mapping, one 16-byte store a lane per array.
//
// The kernel is a template on the reduction variant, as K1 v2 is:
// QM_FULL, QM_NOREDUCE (tmax = acc of node 0, tsum = acc of node 1, 0 at
// padding nodes) and QM_NOGATHER (copy 0 of the windows at residual 0).

#include "detect_v2_core.cuh"
#include "tma_rows.cuh"

// Resident blocks per SM the kernel is built for.
#define QX2_MIN_BLOCKS 3

// Width, in floats, of one TMA box of copy 0.
#define QX2_BOX 32

// Ints of the block's copy of the host table: coff [4, O], then w [O],
// rounded up to 4.
__host__ __device__ __forceinline__ int qx2_tab_ints(int n_onsets) {
  return (5 * n_onsets + 3) & ~3;
}

// Dynamic shared memory of a block: 128 bytes of alignment slack, the
// copies (or the reduction scratch that aliases them, whichever is
// larger), valid, the table and one mbarrier.
static int qx2_smem_bytes(int n_onsets, int tile, int copy_floats) {
  const int copies =
      copy_floats > QM_RED_FLOATS ? copy_floats : QM_RED_FLOATS;
  return 128 + 4 * copies + 4 * tile + 4 * qx2_tab_ints(n_onsets) + 8;
}

// Onset o's window at residual 0 (QM_NOGATHER): copy 0 plus the 0-3
// floats by which the window's first column lies past the multiple of 4
// that its load started from.
struct Qx2Offsets {
  const int* coff0;
  int lead;  // fsmp
  const int* base_i;
  __device__ __forceinline__ int operator()(int o) const {
    return coff0[o] + ((lead + base_i[o]) & 3);
  }
};

// Adds onset j of node a's slab chunk qa into `a` and, for NN = 2, of
// node b's chunk qb into `b`: one aligned 16-byte read a lane each.
template <int NN>
__device__ __forceinline__ void qx2_add_onset(const float* cl, const uint4& qa,
                                              const uint4& qb, int j,
                                              float (&a)[QM_SPT],
                                              float (&b)[QM_SPT]) {
  const float4 va = *reinterpret_cast<const float4*>(cl + qv_entry(qa, j));
  a[0] += va.x;
  a[1] += va.y;
  a[2] += va.z;
  a[3] += va.w;
  if (NN == 2) {
    const float4 vb = *reinterpret_cast<const float4*>(cl + qv_entry(qb, j));
    b[0] += vb.x;
    b[1] += vb.y;
    b[2] += vb.z;
    b[3] += vb.w;
  }
}

// The gather of node a (global slab row ra) and, for NN = 2, node b (row
// rb) together: onsets in order o = 0..O-1 for each node.
template <int NN>
__device__ __forceinline__ void qx2_gather(const float* cl, const uint4* ra,
                                           const uint4* rb, int n_onsets,
                                           float (&a)[QM_SPT],
                                           float (&b)[QM_SPT]) {
  const int chunks = n_onsets >> 3;
  for (int c = 0; c < chunks; ++c) {
    const uint4 qa = __ldg(ra + c);
    const uint4 qb = NN == 2 ? __ldg(rb + c) : qa;
#pragma unroll
    for (int j = 0; j < 8; ++j) qx2_add_onset<NN>(cl, qa, qb, j, a, b);
  }
  const int rest = n_onsets & 7;
  if (rest) {
    const uint4 qa = __ldg(ra + chunks);
    const uint4 qb = NN == 2 ? __ldg(rb + chunks) : qa;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      if (j < rest) qx2_add_onset<NN>(cl, qa, qb, j, a, b);
    }
  }
}

// The cross-warp reduction of the partials, qv_reduce_warps with register
// k of lane l at block sample 4 l + k: thread tid < QM_SBLK stores sample
// s0 + tid of row `out_row`. `red` (QM_RED_FLOATS floats, 16-byte
// aligned) aliases the copies: the first barrier ends every read of them.
template <int V>
__device__ __forceinline__ void qx2_reduce_warps(
    const QvPartial& p, float* red, float* __restrict__ tmax,
    int* __restrict__ targ, float* __restrict__ tsum, long long out_row,
    int s0, int nsamples) {
  static_assert(QM_SPT == 4, "one 16-byte read a lane covers QM_SBLK samples");
  const int tid = threadIdx.x;
  __syncthreads();

  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + QM_NWARPS * QM_SBLK);
  float* red_sum = red + 2 * QM_NWARPS * QM_SBLK;
  // thread tid = 32 warp + lane holds samples 4 lane .. 4 lane + 3 of its
  // warp's row: element 4 tid of each array
  reinterpret_cast<float4*>(red_max)[tid] =
      make_float4(p.best[0], p.best[1], p.best[2], p.best[3]);
  reinterpret_cast<int4*>(red_arg)[tid] =
      make_int4(p.arg[0], p.arg[1], p.arg[2], p.arg[3]);
  reinterpret_cast<float4*>(red_sum)[tid] =
      make_float4(p.total[0], p.total[1], p.total[2], p.total[3]);
  __syncthreads();

  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = 0;
    float s;
    if (V == QM_NOREDUCE) {
      // node 0 belongs to warp 0, node 1 to warp 1
      s = red_sum[QM_SBLK + tid];
    } else {
      a = red_arg[tid];
      s = red_sum[tid];
      for (int w = 1; w < QM_NWARPS; ++w) {
        const float mw = red_max[w * QM_SBLK + tid];
        const int aw = red_arg[w * QM_SBLK + tid];
        if (mw > m || (mw == m && aw < a)) {
          m = mw;
          a = aw;
        }
        s += red_sum[w * QM_SBLK + tid];
      }
    }
    tmax[out_row + s0 + tid] = m;
    targ[out_row + s0 + tid] = a;
    tsum[out_row + s0 + tid] = s;
  }
}

template <int V>
__global__ void __launch_bounds__(QM_THREADS, QX2_MIN_BLOCKS)
qm_x16_v2_kernel(const __grid_constant__ CUtensorMap map,
                 const int* __restrict__ base,
                 const unsigned short* __restrict__ slab_g,
                 const float* __restrict__ valid,
                 const int* __restrict__ tab_g,
                 const float* __restrict__ inv_available,
                 float* __restrict__ tmax, int* __restrict__ targ,
                 float* __restrict__ tsum, int n_onsets, int tile, int fsmp,
                 int nsamples, int copy_floats) {
  static_assert(V == QM_FULL || V == QM_NOREDUCE || V == QM_NOGATHER,
                "built for FULL, NOREDUCE and NOGATHER");
  extern __shared__ unsigned char qx2_raw[];
  unsigned char* smem = qx2_raw + ((128 - (wg_smem(qx2_raw) & 127)) & 127);
  const int copy_region =
      copy_floats > QM_RED_FLOATS ? copy_floats : QM_RED_FLOATS;
  float* copies = reinterpret_cast<float*>(smem);
  float* vld = copies + copy_region;
  int* tab = reinterpret_cast<int*>(vld + tile);  // coff [4][O], w [O]
  uint64_t* bar = reinterpret_cast<uint64_t*>(tab + qx2_tab_ints(n_onsets));
  const int* width = tab + 4 * n_onsets;

  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = qv_row(n_onsets);
  const int* base_i = base + (long long)tile_i * n_onsets;

  for (int k = tid; k < 5 * n_onsets; k += QM_THREADS) tab[k] = tab_g[k];
  if (tid == 0) {
    wg_bar_init(bar, 1);
    wg_bar_init_fence();
    wg_prefetch_map(&map);
  }
  __syncthreads();

  // Warp 0: valid by bulk copy, copy 0 of onset o (lane o % 32) in boxes
  // of QX2_BOX floats; lane 0 announces every byte first.
  if (warp == 0) {
    if (lane == 0) {
      uint32_t bytes = 4 * tile;
      for (int o = 0; o < n_onsets; ++o) {
        bytes += 4 * ((width[o] + QX2_BOX - 1) / QX2_BOX * QX2_BOX);
      }
      wg_bar_expect_tx(bar, bytes);
      qt_bulk_load(vld, valid + (long long)tile_i * tile, 4 * tile, bar);
    }
    __syncwarp();
    for (int o = lane; o < n_onsets; o += 32) {
      const int col = ((fsmp + base_i[o]) & ~3) + s0;
      float* dst = copies + tab[o];
      for (int f = 0; f < width[o]; f += QX2_BOX) {
        wg_tma_load_2d(dst + f, &map, bar, col + f, o);
      }
    }
  }
  wg_bar_wait(bar, 0);

  // Copies 1-3: copy_c[x] = copy_0[x + c] for x < w_o. The tail x + c >=
  // w_o is never read (a read of copy c ends at u + QM_SBLK - 1 - c,
  // u <= r_spans[o] + 2, so below w_o - c) and is zeroed.
  for (int r = warp; r < 3 * n_onsets; r += QM_NWARPS) {
    const int c = 1 + r / n_onsets;
    const int o = r - (c - 1) * n_onsets;
    const int w = width[o];
    const float* src = copies + tab[o];
    float* dst = copies + tab[c * n_onsets + o];
    for (int x = lane; x < w; x += 32) dst[x] = x + c < w ? src[x + c] : 0.0f;
  }
  __syncthreads();

  const long long out_row = (long long)tile_i * nsamples;
  if constexpr (V == QM_NOGATHER) {
    qm_staged_sum(copies, Qx2Offsets{tab, fsmp, base_i}, n_onsets, tmax, targ,
                  tsum, out_row, s0, nsamples);
  } else {
    const float inv = *inv_available;
    const float* cl = copies + 4 * lane;
    const unsigned short* slab_i = slab_g + (long long)tile_i * tile * row;
    QvPartial p;
    // QM_NOREDUCE keeps only nodes 0 and 1 (qv_fold); every node's sums
    // also enter a sink that reaches a partial only if it is -inf, so the
    // compiler keeps every gather (detect_v2_core.cuh, qv_sweep_tile).
    float sink = 0.0f;
    for (int n = warp; n < tile; n += 2 * QM_NWARPS) {
      const int m = n + QM_NWARPS;
      const float va = vld[n];
      const float vb = vld[m];
      float acc_n[QM_SPT], acc_m[QM_SPT];
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) acc_n[k] = acc_m[k] = 0.0f;
      const uint4* rn = reinterpret_cast<const uint4*>(slab_i + n * row);
      const uint4* rm = reinterpret_cast<const uint4*>(slab_i + m * row);
      if (va != 0.0f && vb != 0.0f) {
        qx2_gather<2>(cl, rn, rm, n_onsets, acc_n, acc_m);
      } else if (va != 0.0f) {
        qx2_gather<1>(cl, rn, rn, n_onsets, acc_n, acc_n);
      } else if (vb != 0.0f) {
        qx2_gather<1>(cl, rm, rm, n_onsets, acc_m, acc_m);
      }
      if (V == QM_NOREDUCE) {
#pragma unroll
        for (int k = 0; k < QM_SPT; ++k) sink += acc_n[k] + acc_m[k];
      }
      qv_fold<V>(p, acc_n, n, va, inv);
      qv_fold<V>(p, acc_m, m, vb, inv);
    }
    if (V == QM_NOREDUCE && sink == -INFINITY) p.best[0] = sink;
    qx2_reduce_warps<V>(p, copies, tmax, targ, tsum, out_row, s0, nsamples);
  }
}

template <int V>
static int qx2_launch(const CUtensorMap& map, const void* base,
                      const void* slab, const void* valid, const void* tab,
                      const void* inv_available, void* tmax, void* targ,
                      void* tsum, int n_onsets, int n_tiles, int tile,
                      int fsmp, int nsamples, int copy_floats,
                      cudaStream_t stream) {
  const auto kernel = qm_x16_v2_kernel<V>;
  const int smem = qx2_smem_bytes(n_onsets, tile, copy_floats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  kernel<<<grid, QM_THREADS, smem, stream>>>(
      map, static_cast<const int*>(base),
      static_cast<const unsigned short*>(slab),
      static_cast<const float*>(valid), static_cast<const int*>(tab),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples, copy_floats);
  return (int)cudaGetLastError();
}

// L: float32 [n_onsets, ld] (row pitch ld >= t_len, a multiple of 4,
// 16-byte aligned); base int32 [n_tiles, n_onsets]; slab uint16 [n_tiles,
// tile, round_up(n_onsets, 8)], entries below copy_floats (x16_v2_slab);
// valid float32 [n_tiles, tile]; tab int32 [5, n_onsets]: coff [4][O]
// (copy 0 at multiples of 32 floats, each copy 16-byte aligned) then the
// copies' widths w [O] (multiples of 4; copy 0 has room for w rounded up
// to 32). variant QM_FULL, QM_NOREDUCE or QM_NOGATHER (a QmVariant).
extern "C" int qm_migrate_detect_x16_v2(
    const void* L, int t_len, int ld, const void* base, const void* slab,
    const void* valid, const void* tab, const void* inv_available,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles, int tile,
    int fsmp, int nsamples, int copy_floats, int variant, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 2 * QM_NWARPS ||
      tile % (2 * QM_NWARPS) != 0 || nsamples < 1 ||
      copy_floats % QX2_BOX != 0 || copy_floats < 4 * n_onsets * QM_SBLK ||
      copy_floats > 65536 ||
      4 * copy_floats + 4 * tile > QT_MAX_TX_BYTES) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const int err = qt_row_map(&map, L, n_onsets, t_len, ld, QX2_BOX);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QX2_CASE(V)                                                           \
  case V:                                                                     \
    return qx2_launch<V>(map, base, slab, valid, tab, inv_available, tmax,    \
                         targ, tsum, n_onsets, n_tiles, tile, fsmp,           \
                         nsamples, copy_floats, s);
  switch (variant) {
    QX2_CASE(QM_FULL)
    QX2_CASE(QM_NOREDUCE)
    QX2_CASE(QM_NOGATHER)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QX2_CASE
}

// Resident blocks per SM of the FULL kernel at this geometry, from the
// occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_x16_v2_blocks_per_sm(int n_onsets, int tile,
                                                      int copy_floats) {
  const int smem = qx2_smem_bytes(n_onsets, tile, copy_floats);
  cudaError_t err = cudaFuncSetAttribute(
      qm_x16_v2_kernel<QM_FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qm_x16_v2_kernel<QM_FULL>, QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
