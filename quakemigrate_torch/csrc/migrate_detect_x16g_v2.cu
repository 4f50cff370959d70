// Stride-16 table detect on Hopper's warpgroup tensor cores ("X16G v2"),
// for sm_90a.
//
// Replaces the TPU experiment kernel _x16g_kernel
// (experiments/exp_x16g.py:53) with the function, inputs and outputs of
// migrate_detect_x16g.cu (v1, mma.sync), which stays as its yardstick: the
// detect contract in bf16 hi/lo numerics read through the stride-16 tables
// on the 16-aligned plan. With coarse row m = (o, q) (a_off[o] <= m <
// a_off[o + 1], q = m - a_off[o]), G[m][x] = table[want[m]][s0 + x] and the
// one-hot A[n, (m, b)] = (fine16[o, n] == 16 q + b), per node n and sample t
// of a block:
//   acc[n, t] = sum_m sum_b A[n, (m, b)] (G_hi[m][b + t] + G_lo[m][b + t])
//   (k-steps m in order, hi then lo, into one f32 accumulator, as v1),
//   coa[n, t] = exp(acc * inv) * valid[n];  tmax, first argmax, sum over n.
//
// Bound on the card: the tensor cores, 4 K flop per padded node and padded
// sample (K = 16 a_sum, hi and lo) at 989 TFLOP/s bf16 dense. v1 reached 40
// % of it: mma.sync with 16-node warp tiles reads every B fragment once per
// 16 nodes, and its expand form rebuilt each onset's Hankel block in every
// 128-node pass.
//
// Design.
// - One block per (tile, 64 samples). The block owns the whole tile (up to
//   512 nodes), so each k-step's B is built once for all of them. Two
//   warpgroups, 256 threads: no warp is set apart to produce, because
//   ptxas fits every warp in the block's register count at launch (it
//   does not give the code after setmaxnreg.inc more), and at 256 threads
//   that count is 255, room for 128 accumulators, where 384 threads leave
//   168 and the products are serialized.
// - wgmma m64n64k16: nodes are M, samples N, K the (m, b) rows, one k16
//   step per coarse row m. Warpgroup cw has four m64 tiles, 4 x 32
//   f32 accumulators a thread. Thread (warp w of its warpgroup, group g,
//   quad c) holds rows 16 w + g + 8 h of tile i, which are the 8
//   consecutive nodes 256 cw + 64 w + 8 g + 2 i + h.
// - A, the one-hot, from registers (the RS form): the thread's m16k16
//   fragment rows of each tile, selected by compares from its nodes'
//   fine16. A node's fine16 gives one word, at one coarse row q, in one of
//   the fragment's two column halves, so the onset's one-hot is 2 words a
//   node; the next onset's fine16 (32 bytes) comes into shared memory by
//   cp.async one onset ahead. Nodes at or past `tile` read as coarse row
//   -1, so their A is zero, and the epilogue skips them. One A feeds both
//   products of a step, hi and lo, and is double-buffered across k-steps:
//   the next step's fragments are built while this step's products run
//   (wgmma.wait_group 1). Every product is issued unconditionally (a
//   branch around wgmma makes ptxas serialize them).
// - B, the Hankel tile B[b, t] = G[m][b + t], 16 x 64 bf16, MN-major with
//   the 128-byte swizzle: one 128-byte row per k, chunk j (8 samples) of
//   row b stored at chunk j ^ (b & 7) of its 1024-byte atom (the pattern
//   TMA writes). A step's two tiles (hi, lo; 4 KB) go into a ring of
//   QW_STAGES stages with full and empty mbarriers, built QW_AHEAD steps
//   ahead by the whole block in its step loop: thread (half, b, j) writes
//   chunk j of row b, 5 words of its row funnel-shifted by the parity of b.
//   The ordinary shared stores reach wgmma's async proxy through
//   fence.proxy.async before the thread arrives on the full barrier.
// - Uniform control flow. ptxas serializes the products when a register
//   they read is defined under a branch it cannot prove uniform, and a
//   warp index or a value loaded from memory is not uniform to it. So
//   every thread builds a part of every step (no warp set apart for it), the
//   onset offsets a_off are a kernel parameter (the onset loop's bounds
//   are uniform), and the fine16 fetch and load select instead of
//   branching.
// - Staging: every thread copies rows want[m] of hi and lo, columns [s0,
//   s0 + 80), with cp.async (26.9 KB at 84 rows).
// - Epilogue: coa = __fmul_rn(expf(__fmul_rn(acc, inv)), valid) as v1; per
//   sample first the thread's 8 nodes in order, then shuffles over the
//   groups (xor 4, 8, 16), then the 8 warps in shared memory,
//   always with v1's tie rule (larger value, or equal value and smaller
//   node). Samples at or past nsamples are not written.
// - Registers: 128 accumulators, two A buffers of 16, the onset's 16
//   one-hot words and the Hankel build's 8 words, in one block per SM.
// - Ablations (template ABL): nomain skips the products (acc = 0; the
//   ring runs and the one-hot is built), noreduce writes acc of nodes 0,
//   1, 2 (the middle one as int32) in place of tmax, targ, tsum. ptxas
//   drops work whose result no instruction reads, so each folds what it
//   must keep into a store that no input triggers.

#include "detect_core.cuh"
#include "mma_core.cuh"
#include "wgmma_core.cuh"

#define QW_N 64           // samples a block: wgmma's N
#define QW_PITCH 80       // bf16 a staged row: 64 samples + 16 residues
#define QW_WARPS 8
#define QW_STAGES 8
#define QW_AHEAD 4        // steps between a stage's build and its products
#define QW_MAX_ONSETS 255
#define QW_TILE_MAX 512   // two warpgroups x 4 m64 tiles
#define QW_THREADS (32 * QW_WARPS)
#define QW_B_BYTES 2048   // one Hankel tile: 16 k rows x 64 bf16
#define QW_STAGE_BYTES (2 * QW_B_BYTES)  // hi and lo
#define QW_RED_BYTES (3 * 8 * QW_N * 4)
#define QW_FINE_BYTES (2 * QW_THREADS * 8 * 4)  // two onsets x 8 nodes
#define QW_NO_NODE (-16)  // fine16 of a node past the tile: coarse row -1

enum QwAblate { QW_FULL = 0, QW_NOMAIN = 1, QW_NOREDUCE = 2 };

// Shared-memory layout of a block, in bytes from the 1024-aligned base
// (mirrored on the host by ops/cuda_x16g.x16g_v2_smem): the ring at 0, the
// threads' fine16 buffers, the staged rows (hi rows, then lo rows,
// QW_PITCH bf16 each), the cross-warp reduction, the full and empty
// barriers; the total adds 1024 bytes for aligning the base.
struct QwLayout {
  int fine_off, g_off, red_off, bar_off, total;
};

// The prefix sums of A_o, as a kernel parameter.
struct QwOnsets {
  int a_off[QW_MAX_ONSETS + 1];
};

__host__ __device__ inline int qw_round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline QwLayout qw_layout(int a_sum) {
  QwLayout l;
  l.fine_off = QW_STAGES * QW_STAGE_BYTES;
  l.g_off = l.fine_off + QW_FINE_BYTES;
  l.red_off = qw_round_up(l.g_off + 2 * a_sum * QW_PITCH * 2, 16);
  l.bar_off = l.red_off + QW_RED_BYTES;
  l.total = l.bar_off + 2 * QW_STAGES * 8 + 1024;
  return l;
}

// The one-hot of the onset being read at the thread's 8 nodes: for node s,
// key[s] = 2 q + half, where q = fine16 / 16 is the coarse row it is read
// at and half says which register pair of the fragment row may hold its
// one (columns 2c, 2c + 1 or 2c + 8, 2c + 9), and word[s] that register's
// value at that row (0 when the one is in another quad's columns). Past
// the tile fine16 is QW_NO_NODE, so key is -2 and matches no k-step.
struct QwHot {
  int key[8];
  unsigned word[8];
};

__device__ __forceinline__ void qw_hot_load(QwHot& h, const int* f, int c) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int r = (f[s] & 15) - 2 * c;
    const int half = r >= 8;
    const int x = r - 8 * half;  // 0 or 1 where the one is this thread's
    h.key[s] = 2 * (f[s] >> 4) + half;
    h.word[s] = x == 0 ? QT_BF16_ONE : (x == 1 ? QT_BF16_ONE << 16 : 0u);
  }
}

// A fragments of the four m64 tiles at coarse row q: row g of tile i is
// node slot 2 i, row g + 8 slot 2 i + 1.
__device__ __forceinline__ void qw_build(unsigned (&a)[4][4], const QwHot& h,
                                         int q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ka = h.key[2 * i], kb = h.key[2 * i + 1];
    a[i][0] = ka == 2 * q ? h.word[2 * i] : 0u;
    a[i][1] = kb == 2 * q ? h.word[2 * i + 1] : 0u;
    a[i][2] = ka == 2 * q + 1 ? h.word[2 * i] : 0u;
    a[i][3] = kb == 2 * q + 1 ? h.word[2 * i + 1] : 0u;
  }
}

// 16-byte asynchronous copy global -> shared of `bytes` (16 or 0) bytes
// from src, the rest zero-filled.
__device__ __forceinline__ void qw_cp_async16(void* dst, const void* src,
                                              int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// A store that no input triggers (the bit pattern of `x` is never all
// ones: fold results are sums of finite values or XORs of one-hot words),
// so that ptxas keeps the work that made `x`.
__device__ __forceinline__ void qw_keep(unsigned x, float* sink) {
  if (x == 0xFFFFFFFFu) *sink = __uint_as_float(x);
}

template <int ABL>
__global__ void __launch_bounds__(QW_THREADS, 1)
qm_migrate_detect_x16g_v2_kernel(
    const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
    int width, const int* __restrict__ want, int m_pad,
    const __grid_constant__ QwOnsets onsets, const int* __restrict__ fine,
    const float* __restrict__ valid, const float* __restrict__ inv_available,
    float* __restrict__ tmax, int* __restrict__ targ, float* __restrict__ tsum,
    int n_onsets, int tile, int nsamples, int a_sum) {
  extern __shared__ uint8_t qw_raw[];
  uint8_t* smem = qw_raw + ((1024 - (wg_smem(qw_raw) & 1023)) & 1023);
  const QwLayout lay = qw_layout(a_sum);
  uint8_t* ring = smem;
  __nv_bfloat16* g_buf = reinterpret_cast<__nv_bfloat16*>(smem + lay.g_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + QW_STAGES;

  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QW_N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long out_row = (long long)tile_i * nsamples;
  // the thread's 8 nodes n0 .. n0 + 7, shared by the 4 threads of a quad
  // (all inside the tile or all past it), and its two fine16 buffers
  const int n0 = 8 * (tid >> 2);
  const bool act = n0 < tile;
  const int* fine_n = fine + (long long)tile_i * n_onsets * tile + n0;
  int* fbuf = reinterpret_cast<int*>(smem + lay.fine_off) + 8 * tid;
  // the next onset's fine16 of the thread's nodes into buffer o & 1 (zeros
  // past the tile or the last onset, read as QW_NO_NODE by load_onset)
  auto fetch = [&](int o) {
    const bool real = act && o < n_onsets;
    const int* src = real ? fine_n + (long long)o * tile : fine;
    int* dst = fbuf + (o & 1) * (QW_THREADS * 8);
    qw_cp_async16(dst, src, real ? 16 : 0);
    qw_cp_async16(dst + 4, real ? src + 4 : src, real ? 16 : 0);
    qm_cp_async_commit();
  };

  if (tid == 0) {
    for (int i = 0; i < QW_STAGES; ++i) {
      wg_bar_init(&full[i], QW_THREADS);  // every thread builds a chunk
      wg_bar_init(&empty[i], QW_WARPS);    // one arrival a warp
    }
    wg_bar_init_fence();
  }

  // Coarse select: rows want[m] of hi and lo, columns [s0, s0 + 80), 10
  // chunks of 16 bytes a row; and the fine16 of onsets 0 and 1.
  const int* want_i = want + (long long)tile_i * m_pad;
  for (int e = tid; e < 2 * a_sum * (QW_PITCH / 8); e += QW_THREADS) {
    const int row = e / (QW_PITCH / 8);
    const int chunk = e - row * (QW_PITCH / 8);
    const int half = row >= a_sum;
    const __nv_bfloat16* table = half ? lo : hi;
    qm_cp_async16(g_buf + row * QW_PITCH + 8 * chunk,
                  table + (long long)want_i[row - half * a_sum] * width + s0 +
                      8 * chunk);
  }
  fetch(0);
  fetch(1);
  qm_cp_async_wait<0>();
  __syncthreads();

  // This thread's chunk of the Hankel tiles of step mb, in stage mb %
  // QW_STAGES once every warp is done with the stage's last use: chunk j
  // (samples 8 j .. 8 j + 7) of row b of tile `half`, G[mb][b + 8 j ..],
  // at chunk j ^ (b & 7) of the row.
  const int half = tid >> 7, b_row = (tid >> 3) & 15, j = tid & 7;
  const int x0 = b_row + 8 * j;
  const unsigned* hank_src = reinterpret_cast<const unsigned*>(
      g_buf + half * a_sum * QW_PITCH) + (x0 >> 1);
  const int hank_dst = half * QW_B_BYTES + b_row * 128 +
                       ((j ^ (b_row & 7)) << 4);
  const unsigned shift = 16 * (x0 & 1);
  auto build_b = [&](int mb) {
    const int st = mb % QW_STAGES;
    const unsigned* w = hank_src + mb * (QW_PITCH / 2);
    const unsigned w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
    const uint4 out = make_uint4(
        __funnelshift_r(w0, w1, shift), __funnelshift_r(w1, w2, shift),
        __funnelshift_r(w2, w3, shift), __funnelshift_r(w3, w4, shift));
    wg_bar_wait(&empty[st], ((mb / QW_STAGES) & 1) ^ 1);
    *reinterpret_cast<uint4*>(ring + st * QW_STAGE_BYTES + hank_dst) = out;
    wg_fence_proxy_async();
    wg_bar_arrive(&full[st]);
  };
  for (int mb = 0; mb < QW_AHEAD && mb < a_sum; ++mb) build_b(mb);

  const int c = qt_quad(lane);
  float acc[4][32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;

  // The one-hot of onset o from buffer o & 1 (QW_NO_NODE past the tile).
  QwHot hot;
  auto load_onset = [&](int o) {
    const int4* src =
        reinterpret_cast<const int4*>(fbuf + (o & 1) * (QW_THREADS * 8));
    const int4 lo4 = src[0], hi4 = src[1];
    const int f[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
    int g[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) g[s] = act ? f[s] : QW_NO_NODE;
    qw_hot_load(hot, g, c);
  };
  load_onset(0);
  int o = 0, m_begin = 0, m_end = onsets.a_off[1];
  // The coarse row q of k-step m (called for m = 0, 1, ... in order),
  // moving the one-hot to the next onset where m starts one.
  auto advance = [&](int m) {
    if (m == m_end) {
      ++o;
      qm_cp_async_wait<0>();  // onset o, fetched one onset ago
      load_onset(o);
      fetch(o + 1);  // into the buffer onset o - 1 used
      m_begin = m_end;
      m_end = onsets.a_off[o + 1];
    }
    return m - m_begin;
  };

  int prev = -1;
  unsigned kept = 0u;  // nomain: the one-hot words, folded
  // Step m: the step's products on its stage, A from `a`; while they run,
  // this thread's chunk of step m + QW_AHEAD; then the stage of the step
  // before is released once its products are done.
  auto step = [&](int m, const unsigned (&a)[4][4]) {
    const int st = m % QW_STAGES;
    wg_bar_wait(&full[st], (m / QW_STAGES) & 1);
    if (ABL == QW_NOMAIN) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) kept ^= a[i][e];
      if (m + QW_AHEAD < a_sum) build_b(m + QW_AHEAD);
      if (lane == 0) wg_bar_arrive(&empty[st]);
    } else {
      const uint8_t* b = ring + st * QW_STAGE_BYTES;
      // MN-major, 128-byte swizzle: the second 8 k rows one atom (SBO 1024)
      // on; N = 64 is a single swizzle row, so LBO (the distance between
      // blocks of 64 columns) is never used.
      const uint64_t d_hi = wg_desc(b, 1024, 1024);
      const uint64_t d_lo = wg_desc(b + QW_B_BYTES, 1024, 1024);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wg_mma_m64n64k16_rs<1>(acc[i], a[i], d_hi);
        wg_mma_m64n64k16_rs<1>(acc[i], a[i], d_lo);
      }
      wg_commit();
      if (m + QW_AHEAD < a_sum) build_b(m + QW_AHEAD);
      wg_wait<1>();  // the step before is done: its A buffer and stage free
      if (lane == 0 && prev >= 0) wg_bar_arrive(&empty[prev]);
      prev = st;
    }
  };

  unsigned a0[4][4], a1[4][4];
  qw_build(a0, hot, advance(0));
  for (int m = 0; m < a_sum; m += 2) {
    step(m, a0);
    if (m + 1 < a_sum) {
      qw_build(a1, hot, advance(m + 1));
      step(m + 1, a1);
    }
    if (m + 2 < a_sum) qw_build(a0, hot, advance(m + 2));
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) wg_fence_regs(acc[i]);
  if (ABL == QW_NOMAIN) qw_keep(kept, tsum + out_row);

  // d[4 jj + 2 h + e] of tile i: node n0 + 2 i + h, sample 8 jj + 2 c + e
  if (ABL == QW_NOREDUCE) {
    float folded = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) folded += acc[i][e];
    qw_keep(__float_as_uint(folded), tsum + out_row);
    if (tid < 4) {  // nodes 0, 1, 2: slots 0, 1 (tile 0) and 2 (tile 1)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = s0 + 8 * jj + 2 * c + e;
          if (s < nsamples) {
            tmax[out_row + s] = acc[0][4 * jj + e];
            targ[out_row + s] = (int)acc[0][4 * jj + 2 + e];
            tsum[out_row + s] = acc[1][4 * jj + e];
          }
        }
    }
    return;
  }

  const float inv = *inv_available;
  float vn[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    vn[s] = act ? __ldg(valid + (long long)tile_i * tile + n0 + s) : 0.0f;
  }
  float* red_max = reinterpret_cast<float*>(smem + lay.red_off);
  int* red_arg = reinterpret_cast<int*>(red_max + 8 * QW_N);
  float* red_sum = red_max + 2 * 8 * QW_N;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = -INFINITY, total = 0.0f;
      int n = 0;
      if (act) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {  // nodes ascend: the first max stays
          const float x =
              __fmul_rn(expf(__fmul_rn(acc[s >> 1][4 * jj + 2 * (s & 1) + e],
                                       inv)),
                        vn[s]);
          if (x > v) {
            v = x;
            n = n0 + s;
          }
          total += x;
        }
      }
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, x);
        const int on = __shfl_xor_sync(0xffffffffu, n, x);
        total += __shfl_xor_sync(0xffffffffu, total, x);
        if (ov > v || (ov == v && on < n)) {
          v = ov;
          n = on;
        }
      }
      if (lane < 4) {
        const int t = warp * QW_N + 8 * jj + 2 * c + e;
        red_max[t] = v;
        red_arg[t] = n;
        red_sum[t] = total;
      }
    }
  }
  __syncthreads();
  if (tid < QW_N && s0 + tid < nsamples) {
    float m = red_max[tid], s = red_sum[tid];
    int a = red_arg[tid];
    for (int wi = 1; wi < 8; ++wi) {
      const float mw = red_max[wi * QW_N + tid];
      const int aw = red_arg[wi * QW_N + tid];
      if (mw > m || (mw == m && aw < a)) {
        m = mw;
        a = aw;
      }
      s += red_sum[wi * QW_N + tid];
    }
    tmax[out_row + s0 + tid] = m;
    targ[out_row + s0 + tid] = a;
    tsum[out_row + s0 + tid] = s;
  }
}

template <int ABL>
static int qw_launch(const void* hi, const void* lo, int width,
                     const void* want, int m_pad, const void* a_off,
                     const void* fine, const void* valid,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int tile,
                     int nsamples, int a_sum, cudaStream_t stream) {
  const int smem = qw_layout(a_sum).total;
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_x16g_v2_kernel<ABL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  QwOnsets onsets = {};
  for (int o = 0; o <= n_onsets; ++o) {
    onsets.a_off[o] = static_cast<const int*>(a_off)[o];
  }
  const dim3 grid(n_tiles, (nsamples + QW_N - 1) / QW_N);
  qm_migrate_detect_x16g_v2_kernel<ABL><<<grid, QW_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hi),
      static_cast<const __nv_bfloat16*>(lo), width,
      static_cast<const int*>(want), m_pad, onsets,
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      nsamples, a_sum);
  return (int)cudaGetLastError();
}

// The inputs of qm_migrate_detect_x16g (v1), but a_off (int32 [n_onsets +
// 1], n_onsets <= QW_MAX_ONSETS) in host memory: it becomes a kernel
// parameter. tile a multiple of 64 up to 512 and tables at least
// round_up(nsamples, 64) + 16 wide; outputs [n_tiles, nsamples]. ablate: a
// QwAblate.
extern "C" int qm_migrate_detect_x16g_v2(
    const void* hi, const void* lo, int width, const void* want, int m_pad,
    const void* a_off, const void* fine, const void* valid,
    const void* inv_available, void* tmax, void* targ, void* tsum,
    int n_onsets, int n_tiles, int tile, int nsamples, int a_sum, int ablate,
    void* stream) {
  if (n_onsets < 1 || n_onsets > QW_MAX_ONSETS || n_tiles < 1 ||
      tile < 64 || tile % 64 != 0 ||
      tile > QW_TILE_MAX || nsamples < 1 ||
      (nsamples + QW_N - 1) / QW_N > 65535 || a_sum < n_onsets ||
      m_pad < a_sum || width % 8 != 0 ||
      width < (nsamples + QW_N - 1) / QW_N * QW_N + 16 ||
      static_cast<const int*>(a_off)[n_onsets] != a_sum) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QW_CASE(A)                                                            \
  case A:                                                                     \
    return qw_launch<A>(hi, lo, width, want, m_pad, a_off, fine, valid,       \
                        inv_available, tmax, targ, tsum, n_onsets, n_tiles, \
                        tile, nsamples, a_sum, s);
  switch (ablate) {
    QW_CASE(QW_FULL)
    QW_CASE(QW_NOMAIN)
    QW_CASE(QW_NOREDUCE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QW_CASE
}

// Resident blocks per SM of the full kernel at a plan, from the occupancy
// API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_x16g_v2_blocks_per_sm(int a_sum) {
  const int smem = qw_layout(a_sum).total;
  const void* kernel = (const void*)qm_migrate_detect_x16g_v2_kernel<QW_FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      QW_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
