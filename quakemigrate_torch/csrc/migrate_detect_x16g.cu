// Stride-16 table detect on the tensor cores ("X16G"), for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel _x16g_kernel
// (experiments/exp_x16g.py:53). The detect contract (migrate_detect.cu) in
// bf16 hi/lo numerics, read through a stride-16 table
//   X16[o a_pad + a, u] = L[o, fsmp + 16 a + u]   (as hi and lo, bf16)
// on the 16-aligned plan: per tile and onset base16 (a multiple of 16) and
// per node fine16 < 16 A_o. Per node tile and scan sample t:
//   acc[n, t] = sum_o hi(L)[o, fsmp + base16 + fine16[o, n] + t]
//             + sum_o lo(L)[...]                        (f32 accumulation)
//   coa[n, t] = exp(acc * inv) * valid[n];  tmax, first argmax, sum over n.
//
// Design. One block per (node tile, 128-sample block), 8 warps, as K1.
// - Coarse select. On the TPU a one-hot product C @ stage picks each
//   onset's A_o coarse rows at its dynamic row base16 / 16; on the card a
//   dynamic-offset copy is legal, so the block stages table rows want[m]
//   (m = (o, q), q < A_o), columns [s0, s0 + 144), of hi and lo with
//   cp.async into G (48 KB at 24 onsets, A = 84 rows).
// - The product. With s = fine16 = 16 q + b, the samples a node needs are
//   G[(o, q)][b + t]: K runs over (o, q, b), and each (o, q) is exactly one
//   k16 step of mma.sync m16n8k16. A[n, (o, q, b)] = (fine16[o, n] == 16 q
//   + b) is built in registers by compares; B[(o, q, b), t] = G[(o, q)][b +
//   t] is a Hankel view of G. A warp owns 16 nodes x 128 samples (64 f32
//   accumulators a lane) and walks every (o, q), hi then lo into the same
//   accumulators; 8 warps take 128 nodes a pass, tile / 128 passes.
// - The B operand, the template's FUSE (the TPU `fuse`):
//   FUSE = false ("expand") writes each onset's [16 A_o x 128] Hankel block
//   into shared memory (double-buffered, one barrier per onset, rows
//   XOR-swizzled by 16-byte chunk so that ldmatrix.trans reads are free of
//   bank conflicts) and feeds B with ldmatrix.x4.trans;
//   FUSE = true reads B fragments straight from G: a lane's pair G[x], G[x +
//   1] starts at x = 8 nt + 2 c + g, odd for odd g, so G is kept in a
//   second copy shifted by one element and odd-group lanes read that one:
//   every load is an aligned 32-bit word.
//   The TPU option `aligned` pads K to its sublane tile; here each (o, q)
//   is already one k16 step, so both values launch the same kernel.
// - Epilogue. coa = __fmul_rn(expf(__fmul_rn(acc, inv)), valid) as K1; per
//   sample the max, smallest node attaining it, and sum: rows g and g + 8
//   of a fragment, then lane shuffles over the groups, then across passes
//   and warps through shared memory, always with qm_reduce_nodes' tie rule
//   (larger value, or equal value and smaller node).
// - Ablations (the TPU `ablate`), template ABL: nosel skips staging (G
//   stays zero), noonehot builds no A (zero), noexp skips the Hankel
//   expansion (zero), nomain skips the products (acc = G_hi row 0 at t, as
//   the TPU's acc = a_op[0, 0]), noreduce writes acc of nodes 0, 1, 2 (the
//   middle one as int32) in place of tmax, targ, tsum, onlymain keeps the
//   products and the epilogue on zero operands. Skipped buffers are zeroed
//   once per block, so ablated outputs are deterministic.
//
// Bound on the card: the tensor cores, 4 K flop per node-sample (K = 16 A,
// hi and lo) at 989 TFLOP/s bf16 dense. mma.sync with 16-node warp tiles
// re-reads B from shared memory for every 16 nodes, about as many bytes as
// the products consume; no wgmma, TMA or tuning yet.

#include "detect_core.cuh"
#include "mma_core.cuh"

#define QG_COLS 144       // staged columns a row: 128 samples + 16 residues
#define QG_PITCH 144      // bf16 a G row (288 bytes, 16-byte aligned)
#define QG_NODES 16       // nodes a warp a pass
#define QG_RED_BYTES (3 * QM_NWARPS * QM_SBLK * 4)

enum QgAblate {
  QG_FULL = 0,
  QG_NOSEL = 1,
  QG_NOONEHOT = 2,
  QG_NOEXP = 3,
  QG_NOMAIN = 4,
  QG_NOREDUCE = 5,
  QG_ONLYMAIN = 6,
};

// Shared-memory layout of a block, in bytes (mirrored on the host by
// ops/cuda_x16g.x16g_smem):
//   [0, g_bytes)           G: hi rows, then lo rows, QG_PITCH bf16 each;
//   odd_off (FUSE)         G shifted by one element, same shape, placed 16
//                          banks off G so that the two copies' reads do not
//                          collide;
//   e_off (not FUSE)       2 buffers x (hi, lo) x 16 a_max rows x 128 bf16;
//   aoff_off               a_off, n_onsets + 1 ints;
// and the cross-warp reduction (QG_RED_BYTES) at 0, after the last read of
// G and the Hankel buffers.
struct QgLayout {
  int g_bytes, odd_off, e_off, e_half, aoff_off, total;
};

__host__ __device__ inline int qg_round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline QgLayout qg_layout(int n_onsets, int a_sum,
                                              int a_max, bool fuse) {
  QgLayout l;
  l.g_bytes = 2 * a_sum * QG_PITCH * 2;
  l.odd_off = fuse ? qg_round_up(l.g_bytes, 128) + 64 : 0;
  l.e_off = fuse ? 0 : qg_round_up(l.g_bytes, 128);
  l.e_half = 16 * a_max * QM_SBLK * 2;
  int end = fuse ? l.odd_off + l.g_bytes : l.e_off + 4 * l.e_half;
  if (end < QG_RED_BYTES) end = QG_RED_BYTES;
  l.aoff_off = qg_round_up(end, 16);
  l.total = l.aoff_off + 4 * (n_onsets + 1);
  return l;
}

// Two bf16 at element x of a row of 32-bit words: the aligned word, or the
// pair across two words for odd x.
__device__ __forceinline__ unsigned qg_pair(const unsigned* w, int x) {
  const unsigned lo = w[x >> 1];
  if (!(x & 1)) return lo;
  return __funnelshift_r(lo, w[(x >> 1) + 1], 16);
}

// Byte offset of the 16-byte chunk `chunk` (8 samples) of Hankel row r.
__device__ __forceinline__ int qg_swizzle(int r, int chunk) {
  return r * (QM_SBLK * 2) + ((chunk ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned qg_hot(int r, int b) {
  return (r == b ? QT_BF16_ONE : 0u) | (r == b + 1 ? QT_BF16_ONE << 16 : 0u);
}

template <bool FUSE, int ABL>
__global__ void __launch_bounds__(QM_THREADS, 2)
qm_migrate_detect_x16g_kernel(
    const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
    int width, const int* __restrict__ want, int m_pad,
    const int* __restrict__ a_off_g, const int* __restrict__ fine,
    const float* __restrict__ valid, const float* __restrict__ inv_available,
    float* __restrict__ tmax, int* __restrict__ targ, float* __restrict__ tsum,
    int n_onsets, int tile, int nsamples, int a_sum, int a_max) {
  extern __shared__ __align__(16) unsigned char qg_smem[];
  const QgLayout lay = qg_layout(n_onsets, a_sum, a_max, FUSE);
  __nv_bfloat16* g_buf = reinterpret_cast<__nv_bfloat16*>(qg_smem);
  int* a_off = reinterpret_cast<int*>(qg_smem + lay.aoff_off);
  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = qt_group(lane);
  const int c = qt_quad(lane);

  for (int o = tid; o <= n_onsets; o += QM_THREADS) a_off[o] = a_off_g[o];
  constexpr bool ZERO_G = ABL == QG_NOSEL || ABL == QG_ONLYMAIN;
  constexpr bool ZERO_E = !FUSE && (ABL == QG_NOEXP || ABL == QG_ONLYMAIN);
  if (ZERO_G || ZERO_E) {
    const int from = ZERO_G ? 0 : lay.e_off;
    const int to = ZERO_E ? lay.e_off + 4 * lay.e_half
                          : (FUSE ? lay.odd_off + lay.g_bytes : lay.g_bytes);
    for (int x = from / 16 + tid; x < to / 16; x += QM_THREADS) {
      reinterpret_cast<uint4*>(qg_smem)[x] = make_uint4(0, 0, 0, 0);
    }
  }

  // Coarse select: table rows want[m] of hi and lo, columns [s0, s0 + 144),
  // 18 chunks of 16 bytes a row.
  if (!ZERO_G) {
    const int* want_i = want + (long long)tile_i * m_pad;
    for (int e = tid; e < 2 * a_sum * (QG_COLS / 8); e += QM_THREADS) {
      const int row = e / (QG_COLS / 8);
      const int chunk = e - row * (QG_COLS / 8);
      const int half = row >= a_sum;
      const int m = row - half * a_sum;
      const __nv_bfloat16* table = half ? lo : hi;
      qm_cp_async16(g_buf + row * QG_PITCH + 8 * chunk,
                    table + (long long)want_i[m] * width + s0 + 8 * chunk);
    }
  }
  qm_cp_async_commit();
  qm_cp_async_wait<0>();
  __syncthreads();

  if (FUSE && !ZERO_G) {  // the copy shifted by one element
    const unsigned* src = reinterpret_cast<const unsigned*>(g_buf);
    unsigned* dst = reinterpret_cast<unsigned*>(qg_smem + lay.odd_off);
    constexpr int WORDS = QG_PITCH / 2;
    for (int e = tid; e < 2 * a_sum * WORDS; e += QM_THREADS) {
      const int x = e % WORDS;
      const unsigned next = x + 1 < WORDS ? src[e + 1] : 0u;
      dst[e] = __funnelshift_r(src[e], next, 16);
    }
    __syncthreads();
  }

  const int* fine_i = fine + (long long)tile_i * n_onsets * tile;
  const float* valid_i = valid + (long long)tile_i * tile;
  const float inv = *inv_available;
  const long long out_row = (long long)tile_i * nsamples;

  // Running reduction of this lane's 4 samples: slot k holds sample
  // 8 (g + 8 (k / 2)) + 2 c + k % 2.
  float best[4], total[4];
  int arg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    best[k] = -INFINITY;
    total[k] = 0.0f;
    arg[k] = 0;
  }

  int step = 0;  // (pass, onset) counter: the Hankel buffer's parity
  for (int n_pass = 0; n_pass < tile; n_pass += QM_NWARPS * QG_NODES) {
    const int n0 = n_pass + warp * QG_NODES;
    const bool active = n0 < tile;  // uniform in the warp
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

    for (int o = 0; o < n_onsets; ++o, ++step) {
      const int m0 = a_off[o];
      const int a_o = a_off[o + 1] - m0;
      unsigned char* e_buf = qg_smem + lay.e_off + (step & 1) * 2 * lay.e_half;
      if (!FUSE) {
        // Hankel block of onset o: row 16 q + b, samples t = 8 chunk ..
        // + 7, from G[m0 + q][b + t], for hi and lo.
        if (ABL != QG_NOEXP && ABL != QG_ONLYMAIN) {
          for (int e = tid; e < 2 * 16 * a_o * 16; e += QM_THREADS) {
            const int chunk = e & 15;
            const int r = (e >> 4) % (16 * a_o);
            const int half = (e >> 4) / (16 * a_o);
            const unsigned* w = reinterpret_cast<const unsigned*>(
                g_buf + (half * a_sum + m0 + (r >> 4)) * QG_PITCH);
            const int x = (r & 15) + 8 * chunk;
            uint4 v;
            v.x = qg_pair(w, x);
            v.y = qg_pair(w, x + 2);
            v.z = qg_pair(w, x + 4);
            v.w = qg_pair(w, x + 6);
            *reinterpret_cast<uint4*>(e_buf + half * lay.e_half +
                                      qg_swizzle(r, chunk)) = v;
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      const int fa = __ldg(fine_i + o * tile + n0 + g);
      const int fb = __ldg(fine_i + o * tile + n0 + g + 8);
      for (int q = 0; q < a_o; ++q) {
        unsigned a[4] = {0u, 0u, 0u, 0u};
        if (ABL != QG_NOONEHOT && ABL != QG_ONLYMAIN) {
          const int ra = fa - 16 * q - 2 * c;
          const int rb = fb - 16 * q - 2 * c;
          a[0] = qg_hot(ra, 0);
          a[1] = qg_hot(rb, 0);
          a[2] = qg_hot(ra, 8);
          a[3] = qg_hot(rb, 8);
        }
        if (ABL == QG_NOMAIN) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qm_keep(__uint_as_float(a[e]));
          continue;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (FUSE) {
            const int m = half * a_sum + m0 + q;
            const __nv_bfloat16* row =
                (g & 1) ? reinterpret_cast<const __nv_bfloat16*>(
                              qg_smem + lay.odd_off) + m * QG_PITCH - 1
                        : g_buf + m * QG_PITCH;
            const __nv_bfloat16* p = row + 2 * c + g;
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
              const unsigned b0 = *reinterpret_cast<const unsigned*>(p + 8 * nt);
              const unsigned b1 =
                  *reinterpret_cast<const unsigned*>(p + 8 * nt + 8);
              qt_mma_bf16(acc[nt], a, b0, b1);
            }
          } else {
            const unsigned char* e_half = e_buf + half * lay.e_half;
            const int r = 16 * q + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
            for (int np = 0; np < 8; ++np) {
              unsigned b[4];
              qt_ldmatrix_x4_trans(
                  b, e_half + qg_swizzle(r, 2 * np + (lane >> 4)));
              qt_mma_bf16(acc[2 * np], a, b[0], b[1]);
              qt_mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    if (!active) continue;

    if (ABL == QG_NOMAIN) {  // acc = G_hi row 0 at sample t
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = __bfloat162float(g_buf[8 * nt + 2 * c + (e & 1)]);
    }

    if (ABL == QG_NOREDUCE) {
      if (n0 == 0 && g < 3) {  // nodes 0, 1, 2: rows 0..2 of warp 0's tile
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = s0 + 8 * nt + 2 * c + j;
            if (s < nsamples) {
              if (g == 0) tmax[out_row + s] = acc[nt][j];
              if (g == 1) targ[out_row + s] = (int)acc[nt][j];
              if (g == 2) tsum[out_row + s] = acc[nt][j];
            }
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) qm_keep(acc[nt][e]);
      }
      continue;
    }

    const int na = n0 + g, nb = n0 + g + 8;
    const float va = __ldg(valid_i + na), vb = __ldg(valid_i + nb);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float ca = __fmul_rn(expf(__fmul_rn(acc[nt][j], inv)), va);
        const float cb = __fmul_rn(expf(__fmul_rn(acc[nt][2 + j], inv)), vb);
        float v = ca, s = ca + cb;
        int n = na;
        if (cb > ca) {
          v = cb;
          n = nb;
        }
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, x);
          const int on = __shfl_xor_sync(0xffffffffu, n, x);
          s += __shfl_xor_sync(0xffffffffu, s, x);
          if (ov > v || (ov == v && on < n)) {
            v = ov;
            n = on;
          }
        }
        if ((nt & 7) == g) {
          const int k = (nt >> 3) * 2 + j;
          if (v > best[k] || (v == best[k] && n < arg[k])) {
            best[k] = v;
            arg[k] = n;
          }
          total[k] += s;
        }
      }
    }
  }
  if (ABL == QG_NOREDUCE) return;

  __syncthreads();  // every read of G and the Hankel buffers is done
  float* red_max = reinterpret_cast<float*>(qg_smem);
  int* red_arg = reinterpret_cast<int*>(red_max + QM_NWARPS * QM_SBLK);
  float* red_sum = red_max + 2 * QM_NWARPS * QM_SBLK;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 8 * (g + 8 * (k >> 1)) + 2 * c + (k & 1);
    red_max[warp * QM_SBLK + t] = best[k];
    red_arg[warp * QM_SBLK + t] = arg[k];
    red_sum[warp * QM_SBLK + t] = total[k];
  }
  __syncthreads();
  if (tid < QM_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid], s = red_sum[tid];
    int a = red_arg[tid];
    for (int w = 1; w < QM_NWARPS; ++w) {
      const float mw = red_max[w * QM_SBLK + tid];
      const int aw = red_arg[w * QM_SBLK + tid];
      if (mw > m || (mw == m && aw < a)) {
        m = mw;
        a = aw;
      }
      s += red_sum[w * QM_SBLK + tid];
    }
    tmax[out_row + s0 + tid] = m;
    targ[out_row + s0 + tid] = a;
    tsum[out_row + s0 + tid] = s;
  }
}

template <bool FUSE, int ABL>
static int qg_launch(const void* hi, const void* lo, int width,
                     const void* want, int m_pad, const void* a_off,
                     const void* fine, const void* valid,
                     const void* inv_available, void* tmax, void* targ,
                     void* tsum, int n_onsets, int n_tiles, int tile,
                     int nsamples, int a_sum, int a_max, cudaStream_t stream) {
  const int smem = qg_layout(n_onsets, a_sum, a_max, FUSE).total;
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_x16g_kernel<FUSE, ABL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_migrate_detect_x16g_kernel<FUSE, ABL><<<grid, QM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hi),
      static_cast<const __nv_bfloat16*>(lo), width,
      static_cast<const int*>(want), m_pad, static_cast<const int*>(a_off),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      nsamples, a_sum, a_max);
  return (int)cudaGetLastError();
}

template <bool FUSE>
static int qg_dispatch(int ablate, const void* hi, const void* lo, int width,
                       const void* want, int m_pad, const void* a_off,
                       const void* fine, const void* valid, const void* inv,
                       void* tmax, void* targ, void* tsum, int n_onsets,
                       int n_tiles, int tile, int nsamples, int a_sum,
                       int a_max, cudaStream_t s) {
#define QG_CASE(A)                                                          \
  case A:                                                                   \
    return qg_launch<FUSE, A>(hi, lo, width, want, m_pad, a_off, fine, valid, \
                              inv, tmax, targ, tsum, n_onsets, n_tiles, tile, \
                              nsamples, a_sum, a_max, s);
  switch (ablate) {
    QG_CASE(QG_FULL)
    QG_CASE(QG_NOSEL)
    QG_CASE(QG_NOONEHOT)
    QG_CASE(QG_NOEXP)
    QG_CASE(QG_NOMAIN)
    QG_CASE(QG_NOREDUCE)
    QG_CASE(QG_ONLYMAIN)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QG_CASE
}

// hi, lo: bf16 [rows, width] tables (width a multiple of 8, at least
// round_up(nsamples, 128) + 16); want: int32 [n_tiles, m_pad] table rows,
// the first a_sum of each tile valid rows; a_off: int32 [n_onsets + 1]
// prefix sums of A_o (a_off[n_onsets] = a_sum, each A_o <= a_max); fine:
// int32 [n_tiles, n_onsets, tile] with fine < 16 A_o; valid: f32 [n_tiles,
// tile]; outputs [n_tiles, nsamples]. ablate: a QgAblate.
extern "C" int qm_migrate_detect_x16g(
    const void* hi, const void* lo, int width, const void* want, int m_pad,
    const void* a_off, const void* fine, const void* valid,
    const void* inv_available, void* tmax, void* targ, void* tsum,
    int n_onsets, int n_tiles, int tile, int nsamples, int a_sum, int a_max,
    int fuse, int ablate, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < QG_NODES || tile % QG_NODES != 0 ||
      nsamples < 1 || a_sum < n_onsets || a_max < 1 || m_pad < a_sum ||
      width % 8 != 0 || width < (nsamples + QM_SBLK - 1) / QM_SBLK * QM_SBLK + 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fuse) {
    return qg_dispatch<true>(ablate, hi, lo, width, want, m_pad, a_off, fine,
                             valid, inv_available, tmax, targ, tsum, n_onsets,
                             n_tiles, tile, nsamples, a_sum, a_max, s);
  }
  return qg_dispatch<false>(ablate, hi, lo, width, want, m_pad, a_off, fine,
                            valid, inv_available, tmax, targ, tsum, n_onsets,
                            n_tiles, tile, nsamples, a_sum, a_max, s);
}

// Resident blocks per SM of the full kernel in either form at this plan,
// from the occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_x16g_blocks_per_sm(int n_onsets, int a_sum,
                                                    int a_max, int fuse) {
  const int smem = qg_layout(n_onsets, a_sum, a_max, fuse != 0).total;
  const void* kernel =
      fuse ? (const void*)qm_migrate_detect_x16g_kernel<true, QG_FULL>
           : (const void*)qm_migrate_detect_x16g_kernel<false, QG_FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
