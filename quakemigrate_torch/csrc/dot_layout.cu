// One-hot product layouts on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel _kern (experiments/exp_dot_layout.py:31),
// which measures the matrix unit's rate for the layouts a one-hot detect
// product can take. Its contract, per step t of `steps`, on persistent bf16
// operands filled once:
//   lhs = (iota % 7) * 0.125 along dim 1, stored [K][M] (kk, kk1, kkT) or
//         [M][K] (mk, mk1);
//   rhs = (iota % 5) * 0.25 along dim 1, stored [K][N] or [K][2N] (kk1, mk1);
//   kk, mk: acc = A * rhs + A * (rhs * 0.5), out[t, n] = sum_m acc[m, n];
//   kk1, mk1: acc = A * rhs (width 2N), out[t, n] = sum_m acc[m, n] +
//             acc[m, N + n];
//   kkT: lhs transposed to [M][K] each step, acc = A * rhs,
//        out[t, n] = sum_m acc[m, n];
// with A = lhs^T (kk, kk1, kkT) or lhs (mk, mk1), f32 accumulation. Every
// acc entry is exact (sums of products of dyadic values with few bits); only
// the f32 sum over m may round.
//
// Design. The operands live in device memory (12.6 MB for rhs [1536][4096]:
// no SM could keep them resident as VMEM does; L2 holds them) and every
// step streams them through shared memory. One block per (128 columns of
// out, step): it walks the M rows in 128-row tiles (and both column halves
// for kk1/mk1) with a K loop of 32, double-buffered with cp.async, 8 warps
// each owning a 64 x 32 piece of the 128 x 128 product in mma.sync m16n8k16
// accumulators. The accumulators of all M tiles and halves add up in place
// (their sum is the column sum the step needs, and stays exact); at the end
// each warp sums its 64 rows by lane shuffles, the two row halves meet in
// shared memory, and the block writes its 128 columns of out[t] once, so
// out needs no zeroing and no atomics. Layouts: kk keeps [K][M] tiles and
// loads its A fragments with ldmatrix.trans; mk loads [M][K] tiles with
// plain ldmatrix; kkT copies each [K][M] tile into an [M][K] buffer (the
// per-step transpose) and then runs mk's loads; rhs [K][N] tiles feed B by
// ldmatrix.trans in every mode. The second product of kk and mk multiplies
// the B fragments by 0.5, exact in bf16. Row pitches are padded by 16 bytes
// so that the eight 16-byte rows of each ldmatrix matrix fall in distinct
// banks.
//
// Bound on the card: the tensor cores, 4 K M N flop a step (2 K M N for
// kkT) at 989 TFLOP/s bf16 dense; the operands are re-read from L2 every
// step. No wgmma, TMA or tuning: mma.sync reaches only part of that rate.

#include "detect_core.cuh"
#include "mma_core.cuh"

#define QD_BM 128
#define QD_BN 128
#define QD_BK 32
#define QD_THREADS 256
#define QD_PITCH_MK (QD_BK + 8)   // [m][k] tile row: 80 bytes
#define QD_PITCH_KN (QD_BN + 8)   // [k][m] or [k][n] tile row: 272 bytes
#define QD_TILE_MK (QD_BM * QD_PITCH_MK)
#define QD_TILE_KN (QD_BK * QD_PITCH_KN)

enum QdMode { QD_KK = 0, QD_KK1 = 1, QD_MK = 2, QD_MK1 = 3, QD_KKT = 4 };

__host__ __device__ constexpr bool qd_two(int mode) {
  return mode == QD_KK1 || mode == QD_MK1;
}
__host__ __device__ constexpr bool qd_lhs_km(int mode) {
  return mode == QD_KK || mode == QD_KK1 || mode == QD_KKT;
}

// The fill of the TPU kernel's first step: p[i] = (i % cols % mod) * scale.
__global__ void qm_dot_layout_fill_kernel(__nv_bfloat16* __restrict__ p,
                                          long long n, int cols, int mod,
                                          float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    p[i] = __float2bfloat16_rn((float)((int)(i % cols) % mod) * scale);
  }
}

template <int MODE>
__global__ void __launch_bounds__(QD_THREADS)
qm_dot_layout_kernel(const __nv_bfloat16* __restrict__ lhs,
                     const __nv_bfloat16* __restrict__ rhs,
                     float* __restrict__ out, int K, int M, int N) {
  constexpr bool TWO = qd_two(MODE);
  constexpr bool LHS_KM = qd_lhs_km(MODE);
  constexpr bool HALF_PRODUCT = MODE == QD_KK || MODE == QD_MK;
  constexpr int A_TILE = LHS_KM ? QD_TILE_KN : QD_TILE_MK;

  extern __shared__ __align__(16) __nv_bfloat16 qd_smem[];
  __nv_bfloat16* a_buf = qd_smem;                // 2 x A_TILE
  __nv_bfloat16* b_buf = qd_smem + 2 * A_TILE;   // 2 x QD_TILE_KN
  __nv_bfloat16* t_buf = b_buf + 2 * QD_TILE_KN; // kkT: [m][k] copy
  float* red = reinterpret_cast<float*>(t_buf + (MODE == QD_KKT ? QD_TILE_MK : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // warp's rows in the 128 x 128 tile
  const int wn = (warp & 3) * 32;   // warp's columns
  const int n0 = blockIdx.x * QD_BN;
  const int NB = TWO ? 2 * N : N;   // columns of rhs
  const int t = blockIdx.y;

  const int k_iters = K / QD_BK;
  const int m_iters = M / QD_BM;
  const int n_iters = (TWO ? 2 : 1) * m_iters * k_iters;

  // Queue the cp.async copies of iteration `it` into buffer `buf`.
  auto stage = [&](int it, int buf) {
    const int kb = it % k_iters;
    const int mb = (it / k_iters) % m_iters;
    const int half = it / (k_iters * m_iters);
    const int k0 = kb * QD_BK, m0 = mb * QD_BM;
    __nv_bfloat16* a = a_buf + buf * A_TILE;
    __nv_bfloat16* b = b_buf + buf * QD_TILE_KN;
    // 512 16-byte chunks each for A and B: 2 per thread each.
    for (int c = tid; c < 512; c += QD_THREADS) {
      if (LHS_KM) {  // [32 k][128 m]: 16 chunks a row
        const int r = c >> 4, x = (c & 15) * 8;
        qm_cp_async16(a + r * QD_PITCH_KN + x,
                      lhs + (long long)(k0 + r) * M + m0 + x);
      } else {       // [128 m][32 k]: 4 chunks a row
        const int r = c >> 2, x = (c & 3) * 8;
        qm_cp_async16(a + r * QD_PITCH_MK + x,
                      lhs + (long long)(m0 + r) * K + k0 + x);
      }
      const int r = c >> 4, x = (c & 15) * 8;
      qm_cp_async16(b + r * QD_PITCH_KN + x,
                    rhs + (long long)(k0 + r) * NB + half * N + n0 + x);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  stage(0, 0);
  qm_cp_async_commit();
  for (int it = 0; it < n_iters; ++it) {
    const int buf = it & 1;
    qm_cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; everyone is done with it - 1
    if (it + 1 < n_iters) stage(it + 1, buf ^ 1);
    qm_cp_async_commit();

    const __nv_bfloat16* a = a_buf + buf * A_TILE;
    const __nv_bfloat16* b = b_buf + buf * QD_TILE_KN;
    if (MODE == QD_KKT) {  // the per-step transpose: [k][m] -> [m][k]
      for (int e = tid; e < QD_BK * QD_BM; e += QD_THREADS) {
        const int k = e / QD_BM, m = e - k * QD_BM;
        t_buf[m * QD_PITCH_MK + k] = a[k * QD_PITCH_KN + m];
      }
      __syncthreads();
      a = t_buf;
    }

#pragma unroll
    for (int ks = 0; ks < QD_BK; ks += 16) {
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (MODE == QD_KK || MODE == QD_KK1) {
          qt_ldmatrix_x4_trans(
              af[mt], qt_a_colmajor_addr(a, QD_PITCH_KN, wm + 16 * mt, ks, lane));
        } else {
          qt_ldmatrix_x4(
              af[mt], qt_a_rowmajor_addr(a, QD_PITCH_MK, wm + 16 * mt, ks, lane));
        }
      }
      unsigned bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        qt_ldmatrix_x4_trans(r, qt_b_kn_addr(b, QD_PITCH_KN, ks, wn + 16 * np, lane));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          qt_mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
          if (HALF_PRODUCT) {
            qt_mma_bf16(acc[mt][nt], af[mt], qt_half(bf[nt][0]),
                        qt_half(bf[nt][1]));
          }
        }
    }
  }

  // Column sums: the warp's 64 rows (4 m tiles, rows g and g + 8 of each),
  // then over the 8 groups of lanes; lanes 0..3 keep columns 8 nt + 2 c + j.
  float col[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) s += acc[mt][nt][j] + acc[mt][nt][2 + j];
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
      col[nt][j] = s;
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[(warp >> 2) * QD_BN + wn + 8 * nt + 2 * lane + j] = col[nt][j];
  }
  __syncthreads();
  if (tid < QD_BN) {
    out[(long long)t * N + n0 + tid] = red[tid] + red[QD_BN + tid];
  }
}

static int qd_smem_bytes(int mode) {
  const int a_tile = qd_lhs_km(mode) ? QD_TILE_KN : QD_TILE_MK;
  const int t_tile = mode == QD_KKT ? QD_TILE_MK : 0;
  return (2 * a_tile + 2 * QD_TILE_KN + t_tile) * 2 + 2 * QD_BN * 4;
}

template <int MODE>
static int qd_launch(const void* lhs, const void* rhs, void* out, int K, int M,
                     int N, int steps, cudaStream_t stream) {
  const int smem = qd_smem_bytes(MODE);
  cudaError_t err = cudaFuncSetAttribute(
      qm_dot_layout_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / QD_BN, steps);
  qm_dot_layout_kernel<MODE><<<grid, QD_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(lhs),
      static_cast<const __nv_bfloat16*>(rhs), static_cast<float*>(out), K, M,
      N);
  return (int)cudaGetLastError();
}

static bool qd_bad_shape(int mode, int K, int M, int N) {
  return mode < QD_KK || mode > QD_KKT || K < QD_BK || K % QD_BK != 0 ||
         M < QD_BM || M % QD_BM != 0 || N < QD_BN || N % QD_BN != 0;
}

// Fill lhs and rhs (bf16, device) for `mode` as the TPU kernel's first step
// does: lhs [K][M] or [M][K], rhs [K][N] or [K][2N].
extern "C" int qm_dot_layout_fill(void* lhs, void* rhs, int mode, int K, int M,
                                  int N, void* stream) {
  if (qd_bad_shape(mode, K, M, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = qd_two(mode) ? 2 * N : N;
  qm_dot_layout_fill_kernel<<<1024, 256, 0, s>>>(
      static_cast<__nv_bfloat16*>(lhs), (long long)K * M,
      qd_lhs_km(mode) ? M : K, 7, 0.125f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qm_dot_layout_fill_kernel<<<1024, 256, 0, s>>>(
      static_cast<__nv_bfloat16*>(rhs), (long long)K * nb, nb, 5, 0.25f);
  return (int)cudaGetLastError();
}

// out: f32 [steps][N]. mode: 0 kk, 1 kk1, 2 mk, 3 mk1, 4 kkT. K a multiple
// of 32, M and N of 128.
extern "C" int qm_dot_layout(const void* lhs, const void* rhs, void* out,
                             int mode, int K, int M, int N, int steps,
                             void* stream) {
  if (qd_bad_shape(mode, K, M, N) || steps < 1 || steps > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case QD_KK: return qd_launch<QD_KK>(lhs, rhs, out, K, M, N, steps, s);
    case QD_KK1: return qd_launch<QD_KK1>(lhs, rhs, out, K, M, N, steps, s);
    case QD_MK: return qd_launch<QD_MK>(lhs, rhs, out, K, M, N, steps, s);
    case QD_MK1: return qd_launch<QD_MK1>(lhs, rhs, out, K, M, N, steps, s);
    default: return qd_launch<QD_KKT>(lhs, rhs, out, K, M, N, steps, s);
  }
}
