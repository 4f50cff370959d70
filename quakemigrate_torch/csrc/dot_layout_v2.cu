// One-hot product layouts on Hopper's warpgroup tensor cores (sm_90a):
// E5 v2, wgmma fed by a TMA ring.
//
// Replaces the TPU experiment kernel _kern (experiments/exp_dot_layout.py:31)
// with the same contract as dot_layout.cu (v1, mma.sync), which stays as the
// yardstick: per step t of `steps`, on persistent bf16 operands filled once
// (lhs = (iota % 7) * 0.125, rhs = (iota % 5) * 0.25 along dim 1),
//   kk, mk:   out[t, n] = sum_m (A rhs)[m, n] + (A (rhs * 0.5))[m, n];
//   kk1, mk1: out[t, n] = sum_m (A rhs)[m, n] + (A rhs)[m, N + n], rhs [K][2N];
//   kkT:      out[t, n] = sum_m (A rhs)[m, n];
// with A = lhs^T, lhs stored [K][M] (kk, kk1, kkT), or A = lhs stored [M][K]
// (mk, mk1), f32 accumulation. Every product is issued in every step.
// rhs * 0.5 is made once per launch (exact in bf16) as a second B operand,
// as the library yardstick does.
//
// Bound on the card: the tensor cores, 4 K M N flop a step (2 K M N for
// kkT) at 989 TFLOP/s bf16 dense. The operands (at most 12.6 MB) stay in
// L2, so the second limit is L2 -> shared traffic, which v1 spent freely:
// its blocks walked M outside K and staged a strip of rhs once per 128 rows
// of A (64 K M bytes a step at N = 2048, 100.7 MB at the head shape).
//
// Design.
// - One block per (256 columns of out, step). Warp-specialised: warpgroup 0
//   produces (one thread issues every TMA load; setmaxnreg gives its
//   registers away), warpgroups 1 and 2 consume, each owning 64 rows of a
//   128-row A tile, with a 64 x 256 f32 accumulator in registers (128 a
//   thread).
// - K outside, M inside, and every A tile adds into the same accumulators,
//   since only column sums are wanted. A stage of B (64 k x 256 columns,
//   both B operands of the step: rhs and rhs * 0.5, or the two column
//   halves) is staged once per block and step and held while the M / 128
//   A tiles of that k stream through a 5-deep ring. Staged bytes a step:
//   (N / 256) (2 K M + 512 K B-operands) = 37.7 MB at the head shape.
// - Both products of a step read the same staged A tile, so A is staged
//   once for two products in every two-product mode (v1 staged it twice in
//   kk1 and mk1).
// - Layouts by descriptor: 128-byte-swizzled TMA boxes of 64 x 64, A
//   MN-major for kk, kk1, kkT (trans-a) and K-major for mk, mk1; rhs [K][N]
//   is an MN-major B (trans-b). bf16 wgmma reads either order from shared
//   memory, so kkT, the TPU experiment's question of what an explicit
//   transpose costs, has no transpose step on this card: it is kk with one
//   product.
// - Barriers: a full and an empty mbarrier per stage (TMA expect-tx; one
//   arrival per consumer warp). A consumer commits each A tile's products
//   as one group and waits for the group before it, so the tensor cores
//   always have the next tile queued; a stage is released only when the
//   products that read it are done.
// - Epilogue: column sums of each warp's 16 rows by shuffles over the
//   accumulator fragment (wgmma_core.cuh), the eight consumer warps meet
//   in shared memory, and the block writes its 256 columns of out[t] once:
//   no atomics, no zeroing.
// Shapes: K a multiple of 64, M of 128, N of 256.

#include "tma_rows.cuh"

#define QV_BM 128  // rows of an A tile: two consumer warpgroups x 64
#define QV_BN 256  // columns of a block's strip
#define QV_BK 64   // k of a stage: one 128-byte swizzle row of bf16
#define QV_A_STAGES 5
#define QV_B_STAGES 2
#define QV_THREADS 384
#define QV_CONSUMER_WARPS 8
#define QV_BOX_BYTES (64 * 64 * 2)            // one TMA box
#define QV_A_BYTES (2 * QV_BOX_BYTES)         // 128 rows x 64 k
#define QV_B_OP_BYTES (4 * QV_BOX_BYTES)      // 64 k x 256 columns
#define QV_B_BYTES (2 * QV_B_OP_BYTES)        // both B operands
#define QV_RED_BYTES (QV_CONSUMER_WARPS * QV_BN * 4)
#define QV_BAR_BYTES (2 * (QV_A_STAGES + QV_B_STAGES) * 8)
#define QV_SMEM_BYTES                                               \
  (QV_B_STAGES * QV_B_BYTES + QV_A_STAGES * QV_A_BYTES + QV_RED_BYTES + \
   QV_BAR_BYTES + 1024)  // + 1024: the base is rounded up to 1024 bytes

enum QvMode { QV_KK = 0, QV_KK1 = 1, QV_MK = 2, QV_MK1 = 3, QV_KKT = 4 };

__host__ __device__ constexpr bool qv_lhs_km(int mode) {
  return mode == QV_KK || mode == QV_KK1 || mode == QV_KKT;
}
__host__ __device__ constexpr bool qv_two(int mode) {
  return mode == QV_KK1 || mode == QV_MK1;
}

// rhs * 0.5, element by element (exact in bf16 for these fills).
__global__ void qm_dot_layout_v2_half_kernel(
    const __nv_bfloat16* __restrict__ src, __nv_bfloat16* __restrict__ dst,
    long long n) {
  const __nv_bfloat16 half = __float2bfloat16_rn(0.5f);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = __hmul(src[i], half);
  }
}

template <int MODE>
__global__ void __launch_bounds__(QV_THREADS, 1)
qm_dot_layout_v2_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_b2,
                        float* __restrict__ out, int K, int M, int N) {
  constexpr bool LHS_KM = qv_lhs_km(MODE);  // A MN-major
  constexpr int OPS = MODE == QV_KKT ? 1 : 2;

  extern __shared__ uint8_t qv_raw[];
  uint8_t* smem = qv_raw + ((1024 - (wg_smem(qv_raw) & 1023)) & 1023);
  uint8_t* b_buf = smem;
  uint8_t* a_buf = b_buf + QV_B_STAGES * QV_B_BYTES;
  float* red = reinterpret_cast<float*>(a_buf + QV_A_STAGES * QV_A_BYTES);
  uint64_t* a_full =
      reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(red) + QV_RED_BYTES);
  uint64_t* a_empty = a_full + QV_A_STAGES;
  uint64_t* b_full = a_empty + QV_A_STAGES;
  uint64_t* b_empty = b_full + QV_B_STAGES;

  const int n0 = blockIdx.x * QV_BN;
  const int t = blockIdx.y;
  const int k_iters = K / QV_BK;
  const int m_iters = M / QV_BM;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QV_A_STAGES; ++i) {
      wg_bar_init(&a_full[i], 1);
      wg_bar_init(&a_empty[i], QV_CONSUMER_WARPS);
    }
    for (int i = 0; i < QV_B_STAGES; ++i) {
      wg_bar_init(&b_full[i], 1);
      wg_bar_init(&b_empty[i], QV_CONSUMER_WARPS);
    }
    wg_bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    wg_regs_dec<40>();
    if (threadIdx.x == 0) {
      wg_prefetch_map(&map_a);
      wg_prefetch_map(&map_b);
      if (OPS == 2 && !qv_two(MODE)) wg_prefetch_map(&map_b2);
      int as = 0, bs = 0;
      uint32_t ap = 0, bp = 0;
      for (int kb = 0; kb < k_iters; ++kb) {
        const int k0 = kb * QV_BK;
        wg_bar_wait(&b_empty[bs], bp ^ 1);
        uint8_t* b = b_buf + bs * QV_B_BYTES;
        wg_bar_expect_tx(&b_full[bs], OPS * QV_B_OP_BYTES);
        for (int j = 0; j < 4; ++j) {
          wg_tma_load_2d(b + j * QV_BOX_BYTES, &map_b, &b_full[bs],
                         n0 + 64 * j, k0);
          if (qv_two(MODE)) {  // the second column half of rhs [K][2N]
            wg_tma_load_2d(b + QV_B_OP_BYTES + j * QV_BOX_BYTES, &map_b,
                           &b_full[bs], N + n0 + 64 * j, k0);
          } else if (OPS == 2) {  // rhs * 0.5
            wg_tma_load_2d(b + QV_B_OP_BYTES + j * QV_BOX_BYTES, &map_b2,
                           &b_full[bs], n0 + 64 * j, k0);
          }
        }
        if (++bs == QV_B_STAGES) {
          bs = 0;
          bp ^= 1;
        }
        for (int mb = 0; mb < m_iters; ++mb) {
          const int m0 = mb * QV_BM;
          wg_bar_wait(&a_empty[as], ap ^ 1);
          uint8_t* a = a_buf + as * QV_A_BYTES;
          wg_bar_expect_tx(&a_full[as], QV_A_BYTES);
          for (int h = 0; h < 2; ++h) {
            if (LHS_KM) {  // lhs [K][M]: box {64 m, 64 k}
              wg_tma_load_2d(a + h * QV_BOX_BYTES, &map_a, &a_full[as],
                             m0 + 64 * h, k0);
            } else {       // lhs [M][K]: box {64 k, 64 m}
              wg_tma_load_2d(a + h * QV_BOX_BYTES, &map_a, &a_full[as], k0,
                             m0 + 64 * h);
            }
          }
          if (++as == QV_A_STAGES) {
            as = 0;
            ap ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of every A tile ----
    wg_regs_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) - 4;  // 0..7 over both consumers
    const int lane = threadIdx.x & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    int as = 0, bs = 0, prev_a = -1, prev_b = -1;
    uint32_t ap = 0, bp = 0;
    for (int kb = 0; kb < k_iters; ++kb) {
      wg_bar_wait(&b_full[bs], bp);
      const uint8_t* b = b_buf + bs * QV_B_BYTES;
      for (int mb = 0; mb < m_iters; ++mb) {
        wg_bar_wait(&a_full[as], ap);
        const uint8_t* a = a_buf + as * QV_A_BYTES + c * QV_BOX_BYTES;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < QV_BK / 16; ++ks) {
          // the next 16 k: two swizzle atoms further when k is the row
          // (MN-major), 32 bytes further along the row when K-major
          const uint64_t da = LHS_KM
                                  ? wg_desc(a + ks * 2048, QV_BOX_BYTES, 1024)
                                  : wg_desc(a + ks * 32, 0, 1024);
          wg_mma_m64n256k16<(LHS_KM ? 1 : 0), 1>(
              acc, da, wg_desc(b + ks * 2048, QV_BOX_BYTES, 1024));
          if (OPS == 2) {
            wg_mma_m64n256k16<(LHS_KM ? 1 : 0), 1>(
                acc, da,
                wg_desc(b + QV_B_OP_BYTES + ks * 2048, QV_BOX_BYTES, 1024));
          }
        }
        wg_commit();
        wg_wait<1>();  // the previous tile's products are done
        if (lane == 0) {
          if (prev_a >= 0) wg_bar_arrive(&a_empty[prev_a]);
          if (mb == 0 && prev_b >= 0) wg_bar_arrive(&b_empty[prev_b]);
        }
        prev_a = as;
        if (++as == QV_A_STAGES) {
          as = 0;
          ap ^= 1;
        }
      }
      prev_b = bs;
      if (++bs == QV_B_STAGES) {
        bs = 0;
        bp ^= 1;
      }
    }
    wg_wait<0>();
    wg_fence_regs(acc);

    // Column sums of the warp's 16 rows: acc[4 j + 2 h + e] is row g + 8 h,
    // column 8 j + 2 (lane % 4) + e; then over the 8 groups of lanes.
#pragma unroll
    for (int j = 0; j < QV_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * j + e] + acc[4 * j + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[warp * QV_BN + 8 * j + 2 * lane + e] = s;
      }
    }
    wg_named_sync(1, 2 * 128);
    const int col = threadIdx.x - 128;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < QV_CONSUMER_WARPS; ++w) s += red[w * QV_BN + col];
    out[(long long)t * N + n0 + col] = s;
  }
}

// Tensor map of a bf16 matrix [rows][cols] (cols contiguous): 64 x 64
// boxes with the 128-byte swizzle.
static int qv_map(CUtensorMap* map, const void* p, long long rows,
                  long long cols) {
  QtEncodeTiled encode = qt_encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int MODE>
static int qv_launch(const void* lhs, const void* rhs, const void* rhs_half,
                     void* out, int K, int M, int N, int steps,
                     cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_b2;
  const int nb = qv_two(MODE) ? 2 * N : N;
  int err = qv_lhs_km(MODE) ? qv_map(&map_a, lhs, K, M)
                            : qv_map(&map_a, lhs, M, K);
  if (err == 0) err = qv_map(&map_b, rhs, K, nb);
  if (err == 0) {
    const bool half = MODE == QV_KK || MODE == QV_MK;
    err = qv_map(&map_b2, half ? rhs_half : rhs, K, N);
  }
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      qm_dot_layout_v2_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, QV_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / QV_BN, steps);
  qm_dot_layout_v2_kernel<MODE><<<grid, QV_THREADS, QV_SMEM_BYTES, stream>>>(
      map_a, map_b, map_b2, static_cast<float*>(out), K, M, N);
  return (int)cudaGetLastError();
}

// out: f32 [steps][N]. mode: 0 kk, 1 kk1, 2 mk, 3 mk1, 4 kkT. lhs and rhs
// hold the fills (qm_dot_layout_fill); rhs_half, bf16 [K][N], receives
// rhs * 0.5 in kk and mk and is not read in the other modes. K a multiple
// of 64, M of 128, N of 256, 1 <= steps <= 65535.
extern "C" int qm_dot_layout_v2(const void* lhs, const void* rhs,
                                void* rhs_half, void* out, int mode, int K,
                                int M, int N, int steps, void* stream) {
  if (mode < QV_KK || mode > QV_KKT || K < QV_BK || K % QV_BK != 0 ||
      M < QV_BM || M % QV_BM != 0 || N < QV_BN || N % QV_BN != 0 ||
      steps < 1 || steps > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == QV_KK || mode == QV_MK) {
    qm_dot_layout_v2_half_kernel<<<1024, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rhs),
        static_cast<__nv_bfloat16*>(rhs_half), (long long)K * N);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  switch (mode) {
    case QV_KK:
      return qv_launch<QV_KK>(lhs, rhs, rhs_half, out, K, M, N, steps, s);
    case QV_KK1:
      return qv_launch<QV_KK1>(lhs, rhs, rhs_half, out, K, M, N, steps, s);
    case QV_MK:
      return qv_launch<QV_MK>(lhs, rhs, rhs_half, out, K, M, N, steps, s);
    case QV_MK1:
      return qv_launch<QV_MK1>(lhs, rhs, rhs_half, out, K, M, N, steps, s);
    default:
      return qv_launch<QV_KKT>(lhs, rhs, rhs_half, out, K, M, N, steps, s);
  }
}
