// Fused migrate-and-reduce on the VPU plan layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel _detect_kernel
// (quakemigrate_tpu/ops/pallas_migrate.py:242), reached through
// PallasDetect. That kernel runs a grid (node tile, onset) with the onset
// innermost: a (tile, samples) f32 accumulator stays in VMEM across the
// onset axis, and each node's residual shift is applied to the tile's
// onset row by a roll-and-select network (log2(r_span) static rolls),
// because the TPU has no vector gather.
//
// Contract (the same as K1, migrate_detect.cu), per
// node tile i (brick order) and scan sample t:
//   coa[n,t]  = exp(sum_o L[o, fsmp + base[i,o] + fine[i,o,n] + t]
//                   * inv_available) * valid[i,n]
//   tmax[i,t] = max_n coa;  targ[i,t] = smallest local n attaining it;
//   tsum[i,t] = sum_n coa
//
// Design: K2's structure, not its shift network. The accumulator stays
// where it is and the onsets stream past it. One block of 16 warps per
// (node tile, block of 32 scan samples): lane l owns sample s0 + l and
// warp w owns nodes w*NPT .. w*NPT + NPT - 1 (tile = 16 * NPT; NPT = 32
// at the default tile of 512), so the tile's 512 x 32 partial sums live
// in registers, NPT per thread, across the whole onset loop. Per onset
// the block stages two things in shared memory: the onset's row window
// L[o, fsmp + base[i,o] + s0 : + r_span + 32] and the tile's fine column
// fine[i,o,:]. Both are double-buffered with cp.async: onset o+1's copies
// are in flight while the block gathers onset o. A warp reads one fine
// value (a broadcast, 16 bytes at a time) and its lanes 32 consecutive
// window samples, so the gather is free of bank conflicts. Onsets are
// summed in order o = 0..O-1, as the plain version does. The epilogue is
// K1's: exp with __fmul_rn, valid, a strict > over
// ascending nodes per thread, then the smallest node index across warps.
//
// Bound on the card: shared-memory reads, as for K1
// (tile * 32 gather reads per onset and block, plus a quarter as many
// broadcast reads of fine), against (r_span + 32 + tile) floats staged
// per onset and block. Shared memory per block is O(r_span + 32 + tile),
// independent of the number of onsets, where K1
// stages all O windows at once. The cost is two barriers per onset.

#include "detect_core.cuh"

#define QV_WARPS 16
#define QV_THREADS (32 * QV_WARPS)
#define QV_SBLK 32
#define QV_RED_FLOATS (3 * QV_WARPS * QV_SBLK)

// Two blocks per SM: at most 64 registers a thread, NPT of them the sums.
template <int NPT>
__global__ void __launch_bounds__(QV_THREADS, 2)
qm_vpu_kernel(const float* __restrict__ L, int t_len,
              const int* __restrict__ base, const int* __restrict__ fine,
              const float* __restrict__ valid,
              const float* __restrict__ inv_available,
              float* __restrict__ tmax, int* __restrict__ targ,
              float* __restrict__ tsum, int n_onsets, int fsmp, int nsamples,
              int width) {
  constexpr int TILE = QV_WARPS * NPT;
  extern __shared__ float smem[];
  const int wpad = (width + 3) & ~3;
  int* fine_s = reinterpret_cast<int*>(smem);  // [2][TILE]
  float* win = smem + 2 * TILE;                // [2][wpad]
  float* red = win + 2 * wpad;                 // QV_RED_FLOATS
  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QV_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* base_i = base + (long long)tile_i * n_onsets;
  const int* fine_i = fine + (long long)tile_i * n_onsets * TILE;

  // Queue onset o's fine column and row window into buffer `buf`. Reads
  // past the row end are zero-filled; they feed only samples at or
  // beyond nsamples, which are not stored.
  auto stage = [&](int o, int buf) {
    if (tid < TILE / 4) {
      qm_cp_async16(fine_s + buf * TILE + 4 * tid,
                    fine_i + (long long)o * TILE + 4 * tid);
    }
    const long long col0 = (long long)fsmp + base_i[o] + s0;
    const float* row = L + (long long)o * t_len;
    for (int c = tid; c < width; c += QV_THREADS) {
      const long long col = col0 + c;
      const bool in_row = col < t_len;
      qm_cp_async4(win + buf * wpad + c, row + (in_row ? col : 0), in_row);
    }
  };

  float acc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) acc[j] = 0.0f;

  stage(0, 0);
  qm_cp_async_commit();
  for (int o = 0; o < n_onsets; ++o) {
    if (o + 1 < n_onsets) stage(o + 1, (o + 1) & 1);
    qm_cp_async_commit();
    qm_cp_async_wait<1>();  // this thread's copies of onset o landed
    __syncthreads();        // ... and every thread's

    const int4* f =
        reinterpret_cast<const int4*>(fine_s + (o & 1) * TILE + warp * NPT);
    const float* w = win + (o & 1) * wpad + lane;
#pragma unroll
    for (int q = 0; q < NPT / 4; ++q) {
      const int4 r = f[q];
      acc[4 * q + 0] += w[r.x];
      acc[4 * q + 1] += w[r.y];
      acc[4 * q + 2] += w[r.z];
      acc[4 * q + 3] += w[r.w];
    }
    __syncthreads();  // buffer o & 1 is refilled for onset o + 2
  }

  const float inv = *inv_available;
  const float* valid_i = valid + (long long)tile_i * TILE;
  float best = -INFINITY, total = 0.0f;
  int arg = 0;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = warp * NPT + j;
    // __fmul_rn: no contraction into expf's range reduction, so the
    // exponent argument is rounded exactly as in the plain version.
    const float coa =
        __fmul_rn(expf(__fmul_rn(acc[j], inv)), __ldg(valid_i + n));
    if (coa > best) {
      best = coa;
      arg = n;
    }
    total += coa;
  }

  float* red_max = red;
  int* red_arg = reinterpret_cast<int*>(red + QV_WARPS * QV_SBLK);
  float* red_sum = red + 2 * QV_WARPS * QV_SBLK;
  red_max[warp * QV_SBLK + lane] = best;
  red_arg[warp * QV_SBLK + lane] = arg;
  red_sum[warp * QV_SBLK + lane] = total;
  __syncthreads();

  if (tid < QV_SBLK && s0 + tid < nsamples) {
    float m = red_max[tid];
    int a = red_arg[tid];
    float s = red_sum[tid];
    for (int v = 1; v < QV_WARPS; ++v) {
      const float mv = red_max[v * QV_SBLK + tid];
      const int av = red_arg[v * QV_SBLK + tid];
      if (mv > m || (mv == m && av < a)) {
        m = mv;
        a = av;
      }
      s += red_sum[v * QV_SBLK + tid];
    }
    const long long out = (long long)tile_i * nsamples + s0 + tid;
    tmax[out] = m;
    targ[out] = a;
    tsum[out] = s;
  }
}

template <int NPT>
static int qm_launch_vpu(const void* L, int t_len, const void* base,
                         const void* fine, const void* valid,
                         const void* inv_available, void* tmax, void* targ,
                         void* tsum, int n_onsets, int n_tiles, int fsmp,
                         int nsamples, int width, void* stream) {
  const int wpad = (width + 3) & ~3;
  const int smem =
      (2 * QV_WARPS * NPT + 2 * wpad + QV_RED_FLOATS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qm_vpu_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QV_SBLK - 1) / QV_SBLK);
  qm_vpu_kernel<NPT><<<grid, QV_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const int*>(fine), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, fsmp,
      nsamples, width);
  return (int)cudaGetLastError();
}

// tile must be 64, 128, 256 or 512 (16 warps x 4, 8, 16 or 32 nodes);
// fine must be 16-byte aligned.
extern "C" int qm_migrate_detect_vpu(const void* L, int t_len,
                                     const void* base, const void* fine,
                                     const void* valid,
                                     const void* inv_available, void* tmax,
                                     void* targ, void* tsum, int n_onsets,
                                     int n_tiles, int tile, int fsmp,
                                     int nsamples, int r_span, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || nsamples < 1 || r_span < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int width = r_span + QV_SBLK;
#define QV_TILE_CASE(NPT)                                                   \
  case QV_WARPS * NPT:                                                      \
    return qm_launch_vpu<NPT>(L, t_len, base, fine, valid, inv_available,   \
                              tmax, targ, tsum, n_onsets, n_tiles, fsmp,    \
                              nsamples, width, stream);
  switch (tile) {
    QV_TILE_CASE(4)
    QV_TILE_CASE(8)
    QV_TILE_CASE(16)
    QV_TILE_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QV_TILE_CASE
}
