// Fused migrate-and-reduce for the detect stage, redesigned for Hopper's
// shared-memory pipe (sm_90a): K1 v2.
//
// Replaces the TPU kernel _mxu_detect_kernel
// (quakemigrate_tpu/ops/pallas_migrate.py:399), as K1 (migrate_detect.cu)
// does, with K1's contract bit for bit (tmax, targ, tsum):
//   coa[n,t]  = exp(sum_o L[o, fsmp + base[i,o] + fine[i,o,n] + t]
//                   * inv_available) * valid[i,n]
//   tmax[i,t] = max_n coa;  targ[i,t] = first local n attaining it;
//   tsum[i,t] = sum_n coa
// for every input whose exp(sum * inv_available) is finite at the
// padding nodes (the only nodes where v2 and K1 may differ: K1 multiplies
// that value by 0, v2 does not compute it).
//
// Bound on the card: the shared-memory (L1) pipe. K1's gather is 93.5 %
// of its time; per (node, onset) it issues 4 conflict-free 4-byte LDS
// (one wavefront each) and one warp-uniform LDG of the residual, which
// rides the same pipe, and its address arithmetic is redone per node and
// onset. What each design item does about it:
//
// 1. The residuals leave the global-load path. The host keeps a
//    node-major int16 table fine16 [n_tiles, tile, O]. Each block stages
//    its tile's slab once, as uint16 rows of O rounded up to 8 entries
//    (16 bytes), holding off[o] + fine: the window offset of each onset
//    is added here, once per block, not per node. A warp then reads a
//    node's residuals as broadcast 16-byte loads, 8 onsets a load (3 a
//    node at O = 24), in place of O LDGs. `valid` is staged too (tile
//    floats), so the loop issues no global load at all.
// 2. Padding nodes skip the gather, and only the gather: for valid[n] ==
//    0 (warp-uniform, a warp owns the node) acc stays 0 and the epilogue
//    runs unchanged: exp(0) * 0 = 0 enters max and sum as K1's
//    exp(acc) * 0 does. About 6 % of the reads at Icequake.
// 3. Two nodes per warp iteration, same order: warp w takes the pairs
//    (n, n + 8) for n = w, w + 16, ..., gathers both (8 independent LDS a
//    lane per onset instead of 4) and folds n, then n + 8, into the
//    partials, so each thread sees its nodes in K1's order. Every onset
//    sum keeps order o = 0..O-1, so tmax, targ and tsum equal K1's.
// 4. Per-onset window widths: onset o's window spans span_off[o + 1] -
//    span_off[o] = r_spans[o] + QM_SBLK floats (QmTable), not the
//    uniform r_span + QM_SBLK; P windows are about half as wide as S.
// 5. K1's schedule: one block per (node tile, QM_SBLK-sample block) and
//    8 warps, with K1's resident blocks per SM (__launch_bounds__), so
//    as many warps hide shared-memory latency as in K1.
//
// Shared memory of a block (bytes, all regions 16-byte aligned):
//   off  int32 [O + 1, rounded up to 4]   window offsets (span_off)
//   vld  f32   [tile]                     valid
//   slab u16   [tile, round_up(O, 8)]     off[o] + fine[n, o]
//   win  f32   [span_off[O]]              the onsets' windows
// and the cross-warp reduction (QM_RED_FLOATS) reuses slab and win. The
// slab entries are below span_off[O], which the shared-memory limit keeps
// under 2^16.
//
// The kernel is a template on the reduction variant (QmVariant):
// QM_FULL is the production kernel; QM_NOREDUCE (tmax = acc of node 0,
// tsum = acc of node 1, with padding nodes' acc left at 0 as above) and
// QM_NOGATHER (the staged windows at residual 0) are its ablations.

#include "detect_v2_core.cuh"

// Resident blocks per SM the kernel is built for: K1's.
#define QV_MIN_BLOCKS 6

// Ints of the offset table: O + 1 rounded up to 4.
__host__ __device__ __forceinline__ int qv_off_ints(int n_onsets) {
  return (n_onsets + 4) & ~3;
}

static int qv_smem_bytes(int n_onsets, int tile, int win_floats) {
  int body = 2 * tile * qv_row(n_onsets) + 4 * win_floats;
  if (body < 4 * QM_RED_FLOATS) body = 4 * QM_RED_FLOATS;
  return 4 * (qv_off_ints(n_onsets) + tile) + body;
}

template <int V>
__global__ void __launch_bounds__(QM_THREADS, QV_MIN_BLOCKS)
qm_migrate_detect_v2_kernel(const float* __restrict__ L, int t_len,
                            const int* __restrict__ base,
                            const short* __restrict__ fine16,
                            const float* __restrict__ valid,
                            const float* __restrict__ inv_available,
                            const int* __restrict__ span_off,
                            float* __restrict__ tmax, int* __restrict__ targ,
                            float* __restrict__ tsum, int n_onsets, int tile,
                            int fsmp, int nsamples) {
  static_assert(V == QM_FULL || V == QM_NOREDUCE || V == QM_NOGATHER,
                "v2 is built for FULL, NOREDUCE and NOGATHER");
  extern __shared__ __align__(16) unsigned char qv_smem[];
  const int row = qv_row(n_onsets);
  int* off = reinterpret_cast<int*>(qv_smem);
  float* vld = reinterpret_cast<float*>(off + qv_off_ints(n_onsets));
  unsigned short* slab = reinterpret_cast<unsigned short*>(vld + tile);
  float* win = reinterpret_cast<float*>(slab + tile * row);
  const int tile_i = blockIdx.x;
  const int s0 = blockIdx.y * QM_SBLK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int o = tid; o <= n_onsets; o += QM_THREADS) off[o] = span_off[o];
  for (int n = tid; n < tile; n += QM_THREADS) {
    vld[n] = valid[(long long)tile_i * tile + n];
  }
  __syncthreads();

  // Onset o's window, warp o % QM_NWARPS, lanes on consecutive samples.
  // Reads past the row end become 0: they feed only samples at or beyond
  // nsamples (the host checks fsmp + nsamples + max shift <= t_len).
  const int* base_i = base + (long long)tile_i * n_onsets;
  for (int o = warp; o < n_onsets; o += QM_NWARPS) {
    const int width = off[o + 1] - off[o];
    const long long col0 = (long long)fsmp + base_i[o] + s0;
    const float* src = L + (long long)o * t_len;
    float* dst = win + off[o];
    for (int c = lane; c < width; c += 32) {
      const long long col = col0 + c;
      dst[c] = col < t_len ? src[col] : 0.0f;
    }
  }
  // The slab: element k of the tile's [tile, O] residuals is (n, o), the
  // pair stepped by QM_THREADS elements without a division per element.
  {
    const short* fine_i = fine16 + (long long)tile_i * tile * n_onsets;
    const int dn = QM_THREADS / n_onsets;
    const int dout = QM_THREADS - dn * n_onsets;
    int n = tid / n_onsets;
    int o = tid - n * n_onsets;
    for (int k = tid; k < tile * n_onsets; k += QM_THREADS) {
      slab[n * row + o] = static_cast<unsigned short>(off[o] + fine_i[k]);
      n += dn;
      o += dout;
      if (o >= n_onsets) {
        o -= n_onsets;
        ++n;
      }
    }
  }
  __syncthreads();

  const long long out_row = (long long)tile_i * nsamples;
  if constexpr (V == QM_NOGATHER) {
    qm_staged_sum(win, QmTable{off}, n_onsets, tmax, targ, tsum, out_row, s0,
                  nsamples);
  } else {
    const float inv = *inv_available;
    const float* wl = win + lane;
    QvPartial p;
    for (int n = warp; n < tile; n += 2 * QM_NWARPS) {
      const int m = n + QM_NWARPS;
      const float va = vld[n];
      const float vb = vld[m];
      float acc_n[QM_SPT], acc_m[QM_SPT];
#pragma unroll
      for (int k = 0; k < QM_SPT; ++k) acc_n[k] = acc_m[k] = 0.0f;
      const uint4* rn = reinterpret_cast<const uint4*>(slab + n * row);
      const uint4* rm = reinterpret_cast<const uint4*>(slab + m * row);
      if (va != 0.0f && vb != 0.0f) {
        qv_gather<2>(wl, rn, rm, n_onsets, acc_n, acc_m);
      } else if (va != 0.0f) {
        qv_gather<1>(wl, rn, rn, n_onsets, acc_n, acc_n);
      } else if (vb != 0.0f) {
        qv_gather<1>(wl, rm, rm, n_onsets, acc_m, acc_m);
      }
      qv_fold<V>(p, acc_n, n, va, inv);
      qv_fold<V>(p, acc_m, m, vb, inv);
    }
    // The reduction reuses the slab and the windows.
    qv_reduce_warps<V>(p, reinterpret_cast<float*>(slab), tmax, targ, tsum,
                       out_row, s0, nsamples);
  }
}

template <int V>
static int qv_launch(const void* L, int t_len, const void* base,
                     const void* fine16, const void* valid,
                     const void* inv_available, const void* span_off,
                     void* tmax, void* targ, void* tsum, int n_onsets,
                     int n_tiles, int tile, int fsmp, int nsamples,
                     int win_floats, void* stream) {
  if (n_onsets < 1 || n_tiles < 1 || tile < 2 * QM_NWARPS ||
      tile % (2 * QM_NWARPS) != 0 || nsamples < 1 ||
      win_floats < n_onsets * (QM_SBLK + 1) || win_floats > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = qv_smem_bytes(n_onsets, tile, win_floats);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_v2_kernel<V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (nsamples + QM_SBLK - 1) / QM_SBLK);
  qm_migrate_detect_v2_kernel<V><<<grid, QM_THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), t_len, static_cast<const int*>(base),
      static_cast<const short*>(fine16), static_cast<const float*>(valid),
      static_cast<const float*>(inv_available),
      static_cast<const int*>(span_off), static_cast<float*>(tmax),
      static_cast<int*>(targ), static_cast<float*>(tsum), n_onsets, tile,
      fsmp, nsamples);
  return (int)cudaGetLastError();
}

// span_off: int32 [n_onsets + 1] on the device, span_off[0] = 0,
// span_off[o + 1] - span_off[o] >= r_spans[o] + QM_SBLK, and
// span_off[n_onsets] = win_floats. fine16: int16 [n_tiles, tile,
// n_onsets], each residual below its onset's r_span.
extern "C" int qm_migrate_detect_v2(const void* L, int t_len, const void* base,
                                    const void* fine16, const void* valid,
                                    const void* inv_available,
                                    const void* span_off, void* tmax,
                                    void* targ, void* tsum, int n_onsets,
                                    int n_tiles, int tile, int fsmp,
                                    int nsamples, int win_floats,
                                    void* stream) {
  return qv_launch<QM_FULL>(L, t_len, base, fine16, valid, inv_available,
                            span_off, tmax, targ, tsum, n_onsets, n_tiles,
                            tile, fsmp, nsamples, win_floats, stream);
}

// The same launch with the reduction variant `variant`: QM_FULL,
// QM_NOREDUCE or QM_NOGATHER (a QmVariant).
extern "C" int qm_migrate_detect_v2_ablate(
    const void* L, int t_len, const void* base, const void* fine16,
    const void* valid, const void* inv_available, const void* span_off,
    void* tmax, void* targ, void* tsum, int n_onsets, int n_tiles, int tile,
    int fsmp, int nsamples, int win_floats, int variant, void* stream) {
#define QV_ABLATE_CASE(V)                                                     \
  case V:                                                                     \
    return qv_launch<V>(L, t_len, base, fine16, valid, inv_available,         \
                        span_off, tmax, targ, tsum, n_onsets, n_tiles, tile,  \
                        fsmp, nsamples, win_floats, stream);
  switch (variant) {
    QV_ABLATE_CASE(QM_FULL)
    QV_ABLATE_CASE(QM_NOREDUCE)
    QV_ABLATE_CASE(QM_NOGATHER)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QV_ABLATE_CASE
}

// Resident blocks per SM of the production variant at this geometry,
// from the occupancy API; a negative value is minus a CUDA error code.
extern "C" int qm_migrate_detect_v2_blocks_per_sm(int n_onsets, int tile,
                                                  int win_floats) {
  const int smem = qv_smem_bytes(n_onsets, tile, win_floats);
  cudaError_t err = cudaFuncSetAttribute(
      qm_migrate_detect_v2_kernel<QM_FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qm_migrate_detect_v2_kernel<QM_FULL>, QM_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
