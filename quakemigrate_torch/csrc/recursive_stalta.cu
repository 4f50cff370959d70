// R1: recursive (exponential-decay) STA/LTA, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes it with an XLA
// associative scan, quakemigrate_tpu/ops/stalta.py:84 (recursive_sta_lta),
// as it does the fallback detect reduction and the locate passes that K3,
// M1 and M2 replace. Contract, per row of x [rows, n]:
//
//   sta_i = c_sta * x_i + (1 - c_sta) * sta_{i-1},  sta_{-1} = 0,
//   likewise lta with c_lta, with x_0 taken as 0 and the decay at i = 0
//   as 0 (the reference's recursion starts at sample 1);
//   onset_i = sta_i / max(lta_i, tiny), onset_0 = 0, and onset_i = 1 for
//   i < nlta when null_head (nlta < n).
//
// Design. A recursion is an affine map per sample, s -> m_i * s + v_i
// (m_i = 1 - c, v_i = c * x_i), and maps compose associatively:
// (m, v) then (m', v') is (m * m', v * m' + v'). One block takes one row
// and walks it in chunks of R1_CHUNK samples, carrying the state across
// chunks. Per chunk: the samples are staged through shared memory, so the
// global reads and writes are coalesced; each thread composes the maps of
// its R1_SPT consecutive samples into one pair, for sta and lta together;
// a block-wide exclusive scan of the pairs (warp shuffles, then the warp
// totals through shared memory) gives each thread the map from the
// chunk's carried-in state to its first sample; a second pass runs the
// recursion over its samples from that state and writes the onset back to
// shared memory, whence the block stores it. The kernel multiplies and
// adds only, and divides once a sample by max(lta, tiny): a decay product
// that underflows to 0 is the correct limit of the map and needs no care.
//
// Bound on the card: device-memory bandwidth, rows * n * sizeof(T) read
// once and written once (a handful of operations a sample). One block a
// row keeps the carry in the block; rows below twice the SM count leave
// SMs idle, which is later work (segments with a look-back of the carry).

#include <cfloat>
#include <cuda_runtime.h>

#define R1_THREADS 512
#define R1_SPT 8
#define R1_CHUNK (R1_THREADS * R1_SPT)
#define R1_WARPS (R1_THREADS / 32)

template <typename T>
struct R1Pair {
  T m, v;
};

// a then b
template <typename T>
__device__ __forceinline__ R1Pair<T> r1_combine(R1Pair<T> a, R1Pair<T> b) {
  return {a.m * b.m, a.v * b.m + b.v};
}

template <typename T>
__device__ __forceinline__ T r1_tiny();
template <>
__device__ __forceinline__ float r1_tiny<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double r1_tiny<double>() { return DBL_MIN; }

// Inclusive scan of a pair over the lanes of a warp.
template <typename T>
__device__ __forceinline__ R1Pair<T> r1_warp_scan(R1Pair<T> p, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T m = __shfl_up_sync(0xffffffffu, p.m, off);
    const T v = __shfl_up_sync(0xffffffffu, p.v, off);
    if (lane >= off) p = r1_combine<T>({m, v}, p);
  }
  return p;
}

// The pair before this lane's (identity at lane 0), from the inclusive one.
template <typename T>
__device__ __forceinline__ R1Pair<T> r1_exclusive(R1Pair<T> incl, int lane) {
  const T m = __shfl_up_sync(0xffffffffu, incl.m, 1);
  const T v = __shfl_up_sync(0xffffffffu, incl.v, 1);
  return lane == 0 ? R1Pair<T>{T(1), T(0)} : R1Pair<T>{m, v};
}

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
qm_recursive_stalta_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int n, T c_sta, T d_sta, T c_lta, T d_lta,
                           int nlta, int null_head) {
  extern __shared__ __align__(16) unsigned char r1_smem[];
  T* buf = reinterpret_cast<T*>(r1_smem);  // one chunk of the row
  __shared__ R1Pair<T> warp_sta[R1_WARPS], warp_lta[R1_WARPS];
  __shared__ T carry_out[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  const T tiny = r1_tiny<T>();
  T carry_sta = T(0), carry_lta = T(0);

  for (long long base = 0; base < n; base += R1_CHUNK) {
    const int len = (int)min((long long)R1_CHUNK, n - base);
    for (int e = tid; e < len; e += R1_THREADS) buf[e] = xr[base + e];
    __syncthreads();

    // Pass 1: this thread's samples as one map each for sta and lta.
    const int first = tid * R1_SPT;
    T xs[R1_SPT];
    R1Pair<T> ps = {T(1), T(0)}, pl = {T(1), T(0)};
#pragma unroll
    for (int j = 0; j < R1_SPT; ++j) {
      const long long i = base + first + j;
      xs[j] = first + j < len ? buf[first + j] : T(0);
      if (first + j < len) {
        const T xi = i == 0 ? T(0) : xs[j];
        const T ds = i == 0 ? T(0) : d_sta, dl = i == 0 ? T(0) : d_lta;
        ps = {ps.m * ds, ps.v * ds + c_sta * xi};
        pl = {pl.m * dl, pl.v * dl + c_lta * xi};
      }
    }

    // Block-wide exclusive scan of the pairs.
    const R1Pair<T> is = r1_warp_scan(ps, lane), il = r1_warp_scan(pl, lane);
    if (lane == 31) {
      warp_sta[warp] = is;
      warp_lta[warp] = il;
    }
    __syncthreads();
    if (warp == 0) {
      R1Pair<T> ws = {T(1), T(0)}, wl = {T(1), T(0)};
      if (lane < R1_WARPS) {
        ws = warp_sta[lane];
        wl = warp_lta[lane];
      }
      ws = r1_warp_scan(ws, lane);
      wl = r1_warp_scan(wl, lane);
      if (lane < R1_WARPS) {
        warp_sta[lane] = ws;
        warp_lta[lane] = wl;
      }
    }
    __syncthreads();
    R1Pair<T> es = r1_exclusive(is, lane), el = r1_exclusive(il, lane);
    if (warp > 0) {
      es = r1_combine(warp_sta[warp - 1], es);
      el = r1_combine(warp_lta[warp - 1], el);
    }

    // Pass 2: the recursion over this thread's samples from its state.
    T sta = es.m * carry_sta + es.v, lta = el.m * carry_lta + el.v;
#pragma unroll
    for (int j = 0; j < R1_SPT; ++j) {
      const long long i = base + first + j;
      if (first + j < len) {
        if (i == 0) {
          sta = T(0);
          lta = T(0);
        } else {
          sta = c_sta * xs[j] + d_sta * sta;
          lta = c_lta * xs[j] + d_lta * lta;
        }
        T onset = sta / max(lta, tiny);
        if (i == 0) onset = T(0);
        if (null_head && i < nlta) onset = T(1);
        buf[first + j] = onset;
      }
    }
    if (tid == R1_THREADS - 1) {  // its samples end the chunk (or pad it)
      carry_out[0] = sta;
      carry_out[1] = lta;
    }
    __syncthreads();
    carry_sta = carry_out[0];
    carry_lta = carry_out[1];
    for (int e = tid; e < len; e += R1_THREADS) orow[base + e] = buf[e];
    __syncthreads();  // the buffer and the carry are refilled next chunk
  }
}

template <typename T>
static int r1_launch(const void* x, void* out, int rows, int n, int nsta,
                     int nlta, void* stream) {
  if (rows < 0 || n < 0 || nsta < 1 || nlta < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || n == 0) return (int)cudaSuccess;
  const double c_sta = 1.0 / nsta, c_lta = 1.0 / nlta;
  qm_recursive_stalta_kernel<T>
      <<<rows, R1_THREADS, R1_CHUNK * sizeof(T),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<T*>(out), n, (T)c_sta,
          (T)(1.0 - c_sta), (T)c_lta, (T)(1.0 - c_lta), nlta,
          nlta < n ? 1 : 0);
  return (int)cudaGetLastError();
}

// x, out: [rows, n] contiguous on the device, float32 or float64.
extern "C" int qm_recursive_stalta_f32(const void* x, void* out, int rows,
                                       int n, int nsta, int nlta,
                                       void* stream) {
  return r1_launch<float>(x, out, rows, n, nsta, nlta, stream);
}

extern "C" int qm_recursive_stalta_f64(const void* x, void* out, int rows,
                                       int n, int nsta, int nlta,
                                       void* stream) {
  return r1_launch<double>(x, out, rows, n, nsta, nlta, stream);
}
