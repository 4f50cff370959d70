// Device-memory -> shared-memory streaming probe, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel _stream_kernel
// (experiments/exp_dma_probe.py:48), which measures the HBM -> VMEM rate
// of large double-buffered copies with no compute: grid step t copies
// source chunk t mod n_chunks of a bf16 [n_chunks, rows, 2048] table into
// one of two VMEM slots while the other is waited on, and the output is
// the last step's staged rows 0-7, lanes 0-127, as f32 [8, 128].
//
// Design. The n_total chunks of the stream are cut into pieces of
// QS_PIECE_ROWS rows (32 KB), piece p being rows (p mod ppc) * 8 .. + 8
// of step t = p / ppc, whose chunk is t mod n_chunks (ppc = rows / 8
// pieces per chunk). A persistent grid (as many 256-thread blocks per SM
// as fit) walks the pieces: block b takes pieces b, b + gridDim.x, ...
// through a two-slot shared buffer, each piece one cp.async commit group
// of 16-byte copies: start the next piece, wait for the current one. Each
// thread reads back the first 16 bytes it staged, so the staged data stays
// live. The block holding piece (n_total - 1) * ppc, rows 0-7 of the last
// step, writes its rows 0-7, lanes 0-127 as f32 [8, 128].
//
// Bound on the card: device-memory bandwidth, n_total * rows * 4096
// bytes read once (the 512 MiB source does not fit the 50 MB L2).
// Bulk copies by the Tensor Memory Accelerator are later perf work.

#include <cuda_bf16.h>

#include "detect_core.cuh"

#define QS_THREADS 256
#define QS_ROW_BYTES 4096  // 2048 bf16
#define QS_PIECE_ROWS 8
#define QS_PIECE_BYTES (QS_PIECE_ROWS * QS_ROW_BYTES)
#define QS_OUT_ROWS 8
#define QS_OUT_LANES 128

__global__ void __launch_bounds__(QS_THREADS)
qm_stream_probe_kernel(const unsigned char* __restrict__ src, int rows,
                       int n_chunks, int n_total, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char qs_buf[];  // 2 pieces
  const int ppc = rows / QS_PIECE_ROWS;
  const long long chunk_bytes = (long long)rows * QS_ROW_BYTES;
  const long long n_pieces = (long long)n_total * ppc;
  const long long out_piece = (long long)(n_total - 1) * ppc;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  const long long my_pieces =
      first < n_pieces ? (n_pieces - first + stride - 1) / stride : 0;

  // Queue the copies of this block's k-th piece into `slot`.
  auto stage = [&](long long k, unsigned char* slot) {
    const long long p = first + k * stride;
    const long long t = p / ppc;
    const long long chunk = t - (t / n_chunks) * n_chunks;
    const unsigned char* from =
        src + chunk * chunk_bytes + (p - t * ppc) * QS_PIECE_BYTES;
    for (int c = 16 * threadIdx.x; c < QS_PIECE_BYTES; c += 16 * QS_THREADS) {
      qm_cp_async16(slot + c, from + c);
    }
  };

  unsigned live = 0;
  if (my_pieces > 0) stage(0, qs_buf);
  qm_cp_async_commit();
  for (long long k = 0; k < my_pieces; ++k) {
    unsigned char* cur = qs_buf + (k & 1) * QS_PIECE_BYTES;
    if (k + 1 < my_pieces) {
      stage(k + 1, qs_buf + ((k + 1) & 1) * QS_PIECE_BYTES);
    }
    qm_cp_async_commit();
    qm_cp_async_wait<1>();  // this thread's copies of piece k landed
    live ^= *reinterpret_cast<const unsigned*>(cur + 16 * threadIdx.x);
    if (first + k * stride == out_piece) {  // uniform in the block
      __syncthreads();                      // every thread's copies landed
      const __nv_bfloat16* staged = reinterpret_cast<const __nv_bfloat16*>(cur);
      for (int e = threadIdx.x; e < QS_OUT_ROWS * QS_OUT_LANES;
           e += QS_THREADS) {
        const int r = e / QS_OUT_LANES;
        const int l = e - r * QS_OUT_LANES;
        out[e] = __bfloat162float(staged[r * (QS_ROW_BYTES / 2) + l]);
      }
      __syncthreads();  // the slot is refilled at the next piece
    }
  }
  qm_cp_async_wait<0>();
  asm volatile("" ::"r"(live));
}

// src: bf16 [n_chunks, rows, 2048] on the device, 16-byte aligned, rows a
// multiple of QS_PIECE_ROWS; out: f32 [8, 128].
extern "C" int qm_stream_probe(const void* src, int n_chunks, int rows,
                               int n_total, void* out, void* stream) {
  if (n_chunks < 1 || n_total < 1 || rows < QS_PIECE_ROWS ||
      rows % QS_PIECE_ROWS != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = 2 * QS_PIECE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      qm_stream_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qm_stream_probe_kernel, QS_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_pieces = (long long)n_total * (rows / QS_PIECE_ROWS);
  long long blocks = (long long)n_sm * per_sm;
  if (blocks > n_pieces) blocks = n_pieces;
  qm_stream_probe_kernel<<<(unsigned)blocks, QS_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), rows, n_chunks, n_total,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
