// The chunk sum of the marginalisation kernels, M1 (migrate_marginalise.cu)
// and M1 v2 (migrate_marginalise_v2.cu): a window longer than one chunk
// writes one row of a [chunks, n_nodes] partial table a chunk, and this
// kernel adds the rows in chunk order. M1 v2 equals M1 bit for bit at one
// chunk and rounds like it beyond, so both take this one kernel. Static:
// each source that includes it keeps its own copy in the one library.
#pragma once

#include <cuda_runtime.h>

// out[n] = the sum of partial[c, n] over the chunks c, in chunk order
static __global__ void qm_marginalise_sum_chunks_kernel(
    const float* __restrict__ partial, int n_chunks, int n_nodes,
    float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  float total = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    total += partial[(long long)c * n_nodes + n];
  }
  out[n] = total;
}
