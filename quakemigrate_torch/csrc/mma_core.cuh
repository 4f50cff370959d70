// Tensor-core helpers of the bf16 kernels for Hopper (sm_90a): the
// warp-level product mma.sync m16n8k16 (bf16 inputs, f32 accumulators),
// ldmatrix, and the fragment index maps of the PTX ISA ("Matrix fragments
// for mma.m16n8k16 with floating point type"), for dot_layout.cu and
// migrate_detect_x16g.cu.
//
// Fragments of one m16n8k16 product D[16 x 8] += A[16 x 16] * B[16 x 8],
// for lane l of the warp, with g = l / 4 (the group) and c = l % 4:
//   A, 4 registers of 2 bf16 (row-major, "row"):
//     a0 = A[g][2c, 2c+1],    a1 = A[g+8][2c, 2c+1],
//     a2 = A[g][2c+8, 2c+9],  a3 = A[g+8][2c+8, 2c+9];
//   B, 2 registers of 2 bf16 (column-major, "col"):
//     b0 = B[2c, 2c+1][g],    b1 = B[2c+8, 2c+9][g];
//   C and D, 4 floats:
//     c0, c1 = C[g][2c, 2c+1],  c2, c3 = C[g+8][2c, 2c+1].
// In a register of 2 bf16 the element of the lower index sits in the low
// 16 bits.
//
// ldmatrix.x4 loads four 8 x 8 matrices of b16 from shared memory: lanes
// 8j .. 8j+7 give the addresses of the 8 rows (16 bytes each, 16-byte
// aligned) of matrix j, and register j of lane l receives row l / 4,
// elements 2 (l % 4) and 2 (l % 4) + 1 of matrix j; with .trans, elements
// (rows) 2 (l % 4) and 2 (l % 4) + 1 of column l / 4 instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// bf16 1.0 in a register half.
#define QT_BF16_ONE 0x3F80u

__device__ __forceinline__ int qt_group(int lane) { return lane >> 2; }
__device__ __forceinline__ int qt_quad(int lane) { return lane & 3; }

// D = A * B + C, m16n8k16, bf16 x bf16 -> f32, accumulating in place.
__device__ __forceinline__ void qt_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned qt_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: `row` is this lane's row
// address (see above).
__device__ __forceinline__ void qt_ldmatrix_x4(unsigned (&r)[4],
                                               const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(qt_smem_addr(row)));
}

__device__ __forceinline__ void qt_ldmatrix_x4_trans(unsigned (&r)[4],
                                                     const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(qt_smem_addr(row)));
}

// Row (and 8-element column block) of the stored matrix whose address
// lane l gives to ldmatrix.x4 for each operand layout. `pitch` is the row
// pitch in elements; every row start must be 16-byte aligned.
//
// A fragment (16 x 16 at m0, k0) from A stored row-major [m][k], plain
// ldmatrix: matrix j covers rows 8 (j % 2), columns 8 (j / 2).
__device__ __forceinline__ const __nv_bfloat16* qt_a_rowmajor_addr(
    const __nv_bfloat16* s, int pitch, int m0, int k0, int lane) {
  return s + (m0 + (lane & 15)) * pitch + k0 + ((lane >> 4) << 3);
}

// A fragment (16 x 16 at m0, k0) from A stored column-major, i.e. as
// [k][m], with ldmatrix.trans: matrix j covers k 8 (j / 2), m 8 (j % 2).
__device__ __forceinline__ const __nv_bfloat16* qt_a_colmajor_addr(
    const __nv_bfloat16* s, int pitch, int m0, int k0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 +
         (((lane >> 3) & 1) << 3);
}

// B fragments of two n8 tiles (16 x 16 at k0, n0) from B stored [k][n],
// with ldmatrix.trans: registers (0, 1) are (b0, b1) of columns n0..n0+7,
// registers (2, 3) those of n0+8..n0+15.
__device__ __forceinline__ const __nv_bfloat16* qt_b_kn_addr(
    const __nv_bfloat16* s, int pitch, int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 +
         ((lane >> 4) << 3);
}

// Two bf16 of a register multiplied by 0.5 (exact in bf16 unless either
// underflows, which the fills here never do).
__device__ __forceinline__ unsigned qt_half(unsigned x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hmul2(v, __float2bfloat162_rn(0.5f));
  return *reinterpret_cast<unsigned*>(&v);
}
