// TMA for the detect kernels that stage onset windows on Hopper (sm_90a):
// a tensor map over the float32 onset rows L [O, t_len], whose tiled
// boxes of 1 x `box` floats land at 128-byte-aligned shared addresses and
// read columns past t_len as 0, and the plain bulk copy (no tensor map)
// of a contiguous run of bytes. Used by migrate_detect_pipelined_v2.cu
// and migrate_detect_resident_v2.cu, and its tensor-map encoder lookup by
// dot_layout_v2.cu; the mbarrier and tensor-load helpers are
// wgmma_core.cuh's.
//
// Alignment (CUDA programming guide, "Asynchronous Data Copies using the
// Tensor Memory Accelerator"): a tiled load's shared destination 128
// bytes, the map's global address and row pitch 16 bytes, the box's inner
// extent a multiple of 16 bytes (4 floats) and at most 256 elements; a
// bulk copy's source, destination and size 16 bytes. And the box's
// inner start coordinate a multiple of 16 bytes: on the H100 a load at
// an unaligned column of a float map faults ("an illegal instruction was
// encountered"); starts past the row end or before column 0 are
// zero-filled. So the kernels load from the column rounded down to 4 and
// the host folds the 0-3 floats of misalignment into their slabs.

#pragma once

#include <dlfcn.h>

#include "wgmma_core.cuh"

// Shared-memory alignment of a tiled TMA destination, in floats.
#define QT_ALIGN_FLOATS 32

// cuTensorMapEncodeTiled belongs to libcuda's API, not the runtime's: it
// is taken from libcuda.so.1, which the CUDA runtime has loaded already,
// so the kernel library needs no link against libcuda.
typedef CUresult (*QtEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static QtEncodeTiled qt_encode_tiled() {
  static QtEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) {
      fn = reinterpret_cast<QtEncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// Tensor map of the float32 rows L [n_rows][t_len] with row pitch `ld`
// floats (ld >= t_len, a multiple of 4): boxes of 1 row x `box` columns,
// no swizzle, columns at or past t_len filled with 0. Returns 0 or a CUDA
// error code.
static int qt_row_map(CUtensorMap* map, const void* L, int n_rows, int t_len,
                      int ld, int box) {
  if (reinterpret_cast<uintptr_t>(L) % 16 != 0 || ld % 4 != 0 ||
      ld < t_len || box % 4 != 0 || box < 4 || box > 256) {
    return (int)cudaErrorInvalidValue;
  }
  QtEncodeTiled encode = qt_encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)t_len, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box_dims[2] = {(cuuint32_t)box, 1};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(L), dims,
      strides, box_dims, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// `bytes` bytes from global `src` into shared `dst`, completing on `bar`
// (which must expect them).
__device__ __forceinline__ void qt_bulk_load(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg_smem(dst)),
      "l"(src), "r"(bytes), "r"(wg_smem(bar))
      : "memory");
}

// The largest byte count one mbarrier phase may expect (its tx-count).
#define QT_MAX_TX_BYTES ((1 << 20) - 1)
