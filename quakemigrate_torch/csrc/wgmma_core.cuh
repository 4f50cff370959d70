// Hopper (sm_90a) building blocks of the warp-specialised tensor-core
// kernels: mbarriers, TMA tile loads from a CUtensorMap, wgmma shared-memory
// descriptors for the 128-byte swizzle, the m64n256k16 bf16 product with
// f32 accumulators, and setmaxnreg. First used by dot_layout_v2.cu.
//
// Fragment of the m64nNk16 accumulator (PTX ISA, "Matrix fragments for
// wgmma .m64nNk16", D of type f32): thread x of the warpgroup, with
// w = x / 32 (its warp), l = x % 32, g = l / 4 and c = l % 4, holds N / 2
// floats d[i]; for i = 4 j + 2 h + e (j < N / 8, h and e in {0, 1}):
//   d[i] = D[16 w + g + 8 h][8 j + 2 c + e].
// That is the mma.sync m16n8 C fragment (mma_core.cuh) repeated over the
// N / 8 column octets, and over the four warps for rows 16 w .. 16 w + 15.
//
// Shared-memory operands with the 128-byte swizzle. A TMA box whose inner
// dimension is 64 bf16 (128 bytes) lands as rows of 128 bytes, swizzled in
// atoms of 8 rows (1024 bytes), so every stage buffer must be
// 1024-byte aligned (the descriptors' base offset is then 0). The
// descriptor (64 bits): start address >> 4 in bits 0-13, leading byte
// offset (LBO) >> 4 in bits 16-29, stride byte offset (SBO) >> 4 in bits
// 32-45, layout 1 (128-byte swizzle) in bits 62-63. For an operand
// tile of MN x K values (A: M = 64; B: N = 256; K = 16 per instruction):
//   K-major (K contiguous, box {64 K, rows}): a row is one m (or n), 8
//     rows make an atom; SBO = 1024 (the next 8 rows), LBO unused for a
//     swizzled K-major operand; the next 16 k start 32 bytes further in
//     the same rows (the swizzle is a function of the address, hence the
//     1024-byte alignment).
//   MN-major (MN contiguous, box {64 MN, K rows}): a row is one k, holding
//     64 consecutive m (or n); SBO = 1024 (the next 8 k), LBO = the
//     distance between blocks of 64 MN values (boxes laid side by side);
//     the next 16 k start 2048 bytes further (two atoms).
// The transpose bits of wgmma (imm-trans-a, imm-trans-b) select MN-major
// for bf16; both operands of a bf16 product may take either order.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t wg_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void wg_bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_smem(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void wg_bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void wg_bar_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          wg_smem(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void wg_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wg_smem(bar))
               : "memory");
}

__device__ __forceinline__ bool wg_bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t wg_globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's current phase differs from `parity`, i.e. the
// phase of that parity has completed. A wait of more than 4 s can only be
// a broken ring: it traps, so that the launch fails with an error instead
// of hanging the card.
__device__ __forceinline__ void wg_bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = wg_smem(bar);
  if (wg_bar_try(addr, parity)) return;
  const uint64_t start = wg_globaltimer_ns();
  while (!wg_bar_try(addr, parity)) {
    if (wg_globaltimer_ns() - start > 4000000000ull) __trap();
  }
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void wg_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of `map` at (c0 inner, c1 outer) into `dst`, completing on `bar`.
__device__ __forceinline__ void wg_tma_load_2d(void* dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (see above).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((wg_smem(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// a wait (their registers belong to the asynchronous product until then).
template <int R>
__device__ __forceinline__ void wg_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], bf16 x bf16 -> f32, both from
// shared memory. TRANS_A / TRANS_B: 1 if that operand is MN-major.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wg_mma_m64n256k16(float (&d)[128],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// ---- registers ----------------------------------------------------------

// Give this warpgroup's registers back (producer) or take more (consumers);
// all four warps of the warpgroup execute it.
template <int REGS>
__device__ __forceinline__ void wg_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void wg_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Named barrier over `count` threads (a multiple of 32), id 1..15.
__device__ __forceinline__ void wg_named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
