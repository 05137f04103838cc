// Hopper building blocks of the bf16 wgmma kernels (A-J): mbarriers, TMA
// tile loads (cp.async.bulk.tensor) and bulk copies, warpgroup products
// (wgmma) with shared-memory descriptors, the accumulator epilogue, the
// GEGLU gate, the (128, 128) tile loop of kernels H and J, and the
// host-side tensor-map encoder.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box of
// 64 bf16 columns (128 bytes) by R rows lands as R rows of 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8). Every tile starts on
// a 1024-byte boundary (the swizzle atom: 8 rows). A wgmma descriptor then
// names such a tile by its start address, a stride of 1024 bytes between
// 8-row groups (SBO) and layout type 1 (128-byte swizzle):
//  - K-major (the contraction index along the 128-byte rows, as Q and K are
//    stored): one k16 step is 32 bytes along the row, so step kk starts at
//    tile + 32 * kk bytes;
//  - MN-major (rows are the contraction index, as V's rows are keys): one
//    k16 step is two 8-row groups, so step kk starts at tile + 2048 * kk.
//    An operand wider than 64 columns is stored as 64-column blocks of
//    R x 128 bytes one after another; the descriptor's leading byte offset
//    (LBO) is the distance between two blocks (desc_sw128_mn).
// The accumulator of m64nNk16 gives warp w of the warpgroup rows 16w..16w+15;
// lane l holds, for each 8-column chunk c, (row l/4, columns 8c + 2(l%4) + 0,
// 1) in d[4c], d[4c+1] and the same columns of row l/4 + 8 in d[4c+2],
// d[4c+3]. Two neighbouring chunks 2i, 2i+1 packed to bf16 pairs are exactly
// the register A operand of a k16 step over those 16 columns.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace lvd {
namespace hop {

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of asynchronous (TMA) traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the barrier's phase with this parity has completed. A phase
// that never completes (a lost arrival or byte count) traps after about
// 2^28 polls, seconds, rather than hang the card; a real wait here lasts
// one tile's loads or products.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// Orders this thread's generic-proxy writes to shared memory before later
// asynchronous-proxy (TMA) accesses of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The same for this thread's writes to any state space (global memory
// read back by a TMA bulk copy of the same block).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA ----
// One box of a 2-D tensor map at (c0, c1) (column, row); rows or columns
// outside the tensor (negative included) read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// A plain bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copies one box of a 3-D tensor map at coordinates (c0, c1, c2) (innermost
// first) into shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copies one box of a 4-D tensor map at coordinates (c0, c1, c2, c3)
// (innermost first) into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ----
// Descriptor of a 128-byte-swizzled tile (see the note at the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Descriptor of an MN-major operand of 64-column blocks `lbo_bytes` apart
// (see the note at the top), each block a 128-byte-swizzled tile.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p, uint32_t lbo_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n128k16, bf16 in, fp32 accumulators; A and B from shared
// memory through descriptors (both K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulators; A and B from shared
// memory through descriptors (both K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n32k16, bf16 in, fp32 accumulators; A and B from shared
// memory through descriptors (both K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulators; A from registers (the
// accumulator layout of a previous product, packed to bf16 pairs), B from
// shared memory K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, bf16 in, fp32 accumulators; A from registers (the
// accumulator layout of a previous product, packed to bf16 pairs), B from
// shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64_tn(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A B, m64n128k16, bf16 in, fp32 accumulators; A from shared memory
// K-major, B from shared memory MN-major (transposed: N contiguous, two
// 64-column blocks, desc_sw128_mn); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128_tn(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulators; A from shared memory
// K-major, B from shared memory MN-major (one 64-column block); accumulate
// = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_tn(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulators; A and B from shared
// memory, both MN-major (A transposed: a tile whose rows are the
// contraction index, M contiguous, read as a single 64-column block like
// an MN-major B); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n128k16, bf16 in, fp32 accumulators; A from registers (the
// m16n8k16 A-fragment layout, e.g. from ldmatrix x4), B from shared memory
// MN-major (two 64-column blocks, desc_sw128_mn).
__device__ __forceinline__ void wgmma_rs_n128_tn(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---- TF32 wgmma (the fp32 forms of kernels F and G) ----
// x rounded to TF32 (round to nearest, ties away from zero), as an fp32
// value: the operand rounding of the WMMA and mma.sync forms (load_op,
// wm::tf32), which the TF32 wgmma forms apply before an operand reaches
// shared memory (the tensor cores would otherwise drop its low 13 bits).
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// dst = src rounded to TF32 (tf32_rna), n values, grid-stride; src and dst
// 16-byte aligned (they may be the same).
__device__ __forceinline__ void tf32_round_rows(const float* src, float* dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(src)[i];
    v = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    reinterpret_cast<float4*>(dst)[i] = v;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = tf32_rna(src[i]);
}

// d (+)= A B, m64n192k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n192(float (&d)[96], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n160k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n160(float (&d)[80], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n128k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n32k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n16k8, TF32 in (fp32 operands, read as TF32), fp32
// accumulators; A and B from shared memory, both K-major (TF32 takes no
// transpose), 128-byte swizzled, one k8 step 32 bytes along the row;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B at width BN (64, 128, 160 or 192), TF32, as the wrappers above.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (BN == 192) {
    wgmma_tf32_n192(d, a, b, accumulate);
  } else if constexpr (BN == 160) {
    wgmma_tf32_n160(d, a, b, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_tf32_n128(d, a, b, accumulate);
  } else {
    static_assert(BN == 64, "TF32 wgmma widths: 64, 128, 160, 192");
    wgmma_tf32_n64(d, a, b, accumulate);
  }
}

// d += A B at width 64 * NB (1 or 2), A from registers, B MN-major.
template <int NB>
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[NB * 32], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (NB == 2) {
    wgmma_rs_n128_tn(d, a, b);
  } else {
    wgmma_rs_n64_tn(d, a, b);
  }
}

// The epilogue of a warpgroup's m64 x (64 NB) fp32 accumulators: plus the
// bias (fp32, before the one rounding), rounded to bf16 and written to rows
// [0, 64) of `out` (row stride `ld` elements) where row < rows_valid, with
// 16-byte stores. The accumulators go through `stage`: NB tiles of 64 x 64
// bf16 (8 KB each, the warpgroup's own), `stride` elements apart, chunk c
// of row r at c ^ (r % 8). Each warp stages and stores only its own 16
// rows, so no barrier is needed. `bias` points at the tile's first column,
// or is null. Only the first `cols_valid` columns (a multiple of 8) are
// read from `bias` and stored.
template <int NB>
__device__ __forceinline__ void store_acc_bf16(const float (&acc)[NB * 32], bf16* stage,
                                               int stride, const bf16* bias, bf16* out,
                                               size_t ld, int rows_valid,
                                               int cols_valid = 64 * NB) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < 8 * NB; ++c) {
    const int col = 8 * c + cq;
    const bool has_bias = bias != nullptr && col < cols_valid;
    const float b0 = has_bias ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = has_bias ? __bfloat162float(bias[col + 1]) : 0.f;
    bf16* st = stage + (c / 8) * stride + (warp * 16) * 64 + (((c % 8) ^ r) * 8) + cq;
    *reinterpret_cast<uint32_t*>(st + r * 64) = pack_bf16(acc[4 * c] + b0, acc[4 * c + 1] + b1);
    *reinterpret_cast<uint32_t*>(st + (r + 8) * 64) =
        pack_bf16(acc[4 * c + 2] + b0, acc[4 * c + 3] + b1);
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < NB; ++h) {
    const bf16* st = stage + h * stride + (warp * 16) * 64;
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int rr = i / 8, cc = i % 8;
      if (warp * 16 + rr < rows_valid && h * 64 + cc * 8 < cols_valid)
        *reinterpret_cast<uint4*>(out + (size_t)(warp * 16 + rr) * ld + h * 64 + cc * 8) =
            *reinterpret_cast<const uint4*>(st + rr * 64 + ((cc ^ (rr % 8)) * 8));
    }
  }
}

// tanh in fp32 on the special-function unit (one instruction; relative
// error about 2^-11, below a bf16 rounding).
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The GEGLU gate's GELU in fp32: the tanh form on the special-function
// unit's tanh, or the exact erf form (kernels C and J).
__device__ __forceinline__ float gelu_gate(float g, int exact) {
  if (exact) return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
  const float hg = 0.5f * g;
  return fmaf(hg, tanh_approx(g * fmaf(0.0356774081f, g * g, 0.7978845608f)), hg);
}

}  // namespace hop

// One (128-row, 128-column) output tile of A (R, K) times B on wgmma: kernel
// H's tile loop, shared with kernel J's two passes. One producer warp keeps
// a ring of kStages stages in flight with TMA: a (128 rows, 64-deep K) tile
// of A and the matching (64-deep K, 128 columns) tile of B, 32 KB a stage,
// 128-byte swizzled, on 2-D tensor maps (rows of A past R, and K past the
// maps' extent, read as zero). Two consumer warpgroups each own 64 rows x
// 128 columns (m64n128k16, accumulators in registers, one group of
// products kept in flight while the next stage is waited for). B is read
// as stored: (K, N) N-contiguous as an MN-major operand (two 64-column
// boxes), or with kTransB (N, K) K-contiguous as a K-major operand (one box
// of 128 rows).
template <int kStages, bool kTransB>
struct WgTile {
  static constexpr int BM = 128, BN = 128, BK = 64;
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int kATile = BM * BK * 2;     // 16 KB
  static constexpr int kBTile = BK * BN * 2;     // 16 KB
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kBarOff = kStages * kStageBytes;
  // The ring, the barriers, and slack to align the start to 1024.
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;

  // Runs the tile at rows r0, columns n0 over nk K steps: false on the
  // producer warp (every load issued), true on a consumer thread, whose
  // warpgroup's 64 x 128 accumulators are then in acc. Afterwards the A
  // tiles' rows [64 wg, 64 wg + 64) of every stage are the warpgroup's own
  // to reuse (every load into them landed, every product that read them is
  // done; the other warpgroup reads only its rows and the B tiles).
  __device__ static bool run(unsigned char* smem, const CUtensorMap* tm_a,
                             const CUtensorMap* tm_b, int r0, int n0, int nk, float (&acc)[64]) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
    uint64_t* empty = full + kStages;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        hop::mbar_init(&full[s], 1);
        hop::mbar_init(&empty[s], 8);  // one arrival per consumer warp
      }
      hop::mbar_fence_init();
    }
    __syncthreads();

    if (warp == 8) {  // the producer: one lane issues every TMA load
      if (lane == 0) {
        for (int j = 0; j < nk; ++j) {
          const int s = j % kStages;
          if (j >= kStages) hop::mbar_wait(&empty[s], (j / kStages - 1) & 1);
          hop::mbar_expect_tx(&full[s], kStageBytes);
          bf16* As = reinterpret_cast<bf16*>(smem + s * kStageBytes);
          bf16* Bs = As + BM * BK;
          hop::tma_load_2d(As, tm_a, &full[s], j * BK, r0);
          if constexpr (kTransB) {
            hop::tma_load_2d(Bs, tm_b, &full[s], j * BK, n0);  // (128 n, 64 k)
          } else {
            hop::tma_load_2d(Bs, tm_b, &full[s], n0, j * BK);  // (64 k, 64 n) x 2
            hop::tma_load_2d(Bs + 64 * 64, tm_b, &full[s], n0 + 64, j * BK);
          }
        }
      }
      return false;
    }

    const int wg = warp / 4;
    for (int j = 0; j < nk; ++j) {
      const int s = j % kStages;
      hop::mbar_wait(&full[s], (j / kStages) & 1);
      const bf16* As = reinterpret_cast<const bf16*>(smem + s * kStageBytes) + wg * 64 * 64;
      const bf16* Bs = reinterpret_cast<const bf16*>(smem + s * kStageBytes) + BM * BK;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hop::desc_sw128(As + kk * 16);
        // The first product overwrites the accumulators (no zero fill, which
        // would serialise the products: ptxas C7515).
        if constexpr (kTransB) {
          hop::wgmma_ss_n128(acc, da, hop::desc_sw128(Bs + kk * 16), j > 0 || kk > 0);
        } else {
          hop::wgmma_ss_n128_tn(acc, da, hop::desc_sw128_mn(Bs + kk * 16 * 64, 64 * 64 * 2),
                                j > 0 || kk > 0);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous stage's products are done
      hop::fence_regs(acc);
      if (j > 0) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[(j - 1) % kStages]);
      }
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    return true;
  }
};

// ---- host: tensor maps ----
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, fetched once through the runtime's
// entry-point query (this library is not linked against libcuda); null if
// the installed libcuda lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a (B, S, C) bf16 tensor with boxes of 64 columns x `rows`
// rows x 1 batch, 128-byte swizzle. Rows past S (and past the last batch)
// read as zero, so a tile never takes rows of the next batch.
inline cudaError_t make_map_bsc(CUtensorMap* map, const void* base, int B, int S, int C,
                                int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)S * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a (rows, cols) row-major bf16 tensor with boxes of 64
// columns x `box_rows` rows (<= 256), 128-byte swizzle. Boxes reaching
// outside the tensor read zeros there.
inline cudaError_t make_map_2d(CUtensorMap* map, const void* base, long long rows, int cols,
                               int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map over a (rows, cols) row-major fp32 tensor with boxes of 32
// columns (128 bytes) x `box_rows` rows (<= 256), 128-byte swizzle: the
// K-major tiles of the TF32 wgmma forms. Boxes reaching outside the tensor
// read zeros there.
inline cudaError_t make_map_2d_f32(CUtensorMap* map, const void* base, long long rows, int cols,
                                   int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map of `rank` (2-5) dimensions over a bf16 tensor: dims innermost
// first, the byte strides of dims 1.. (multiples of 16), and the box
// (box[0] = 64: 128-byte rows under the 128-byte swizzle). Elements
// outside the tensor read as zero.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The first 1024-byte boundary at or after p (a 128-byte-swizzled tile
// must start on one).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

}  // namespace lvd
