// Hopper (sm_90a) building blocks of qmatmul.cu's warp-specialised path:
// mbarriers, TMA and bulk copies from device to shared memory, register
// reallocation, the shared-memory matrix descriptor and the integer
// warpgroup product wgmma.mma_async m64nNk32 .s32.s8.s8 for N = 32, 64, 128.
// Each wrapper is one instruction (the PTX ISA's "Asynchronous Warpgroup
// Level Matrix Multiply-Accumulate", "mbarrier" and "cp.async.bulk"
// sections).
//
// Operand layout of wgmma (8-bit operands are taken K-major only): a tile of
// R rows (m or n) and k bytes lies in panels of P bytes of k (P = 32, 64 or
// 128); panel j holds R rows of P bytes, row r at r * P, with the 16-byte
// chunks of each row swizzled by the address bits the way TMA's
// CU_TENSOR_MAP_SWIZZLE_<P>B writes them (swizzle()); a panel starts on a
// 1024-byte boundary. The descriptor's stride between 8-row groups is 8 P;
// a k32 step inside a panel adds 32 bytes to the start address.
//
// The accumulator of m64nN: thread (warp v of the warpgroup, lane 4g + t)
// holds N / 2 sums; d[4j + 2h + e] is row 16v + g + 8h, column 8j + 2t + e.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset `off` of a panel of P-byte rows as the swizzle lays it out:
// the 16-byte chunk bits [4, 4 + log2(P / 16)) XORed with the bits above
// bit 7 (128B: bits 4-6 with 7-9; 64B: 4-5 with 7-8; 32B: 4 with 7).
__host__ __device__ __forceinline__ uint32_t swizzle(uint32_t off, int p) {
  return off ^ (((off >> 7) & (uint32_t)(p / 16 - 1)) << 4);
}

// The descriptor's layout field for a panel width (1: 128B, 2: 64B, 3: 32B).
__host__ __device__ __forceinline__ int layout_type(int p) {
  return p == 128 ? 1 : p == 64 ? 2 : 3;
}

// The shared-memory matrix descriptor of a K-major operand whose rows are
// P bytes (the leading offset is unused by the swizzled K-major layouts).
__device__ __forceinline__ uint64_t desc(const void* p, int panel) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * panel) >> 4) << 32) |
         ((uint64_t)layout_type(panel) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's shared-memory writes before later reads of the
// async proxy (wgmma, TMA), and its reads before the async proxy's writes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box of the 2D tensor map at (c0 innermost, c1) into `dst`, completing
// its bytes on `bar`; elements outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from `src` (16-byte aligned)
// into `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The calling warpgroup's named barrier `id` (1-15) over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Before the first wgmma that reads registers or shared memory this
// warpgroup wrote.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// This warpgroup's registers a thread become N (raised or lowered); every
// warp of the warpgroup executes it.
template <bool RAISE, int N>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (RAISE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Pins the accumulators: no access to them moves across this point (an
// asynchronous wgmma writes them behind the compiler's back).
template <int R>
__device__ __forceinline__ void fence_operands(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (m64 x nN, s32) += a (m64 x k32) @ b (k32 x nN), s8 in, both operands in
// shared memory, K-major (descriptors da, db).
__device__ __forceinline__ void mma_n32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x nBN) += a @ b over the n pieces 128, 64, 32 that make BN; the
// piece at column c reads b's rows from c on (`row_units` descriptor units
// a row).
template <int BN, int DONE = 0>
__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db,
                                    uint32_t row_units) {
  constexpr int LEFT = BN - DONE;
  const uint64_t b = db + (uint64_t)DONE * row_units;
  if constexpr (LEFT >= 128) {
    mma_n128(d + DONE / 2, da, b);
    mma<BN, DONE + 128>(d, da, db, row_units);
  } else if constexpr (LEFT >= 64) {
    mma_n64(d + DONE / 2, da, b);
    mma<BN, DONE + 64>(d, da, db, row_units);
  } else if constexpr (LEFT >= 32) {
    mma_n32(d + DONE / 2, da, b);
    mma<BN, DONE + 32>(d, da, db, row_units);
  }
}

}  // namespace wg
