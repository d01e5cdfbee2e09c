// PTX wrappers for the tensor-core kernels: cp.async copies from device to
// shared memory (16 bytes for the bf16 and f32 matmul, matmul.cu, and the
// attention, flash_attention.cu; 16, 8 or 4 bytes with zero fill for the
// int8 qmatmul, qmatmul.cu) and a thread's walk over a tile's 16-byte
// chunks, ldmatrix fragment loads, the TF32 rounding and 3xTF32 split and
// the warp-level mma.sync products:
// m16n8k16 bf16 and m16n8k8 TF32 with f32 accumulators, m16n8k32 s8 with
// s32 accumulators. Each wrapper is one instruction; the fragment layouts
// are those of the PTX ISA ("Matrix Fragments for mma.m16n8k16", "for
// mma.m16n8k8" and "for mma.m16n8k32").
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory, through L2 only (.cg).
// Both addresses must be 16-byte aligned.
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Copy V (16, 8 or 4) bytes from device to shared memory, or, when `valid`
// is false, write V zero bytes and read nothing (src-size 0). Both
// addresses V-byte aligned; src must be a mapped address either way.
template <int V>
__device__ inline void cp_async_zfill(void* dst, const void* src,
                                      bool valid) {
  static_assert(V == 16 || V == 8 || V == 4, "cp.async copies 4, 8 or 16");
  const int n = valid ? V : 0;
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(V), "r"(n)
                 : "memory");
}

// A thread's walk over the 16-byte chunks of a tile with `cols` chunks a
// row: chunks threadIdx.x, threadIdx.x + blockDim.x, ... as (row, col),
// with the divisions done once per kernel, not once per chunk.
struct ChunkWalk {
  int r0, c0, dr, dc, cols;
  __device__ explicit ChunkWalk(int cols_) : cols(cols_) {
    r0 = threadIdx.x / cols;
    c0 = threadIdx.x - r0 * cols;
    dr = blockDim.x / cols;
    dc = blockDim.x - dr * cols;
  }
  __device__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every copy this thread committed has landed.
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and r[j] receives this lane's part of matrix j.
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way: rows in shared memory become
// columns of the fragment (a row-major (k, n) tile as the "col" B operand).
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row-major) @ b (16x8, column-major), bf16 in, f32 sum.
__device__ inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero. The same bits as
// cvt.rna.tf32.f32 for every finite value and infinity (half a unit added
// to the magnitude carries into the exponent as rounding does), in two
// integer instructions where the cvt compiles to a sequence that tests for
// NaN and infinity; only a NaN whose payload lies in the low 13 bits would
// come out as infinity.
__device__ inline uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 2^-22 of v, both TF32 (3xTF32's operand split).
__device__ inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a (16x8, row-major) @ b (8x8, column-major), TF32 in, f32 sum. a0 is
// row g, column t; a1 row g + 8; a2, a3 the same at column t + 4; b0 is row
// t, column g, b1 row t + 4; d as for m16n8k16 (g = lane / 4, t = lane % 4).
__device__ inline void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row-major) @ b (32x8, column-major), s8 in, s32 sum. a[i]
// holds four k-consecutive bytes: rows g (a0, a2) and g + 8 (a1, a3), k
// 4t..4t+3 (a0, a1) and 16+4t.. (a2, a3); b0 holds k rows 4t..4t+3 and b1
// rows 16+4t.. of column g; d0, d1 row g, columns 2t, 2t+1; d2, d3 row
// g + 8 (g = lane / 4, t = lane % 4). int32 sums are exact.
__device__ inline void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
