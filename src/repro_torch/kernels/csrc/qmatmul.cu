// Quantized int8 matmul + bias + requantize for Hopper (sm_90a).
//
// Replaces src/repro/kernels/qmatmul/kernel.py:_qmm_kernel:
//   out_i8 = clip(round_half_even(f32(x_i8 @ w_i8 + bias_i32) * scale), -128, 127)
// Always the accumulating form: like the Pallas kernel it ignores the
// schedule's order and accumulate decisions (one (m, n) tile per block,
// tiles issued m-major).
//
// What bounds it on this card: the LM-head shape (64 x 32000 x 576) reads an
// 18.4 MB weight once, 6.2 us at 3.35 TB/s, against 0.12 us of int8
// tensor-core work at 1979 TOP/s, so the card is bound by bytes. This first
// kernel computes with __dp4a on the CUDA cores (four int8 products per
// instruction), which puts it under a much lower compute ceiling than the
// memory bound. What the design does about it: the int32 accumulator stays
// in registers across the whole K loop and the requantized int8 tile is
// stored once, so device memory sees only the operands, the bias and one
// byte per output. Tensor-core int8 (wgmma) is later work.
//
// The rescale is bit-exact with the JAX kernel: int32 add, conversion to
// f32 with round-to-nearest, one f32 multiply (a lone multiply; nothing to
// contract into an FMA), rintf (round half to even, as jnp.round; not
// roundf, which rounds half away from zero), clamp, int8. Build without
// --use_fast_math.
#include "tile.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(MAX_THREADS)
    qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int* __restrict__ bias, float scale,
                   int8_t* __restrict__ out, int M, int N, int K, int bm,
                   int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(bm, bn);
  int m0, n0;
  tile_origin(M, N, bm, bn, /*n_major=*/0, &m0, &n0);
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < K; k0 += bk)
    k_step<int8_t>(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, acc);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + L.tx + j * L.TX;
    const int b = bias[col];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float scaled = __fmul_rn(__int2float_rn(acc[i][j] + b), scale);
      const float r = fminf(fmaxf(rintf(scaled), -128.0f), 127.0f);
      out[(size_t)(m0 + L.ty + i * L.TY) * N + col] = (int8_t)(int)r;
    }
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, bias (N,) int32, out (M, N) int8; all
// row-major and contiguous, M, N and K multiples of bm, bn and bk, bk a
// multiple of 4. Returns a cudaError_t.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* bias,
                              float scale, void* out, int M, int N, int K,
                              int bm, int bn, int bk, void* stream) {
  if (!shape_ok(M, N, K, bm, bn, bk, 4)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<int8_t>(bm, bn, bk);
  cudaError_t err = prepare_launch(qmatmul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  qmatmul_kernel<<<(M / bm) * (N / bn), (bm / TM) * (bn / TN), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), scale, static_cast<int8_t*>(out), M, N,
      K, bm, bn, bk);
  return (int)cudaGetLastError();
}
