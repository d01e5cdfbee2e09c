// Tiled matmul for Hopper (sm_90a): out = x @ w, f32 or int32 accumulation.
//
// Replaces the two Pallas kernels of src/repro/kernels/matmul/kernel.py:
//   _acc_kernel   -> matmul_acc:   K innermost; the accumulator is carried
//                    across the K steps and the output tile is stored once
//                    (the paper's Algorithm 1).
//   _noacc_kernel -> matmul_noacc: the store-heavy schedule; the output tile
//                    is read, added to and written back in device memory
//                    after every K step.
//
// What bounds it on this card: at the tuned workloads (m = 64 token rows or
// k = 576) the products are small. Read once, their operands take about
// 0.6 us at 3.35 TB/s, less than their tensor-core time, so the card could
// finish them in a few microseconds. This first kernel runs on the CUDA
// cores (f32 FMA, int8 __dp4a), not the tensor cores, so it is bound by
// CUDA-core issue and shared-memory reads: each thread reads 8 shared
// values per 16 multiply-adds. What the design does about it: the
// accumulator lives in registers, as Algorithm 1 keeps it in vector
// registers, so device memory sees each output once (matmul_acc). Tensor
// cores (wgmma) and TMA loads are later work.
//
// The Pallas grid runs in order; thread blocks do not. matmul_noacc
// therefore keeps one block per output tile and runs its K loop inside the
// block, each thread re-reading and re-writing only the output elements it
// owns, so no two blocks touch one element and the sum order is that of the
// Pallas grid. The first K step writes without adding (the buffer comes
// from torch.empty). No split-K atomics: they would change the sum order
// from run to run.
#include "tile.cuh"

namespace {

using namespace tile;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    matmul_acc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      typename Traits<T>::Acc* __restrict__ out, int M, int N,
                      int K, int bm, int bn, int bk, int n_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Acc = typename Traits<T>::Acc;
  const Layout L(bm, bn);
  int m0, n0;
  tile_origin(M, N, bm, bn, n_major, &m0, &n0);
  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  for (int k0 = 0; k0 < K; k0 += bk)
    k_step<T>(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx + j * L.TX] =
          acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    matmul_noacc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        typename Traits<T>::Acc* __restrict__ out, int M,
                        int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Acc = typename Traits<T>::Acc;
  const Layout L(bm, bn);
  int m0, n0;
  // the Pallas grid (gk, gm, gn) walks n fastest within each k step
  tile_origin(M, N, bm, bn, /*n_major=*/0, &m0, &n0);
  for (int k0 = 0; k0 < K; k0 += bk) {
    Acc part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = Acc(0);
    k_step<T>(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, part);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        Acc* o = out + (size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx +
                 j * L.TX;
        *o = (k0 == 0) ? part[i][j] : *o + part[i][j];
      }
  }
}

template <typename T>
int launch(bool accumulate, const void* x, const void* w, void* out, int M,
           int N, int K, int bm, int bn, int bk, int n_major,
           cudaStream_t stream) {
  using Acc = typename Traits<T>::Acc;
  if (!shape_ok(M, N, K, bm, bn, bk, sizeof(T) == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(bm, bn, bk);
  const dim3 grid((M / bm) * (N / bn)), block((bm / TM) * (bn / TN));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  Acc* op = static_cast<Acc*>(out);
  cudaError_t err;
  if (accumulate) {
    err = prepare_launch(matmul_acc_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_acc_kernel<T><<<grid, block, smem, stream>>>(xp, wp, op, M, N, K,
                                                        bm, bn, bk, n_major);
  } else {
    err = prepare_launch(matmul_noacc_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_noacc_kernel<T><<<grid, block, smem, stream>>>(xp, wp, op, M, N,
                                                          K, bm, bn, bk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. out is float32 for the first
// two and int32 for int8; every array is row-major and contiguous, with M,
// N and K multiples of bm, bn and bk. Returns a cudaError_t.
extern "C" int matmul_launch(int accumulate, int dtype, const void* x,
                             const void* w, void* out, int M, int N, int K,
                             int bm, int bn, int bk, int n_major,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(accumulate, x, w, out, M, N, K, bm, bn, bk,
                           n_major, s);
    case 1:
      return launch<__nv_bfloat16>(accumulate, x, w, out, M, N, K, bm, bn, bk,
                                   n_major, s);
    case 2:
      return launch<int8_t>(accumulate, x, w, out, M, N, K, bm, bn, bk,
                            n_major, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
