// Matrix-vector product for Hopper (sm_90a): out[n] = sum_k x[k] * w[k, n],
// f32 or bf16 operands, float32 output always (as the Pallas kernels).
//
// Replaces the two Pallas kernels of src/repro/kernels/gemv/kernel.py:
//   _gemv_kernel       -> gemv_acc_kernel:   each thread keeps its f32 sum in
//                         a register across every K step; one reduction
//                         across the block's threads and one store at the
//                         end (Algorithm 1 at J = bn, VL = bk).
//   _gemv_noacc_kernel -> gemv_noacc_kernel: the store-heavy form; after
//                         every K step the block reduces its partial and
//                         reads, adds and writes back the output in device
//                         memory.
//
// Operands are x (1, K) and w (K, N), both row-major (workload.py:
// example_inputs), so output column n reads w's column n with a stride of N
// elements. One block owns bn output columns: its threads form a TY x bn
// grid, thread (ty, tx) owning column n0 + tx and the k rows ty, ty + TY,
// ... of each K step. Neighbouring threads read neighbouring columns of one
// w row, so a warp's loads are contiguous when bn >= 32. bn = 1 is the
// paper's J = 1 row kernel: every thread of the block reads one element of
// its own row, each from another 32-byte sector. It is right and slow.
//
// What bounds it on this card: bytes. The LM head of MobileLLM-125M
// (32000 x 576, bf16) reads a 36.9 MB weight for 36.9 MFLOP, 11 us at
// 3.35 TB/s against 0.04 us of bf16 tensor-core work. What the design does
// about it: every w element is read exactly once, by one thread, coalesced
// along n; x (1.2 KB) stays in L1; the accumulator lives in registers and
// the output is written once per column (gemv_acc_kernel). Vector loads,
// several columns per thread and a split of K across blocks for narrow N
// are later work.
//
// The Pallas grid runs K-outer in order for _gemv_noacc_kernel; thread
// blocks do not run in order. gemv_noacc_kernel therefore keeps one block
// per output block and runs its K loop inside the block. The thread with
// ty == 0 owns column n and is the only one that reads and writes out[n],
// so the sum order is that of the Pallas grid: the first K step writes (the
// buffer comes from torch.empty), every later one adds. No split-K atomics.
#include "tile.cuh"

namespace {

using tile::to_f32;

// A block has GEMV_THREADS threads while bn <= GEMV_THREADS: TY is the
// largest power of two with TY * bn <= GEMV_THREADS. Wider bn runs one
// thread per column (TY = 1), up to the 1024 threads a block may have
// (kernels/gemv/ops.py: MAX_BN mirrors it).
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_MAX_BN = 1024;

__host__ inline int rows_per_block(int bn) {
  int ty = 1;
  while (ty * 2 * bn <= GEMV_THREADS) ty *= 2;
  return ty;
}

// Sum v over the TY threads of each column (tree over shared memory; TY is
// a power of two). The result is valid in the ty == 0 thread of a column.
__device__ inline float column_sum(float* red, float v, int tx, int ty,
                                   int TY, int bn) {
  red[ty * bn + tx] = v;
  __syncthreads();
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) red[ty * bn + tx] += red[(ty + s) * bn + tx];
    __syncthreads();
  }
  const float total = red[tx];
  __syncthreads();  // red is written again by the next call
  return total;
}

// The thread's share of one K step [k0, k0 + bk), added to acc.
template <typename T>
__device__ inline float gemv_step(const T* __restrict__ x,
                                  const T* __restrict__ w, int N, int n,
                                  int k0, int bk, int ty, int TY, float acc) {
#pragma unroll 8
  for (int k = k0 + ty; k < k0 + bk; k += TY)
    acc = fmaf(to_f32(x[k]), to_f32(w[(size_t)k * N + n]), acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(GEMV_MAX_BN)
    gemv_acc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ out, int N, int K, int bn, int bk) {
  __shared__ float red[GEMV_MAX_BN];
  const int TY = blockDim.x / bn, tx = threadIdx.x % bn,
            ty = threadIdx.x / bn;
  const int n = blockIdx.x * bn + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += bk)
    acc = gemv_step<T>(x, w, N, n, k0, bk, ty, TY, acc);
  const float total = column_sum(red, acc, tx, ty, TY, bn);
  if (ty == 0) out[n] = total;
}

template <typename T>
__global__ void __launch_bounds__(GEMV_MAX_BN)
    gemv_noacc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      float* __restrict__ out, int N, int K, int bn, int bk) {
  __shared__ float red[GEMV_MAX_BN];
  const int TY = blockDim.x / bn, tx = threadIdx.x % bn,
            ty = threadIdx.x / bn;
  const int n = blockIdx.x * bn + tx;
  for (int k0 = 0; k0 < K; k0 += bk) {
    const float part = column_sum(
        red, gemv_step<T>(x, w, N, n, k0, bk, ty, TY, 0.0f), tx, ty, TY,
        bn);
    if (ty == 0) out[n] = (k0 == 0) ? part : out[n] + part;
  }
}

template <typename T>
int launch(bool accumulate, const void* x, const void* w, void* out, int N,
           int K, int bn, int bk, cudaStream_t stream) {
  if (bn < 1 || bk < 1 || bn > GEMV_MAX_BN || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / bn), block(bn * rows_per_block(bn));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  float* op = static_cast<float*>(out);
  if (accumulate)
    gemv_acc_kernel<T><<<grid, block, 0, stream>>>(xp, wp, op, N, K, bn, bk);
  else
    gemv_noacc_kernel<T><<<grid, block, 0, stream>>>(xp, wp, op, N, K, bn,
                                                     bk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (1, K), w (K, N) row-major and
// contiguous, out (1, N) float32; N and K multiples of bn and bk, bn at
// most 1024. Returns a cudaError_t.
extern "C" int gemv_launch(int accumulate, int dtype, const void* x,
                           const void* w, void* out, int N, int K, int bn,
                           int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(accumulate, x, w, out, N, K, bn, bk, s);
    case 1:
      return launch<__nv_bfloat16>(accumulate, x, w, out, N, K, bn, bk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
