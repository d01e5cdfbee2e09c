// Block-tiled product on the CUDA cores: matmul.cu's int8 kernels. The
// other sources include it for its launch helpers, to_f32 and
// kernel_error_string only.
//
// One thread block computes one (bm, bn) output tile. Its threads form a
// (bm/4) x (bn/4) grid; each owns a 4x4 register micro-tile, strided so that
// neighbouring threads own neighbouring columns: rows ty + i*(bm/4), columns
// tx + j*(bn/4). bm, bn and bk are runtime arguments, so one build serves
// every tile the design space offers; the Python gate
// (kernels/matmul/ops.py: supports_block_shape) mirrors the limits below.
//
// Per k step the block stages an int8 x tile (bm, bk) and w tile (bk, bn)
// in shared memory. x rows are padded by one 32-bit word so the column reads
// of threads on different rows fall in different banks; w is stored as
// 32-bit words packing w[k..k+3, n], the operand layout of __dp4a.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int TM = 4;              // micro-tile rows per thread
constexpr int TN = 4;              // micro-tile columns per thread
constexpr int MAX_THREADS = 1024;  // => bm * bn <= 16384

constexpr int XPAD = 4;            // bytes of padding per x row

__host__ __device__ inline size_t smem_bytes(int bm, int bn, int bk) {
  return (size_t)bm * (bk + XPAD) + (size_t)bk * bn;
}

// Thread coordinates within the block's (bm/4) x (bn/4) thread grid.
struct Layout {
  int tx, ty, TX, TY;
  __device__ Layout(int bm, int bn) {
    TX = bn / TN;
    TY = bm / TM;
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
  }
};

// Where output tile t starts. Tiles are numbered as blocks are issued, so
// the fastest-varying tile axis is the second letter of the Pallas grid
// order: "mnk" walks n within a row of tiles, "nmk" walks m within a column.
__device__ inline void tile_origin(int M, int N, int bm, int bn, int n_major,
                                   int t, int* m0, int* n0) {
  const int gm = M / bm, gn = N / bn;
  if (n_major) {
    *n0 = (t / gm) * bn;
    *m0 = (t % gm) * bm;
  } else {
    *m0 = (t / gn) * bm;
    *n0 = (t % gn) * bn;
  }
}

// The same for tile blockIdx.x: one block per output tile.
__device__ inline void tile_origin(int M, int N, int bm, int bn, int n_major,
                                   int* m0, int* n0) {
  tile_origin(M, N, bm, bn, n_major, (int)blockIdx.x, m0, n0);
}

// Copy the x tile rows [m0, m0+bm) x cols [k0, k0+bk) and the w tile into
// shared memory. Reads are coalesced along the row-major inner dimension.
__device__ inline void stage(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ w,
                             unsigned char* smem, int N, int K, int m0,
                             int n0, int k0, int bm, int bn, int bk) {
  const int nt = blockDim.x;
  const int xs_stride = bk + XPAD;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  for (int e = threadIdx.x; e < bm * bk; e += nt) {
    const int r = e / bk, c = e - r * bk;
    xs[r * xs_stride + c] = x[(size_t)(m0 + r) * K + k0 + c];
  }
  int* ws = reinterpret_cast<int*>(smem + (size_t)bm * xs_stride);
  for (int e = threadIdx.x; e < (bk / 4) * bn; e += nt) {
    const int q = e / bn, c = e - q * bn;
    const unsigned char* p = reinterpret_cast<const unsigned char*>(
        w + (size_t)(k0 + 4 * q) * N + n0 + c);
    const uint32_t b0 = p[0], b1 = p[(size_t)N], b2 = p[2 * (size_t)N],
                   b3 = p[3 * (size_t)N];
    ws[e] = (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  }
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc += x_tile @ w_tile over the staged k step, in the thread's registers.
__device__ inline void multiply_step(const unsigned char* smem, int bm,
                                     int bn, int bk, const Layout& L,
                                     int (&acc)[TM][TN]) {
  const int xs_stride = bk + XPAD;
  const int8_t* xs = reinterpret_cast<const int8_t*>(smem);
  const int* ws = reinterpret_cast<const int*>(smem + (size_t)bm * xs_stride);
  for (int q = 0; q < bk / 4; ++q) {
    int a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const int*>(xs + (L.ty + i * L.TY) * xs_stride
                                           + 4 * q);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ws[q * bn + L.tx + j * L.TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// The product of one k step [k0, k0+bk) into acc (accumulating), with the
// barriers around the shared-memory tile.
__device__ inline void k_step(const int8_t* __restrict__ x,
                              const int8_t* __restrict__ w,
                              unsigned char* smem, int N, int K, int m0,
                              int n0, int k0, int bm, int bn, int bk,
                              const Layout& L, int (&acc)[TM][TN]) {
  stage(x, w, smem, N, K, m0, n0, k0, bm, bn, bk);
  __syncthreads();
  multiply_step(smem, bm, bn, bk, L, acc);
  __syncthreads();
}

// Launch-side helpers: opt into large dynamic shared memory, then launch.
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: not sticky
  return err;
}

inline bool shape_ok(int M, int N, int K, int bm, int bn, int bk) {
  return bm > 0 && bn > 0 && bk > 0 && bm % TM == 0 && bn % TN == 0 &&
         bk % 4 == 0 && M % bm == 0 && N % bn == 0 && K % bk == 0 &&
         (bm / TM) * (bn / TN) <= MAX_THREADS;
}

}  // namespace tile

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
