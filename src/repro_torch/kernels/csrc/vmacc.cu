// Elementwise multiply-accumulate for Hopper (sm_90a): out = a * b + c.
//
// Replaces src/repro/kernels/vmacc/kernel.py:_vmacc_kernel (Algorithm 2,
// the depthwise-convolution and gating layer class): three (R, C) arrays in,
// one out, in the dtype of a.
//
// One block owns one (br, bc) tile; the tiles are issued row of tiles by row
// of tiles, as the Pallas grid (gr, gc). The block's 256 threads walk the
// tile's br * bc elements in row-major order, so neighbouring threads touch
// neighbouring addresses of one row and each warp's loads and store are
// contiguous. The tile is a runtime argument and the loop takes any size, so
// the kernel itself has no per-tile limit beyond tiling the arrays exactly:
// its launch gate (kernels/vmacc/ops.py) is the reference's sublane/lane
// rule.
//
// What bounds it on this card: bytes. vmacc(12544, 32) f32, the first
// depthwise stage of MobileNetV2, moves 6.42 MB (three reads, one write) for
// 0.8 MFLOP: 1.92 us at 3.35 TB/s. What the design does about it: each
// element is read once and written once, and nothing is staged in shared
// memory (a tile has no reuse). Vector loads and fewer, larger blocks are
// later work.
//
// Arithmetic: float32 is one fmaf per element (a * b + c with a single
// rounding); the plain version rounds the product first. The two differ by
// at most one rounding of a * b, far inside the 1e-5 tolerance. bfloat16
// rounds the product to bf16 and then the sum, as two eager PyTorch bf16
// operations do. Built without --use_fast_math.
#include "tile.cuh"

namespace {

constexpr int VMACC_THREADS = 256;

__device__ inline float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ inline __nv_bfloat16 madd(__nv_bfloat16 a, __nv_bfloat16 b,
                                     __nv_bfloat16 c) {
  const __nv_bfloat16 p = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(p), __bfloat162float(c)));
}

template <typename T>
__global__ void __launch_bounds__(VMACC_THREADS)
    vmacc_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ c, T* __restrict__ out, int C, int br,
                 int bc) {
  const int gc = C / bc;
  const int r0 = (blockIdx.x / gc) * br, c0 = (blockIdx.x % gc) * bc;
  const int n = br * bc;
  for (int e = threadIdx.x; e < n; e += VMACC_THREADS) {
    const int r = e / bc, col = e - r * bc;
    const size_t i = (size_t)(r0 + r) * C + c0 + col;
    out[i] = madd(a[i], b[i], c[i]);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* out, int R,
           int C, int br, int bc, cudaStream_t stream) {
  if (br < 1 || bc < 1 || R % br || C % bc) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(R / br) * (C / bc);
  if (tiles < 1 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  vmacc_kernel<T><<<(unsigned)tiles, VMACC_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), C, br, bc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. a, b, c and out are (R, C), row-major
// and contiguous, R and C multiples of br and bc. Returns a cudaError_t.
extern "C" int vmacc_launch(int dtype, const void* a, const void* b,
                            const void* c, void* out, int R, int C, int br,
                            int bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, c, out, R, C, br, bc, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, c, out, R, C, br, bc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
