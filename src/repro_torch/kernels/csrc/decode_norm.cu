// Residual add and RMSNorm of a decode step's rows, for Hopper (sm_90a): one
// launch for what the eager path does in ten.
//
// Replaces no TPU kernel: the JAX package leaves the norm to XLA, which fuses
// it. It exists to replace a chain of eager launches: in a decode step of the
// port's models/moe.py each residual add and the RMSNorm after it were an
// add, three casts, two products, a mean, an add and an rsqrt, each its own
// launch over 4 or 16 rows of 2048. This kernel computes, for each row,
//
//   s   = bf16(x + y)                       (y optional: the residual branch)
//   out = bf16((f32(s) * rsqrtf(mean(f32(s)^2) + eps)) * f32(scale))
//
// rounded where layers.rms_norm rounds: the sum once to bf16, each f32
// product on its own (__fmul_rn: no contraction into an FMA), the output once
// to bf16. Only the order of the f32 sum of squares differs from PyTorch's
// reduction, so an output may part from the eager one by a bf16 ulp. The
// mean is the sum times `factor`, which the caller passes as PyTorch's mean
// computes it (outputs / elements, in f32).
//
// What bounds it on this card: latency. A Qwen1.5-MoE step's 49 calls move
// ~2 MB in all; each eager launch cost 1.3-2.7 us of card time only for
// being a launch. What the design does about it: one block a row, each lane
// holding its 16-byte chunks of the row in registers from the load to the
// store, one warp-shuffle reduction and one pass through shared memory
// across warps; no second launch, no scratch.
//
// Supported: bf16 rows of D, D a multiple of 8 up to 8192, each operand
// contiguous and starting on 16 bytes. Built without --use_fast_math:
// rsqrtf is the one PyTorch's rsqrt calls.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 256;
constexpr int MAX_CHUNKS = 4;  // 16-byte chunks a lane holds: D <= 8192
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const bf16* x;      // (R, D)
  const bf16* y;      // (R, D) or null
  const bf16* scale;  // (D)
  bf16* sum;          // (R, D), written where y is not null
  bf16* out;          // (R, D)
  int D;
  float factor;       // 1 / D as PyTorch's mean takes it
  float eps;
};

__device__ inline void unpack(uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ inline uint4 pack(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

__global__ void __launch_bounds__(MAX_THREADS) decode_norm_kernel(Params p) {
  __shared__ float warp_sums[MAX_THREADS / 32];
  const int chunks = p.D / 8;
  const size_t base = (size_t)blockIdx.x * p.D;
  const uint4* x = reinterpret_cast<const uint4*>(p.x + base);
  const uint4* y = p.y ? reinterpret_cast<const uint4*>(p.y + base) : nullptr;
  uint4* sum = p.y ? reinterpret_cast<uint4*>(p.sum + base) : nullptr;
  float v[MAX_CHUNKS][8];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c >= chunks) break;
    unpack(x[c], v[j]);
    if (y) {
      float w[8];
      unpack(y[c], w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = __fadd_rn(v[j][i], w[i]);
      const uint4 rounded = pack(v[j]);
      sum[c] = rounded;
      unpack(rounded, v[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      ss = __fadd_rn(ss, __fmul_rn(v[j][i], v[j][i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  const int warp = threadIdx.x / 32, warps = (blockDim.x + 31) / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += warp_sums[w];
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, p.factor), p.eps));
  const uint4* scale = reinterpret_cast<const uint4*>(p.scale);
  uint4* out = reinterpret_cast<uint4*>(p.out + base);
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c >= chunks) break;
    float g[8], o[8];
    unpack(scale[c], g);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(__fmul_rn(v[j][i], r), g[i]);
    out[c] = pack(o);
  }
}

}  // namespace

// x, y (or null), sum (or null where y is) and out (R, D); scale (D); bf16,
// contiguous, starting on 16 bytes. Returns a cudaError_t.
extern "C" int decode_norm_launch(const void* x, const void* y,
                                  const void* scale, void* sum, void* out,
                                  int R, int D, float factor, float eps,
                                  void* stream) {
  if (R < 1 || D < 8 || D % 8 || D / 8 > MAX_THREADS * MAX_CHUNKS ||
      (y && !sum))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(y),
           static_cast<const bf16*>(scale), static_cast<bf16*>(sum),
           static_cast<bf16*>(out), D, factor, eps};
  // a lane a chunk where that fits (D 2048: 256 lanes), else 256 lanes
  const int lanes = ((D / 8 + 31) / 32) * 32;
  const int threads = lanes < MAX_THREADS ? lanes : MAX_THREADS;
  decode_norm_kernel<<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
