// Elementwise multiply-accumulate for Hopper (sm_90a): out = a * b + c.
//
// Replaces src/repro/kernels/vmacc/kernel.py:_vmacc_kernel (Algorithm 2,
// the depthwise-convolution and gating layer class): three (R, C) arrays in,
// one out, in the dtype of a.
//
// The arrays come at their real size: the (br, bc) tiles that cover them are
// masked at the bottom and right edges, so nothing is padded first and the
// visible outputs equal those of the kernel run on arrays zero-padded to the
// block. A block takes `per` tiles stacked in one column of tiles (make_plan):
// a band of per * br rows and bc columns, so an element's place in the band
// is one division away from its index. The bands are numbered row of bands
// by row of bands, as the Pallas grid (gr, gc) numbers the tiles.
//
// What bounds it on this card: bytes. vmacc(12544, 32) f32, the first
// depthwise stage of MobileNetV2, moves 6.42 MB (three reads, one write) for
// 0.8 MFLOP: 1.92 us at 3.35 TB/s. The MobileNetV2 stages at 7 x 7 and 14 x
// 14 move 0.1-0.8 MB, well under a microsecond: there a launch and one
// round trip to device memory are the cost. What the design does about it:
//
// - Vector path (V = 16 / sizeof(T): 4 f32, 8 bf16) where C and bc are
//   multiples of V and the four arrays start on 16 bytes: every thread reads
//   16-byte vectors of a, b and c (read-only, not allocated in L1: each is
//   read once) and writes 16-byte vectors of out. Else the scalar path, one
//   element a step (V = 1), as an odd width (33 x 17) or a view at an odd
//   offset needs.
// - Each thread issues the loads of VMACC_UNROLL vectors (3 * VMACC_UNROLL
//   16-byte loads) before its first multiply-add, so a block keeps many
//   loads in flight.
// - A block takes per = VMACC_THREADS * VMACC_UNROLL / (br * bc / V) tiles
//   (so that each thread has about VMACC_UNROLL vectors), at least 1 and at
//   most tiles / VMACC_FILL_CTAS (so that the grid still covers the card's
//   132 SMs where there are tiles enough). Nothing is staged in shared
//   memory: a tile has no reuse. kernels/vmacc/ops.py: plan mirrors these
//   rules.
// - The index arithmetic is short, since at these sizes it sits in front
//   of the first load: a vector's row and column in its band are one
//   division by the band's width, and the band's origin one division per
//   block, not a chain of tile, row and column divisions per vector.
//
// Arithmetic: float32 is one fmaf per element (a * b + c with a single
// rounding); the plain version rounds the product first. The two differ by
// at most one rounding of a * b, far inside the 1e-5 tolerance. bfloat16
// rounds the product to bf16 and then the sum, as two eager PyTorch bf16
// operations do. Built without --use_fast_math.
#include "tile.cuh"

namespace {

constexpr int VMACC_THREADS = 256;
constexpr int VMACC_UNROLL = 4;
constexpr int VMACC_FILL_CTAS = 132;

struct Plan {
  int v;       // elements a step: 16 / sizeof(T), or 1
  int gc;      // tiles across the columns
  int tiles;
  int per;     // tiles a block takes, stacked in one column of tiles
  int blocks;
};

__host__ inline Plan make_plan(int R, int C, int br, int bc, int item,
                               bool aligned) {
  Plan p{};
  const int vec = 16 / item;
  p.v = (aligned && C % vec == 0 && bc % vec == 0) ? vec : 1;
  p.gc = (C + bc - 1) / bc;
  const int gr = (R + br - 1) / br;
  p.tiles = gr * p.gc;
  const long long tile_items = (long long)br * bc / p.v;
  long long per = VMACC_THREADS * VMACC_UNROLL / tile_items;
  const long long most = p.tiles / VMACC_FILL_CTAS;
  if (per > most) per = most;
  if (per < 1) per = 1;
  p.per = (int)per;
  p.blocks = ((gr + p.per - 1) / p.per) * p.gc;
  return p;
}

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

// madd on each element of one 32-bit word of a 16-byte vector: one f32, or
// two bf16 (the element at the lower address in the low half).
__device__ inline uint32_t madd_word(float, uint32_t a, uint32_t b,
                                     uint32_t c) {
  return __float_as_uint(
      madd(__uint_as_float(a), __uint_as_float(b), __uint_as_float(c)));
}

__device__ inline uint32_t madd_word(__nv_bfloat16, uint32_t a, uint32_t b,
                                     uint32_t c) {
  uint32_t r = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16 v = madd(
        __ushort_as_bfloat16((unsigned short)(a >> (16 * h))),
        __ushort_as_bfloat16((unsigned short)(b >> (16 * h))),
        __ushort_as_bfloat16((unsigned short)(c >> (16 * h))));
    r |= (uint32_t)__bfloat16_as_ushort(v) << (16 * h);
  }
  return r;
}

// V neighbouring elements: one 16-byte vector (V > 1) or one element.
template <typename T, int V> struct Vec {
  uint4 raw;
  __device__ void load(const T* p) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
        : "l"(p));
  }
  __device__ void store(T* p) const { *reinterpret_cast<uint4*>(p) = raw; }
  // this = this * b + c, element by element
  __device__ void madd_by(const Vec& b, const Vec& c) {
    raw.x = madd_word(T(), raw.x, b.raw.x, c.raw.x);
    raw.y = madd_word(T(), raw.y, b.raw.y, c.raw.y);
    raw.z = madd_word(T(), raw.z, b.raw.z, c.raw.z);
    raw.w = madd_word(T(), raw.w, b.raw.w, c.raw.w);
  }
};

template <typename T> struct Vec<T, 1> {
  T raw;
  __device__ void load(const T* p) { raw = __ldg(p); }
  __device__ void store(T* p) const { *p = raw; }
  __device__ void madd_by(const Vec& b, const Vec& c) {
    raw = madd(raw, b.raw, c.raw);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(VMACC_THREADS)
    vmacc_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ c, T* __restrict__ out, int R, int C,
                 int br, int bc, Plan p) {
  // this block's band: rows [r0, r0 + per * br) of tile column j, as one
  // list of items: item e is vector e % row_items of row r0 + e / row_items
  const int r0 = (blockIdx.x / p.gc) * p.per * br;
  const int c0 = (blockIdx.x % p.gc) * bc;
  const int row_items = bc / V;
  const int n =
      (int)min((long long)p.per * br, (long long)(R - r0)) * row_items;
  for (int base = threadIdx.x; base < n;
       base += VMACC_THREADS * VMACC_UNROLL) {
    Vec<T, V> va[VMACC_UNROLL], vb[VMACC_UNROLL], vc[VMACC_UNROLL];
    size_t at[VMACC_UNROLL];
    bool ok[VMACC_UNROLL];
#pragma unroll
    for (int u = 0; u < VMACC_UNROLL; ++u) {
      const int e = base + u * VMACC_THREADS;
      const int row = e / row_items;
      const int col = c0 + (e - row * row_items) * V;
      ok[u] = e < n && col < C;
      at[u] = (size_t)(r0 + row) * C + col;
      if (ok[u]) {
        va[u].load(a + at[u]);
        vb[u].load(b + at[u]);
        vc[u].load(c + at[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < VMACC_UNROLL; ++u) {
      if (!ok[u]) continue;
      va[u].madd_by(vb[u], vc[u]);
      va[u].store(out + at[u]);
    }
  }
}

template <typename T, int V>
int run(const void* a, const void* b, const void* c, void* out, int R, int C,
        int br, int bc, const Plan& p, cudaStream_t stream) {
  vmacc_kernel<T, V><<<p.blocks, VMACC_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), R, C, br, bc, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* out, int R,
           int C, int br, int bc, cudaStream_t stream) {
  // every index below fits an int: the tile grid and one band's elements
  if (R < 1 || C < 1 || br < 1 || bc < 1 ||
      (long long)((R + br - 1) / br) * ((C + bc - 1) / bc) > 0x7fffffffLL ||
      (long long)R * bc + VMACC_THREADS * VMACC_UNROLL > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const Plan p = make_plan(R, C, br, bc, (int)sizeof(T), aligned);
  constexpr int VEC = 16 / sizeof(T);
  if (p.v == VEC)
    return run<T, VEC>(a, b, c, out, R, C, br, bc, p, stream);
  return run<T, 1>(a, b, c, out, R, C, br, bc, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. a, b, c and out are (R, C), row-major
// and contiguous, any R, C >= 1 and any block (br, bc) >= 1. Returns a
// cudaError_t.
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
