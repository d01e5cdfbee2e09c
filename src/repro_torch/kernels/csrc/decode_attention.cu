// Decode attention for Hopper (sm_90a): one query a row against a KV cache,
// split over the cache's visible positions ("flash-decoding").
//
// Replaces no TPU kernel. The JAX package computes decode attention with
// einsums that XLA fuses (models/layers.py: _sdpa at one query a row); the
// port's PyTorch form of those einsums cast every slot of the cache to f32
// and laid it out again before each batched product, visible or not, which
// made decode attention most of a served decode step's card time. This
// kernel computes what _sdpa computes for one query a row, at its
// precision, from the cache as it is held:
//
// - scores in f32 from q and k of the cache's dtype (a bf16 product is exact
//   in f32), times 1/sqrt(D); the softmax's max and sum in f32;
// - the probabilities rounded to the cache's dtype before the PV product, as
//   _sdpa rounds them (p.to(v.dtype)); PV summed in f32;
// - the output cast to q's dtype, laid out (B, 1, Hq * D) as the output
//   projection takes it.
//
// What bounds it on this card: bytes. A step of Qwen1.5-MoE-A2.7B at batch 4
// reads K and V of ~4.1-5k visible positions x 16 heads x 128 of bf16 in
// each of 24 layers, about 3.5 GB, against a few FLOPs a byte. What the
// design does about it:
//
// - Only positions lo..hi are read: hi = min(pos, T - 1), lo = 0, or
//   pos - window + 1 where window >= 0. The position is read on the card
//   from an int32 (a step captured as a CUDA graph advances it between
//   replays) or passed by value.
// - Grid (B * Hkv) x splits: a block takes one KV head of one row, all its
//   group = Hq / Hkv query heads (K and V read once for the group), and one
//   split of the visible positions. `splits` comes from the shapes and the
//   SM count alone (kernels/decode_attention/kernel.py: splits_for), never
//   from the position, so one capture serves every position; each split's
//   length is ceil(n / splits) rounded up to DA_ALIGN. The KV head varies
//   fastest across blocks, so blocks that run together read neighbouring
//   head rows of the same positions.
// - Each lane loads 16 bytes of a head row: one row of D = 128 bf16 is 16
//   neighbouring lanes, 256 contiguous bytes. Each lane issues DA_UNROLL rows'
//   loads (read-only, not allocated in L1: each byte is read once) before it
//   uses the first, so a block of DA_THREADS keeps 16 KB in flight.
// - Two passes over a split: K, whose scores go to shared memory, then, once
//   the split's max is known, the probabilities in place and V. So a split's
//   probabilities are exp(s - m_split), rounded once; the plain version
//   (kernels/decode_attention/plain.py) computes the same split for split.
// - Each split writes an f32 partial (m, l, acc[D]) a query head to scratch;
//   a second kernel merges a head's partials in split order. No atomics: a
//   launch gives the same bits every time, captured or not.
//
// Supported: D in {16, 64, 128, 256}; float32 or bfloat16, q and the cache
// of one dtype; group <= 8 (the register file holds group x D / 32 sums a
// lane). Built without --use_fast_math: expf and the division are IEEE's.
#include <math.h>

#include <algorithm>

#include "tile.cuh"

namespace {

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_UNROLL = 8;  // rows a lane loads before it uses the first
constexpr int DA_ALIGN = 16;  // a split's length is a multiple of this
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;    // (B, Hkv * group, D)
  const void* k;    // (B, T, Hkv, D)
  const void* v;
  void* out;        // (B, Hkv * group, D)
  float* part;      // (B * Hkv, splits, group, D + 2): m, l, acc[D]
  const int* pos_dev;
  int pos_host;
  int B, T, Hkv, group, window, splits, chunk_max;
  float scale;
};

// The elements of one 16-byte vector, as f32, and the roundings _sdpa makes.
template <typename T> struct Elems;

template <> struct Elems<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& r, float (&f)[E]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the element at the lower address low
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <> struct Elems<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& r, float (&f)[E]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static float from(float x) { return x; }
};

// How lanes cover a head row of D elements of T.
template <typename T, int D> struct Shape {
  static constexpr int E = Elems<T>::E;          // elements a vector
  static constexpr int VR = D / E;               // vectors a row
  static constexpr int LPR = VR < 32 ? VR : 32;  // lanes a row
  static constexpr int VPL = VR / LPR;           // vectors a lane holds
  static constexpr int RPW = 32 / LPR;           // rows a warp loads at once
  static constexpr int RPB = RPW * DA_WARPS;     // rows a block loads at once
  static_assert(D % E == 0 && (VR & (VR - 1)) == 0, "unsupported head dim");
};

__device__ inline uint4 load_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// The visible positions lo..hi and this split's part of them: [start,
// start + len), len <= 0 for a split with none.
__device__ inline void split_range(const Params& p, int split, int* start,
                                   int* len) {
  const int pos = p.pos_dev ? *p.pos_dev : p.pos_host;
  const int hi = min(pos, p.T - 1);
  const int lo = p.window >= 0 ? max(0, pos - p.window + 1) : 0;
  const int n = hi - lo + 1;
  int chunk = (n + p.splits - 1) / p.splits;
  chunk = (chunk + DA_ALIGN - 1) / DA_ALIGN * DA_ALIGN;
  *start = lo + split * chunk;
  *len = min(chunk, hi + 1 - *start);
}

// Sum (or max) of x over the block, in a fixed order: a butterfly within each
// warp, then the warps' results in warp order. Every thread gets the result.
template <bool MAX>
__device__ inline float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    const float y = __shfl_xor_sync(FULL, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();  // scratch may still be read from a previous call
  if (threadIdx.x % 32 == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < DA_WARPS; ++w)
    r = MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_kernel(const Params p) {
  using S = Shape<T, D>;
  using X = Elems<T>;
  constexpr int E = S::E, VPL = S::VPL, LPR = S::LPR;
  extern __shared__ float smem[];  // scores, then probabilities; then sums
  __shared__ float scratch[DA_WARPS];
  __shared__ float m_s[GMAX], l_s[GMAX];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.group;
  float* rec = p.part + ((size_t)bh * p.splits + split) * G * (D + 2);
  int start, len;
  split_range(p, split, &start, &len);
  if (len <= 0) {  // no visible position: a partial that weighs nothing
    for (int i = threadIdx.x; i < G * (D + 2); i += DA_THREADS)
      rec[i] = i % (D + 2) == 0 ? -INFINITY : 0.f;
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = lane / LPR, li = lane % LPR;
  const size_t row_stride = (size_t)p.Hkv * D;
  const T* kbase = static_cast<const T*>(p.k) +
                   ((size_t)b * p.T + start) * row_stride + (size_t)h * D;
  const T* vbase = static_cast<const T*>(p.v) +
                   ((size_t)b * p.T + start) * row_stride + (size_t)h * D;
  const int cm = p.chunk_max;

  // the lane's elements of each query head: (li + j * LPR) * E + e
  float qf[GMAX][VPL][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const T* qrow = static_cast<const T*>(p.q) +
                    ((size_t)bh * G + (g < G ? g : 0)) * D;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      X::unpack(load_stream(qrow + (li + j * LPR) * E), qf[g][j]);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (g >= G) qf[g][j][e] = 0.f;
    }
  }

  // ---- pass 1: scores of K, into shared memory, and their max ------------
  float mx[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) mx[g] = -INFINITY;
  for (int base = 0; base < len; base += S::RPB * DA_UNROLL) {
    uint4 kv[DA_UNROLL][VPL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      // a row past the split loads its last row again, unused
      const int i = min(base + u * S::RPB + warp * S::RPW + rw, len - 1);
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        kv[u][j] = load_stream(kbase + i * row_stride + (li + j * LPR) * E);
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int i = base + u * S::RPB + warp * S::RPW + rw;
      float dot[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) dot[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float kf[E];
        X::unpack(kv[u][j], kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) dot[g] = fmaf(qf[g][j][e], kf[e], dot[g]);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o /= 2)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          dot[g] += __shfl_xor_sync(FULL, dot[g], o);
      if (i < len) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float s = dot[g] * p.scale;
          mx[g] = fmaxf(mx[g], s);
          if (li == 0) smem[g * cm + i] = s;
        }
      }
    }
  }
  for (int g = 0; g < G; ++g) {
    const float m = block_reduce<true>(mx[g], scratch);
    if (threadIdx.x == 0) m_s[g] = m;
  }
  __syncthreads();

  // ---- the probabilities, rounded to the cache's dtype, and their sum -----
  for (int g = 0; g < G; ++g) {
    const float m = m_s[g];
    float l = 0.f;
    for (int i = threadIdx.x; i < len; i += DA_THREADS) {
      const float e = expf(smem[g * cm + i] - m);
      l += e;
      smem[g * cm + i] = X::round(e);
    }
    l = block_reduce<false>(l, scratch);
    if (threadIdx.x == 0) l_s[g] = l;
  }
  __syncthreads();

  // ---- pass 2: V weighted by the probabilities ----------------------------
  float acc[GMAX][VPL][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][j][e] = 0.f;
  for (int base = 0; base < len; base += S::RPB * DA_UNROLL) {
    uint4 vv[DA_UNROLL][VPL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int i = min(base + u * S::RPB + warp * S::RPW + rw, len - 1);
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        vv[u][j] = load_stream(vbase + i * row_stride + (li + j * LPR) * E);
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int i = base + u * S::RPB + warp * S::RPW + rw;
      if (i >= len) continue;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float vf[E];
        X::unpack(vv[u][j], vf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float pr = smem[g * cm + i];
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][j][e] = fmaf(pr, vf[e], acc[g][j][e]);
        }
      }
    }
  }
  // the warp's rows summed (a butterfly over the lanes of one li), then the
  // warps' sums in warp order, through shared memory
#pragma unroll
  for (int o = LPR; o < 32; o *= 2)
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][j][e] += __shfl_xor_sync(FULL, acc[g][j][e], o);
  __syncthreads();  // every probability read: the sums take their place
  if (rw == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          smem[(warp * G + g) * D + (li + j * LPR) * E + e] = acc[g][j][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += DA_THREADS) {
    const int g = i / D, d = i - g * D;
    float s = smem[g * D + d];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w) s += smem[(w * G + g) * D + d];
    rec[g * (D + 2) + 2 + d] = s;
  }
  if (threadIdx.x < G) {
    rec[threadIdx.x * (D + 2)] = m_s[threadIdx.x];
    rec[threadIdx.x * (D + 2) + 1] = l_s[threadIdx.x];
  }
}

// One query head of one row a block, one element of its head a thread: the
// splits' partials merged in split order, out = acc / l in q's dtype.
template <typename T>
__global__ void decode_attention_combine(const float* __restrict__ part,
                                         T* __restrict__ out, int splits,
                                         int group, int D) {
  const int bhg = blockIdx.x, d = threadIdx.x;
  const int bh = bhg / group, g = bhg - bh * group;
  const size_t step = (size_t)group * (D + 2);
  const float* rec = part + (size_t)bh * splits * step + (size_t)g * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, rec[s * step]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* r = rec + s * step;
    const float w = expf(r[0] - m);
    l = fmaf(r[1], w, l);
    acc = fmaf(r[2 + d], w, acc);
  }
  out[(size_t)bhg * D + d] = Elems<T>::from(acc / l);
}

template <typename T, int D, int GMAX>
int run(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * std::max((size_t)p.chunk_max * p.group,
                               (size_t)DA_WARPS * p.group * D);
  const cudaError_t prep =
      tile::prepare_launch(decode_attention_kernel<T, D, GMAX>, smem);
  if (prep != cudaSuccess) return (int)prep;
  decode_attention_kernel<T, D, GMAX>
      <<<dim3(p.B * p.Hkv, p.splits), DA_THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine<T><<<p.B * p.Hkv * p.group, D, 0, stream>>>(
      p.part, static_cast<T*>(p.out), p.splits, p.group, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(const Params& p, cudaStream_t stream) {
  if (p.group <= 1) return run<T, D, 1>(p, stream);
  if (p.group <= 2) return run<T, D, 2>(p, stream);
  if (p.group <= 4) return run<T, D, 4>(p, stream);
  return run<T, D, 8>(p, stream);
}

template <typename T>
int by_dim(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return by_group<T, 16>(p, stream);
    case 64: return by_group<T, 64>(p, stream);
    case 128: return by_group<T, 128>(p, stream);
    case 256: return by_group<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of q, the cache and out alike. q and out
// (B, Hkv * group, D), k and v (B, T, Hkv, D), all contiguous; part holds
// B * Hkv * splits * group * (D + 2) floats. The position is *pos_dev where
// pos_dev is not null, else pos_host; it must leave a visible position
// (0 <= pos, and pos - window + 1 <= T - 1 where window >= 0, window != 0).
// Returns a cudaError_t.
extern "C" int decode_attention_launch(int dtype, int D, const void* q,
                                       const void* k, const void* v,
                                       void* out, void* part,
                                       const void* pos_dev, int pos_host,
                                       int B, int T, int Hkv, int group,
                                       int window, int splits, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || group < 1 || group > 8 || splits < 1 ||
      splits > 65535 || window == 0 ||
      (long long)B * Hkv * group > 0x7fffffffLL ||
      (long long)T * Hkv * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.pos_dev = static_cast<const int*>(pos_dev);
  p.pos_host = pos_host;
  p.B = B;
  p.T = T;
  p.Hkv = Hkv;
  p.group = group;
  p.window = window;
  p.splits = splits;
  const int most = (T + splits - 1) / splits;
  p.chunk_max = (most + DA_ALIGN - 1) / DA_ALIGN * DA_ALIGN;
  p.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_dim<float>(D, p, s);
    case 1: return by_dim<__nv_bfloat16>(D, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
