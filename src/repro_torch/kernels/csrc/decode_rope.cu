// The attention prologue of a decode step, for Hopper (sm_90a): from the
// projections' outputs to the query attention reads and the cache row it
// reads beside the others, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves RoPE and the cache's
// dynamic_update_slice to XLA, which fuses them. It exists to replace a chain
// of eager launches: per layer of a decode step the port's models/layers.py
// and models/mla.py spent about 50 (three bias adds, the frequencies
// recomputed in float64, casts, cos, sin, four products and two sums for each
// of q and k, a cat, a clamp and an arange for the slot, two index_copy_);
// each moved a few KB. Two modes, one algorithm in two layouts:
//
// - GQA (layers._attention_decode): q, k and v from their projections, each
//   plus its bias where the layer has one (rounded to bf16 as `y + b` is); q
//   and k rotated by halves (dim i with dim i + D/2); k and v written into
//   the cache at slot min(pos, T - 1) through the strides of the layer's
//   view; q rotated returned (B, Hq, D).
// - MLA (mla.attention_decode): c_kv of x @ wkv_a RMS-normed (kv_norm), k_pe
//   rotated by interleaved pairs (dims 2i, 2i + 1), the row c_kv ‖ k_pe
//   written into the latent cache at slot min(pos, T - 1); each head's q_pe
//   rotated and written after its q_lat (which mla.absorb computed from the
//   unrotated q_nope), so that the query the latent kernel reads,
//   (B, H, r + rope), is made here and needs no cat.
//
// The arithmetic is the eager path's, at its precision and rounding points:
// frequency i is the f32 of the float64 1 / theta^(2i / d), computed on the
// card as layers._rope_freqs_on computes it (pow and a division in float64);
// the angle f32(pos) * freq in f32; accurate cosf and sinf (never __cosf,
// whose error grows with the angle, up to 8192 rad here); each product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA);
// one rounding to bf16 at the end. So q, k, v and the cache rows equal the
// eager path's bit for bit; kv_norm's output may part by a bf16 ulp, its f32
// sum of squares being taken in another order.
//
// What bounds it on this card: latency. A step's 24-27 calls move under
// 1 MB. What the design does about it: one block a (row, head) of q and of
// k (GQA) or a row's latent and each head's q (MLA), every output written
// once from registers; the position is read on the card from an int32 (a step
// captured as a CUDA graph advances it between replays) or passed by value,
// so one capture serves every position; no scratch and no second launch.
//
// Supported: bf16; GQA head dims even up to 512; MLA r up to 1024 and rope
// even up to 256. Built without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int NORM_PER_LANE = 8;  // c_kv dims a lane holds: r <= 1024
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float f32(bf16 x) { return __bfloat162float(x); }
__device__ inline bf16 round_bf16(float x) { return __float2bfloat16_rn(x); }

// x[i], plus b[i] rounded to bf16 where there is a bias
__device__ inline float biased(const bf16* x, const bf16* b, int i) {
  return b ? f32(round_bf16(__fadd_rn(f32(x[i]), f32(b[i])))) : f32(x[i]);
}

// cos and sin of pair i's angle at `pos`, for a rotary width of d
__device__ inline void angle(int pos, int i, int d, double theta, float* c,
                             float* s) {
  const float freq = (float)(1.0 / pow(theta, (double)(2 * i) / (double)d));
  const float a = __fmul_rn((float)pos, freq);
  *c = cosf(a);
  *s = sinf(a);
}

// (x1 cos - x2 sin, x2 cos + x1 sin), each product and sum rounded alone
__device__ inline void rotate(float x1, float x2, float c, float s, bf16* o1,
                              bf16* o2) {
  *o1 = round_bf16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  *o2 = round_bf16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

struct Gqa {
  const bf16 *q, *k, *v;        // projections: rows of Hq * D, Hkv * D
  long long q_row, k_row, v_row;
  const bf16 *bq, *bk, *bv;     // biases (Hq * D, Hkv * D) or all null
  bf16* q_out;                  // (B, Hq, D)
  bf16 *k_cache, *v_cache;      // (B, T, Hkv, D), unit stride along D
  long long kb, kt, kh, vb, vt, vh;
  const int* pos_dev;
  int pos_host, T, Hq, Hkv, D;
  double theta;
};

// block (b, j): query head j < Hq, else KV head j - Hq (k rotated, v copied)
__global__ void __launch_bounds__(THREADS) decode_rope_gqa(Gqa p) {
  const int b = blockIdx.x, j = blockIdx.y, half = p.D / 2;
  const int pos = p.pos_dev ? *p.pos_dev : p.pos_host;
  const int slot = pos < p.T - 1 ? pos : p.T - 1;
  const bool is_q = j < p.Hq;
  const int h = is_q ? j : j - p.Hq;
  const bf16* src = is_q ? p.q + b * p.q_row + (size_t)h * p.D
                         : p.k + b * p.k_row + (size_t)h * p.D;
  const bf16* bias = is_q ? (p.bq ? p.bq + (size_t)h * p.D : nullptr)
                          : (p.bk ? p.bk + (size_t)h * p.D : nullptr);
  bf16* dst = is_q ? p.q_out + ((size_t)b * p.Hq + h) * p.D
                   : p.k_cache + b * p.kb + slot * p.kt + h * p.kh;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float c, s;
    angle(pos, i, p.D, p.theta, &c, &s);
    rotate(biased(src, bias, i), biased(src, bias, i + half), c, s, dst + i,
           dst + i + half);
  }
  if (is_q) return;
  const bf16* vs = p.v + b * p.v_row + (size_t)h * p.D;
  const bf16* vbias = p.bv ? p.bv + (size_t)h * p.D : nullptr;
  bf16* vd = p.v_cache + b * p.vb + slot * p.vt + h * p.vh;
  for (int i = threadIdx.x; i < p.D; i += blockDim.x)
    vd[i] = round_bf16(biased(vs, vbias, i));
}

struct Mla {
  const bf16* q;                // rows of H * (nope + rope)
  long long q_row;
  const bf16* kv;               // rows of r + rope
  long long kv_row;
  const bf16* norm;             // (r)
  const bf16* q_lat;            // (B, H, r), strides lat_b, lat_h, 1
  long long lat_b, lat_h;
  bf16* q_out;                  // (B, H, r + rope)
  bf16* cache;                  // (B, T, r + rope), strides cb, ct, 1
  long long cb, ct;
  const int* pos_dev;
  int pos_host, T, H, nope, r, rope;
  float factor, eps;            // kv_norm's mean factor (1 / r) and eps
  double theta;
};

// block (b, 0): the row's latent (c_kv normed ‖ k_pe rotated) into the
// cache; block (b, 1 + h): head h's q_lat ‖ q_pe rotated
__global__ void __launch_bounds__(THREADS) decode_rope_mla(Mla p) {
  __shared__ float warp_sums[THREADS / 32];
  const int b = blockIdx.x, j = blockIdx.y, pairs = p.rope / 2;
  const int pos = p.pos_dev ? *p.pos_dev : p.pos_host;
  const int width = p.r + p.rope;
  if (j > 0) {
    const int h = j - 1;
    const bf16* lat = p.q_lat + b * p.lat_b + h * p.lat_h;
    bf16* out = p.q_out + ((size_t)b * p.H + h) * width;
    for (int i = threadIdx.x; i < p.r; i += blockDim.x) out[i] = lat[i];
    const bf16* pe =
        p.q + b * p.q_row + (size_t)h * (p.nope + p.rope) + p.nope;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      float c, s;
      angle(pos, i, p.rope, p.theta, &c, &s);
      rotate(f32(pe[2 * i]), f32(pe[2 * i + 1]), c, s, out + p.r + 2 * i,
             out + p.r + 2 * i + 1);
    }
    return;
  }
  const int slot = pos < p.T - 1 ? pos : p.T - 1;
  const bf16* kv = p.kv + b * p.kv_row;
  bf16* row = p.cache + b * p.cb + slot * p.ct;
  float v[NORM_PER_LANE];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < NORM_PER_LANE; ++e) {
    const int i = threadIdx.x + e * blockDim.x;
    v[e] = i < p.r ? f32(kv[i]) : 0.f;
    ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(total, p.factor), p.eps));
#pragma unroll
  for (int e = 0; e < NORM_PER_LANE; ++e) {
    const int i = threadIdx.x + e * blockDim.x;
    if (i < p.r)
      row[i] = round_bf16(__fmul_rn(__fmul_rn(v[e], inv), f32(p.norm[i])));
  }
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    float c, s;
    angle(pos, i, p.rope, p.theta, &c, &s);
    rotate(f32(kv[p.r + 2 * i]), f32(kv[p.r + 2 * i + 1]), c, s,
           row + p.r + 2 * i, row + p.r + 2 * i + 1);
  }
}

}  // namespace

// The position is *pos_dev where pos_dev is not null, else pos_host (0 or
// later); strides in elements. Each returns a cudaError_t.
extern "C" int decode_rope_gqa_launch(
    const void* q, const void* k, const void* v, long long q_row,
    long long k_row, long long v_row, const void* bq, const void* bk,
    const void* bv, void* q_out, void* k_cache, void* v_cache, long long kb,
    long long kt, long long kh, long long vb, long long vt, long long vh,
    const void* pos_dev, int pos_host, int B, int T, int Hq, int Hkv, int D,
    double theta, void* stream) {
  if (B < 1 || T < 1 || Hq < 1 || Hkv < 1 || D < 2 || D % 2 || D > 512 ||
      B > 65535 || Hq + Hkv > 65535 || (!pos_dev && pos_host < 0))
    return (int)cudaErrorInvalidValue;
  Gqa p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), q_row, k_row, v_row,
        static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
        static_cast<const bf16*>(bv), static_cast<bf16*>(q_out),
        static_cast<bf16*>(k_cache), static_cast<bf16*>(v_cache),
        kb, kt, kh, vb, vt, vh, static_cast<const int*>(pos_dev), pos_host,
        T, Hq, Hkv, D, theta};
  const int threads = D / 2 >= THREADS ? THREADS : ((D / 2 + 31) / 32) * 32;
  decode_rope_gqa<<<dim3(B, Hq + Hkv), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int decode_rope_mla_launch(
    const void* q, long long q_row, const void* kv, long long kv_row,
    const void* norm, const void* q_lat, long long lat_b, long long lat_h,
    void* q_out, void* cache, long long cb, long long ct,
    const void* pos_dev, int pos_host, int B, int T, int H, int nope, int r,
    int rope, float factor, float eps, double theta, void* stream) {
  if (B < 1 || T < 1 || H < 1 || nope < 0 || r < 1 ||
      r > THREADS * NORM_PER_LANE || rope < 2 || rope % 2 || rope > 256 ||
      B > 65535 || H + 1 > 65535 || (!pos_dev && pos_host < 0))
    return (int)cudaErrorInvalidValue;
  Mla p{static_cast<const bf16*>(q), q_row, static_cast<const bf16*>(kv),
        kv_row, static_cast<const bf16*>(norm),
        static_cast<const bf16*>(q_lat), lat_b, lat_h,
        static_cast<bf16*>(q_out), static_cast<bf16*>(cache), cb, ct,
        static_cast<const int*>(pos_dev), pos_host, T, H, nope, r, rope,
        factor, eps, theta};
  decode_rope_mla<<<dim3(B, H + 1), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
