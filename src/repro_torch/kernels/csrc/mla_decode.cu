// Latent decode attention (MLA, absorbed form) for Hopper (sm_90a): the 16
// heads of one query a row against the bf16 latent cache, split over the
// cache's visible positions.
//
// Replaces no TPU kernel: the JAX package has no latent attention. The
// port's models/mla.py computes a decode step's attention in the absorbed
// form: each head's query is q_lat (its nope dims taken through W_UK into the
// 512-wide latent space) and q_pe (64 RoPE dims), and every head attends over
// the same cached row of a token, c_kv (512) and k_pe (64). This kernel
// computes what mla.absorbed computes, at its precision, from the cache as it
// is held:
//
// - scores in f32 of q (bf16) against the row's 576 dims, times the scale
//   (1/sqrt(192) for Moonlight-16B-A3B), the softmax's max and sum in f32;
// - the probabilities rounded to bf16 before their product with c_kv, as
//   mla.absorbed rounds them (p.to(cache dtype)); that product summed in f32;
// - the output, (B, 16, 512), in bf16, for W_UV and the output projection.
//
// What bounds it on this card: bytes. A step of Moonlight-16B-A3B at 16 rows
// reads ~4-8k latent rows of 1152 bytes a row in each of 27 layers (at 6144
// positions 3.06 GB a step), and writes 16 KB a row and layer. Every head
// reads the same row, so the arithmetic is 16 x 1088 x 2 FLOP over 1152 B,
// 30 FLOP a byte: on f32 FMAs (67 TFLOP/s) it would be held to ~66 % of the
// bytes' rate. What the design does about it:
//
// - The 16 heads are the M = 16 of a bf16 mma.sync tile (m16n8k16), for the
//   scores (Q (16 x 576) . K^T) and the output (P (16 x positions) . c_kv)
//   alike, so the tensor cores do the arithmetic at a few % of their rate.
// - Each latent row is read once a row of the batch, not once a head: a
//   block stages TILE rows in shared memory with cp.async (16 bytes a
//   lane, through L2 only), two stages, the next tile in flight while this
//   one is used. Rows are padded by 16 bytes in shared memory so that
//   ldmatrix's eight rows fall in eight different bank groups.
// - Only positions 0..hi are read, hi = min(pos, T - 1); the position is
//   read on the card from an int32 (a step captured as a CUDA graph
//   advances it between replays) or passed by value. Grid B x splits; the
//   split count comes from the shapes and the SM count alone
//   (kernels/mla_decode/kernel.py: splits_for), never from the position, so
//   one capture serves every position; a split's length is a multiple of
//   TILE. A block keeps an online softmax over its tiles; the 8 warps share
//   one running max, each computes 8 positions' scores of a tile and 64
//   columns of the output.
// - Each split writes an f32 partial (m, l, acc[512]) a head to scratch; a
//   second kernel merges a head's partials in split order. No atomics: a
//   launch gives the same bits every time, captured or not.
//
// Supported: 16 heads, rows of 512 + 64, bf16. Built without
// --use_fast_math: expf and the divisions are IEEE's.
#include <math.h>

#include <algorithm>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HEADS = 16;
constexpr int LAT = 512;
constexpr int ROPE = 64;
constexpr int WIDTH = LAT + ROPE;     // 576 bf16 a row
constexpr int CHUNKS = WIDTH / 8;     // 16-byte chunks a row
constexpr int TILE = 64;              // positions a stage holds
constexpr int STAGES = 2;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LD = WIDTH + 8;         // a staged row: 1168 bytes, 292 words
constexpr int PLD = TILE + 8;         // a row of probabilities: 144 bytes
constexpr int COLS = LAT / WARPS;     // output columns a warp sums: 64
constexpr unsigned FULL = 0xffffffffu;

static_assert(TILE == 8 * WARPS, "a warp scores 8 positions of a tile");
static_assert(COLS % 16 == 0, "a warp's columns are pairs of n8 tiles");

constexpr size_t SMEM_BYTES =
    sizeof(bf16) * ((size_t)HEADS * LD + (size_t)STAGES * TILE * LD +
                    (size_t)HEADS * PLD) +
    sizeof(float) * 2 * WARPS * HEADS;

struct Params {
  const bf16* q;      // (B, HEADS, WIDTH)
  const bf16* cache;  // (B, T, WIDTH)
  bf16* out;          // (B, HEADS, LAT)
  float* part;        // (B, splits, HEADS, LAT + 2): m, l, acc[LAT]
  const int* pos_dev;
  int pos_host;
  int B, T, splits;
  float scale;
};

// This split's part of the visible positions 0..hi: [start, start + len),
// len <= 0 for a split with none.
__device__ inline void split_range(const Params& p, int split, int* start,
                                   int* len) {
  const int pos = p.pos_dev ? *p.pos_dev : p.pos_host;
  const int n = min(pos, p.T - 1) + 1;
  int chunk = (n + p.splits - 1) / p.splits;
  chunk = (chunk + TILE - 1) / TILE * TILE;
  *start = split * chunk;
  *len = min(chunk, n - *start);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows [t0, t0 + TILE) of the split (zeros past `len`) in `dst`.
__device__ inline void stage_tile(bf16* dst, const bf16* rows, int t0,
                                  int len) {
  for (int c = threadIdx.x; c < TILE * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, k = c - r * CHUNKS;
    const bool valid = t0 + r < len;
    const bf16* src = rows + (size_t)(valid ? t0 + r : 0) * WIDTH + k * 8;
    mma::cp_async_zfill<16>(dst + r * LD + k * 8, src, valid);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mla_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + HEADS * LD;
  bf16* ps = ks + STAGES * TILE * LD;
  float* red_max = reinterpret_cast<float*>(ps + HEADS * PLD);
  float* red_sum = red_max + WARPS * HEADS;

  const int b = blockIdx.x / p.splits, split = blockIdx.x - b * p.splits;
  float* rec = p.part + ((size_t)b * p.splits + split) * HEADS * (LAT + 2);
  int start, len;
  split_range(p, split, &start, &len);
  if (len <= 0) {  // no visible position: a partial that weighs nothing
    for (int i = threadIdx.x; i < HEADS * (LAT + 2); i += THREADS)
      rec[i] = i % (LAT + 2) == 0 ? -INFINITY : 0.f;
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // the mma fragments' row, column
  const bf16* rows = p.cache + ((size_t)b * p.T + start) * WIDTH;
  const int tiles = (len + TILE - 1) / TILE;

  // the query, then the first two tiles, each its own cp.async group (Q
  // rides with tile 0)
  const bf16* q = p.q + (size_t)b * HEADS * WIDTH;
  for (int c = threadIdx.x; c < HEADS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, k = c - r * CHUNKS;
    mma::cp_async16(qs + r * LD + k * 8, q + r * WIDTH + k * 8);
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < tiles) stage_tile(ks + s * TILE * LD, rows, s * TILE, len);
    mma::cp_async_commit();
  }

  // running max and sum of heads g and g + 8 (the same in every warp), and
  // the warp's output columns: n8 tile j holds columns COLS * warp + 8 j +
  // 2 t4 (+1) of heads g (acc[j][0..1]) and g + 8 (acc[j][2..3])
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[COLS / 8][4];
#pragma unroll
  for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    mma::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const bf16* kt = ks + (t % STAGES) * TILE * LD;

    // ---- scores of the warp's 8 positions: Q (16 x 576) . K^T ----------
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < WIDTH / 16; kk += 2) {
      uint32_t kb[4], a0[4], a1[4];
      mma::ldmatrix_x4(kb, kt + (8 * warp + lane % 8) * LD + kk * 16 +
                               (lane / 8) * 8);
      mma::ldmatrix_x4(a0, qs + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      mma::ldmatrix_x4(a1, qs + (lane % 16) * LD + (kk + 1) * 16 +
                               (lane / 16) * 8);
      mma::mma_bf16_16816(s, a0, kb[0], kb[1]);
      mma::mma_bf16_16816(s, a1, kb[2], kb[3]);
    }
    // s[0..1]: head g at positions 8 warp + 2 t4 (+1); s[2..3] head g + 8
    const int i0 = t * TILE + 8 * warp + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = i0 + (e & 1) < len ? s[e] * p.scale : -INFINITY;

    // ---- the tile's max over the warps, in warp order ---------------------
    float x0 = fmaxf(s[0], s[1]), x1 = fmaxf(s[2], s[3]);
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      x0 = fmaxf(x0, __shfl_xor_sync(FULL, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, o));
    }
    if (t4 == 0) {
      red_max[warp * HEADS + g] = x0;
      red_max[warp * HEADS + g + 8] = x1;
    }
    __syncthreads();
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      n0 = fmaxf(n0, red_max[w * HEADS + g]);
      n1 = fmaxf(n1, red_max[w * HEADS + g + 8]);
    }
    // ---- the probabilities: to shared memory in bf16, their sums ---------
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = expf(s[e] - (e < 2 ? n0 : n1));
    const int col = 8 * warp + 2 * t4;
    *reinterpret_cast<uint32_t*>(ps + g * PLD + col) = pack_bf16(pr[0], pr[1]);
    *reinterpret_cast<uint32_t*>(ps + (g + 8) * PLD + col) =
        pack_bf16(pr[2], pr[3]);
    float y0 = pr[0] + pr[1], y1 = pr[2] + pr[3];
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      y0 += __shfl_xor_sync(FULL, y0, o);
      y1 += __shfl_xor_sync(FULL, y1, o);
    }
    if (t4 == 0) {
      red_sum[warp * HEADS + g] = y0;
      red_sum[warp * HEADS + g + 8] = y1;
    }
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    __syncthreads();
    float z0 = 0.f, z1 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      z0 += red_sum[w * HEADS + g];
      z1 += red_sum[w * HEADS + g + 8];
    }
    l0 = l0 * alpha0 + z0;
    l1 = l1 * alpha1 + z1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // ---- the output: P (16 x TILE) . c_kv (TILE x the warp's columns) ----
#pragma unroll
    for (int kq = 0; kq < TILE / 16; ++kq) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, ps + (lane % 16) * PLD + kq * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < COLS / 16; ++jj) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(
            vb, kt + (kq * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                    COLS * warp + jj * 16 + (lane / 16) * 8);
        mma::mma_bf16_16816(acc[2 * jj], a, vb[0], vb[1]);
        mma::mma_bf16_16816(acc[2 * jj + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage and the probabilities are free again
    if (t + STAGES < tiles)
      stage_tile(ks + (t % STAGES) * TILE * LD, rows, (t + STAGES) * TILE,
                 len);
    mma::cp_async_commit();
  }
  mma::cp_async_wait_all();

#pragma unroll
  for (int j = 0; j < COLS / 8; ++j) {
    const int c = 2 + COLS * warp + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(rec + g * (LAT + 2) + c) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(rec + (g + 8) * (LAT + 2) + c) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (warp == 0 && t4 == 0) {
    rec[g * (LAT + 2)] = m0;
    rec[g * (LAT + 2) + 1] = l0;
    rec[(g + 8) * (LAT + 2)] = m1;
    rec[(g + 8) * (LAT + 2) + 1] = l1;
  }
}

// One head of one row a block, two output columns a thread: the splits'
// partials merged in split order, out = acc / l in bf16.
__global__ void __launch_bounds__(LAT / 2)
    mla_decode_combine(const float* __restrict__ part, bf16* __restrict__ out,
                       int splits) {
  const int bh = blockIdx.x, b = bh / HEADS, h = bh - b * HEADS;
  const size_t step = (size_t)HEADS * (LAT + 2);
  const float* rec = part + (size_t)b * splits * step + (size_t)h * (LAT + 2);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, rec[s * step]);
  const int c = 2 * threadIdx.x;
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* r = rec + s * step;
    const float w = expf(r[0] - m);
    l = fmaf(r[1], w, l);
    a0 = fmaf(r[2 + c], w, a0);
    a1 = fmaf(r[3 + c], w, a1);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)bh * LAT + c) =
      __floats2bfloat162_rn(a0 / l, a1 / l);
}

}  // namespace

// q (B, 16, 576), cache (B, T, 576) and out (B, 16, 512), bf16, contiguous,
// starting on 16 bytes; part holds B * splits * 16 * 514 floats. The
// position is *pos_dev where pos_dev is not null, else pos_host; it must be
// 0 or later. Returns a cudaError_t.
extern "C" int mla_decode_launch(const void* q, const void* cache, void* out,
                                 void* part, const void* pos_dev,
                                 int pos_host, int B, int T, int splits,
                                 float scale, void* stream) {
  if (B < 1 || T < 1 || splits < 1 || (long long)B * splits > 0x7fffffffLL ||
      (!pos_dev && pos_host < 0))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.cache = static_cast<const bf16*>(cache);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.pos_dev = static_cast<const int*>(pos_dev);
  p.pos_host = pos_host;
  p.B = B;
  p.T = T;
  p.splits = splits;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile::prepare_launch(mla_decode_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  mla_decode_kernel<<<B * splits, THREADS, SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mla_decode_combine<<<B * HEADS, LAT / 2, 0, s>>>(p.part, p.out, splits);
  return (int)cudaGetLastError();
}
