// Blockwise (flash) attention for Hopper (sm_90a) on the tensor cores:
// online softmax with f32 running state, grouped-query heads, bottom-right-
// aligned causal masking.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:_fa_kernel. Operands
// are q (BH, pq, pd) and k, v (BH / group, pkv, pd), row-major and zero-padded
// to the block; q head h reads KV head h / group, as the Pallas index maps.
//
// One thread block owns one (head, q block) pair. The Pallas grid's KV axis
// is a sequential reduction (the online softmax carries m, l and acc from
// one KV step to the next), so it becomes a loop inside the block, in order
// jk = 0, 1, ... A KV block is skipped exactly when the Pallas predicate
// says it is dead (kernel.py:40), decided for the whole (bq, bkv) block;
// the predicate is monotone in jk, so the loop stops at the first dead
// block. Skipping is not masking: inside a live block every column is
// computed, and a row with no visible key at all (causal, q_len > kv_len)
// takes p = exp(NEG_INF - NEG_INF) = 1 on every column of every live block,
// the padded tail included; its output is the mean of those v rows. Blocks
// are issued heaviest first (the last q block of a head first), which only
// changes when each block runs.
//
// What bounds it on this card: operations. MobileLLM-125M's prefill
// attention at its max_seq_len 2048 (9 heads, head dim 64, causal, f32)
// does 4.8 GFLOP on its visible (query, key) pairs; 3xTF32 issues three
// TF32 products per f32 product, 29 us at the 494.7 TFLOP/s dense TF32
// rate, against 3.8 us to move its 12.6 MB. What the design does about it:
//
// - QK^T and PV on the tensor cores with mma.sync, the running state in
//   registers. Warp (rq, kq) owns query rows [16 rq, 16 rq + 16) of the
//   block and columns [kq cols, (kq + 1) cols) of every KV tile; it walks
//   its columns in sub-tiles of 64, 32 or 16 (the widest that divides
//   them, at most 32 at head dims above 128), a compile-time width, so the
//   score fragment stays within 32 registers and no sub-tile is partial.
//   Scores never leave the registers: the row max and sum are quad
//   shuffles of the mma fragment, and acc is rescaled by alpha in
//   registers.
// - f32 as 3xTF32: each value v splits into hi = tf32_rna(v) and lo =
//   tf32_rna(v - hi) (mma.cuh: the rounding of cvt.rna.tf32 in two integer
//   instructions); a product is lo*hi + hi*lo + hi*hi (m16n8k8), small
//   terms first. QK^T sums over the head dim on the tensor cores; PV sums a
//   sub-tile's keys from zero on the tensor cores and adds that to acc in
//   f32 (acc = acc * alpha + pv), so no tensor-core sum runs over more than
//   64 keys. One TF32 pass (2^-11 per product) would move exp(s - m) by
//   more than the 2e-3 tolerance on peaked scores. Each pass of products
//   runs over every tile of the sub-tile (QK^T) or over eight head-dim
//   tiles (PV) before the next, so consecutive mma never wait on one
//   accumulator.
// - bf16: QK^T with m16n8k16 bf16 (products exact in f32). P is f32, so PV
//   runs as TF32 with P split into hi + lo (bf16 v is exact in TF32): two
//   m16n8k8 products, P good to 2^-22. Rounding P to bf16 would cost
//   about 4e-3.
// - PV needs P as an mma A fragment. Its k index is permuted (k = t holds
//   key 2t, k = t + 4 key 2t + 1), which makes the A fragment the score
//   fragment's own registers, and v's B fragment rows 2t and 2t + 1: 32-bit
//   shared loads for f32, one ldmatrix.trans for two bf16 pairs.
// - K and V tiles arrive by 16-byte cp.async in a FA_STAGES-deep ring: the
//   next KV tile is in flight while the current one is multiplied, one
//   barrier per step. The q tile is copied once, with the first KV tile,
//   and its fragments are read by ldmatrix (and split) at each step: held
//   in registers they would take up to 2 x pd of them.
// - Shared rows are padded by 16 bytes: a row stride of 4 mod 8 words (pd a
//   multiple of 16) puts the eight rows of an ldmatrix matrix in eight
//   16-byte bank groups and f32 v's loads at rows 2t, 2t+1 in 32 banks.
// - Enough warps at small bq: a block splits each KV tile's columns over
//   kq = 0 .. wk-1 while it has fewer than FA_MIN_WARPS warps and the
//   columns divide into 16-column shares (bq = 16, bkv = 64: four warps).
//   Each warp keeps its own m, l and acc over its columns; at the end the
//   wk partial states of a row meet in shared memory and combine in kq
//   order: m = max m_kq, w_kq = exp(m_kq - m), l = sum w_kq l_kq, out =
//   sum w_kq acc_kq / l. The order is fixed, so the result is the same
//   from run to run; no atomics. A warp whose columns see no key keeps m =
//   NEG_INF, and its weight is then exp(NEG_INF - m) = 0, or 1 when no
//   warp sees one (the no-visible-key rows), as the sequential loop gives.
// - Head dims: register classes of 64, 128 and 256 (acc holds DC / 2
//   floats a thread); the networks' 64 has its own instantiation with no
//   predicate on the head dim.
//
// Shared memory: the q tile, then FA_STAGES stages of a k and a v tile,
// every row pd values plus FA_ROW_PAD bytes: (bq + 2 FA_STAGES bkv) (pd
// sizeof(T) + 16) bytes, nondecreasing in bq, bkv and pd. The partial
// states of a split block take wk bq rows of pd + 4 floats and two floats
// a row, inside the ring once the loop is done (wk > 1 means bkv >= 32 and
// wk bq <= 64). kernels/flash_attention/ops.py: smem_bytes mirrors
// fa_smem_bytes, plan mirrors fa_plan. The output is written once, from
// the fragments or from the combine.
//
// Numerics: expf (not __expf), IEEE division, NEG_INF = -1e30 as a float
// so that exp(NEG_INF - NEG_INF) = 1 as in the reference; the scale is
// 1/sqrt(d_real) rounded once to float, as JAX rounds the Python float, and
// multiplies the finished dot product. Padded head-dim columns are zeros
// and add nothing to a score. Built without --use_fast_math.
#include <cmath>
#include <type_traits>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int FA_FRAG = 16;      // query rows per warp: one mma m16
constexpr int FA_STAGES = 2;     // the K/V cp.async ring
constexpr int FA_ROW_PAD = 16;   // bytes of padding per shared row
constexpr int FA_MIN_WARPS = 4;  // split KV columns over warps up to this
constexpr int FA_MAX_BQ = 128;   // 8 warps of query rows
constexpr int FA_MAX_PD = 256;   // the largest register class below
constexpr int FA_THREADS = 256;  // FA_MAX_BQ / FA_FRAG warps
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t fa_row_bytes(int pd, int esize) {
  return (size_t)pd * esize + FA_ROW_PAD;
}

__host__ __device__ inline size_t fa_smem_bytes(int bq, int bkv, int pd,
                                                int esize) {
  return ((size_t)bq + 2 * FA_STAGES * (size_t)bkv) * fa_row_bytes(pd, esize);
}

// The launch-time layout, computed once on the host.
struct FaPlan {
  int wq;      // warps down the query rows (bq / 16)
  int wk;      // warps across each KV tile's columns
  int warps;   // wq * wk
  int cols;    // KV columns per warp (bkv / wk, a multiple of 16)
  int dclass;  // register class of the head dim: 64, 128 or 256
  int sub;     // key columns per sub-tile: 64, 32 or 16, dividing cols
};

__host__ inline FaPlan fa_plan(int bq, int bkv, int pd) {
  FaPlan p{};
  p.wq = bq / FA_FRAG;
  p.wk = 1;
  while ((bkv / FA_FRAG) % (2 * p.wk) == 0 &&
         p.wq * p.wk * 2 <= FA_MIN_WARPS)
    p.wk *= 2;
  p.warps = p.wq * p.wk;
  p.cols = bkv / p.wk;
  p.dclass = pd <= 64 ? 64 : pd <= 128 ? 128 : 256;
  p.sub = p.cols % 64 == 0 && p.dclass != 256 ? 64 : p.cols % 32 == 0 ? 32
                                                                      : 16;
  return p;
}

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int group, pq, pkv, pd, bq, bkv, kv_len, offset, causal, wk, cols;
  float scale;
};

__device__ inline void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ inline void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ inline void store1(float* p, float x) { *p = x; }
__device__ inline void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// T: float or bf16. DC: the head dim's register class (pd <= DC); SUBT:
// the n8 key tiles of a sub-tile (its width divides the warp's columns, so
// every sub-tile is full); EXACT: pd == DC. Loops over head-dim tiles run
// to DC / 8, predicated on the runtime pd unless EXACT, so every register
// array has a compile-time index and the networks' head dim (64) runs
// without a branch around an mma.
template <typename T, int DC, int SUBT, bool EXACT>
__global__ void __launch_bounds__(FA_THREADS) fa_tc_kernel(const FaArgs a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ND = DC / 8;                 // head-dim n8 tiles, at most
  constexpr int KC = F32 ? 8 : 16;           // head dim per QK^T mma
  constexpr int NK = DC / KC;                // QK^T k chunks, at most
  constexpr int JB = DC == 256 ? 4 : 8;      // head-dim tiles per pv pass
  constexpr int V = 16 / sizeof(T);          // values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int pd = EXACT ? DC : a.pd;
  const int stride = pd + FA_ROW_PAD / (int)sizeof(T);
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + (size_t)a.bq * stride;
  const int slot = 2 * a.bkv * stride;       // one stage: k rows, v rows

  const int gq = a.pq / a.bq;
  const int h = blockIdx.x / gq;
  const int iq = gq - 1 - (int)(blockIdx.x - h * gq);  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = a.bq / FA_FRAG;
  const int rq = warp % wq, kq = warp / wq;
  const int nd = pd / 8, nk = pd / KC;

  const T* qg = static_cast<const T*>(a.q) +
                ((size_t)h * a.pq + (size_t)iq * a.bq) * pd;
  const size_t kv0 = (size_t)(h / a.group) * a.pkv * pd;
  const T* kg = static_cast<const T*>(a.k) + kv0;
  const T* vg = static_cast<const T*>(a.v) + kv0;

  int steps = a.pkv / a.bkv;
  if (a.causal) {  // the Pallas predicate jk * bkv <= q_last, per block
    const int q_last = iq * a.bq + a.bq - 1 + a.offset;
    steps = q_last < 0 ? 0 : min(steps, q_last / a.bkv + 1);
  }

  const mma::ChunkWalk walk(pd / V);
  auto load_kv = [&](int jk) {
    T* ks = ring + (jk % FA_STAGES) * slot;
    T* vs = ks + a.bkv * stride;
    const T* kb = kg + (size_t)jk * a.bkv * pd;
    const T* vb = vg + (size_t)jk * a.bkv * pd;
    for (int r = walk.r0, c = walk.c0; r < a.bkv; walk.next(r, c)) {
      mma::cp_async16(ks + r * stride + c * V, kb + (size_t)r * pd + c * V);
      mma::cp_async16(vs + r * stride + c * V, vb + (size_t)r * pd + c * V);
    }
  };
  for (int r = walk.r0, c = walk.c0; r < a.bq; walk.next(r, c))
    mma::cp_async16(qs + r * stride + c * V, qg + (size_t)r * pd + c * V);
  if (steps > 0) load_kv(0);
  mma::cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this thread's share
  // of the running sum (its two columns of each n8 tile)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row_lo = iq * a.bq + rq * FA_FRAG + a.offset;  // key position
  // ldmatrix.x4 row addresses. q (A): matrices (rows 0-7, k lo), (rows
  // 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi) = a0..a3, k lo/hi the
  // two 16-byte halves of a k chunk. k (B, two n8 tiles): (keys 0-7, k lo),
  // (keys 0-7, k hi), (keys 8-15, k lo), (keys 8-15, k hi) = b0, b1 of the
  // first tile, then of the second.
  const T* qa = qs + (rq * FA_FRAG + (lane & 15)) * stride + (lane >> 4) * V;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * V;

  for (int jk = 0; jk < steps; ++jk) {
    // Step jk's copies have landed for every thread, and every warp is done
    // with step jk-1's slot, which step jk+1 now overwrites.
    mma::cp_async_wait<0>();
    __syncthreads();
    if (jk + 1 < steps) load_kv(jk + 1);
    mma::cp_async_commit();
    const T* ks = ring + (jk % FA_STAGES) * slot;
    const T* vs = ks + a.bkv * stride;
    const int c_end = (kq + 1) * a.cols;
    for (int c0 = kq * a.cols; c0 < c_end; c0 += SUBT * 8) {
      // ---- scores s = q k^T over the head dim, on the tensor cores ----
      float s[SUBT][4];
#pragma unroll
      for (int n = 0; n < SUBT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const T* kb = ks + (c0 + kb_row) * stride + kb_col;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        if (!EXACT && kc >= nk) break;
        uint32_t qr[4];
        mma::ldmatrix_x4(qr, qa + kc * KC);
        // every tile's k fragment first, then one product per tile at a
        // time: consecutive mma never wait on each other's accumulator
        uint32_t kr[SUBT][2];
#pragma unroll
        for (int np = 0; np < SUBT / 2; ++np) {
          uint32_t r[4];
          mma::ldmatrix_x4(r, kb + np * 16 * stride + kc * KC);
          kr[2 * np][0] = r[0];
          kr[2 * np][1] = r[1];
          kr[2 * np + 1][0] = r[2];
          kr[2 * np + 1][1] = r[3];
        }
        if constexpr (F32) {
          uint32_t qh[4], ql[4], kl[SUBT][2];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma::split_tf32(__uint_as_float(qr[e]), qh[e], ql[e]);
#pragma unroll
          for (int n = 0; n < SUBT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mma::split_tf32(__uint_as_float(kr[n][e]), kr[n][e], kl[n][e]);
#pragma unroll
          for (int n = 0; n < SUBT; ++n)
            mma::mma_tf32_1688(s[n], ql, kr[n][0], kr[n][1]);
#pragma unroll
          for (int n = 0; n < SUBT; ++n)
            mma::mma_tf32_1688(s[n], qh, kl[n][0], kl[n][1]);
#pragma unroll
          for (int n = 0; n < SUBT; ++n)
            mma::mma_tf32_1688(s[n], qh, kr[n][0], kr[n][1]);
        } else {
#pragma unroll
          for (int n = 0; n < SUBT; ++n)
            mma::mma_bf16_16816(s[n], qr, kr[n][0], kr[n][1]);
        }
      }
      // ---- scale, mask, online softmax (rows g: e 0-1, g + 8: e 2-3) ----
      const int col0 = jk * a.bkv + c0;  // key position of the sub-tile
      const int col_hi = col0 + SUBT * 8 - 1;
      const bool full =
          col_hi < a.kv_len && (!a.causal || col_hi <= row_lo);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < SUBT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s[n][e] * a.scale;
          if (!full) {
            const int col = col0 + n * 8 + 2 * t + (e & 1);
            const int row = row_lo + g + (e >> 1) * 8;
            if (!(col < a.kv_len && (!a.causal || col <= row))) sv = NEG_INF;
          }
          s[n][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
      // P as the A fragment of m16n8k8 with the permuted k (a0 = key 2t of
      // row g, a1 = row g + 8, a2 = key 2t + 1 of row g, a3 = row g + 8),
      // split into TF32 hi and lo
      uint32_t ph[SUBT][4], pl[SUBT][4];
#pragma unroll
      for (int n = 0; n < SUBT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          psum[e >> 1] += p;
          const int ai = (e >> 1) | ((e & 1) << 1);  // c0..c3: a0 a2 a1 a3
          mma::split_tf32(p, ph[n][ai], pl[n][ai]);
        }
      l[0] = alpha[0] * l[0] + psum[0];
      l[1] = alpha[1] * l[1] + psum[1];
      // ---- pv = P v over the sub-tile's keys, from zero, JB head-dim
      // tiles at a time (JB independent accumulators); acc = acc a + pv
#pragma unroll
      for (int j0 = 0; j0 < ND; j0 += JB) {
        if (!EXACT && j0 >= nd) break;
        float pv[JB][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[jj][e] = 0.f;
        if constexpr (F32) {
          const float* vb = vs + (c0 + 2 * t) * stride + j0 * 8 + g;
#pragma unroll
          for (int n = 0; n < SUBT; ++n) {
            uint32_t vh[JB][2], vl[JB][2];
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              if (!EXACT && j0 + jj >= nd) break;
              const float* vp = vb + n * 8 * stride + jj * 8;
              mma::split_tf32(vp[0], vh[jj][0], vl[jj][0]);
              mma::split_tf32(vp[stride], vh[jj][1], vl[jj][1]);
            }
#pragma unroll
            for (int jj = 0; jj < JB; ++jj)
              if (EXACT || j0 + jj < nd)
                mma::mma_tf32_1688(pv[jj], pl[n], vh[jj][0], vh[jj][1]);
#pragma unroll
            for (int jj = 0; jj < JB; ++jj)
              if (EXACT || j0 + jj < nd)
                mma::mma_tf32_1688(pv[jj], ph[n], vl[jj][0], vl[jj][1]);
#pragma unroll
            for (int jj = 0; jj < JB; ++jj)
              if (EXACT || j0 + jj < nd)
                mma::mma_tf32_1688(pv[jj], ph[n], vh[jj][0], vh[jj][1]);
          }
        } else {
          // ldmatrix.trans matrices (keys 8n..+7, dims 8j..+7) for n, n + 1
          // and j, j + 1: lane (g, t) gets v[2t][g] (low half) and
          // v[2t+1][g], exact as TF32 once shifted into the high half
          const T* vb = vs +
                        (c0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                        (lane >> 4) * 8 + j0 * 8;
#pragma unroll
          for (int n = 0; n < SUBT; n += 2) {
            uint32_t vr[JB / 2][4];
#pragma unroll
            for (int jp = 0; jp < JB / 2; ++jp)
              if (EXACT || j0 + 2 * jp < nd)
                mma::ldmatrix_x4_trans(vr[jp], vb + n * 8 * stride + jp * 16);
#pragma unroll
            for (int u = 0; u < 2; ++u) {  // key tile n + u
#pragma unroll
              for (int jj = 0; jj < JB; ++jj)
                if (EXACT || j0 + jj < nd) {
                  const uint32_t r = vr[jj >> 1][u + 2 * (jj & 1)];
                  mma::mma_tf32_1688(pv[jj], pl[n + u], r << 16,
                                     r & 0xffff0000u);
                }
#pragma unroll
              for (int jj = 0; jj < JB; ++jj)
                if (EXACT || j0 + jj < nd) {
                  const uint32_t r = vr[jj >> 1][u + 2 * (jj & 1)];
                  mma::mma_tf32_1688(pv[jj], ph[n + u], r << 16,
                                     r & 0xffff0000u);
                }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
          if (EXACT || j0 + jj < nd)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j0 + jj][e] = acc[j0 + jj][e] * alpha[e >> 1] + pv[jj][e];
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row sums, over the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* og = static_cast<T*>(a.out) + ((size_t)h * a.pq + (size_t)iq * a.bq) * pd;
  const int r0 = rq * FA_FRAG + g;
  if (a.wk == 1) {
    const float l0 = l[0] == 0.f ? 1.f : l[0];  // rows with no live block
    const float l1 = l[1] == 0.f ? 1.f : l[1];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (!EXACT && j >= nd) break;
      store2(og + r0 * pd + j * 8 + 2 * t, acc[j][0] / l0, acc[j][1] / l0);
      store2(og + (r0 + 8) * pd + j * 8 + 2 * t, acc[j][2] / l1,
             acc[j][3] / l1);
    }
    return;
  }

  // Split columns: the partial states meet in the ring, combined in kq
  // order. part: (wk, bq) rows of pd + 4 floats; then m (wk, bq), l (wk,
  // bq); the combine writes each row's weights over m and its l over l[0].
  __syncthreads();  // every warp is done with the ring
  const int pstride = pd + 4;
  float* part = reinterpret_cast<float*>(ring);
  float* pm = part + (size_t)a.wk * a.bq * pstride;
  float* pl_ = pm + a.wk * a.bq;
  float* prow = part + (size_t)(kq * a.bq + r0) * pstride;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (!EXACT && j >= nd) break;
    store2(prow + j * 8 + 2 * t, acc[j][0], acc[j][1]);
    store2(prow + 8 * pstride + j * 8 + 2 * t, acc[j][2], acc[j][3]);
  }
  if (t == 0) {
    pm[kq * a.bq + r0] = m[0];
    pm[kq * a.bq + r0 + 8] = m[1];
    pl_[kq * a.bq + r0] = l[0];
    pl_[kq * a.bq + r0 + 8] = l[1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < a.bq; r += blockDim.x) {
    float mm = NEG_INF;
    for (int q = 0; q < a.wk; ++q) mm = fmaxf(mm, pm[q * a.bq + r]);
    float ll = 0.f;
    for (int q = 0; q < a.wk; ++q) {
      const float w = expf(pm[q * a.bq + r] - mm);
      ll += w * pl_[q * a.bq + r];
      pm[q * a.bq + r] = w;
    }
    pl_[r] = ll == 0.f ? 1.f : ll;
  }
  __syncthreads();
  for (int r = warp; r < a.bq; r += blockDim.x >> 5) {
    const float ll = pl_[r];
    for (int d = lane; d < pd; d += 32) {
      float o = 0.f;
      for (int q = 0; q < a.wk; ++q)
        o += pm[q * a.bq + r] * part[(size_t)(q * a.bq + r) * pstride + d];
      store1(og + r * pd + d, o / ll);
    }
  }
}

template <typename T, int DC, int SUBT, bool EXACT>
int fa_run(const FaArgs& a, const FaPlan& p, unsigned blocks,
           cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(a.bq, a.bkv, a.pd, sizeof(T));
  const cudaError_t err =
      tile::prepare_launch(fa_tc_kernel<T, DC, SUBT, EXACT>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_tc_kernel<T, DC, SUBT, EXACT><<<blocks, p.warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instantiation for the plan: the head dim's class, exact at 64; the
// sub-tile width.
template <typename T, int DC, bool EXACT>
int fa_dispatch_sub(const FaArgs& a, const FaPlan& p, unsigned blocks,
                    cudaStream_t stream) {
  if constexpr (DC != 256) {
    if (p.sub == 64) return fa_run<T, DC, 8, EXACT>(a, p, blocks, stream);
  }
  if (p.sub == 32) return fa_run<T, DC, 4, EXACT>(a, p, blocks, stream);
  return fa_run<T, DC, 2, EXACT>(a, p, blocks, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int group, int pq, int pkv, int pd, int bq, int bkv, int kv_len,
           int q_len, int d_real, int causal, cudaStream_t stream) {
  if (BH < 1 || group < 1 || BH % group || pd < FA_FRAG || pd > FA_MAX_PD ||
      pd % FA_FRAG || bq < FA_FRAG || bq > FA_MAX_BQ || bq % FA_FRAG ||
      bkv < FA_FRAG || bkv % FA_FRAG || pq < 1 || pkv < 1 || pq % bq ||
      pkv % bkv || q_len < 1 || q_len > pq || kv_len < 1 || kv_len > pkv ||
      d_real < 1 || d_real > pd ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)BH * (pq / bq);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const FaPlan p = fa_plan(bq, bkv, pd);
  FaArgs a{q, k, v, out, group, pq, pkv, pd, bq, bkv, kv_len,
           kv_len - q_len, causal, p.wk, p.cols,
           (float)(1.0 / std::sqrt((double)d_real))};
  const unsigned nb = (unsigned)blocks;
  if (p.dclass == 64)
    return pd == 64 ? fa_dispatch_sub<T, 64, true>(a, p, nb, stream)
                    : fa_dispatch_sub<T, 64, false>(a, p, nb, stream);
  if (p.dclass == 128)
    return fa_dispatch_sub<T, 128, false>(a, p, nb, stream);
  return fa_dispatch_sub<T, 256, false>(a, p, nb, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out are (BH, pq, pd), k and v
// (BH / group, pkv, pd), row-major and contiguous, zero-padded, 16-byte
// aligned; pq and pkv multiples of bq and bkv; bq, bkv and pd multiples of
// 16, bq <= 128, pd <= 256. kv_len, q_len and d_real are the unpadded
// extents. causal: 0 or 1. Returns a cudaError_t.
extern "C" int fa_launch(int dtype, const void* q, const void* k,
                         const void* v, void* out, int BH, int group, int pq,
                         int pkv, int pd, int bq, int bkv, int kv_len,
                         int q_len, int d_real, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, BH, group, pq, pkv, pd, bq, bkv,
                           kv_len, q_len, d_real, causal, s);
    case 1:
      return launch<bf16>(q, k, v, out, BH, group, pq, pkv, pd, bq, bkv,
                          kv_len, q_len, d_real, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
