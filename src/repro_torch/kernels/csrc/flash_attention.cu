// Blockwise (flash) attention for Hopper (sm_90a): online softmax with f32
// running state, grouped-query heads, bottom-right-aligned causal masking.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:_fa_kernel. Operands
// are q (BH, pq, pd) and k, v (BH / group, pkv, pd), row-major and zero-padded
// to the block; q head h reads KV head h / group, as the Pallas index maps.
//
// One block owns one (head, q block) pair: block index t covers head
// t / (pq / bq) and q block t % (pq / bq). The Pallas grid's KV axis is a
// sequential reduction (the online softmax carries m, l and acc from one KV
// step to the next), so it becomes a loop inside the block, in order
// jk = 0, 1, ...; no split of the KV axis across blocks, which would change
// the sum order. A KV block is skipped exactly when the Pallas predicate
// says it is dead (kernel.py:40). That predicate is monotone in jk, so the
// loop stops at the first dead block. Skipping is not the same as masking:
// a row with no visible key at all (causal, q_len > kv_len) takes
// p = exp(NEG_INF - NEG_INF) = 1 on every column of every live block, the
// padded tail included, and its output is the mean of those v rows.
//
// Per block, in dynamic shared memory:
//   qs   (bq, pd)        the q tile, staged once, input dtype
//   kt   (pd, bkv + 1)   the k tile of the current step, transposed, padded
//                        by one column so that both the staging writes and
//                        the score reads are free of bank conflicts
//   vs   (bkv, pd)       the v tile of the current step
//   s    (bq, bkv) f32   the scores, then the probabilities p
//   acc  (bq, pd)  f32   the unnormalised output
//   m, l (bq)      f32   the running max and sum
// The float region starts 16-byte aligned. kernels/flash_attention/ops.py:
// smem_bytes mirrors fa_smem_bytes below exactly.
//
// 256 threads, 8 warps. Warp w owns rows w, w + 8, ...: it computes their
// scores (lanes across KV columns, four columns per lane at a time so that
// one broadcast q read serves four products), reduces max and sum across
// the warp, and updates their acc row (lanes across head-dim columns). So a
// row's state is touched by one warp only; the block synchronises only
// around the staging of each k and v tile.
//
// What bounds it on this card: operations, at the shapes of the main path.
// MobileLLM-125M's prefill attention at its max_seq_len 2048 (9 heads, head
// dim 64, causal, f32) does 4.8 GFLOP on its live block pairs, 72 us at the
// 67 TFLOP/s f32 CUDA-core rate, against 3.8 us to move its 12.6 MB. What
// the design does about it: every product runs in f32 on the CUDA cores
// from shared memory, each q, k and v element is read from device memory
// once per (head, q block) and the output written once. Tensor cores
// (mma/wgmma on a bf16 or tf32 copy), register-held accumulators and
// double-buffered tile loads are later work.
//
// Numerics: expf (not __expf), IEEE division, NEG_INF = -1e30 as a float so
// that exp(NEG_INF - NEG_INF) = 1 as in the reference; the scale is
// 1/sqrt(d_real) rounded once to float, as JAX rounds the Python float.
// Padded head-dim columns are zeros and add nothing to a score. Built
// without --use_fast_math.
#include <cmath>

#include "tile.cuh"

namespace {

using tile::to_f32;

constexpr int FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int COLS_PER_LANE = 4;
constexpr float NEG_INF = -1e30f;

__device__ inline float from_f32(float v, float*) { return v; }
__device__ inline __nv_bfloat16 from_f32(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__host__ __device__ inline size_t fa_tile_bytes(int bq, int bkv, int pd) {
  const size_t b = ((size_t)bq * pd + (size_t)pd * (bkv + 1) +
                    (size_t)bkv * pd) * sizeof(T);
  return (b + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline size_t fa_smem_bytes(int bq, int bkv, int pd) {
  return fa_tile_bytes<T>(bq, bkv, pd) +
         ((size_t)bq * bkv + (size_t)bq * pd + 2 * (size_t)bq) * sizeof(float);
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int group,
              int pq, int pkv, int pd, int bq, int bkv, int kv_len,
              int offset, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kt = qs + (size_t)bq * pd;
  T* vs = kt + (size_t)pd * (bkv + 1);
  float* s = reinterpret_cast<float*>(smem + fa_tile_bytes<T>(bq, bkv, pd));
  float* acc = s + (size_t)bq * bkv;
  float* m = acc + (size_t)bq * pd;
  float* l = m + bq;

  const int gq = pq / bq;
  const int h = blockIdx.x / gq, iq = blockIdx.x % gq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kts = bkv + 1;
  const T* qh = q + ((size_t)h * pq + (size_t)iq * bq) * pd;
  const T* kh = k + (size_t)(h / group) * pkv * pd;
  const T* vh = v + (size_t)(h / group) * pkv * pd;

  for (int e = threadIdx.x; e < bq * pd; e += FA_THREADS) {
    qs[e] = qh[e];
    acc[e] = 0.0f;
  }
  for (int r = threadIdx.x; r < bq; r += FA_THREADS) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
  }
  __syncthreads();  // the state is read below by the warp that owns the row

  const int kv_steps = pkv / bkv;
  const int q_last = iq * bq + bq - 1 + offset;  // last row's position
  for (int jk = 0; jk < kv_steps; ++jk) {
    if (causal && jk * bkv > q_last) break;  // dead, and so is every later one
    const T* kb = kh + (size_t)jk * bkv * pd;
    const T* vb = vh + (size_t)jk * bkv * pd;
    __syncthreads();  // the previous step's readers are done with kt and vs
    for (int e = threadIdx.x; e < bkv * pd; e += FA_THREADS) {
      const int c = e / pd, d = e - c * pd;
      kt[d * kts + c] = kb[e];
      vs[e] = vb[e];
    }
    __syncthreads();

    for (int r = warp; r < bq; r += FA_WARPS) {
      const int row = iq * bq + offset + r;  // the query's key position
      float* sr = s + (size_t)r * bkv;
      float mx = NEG_INF;
      for (int c0 = 0; c0 < bkv; c0 += 32 * COLS_PER_LANE) {
        float dot[COLS_PER_LANE] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < pd; ++d) {
          const float qv = to_f32(qs[r * pd + d]);
          const T* kd = kt + d * kts + c0 + lane;
#pragma unroll
          for (int j = 0; j < COLS_PER_LANE; ++j)
            if (c0 + lane + 32 * j < bkv)
              dot[j] = fmaf(qv, to_f32(kd[32 * j]), dot[j]);
        }
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c >= bkv) continue;
          const int col = jk * bkv + c;
          const bool keep = col < kv_len && (!causal || col <= row);
          const float sv = keep ? dot[j] * scale : NEG_INF;
          sr[c] = sv;
          mx = fmaxf(mx, sv);
        }
      }
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.0f;
      for (int c = lane; c < bkv; c += 32) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();  // every lane's p is in sr
      for (int d = lane; d < pd; d += 32) {
        float pv = 0.0f;
        for (int c = 0; c < bkv; ++c)
          pv = fmaf(sr[c], to_f32(vs[c * pd + d]), pv);
        acc[r * pd + d] = acc[r * pd + d] * alpha + pv;
      }
      __syncwarp();  // every lane has read m[r] and sr before they change
      if (lane == 0) {
        m[r] = m_new;
        l[r] = alpha * l[r] + psum;
      }
      __syncwarp();
    }
  }

  T* oh = out + ((size_t)h * pq + (size_t)iq * bq) * pd;
  for (int r = warp; r < bq; r += FA_WARPS) {
    const float lr = l[r] == 0.0f ? 1.0f : l[r];  // rows with no live block
    for (int d = lane; d < pd; d += 32)
      oh[r * pd + d] = from_f32(acc[r * pd + d] / lr, (T*)nullptr);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int group, int pq, int pkv, int pd, int bq, int bkv, int kv_len,
           int q_len, int d_real, int causal, cudaStream_t stream) {
  if (BH < 1 || group < 1 || BH % group || pd < 1 || bq < 1 || bkv < 1 ||
      pq % bq || pkv % bkv || pq < 1 || pkv < 1 || q_len < 1 ||
      q_len > pq || kv_len < 1 || kv_len > pkv || d_real < 1 || d_real > pd)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)BH * (pq / bq);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = fa_smem_bytes<T>(bq, bkv, pd);
  const cudaError_t err = tile::prepare_launch(fa_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / std::sqrt((double)d_real));
  fa_kernel<T><<<(unsigned)blocks, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), group, pq, pkv, pd, bq,
      bkv, kv_len, kv_len - q_len, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out are (BH, pq, pd), k and v
// (BH / group, pkv, pd), row-major and contiguous, zero-padded; pq and pkv
// multiples of bq and bkv. kv_len, q_len and d_real are the unpadded
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
      return launch<__nv_bfloat16>(q, k, v, out, BH, group, pq, pkv, pd, bq,
                                   bkv, kv_len, q_len, d_real, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
