// The MoE layer of a decode step for Hopper (sm_90a): routing, the chosen
// experts' SwiGLU and the gated shared expert of a few rows, in four
// launches.
//
// Replaces no TPU kernel. The JAX package computes its MoE layer with
// einsums that XLA fuses (src/repro/models/moe.py); the port's dropless path
// (models/moe.py: _dropless_experts, then the shared expert's L.mlp) is
// about thirty library and elementwise launches a layer, each a few
// microseconds on a decode step's few rows. This computes the same layer
// for at most MAX_ROWS rows, at bf16's precision or better:
//
// - the router's logits x . W_r in f32, rounded to bf16 as the library's bf16
//   product rounds them; the softmax over every expert in f32; the stable
//   top-k (a tie goes to the lower index), its weights the softmax's own or,
//   with norm_topk, the softmax of the k chosen logits; the shared expert's
//   gate sigmoid(x . w_s) of the bf16-rounded dot, in f32;
// - or, in the sigmoid mode (DeepSeek-V3's routing, Moonlight-16B-A3B's):
//   the logits in f32, unrounded, as the published gate computes them in
//   f32; each expert's score sigmoid(logit); the stable top-k of score +
//   bias (the correction bias, where one is given); the weights the chosen
//   experts' unbiased scores, with norm_topk divided by their sum + 1e-20,
//   times the routed scaling factor;
// - each chosen expert's gate and up products in f32, silu(g) * u kept in
//   f32, the down product in f32; the shared expert the same, cut into
//   P parts of F columns (its width is P * F);
// - each row's k routed results times their weights, in the order of its
//   top-k, then its shared result times its gate, summed in f32 and rounded
//   to bf16 once.
//
// What bounds it on this card: bytes. At Qwen1.5-MoE-A2.7B's widths a layer
// of a 4-row step must read ~14 chosen experts of 17.3 MB and the shared
// expert's 69 MB once, ~305 MB, against a few FLOPs a byte. What the design
// does about it:
//
// - Every weight is read as the model holds it ((E, D, F), (E, F, D),
//   (D, P * F), (P * F, D), bf16), 16 bytes a lane along its contiguous
//   dimension, read-only and not allocated in L1 (each byte is read once).
//   A lane issues the loads of CHUNK rows before it uses the first, so a
//   block keeps 32 KB in flight from its registers. A ring of cp.async stages in shared memory, tried in
//   place of the registers, ran 20-30 % slower at 3 to 8 stages.
// - A block computes TILE output columns of one slot (a chosen expert, or a
//   part of the shared expert) for all the slot's rows, so each weight byte
//   is read once a step whatever the number of rows that chose it; an expert
//   no row chose is never read. Slots past the distinct experts chosen exit
//   at once: the grids are fixed by the shapes, so a captured step replays
//   whatever the routing.
// - The routing runs in the first launch beside the shared expert's gate and
//   up products, which do not wait for it; the shared expert's down products
//   run in the second beside the chosen experts' gate and up, and fill that
//   launch's last blocks.
// - Partial sums are combined in a fixed order through shared memory or
//   scratch; no atomics: a launch gives the same bits every time.
//
// Launches: (1) route, one block a row, and the shared expert's gate/up, one
// block a (part, SHARED_TILE columns); (2) the chosen experts' gate/up, one
// block a (slot, TILE columns), then the shared parts' down products, one
// block a (part, TILE columns of D); (3) the chosen experts' down products,
// one block a (slot, TILE columns of D); (4) the combine, one thread an
// output element.
//
// Supported: bf16; rows 1..MAX_ROWS; E <= MAX_EXPERTS; K <= MAX_TOPK; D and F
// multiples of VEC, D <= MAX_WIDTH. Built without --use_fast_math: expf and
// the divisions are IEEE's.
#include <math.h>

#include <algorithm>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The constants below were chosen on an H100 at the decode cell's widths
// against 32- and 128-column tiles, 3 blocks an SM and a 64-column shared
// tile, each slower, and 16-row chunks where a slot has one row, under 1 %
// faster.
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;  // the registers' budget: 128 a lane
constexpr int TILE = 64;          // output columns a block computes
constexpr int SHARED_TILE = 32;   // the same, of the shared gate/up
constexpr int VEC = 8;            // bf16 in one 16-byte load
constexpr int RT = 4;             // token rows a lane sums, in a slot of more
constexpr int CHUNK = VEC;        // reduction rows a lane loads at once
constexpr int UNROLL = 16;        // router vectors a lane loads at once
constexpr int MAX_ROWS = 16;
constexpr int MAX_EXPERTS = 64;
constexpr int MAX_TOPK = 8;
constexpr int MAX_WIDTH = 8192;
// partial sums of a block: (THREADS / (CL * M * RG)) reduction groups x M
// matrices x RG * RT rows x TL columns (CL = TL / VEC), at most this
constexpr int RED_FLOATS = THREADS * RT * VEC;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const bf16* x;       // (N, D)
  const bf16* router;  // (D, E)
  const bf16* score;   // (D): the shared expert's gate; null: weight 1
  const bf16* bias;    // (E): the sigmoid mode's correction bias, or null
  const bf16* w_gate;  // (E, D, F)
  const bf16* w_up;    // (E, D, F)
  const bf16* w_down;  // (E, F, D)
  const bf16* s_gate;  // (D, P * F); null where P == 0
  const bf16* s_up;    // (D, P * F)
  const bf16* s_down;  // (P * F, D)
  bf16* y;             // (N, D)
  float* logits;       // (N, E)
  float* gates;        // (N, K)
  float* sg;           // (N)
  int* sel;            // (N, K)
  int* counts;         // (E)
  // work rows: the N * K assignments by expert, then by row; then the
  // shared parts' rows, N a part
  float* h;            // (N * K + P * N, F)
  float* out;          // (N * K + P * N, D)
  int N, D, F, E, K, P, norm_topk, sigmoid;
  float scale;         // the sigmoid mode's routed scaling factor
};

// The rows a block computes: activation row and destination row of each.
struct Work {
  int n;
  int in_row[MAX_ROWS];
  int out_row[MAX_ROWS];
};

__device__ inline int tiles(int n, int tl = TILE) { return (n + tl - 1) / tl; }

__device__ inline int slots(const Params& p) { return min(p.E, p.N * p.K); }

__device__ inline uint4 load_stream(const void* ptr) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(ptr));
  return r;
}

// Eight bf16, the element at the lower address first, as f32.
__device__ inline void unpack(const uint4& r, float (&f)[VEC]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight consecutive activations as f32: a bf16 token row, or f32 h.
__device__ inline void load_row8(const bf16* ptr, float (&f)[VEC]) {
  unpack(__ldg(reinterpret_cast<const uint4*>(ptr)), f);
}

__device__ inline void load_row8(const float* ptr, float (&f)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(ptr));
  const float4 b = __ldg(reinterpret_cast<const float4*>(ptr) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Sum of x over the block in a fixed order: a butterfly within each warp,
// then the warps' sums in warp order. Every thread gets it.
__device__ inline float block_sum(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(FULL, x, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < THREADS / 32; ++w) r += scratch[w];
  return r;
}

// Row groups of RT rows that lanes of one column and matrix split n rows
// into: 1, 2 or 4, so that the groups divide the block.
__device__ inline int row_groups(int n) {
  return n <= RT ? 1 : n <= 2 * RT ? 2 : 4;
}

// The block's partial sums of out[i][c] = sum_k a[in_row[i]][k] *
// W_m[k][col0 + c] for its rows, M (1 or 2) matrices W_0, W_1 of K rows of
// ld elements, and c < ncols. Lane t: column lane cl (VEC columns), matrix
// m, row group rg (R rows), reduction group g (rows k of its chunks g, g +
// G, ...); its sums go to red[g][m][i][c].
template <typename A, int TL, int R>
__device__ void partials(const A* act, int lda, const Work& wk,
                         const bf16* w0, const bf16* w1, int M, int ld,
                         int K, int col0, int ncols, float* red) {
  constexpr int CL = TL / VEC;
  const int RG = R == 1 ? 1 : row_groups(wk.n);
  const int lanes = CL * M * RG, G = THREADS / lanes, rows = RG * R;
  const int t = threadIdx.x;
  const int cl = t % CL, m = (t / CL) % M, rg = (t / (CL * M)) % RG;
  const int g = t / lanes;
  const bool live = cl * VEC < ncols;
  // a lane past the tile's columns loads the tile's first vector, which its
  // neighbour loads in the same instruction, and keeps nothing
  const bf16* w = (m ? w1 : w0) + col0 + (live ? cl * VEC : 0);
  const A* a[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    a[r] = act + (size_t)wk.in_row[min(rg * R + r, wk.n - 1)] * lda;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[r][c] = 0.f;
  for (int k0 = g * CHUNK; k0 < K; k0 += G * CHUNK) {  // K: CHUNK rows a time
    uint4 wv[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      wv[i] = load_stream(w + (size_t)(k0 + i) * ld);
    float av[R][VEC];  // CHUNK == VEC: one load a row
#pragma unroll
    for (int r = 0; r < R; ++r) load_row8(a[r] + k0, av[r]);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      float wf[VEC];
      unpack(wv[i], wf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[r][c] = fmaf(av[r][i], wf[c], acc[r][c]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = rg * R + r;
    if (i >= wk.n) break;
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      red[((g * M + m) * rows + i) * TL + cl * VEC + c] = acc[r][c];
  }
}

// The block's output columns col0..col0 + TILE (fewer at the edge of
// ncols_total) for its rows: the partial sums summed over the reduction
// groups in order, then silu(g) * u (GATED: W_0 the gate's, W_1 the up's)
// or the sum, written to dst[out_row[i]][col0 + c].
template <typename A, bool GATED, int TL = TILE>
__device__ void product(const A* act, int lda, const Work& wk,
                        const bf16* w0, const bf16* w1, int ld, int K,
                        int col0, int ncols_total, float* dst, int ldd,
                        float* red) {
  constexpr int M = GATED ? 2 : 1, CL = TL / VEC;
  const int ncols = min(TL, ncols_total - col0);
  const int R = wk.n == 1 ? 1 : RT;
  if (R == 1)
    partials<A, TL, 1>(act, lda, wk, w0, w1, M, ld, K, col0, ncols, red);
  else
    partials<A, TL, RT>(act, lda, wk, w0, w1, M, ld, K, col0, ncols, red);
  __syncthreads();
  const int RG = R == 1 ? 1 : row_groups(wk.n);
  const int G = THREADS / (CL * M * RG), rows = RG * R;
  for (int idx = threadIdx.x; idx < wk.n * ncols; idx += THREADS) {
    const int i = idx / ncols, c = idx - i * ncols;
    float s0 = 0.f, s1 = 0.f;
    for (int g = 0; g < G; ++g) {
      s0 += red[((g * M) * rows + i) * TL + c];
      if (GATED) s1 += red[((g * M + 1) * rows + i) * TL + c];
    }
    dst[(size_t)wk.out_row[i] * ldd + col0 + c] =
        GATED ? s0 / (1.f + expf(-s0)) * s1 : s0;
  }
}

// Each row's chosen experts as a bit mask, in shared memory.
__device__ void load_masks(const Params& p, unsigned long long* mask) {
  const int t = threadIdx.x;
  if (t < p.N) {
    unsigned long long m = 0;
    for (int j = 0; j < p.K; ++j) m |= 1ull << p.sel[t * p.K + j];
    mask[t] = m;
  }
  __syncthreads();
}

// Work row of assignment (row r, expert e): the assignments of the experts
// below e, then the rows before r that chose e.
__device__ inline int assignment(const unsigned long long* mask, int n, int r,
                                 int e) {
  const unsigned long long below = (1ull << e) - 1;
  int a = 0;
  for (int q = 0; q < n; ++q)
    a += __popcll(mask[q] & below) + (q < r ? (int)(mask[q] >> e & 1) : 0);
  return a;
}

// Routed slot `slot`: the slot-th smallest expert chosen, and its rows in
// row order (token rows in, work rows out; work rows both where `by_work`).
// False, for every thread, past the distinct experts chosen.
__device__ bool routed_slot(const Params& p, int slot, unsigned long long* mask,
                            Work& wk, bool by_work, int* expert) {
  load_masks(p, mask);
  unsigned long long all = 0;
  for (int r = 0; r < p.N; ++r) all |= mask[r];
  if (slot >= __popcll(all)) return false;
  for (int s = 0; s < slot; ++s) all &= all - 1;
  const int e = __ffsll((long long)all) - 1;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int r = 0; r < p.N; ++r) {
      if (!(mask[r] >> e & 1)) continue;
      const int a = assignment(mask, p.N, r, e);
      wk.in_row[n] = by_work ? a : r;
      wk.out_row[n] = a;
      ++n;
    }
    wk.n = n;
  }
  __syncthreads();
  *expert = e;
  return true;
}

// The shared expert's part `part`: every row, work rows after the
// assignments.
__device__ void shared_part(const Params& p, int part, Work& wk, bool by_work) {
  const int t = threadIdx.x;
  if (t < p.N) {
    const int a = p.N * p.K + part * p.N + t;
    wk.in_row[t] = by_work ? a : t;
    wk.out_row[t] = a;
  }
  if (t == 0) wk.n = p.N;
  __syncthreads();
}

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Warp 0: the stable top-k of row r's logits lg[0..E): chosen on the logits
// and weighted by their softmax, or, in the sigmoid mode, chosen on score +
// bias and weighted by the scores (e0, e1 over a sum of 1).
__device__ void top_k(const Params& p, int r, const float* lg) {
  const int lane = threadIdx.x, E = p.E;
  float v0, v1, e0, e1, sum = 1.f;
  if (p.sigmoid) {
    e0 = lane < E ? sigmoid(lg[lane]) : 0.f;
    e1 = lane + 32 < E ? sigmoid(lg[lane + 32]) : 0.f;
    const float b0 = p.bias && lane < E ? __bfloat162float(p.bias[lane]) : 0.f;
    const float b1 =
        p.bias && lane + 32 < E ? __bfloat162float(p.bias[lane + 32]) : 0.f;
    v0 = lane < E ? e0 + b0 : -INFINITY;
    v1 = lane + 32 < E ? e1 + b1 : -INFINITY;
  } else {
    v0 = lane < E ? lg[lane] : -INFINITY;
    v1 = lane + 32 < E ? lg[lane + 32] : -INFINITY;
    float mx = fmaxf(v0, v1);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    e0 = lane < E ? expf(v0 - mx) : 0.f;
    e1 = lane + 32 < E ? expf(v1 - mx) : 0.f;
    sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(FULL, sum, o);
  }
  bool free0 = lane < E, free1 = lane + 32 < E;
  float top[MAX_TOPK], prob[MAX_TOPK];
  int pick[MAX_TOPK];
#pragma unroll
  for (int j = 0; j < MAX_TOPK; ++j) {
    if (j >= p.K) break;
    // the lane's best free expert, then the warp's: the larger logit, the
    // lower index among equals
    float bv = -INFINITY;
    int bi = -1;
    if (free0) { bv = v0; bi = lane; }
    if (free1 && (bi < 0 || v1 > bv)) { bv = v1; bi = lane + 32; }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (oi >= 0 && (bi < 0 || ov > bv || (ov == bv && oi < bi))) {
        bv = ov;
        bi = oi;
      }
    }
    bi = __shfl_sync(FULL, bi, 0);
    bv = __shfl_sync(FULL, bv, 0);
    if (bi == lane) free0 = false;
    if (bi == lane + 32) free1 = false;
    pick[j] = bi;
    top[j] = bv;
    prob[j] = __shfl_sync(FULL, bi >= 32 ? e1 : e0, bi & 31) / sum;
  }
  if (lane != 0) return;
  float norm = 0.f;
  if (p.sigmoid) {
    if (p.norm_topk) {
#pragma unroll
      for (int j = 0; j < MAX_TOPK; ++j) {
        if (j >= p.K) break;
        norm += prob[j];
      }
      norm += 1e-20f;
    }
#pragma unroll
    for (int j = 0; j < MAX_TOPK; ++j) {
      if (j >= p.K) break;
      p.sel[r * p.K + j] = pick[j];
      p.gates[r * p.K + j] =
          (p.norm_topk ? prob[j] / norm : prob[j]) * p.scale;
    }
    return;
  }
  if (p.norm_topk) {
#pragma unroll
    for (int j = 0; j < MAX_TOPK; ++j) {
      if (j >= p.K) break;
      prob[j] = expf(top[j] - top[0]);
      norm += prob[j];
    }
  }
#pragma unroll
  for (int j = 0; j < MAX_TOPK; ++j) {
    if (j >= p.K) break;
    p.sel[r * p.K + j] = pick[j];
    p.gates[r * p.K + j] = p.norm_topk ? prob[j] / norm : prob[j];
  }
}

// Row r's routing: its logits, top-k and shared-expert gate.
//
// The router (D, E) is read as flat 16-byte vectors: vector j holds elements
// 8j..8j+7. With g8 = gcd(E, 8), vectors j and j + E / g8 hold the same
// experts 8 / g8 rows of d further on, so lane class c = j mod (E / g8)
// always meets the same 8 (row offset, expert) pairs and keeps 8 sums.
__device__ void route(const Params& p, int r, float* smem) {
  const int t = threadIdx.x, E = p.E, D = p.D;
  float* xs = smem;                   // D
  float* part = xs + D;               // VEC * THREADS
  float* lg = part + VEC * THREADS;   // MAX_EXPERTS
  float* scratch = lg + MAX_EXPERTS;  // THREADS / 32
  const bf16* x = p.x + (size_t)r * D;
  for (int d = t * VEC; d < D; d += THREADS * VEC) {
    float f[VEC];
    load_row8(x + d, f);
#pragma unroll
    for (int u = 0; u < VEC; ++u) xs[d + u] = f[u];
  }
  __syncthreads();
  const int g8 = E % 8 == 0 ? 8 : E % 4 == 0 ? 4 : E % 2 == 0 ? 2 : 1;
  const int P = E / g8, Q = 8 / g8, G = THREADS / P;
  const int c = t % P, g = t / P;
  float acc[VEC];
  int off[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    acc[u] = 0.f;
    off[u] = (VEC * c + u) / E;
  }
  if (g < G) {
    const int per = D / Q;  // vectors of a class
    const uint4* w = reinterpret_cast<const uint4*>(p.router) + c;
    for (int m0 = g; m0 < per; m0 += UNROLL * G) {
      // every load issued before the first is used: a vector past the
      // class's end loads its last one again and adds nothing
      uint4 v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        v[k] = load_stream(w + (size_t)min(m0 + k * G, per - 1) * P);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int m = min(m0 + k * G, per - 1);
        const bool in = m0 + k * G < per;
        float f[VEC];
        unpack(v[k], f);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc[u] = fmaf(xs[Q * m + off[u]], in ? f[u] : 0.f, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) part[(c * VEC + u) * G + g] = acc[u];
  }
  float sd = 0.f;
  if (p.score)
    for (int d = t * VEC; d < D; d += THREADS * VEC) {
      float f[VEC];
      load_row8(p.score + d, f);
#pragma unroll
      for (int u = 0; u < VEC; ++u) sd = fmaf(xs[d + u], f[u], sd);
    }
  sd = block_sum(sd, scratch);  // its barriers publish part[] too
  if (t < E) {
    // expert t's elements: flat q * E + t of each period, q < Q
    float s = 0.f;
    for (int q = 0; q < Q; ++q) {
      const int flat = q * E + t;
      for (int gg = 0; gg < G; ++gg) s += part[flat * G + gg];
    }
    lg[t] = p.sigmoid ? s : round_bf16(s);
    p.logits[r * E + t] = lg[t];
  }
  if (t == 0) p.sg[r] = p.score ? 1.f / (1.f + expf(-round_bf16(sd))) : 1.f;
  __syncthreads();
  if (t < 32) top_k(p, r, lg);
}

// (1) Blocks 0..N-1 route a row each; the rest compute the shared expert's
// gate and up products, a (part, F tile) each.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    moe_route_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ Work wk;
  if ((int)blockIdx.x < p.N) {
    route(p, blockIdx.x, smem);
    return;
  }
  const int b = blockIdx.x - p.N, ft = tiles(p.F, SHARED_TILE);
  const int part = b / ft, tile = b - part * ft;
  shared_part(p, part, wk, false);
  product<bf16, true, SHARED_TILE>(
      p.x, p.D, wk, p.s_gate + (size_t)part * p.F,
      p.s_up + (size_t)part * p.F, p.P * p.F, p.D, tile * SHARED_TILE, p.F,
      p.h, p.F, smem);
}

// (2) The chosen experts' gate and up products, a (slot, F tile) a block;
// block 0 also writes the experts' row counts. The blocks after them
// compute the shared parts' down products, a (part, D tile) each, which need
// only launch (1)'s results.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    moe_up_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ Work wk;
  __shared__ unsigned long long mask[MAX_ROWS];
  const int ft = tiles(p.F), routed = slots(p);
  if ((int)blockIdx.x >= routed * ft) {
    const int b = blockIdx.x - routed * ft, dt = tiles(p.D, TILE);
    const int part = b / dt, tile = b - part * dt;
    shared_part(p, part, wk, true);
    product<float, false, TILE>(
        p.h, p.F, wk, p.s_down + (size_t)part * p.F * p.D, nullptr, p.D,
        p.F, tile * TILE, p.D, p.out, p.D, smem);
    return;
  }
  const int slot = blockIdx.x / ft, tile = blockIdx.x - slot * ft;
  int e;
  if (!routed_slot(p, slot, mask, wk, false, &e)) return;
  if (blockIdx.x == 0)
    for (int x = threadIdx.x; x < p.E; x += THREADS) {
      int n = 0;
      for (int r = 0; r < p.N; ++r) n += (int)(mask[r] >> x & 1);
      p.counts[x] = n;
    }
  const size_t off = (size_t)e * p.D * p.F;
  product<bf16, true>(p.x, p.D, wk, p.w_gate + off, p.w_up + off, p.F, p.D,
                      tile * TILE, p.F, p.h, p.F, smem);
}

// (3) The chosen experts' down products, a (slot, D tile) a block.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    moe_down_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ Work wk;
  __shared__ unsigned long long mask[MAX_ROWS];
  const int dt = tiles(p.D, TILE);
  const int slot = blockIdx.x / dt, tile = blockIdx.x - slot * dt;
  int e;
  if (!routed_slot(p, slot, mask, wk, true, &e)) return;
  product<float, false, TILE>(
      p.h, p.F, wk, p.w_down + (size_t)e * p.F * p.D, nullptr, p.D, p.F,
      tile * TILE, p.D, p.out, p.D, smem);
}

// (4) y[r][d]: row r's routed results times their weights in top-k order,
// then its shared parts' sum times its gate, in f32, rounded to bf16.
__global__ void __launch_bounds__(THREADS) moe_combine_kernel(const Params p) {
  __shared__ unsigned long long mask[MAX_ROWS];
  __shared__ int arow[MAX_ROWS * MAX_TOPK];  // each assignment's work row
  load_masks(p, mask);
  const int t = threadIdx.x;
  if (t < p.N * p.K) arow[t] = assignment(mask, p.N, t / p.K, p.sel[t]);
  __syncthreads();
  const int idx = blockIdx.x * THREADS + t;
  if (idx >= p.N * p.D) return;
  const int r = idx / p.D, d = idx - r * p.D;
  float acc = 0.f;
  for (int j = 0; j < p.K; ++j)
    acc = fmaf(p.gates[r * p.K + j],
               p.out[(size_t)arow[r * p.K + j] * p.D + d], acc);
  if (p.P) {
    float s = 0.f;
    for (int part = 0; part < p.P; ++part)
      s += p.out[(size_t)(p.N * p.K + part * p.N + r) * p.D + d];
    acc = fmaf(p.sg[r], s, acc);
  }
  p.y[idx] = __float2bfloat16_rn(acc);
}

}  // namespace

// All bf16, contiguous, starting on 16 bytes: x (N, D); router (D, E);
// score (D) or null; bias (E) or null (read in the sigmoid mode only);
// w_gate, w_up (E, D, F); w_down (E, F, D); s_gate, s_up (D, P * F) and
// s_down (P * F, D), null where P == 0; y (N, D). Scratch,
// f32: logits (N, E), gates (N, K), sg (N), h (N * K + P * N, F), out (N * K
// + P * N, D); int32: sel (N, K), counts (E). sigmoid: 0 the softmax
// routing, 1 the sigmoid one, whose weights are scaled by `scale`. Returns a
// cudaError_t.
extern "C" int moe_decode_launch(
    const void* x, const void* router, const void* score, const void* bias,
    const void* w_gate, const void* w_up, const void* w_down,
    const void* s_gate, const void* s_up, const void* s_down, void* y,
    void* logits, void* gates, void* sg, void* sel, void* counts, void* h,
    void* out, int N, int D, int F, int E, int K, int P, int norm_topk,
    int sigmoid, float scale, void* stream) {
  if (N < 1 || N > MAX_ROWS || E < 1 || E > MAX_EXPERTS || K < 1 ||
      K > MAX_TOPK || K > E || D < VEC || D % VEC || D > MAX_WIDTH ||
      F < VEC || F % VEC || P < 0 || (P > 0 && !(s_gate && s_up && s_down)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.router = static_cast<const bf16*>(router);
  p.score = static_cast<const bf16*>(score);
  p.bias = static_cast<const bf16*>(bias);
  p.w_gate = static_cast<const bf16*>(w_gate);
  p.w_up = static_cast<const bf16*>(w_up);
  p.w_down = static_cast<const bf16*>(w_down);
  p.s_gate = static_cast<const bf16*>(s_gate);
  p.s_up = static_cast<const bf16*>(s_up);
  p.s_down = static_cast<const bf16*>(s_down);
  p.y = static_cast<bf16*>(y);
  p.logits = static_cast<float*>(logits);
  p.gates = static_cast<float*>(gates);
  p.sg = static_cast<float*>(sg);
  p.sel = static_cast<int*>(sel);
  p.counts = static_cast<int*>(counts);
  p.h = static_cast<float*>(h);
  p.out = static_cast<float*>(out);
  p.N = N;
  p.D = D;
  p.F = F;
  p.E = E;
  p.K = K;
  p.P = P;
  p.norm_topk = norm_topk;
  p.sigmoid = sigmoid;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ft = (F + TILE - 1) / TILE;
  const int dt = (D + TILE - 1) / TILE;
  const int sft = (F + SHARED_TILE - 1) / SHARED_TILE;
  const int routed = std::min(E, N * K);
  const size_t red = sizeof(float) * RED_FLOATS;
  const size_t route_smem = std::max(
      red, sizeof(float) * (D + VEC * THREADS + MAX_EXPERTS + THREADS / 32));
  cudaError_t err = tile::prepare_launch(moe_route_kernel, route_smem);
  if (err != cudaSuccess) return (int)err;
  moe_route_kernel<<<N + P * sft, THREADS, route_smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  moe_up_kernel<<<routed * ft + P * dt, THREADS, red, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  moe_down_kernel<<<routed * dt, THREADS, red, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  moe_combine_kernel<<<(N * D + THREADS - 1) / THREADS, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
