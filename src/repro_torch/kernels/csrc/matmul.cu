// Tiled matmul for Hopper (sm_90a): out = x @ w, f32 or int32 accumulation.
//
// Replaces the two Pallas kernels of src/repro/kernels/matmul/kernel.py:
//   _acc_kernel   -> matmul_tc_kernel<..., true> (bf16),
//                    matmul_3xtf32_kernel<..., true> (f32), matmul_acc_kernel
//                    (int8): K innermost; the accumulator is carried across
//                    the K steps in registers and the output tile is stored
//                    once (the paper's Algorithm 1).
//   _noacc_kernel -> the same kernels with false, matmul_noacc_kernel
//                    (int8): the store-heavy schedule; the output tile is
//                    read, added to and written back in device memory after
//                    every K step.
//
// What bounds it on this card: at the tuned workloads (m = 64 token rows,
// k = 576 or 1536; MobileNetV2's and DCGAN's im2col convolutions) the
// products are small. Read once, their operands take 0.7-14 us at 3.35
// TB/s, and their operations at the tensor-core peaks less than that, so
// the bound is bytes (f32 at the CUDA cores' 67 TFLOP/s would be
// operations). But one block's output tile needs K / bk dependent steps,
// each a round trip to device memory, and the grids are small (24 blocks on
// 132 SMs for W3 at 64 x 64): the time is the latency of one block's chain
// of k steps, not a rate.
//
// bf16, on the tensor cores. What the design does about that latency:
// - each k step's x (bm, bk) and w (bk, bn) tiles are copied with 16-byte
//   cp.async.cg into a fixed two-stage ring in dynamic shared memory; step
//   k+1's copies are issued before step k's product, so the next tile's
//   load overlaps the current product, with one barrier per step;
// - each warp multiplies with mma.sync m16n8k16 (bf16 in, f32 sum in
//   registers), its A fragments loaded by ldmatrix from the x tile and its
//   B fragments by ldmatrix.trans from the row-major (k, n) w tile; shared
//   rows are padded by 8 bf16 values (16 bytes), so the eight rows of one
//   ldmatrix matrix fall in eight different 16-byte bank groups.
// Warp layout: the (bm, bn) tile is cut into 16x16 fragments, fm = bm/16 by
// fn = bn/16, and each warp owns a WMF x WNF block of them (a 32x32,
// 16x32, 32x16 or 16x16 warp tile, the largest of 2 x 2 that divides the
// fragment grid, so any multiple of 16 works: bn = 48, bm = 80). With
// bm * bn <= 16384 that is at most 32 warps, except for a grid odd in both
// dims of more than 32 fragments (80 x 112, say), where each warp takes two
// 16x16 tiles (REP = 2). The stage count is fixed, not adapted to the tile,
// so the shared-memory footprint, 2 * (bm * (bk + 8) + bk * (bn + 8)) * 2
// bytes, is nondecreasing in each block dim (the design space's static
// analyzer relies on it); kernels/matmul/ops.py mirrors it and the launch
// limits exactly. Later work: wgmma and TMA for 64-row warpgroup tiles.
//
// f32, on the tensor cores as 3xTF32, in the same fragments, warp tiles and
// stores (matmul_3xtf32_kernel):
// - each operand value v is split into hi = tf32_rna(v) and lo =
//   tf32_rna(v - hi), and a warp issues three mma.sync m16n8k8 TF32
//   products into one f32 accumulator, small terms first: lo*hi, hi*lo,
//   hi*hi. The dropped lo*lo term and lo's own rounding are about 2^-22 of
//   a product, near f32 rounding, so the 1e-4 / 1e-3 tolerance against the
//   JAX package holds where one TF32 pass (2^-11) would not. Each stage's
//   products are summed on the tensor cores from zero and then added to
//   the register accumulator with f32 adds (f32_warp_product);
// - a three-stage ring (F32_STAGES) of 16-byte cp.async copies, one
//   barrier per step;
// - A fragments by ldmatrix: an 8x8 b16 matrix is 8 rows of four f32, and
//   lane (g, t) receives element (g, t), the TF32 A layout; x rows are
//   padded by 4 floats (16 bytes), as the bf16 ones are;
// - B fragments by 32-bit shared loads at (k = t, n = g) (ldmatrix .trans
//   moves 16-bit elements only); w rows are padded by 8 floats, a stride of
//   8 or 24 mod 32 words, so a warp's 32 loads hit 32 banks;
// - a block keeps at least F32_MIN_WARPS warps where its tile allows (at
//   W3's (16, 64, 64) the bf16 rule would give two): a warp tile doubles in
//   a dim only while four warps remain (qmatmul.cu's rule). A block of warp
//   tiles larger than 16x16 has at most 16 warps (F32_MAX_WIDE_WARPS; a
//   1 x 2 or 2 x 1 layout that would need more takes 16x16 tiles), so each
//   of its threads may hold 128 registers: at 64 the 2 x 1 layout spilled;
// - _acc_kernel on fewer tiles than SMs splits K over a cluster of C
//   blocks, each taking a contiguous share of the k steps: C doubles while
//   C < F32_MAX_CLUSTER, the grid (tiles * 2C) stays within F32_FILL_CTAS
//   and each block keeps F32_MIN_STEPS k steps (qmatmul.cu's rule). The
//   partial tiles meet in distributed shared memory, where rank r adds n8
//   groups r, r + C, ... over the blocks in rank order: the sum order is
//   fixed from run to run. _noacc_kernel is never split.
// Shared memory: max(F32_STAGES * (bm * (bk + 4) + bk * (bn + 8)) * 4,
// bm * bn * 4) bytes, the ring or, after it, the cluster's partial tile;
// nondecreasing in each block dim (kernels/matmul/ops.py: smem_bytes, and
// plan mirrors f32_plan).
//
// int8 stays on the CUDA cores (tile.cuh: a 4x4 register micro-tile per
// thread, __dp4a); the int8 networks run qmatmul.cu, no path runs it.
//
// The Pallas grid runs in order; thread blocks do not. The noacc kernels
// therefore keep one block per output tile and run their K loop inside the
// block, each thread re-reading and re-writing only the output elements it
// owns, so no two blocks touch one element and the sum runs over k in the
// order of the Pallas grid. The first K step writes without adding (the
// buffer comes from torch.empty). No split-K atomics: they would change the
// sum order from run to run.
#include <cooperative_groups.h>

#include "mma.cuh"
#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tile;

// ---- int8 on the CUDA cores (tile.cuh) ------------------------------------

__global__ void __launch_bounds__(MAX_THREADS)
    matmul_acc_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int* __restrict__ out,
                      int M, int N, int K, int bm, int bn, int bk,
                      int n_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(bm, bn);
  int m0, n0;
  tile_origin(M, N, bm, bn, n_major, &m0, &n0);
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < K; k0 += bk)
    k_step(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx + j * L.TX] =
          acc[i][j];
}

__global__ void __launch_bounds__(MAX_THREADS)
    matmul_noacc_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w, int* __restrict__ out,
                        int M, int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(bm, bn);
  int m0, n0;
  // the Pallas grid (gk, gm, gn) walks n fastest within each k step
  tile_origin(M, N, bm, bn, /*n_major=*/0, &m0, &n0);
  for (int k0 = 0; k0 < K; k0 += bk) {
    int part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0;
    k_step(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, part);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        int* o = out + (size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx +
                 j * L.TX;
        *o = (k0 == 0) ? part[i][j] : *o + part[i][j];
      }
  }
}

int int8_launch(bool accumulate, const void* x, const void* w, void* out,
                int M, int N, int K, int bm, int bn, int bk, int n_major,
                cudaStream_t stream) {
  if (!shape_ok(M, N, K, bm, bn, bk)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bm, bn, bk);
  const dim3 grid((M / bm) * (N / bn)), block((bm / TM) * (bn / TN));
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int* op = static_cast<int*>(out);
  cudaError_t err;
  if (accumulate) {
    err = prepare_launch(matmul_acc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_acc_kernel<<<grid, block, smem, stream>>>(xp, wp, op, M, N, K, bm,
                                                     bn, bk, n_major);
  } else {
    err = prepare_launch(matmul_noacc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_noacc_kernel<<<grid, block, smem, stream>>>(xp, wp, op, M, N, K,
                                                       bm, bn, bk);
  }
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ---------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int FRAG = 16;    // fragment edge: one mma m16 x (two n8) x k16
constexpr int PAD = 8;      // bf16 values of padding per shared row
constexpr int STAGES = 2;   // the cp.async ring

__host__ __device__ inline size_t tc_stage_bytes(int bm, int bn, int bk) {
  return ((size_t)bm * (bk + PAD) + (size_t)bk * (bn + PAD)) * sizeof(bf16);
}

__host__ __device__ inline size_t tc_smem_bytes(int bm, int bn, int bk) {
  return STAGES * tc_stage_bytes(bm, bn, bk);
}

inline bool tc_shape_ok(int M, int N, int K, int bm, int bn, int bk) {
  return bm > 0 && bn > 0 && bk > 0 && bm % FRAG == 0 && bn % FRAG == 0 &&
         bk % FRAG == 0 && M % bm == 0 && N % bn == 0 && K % bk == 0 &&
         (long long)bm * bn <= TM * TN * MAX_THREADS;
}

using mma::ChunkWalk;

// Issue (and commit as one group) the cp.async copies of the k step at k0:
// x rows [m0, m0+bm) x cols [k0, k0+bk) into xs, w rows [k0, k0+bk) x cols
// [n0, n0+bn) into ws, 16 bytes (8 bf16 or 4 f32 values) per copy.
template <typename T>
__device__ inline void tc_load_stage(const T* __restrict__ x,
                                     const T* __restrict__ w, T* xs, T* ws,
                                     int N, int K, int m0, int n0, int k0,
                                     int bm, int bk, const ChunkWalk& xwalk,
                                     const ChunkWalk& wwalk, int xstride,
                                     int wstride) {
  constexpr int V = 16 / sizeof(T);
  for (int r = xwalk.r0, c = xwalk.c0; r < bm; xwalk.next(r, c))
    mma::cp_async16(xs + r * xstride + c * V,
                    x + (size_t)(m0 + r) * K + k0 + c * V);
  for (int r = wwalk.r0, c = wwalk.c0; r < bk; wwalk.next(r, c))
    mma::cp_async16(ws + r * wstride + c * V,
                    w + (size_t)(k0 + r) * N + n0 + c * V);
  mma::cp_async_commit();
}

// acc += the staged x tile's rows [wm0, wm0 + 16*WMF) @ the w tile's
// columns [wn0, wn0 + 16*WNF), over the bk of the stage. acc[i][j][h] is
// the mma accumulator of fragment (i, j)'s n8 half h.
template <int WMF, int WNF>
__device__ inline void tc_warp_product(const bf16* xs, const bf16* ws,
                                       int bn, int bk, int wm0, int wn0,
                                       float (&acc)[WMF][WNF][2][4]) {
  const int lane = threadIdx.x & 31;
  const int xstride = bk + PAD, wstride = bn + PAD;
  // ldmatrix.x4 row addresses. A: matrices (rows 0-7, k 0-7), (rows 8-15,
  // k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) = a0..a3. B (trans):
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) =
  // b0, b1 of the first n8 half, then b0, b1 of the second.
  const bf16* a_ptr = xs + (wm0 + (lane & 15)) * xstride + (lane >> 4) * 8;
  const bf16* b_ptr = ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * wstride +
                      wn0 + (lane >> 4) * 8;
  for (int kk = 0; kk < bk; kk += FRAG) {
    uint32_t a[WMF][4], b[WNF][4];
#pragma unroll
    for (int i = 0; i < WMF; ++i)
      mma::ldmatrix_x4(a[i], a_ptr + i * FRAG * xstride + kk);
#pragma unroll
    for (int j = 0; j < WNF; ++j)
      mma::ldmatrix_x4_trans(b[j], b_ptr + kk * wstride + j * FRAG);
#pragma unroll
    for (int i = 0; i < WMF; ++i)
#pragma unroll
      for (int j = 0; j < WNF; ++j) {
        mma::mma_bf16_16816(acc[i][j][0], a[i], b[j][0], b[j][1]);
        mma::mma_bf16_16816(acc[i][j][1], a[i], b[j][2], b[j][3]);
      }
  }
}

// Write (add == false) or add to (add == true) the warp tile's outputs in
// device memory. A lane holds rows lane/4 and lane/4 + 8 of each n8 half,
// two adjacent columns each (one float2). All reads come before the writes.
template <int WMF, int WNF>
__device__ inline void tc_store(float* __restrict__ out, int N, int row0,
                                int col0, const float (&acc)[WMF][WNF][2][4],
                                bool add) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 2), c = col0 + (lane & 3) * 2;
  float2 v[WMF][WNF][2][2];
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < WNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          v[i][j][h][u] = make_float2(acc[i][j][h][2 * u],
                                      acc[i][j][h][2 * u + 1]);
          if (add) {
            const float2 p = *reinterpret_cast<const float2*>(
                out + (size_t)(r + i * FRAG + u * 8) * N + c + j * FRAG +
                h * 8);
            v[i][j][h][u].x = p.x + v[i][j][h][u].x;
            v[i][j][h][u].y = p.y + v[i][j][h][u].y;
          }
        }
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < WNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          *reinterpret_cast<float2*>(out + (size_t)(r + i * FRAG + u * 8) * N +
                                     c + j * FRAG + h * 8) = v[i][j][h][u];
}

// One block per (bm, bn) output tile; warp w owns warp tiles w and, if
// REP = 2, w + warps (when that exists). ACC: the accumulator is carried
// over the k steps and stored once (_acc_kernel); otherwise each k step's
// product is added to the output in device memory (_noacc_kernel). 2 x 2
// warp tiles need at most 16 warps (64 fragments / 4), the others 32.
template <int WMF, int WNF, int REP, bool ACC>
__global__ void __launch_bounds__(WMF * WNF == 4 ? 512 : 1024)
    matmul_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     float* __restrict__ out, int M, int N, int K, int bm,
                     int bn, int bk, int n_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  int m0, n0;
  // _noacc_kernel's Pallas grid (gk, gm, gn) walks n fastest
  tile_origin(M, N, bm, bn, ACC ? n_major : 0, &m0, &n0);
  const size_t stage = tc_stage_bytes(bm, bn, bk);
  const size_t ws_off = (size_t)bm * (bk + PAD) * sizeof(bf16);

  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int tiles_n = bn / (FRAG * WNF);
  const int tiles = (bm / (FRAG * WMF)) * tiles_n;
  int wm0[REP], wn0[REP];
  bool live[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const int t = warp + r * warps;
    live[r] = t < tiles;   // warp-uniform; always true for r = 0
    wm0[r] = (t / tiles_n) * FRAG * WMF;
    wn0[r] = (t % tiles_n) * FRAG * WNF;
  }
  float acc[REP][WMF][WNF][2][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < WMF; ++i)
#pragma unroll
      for (int j = 0; j < WNF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][i][j][h][e] = 0.f;

  const int steps = K / bk;
  const ChunkWalk xwalk(bk / 8), wwalk(bn / 8);
  tc_load_stage(x, w, reinterpret_cast<bf16*>(smem),
                reinterpret_cast<bf16*>(smem + ws_off), N, K, m0, n0, 0, bm,
                bk, xwalk, wwalk, bk + PAD, bn + PAD);
  for (int s = 0; s < steps; ++s) {
    // Step s's copies have landed for every thread, and every warp is done
    // with step s-1's stage, which the copies of step s+1 now overwrite.
    mma::cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) {
      unsigned char* next = smem + ((s + 1) % STAGES) * stage;
      tc_load_stage(x, w, reinterpret_cast<bf16*>(next),
                    reinterpret_cast<bf16*>(next + ws_off), N, K, m0, n0,
                    (s + 1) * bk, bm, bk, xwalk, wwalk, bk + PAD, bn + PAD);
    }
    const unsigned char* cur = smem + (s % STAGES) * stage;
    const bf16* xs = reinterpret_cast<const bf16*>(cur);
    const bf16* ws = reinterpret_cast<const bf16*>(cur + ws_off);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (!live[r]) continue;
      if (!ACC) {
#pragma unroll
        for (int i = 0; i < WMF; ++i)
#pragma unroll
          for (int j = 0; j < WNF; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[r][i][j][h][e] = 0.f;
      }
      tc_warp_product<WMF, WNF>(xs, ws, bn, bk, wm0[r], wn0[r], acc[r]);
      if (!ACC)
        tc_store<WMF, WNF>(out, N, m0 + wm0[r], n0 + wn0[r], acc[r], s > 0);
    }
  }
  if (ACC) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (live[r])
        tc_store<WMF, WNF>(out, N, m0 + wm0[r], n0 + wn0[r], acc[r], false);
  }
}

template <int WMF, int WNF, int REP, bool ACC>
int tc_run(const bf16* x, const bf16* w, float* out, int M, int N, int K,
           int bm, int bn, int bk, int n_major, cudaStream_t stream) {
  const int tiles = (bm / (FRAG * WMF)) * (bn / (FRAG * WNF));
  const int warps = (tiles + REP - 1) / REP;
  const size_t smem = tc_smem_bytes(bm, bn, bk);
  const cudaError_t err =
      prepare_launch(matmul_tc_kernel<WMF, WNF, REP, ACC>, smem);
  if (err != cudaSuccess) return (int)err;
  matmul_tc_kernel<WMF, WNF, REP, ACC>
      <<<(M / bm) * (N / bn), warps * 32, smem, stream>>>(
          x, w, out, M, N, K, bm, bn, bk, n_major);
  return (int)cudaGetLastError();
}

// The warp layout for a (bm, bn) tile: the largest of 2 x 2 fragments that
// divides the fragment grid, and two 16x16 tiles per warp where a grid odd
// in both dims has more than 32 fragments.
template <bool ACC>
int tc_launch(const void* x, const void* w, void* out, int M, int N, int K,
              int bm, int bn, int bk, int n_major, cudaStream_t stream) {
  if (!tc_shape_ok(M, N, K, bm, bn, bk) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  float* op = static_cast<float*>(out);
  const int fm = bm / FRAG, fn = bn / FRAG;
  if (fm % 2 == 0 && fn % 2 == 0)
    return tc_run<2, 2, 1, ACC>(xp, wp, op, M, N, K, bm, bn, bk, n_major,
                                stream);
  if (fn % 2 == 0)
    return tc_run<1, 2, 1, ACC>(xp, wp, op, M, N, K, bm, bn, bk, n_major,
                                stream);
  if (fm % 2 == 0)
    return tc_run<2, 1, 1, ACC>(xp, wp, op, M, N, K, bm, bn, bk, n_major,
                                stream);
  if (fm * fn <= 32)
    return tc_run<1, 1, 1, ACC>(xp, wp, op, M, N, K, bm, bn, bk, n_major,
                                stream);
  return tc_run<1, 1, 2, ACC>(xp, wp, op, M, N, K, bm, bn, bk, n_major,
                              stream);
}

// ---- f32 on the tensor cores: 3xTF32 --------------------------------------

constexpr int F32_STAGES = 3;       // the cp.async ring
constexpr int F32_X_PAD = 4;        // floats of padding per shared x row
constexpr int F32_W_PAD = 8;        // floats of padding per shared w row
constexpr int F32_MIN_WARPS = 4;
constexpr int F32_MAX_WIDE_WARPS = 16;  // warps of a 2-fragment warp tile
constexpr int F32_MAX_CLUSTER = 8;
constexpr int F32_FILL_CTAS = 132;  // the card's SMs
constexpr int F32_MIN_STEPS = 2;

__host__ __device__ inline size_t f32_stage_bytes(int bm, int bn, int bk) {
  return ((size_t)bm * (bk + F32_X_PAD) + (size_t)bk * (bn + F32_W_PAD)) *
         sizeof(float);
}

__host__ inline size_t f32_smem_bytes(int bm, int bn, int bk) {
  const size_t ring = F32_STAGES * f32_stage_bytes(bm, bn, bk);
  const size_t part = (size_t)bm * bn * sizeof(float);
  return ring > part ? ring : part;
}

// The launch-time layout, computed once on the host.
struct F32Plan {
  int wmf, wnf;  // 16x16 fragments per warp tile: wmf rows x wnf columns
  int rep;       // warp tiles per warp
  int warps;     // warps per block
  int tiles;     // output tiles
  int cluster;   // blocks that split one tile's k steps
};

__host__ inline F32Plan f32_plan(int M, int N, int K, int bm, int bn, int bk,
                                 bool acc, int max_cluster) {
  F32Plan p{};
  const int fm = bm / FRAG, fn = bn / FRAG;
  p.wmf = (fm % 2 == 0 && (fm / 2) * fn >= F32_MIN_WARPS) ? 2 : 1;
  p.wnf = (fn % 2 == 0 && (fm / p.wmf) * (fn / 2) >= F32_MIN_WARPS) ? 2 : 1;
  if (p.wmf * p.wnf == 2 && (fm / p.wmf) * (fn / p.wnf) > F32_MAX_WIDE_WARPS)
    p.wmf = p.wnf = 1;
  const int warp_tiles = (fm / p.wmf) * (fn / p.wnf);
  p.rep = warp_tiles > 32 ? 2 : 1;
  p.warps = (warp_tiles + p.rep - 1) / p.rep;
  p.tiles = (M / bm) * (N / bn);
  const int steps = K / bk;
  int c = 1;
  while (acc && c < max_cluster &&
         (long long)p.tiles * 2 * c <= F32_FILL_CTAS &&
         steps >= 2 * c * F32_MIN_STEPS)
    c *= 2;
  p.cluster = c;
  return p;
}

struct F32Args {
  const float* x;
  const float* w;
  float* out;
  int M, N, K, bm, bn, bk, n_major, cluster;
};

using mma::split_tf32;

// acc += the staged x tile's rows [wm0, wm0 + 16*WMF) @ the w tile's
// columns [wn0, wn0 + 16*WNF), over the bk of the stage, as 3xTF32.
// acc[i][j][h] is the accumulator of fragment (i, j)'s n8 half h. The
// tensor cores sum the stage into d from zero, and d is added to acc with
// f32 adds: their own f32 accumulation keeps fewer of the products' low
// bits than an f32 add once the running sum is much larger than the
// products, so no sum on them runs longer than bk.
template <int WMF, int WNF>
__device__ inline void f32_warp_product(const float* xs, const float* ws,
                                        int bn, int bk, int wm0, int wn0,
                                        float (&acc)[WMF][WNF][2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int xstride = bk + F32_X_PAD, wstride = bn + F32_W_PAD;
  // ldmatrix.x4 on f32 as b16 pairs: matrices (rows 0-7, k 0-3), (rows
  // 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7) = a0..a3.
  const float* a_ptr = xs + (wm0 + (lane & 15)) * xstride + (lane >> 4) * 4;
  const float* b_ptr = ws + t * wstride + wn0 + g;
  float d[WMF][WNF][2][4];
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < WNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][h][e] = 0.f;
  // four k8 chunks deep: each chunk's splits are a few integer
  // instructions, and ptxas does not unroll the loop unasked
#pragma unroll 4
  for (int kk = 0; kk < bk; kk += 8) {
    uint32_t a_hi[WMF][4], a_lo[WMF][4];
#pragma unroll
    for (int i = 0; i < WMF; ++i) {
      uint32_t raw[4];
      mma::ldmatrix_x4(raw, a_ptr + i * FRAG * xstride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(raw[e]), a_hi[i][e], a_lo[i][e]);
    }
#pragma unroll
    for (int j = 0; j < WNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b_hi[2], b_lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_tf32(b_ptr[(kk + 4 * e) * wstride + j * FRAG + h * 8],
                     b_hi[e], b_lo[e]);
#pragma unroll
        for (int i = 0; i < WMF; ++i) {
          mma::mma_tf32_1688(d[i][j][h], a_lo[i], b_hi[0], b_hi[1]);
          mma::mma_tf32_1688(d[i][j][h], a_hi[i], b_lo[0], b_lo[1]);
          mma::mma_tf32_1688(d[i][j][h], a_hi[i], b_hi[0], b_hi[1]);
        }
      }
  }
#pragma unroll
  for (int i = 0; i < WMF; ++i)
#pragma unroll
    for (int j = 0; j < WNF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][h][e] += d[i][j][h][e];
}

// Store one n8 accumulator: rows row, row + 8, columns col, col + 1.
__device__ inline void store_n8(float* __restrict__ out, int N, int row,
                                int col, const float (&v)[4]) {
  *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
      make_float2(v[0], v[1]);
  *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
      make_float2(v[2], v[3]);
}

// One block per (bm, bn) output tile, or a cluster of a.cluster blocks per
// tile (ACC only), each taking a contiguous share of the k steps; warp w
// owns warp tiles w and, if REP = 2, w + warps (when that exists). ACC as
// for matmul_tc_kernel.
template <int WMF, int WNF, int REP, bool ACC>
__global__ void __launch_bounds__(WMF * WNF > 1 ? 512 : 1024)
    matmul_3xtf32_kernel(const F32Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int rank = 0, tile = blockIdx.x;
  if (ACC && a.cluster > 1) {
    rank = (int)cg::this_cluster().block_rank();
    tile = blockIdx.x / a.cluster;
  }
  int m0, n0;
  // _noacc_kernel's Pallas grid (gk, gm, gn) walks n fastest
  tile_origin(a.M, a.N, a.bm, a.bn, ACC ? a.n_major : 0, tile, &m0, &n0);
  const int steps = a.K / a.bk;
  const int s0 = rank * steps / a.cluster;
  const int n = (rank + 1) * steps / a.cluster - s0;
  const size_t stage = f32_stage_bytes(a.bm, a.bn, a.bk);
  const size_t ws_off = (size_t)a.bm * (a.bk + F32_X_PAD) * sizeof(float);

  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_n = a.bn / (FRAG * WNF);
  const int tiles = (a.bm / (FRAG * WMF)) * tiles_n;
  int wm0[REP], wn0[REP];
  bool live[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const int t = warp + r * warps;
    live[r] = t < tiles;   // warp-uniform; always true for r = 0
    wm0[r] = (t / tiles_n) * FRAG * WMF;
    wn0[r] = (t % tiles_n) * FRAG * WNF;
  }
  float acc[REP][WMF][WNF][2][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < WMF; ++i)
#pragma unroll
      for (int j = 0; j < WNF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][i][j][h][e] = 0.f;

  const ChunkWalk xwalk(a.bk / 4), wwalk(a.bn / 4);
  const int xstride = a.bk + F32_X_PAD, wstride = a.bn + F32_W_PAD;
#pragma unroll
  for (int i = 0; i < F32_STAGES - 1; ++i) {
    if (i < n) {
      unsigned char* slot = smem + i * stage;
      tc_load_stage(a.x, a.w, reinterpret_cast<float*>(slot),
                    reinterpret_cast<float*>(slot + ws_off), a.N, a.K, m0,
                    n0, (s0 + i) * a.bk, a.bm, a.bk, xwalk, wwalk, xstride,
                    wstride);
    } else {
      mma::cp_async_commit();  // an empty group keeps the count uniform
    }
  }
  for (int i = 0; i < n; ++i) {
    // Step i's copies have landed for every thread, and every warp is done
    // with step i-1's slot, which step i + STAGES - 1 now overwrites.
    mma::cp_async_wait<F32_STAGES - 2>();
    __syncthreads();
    if (i + F32_STAGES - 1 < n) {
      unsigned char* slot =
          smem + ((i + F32_STAGES - 1) % F32_STAGES) * stage;
      tc_load_stage(a.x, a.w, reinterpret_cast<float*>(slot),
                    reinterpret_cast<float*>(slot + ws_off), a.N, a.K, m0,
                    n0, (s0 + i + F32_STAGES - 1) * a.bk, a.bm, a.bk, xwalk,
                    wwalk, xstride, wstride);
    } else {
      mma::cp_async_commit();
    }
    const unsigned char* cur = smem + (i % F32_STAGES) * stage;
    const float* xs = reinterpret_cast<const float*>(cur);
    const float* ws = reinterpret_cast<const float*>(cur + ws_off);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (!live[r]) continue;
      if (!ACC) {
#pragma unroll
        for (int i2 = 0; i2 < WMF; ++i2)
#pragma unroll
          for (int j = 0; j < WNF; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[r][i2][j][h][e] = 0.f;
      }
      f32_warp_product<WMF, WNF>(xs, ws, a.bn, a.bk, wm0[r], wn0[r], acc[r]);
      if (!ACC)
        tc_store<WMF, WNF>(a.out, a.N, m0 + wm0[r], n0 + wn0[r], acc[r],
                           i > 0);
    }
  }
  if (!ACC) return;
  if (a.cluster == 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (live[r])
        tc_store<WMF, WNF>(a.out, a.N, m0 + wm0[r], n0 + wn0[r], acc[r],
                           false);
    return;
  }

  // Split K: every block's partial tile into its own shared memory, lane
  // fastest (warp tile t, n8 group gi, element e); then rank r sums groups
  // r, r + C, ... over the cluster in rank order and stores them.
  constexpr int G = WMF * WNF * 2;
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (!live[r]) continue;
    const int t = warp + r * warps;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[((t * G + gi) * 4 + e) * 32 + lane] =
            acc[r][gi / (2 * WNF)][(gi / 2) % WNF][gi % 2][e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (!live[r]) continue;
    const int t = warp + r * warps;
    for (int gi = rank; gi < G; gi += a.cluster) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < a.cluster; ++q) {
        const float* src = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] += src[((t * G + gi) * 4 + e) * 32 + lane];
      }
      const int i = gi / (2 * WNF), j = (gi / 2) % WNF, h = gi % 2;
      store_n8(a.out, a.N, m0 + wm0[r] + i * FRAG + (lane >> 2),
               n0 + wn0[r] + j * FRAG + h * 8 + (lane & 3) * 2, v);
    }
  }
  cluster.sync();  // no block leaves while another reads its memory
}

template <int WMF, int WNF, int REP, bool ACC>
int f32_run(const F32Args& a, const F32Plan& p, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.bm, a.bn, a.bk);
  cudaError_t err =
      prepare_launch(matmul_3xtf32_kernel<WMF, WNF, REP, ACC>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.tiles * p.cluster));
  cfg.blockDim = dim3(p.warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, matmul_3xtf32_kernel<WMF, WNF, REP, ACC>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch is not sticky
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <bool ACC>
int f32_launch(const void* x, const void* w, void* out, int M, int N, int K,
               int bm, int bn, int bk, int n_major, int max_cluster,
               cudaStream_t stream) {
  if (!tc_shape_ok(M, N, K, bm, bn, bk) || max_cluster < 1 ||
      max_cluster > F32_MAX_CLUSTER ||
      (long long)(M / bm) * (N / bn) * max_cluster > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const F32Plan p = f32_plan(M, N, K, bm, bn, bk, ACC, max_cluster);
  const F32Args a{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<float*>(out), M, N, K, bm, bn, bk, n_major,
                  p.cluster};
  if (p.wmf == 2 && p.wnf == 2) return f32_run<2, 2, 1, ACC>(a, p, stream);
  if (p.wnf == 2) return f32_run<1, 2, 1, ACC>(a, p, stream);
  if (p.wmf == 2) return f32_run<2, 1, 1, ACC>(a, p, stream);
  if (p.rep == 1) return f32_run<1, 1, 1, ACC>(a, p, stream);
  return f32_run<1, 1, 2, ACC>(a, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. out is float32 for the first
// two and int32 for int8; every array is row-major and contiguous, with M,
// N and K multiples of bm, bn and bk (f32 and bf16: pointers 16-byte
// aligned, block dims multiples of 16). f32 _acc_kernel splits K over at
// most max_cluster blocks of a cluster (1 to 8; 1: never split), for
// measuring what the split buys and holding both sides of it; the other
// kernels ignore it. Returns a cudaError_t.
extern "C" int matmul_launch_capped(int accumulate, int dtype, const void* x,
                                    const void* w, void* out, int M, int N,
                                    int K, int bm, int bn, int bk,
                                    int n_major, int max_cluster,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return accumulate ? f32_launch<true>(x, w, out, M, N, K, bm, bn, bk,
                                           n_major, max_cluster, s)
                        : f32_launch<false>(x, w, out, M, N, K, bm, bn, bk,
                                            n_major, max_cluster, s);
    case 1:
      return accumulate ? tc_launch<true>(x, w, out, M, N, K, bm, bn, bk,
                                          n_major, s)
                        : tc_launch<false>(x, w, out, M, N, K, bm, bn, bk,
                                           n_major, s);
    case 2:
      return int8_launch(accumulate, x, w, out, M, N, K, bm, bn, bk,
                         n_major, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// matmul_launch_capped with f32 K split over up to 8 blocks by its rule.
extern "C" int matmul_launch(int accumulate, int dtype, const void* x,
                             const void* w, void* out, int M, int N, int K,
                             int bm, int bn, int bk, int n_major,
                             void* stream) {
  return matmul_launch_capped(accumulate, dtype, x, w, out, M, N, K, bm, bn,
                              bk, n_major, F32_MAX_CLUSTER, stream);
}
