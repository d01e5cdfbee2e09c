// Tiled matmul for Hopper (sm_90a): out = x @ w, f32 or int32 accumulation.
//
// Replaces the two Pallas kernels of src/repro/kernels/matmul/kernel.py:
//   _acc_kernel   -> matmul_acc (f32, int8), matmul_tc_kernel<..., true>
//                    (bf16): K innermost; the accumulator is carried across
//                    the K steps in registers and the output tile is stored
//                    once (the paper's Algorithm 1).
//   _noacc_kernel -> matmul_noacc (f32, int8), matmul_tc_kernel<..., false>
//                    (bf16): the store-heavy schedule; the output tile is
//                    read, added to and written back in device memory after
//                    every K step.
//
// What bounds it on this card: at the tuned workloads (m = 64 token rows,
// k = 576 or 1536) the products are small. Read once, their operands take
// 0.7-14 us at 3.35 TB/s, and their operations at the bf16 tensor-core peak
// a sixth of that, so the bound is bytes. But one block's output tile needs
// K / bk dependent steps, each a round trip to device memory, and at m = 64
// there are few blocks (24 on 132 SMs for W3 at 64 x 64): the time is the
// latency of one block's chain of k steps, not a rate.
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
// f32 and int8 stay on the CUDA cores (tile.cuh: a 4x4 register micro-tile
// per thread, f32 FMA or __dp4a): TF32 tensor cores would break the 1e-4
// tolerance against the JAX package, no main path runs an f32 matmul, and
// int8 shares tile.cuh with qmatmul.cu, whose tensor-core redesign is a
// later kernel's.
//
// The Pallas grid runs in order; thread blocks do not. The noacc kernels
// therefore keep one block per output tile and run their K loop inside the
// block, each thread re-reading and re-writing only the output elements it
// owns, so no two blocks touch one element and the sum runs over k in the
// order of the Pallas grid. The first K step writes without adding (the
// buffer comes from torch.empty). No split-K atomics: they would change the
// sum order from run to run.
#include "mma.cuh"
#include "tile.cuh"

namespace {

using namespace tile;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    matmul_acc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      typename Traits<T>::Acc* __restrict__ out, int M, int N,
                      int K, int bm, int bn, int bk, int n_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Acc = typename Traits<T>::Acc;
  const Layout L(bm, bn);
  int m0, n0;
  tile_origin(M, N, bm, bn, n_major, &m0, &n0);
  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  for (int k0 = 0; k0 < K; k0 += bk)
    k_step<T>(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx + j * L.TX] =
          acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    matmul_noacc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        typename Traits<T>::Acc* __restrict__ out, int M,
                        int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Acc = typename Traits<T>::Acc;
  const Layout L(bm, bn);
  int m0, n0;
  // the Pallas grid (gk, gm, gn) walks n fastest within each k step
  tile_origin(M, N, bm, bn, /*n_major=*/0, &m0, &n0);
  for (int k0 = 0; k0 < K; k0 += bk) {
    Acc part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = Acc(0);
    k_step<T>(x, w, smem, N, K, m0, n0, k0, bm, bn, bk, L, part);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        Acc* o = out + (size_t)(m0 + L.ty + i * L.TY) * N + n0 + L.tx +
                 j * L.TX;
        *o = (k0 == 0) ? part[i][j] : *o + part[i][j];
      }
  }
}

template <typename T>
int launch(bool accumulate, const void* x, const void* w, void* out, int M,
           int N, int K, int bm, int bn, int bk, int n_major,
           cudaStream_t stream) {
  using Acc = typename Traits<T>::Acc;
  if (!shape_ok(M, N, K, bm, bn, bk, sizeof(T) == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(bm, bn, bk);
  const dim3 grid((M / bm) * (N / bn)), block((bm / TM) * (bn / TN));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  Acc* op = static_cast<Acc*>(out);
  cudaError_t err;
  if (accumulate) {
    err = prepare_launch(matmul_acc_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_acc_kernel<T><<<grid, block, smem, stream>>>(xp, wp, op, M, N, K,
                                                        bm, bn, bk, n_major);
  } else {
    err = prepare_launch(matmul_noacc_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    matmul_noacc_kernel<T><<<grid, block, smem, stream>>>(xp, wp, op, M, N,
                                                          K, bm, bn, bk);
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

// A thread's walk over the 16-byte chunks of a tile with `cols` chunks a
// row: chunks threadIdx.x, threadIdx.x + blockDim.x, ... as (row, col),
// with the divisions done once per kernel, not once per chunk.
struct ChunkWalk {
  int r0, c0, dr, dc, cols;
  __device__ explicit ChunkWalk(int cols_) : cols(cols_) {
    r0 = threadIdx.x / cols;
    c0 = threadIdx.x - r0 * cols;
    dr = blockDim.x / cols;
    dc = blockDim.x - dr * cols;
  }
  __device__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Issue (and commit as one group) the cp.async copies of the k step at k0:
// x rows [m0, m0+bm) x cols [k0, k0+bk) into xs, w rows [k0, k0+bk) x cols
// [n0, n0+bn) into ws, 8 bf16 values per copy.
__device__ inline void tc_load_stage(const bf16* __restrict__ x,
                                     const bf16* __restrict__ w, bf16* xs,
                                     bf16* ws, int N, int K, int m0, int n0,
                                     int k0, int bm, int bk,
                                     const ChunkWalk& xwalk,
                                     const ChunkWalk& wwalk, int xstride,
                                     int wstride) {
  for (int r = xwalk.r0, c = xwalk.c0; r < bm; xwalk.next(r, c))
    mma::cp_async16(xs + r * xstride + c * 8,
                    x + (size_t)(m0 + r) * K + k0 + c * 8);
  for (int r = wwalk.r0, c = wwalk.c0; r < bk; wwalk.next(r, c))
    mma::cp_async16(ws + r * wstride + c * 8,
                    w + (size_t)(k0 + r) * N + n0 + c * 8);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. out is float32 for the first
// two and int32 for int8; every array is row-major and contiguous, with M,
// N and K multiples of bm, bn and bk (bf16: pointers 16-byte aligned, block
// dims multiples of 16). Returns a cudaError_t.
extern "C" int matmul_launch(int accumulate, int dtype, const void* x,
                             const void* w, void* out, int M, int N, int K,
                             int bm, int bn, int bk, int n_major,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(accumulate, x, w, out, M, N, K, bm, bn, bk,
                           n_major, s);
    case 1:
      return accumulate ? tc_launch<true>(x, w, out, M, N, K, bm, bn, bk,
                                          n_major, s)
                        : tc_launch<false>(x, w, out, M, N, K, bm, bn, bk,
                                           n_major, s);
    case 2:
      return launch<int8_t>(accumulate, x, w, out, M, N, K, bm, bn, bk,
                            n_major, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
