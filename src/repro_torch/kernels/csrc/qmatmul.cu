// Quantized int8 matmul + bias + requantize for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces src/repro/kernels/qmatmul/kernel.py:_qmm_kernel:
//   out_i8 = clip(round_half_even(f32(x_i8 @ w_i8 + bias_i32) * scale), -128, 127)
// Always the accumulating form: like the Pallas kernel it ignores the
// schedule's order and accumulate decisions (int32 sums are exact, so no
// order of the k steps changes a bit of the result).
//
// Operands: x (M, K), w (K, N), both row-major int8, bias (N,) int32, out
// (M, N) int8, at their real sizes: the kernel masks the tail tile in m, n
// and k itself (copies past an edge are zero-filled, stores past it are
// dropped), so no operand is padded first and the visible outputs equal
// those of the kernel run on operands zero-padded to the block.
//
// What bounds it on this card: at the main paths' shapes, neither rate.
// MobileLLM-125M's 64 x 576 x 1536 projection moves 1.0 MB (0.3 us at 3.35
// TB/s) for 113 MOP (0.06 us at 1979 TOP/s); the LM head 64 x 32000 x 576
// reads an 18.4 MB weight (6.2 us). What costs time is the latency of a
// chain of k steps in few blocks: 64 x 576 outputs make 9 blocks of 64 x 64
// on 132 SMs. What the design does about it:
//
// - Tensor cores: each warp multiplies with mma.sync m16n8k32 (s8 in, s32
//   sum in registers). A warp owns WM x WN fragments of 16 rows x 32
//   columns (four n8 mma tiles each); make_plan picks WM, WN in {1, 2}
//   so that a block keeps at least four warps where its tile allows.
//   wgmma needs 64-row tiles and the int8 space offers bm 16 and 32.
// - Staging: each k step's x (bm, bk) and w (bk, bn) tiles are copied with
//   cp.async into a QMM_STAGES-deep ring in dynamic shared memory; a thread
//   issues all of its copies of a stage before it waits, and the next
//   stages are in flight while the current one multiplies. The copy width
//   is 16 bytes where a row's length and its tensor's address allow it,
//   else 8 or 4 (make_plan: copy_width); a row length that is not a multiple
//   of 4 (MobileNetV2's first convolution, k = 27) is staged by plain byte
//   loads, four to a shared 32-bit store.
// - The B operand: s8 mma takes B k-major, w's tile is n-major in shared
//   memory, and ldmatrix transposes only 16-bit elements. A lane reads four
//   32-bit words, one from each of four k rows at the same four columns, and
//   transposes the 4 x 4 bytes with __byte_perm. The four columns are the
//   lane's mma column g in each of the fragment's four n8 tiles: mma tile q
//   computes the block's columns 4 * c + q (c = 0..7), so lane (g, t) needs
//   columns 4g..4g+3 and holds, after the products, eight consecutive output
//   columns 8t..8t+7 of rows g and g + 8 (one 8-byte store each). Shared
//   rows are padded by QMM_ROW_PAD bytes (a row stride of 16 mod 32 bytes)
//   and lanes with t >= 2 read their four rows in the order 2, 3, 0, 1, so
//   each of the four loads of a warp touches 32 different banks.
// - Few blocks, long K: the blocks of one output tile form a thread-block
//   cluster of C blocks, each taking a contiguous share of the k steps. C
//   starts at 1 and doubles while C < QMM_MAX_CLUSTER, the grid (tiles *
//   2C) stays within QMM_FILL_CTAS (the card's 132 SMs) and each block
//   keeps at least QMM_MIN_STEPS k steps. The partial int32 tiles meet in
//   distributed shared memory: each block writes its sums into its own
//   shared memory, and rank r reads every block's sums of the output rows it
//   owns (fragment groups r, r + C, ...), adds them and requantizes them.
//   int32 sums are exact: any split gives the same bits.
//
// Shared memory: max(QMM_STAGES * (bm * (bk + 16) + bk * (bn + 16)),
// bm * bn * 4) bytes, the ring or, after it, the cluster's partial tile;
// nondecreasing in each block dim (kernels/qmatmul/ops.py: smem_bytes
// mirrors it, plan mirrors make_plan, supports_block_shape the launch
// limits below).
//
// The rescale is bit-exact with the JAX kernel: int32 add, conversion to
// f32 with round-to-nearest, one f32 multiply (a lone multiply; nothing to
// contract into an FMA), rintf (round half to even, as jnp.round; not
// roundf, which rounds half away from zero), clamp, int8. Build without
// --use_fast_math.
#include <cooperative_groups.h>

#include "mma.cuh"
#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QMM_STAGES = 3;
constexpr int QMM_ROW_PAD = 16;         // bytes per shared row
constexpr int QMM_MAX_OUTPUTS = 16384;  // bm * bn: at most 32 warps
constexpr int QMM_MAX_CLUSTER = 8;
constexpr int QMM_FILL_CTAS = 132;
constexpr int QMM_MIN_STEPS = 2;
constexpr int QMM_MIN_WARPS = 4;
constexpr int FRAG_M = 16;  // rows of one warp fragment (one mma m16)
constexpr int FRAG_N = 32;  // columns: four mma n8 tiles
constexpr int FRAG_K = 32;  // depth of one mma k32

// The launch-time layout, computed once on the host.
struct Plan {
  int wm, wn;            // fragments per warp: wm rows x wn columns of them
  int warps;             // warps per block
  int tiles_m, tiles_n;  // output tiles
  int steps;             // k steps of bk
  int cluster;           // blocks that split one tile's k steps
  int vx, vw;            // copy width in bytes of x's and w's rows (16,
                         // 8, 4; 1: byte loads)
};

__host__ inline int copy_width(int row_bytes, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && a % v == 0) return v;
  return 1;
}

__host__ inline size_t qmm_stage_bytes(int bm, int bn, int bk) {
  return (size_t)bm * (bk + QMM_ROW_PAD) + (size_t)bk * (bn + QMM_ROW_PAD);
}

__host__ inline size_t qmm_smem_bytes(int bm, int bn, int bk) {
  const size_t ring = QMM_STAGES * qmm_stage_bytes(bm, bn, bk);
  const size_t part = (size_t)bm * bn * sizeof(int);
  return ring > part ? ring : part;
}

__host__ inline Plan make_plan(int M, int N, int K, int bm, int bn, int bk,
                               const void* x, const void* w,
                               int max_cluster) {
  Plan p{};
  const int fm = bm / FRAG_M, fn = bn / FRAG_N;
  p.wm = (fm % 2 == 0 && (fm / 2) * fn >= QMM_MIN_WARPS) ? 2 : 1;
  p.wn = (fn % 2 == 0 && (fm / p.wm) * (fn / 2) >= QMM_MIN_WARPS) ? 2 : 1;
  p.warps = (fm / p.wm) * (fn / p.wn);
  p.tiles_m = (M + bm - 1) / bm;
  p.tiles_n = (N + bn - 1) / bn;
  p.steps = (K + bk - 1) / bk;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  int c = 1;
  while (c < max_cluster && tiles * 2 * c <= QMM_FILL_CTAS &&
         p.steps >= 2 * c * QMM_MIN_STEPS)
    c *= 2;
  p.cluster = c;
  p.vx = copy_width(K, x);
  p.vw = copy_width(N, w);
  return p;
}

// Stage a (rows, cols)-byte tile whose top left is `src` (row pitch
// `pitch` bytes) into shared memory at `dst` (row stride `stride`), V bytes
// a copy; rows >= row_lim and columns >= col_lim are zero-filled. V divides
// cols and col_lim's tensor row, so a copy never straddles the edge.
template <int V>
__device__ inline void stage_tile(unsigned char* dst, int stride,
                                  const int8_t* src, size_t pitch, int rows,
                                  int cols, int row_lim, int col_lim) {
  const int per_row = cols / V, n = rows * per_row;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * V;
    const bool ok = r < row_lim && c < col_lim;
    mma::cp_async_zfill<V>(dst + r * stride + c,
                           ok ? src + r * pitch + c : src, ok);
  }
}

// The same with plain byte loads, four to one 32-bit shared store, for rows
// whose length is not a multiple of 4.
__device__ inline void stage_tile_bytes(unsigned char* dst, int stride,
                                        const int8_t* src, size_t pitch,
                                        int rows, int cols, int row_lim,
                                        int col_lim) {
  const int per_row = cols / 4, n = rows * per_row;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    uint32_t v = 0;
    if (r < row_lim) {
      const unsigned char* s =
          reinterpret_cast<const unsigned char*>(src + r * pitch);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < col_lim) v |= (uint32_t)__ldg(s + c + b) << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(dst + r * stride + c) = v;
  }
}

__device__ inline void stage(int v, unsigned char* dst, int stride,
                             const int8_t* src, size_t pitch, int rows,
                             int cols, int row_lim, int col_lim) {
  switch (v) {
    case 16:
      stage_tile<16>(dst, stride, src, pitch, rows, cols, row_lim, col_lim);
      break;
    case 8:
      stage_tile<8>(dst, stride, src, pitch, rows, cols, row_lim, col_lim);
      break;
    case 4:
      stage_tile<4>(dst, stride, src, pitch, rows, cols, row_lim, col_lim);
      break;
    default:
      stage_tile_bytes(dst, stride, src, pitch, rows, cols, row_lim,
                       col_lim);
  }
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int* bias;
  float scale;
  int8_t* out;
  int M, N, K, bm, bn, bk;
  Plan p;
};

// The copies of k step `step` into ring slot `slot`, committed as one group.
__device__ inline void load_step(const Args& a, unsigned char* smem, int slot,
                                 int m0, int n0, int step) {
  unsigned char* xs = smem + slot * (size_t)(a.bm * (a.bk + QMM_ROW_PAD) +
                                             a.bk * (a.bn + QMM_ROW_PAD));
  unsigned char* ws = xs + a.bm * (a.bk + QMM_ROW_PAD);
  const int k0 = step * a.bk;
  stage(a.p.vx, xs, a.bk + QMM_ROW_PAD, a.x + (size_t)m0 * a.K + k0, a.K,
        a.bm, a.bk, a.M - m0, a.K - k0);
  stage(a.p.vw, ws, a.bn + QMM_ROW_PAD, a.w + (size_t)k0 * a.N + n0, a.N,
        a.bk, a.bn, a.K - k0, a.N - n0);
  mma::cp_async_commit();
}

// The B fragments of the 32 x 32 (k, n) piece of the w tile at row k0 and
// column n0: b[q][h] is b_h of mma tile q, whose column c is the piece's
// column 4c + q. Rows 4t..4t+3 (h = 0) and 16+4t.. (h = 1) of columns
// 4g..4g+3, transposed: byte q of row j becomes byte j of b[q][h].
__device__ inline void load_b(uint32_t (&b)[4][2], const unsigned char* ws,
                              int stride, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int flip = t & 2;  // rows in the order 2, 3, 0, 1: no bank conflict
  // byte selectors of the second transpose pass, for rows in either order
  const uint32_t lo = flip ? 0x1054 : 0x5410, hi = flip ? 0x3276 : 0x7632;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* p = ws + (k0 + 16 * h + 4 * t) * stride + n0 + 4 * g;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const uint32_t*>(p + (j ^ flip) * stride);
    // r[j] is row j ^ flip. Interleave rows (r0, r1) and (r2, r3) by byte,
    // then by halfword.
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    b[0][h] = __byte_perm(t0, t2, lo);
    b[1][h] = __byte_perm(t0, t2, hi);
    b[2][h] = __byte_perm(t1, t3, lo);
    b[3][h] = __byte_perm(t1, t3, hi);
  }
}

// acc += the staged x tile's rows [wm0, wm0 + 16 WM) @ the w tile's columns
// [wn0, wn0 + 32 WN), over the stage's bk. acc[i][j][q] is mma tile q of
// fragment (i, j).
template <int WM, int WN>
__device__ inline void warp_product(const unsigned char* xs,
                                    const unsigned char* ws, int bn, int bk,
                                    int wm0, int wn0,
                                    int (&acc)[WM][WN][4][4]) {
  const int lane = threadIdx.x & 31;
  const int xstride = bk + QMM_ROW_PAD, wstride = bn + QMM_ROW_PAD;
  // ldmatrix.x4 on bytes as b16 pairs: matrices (rows 0-7, k 0-15), (rows
  // 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31) = a0..a3
  const unsigned char* a_ptr =
      xs + (wm0 + (lane & 15)) * xstride + (lane >> 4) * 16;
  for (int kk = 0; kk < bk; kk += FRAG_K) {
    uint32_t a[WM][4], b[WN][4][2];
#pragma unroll
    for (int i = 0; i < WM; ++i)
      mma::ldmatrix_x4(a[i], a_ptr + i * FRAG_M * xstride + kk);
#pragma unroll
    for (int j = 0; j < WN; ++j) load_b(b[j], ws, wstride, kk, wn0 + j * FRAG_N);
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma::mma_s8_16832(acc[i][j][q], a[i], b[j][q][0], b[j][q][1]);
  }
}

// Requantize and store the eight outputs of row `row`, columns col..col+7,
// whose int32 sums are v[0..7]; what lies past M or N is dropped.
__device__ inline void store8(const Args& a, int row, int col,
                              const int (&v)[8]) {
  if (row >= a.M) return;
  uint32_t packed[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int b = col + e < a.N ? __ldg(a.bias + col + e) : 0;
    const float scaled = __fmul_rn(__int2float_rn(v[e] + b), a.scale);
    const float r = fminf(fmaxf(rintf(scaled), -128.0f), 127.0f);
    packed[e / 4] |= (uint32_t)((int)r & 0xff) << (8 * (e % 4));
  }
  int8_t* o = a.out + (size_t)row * a.N + col;
  if (col + 8 <= a.N && reinterpret_cast<uintptr_t>(o) % 8 == 0) {
    *reinterpret_cast<uint2*>(o) = make_uint2(packed[0], packed[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < a.N) o[e] = (int8_t)(packed[e / 4] >> (8 * (e % 4)));
}

// The eight sums of fragment group (i, j, u) of this lane: row g + 8u of
// fragment (i, j), columns 8t..8t+7 (mma tile q's columns 2t and 2t + 1 are
// the fragment's 8t + q and 8t + 4 + q).
template <int WM, int WN>
__device__ inline void group_sums(const int (&acc)[WM][WN][4][4], int i,
                                  int j, int u, int (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = acc[i][j][q][2 * u];
    v[4 + q] = acc[i][j][q][2 * u + 1];
  }
}

template <int WM, int WN>
__global__ void __launch_bounds__(WM * WN == 1 ? 1024 : 512)
    qmm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  int rank = 0, tile = blockIdx.x;
  if (p.cluster > 1) {
    rank = (int)cg::this_cluster().block_rank();
    tile = blockIdx.x / p.cluster;
  }
  const int m0 = (tile / p.tiles_n) * a.bm, n0 = (tile % p.tiles_n) * a.bn;
  // this block's share of the k steps
  const int s0 = (int)((long long)rank * p.steps / p.cluster);
  const int s1 = (int)((long long)(rank + 1) * p.steps / p.cluster);
  const int n = s1 - s0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps_n = a.bn / (FRAG_N * WN);
  const int wm0 = (warp / warps_n) * FRAG_M * WM;
  const int wn0 = (warp % warps_n) * FRAG_N * WN;
  int acc[WM][WN][4][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][q][e] = 0;

  const size_t stage_bytes = (size_t)a.bm * (a.bk + QMM_ROW_PAD) +
                             (size_t)a.bk * (a.bn + QMM_ROW_PAD);
  const size_t ws_off = (size_t)a.bm * (a.bk + QMM_ROW_PAD);
#pragma unroll
  for (int i = 0; i < QMM_STAGES - 1; ++i) {
    if (i < n) {
      load_step(a, smem, i, m0, n0, s0 + i);
    } else {
      mma::cp_async_commit();  // an empty group keeps the count uniform
    }
  }
  for (int i = 0; i < n; ++i) {
    // Step i's copies have landed for every thread, and every warp is done
    // with step i-1's slot, which step i + STAGES - 1 now overwrites.
    mma::cp_async_wait<QMM_STAGES - 2>();
    __syncthreads();
    if (i + QMM_STAGES - 1 < n)
      load_step(a, smem, (i + QMM_STAGES - 1) % QMM_STAGES, m0, n0,
                s0 + i + QMM_STAGES - 1);
    else
      mma::cp_async_commit();
    const unsigned char* cur = smem + (i % QMM_STAGES) * stage_bytes;
    warp_product<WM, WN>(cur, cur + ws_off, a.bn, a.bk, wm0, wn0, acc);
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + wm0 + g, col0 = n0 + wn0 + 8 * t;
  if (p.cluster == 1) {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          int v[8];
          group_sums<WM, WN>(acc, i, j, u, v);
          store8(a, row0 + i * FRAG_M + 8 * u, col0 + j * FRAG_N, v);
        }
    return;
  }

  // Split K: every block's partial tile into its own shared memory, group
  // by group, each group's eight sums strided by the block's threads (the
  // reads below are coalesced); then rank r sums groups r, r + C, ... over
  // the cluster in rank order and stores them.
  constexpr int GROUPS = WM * WN * 2;
  const int nt = blockDim.x;
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int gi = 0; gi < GROUPS; ++gi) {
    int v[8];
    group_sums<WM, WN>(acc, gi / (WN * 2), (gi / 2) % WN, gi % 2, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(gi * 8 + e) * nt + threadIdx.x] = v[e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int gi = rank; gi < GROUPS; gi += p.cluster) {
    int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int q = 0; q < p.cluster; ++q) {
      const int* src = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += src[(gi * 8 + e) * nt + threadIdx.x];
    }
    const int i = gi / (WN * 2), j = (gi / 2) % WN, u = gi % 2;
    store8(a, row0 + i * FRAG_M + 8 * u, col0 + j * FRAG_N, v);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

template <int WM, int WN>
int run(const Args& a, cudaStream_t stream) {
  const size_t smem = qmm_smem_bytes(a.bm, a.bn, a.bk);
  cudaError_t err = tile::prepare_launch(qmm_kernel<WM, WN>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)a.p.tiles_m * a.p.tiles_n *
                                a.p.cluster));
  cfg.blockDim = dim3(a.p.warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qmm_kernel<WM, WN>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch is not sticky
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// qmatmul_launch with K split over at most max_cluster blocks of a cluster
// (1 to 8; 1: never split), for measuring what the split buys and holding
// both sides of it.
extern "C" int qmatmul_launch_capped(const void* x, const void* w,
                                     const void* bias, float scale, void* out,
                                     int M, int N, int K, int bm, int bn,
                                     int bk, int max_cluster, void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < FRAG_M || bn < FRAG_N ||
      bk < FRAG_K || bm % FRAG_M || bn % FRAG_N || bk % FRAG_K ||
      (long long)bm * bn > QMM_MAX_OUTPUTS || max_cluster < 1 ||
      max_cluster > QMM_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(x),
         static_cast<const int8_t*>(w),
         static_cast<const int*>(bias),
         scale,
         static_cast<int8_t*>(out),
         M, N, K, bm, bn, bk,
         make_plan(M, N, K, bm, bn, bk, x, w, max_cluster)};
  if ((long long)a.p.tiles_m * a.p.tiles_n * a.p.cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.p.wm == 2 && a.p.wn == 2) return run<2, 2>(a, s);
  if (a.p.wm == 2) return run<2, 1>(a, s);
  if (a.p.wn == 2) return run<1, 2>(a, s);
  return run<1, 1>(a, s);
}

// x (M, K) int8, w (K, N) int8, bias (N,) int32, out (M, N) int8; all
// row-major and contiguous, any M, N, K >= 1; bm a multiple of 16, bn and
// bk of 32, bm * bn <= 16384, shared memory (qmm_smem_bytes) within the
// card's 227 KB. Returns a cudaError_t.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* bias,
                              float scale, void* out, int M, int N, int K,
                              int bm, int bn, int bk, void* stream) {
  return qmatmul_launch_capped(x, w, bias, scale, out, M, N, K, bm, bn, bk,
                               QMM_MAX_CLUSTER, stream);
}
