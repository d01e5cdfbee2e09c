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
// Two main loops, chosen by make_plan from what the call shows (the tile
// count and the block's rows), one function name (qmm_kernel) for both:
//
// 1. The warp-specialised wgmma loop, wgmma::qmm_kernel<BN>, for blocks of
//    64 or 128 rows and 32 to 128 columns whose grid fills the card: at
//    least QMM_FILL_CTAS units of 128 rows x bn, in few enough columns of
//    tiles that a persistent block walks down one of them (make_wg_plan).
//    Of the block it reads only bn: its staging follows the shape, so every
//    block it takes at one bn launches the same kernel on the same layout
//    (ops.launch_key; the measuring runner times each once).
//    That is the networks' im2col
//    convolutions at batch (3,136 to 1,204,224 rows, K 16 to 4608), bound
//    by the bytes of x: ResNet18's 200704 x 64 x 576 moves 128.5 MB (38.4 us
//    at 3.35 TB/s) for 7.5 us of operations. What the design does about it:
//    - x streams through a ring of QMM_WG_MIN_STAGES to QMM_WG_MAX_STAGES
//      slots, as many as the shared memory left beside w holds, that one
//      producer thread fills, completing each slot on an mbarrier; no
//      consumer thread issues a copy. A slot is a unit of QMM_WG_UNIT rows,
//      whatever the block's bm: a copy's own cost is large (on this card a
//      16 KB copy streams at 2.5-3.1 TB/s, an 8 KB one at 2.2). Where K is
//      a multiple of 16 bytes a 2D tensor map (built on the host once per
//      call) brings a slot as one box of P bytes of k (P the least of 32,
//      64, 128 that holds K, else 128; not the block's bk) x 128 rows,
//      swizzled as wgmma reads it. Where it is not (K 27, 24, 147), a slot
//      is a whole unit, 128 * K contiguous bytes, brought by one 1D bulk
//      copy and re-laid by its consumer warpgroup into swizzled panels.
//    - w is staged k-major (wgmma takes 8-bit operands K-major only; w's
//      rows run along n) once on its way into shared memory: the block
//      transposes its whole (K, bn) slice before the loop, and the call
//      takes this loop only where that slice fits beside the ring.
//    - Two consumer warpgroups take alternate units whole, so that one
//      requantizes and stores while the other multiplies (a block left one
//      unit idles a warpgroup: conv5's 25 units a column); each runs
//      wgmma.mma_async m64nBNk32 .s32.s8.s8 on both 64-row halves from
//      shared memory, the int32 sums in registers (2 x BN / 2 a thread,
//      hence bn <= 128), one panel's group in flight while the next is
//      issued. Within each 32 columns, w's column 4c + q is staged as wgmma
//      column 8q + c, so that lane (g, t) ends with eight consecutive
//      output columns 8t..8t+7 of rows g and g + 8 (one 8-byte store each).
//      The requantization avoids the int/float conversions, which run at a
//      quarter of the rate (requant).
//    - The producer warpgroup drops to QMM_WG_PRODUCER_REGS registers a
//      thread and the consumers rise to QMM_WG_CONSUMER_REGS (setmaxnreg).
//    - Blocks persist, one an SM: block b takes column of tiles
//      b % tiles_n and every (blocks / tiles_n)-th unit of it, so its w and
//      bias slices are staged once, and the producer loads the next units
//      while the consumers requantize and store this one.
// 2. The mma.sync loop, qmm_kernel<WM, WN>, for every other call: blocks of
//    16 to 48 rows or wider than 128 columns, and grids that do not fill
//    the card (the batch-1 and prefill shapes: MobileLLM-125M's 64 x 576 x
//    1536 projection moves 1.0 MB, 0.3 us at 3.35 TB/s; what costs time is
//    the latency of a chain of k steps in few blocks).
//    - Each warp multiplies with mma.sync m16n8k32 (s8 in, s32 sum in
//      registers). A warp owns WM x WN fragments of 16 rows x 32 columns
//      (four n8 mma tiles each); make_plan picks WM, WN in {1, 2} so that a
//      block keeps at least four warps where its tile allows.
//    - Staging: each k step's x (bm, bk) and w (bk, bn) tiles are copied
//      with cp.async into a QMM_STAGES-deep ring; a thread issues all of
//      its copies of a stage before it waits. The copy width is 16 bytes
//      where a row's length and its tensor's address allow it, else 8 or 4
//      (make_plan: copy_width); a row length that is not a multiple of 4 is
//      staged by plain byte loads, four to a shared 32-bit store.
//    - The B operand: s8 mma takes B k-major, w's tile is n-major in shared
//      memory, and ldmatrix transposes only 16-bit elements. A lane reads
//      four 32-bit words, one from each of four k rows at the same four
//      columns, and transposes the 4 x 4 bytes with __byte_perm; mma tile q
//      computes the block's columns 4c + q, so lane (g, t) holds eight
//      consecutive output columns as above. Shared rows are padded by
//      QMM_ROW_PAD bytes and lanes with t >= 2 read their four rows in the
//      order 2, 3, 0, 1, so each load of a warp touches 32 banks.
//    - Few blocks, long K: the blocks of one output tile form a thread-block
//      cluster of C blocks, each taking a contiguous share of the k steps.
//      C starts at 1 and doubles while C < QMM_MAX_CLUSTER, the grid (tiles
//      * 2C) stays within QMM_FILL_CTAS (the card's 132 SMs) and each block
//      keeps at least QMM_MIN_STEPS k steps. The partial int32 tiles meet
//      in distributed shared memory, rank r summing the fragment groups r,
//      r + C, ... in rank order: int32 sums are exact, any split gives the
//      same bits.
//
// Shared memory (kernels/qmatmul/ops.py mirrors both: smem_bytes,
// wgmma_plan, and block_smem the loop a launch takes; plan mirrors
// make_plan, supports_block_shape the launch limits below): the mma.sync
// loop max(QMM_STAGES * (bm * (bk + 16) + bk * (bn + 16)), bm * bn * 4)
// bytes, the ring or, after it, the cluster's partial tile, nondecreasing
// in each block dim; the wgmma loop QMM_ALIGN + bias + barriers + resident
// w + re-laid x + stages * slot (make_wg_plan), its ring sized to the
// card's QMM_SMEM_LIMIT.
//
// The rescale is bit-exact with the JAX kernel: int32 add, conversion to
// f32 with round-to-nearest, one f32 multiply (a lone multiply; nothing to
// contract into an FMA), rintf (round half to even, as jnp.round; not
// roundf, which rounds half away from zero), clamp, int8. Build without
// --use_fast_math.
#include <cooperative_groups.h>

#include "mma.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

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
// the wgmma loop
constexpr int QMM_WG_ROWS = 64;          // rows of a consumer warpgroup
constexpr int QMM_WG_UNIT = 128;         // rows a ring slot holds: two's
constexpr int QMM_WG_MAX_N = 128;        // the widest block: two halves' sums
constexpr int QMM_WG_MIN_STAGES = 4;
constexpr int QMM_WG_MAX_STAGES = 32;
constexpr int QMM_WG_THREADS = 384;      // two consumer warpgroups, a producer
// Registers a thread after setmaxnreg: a sub-partition's 16384 hold its two
// consumer warps' and its producer warp's (2 * 232 + 40) * 32.
constexpr int QMM_WG_CONSUMER_REGS = 232;
constexpr int QMM_WG_PRODUCER_REGS = 40;
constexpr int QMM_ALIGN = 1024;          // a swizzled panel's alignment
constexpr int QMM_SMEM_LIMIT = 232448;   // a block's shared memory, opt-in

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

// The wgmma loop's layout (make_wg_plan), on = 0 where the call keeps the
// mma.sync loop. Sizes in bytes.
struct WgPlan {
  int on;
  int bulk;      // x by 1D bulk copies of whole units (K % 16 != 0)
  int panel;     // P: bytes of k a ring slot holds (32, 64 or 128)
  int kp;        // K padded to whole panels
  int units_m;   // units of QMM_WG_UNIT rows
  int stages;    // ring slots
  int blocks;    // persistent blocks
  int w_vec;     // w read 4 bytes at a time (N % 4 == 0, w aligned)
  int x_slot;    // one ring slot
  int a_bytes;   // 1D: the two warpgroups' re-laid units, 2 * 128 * kp
  int smem;      // dynamic shared memory the launch asks for
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

// Bytes of the wgmma loop's shared memory besides its ring, w and re-laid
// rows: the alignment slack, the block's bias slice, the ring's barriers.
__host__ inline long long wg_fixed(int bn) {
  return QMM_ALIGN + 4LL * bn +
         2 * QMM_WG_MAX_STAGES * (long long)sizeof(uint64_t);
}

// The wgmma loop takes the call where the block has one or two warpgroups
// of rows and bn is a legal wgmma n, x lies on the 16-byte grain TMA
// needs, the units fill the card and a persistent grid of at most
// QMM_FILL_CTAS blocks holds every column of tiles, and the block's (kp, bn)
// slice of w fits beside QMM_WG_MIN_STAGES ring slots. The loop stages x in
// units of QMM_WG_UNIT rows (a copy of 16 KB streams at near the HBM rate,
// one of 8 KB at two thirds of it) and P bytes of k (the least of 32, 64,
// 128 that holds K, else 128; re-laid x: K padded to 32 in the widest
// panels that tile it), whatever the block's bm (64 or 128) and bk; the
// ring takes the shared memory left.
__host__ inline WgPlan make_wg_plan(int M, int N, int K, int bm, int bn,
                                    const void* x, const void* w,
                                    const Plan& p) {
  WgPlan g{};
  g.units_m = (M + QMM_WG_UNIT - 1) / QMM_WG_UNIT;
  if (bm % QMM_WG_ROWS || bm > QMM_WG_UNIT || bn > QMM_WG_MAX_N ||
      (long long)g.units_m * p.tiles_n < QMM_FILL_CTAS ||
      p.tiles_n > QMM_FILL_CTAS || reinterpret_cast<uintptr_t>(x) % 16)
    return WgPlan{};
  g.bulk = K % 16 != 0;
  if (g.bulk) {  // re-laid whole: K to 32 bytes, in the widest panels that fit
    g.kp = (K + 31) / 32 * 32;
    g.panel = g.kp % 128 == 0 ? 128 : g.kp % 64 == 0 ? 64 : 32;
  } else {  // a slot a panel
    g.panel = K <= 32 ? 32 : K <= 64 ? 64 : 128;
    g.kp = (K + g.panel - 1) / g.panel * g.panel;
  }
  const long long x_slot =
      g.bulk ? ((long long)QMM_WG_UNIT * K + 32 + QMM_ALIGN - 1) / QMM_ALIGN *
                   QMM_ALIGN
             : (long long)QMM_WG_UNIT * g.panel;
  const long long a_bytes = g.bulk ? 2LL * QMM_WG_UNIT * g.kp : 0;
  const long long fixed = wg_fixed(bn) + (long long)g.kp * bn + a_bytes;
  const long long s = (QMM_SMEM_LIMIT - fixed) / x_slot;
  if (s < QMM_WG_MIN_STAGES) return WgPlan{};
  g.on = 1;
  // even: each consumer warpgroup owns every other slot (ring_item)
  g.stages = (s < QMM_WG_MAX_STAGES ? (int)s : QMM_WG_MAX_STAGES) & ~1;
  g.x_slot = (int)x_slot;
  g.a_bytes = (int)a_bytes;
  g.smem = (int)(fixed + g.stages * x_slot);
  g.blocks = QMM_FILL_CTAS / p.tiles_n * p.tiles_n;
  g.w_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  return g;
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
// whose int32 sums are v[0..7]; what lies past M or N is dropped. (A: either
// loop's arguments.)
template <class A>
__device__ inline void store8(const A& a, int row, int col,
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

// ---- the wgmma loop -------------------------------------------------------

namespace wgmma {

struct Args {
  CUtensorMap map;  // x as (K, M) bytes in boxes of (panel, unit): 2D path
  const int8_t* x;
  const int8_t* w;
  const int* bias;
  float scale;
  int8_t* out;
  int M, N, K, bn;
  int tiles_n;  // columns of tiles: block b takes column b % tiles_n
  WgPlan g;
};

// Four 32-bit words, rows r0..r3 of four bytes each, transposed: c[i] holds
// byte i of r0, r1, r2, r3 (in that order, low byte first).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// w[k, n..n+3] as one word, zeros past K or N.
__device__ __forceinline__ uint32_t w_word(const Args& a, int k, int n) {
  if (k >= a.K) return 0;
  const int8_t* s = a.w + (size_t)k * a.N + n;
  if (a.g.w_vec) return n < a.N ? __ldg(reinterpret_cast<const uint32_t*>(s))
                                 : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (n + b < a.N)
      v |= (uint32_t)(uint8_t)__ldg(s + b) << (8 * b);
  return v;
}

// w's rows [0, kp) of the block's columns [n0, n0 + bn), k-major into
// `dst` as swizzled panels of P bytes of k (panel j at j * bn * P), column
// 32G + 4c + q as row 32G + 8q + c, by the whole block. A thread takes 16
// rows of four columns at a time: 16 word loads, four 4 x 4 byte
// transposes, four 16-byte stores.
__device__ inline void stage_w(unsigned char* dst, const Args& a, int n0) {
  const int P = a.g.panel, cols4 = a.bn / 4, units = a.g.kp / 16 * cols4;
  for (int u = threadIdx.x; u < units; u += QMM_WG_THREADS) {
    const int kc = u / cols4, c4 = u - kc * cols4;
    uint32_t r[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      r[j] = w_word(a, 16 * kc + j, n0 + 4 * c4);
    uint32_t c[4][4];  // c[m][i]: column i's bytes of rows 4m..4m+3
#pragma unroll
    for (int m = 0; m < 4; ++m)
      transpose4(r[4 * m], r[4 * m + 1], r[4 * m + 2], r[4 * m + 3], c[m]);
    const int kl = 16 * kc;
    unsigned char* pd = dst + (size_t)(kl / P) * a.bn * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (c4 / 8) * 32 + 8 * i + c4 % 8;
      const uint32_t off = wg::swizzle(row * P + kl % P, P);
      *reinterpret_cast<uint4*>(pd + off) =
          make_uint4(c[0][i], c[1][i], c[2][i], c[3][i]);
    }
  }
}

// A consumer warpgroup re-lays a raw unit (row r at r * K bytes from
// `raw`) into swizzled panels of P bytes at `dst` (panel j at j * 128 * P),
// k past K as zeros. Thread lt of 128 takes row lt, a 16-byte chunk at a
// time: five aligned words, funnel-shifted.
__device__ inline void relayout(unsigned char* dst, const unsigned char* raw,
                                const Args& a, int lt) {
  const int P = a.g.panel, lp = 31 - __clz(P), K = a.K;
  const uint32_t base = (uint32_t)(lt * K);
  for (int k0 = 0; k0 < a.g.kp; k0 += 16) {
    uint32_t o[4] = {0, 0, 0, 0};
    if (k0 < K) {
      const uint32_t off = base + k0;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(raw + (off & ~3u));
      const uint32_t sh = (off & 3u) * 8;
      uint32_t v[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) v[i] = src[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(v[i], v[i + 1], sh);
      if (K - k0 < 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = K - k0 - 4 * i;
          o[i] = b >= 4 ? o[i] : b <= 0 ? 0u : o[i] & ((1u << (8 * b)) - 1);
        }
      }
    }
    const uint32_t d = (uint32_t)(k0 >> lp) * QMM_WG_UNIT * P +
                       wg::swizzle(lt * P + (k0 & (P - 1)), P);
    *reinterpret_cast<uint4*>(dst + d) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The ring's order: iteration `it` is k panel s of the block's unit u, or
// nothing (false). The two warpgroups' units 2i and 2i + 1 take turns
// panel by panel, so with an even number of slots each warpgroup owns
// every other slot and waits its own slots in order.
__device__ __forceinline__ bool ring_item(int it, int units, int steps,
                                          int& u, int& s) {
  const int q = it >> 1, pair = q / steps;
  s = q - pair * steps;
  u = 2 * pair + (it & 1);
  return u < units;
}

// The producer thread's copies of ring iteration `it` (k panel s of the
// block's unit u) into its slot, completing on full[slot].
__device__ inline void load_x(const Args& a, unsigned char* xring,
                              uint64_t* full, int it, int u, int s,
                              int m_first, int m_stride) {
  const WgPlan& g = a.g;
  const int slot = it % g.stages;
  const int m0 = (m_first + u * m_stride) * QMM_WG_UNIT;
  unsigned char* dst = xring + (size_t)slot * g.x_slot;
  if (!g.bulk) {
    wg::mbar_arrive_tx(&full[slot], (uint32_t)g.x_slot);
    wg::tma_load_2d(dst, &a.map, &full[slot], s * g.panel, m0);
    return;
  }
  const int rows = min(QMM_WG_UNIT, a.M - m0);
  const uint32_t bytes = (uint32_t)(rows * a.K), b16 = bytes & ~15u;
  const int8_t* src = a.x + (size_t)m0 * a.K;
  for (uint32_t i = b16; i < bytes; ++i)  // the tail a bulk copy cannot take
    dst[i] = (unsigned char)src[i];
  wg::mbar_arrive_tx(&full[slot], b16);
  if (b16) wg::bulk_load(dst, src, b16, &full[slot]);
}

// 2^23 + 2^22: a float whose low mantissa bits hold an integer added to it.
constexpr float QMM_MAGIC = 12582912.0f;
constexpr int QMM_MAGIC_BITS = 0x4B400000;

// The requantized int8 of an int32 sum, bit for bit the mma.sync loop's
// __int2float_rn, __fmul_rn, rintf, clamp, in full-rate instructions (the
// conversions run at a quarter of the rate and bound the epilogue): v as
// hi * 2^16 + lo, both exact in f32 through the magic constant, joined by
// one fma (one rounding: __int2float_rn's); the clamp before the rounding
// (rint and the clamp to [-128, 127] commute); the rounding to nearest even
// by adding and removing the magic constant, read back as an integer.
__device__ __forceinline__ uint32_t requant(int v, float scale) {
  const float hi = __int_as_float((v >> 16) + QMM_MAGIC_BITS) - QMM_MAGIC;
  const float lo = __int_as_float((v & 0xffff) + QMM_MAGIC_BITS) - QMM_MAGIC;
  const float f = __fmaf_rn(hi, 65536.0f, lo);
  const float c = fminf(fmaxf(__fmul_rn(f, scale), -128.0f), 127.0f);
  return (uint32_t)(__float_as_int(__fadd_rn(c, QMM_MAGIC)) - QMM_MAGIC_BITS) &
         0xffu;
}

// Requantize and store row `row`, columns col..col+7, from their int32 sums
// v and biases b; what lies past M or N is dropped.
__device__ inline void store_row8(const Args& a, int row, int col,
                                  const int (&v)[8], const int4 (&b)[2]) {
  if (row >= a.M) return;
  const int bias[8] = {b[0].x, b[0].y, b[0].z, b[0].w,
                       b[1].x, b[1].y, b[1].z, b[1].w};
  uint32_t packed[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    packed[e / 4] |= requant(v[e] + bias[e], a.scale) << (8 * (e % 4));
  int8_t* o = a.out + (size_t)row * a.N + col;
  if (col + 8 <= a.N && reinterpret_cast<uintptr_t>(o) % 8 == 0) {
    *reinterpret_cast<uint2*>(o) = make_uint2(packed[0], packed[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < a.N) o[e] = (int8_t)(packed[e / 4] >> (8 * (e % 4)));
}

// Warpgroup wgi (0, 1) takes the block's units wgi, wgi + 2, ... whole, as
// two 64-row halves, so that one requantizes and stores while the other
// multiplies; warpgroup 2 produces, from one thread.
// One block an SM. The producer warpgroup hands registers to the consumers
// (both halves' sums, 128 of them at bn 128, stay in registers).
template <int BN>
__global__ void __launch_bounds__(QMM_WG_THREADS, 1)
    qmm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgPlan& g = a.g;
  unsigned char* base =
      smem_raw + ((QMM_ALIGN - (wg::smem_u32(smem_raw) & (QMM_ALIGN - 1))) &
                  (QMM_ALIGN - 1));
  unsigned char* xring = base;
  unsigned char* wbuf = xring + (size_t)g.stages * g.x_slot;
  unsigned char* abuf = wbuf + (size_t)g.kp * a.bn;
  int* bias_s = reinterpret_cast<int*>(abuf + g.a_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + a.bn);
  uint64_t* empty = full + QMM_WG_MAX_STAGES;

  const int tid = threadIdx.x;
  constexpr int producer = 2 * 128;  // after the consumers
  const int P = g.panel, steps = g.bulk ? 1 : g.kp / P;
  const int n0 = blockIdx.x % a.tiles_n * a.bn;
  const int m_first = blockIdx.x / a.tiles_n;
  const int m_stride = gridDim.x / a.tiles_n;
  const int units = (g.units_m - m_first + m_stride - 1) / m_stride;
  const int total = (units + 1) / 2 * 2 * steps;

  if (tid == producer) {
    for (int s = 0; s < g.stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 128);  // every thread of its warpgroup
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  int issued = 0;
  if (tid == producer)  // the ring's first loads fly during the prologue
    for (; issued < min(g.stages, total); ++issued) {
      int u, s;
      if (ring_item(issued, units, steps, u, s))
        load_x(a, xring, full, issued, u, s, m_first, m_stride);
    }
  for (int i = tid; i < a.bn; i += QMM_WG_THREADS)
    bias_s[i] = n0 + i < a.N ? __ldg(a.bias + n0 + i) : 0;
  stage_w(wbuf, a, n0);
  wg::fence_async_shared();
  __syncthreads();

  if (tid >= producer) {
    wg::set_max_registers<false, QMM_WG_PRODUCER_REGS>();
    if (tid == producer)
      for (int it = issued; it < total; ++it) {
        int u, s;
        if (!ring_item(it, units, steps, u, s)) continue;
        const int slot = it % g.stages;
        wg::mbar_wait(&empty[slot], ((it / g.stages) & 1) ^ 1);
        load_x(a, xring, full, it, u, s, m_first, m_stride);
      }
    return;
  }

  wg::set_max_registers<true, QMM_WG_CONSUMER_REGS>();
  const int wgi = tid / 128, lt = tid % 128, lp = 31 - __clz(P);
  const uint32_t row_units = P / 16;  // descriptor units of one P-byte row
  constexpr int H = BN / 2;           // accumulators of one 64-row half
  unsigned char* at = abuf + (size_t)wgi * QMM_WG_UNIT * g.kp;
  int acc[2 * H];
  for (int u = wgi; u < units; u += 2) {
    const int m0 = (m_first + u * m_stride) * QMM_WG_UNIT;
    const int it0 = 2 * (u / 2 * steps) + wgi;  // ring_item's inverse
#pragma unroll
    for (int i = 0; i < 2 * H; ++i) acc[i] = 0;
    if (g.bulk) {
      const int slot = it0 % g.stages;
      wg::mbar_wait(&full[slot], (it0 / g.stages) & 1);
      relayout(at, xring + (size_t)slot * g.x_slot, a, lt);
      wg::fence_async_shared();
      wg::bar_sync(1 + wgi, 128);
      wg::mbar_arrive(&empty[slot]);
      wg::fence_operands<2 * H>(acc);
      wg::fence();
      for (int k = 0; k < g.kp; k += 32) {
        const int j = k >> lp, in = k & (P - 1);
        const unsigned char* xa = at + j * QMM_WG_UNIT * P + in;
        const uint64_t db = wg::desc(wbuf + j * a.bn * P + in, P);
        wg::mma<BN>(acc, wg::desc(xa, P), db, row_units);
        wg::mma<BN>(acc + H, wg::desc(xa + QMM_WG_ROWS * P, P), db,
                    row_units);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_operands<2 * H>(acc);
    } else {
      int prev = -1;
      for (int s = 0; s < steps; ++s) {
        const int it = it0 + 2 * s, slot = it % g.stages;
        wg::mbar_wait(&full[slot], (it / g.stages) & 1);
        const unsigned char* xs = xring + (size_t)slot * g.x_slot;
        const unsigned char* ws = wbuf + (size_t)s * a.bn * P;
        wg::fence_operands<2 * H>(acc);
        wg::fence();
        for (int in = 0; in < P; in += 32) {
          const uint64_t db = wg::desc(ws + in, P);
          wg::mma<BN>(acc, wg::desc(xs + in, P), db, row_units);
          wg::mma<BN>(acc + H, wg::desc(xs + QMM_WG_ROWS * P + in, P), db,
                      row_units);
        }
        wg::commit();
        if (prev >= 0) {  // the last group but one has read its slot
          wg::wait<1>();
          wg::mbar_arrive(&empty[prev]);
        }
        prev = slot;
      }
      wg::wait<0>();
      wg::fence_operands<2 * H>(acc);
      wg::mbar_arrive(&empty[prev]);
    }
    // lane (g, t) of warp v: rows 16v + g and + 8 of each half, columns
    // 32G + 8t.. of each 32 (w's column order above)
    const int lane = lt % 32, c8 = 8 * (lane % 4);
    const int row = m0 + lt / 32 * 16 + lane / 4;
#pragma unroll
    for (int G = 0; G < BN / 32; ++G) {
      const int4* bp = reinterpret_cast<const int4*>(bias_s + 32 * G + c8);
      const int4 b[2] = {bp[0], bp[1]};
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // half h / 2, rows + 8 (h % 2)
        const int* d = acc + (h / 2) * H + 16 * G + 2 * (h % 2);
        int v[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = d[4 * q];
          v[4 + q] = d[4 * q + 1];
        }
        store_row8(a, row + (h / 2) * QMM_WG_ROWS + 8 * (h % 2),
                   n0 + 32 * G + c8, v, b);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x (M, K) as a 2D tensor map whose boxes are (panel, QMM_WG_UNIT) bytes,
// swizzled as the panel's width.
cudaError_t encode_x(Args& a) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t strides[1] = {(cuuint64_t)a.K};
  const cuuint32_t box[2] = {(cuuint32_t)a.g.panel, QMM_WG_UNIT};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      a.g.panel == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : a.g.panel == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(&a.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<int8_t*>(a.x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
int run(Args& a, cudaStream_t stream) {
  cudaError_t err = tile::prepare_launch(qmm_kernel<BN>, a.g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.g.blocks);
  cfg.blockDim = dim3(QMM_WG_THREADS);
  cfg.dynamicSmemBytes = a.g.smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, qmm_kernel<BN>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

int launch(Args& a, cudaStream_t stream) {
  if (!a.g.bulk) {
    const cudaError_t err = encode_x(a);
    if (err != cudaSuccess) return (int)err;
  }
  switch (a.bn) {
    case 32: return run<32>(a, stream);
    case 64: return run<64>(a, stream);
    case 96: return run<96>(a, stream);
    default: return run<128>(a, stream);
  }
}

}  // namespace wgmma

}  // namespace

// x (M, K) int8, w (K, N) int8, bias (N,) int32, out (M, N) int8; all
// row-major and contiguous, any M, N, K >= 1; bm a multiple of 16, bn and
// bk of 32, bm * bn <= 16384, shared memory (qmm_smem_bytes) within the
// card's 227 KB. K is split over at most max_cluster blocks of a cluster
// (1 to QMM_MAX_CLUSTER; 1: never split, for measuring what the split buys
// and holding both sides of it); the cap does not move the choice of loop.
// *wgmma is set to 1 where the launch took the wgmma loop, else 0. Returns
// a cudaError_t.
extern "C" int qmatmul_launch_capped(const void* x, const void* w,
                                     const void* bias, float scale, void* out,
                                     int M, int N, int K, int bm, int bn,
                                     int bk, int max_cluster, void* stream,
                                     int* wgmma) {
  *wgmma = 0;
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
  const WgPlan g = make_wg_plan(M, N, K, bm, bn, x, w, a.p);
  if (g.on) {  // the loop reads only bn of the block
    wgmma::Args wa{};
    wa.x = a.x;
    wa.w = a.w;
    wa.bias = a.bias;
    wa.scale = scale;
    wa.out = a.out;
    wa.M = M, wa.N = N, wa.K = K, wa.bn = bn;
    wa.tiles_n = a.p.tiles_n;
    wa.g = g;
    *wgmma = 1;
    return wgmma::launch(wa, s);
  }
  if (a.p.wm == 2 && a.p.wn == 2) return run<2, 2>(a, s);
  if (a.p.wm == 2) return run<2, 1>(a, s);
  if (a.p.wn == 2) return run<1, 2>(a, s);
  return run<1, 1>(a, s);
}
