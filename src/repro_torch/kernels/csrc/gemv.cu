// Matrix-vector product for Hopper (sm_90a): out[n] = sum_k x[k] * w[k, n],
// f32 or bf16 operands, float32 output always (as the Pallas kernels).
//
// Replaces the two Pallas kernels of src/repro/kernels/gemv/kernel.py:
//   _gemv_kernel       -> gemv_kernel<T, V, true>:  every thread keeps its
//                         f32 sums in registers over all of its rows; one
//                         reduction across the block (and, for narrow n,
//                         across the blocks of a cluster) and one store per
//                         output column (Algorithm 1 at J = bn, VL = bk).
//   _gemv_noacc_kernel -> gemv_kernel<T, V, false>: the store-heavy form;
//                         every K step's partial is read, added and written
//                         back to the output in device memory.
//
// Operands are x (1, K) and w (K, N), both row-major (workload.py:
// example_inputs), so output column n reads w's column n with a stride of N
// elements. A block owns bn output columns.
//
// What bounds it on this card: bytes, and at the narrow projections of a
// batch-1 decode step the latency of device memory. The LM head of
// MobileLLM-125M (32000 x 576, bf16) reads a 36.9 MB weight for 36.9 MFLOP:
// 11 us at 3.35 TB/s. The 576-1536-wide projections read 0.7-1.8 MB, under
// half a microsecond at that rate, so there one round trip to device memory
// (about 0.6 us) per row, as a thread walking its rows one by one pays it,
// is the whole cost. What the design does about it:
//
// - Each thread owns V = 16 / sizeof(T) neighbouring columns (8 bf16, 4
//   f32) and reads them as one 16-byte load per row, read-only and not
//   allocated in L1 (w is read once). For bn >= 16, N and the block's first
//   column are multiples of V, so every such load is aligned. bn = 1 (the
//   paper's J = 1 row kernel) reads one element per row (V = 1): rows are
//   not 16-byte aligned for odd N.
// - A block always has GEMV_THREADS threads. CT = bn / V threads span the
//   columns, RT = GEMV_THREADS / CT (rounded down) thread rows split the k
//   rows; the threads beyond CT * RT load nothing.
// - Every thread issues GEMV_ROWS_IN_FLIGHT (R) independent loads of w (and
//   the R x values beside them) into registers before its first FMA, and the
//   next batch's loads before the reduction of the current one.
// - Reduction: each thread stores its V sums in shared memory, one barrier,
//   then S lanes of one warp sum each column (S the largest power of two up
//   to 32 with S * bn <= GEMV_THREADS) and finish with shuffles.
// - Narrow n (_gemv_kernel only): the blocks of one column block form a
//   thread-block cluster of C blocks, each taking pk / C contiguous rows.
//   C starts at 1 and doubles while C < GEMV_MAX_CLUSTER, the grid
//   (pn / bn) * C is below GEMV_FILL_CTAS (the card's 132 SMs), a thread
//   still has more than R rows (pk / C > R * RT) and pk % (2C) == 0. A
//   cluster costs more to launch and synchronise than one batch of loads,
//   so it only pays where it saves batches. The cluster's partial sums meet
//   through distributed shared memory, added in rank order: deterministic,
//   with no atomics and no workspace in device memory.
// - _gemv_noacc_kernel: the Pallas grid runs K outer, in order; thread
//   blocks do not run in order, so one block owns an output block and runs
//   every K step. It computes the partials of G steps at once, one group of
//   RG = RT / G thread rows per step, where G = RT * R / bk clamped to
//   [1, min(steps, RT)]. Then, for each step of the wave in k order, one
//   thread per column (the same thread every step) reads out[n] from device
//   memory, adds the step's partial and writes it back: exactly one global
//   read-add-write of the output block per K step, in k order, the first
//   step a plain store (the buffer comes from torch.empty). No atomics.
//
// Shared memory: two buffers of GEMV_THREADS * V floats, 16 KB for bf16,
// 8 KB for f32 and 2 KB for bn = 1 (kernels/gemv/ops.py: smem_bytes mirrors
// it, and every rule above is mirrored by ops.plan).
#include <cooperative_groups.h>

#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

using tile::to_f32;

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_ROWS_IN_FLIGHT = 8;
constexpr int GEMV_MAX_CLUSTER = 8;
constexpr int GEMV_FILL_CTAS = 132;
// A block's GEMV_THREADS threads cover at most GEMV_THREADS vectors of
// columns: 1024 f32 columns. bf16 is held to the same limit, so the launch
// gate needs no dtype (kernels/gemv/ops.py: MAX_BN mirrors it).
constexpr int GEMV_MAX_BN = 1024;

// The launch-time layout, computed once on the host (make_plan).
struct Plan {
  int ct;       // threads across the columns: bn / V
  int rt;       // thread rows: GEMV_THREADS / ct
  int s;        // lanes that sum one column in the reduction
  int g;        // k steps per wave (1 for _gemv_kernel)
  int rg;       // thread rows per step: rt / g
  int span;     // rows of one step: bk, or pk / cluster for _gemv_kernel
  int steps;    // steps in all: pk / bk, or 1 for _gemv_kernel
  int waves;    // ceil(steps / g)
  int nbatch;   // batches of R rows per thread and wave
  int cluster;  // blocks per cluster (1 for _gemv_noacc_kernel)
};

__host__ inline Plan make_plan(bool accumulate, int V, int N, int K, int bn,
                               int bk, int max_cluster) {
  Plan p{};
  p.ct = bn / V;
  p.rt = GEMV_THREADS / p.ct;
  p.s = 1;
  while (p.s < 32 && p.s * 2 * bn <= GEMV_THREADS) p.s *= 2;
  if (accumulate) {
    const int blocks = N / bn;
    const int rows_per_batch = GEMV_ROWS_IN_FLIGHT * p.rt;
    int c = 1;
    while (c < max_cluster && blocks * c < GEMV_FILL_CTAS &&
           K / c > rows_per_batch && K % (2 * c) == 0)
      c *= 2;
    p.cluster = c;
    p.span = K / c;
    p.steps = 1;
    p.g = 1;
  } else {
    p.cluster = 1;
    p.span = bk;
    p.steps = K / bk;
    const int most = p.steps < p.rt ? p.steps : p.rt;
    const int g = p.rt * GEMV_ROWS_IN_FLIGHT / bk;
    p.g = g < 1 ? 1 : (g > most ? most : g);
  }
  p.rg = p.rt / p.g;
  p.waves = (p.steps + p.g - 1) / p.g;
  const int per_batch = GEMV_ROWS_IN_FLIGHT * p.rg;
  p.nbatch = (p.span + per_batch - 1) / per_batch;
  return p;
}

// V neighbouring elements of one w row: one 16-byte load (V > 1) or one
// element (V = 1), and their float values.
template <typename T, int V> struct Lanes;

template <typename T> struct Lanes<T, 1> {
  using Raw = T;
  __device__ static Raw load(const T* p) { return __ldg(p); }
  __device__ static Raw zero() { return Raw(0.0f); }
  __device__ static void unpack(Raw r, float (&f)[1]) { f[0] = to_f32(r); }
};

__device__ inline uint4 load_stream_16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

template <> struct Lanes<float, 4> {
  using Raw = uint4;
  __device__ static Raw load(const float* p) { return load_stream_16(p); }
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static void unpack(Raw r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <> struct Lanes<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return load_stream_16(p);
  }
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  // A bf16 is the high half of the f32 with the same bits; the element at
  // the lower address is the low half of each 32-bit word.
  __device__ static void unpack(Raw r, float (&f)[8]) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// out[i] from device memory (L2, not a stale L1 line), plus v, stored back;
// or v stored alone on the first step. volatile keeps the compiler from
// forwarding the previous step's value instead of reading it.
__device__ inline void read_add_write(float* p, float v, bool first) {
  if (!first) {
    float old;
    asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(old) : "l"(p) : "memory");
    v += old;
  }
  asm volatile("st.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

template <typename T, int V, bool ACC>
__global__ void __launch_bounds__(GEMV_THREADS)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                float* __restrict__ out, int N, int bn, Plan p) {
  using L = Lanes<T, V>;
  constexpr int R = GEMV_ROWS_IN_FLIGHT;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int tx = t % p.ct, ty = t / p.ct;
  // thread row ty works on the step g of each wave, at offset rr in it
  const int g = ty / p.rg, rr = ty % p.rg;
  const bool active = g < p.g;  // implies ty < rt
  int rank = 0, blk = blockIdx.x;
  if (ACC && p.cluster > 1) {
    rank = (int)cg::this_cluster().block_rank();
    blk = blockIdx.x / p.cluster;
  }
  const int n0 = blk * bn;
  const T* wcol = w + n0 + tx * V;
  const int row0 = rank * p.span;  // 0 unless a cluster splits K

  typename L::Raw wv[R];
  float xv[R];
  // Batch `it` (wave it / nbatch, batch it % nbatch of the wave): R rows of
  // this thread, each 16 bytes of w (or one element) and one x value.
  auto load = [&](int it) {
    const int step = (it / p.nbatch) * p.g + g;
    const int b = it % p.nbatch;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int off = rr + (b * R + j) * p.rg;
      const bool ok = active && step < p.steps && off < p.span;
      const int row = row0 + step * p.span + off;
      wv[j] = ok ? L::load(wcol + (size_t)row * N) : L::zero();
      xv[j] = ok ? to_f32(__ldg(x + row)) : 0.0f;
    }
  };

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  const int total = p.waves * p.nbatch;
  load(0);
  for (int it = 0; it < total; ++it) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float f[V];
      L::unpack(wv[j], f);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(xv[j], f[v], acc[v]);
    }
    if (it + 1 < total) load(it + 1);  // in flight during the reduction
    if ((it + 1) % p.nbatch) continue;

    // The wave's last batch: its G partials of bn columns, in k order.
    // Two buffers: wave w + 2 writes buffer w & 1 only after every thread
    // passed wave w + 1's barrier, so after it read wave w's sums.
    const int wave = it / p.nbatch;
    float* red = smem + (wave & 1) * GEMV_THREADS * V;
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) red[ty * bn + tx * V + v] = acc[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    __syncthreads();
    const int cols_per_pass = GEMV_THREADS / p.s;
    const int lane = t % p.s;
    for (int gi = 0; gi < p.g; ++gi) {
      const int step = wave * p.g + gi;
      const float* rows = red + gi * p.rg * bn;
      // every thread runs every pass: the shuffles need whole warps
      for (int c0 = 0; c0 < bn; c0 += cols_per_pass) {
        const int col = c0 + t / p.s;
        float sum = 0.0f;
        if (col < bn)
          for (int r = lane; r < p.rg; r += p.s) sum += rows[r * bn + col];
        for (int o = p.s / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane || col >= bn || step >= p.steps) continue;
        if (!ACC)  // one read-add-write per K step, by the column's owner
          read_add_write(out + n0 + col, sum, step == 0);
        else if (p.cluster == 1)
          out[n0 + col] = sum;
        else  // the block's partial, for the cluster's sum
          smem[GEMV_THREADS * V + col] = sum;
      }
    }
  }

  if (ACC && p.cluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial is in its shared memory
    const float* part = smem + GEMV_THREADS * V;
    for (int col = t; col < bn; col += GEMV_THREADS) {
      if (col % p.cluster != rank) continue;
      float sum = 0.0f;
      for (int q = 0; q < p.cluster; ++q)  // rank order: deterministic
        sum += cluster.map_shared_rank(part, q)[col];
      out[n0 + col] = sum;
    }
    cluster.sync();  // no block leaves while another reads its memory
  }
}

template <typename T, int V, bool ACC>
int launch_plan(const void* x, const void* w, void* out, int N, int K,
                int bn, int bk, int max_cluster, cudaStream_t stream) {
  const Plan p = make_plan(ACC, V, N, K, bn, bk, max_cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / bn) * p.cluster);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.dynamicSmemBytes = 2 * GEMV_THREADS * V * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_kernel<T, V, ACC>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<float*>(out), N, bn, p);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch is not sticky
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(bool accumulate, const void* x, const void* w, void* out, int N,
           int K, int bn, int bk, int max_cluster, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  if (bn < 1 || bk < 1 || bn > GEMV_MAX_BN || N % bn || K % bk ||
      (bn > 1 && bn % VW) || max_cluster < 1 ||
      max_cluster > GEMV_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (bn > 1 && reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int c = max_cluster;
  if (bn == 1)
    return accumulate
               ? launch_plan<T, 1, true>(x, w, out, N, K, bn, bk, c, stream)
               : launch_plan<T, 1, false>(x, w, out, N, K, bn, bk, c, stream);
  return accumulate
             ? launch_plan<T, VW, true>(x, w, out, N, K, bn, bk, c, stream)
             : launch_plan<T, VW, false>(x, w, out, N, K, bn, bk, c, stream);
}

}  // namespace

// gemv_launch with the cluster capped at max_cluster blocks (1 to 8; 1:
// K is never split across blocks), for measuring what the cluster buys.
extern "C" int gemv_launch_capped(int accumulate, int dtype, const void* x,
                                  const void* w, void* out, int N, int K,
                                  int bn, int bk, int max_cluster,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(accumulate, x, w, out, N, K, bn, bk, max_cluster,
                           s);
    case 1:
      return launch<__nv_bfloat16>(accumulate, x, w, out, N, K, bn, bk,
                                   max_cluster, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16. x (1, K), w (K, N) row-major and
// contiguous, w 16-byte aligned, out (1, N) float32; N and K multiples of
// bn and bk, bn 1 or a multiple of 16 / sizeof(dtype), at most 1024.
// Returns a cudaError_t.
extern "C" int gemv_launch(int accumulate, int dtype, const void* x,
                           const void* w, void* out, int N, int K, int bn,
                           int bk, void* stream) {
  return gemv_launch_capped(accumulate, dtype, x, w, out, N, K, bn, bk,
                            GEMV_MAX_CLUSTER, stream);
}
