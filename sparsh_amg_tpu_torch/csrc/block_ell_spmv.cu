// Block SpMV over a node pattern (block-ELL), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparsh_amg_tpu/ops/block_gell.py::
// block_gell_pallas and the reduction of its streams in
// BlockGellMatrix.spmv.  A dof-interleaved systems matrix with BS dofs per
// node is stored as K slots per node row, each slot a dense BS x BS block:
//
//   cols (K, nb) int32      node column of slot k of node row i
//                           (padding slots: col 0, zero block)
//   vals (K, BS, n_pad)     vals[k, d, BS*i + c] = A[BS*i + c, BS*cols[k,i] + d]
//   lens (nb,) int32        node row lengths
//
//   y[t] = sum_{k < lens[t/BS]} sum_d vals[k, d, t] * x[BS*cols[k, t/BS] + d]
//   y[t] = 0                                               (n <= t < n_pad)
//
// The TPU kernel gathered from de-interleaved source planes through
// window tables in SMEM, because Mosaic has no general gather; a Hopper
// thread gathers from any address, so x and y stay dof-interleaved and
// the layout is plain ELL over nodes.
//
// What bounds it: bytes -- 4 or 2 B per value, 4 B per node slot, against
// 2 flops per value -- on the fine elasticity level (70 MB), and the
// latency of a few dependent loads (length, column, x) on coarse levels
// of a few thousand node rows, whose bytes take under a microsecond.
// Three launch shapes, picked by the wrapper (ops/split_rows.py::
// choose_block) from an H100 sweep (scripts/torch_split_sweep.py's
// block cases, PERF.md):
//  * dof rows, one thread each (levels whose rows fill a quarter of the
//    card, K <= 16): a warp reads slot k of 32 neighbouring dof rows, 128
//    coalesced bytes of a value plane, and the BS lanes of a node share
//    their column and x loads in one instruction;
//  * split dof rows (split_rows.cuh; levels that leave most of the card
//    idle, short rows included; node groups measured slower there): G
//    lanes of a block and S blocks of a cluster share each dof row's
//    node slots, so a row is a few loads deep, and the partials are
//    added in a fixed order.
//    Both dof-row launches sum the first kHead slots whatever the row's
//    length (padding adds zero blocks), so tables of K <= kHead never read
//    lens, and on longer ones its load is in flight behind the head;
//  * node groups (levels whose rows fill a quarter of the card and hold
//    more than kHead slots: the fine elasticity level): a thread serves W
//    consecutive node rows, all BS of their dof rows, W = 4 fp32 or 8
//    bf16 so that each value plane's W*BS entries come in 16-byte loads,
//    and T lanes (inside one warp) share the group's slots, lane t taking
//    slots t, t + T, ...  Per slot a lane loads the W node columns once
//    and the BS x entries of each node once, and has BS*BS*W values in
//    flight.  Values and columns stream with evict-first loads, so that
//    x stays in L2 (the fine level's tables outgrow L2).  The T lanes'
//    partials are added by a fixed xor butterfly of shuffles (the same
//    bits on every lane and in every launch; no atomics), and lane t
//    stores outputs t, t + T, ...
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "split_rows.cuh"

namespace {

constexpr int kRowThreads = 128;             // one thread per dof row
constexpr long long kMaxRowBlocks = 132 * 32;
constexpr int kGroupThreads = 256;           // node groups
constexpr int kHead = 16;  // slots summed whatever a row's length

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One thread per dof row, a grid-stride loop over [0, n_pad); slots
// unrolled 4 deep.
template <typename ValT, int BS>
__global__ void __launch_bounds__(kRowThreads)
block_ell_rows(const int* __restrict__ cols, const ValT* __restrict__ vals,
               const int* __restrict__ lens, int kn, int n, int n_pad,
               const float* __restrict__ x, float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t nb = n / BS;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int head = kn > kHead ? kHead : kn;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < np;
       t += stride) {
    float acc = 0.f;
    if (t < n) {
      const int len = kn > kHead ? lens[t / BS] : kn;
      const int* ci = cols + t / BS;
      const ValT* vt = vals + t;
      int k = 0;
#pragma unroll 4
      for (; k < head; ++k) {
        const float* xj = x + (int64_t)BS * ci[k * nb];
        const ValT* vk = vt + k * BS * np;
#pragma unroll
        for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
      }
#pragma unroll 4
      for (; k < len; ++k) {
        const float* xj = x + (int64_t)BS * ci[k * nb];
        const ValT* vk = vt + k * BS * np;
#pragma unroll
        for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
      }
    }
    y[t] = acc;
  }
}

// G lanes and S cluster blocks per dof row (split_rows.cuh's grid):
// thread (row t, lane q) sums slots q, q + P, ... (P = G * S) of the
// head, then up to the row's length, unrolled 2 deep under the launch's
// 64 registers a thread.
template <typename ValT, int BS>
__global__ void __launch_bounds__(split::kRows * split::kMaxLanes)
block_ell_split(const int* __restrict__ cols, const ValT* __restrict__ vals,
                const int* __restrict__ lens, int kn, int n, int n_pad,
                const float* __restrict__ x, float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t nb = n / BS;
  const int64_t t = (int64_t)blockIdx.y * split::kRows + threadIdx.x;
  const int stride = split::slot_stride();
  const int head = kn > kHead ? kHead : kn;
  float acc = 0.f;
  if (t < n) {
    const int len = kn > kHead ? lens[t / BS] : kn;
    const int* ci = cols + t / BS;
    const ValT* vt = vals + t;
    int k = split::first_slot();
#pragma unroll 2
    for (; k < head; k += stride) {
      const float* xj = x + (int64_t)BS * ci[k * nb];
      const ValT* vk = vt + k * BS * np;
#pragma unroll
      for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
    }
#pragma unroll 2
    for (; k < len; k += stride) {
      const float* xj = x + (int64_t)BS * ci[k * nb];
      const ValT* vk = vt + k * BS * np;
#pragma unroll
      for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
    }
  }
  split::reduce_store(acc, t, n, np, y);
}

// v[0, N) = p[0, N), N consecutive values in 16-byte words (p aligned),
// evict-first.
template <typename ValT, int N>
__device__ __forceinline__ void load_run(const ValT* __restrict__ p,
                                         float (&v)[N]) {
  constexpr int per = 16 / (int)sizeof(ValT);
  static_assert(N % per == 0, "a run of whole 16-byte words");
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < N / per; ++i) {
    const uint4 w = __ldcs(q + i);
    ValT e[per];
    memcpy(e, &w, sizeof w);
#pragma unroll
    for (int j = 0; j < per; ++j) v[i * per + j] = to_f32(e[j]);
  }
}

// The first m < N values of a run, one evict-first load each (the last
// group).
template <typename ValT, int N>
__device__ __forceinline__ void load_part(const ValT* __restrict__ p,
                                          float (&v)[N], int m) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = i < m ? to_f32(__ldcs(p + i)) : 0.f;
}

// Slot k of a group of W node rows from node0 (live nodes: m; FULL when
// m == W): acc[w*BS + c] += sum_d vals[k, d, BS*(node0 + w) + c] *
// x[BS*cols[k, node0 + w] + d].
template <typename ValT, int BS, int W, bool FULL>
__device__ __forceinline__ void group_slot(const int* __restrict__ cols,
                                           const ValT* __restrict__ vals,
                                           int64_t nb, int64_t np,
                                           int64_t node0, int m, int k,
                                           const float* __restrict__ x,
                                           float (&acc)[W * BS]) {
  const int* ck = cols + (int64_t)k * nb + node0;
  int c[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    c[w] = (FULL || w < m) ? __ldcs(ck + w) : 0;
  const ValT* vk = vals + (int64_t)k * BS * np + node0 * BS;
#pragma unroll
  for (int d = 0; d < BS; ++d) {
    float v[W * BS];
    if constexpr (FULL)
      load_run<ValT, W * BS>(vk + d * np, v);
    else
      load_part<ValT, W * BS>(vk + d * np, v, m * BS);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float xv = __ldg(x + (int64_t)BS * c[w] + d);
#pragma unroll
      for (int r = 0; r < BS; ++r)
        acc[w * BS + r] = fmaf(v[w * BS + r], xv, acc[w * BS + r]);
    }
  }
}

// Lane t's slots t, t + T, ... of the group: the head, then up to the
// group's longest node row.
template <typename ValT, int BS, int W, bool FULL>
__device__ __forceinline__ void group_sum(const int* __restrict__ cols,
                                          const ValT* __restrict__ vals,
                                          const int* __restrict__ lens,
                                          int kn, int64_t nb, int64_t np,
                                          int64_t node0, int m, int t,
                                          int lanes,
                                          const float* __restrict__ x,
                                          float (&acc)[W * BS]) {
  int len = kn;
  if (kn > kHead) {  // in flight behind the head
    len = 0;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (FULL || w < m) len = max(len, __ldg(lens + node0 + w));
  }
  const int head = kn > kHead ? kHead : kn;
  int k = t;
#pragma unroll 2
  for (; k < head; k += lanes)
    group_slot<ValT, BS, W, FULL>(cols, vals, nb, np, node0, m, k, x, acc);
#pragma unroll 2
  for (; k < len; k += lanes)
    group_slot<ValT, BS, W, FULL>(cols, vals, nb, np, node0, m, k, x, acc);
}

// One group of W node rows per T lanes (lanes = T, a power of two <= 32).
// Every thread of the grid reaches the shuffles: groups past the last
// node add zeros.
template <typename ValT, int BS, int W>
__global__ void __launch_bounds__(kGroupThreads)
block_ell_groups(const int* __restrict__ cols, const ValT* __restrict__ vals,
                 const int* __restrict__ lens, int kn, int n, int n_pad,
                 int lanes, const float* __restrict__ x,
                 float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t nb = n / BS;
  const int64_t gid = (int64_t)blockIdx.x * kGroupThreads + threadIdx.x;
  const int t = (int)(gid & (lanes - 1));
  const int64_t node0 = gid / lanes * W;
  const int m = node0 >= nb ? 0 : nb - node0 < W ? (int)(nb - node0) : W;
  float acc[W * BS];
#pragma unroll
  for (int j = 0; j < W * BS; ++j) acc[j] = 0.f;
  if (m == W)
    group_sum<ValT, BS, W, true>(cols, vals, lens, kn, nb, np, node0, m, t,
                                 lanes, x, acc);
  else if (m > 0)
    group_sum<ValT, BS, W, false>(cols, vals, lens, kn, nb, np, node0, m, t,
                                  lanes, x, acc);
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < W * BS; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
#pragma unroll
  for (int j = 0; j < W * BS; ++j)
    if ((j & (lanes - 1)) == t && j < m * BS) y[node0 * BS + j] = acc[j];
  // the padding rows y[n, n_pad)
  const int64_t stride = (int64_t)gridDim.x * kGroupThreads;
  for (int64_t i = n + gid; i < np; i += stride) y[i] = 0.f;
}

template <typename ValT, int BS, int W>
int launch_groups(const int* cols, const ValT* vals, const int* lens,
                  int kn, int n, int n_pad, int lanes, const float* x,
                  float* y, cudaStream_t s) {
  const int64_t groups = (n / BS + W - 1) / W;
  int64_t blocks = (groups * lanes + kGroupThreads - 1) / kGroupThreads;
  if (blocks < 1) blocks = 1;  // y's padding rows alone
  block_ell_groups<ValT, BS, W>
      <<<(unsigned)blocks, kGroupThreads, 0, s>>>(cols, vals, lens, kn, n,
                                                  n_pad, lanes, x, y);
  return (int)cudaGetLastError();
}

// W = 1: dof rows (G x S = 1: one thread each; else split); W = the
// 16-byte group of the value type (4 fp32, 8 bf16 nodes): node groups of
// T lanes.
template <typename ValT, int BS>
int launch_bs(const int* cols, const ValT* vals, const int* lens, int kn,
              int n, int n_pad, int nodes, int lanes, int g, int cluster,
              const float* x, float* y, cudaStream_t s) {
  constexpr int kWide = 16 / (int)sizeof(ValT);
  if (nodes == kWide && g * cluster == 1)
    return launch_groups<ValT, BS, kWide>(cols, vals, lens, kn, n, n_pad,
                                          lanes, x, y, s);
  if (nodes != 1 || lanes != 1) return (int)cudaErrorInvalidValue;
  if (g * cluster > 1 && n > 0)
    return split::launch(block_ell_split<ValT, BS>, g, cluster, n, s, cols,
                         vals, lens, kn, n, n_pad, x, y);
  long long blocks = ((long long)n_pad + kRowThreads - 1) / kRowThreads;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  block_ell_rows<ValT, BS><<<(unsigned)blocks, kRowThreads, 0, s>>>(
      cols, vals, lens, kn, n, n_pad, x, y);
  return (int)cudaGetLastError();
}

template <typename ValT>
int launch(int bs, const int* cols, const ValT* vals, const int* lens, int kn,
           int n, int n_pad, int nodes, int lanes, int g, int cluster,
           const float* x, float* y, cudaStream_t s) {
#define BLOCK_BS(BS)                                                     \
  case BS:                                                               \
    return launch_bs<ValT, BS>(cols, vals, lens, kn, n, n_pad, nodes,    \
                               lanes, g, cluster, x, y, s);
  switch (bs) { BLOCK_BS(2) BLOCK_BS(3) BLOCK_BS(4) BLOCK_BS(5) BLOCK_BS(6) }
#undef BLOCK_BS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.  bs in 2..6; n = bs * nb
// dof rows, n <= n_pad, n_pad a multiple of 8 and vals 16-byte aligned;
// lens[i] <= kn.  From the wrapper's chooser: nodes (W) and lanes (T)
// -- W = T = 1 for dof rows, over g lanes of a block and cluster blocks
// (g = cluster = 1: one thread each); W = 4 fp32 / 8 bf16 for node groups
// of T = 1, 2, 4, ..., 32 lanes.
extern "C" int block_ell_spmv_launch(int val_bf16, int bs, const int* cols,
                                     const void* vals, const int* lens,
                                     int kn, int n, int n_pad, int nodes,
                                     int lanes, int g, int cluster,
                                     const float* x, float* y,
                                     void* stream_handle) {
  if (kn < 1 || bs < 2 || bs > 6 || n < 0 || n % bs || n > n_pad ||
      n_pad % 8 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      g < 1 || cluster < 1 || (reinterpret_cast<uintptr_t>(vals) & 15))
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream_handle);
  if (val_bf16)
    return launch(bs, cols, static_cast<const __nv_bfloat16*>(vals), lens,
                  kn, n, n_pad, nodes, lanes, g, cluster, x, y, s);
  return launch(bs, cols, static_cast<const float*>(vals), lens, kn, n,
                n_pad, nodes, lanes, g, cluster, x, y, s);
}
