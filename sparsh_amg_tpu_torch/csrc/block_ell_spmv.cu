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
// the layout is plain ELL over nodes.  Each dof row stops at its node
// row's length.  Two launch shapes, picked by the wrapper from (rows, K):
//  * one thread per dof row (G = S = 1; the fine elasticity operator, K =
//    27, and other levels whose rows fill the card): a grid-stride loop,
//    the vals planes read coalesced, the BS threads of a node sharing
//    their cols reads, sums over k, then d, in fp32.  The first kHead node
//    slots are summed whatever the row's length (padding adds zero
//    blocks), so the load of the length is in flight behind them, and
//    tables of K <= kHead never read lens; then each lane stops at its own
//    length (the node rows of such levels are of near-equal length);
//  * split rows (split_rows.cuh; SA coarse levels: a few thousand dof
//    rows of hundreds of node slots): G lanes and S clustered blocks share
//    each dof row's node slots, and the partials are added in a fixed
//    order.
//
// What bounds it: bytes -- 4 or 2 B per value, 4 B per node slot, against
// 2 flops per value.  Split rows remove the latency of K dependent steps
// per thread on short levels; ptxas keeps the BS-way inner loop in
// registers (BS is a template parameter).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "split_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxBlocks = 132 * 32;
constexpr int kHead = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename ValT, int BS>
__global__ void __launch_bounds__(kThreads)
block_ell_spmv(const int* __restrict__ cols, const ValT* __restrict__ vals,
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

template <typename ValT, int BS>
__global__ void __launch_bounds__(split::kRows * split::kMaxLanes)
block_ell_spmv_split(const int* __restrict__ cols,
                     const ValT* __restrict__ vals,
                     const int* __restrict__ lens, int n, int n_pad,
                     const float* __restrict__ x, float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t nb = n / BS;
  const int64_t t = (int64_t)blockIdx.y * split::kRows + threadIdx.x;
  const int stride = split::slot_stride();
  float acc = 0.f;
  if (t < n) {
    const int len = lens[t / BS];
    const int* ci = cols + t / BS;
    const ValT* vt = vals + t;
#pragma unroll 2
    for (int k = split::first_slot(); k < len; k += stride) {
      const float* xj = x + (int64_t)BS * ci[k * nb];
      const ValT* vk = vt + k * BS * np;
#pragma unroll
      for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
    }
  }
  split::reduce_store(acc, t, n, np, y);
}

template <typename ValT, int BS>
int launch_bs(const int* cols, const ValT* vals, const int* lens, int kn,
              int n, int n_pad, int lanes, int cluster, const float* x,
              float* y, cudaStream_t s) {
  if (lanes * cluster > 1 && n > 0)
    return split::launch(block_ell_spmv_split<ValT, BS>, lanes, cluster, n,
                         s, cols, vals, lens, n, n_pad, x, y);
  long long blocks = ((long long)n_pad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  block_ell_spmv<ValT, BS><<<(unsigned)blocks, kThreads, 0, s>>>(
      cols, vals, lens, kn, n, n_pad, x, y);
  return (int)cudaGetLastError();
}

template <typename ValT>
int launch(int bs, const int* cols, const ValT* vals, const int* lens, int kn,
           int n, int n_pad, int lanes, int cluster, const float* x, float* y,
           cudaStream_t s) {
  switch (bs) {
    case 2:
      return launch_bs<ValT, 2>(cols, vals, lens, kn, n, n_pad, lanes,
                                cluster, x, y, s);
    case 3:
      return launch_bs<ValT, 3>(cols, vals, lens, kn, n, n_pad, lanes,
                                cluster, x, y, s);
    case 4:
      return launch_bs<ValT, 4>(cols, vals, lens, kn, n, n_pad, lanes,
                                cluster, x, y, s);
    case 5:
      return launch_bs<ValT, 5>(cols, vals, lens, kn, n, n_pad, lanes,
                                cluster, x, y, s);
    case 6:
      return launch_bs<ValT, 6>(cols, vals, lens, kn, n, n_pad, lanes,
                                cluster, x, y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.  bs in 2..6; n = bs * nb
// dof rows, n <= n_pad; lens[i] <= kn.  lanes (G) and cluster (S) from
// the wrapper's chooser; G = S = 1 is one thread per dof row.
extern "C" int block_ell_spmv_launch(int val_bf16, int bs, const int* cols,
                                     const void* vals, const int* lens,
                                     int kn, int n, int n_pad, int lanes,
                                     int cluster, const float* x, float* y,
                                     void* stream) {
  if (kn < 1 || bs < 2 || bs > 6 || n < 0 || n % bs || n > n_pad)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    return launch(bs, cols, static_cast<const __nv_bfloat16*>(vals), lens,
                  kn, n, n_pad, lanes, cluster, x, y, s);
  return launch(bs, cols, static_cast<const float*>(vals), lens, kn, n,
                n_pad, lanes, cluster, x, y, s);
}
