// Irregular SpMV on transposed ELLPACK (ELL-T), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparsh_amg_tpu/ops/gell.py::
// gell_gather_pallas and the row reduction that follows it
// (_spmv_pallas_reduced, GellMatrix.spmv, SplitGell.spmv):
//
//   y[i] = sum_{k < lens[i]} vals[k, i] * x[cols[k, i]]
//
// over cols (K, n_pad) int32, vals (K, n_pad) fp32 or bf16, lens (n_pad,)
// int32, the row lengths (0 on padding rows).  Slots past a row's length
// hold val 0, col 0, so stopping there gives the same sum for finite x.
// The TPU kernel needed window tables, 16-bit index packing and SMEM
// chunking because Mosaic has no general gather; a Hopper thread gathers
// from any address, so the layout is plain ELL-T.
//
// Two launch shapes, picked by the wrapper from (rows, K):
//  * one thread per row (G = S = 1; levels with hundreds of thousands of
//    rows, which fill the card alone): a grid-stride loop, slots summed
//    in k order in fp32, the cols and vals streams read coalesced.  The
//    first kHead slots are summed whatever the row's length (padding adds
//    0 * x[0]), so the load of lens[i] is in flight behind them rather
//    than ahead of every slot, and tables of K <= kHead never read lens.
//    Past the head a warp walks to its longest row, each lane loading
//    only its own slots: the loop stays uniform (unrolled, converged)
//    while a warp of short rows stops early;
//  * split rows (split_rows.cuh; SA transfers with a few thousand rows of
//    hundreds to thousands of slots): G lanes of a block and S blocks of a
//    cluster share each row's slots, so ~G*S times more loads are in
//    flight, and the partial sums are added in a fixed order.
// Either way each row stops at its own length, so the padding of short
// rows to K (and padding rows) costs no table bytes.
//
// What bounds it: bytes -- 6 or 8 B per real slot plus the gathered x
// entries (2 flops per slot).  Split rows remove the latency bound of K
// dependent steps per thread; what is left is the gather's locality and,
// at a few thousand rows, the launch and the cross-lane reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "split_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr int kHead = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
// the longest length among the 32 lanes of the warp (all must call it)
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename ValT>
__global__ void __launch_bounds__(kThreads)
ell_spmv(const int* __restrict__ cols, const ValT* __restrict__ vals,
         const int* __restrict__ lens, int k, int n_pad,
         const float* __restrict__ x, float* __restrict__ y) {
  const int64_t n = n_pad;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;  // warps whole
  const int lane = threadIdx.x & 31;
  // w: the warp's first row, so every lane of a warp runs every trip
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       w < n; w += stride) {
    const int64_t i = w + lane;
    const bool live = i < n;
    const int head = k > kHead ? kHead : k;
    const int len = !live ? 0 : k > kHead ? lens[i] : k;
    float acc = 0.f;
    if (live) {
      for (int s = 0; s < head; ++s) {
        const int64_t p = s * n + i;
        acc += to_f32(vals[p]) * x[cols[p]];
      }
    }
    const int warp_len = k > kHead ? warp_max(len) : k;
    for (int s = head; s < warp_len; ++s) {
      const int64_t p = s * n + i;
      if (s < len) acc += to_f32(vals[p]) * x[cols[p]];
    }
    if (live) y[i] = acc;
  }
}

template <typename ValT>
__global__ void __launch_bounds__(split::kRows * split::kMaxLanes)
ell_spmv_split(const int* __restrict__ cols, const ValT* __restrict__ vals,
               const int* __restrict__ lens, int n_rows, int n_pad,
               const float* __restrict__ x, float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t i = (int64_t)blockIdx.y * split::kRows + threadIdx.x;
  const int stride = split::slot_stride();
  float acc = 0.f;
  if (i < n_rows) {
    const int len = lens[i];
    const int* ci = cols + i;
    const ValT* vi = vals + i;
#pragma unroll 4
    for (int k = split::first_slot(); k < len; k += stride)
      acc += to_f32(vi[k * np]) * x[ci[k * np]];
  }
  split::reduce_store(acc, i, n_rows, np, y);
}

template <typename ValT>
int launch(const int* cols, const ValT* vals, const int* lens, int k,
           int n_rows, int n_pad, int lanes, int cluster, const float* x,
           float* y, cudaStream_t s) {
  if (lanes * cluster > 1 && n_rows > 0)
    return split::launch(ell_spmv_split<ValT>, lanes, cluster, n_rows, s,
                         cols, vals, lens, n_rows, n_pad, x, y);
  long long blocks = ((long long)n_pad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ell_spmv<ValT><<<(unsigned)blocks, kThreads, 0, s>>>(cols, vals, lens, k,
                                                        n_pad, x, y);
  return (int)cudaGetLastError();
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.  lens[i] <= k for i < n_rows
// and 0 for n_rows <= i < n_pad.  lanes (G) and cluster (S) from the
// wrapper's chooser; G = S = 1 is one thread per row.
extern "C" int ell_spmv_launch(int val_bf16, const int* cols,
                               const void* vals, const int* lens, int k,
                               int n_rows, int n_pad, int lanes, int cluster,
                               const float* x, float* y, void* stream) {
  if (k < 1 || n_pad < 0 || n_rows < 0 || n_rows > n_pad)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    return launch(cols, static_cast<const __nv_bfloat16*>(vals), lens, k,
                  n_rows, n_pad, lanes, cluster, x, y, s);
  return launch(cols, static_cast<const float*>(vals), lens, k, n_rows,
                n_pad, lanes, cluster, x, y, s);
}
