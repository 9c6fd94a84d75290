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
//
//   y[t] = sum_k sum_d vals[k, d, t] * x[BS*cols[k, t / BS] + d]   (t < n)
//   y[t] = 0                                                        (t >= n)
//
// The TPU kernel gathered from de-interleaved source planes through
// window tables in SMEM, because Mosaic has no general gather; a Hopper
// thread gathers from any address, so x and y stay dof-interleaved and
// the layout is plain ELL over nodes.  One thread per dof row, over a
// grid-stride loop: the vals planes are read coalesced, the BS threads of
// a node share their cols reads (one broadcast), and each slot reads BS
// neighbouring x entries.  Sums run over k, then d, in fp32.
//
// What bounds it: on long, wide levels (the fine elasticity operator,
// K = 27) bytes -- 4 or 2 B per value, 4 B per node slot, against 2 flops
// per value.  On short levels with long node rows (an SA coarse level:
// 4,620 dof rows of K = 431 slots) too few threads are live to cover the
// latency of each thread's K dependent steps (cols load, then the x
// gather); the k loop is unrolled 4 ways so loads of later slots are in
// flight while earlier ones are summed.  A warp per node row, or split
// rows, is the remedy there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxBlocks = 132 * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename ValT, int BS>
__global__ void __launch_bounds__(kThreads)
block_ell_spmv(const int* __restrict__ cols, const ValT* __restrict__ vals,
               int kn, int n, int n_pad, const float* __restrict__ x,
               float* __restrict__ y) {
  const int64_t np = n_pad;
  const int64_t nb = n / BS;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < np;
       t += stride) {
    float acc = 0.f;
    if (t < n) {
      const int* ci = cols + t / BS;
      const ValT* vt = vals + t;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float* xj = x + (int64_t)BS * ci[k * nb];
        const ValT* vk = vt + k * BS * np;
#pragma unroll
        for (int d = 0; d < BS; ++d) acc += to_f32(vk[d * np]) * xj[d];
      }
    }
    y[t] = acc;
  }
}

template <typename ValT>
int launch(int bs, const int* cols, const ValT* vals, int kn, int n,
           int n_pad, const float* x, float* y, cudaStream_t s) {
  long long blocks = ((long long)n_pad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  switch (bs) {
    case 2:
      block_ell_spmv<ValT, 2><<<grid, block, 0, s>>>(cols, vals, kn, n,
                                                      n_pad, x, y);
      break;
    case 3:
      block_ell_spmv<ValT, 3><<<grid, block, 0, s>>>(cols, vals, kn, n,
                                                      n_pad, x, y);
      break;
    case 4:
      block_ell_spmv<ValT, 4><<<grid, block, 0, s>>>(cols, vals, kn, n,
                                                      n_pad, x, y);
      break;
    case 5:
      block_ell_spmv<ValT, 5><<<grid, block, 0, s>>>(cols, vals, kn, n,
                                                      n_pad, x, y);
      break;
    case 6:
      block_ell_spmv<ValT, 6><<<grid, block, 0, s>>>(cols, vals, kn, n,
                                                      n_pad, x, y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.  bs in 2..6; n = bs * nb
// dof rows, n <= n_pad.
extern "C" int block_ell_spmv_launch(int val_bf16, int bs, const int* cols,
                                     const void* vals, int kn, int n,
                                     int n_pad, const float* x, float* y,
                                     void* stream) {
  if (kn < 1 || bs < 2 || bs > 6 || n < 0 || n % bs || n > n_pad)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    return launch(bs, cols, static_cast<const __nv_bfloat16*>(vals), kn, n,
                  n_pad, x, y, s);
  return launch(bs, cols, static_cast<const float*>(vals), kn, n, n_pad, x,
                y, s);
}
