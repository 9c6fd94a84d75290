// Irregular SpMV on transposed ELLPACK (ELL-T), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparsh_amg_tpu/ops/gell.py::
// gell_gather_pallas and the row reduction that follows it
// (_spmv_pallas_reduced, GellMatrix.spmv, SplitGell.spmv):
//
//   y[i] = sum_k vals[k, i] * x[cols[k, i]]     (padding slots: val 0, col 0)
//
// The TPU kernel needed window tables, 16-bit index packing and SMEM
// chunking because Mosaic has no general gather; a Hopper thread gathers
// from any address, so the layout is plain ELL-T: cols (K, n_pad) int32,
// vals (K, n_pad) fp32 or bf16.  One thread per row, over a grid-stride
// loop: slot k of neighbouring rows is adjacent in memory, so the cols
// and vals streams are read coalesced, and the gather and the row sum are
// fused (no stream of products goes back to device memory).  Slots are
// summed in k order in fp32.
//
// What bounds it is bytes: 6 or 8 B per slot of table, plus the gathered
// x entries, whose locality depends on the operator (prolongation rows
// read a few nearby coarse entries; restriction rows read ~K fine entries
// spread over neighbouring grid planes, served mostly from L2).  Rows are
// padded to the longest row: the aggressive-coarsening restriction pads
// ~1.6x, which a row-split or SELL-C-sigma layout would bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename ValT>
__global__ void __launch_bounds__(kThreads)
ell_spmv(const int* __restrict__ cols, const ValT* __restrict__ vals, int k,
         int n_pad, const float* __restrict__ x, float* __restrict__ y) {
  const int64_t n = n_pad;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < k; ++s) {
      const int64_t p = s * n + i;
      acc += to_f32(vals[p]) * x[cols[p]];
    }
    y[i] = acc;
  }
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.
extern "C" int ell_spmv_launch(int val_bf16, const int* cols,
                               const void* vals, int k, int n_pad,
                               const float* x, float* y, void* stream) {
  if (k < 1 || n_pad < 0) return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  long long blocks = ((long long)n_pad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    ell_spmv<__nv_bfloat16><<<grid, block, 0, s>>>(
        cols, static_cast<const __nv_bfloat16*>(vals), k, n_pad, x, y);
  else
    ell_spmv<float><<<grid, block, 0, s>>>(
        cols, static_cast<const float*>(vals), k, n_pad, x, y);
  return (int)cudaGetLastError();
}
