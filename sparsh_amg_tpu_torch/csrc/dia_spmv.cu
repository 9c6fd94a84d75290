// DIA (diagonal) SpMV with fused elementwise tails, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sparsh_amg_tpu/ops/pallas_spmv.py:
//   * dia_spmv_pallas (_dia_kernel, _dia_kernel_single):  y = A v
//   * _dia_fused behind dia_residual, dia_dinv_residual, dia_jacobi_sweep
//     and dia_cheb_step: one A v plus an elementwise tail, in one pass.
//
//   az[i] = sum_d bands[d, i] * v[i + off_d]   (0 where i + off_d is
//   outside [0, n_pad): the reference pads v with zeros)
//
//   SPMV           y0 = az
//   RESIDUAL       y0 = b - az
//   DINV_RESIDUAL  y0 = dinv * (b - az)
//   JACOBI         y0 = x + s0 * dinv * (b - az)          (x == v)
//   CHEB           (v = d, b = r)  r' = r - dinv * az
//                  y0 = x + d,  y1 = r',  y2 = s0 * d + s1 * r'
//
// What bounds it is bytes: D band streams (2 or 4 B/row each), the
// multiplied vector, 1-4 extra fp32 vectors and 1-3 fp32 outputs, against
// ~2 flops per band.  One thread per row over a grid-stride loop: every
// band row, vector and output is read or written coalesced, each element
// exactly once from device memory.  The D shifted reads of v hit the same
// lines as the neighbouring rows' reads; on the 192^3 fine level the
// three x planes a block touches (offsets 0 and +-36864, 147 KB each) sit
// in the 50 MB L2, so v costs about one pass from HBM.  Offsets go by
// value (kernel parameter space) and the band loop is unrolled over the
// static maximum so each offset is a constant-bank read.  Sums run over d
// in ascending order in fp32, as the reference's XLA path does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBands = 32;   // params.AMGParams.dia_max_bands
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct Offsets {
  int v[kMaxBands];
};

enum Tail : int { SPMV = 0, RESIDUAL = 1, DINV_RESIDUAL = 2, JACOBI = 3,
                  CHEB = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename BandT, int TAIL>
__global__ void __launch_bounds__(kThreads)
dia_fused(const BandT* __restrict__ bands, int n_bands, Offsets offs,
          int n_pad, const float* __restrict__ v,
          const float* __restrict__ b, const float* __restrict__ dinv,
          const float* __restrict__ x, float s0, float s1,
          float* __restrict__ y0, float* __restrict__ y1,
          float* __restrict__ y2) {
  const int64_t n = n_pad;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxBands; ++d) {
      if (d >= n_bands) break;
      const int64_t j = i + offs.v[d];
      if (j >= 0 && j < n) acc += to_f32(bands[d * n + i]) * v[j];
    }
    if constexpr (TAIL == SPMV) {
      y0[i] = acc;
    } else if constexpr (TAIL == RESIDUAL) {
      y0[i] = b[i] - acc;
    } else if constexpr (TAIL == DINV_RESIDUAL) {
      y0[i] = dinv[i] * (b[i] - acc);
    } else if constexpr (TAIL == JACOBI) {
      y0[i] = x[i] + s0 * dinv[i] * (b[i] - acc);
    } else {
      const float r2 = b[i] - dinv[i] * acc;
      const float dv = v[i];
      y0[i] = x[i] + dv;
      y1[i] = r2;
      y2[i] = s0 * dv + s1 * r2;
    }
  }
}

template <typename BandT>
cudaError_t launch(int tail, const BandT* bands, int n_bands,
                   const Offsets& offs, int n_pad, const float* v,
                   const float* b, const float* dinv, const float* x,
                   float s0, float s1, float* y0, float* y1, float* y2,
                   cudaStream_t stream) {
  long long blocks = ((long long)n_pad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks), block(kThreads);
#define DIA_LAUNCH(T)                                                     \
  dia_fused<BandT, T><<<grid, block, 0, stream>>>(                        \
      bands, n_bands, offs, n_pad, v, b, dinv, x, s0, s1, y0, y1, y2)
  switch (tail) {
    case SPMV: DIA_LAUNCH(SPMV); break;
    case RESIDUAL: DIA_LAUNCH(RESIDUAL); break;
    case DINV_RESIDUAL: DIA_LAUNCH(DINV_RESIDUAL); break;
    case JACOBI: DIA_LAUNCH(JACOBI); break;
    case CHEB: DIA_LAUNCH(CHEB); break;
    default: return cudaErrorInvalidValue;
  }
#undef DIA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// band_bf16: 0 = fp32 bands, 1 = bf16 bands.  offsets: host array of
// n_bands ints.  Pointers a tail does not read may be null.
extern "C" int dia_fused_launch(int band_bf16, int tail, const void* bands,
                                int n_bands, const int* offsets, int n_pad,
                                const float* v, const float* b,
                                const float* dinv, const float* x, float s0,
                                float s1, float* y0, float* y1, float* y2,
                                void* stream) {
  if (n_bands < 1 || n_bands > kMaxBands || n_pad < 0)
    return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  Offsets offs = {};
  for (int d = 0; d < n_bands; ++d) offs.v[d] = offsets[d];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16)
    return (int)launch(tail, static_cast<const __nv_bfloat16*>(bands),
                       n_bands, offs, n_pad, v, b, dinv, x, s0, s1, y0, y1,
                       y2, s);
  return (int)launch(tail, static_cast<const float*>(bands), n_bands, offs,
                     n_pad, v, b, dinv, x, s0, s1, y0, y1, y2, s);
}
