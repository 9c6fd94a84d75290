// Irregular SpMV on sliced ELL with T lanes per row (SELL-P), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sparsh_amg_tpu/ops/gell.py::
// gell_gather_pallas and the row reduction that follows it
// (_spmv_pallas_reduced, GellMatrix.spmv, SplitGell.spmv):
//
//   y[perm[r]] = sum over the stored slots of packed row r of val * x[col]
//
// fp32 or bf16 values, fp32 x, y and sums.  The layout
// (ops/formats.py::pack_ell) sorts rows by descending length within
// windows of sigma rows and cuts them into slices of C = 32 / T rows, the
// rows one warp serves.  Slice s stores width[s] slots per row (its
// longest row rounded up to T * V) from entry off[s]: at step j, lane l
// (lane t = l % T of row l / T) holds the row's slots (j*T + t)*V ..
// (j*T + t)*V + V - 1 at entries off[s] + (j*32 + l)*V ..  So a warp's
// loads of one step are 32 * V consecutive entries, and the T lanes of a
// row read T * V consecutive slots, whose x gathers share sectors.
// Padding slots hold val 0 and a valid column; every row of [0, n_pad) is
// packed (padding rows with length 0), so y is written whole.  The TPU
// kernel needed window tables, 16-bit index packing and SMEM chunking
// because Mosaic has no general gather; a Hopper thread gathers from any
// address.
//
// A launch may apply a tail to each row's sum az before it stores it
// (Tail below; ops/ell_spmv.py names them): the residual b - az, the
// Jacobi sweep x + (s0 dinv) (b - az) and the prolongation's x + az, so
// that an l1-Jacobi or W-cycle visit to an ELL level runs no elementwise
// kernel beside its products.  Each tail rounds op by op as the plain
// PyTorch composition does (no contraction), so it gives its bits.
//
// Two launch shapes, picked by the wrapper:
//  * sliced (every operator but the long-row SA transfers): one warp per
//    slice walks the slice's steps, a uniform loop with no row-length
//    predicate, each lane loading its V slots at once (16-byte column
//    loads for V = 4); the T lanes of a row add their sums by
//    __shfl_down_sync in a fixed tree, so two launches give the same bits;
//  * split rows (T = V = 1 only, rows in their own order; split_rows.cuh;
//    SA transfers with a few thousand rows of hundreds to thousands of
//    slots, coarse levels of tens of thousands of rows): G lanes of a
//    block and S blocks of a cluster share each row's slots up to the
//    row's own length, so ~G*S times more loads are in flight, and the
//    partial sums are added in a fixed order.
//
// What bounds it: bytes -- 6 or 8 B per real slot plus one pass over x and
// y (2 flops per slot).  The design keeps the bytes near that: sorting
// within windows leaves 1.0-1.1x the real slots stored (against 1.3-3x
// for ELL-T rows padded to K, read to each warp's longest row), a sorted
// row costs 4 B more (perm), and the columns and values stream past L2 with
// evict-first loads so that the gathered x stays there.  T lanes per row
// make rows of tens of slots short loops whose gathers come from one
// neighbourhood of x, and keep T times more rows' loads in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "split_rows.cuh"

namespace {

constexpr int kThreads = 256;

// V consecutive slots in one load: columns, fp32 values, bf16 value bits
template <int V> struct Vec;
template <> struct Vec<1> { using I = int; using F = float;
                            using H = unsigned short; };
template <> struct Vec<4> { using I = int4; using F = float4;
                            using H = uint2; };

template <int V>
__device__ __forceinline__ void load_cols(const int* p, int (&c)[V]) {
  using I = typename Vec<V>::I;
  const I w = __ldcs(reinterpret_cast<const I*>(p));
  memcpy(c, &w, sizeof w);
}

template <int V>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[V]) {
  using F = typename Vec<V>::F;
  const F w = __ldcs(reinterpret_cast<const F*>(p));
  memcpy(v, &w, sizeof w);
}

template <int V>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&v)[V]) {
  using H = typename Vec<V>::H;
  const H w = __ldcs(reinterpret_cast<const H*>(p));
  unsigned short h[V];
  memcpy(h, &w, sizeof w);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = __uint_as_float((unsigned)h[i] << 16);
}

// A tail's code is its wrapper's index in ops/ell_spmv.py's WRAPPERS.
enum TailCode { SPMV = 0, RESIDUAL = 1, JACOBI = 2, ADD = 3 };

// The vectors of a tail: b, dinv and x have n_pad entries (null where
// the tail reads none).  The code is each kernel's last template
// argument, so a profiler's kernel name maps back to its wrapper.
struct Tail {
  const float* b;
  const float* dinv;
  const float* x;
  float s0;
};

// What a launch of tail Code stores at row i of y for the row's sum az.
template <int Code>
__device__ __forceinline__ float finish(const Tail& t, int64_t i, float az) {
  if (Code == RESIDUAL) return __fsub_rn(t.b[i], az);
  if (Code == JACOBI)
    return __fadd_rn(t.x[i], __fmul_rn(__fmul_rn(t.s0, t.dinv[i]),
                                       __fsub_rn(t.b[i], az)));
  if (Code == ADD) return __fadd_rn(t.x[i], az);
  return az;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One warp per slice.  At most 32 registers a thread, so that an SM
// holds 2,048 threads and as many slices' loads in flight.
template <typename ValT, int T, int V, int Code>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
ell_spmv(const int* __restrict__ cols, const ValT* __restrict__ vals,
          const int* __restrict__ off, const int* __restrict__ width,
          const int* __restrict__ perm, int n_slices, int n_rows,
          int n_pad, const float* __restrict__ x, float* __restrict__ y,
          Tail t) {
  constexpr int C = 32 / T;
  const int slice =
      (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5);
  if (slice >= n_slices) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)slice * C + lane / T;
  const bool store = lane % T == 0 && r < n_pad;
  if ((int64_t)slice * C >= n_rows) {  // padding rows: perm is identity
    if (store) y[r] = finish<Code>(t, r, 0.f);
    return;
  }
  // in flight behind the slots; no perm: rows unsorted (sigma = 1)
  const int dst = !store ? 0 : perm ? perm[r] : (int)r;
  const int steps = width[slice] / (T * V);
  const int64_t e0 = (int64_t)off[slice] + lane * V;
  const int* c = cols + e0;
  const ValT* v = vals + e0;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < steps; ++j) {
    int ci[V];
    float vi[V];
    load_cols<V>(c + (int64_t)j * 32 * V, ci);
    load_vals<V>(v + (int64_t)j * 32 * V, vi);
#pragma unroll
    for (int i = 0; i < V; ++i) acc += vi[i] * __ldg(x + ci[i]);
  }
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o, T);
  if (store) y[dst] = finish<Code>(t, dst, acc);
}

// split::zero_padding's rows y[n, n_pad), each the tail of a zero sum.
template <int Code>
__device__ __forceinline__ void finish_padding(int64_t n, int64_t n_pad,
                                               const Tail& t,
                                               float* __restrict__ y) {
  if (blockIdx.x != 0) return;
  const int64_t step = (int64_t)gridDim.y * split::kRows * blockDim.y;
  for (int64_t j = n + ((int64_t)blockIdx.y * blockDim.y + threadIdx.y) *
                           split::kRows + threadIdx.x;
       j < n_pad; j += step)
    y[j] = finish<Code>(t, j, 0.f);
}

// T = V = 1: block row blockIdx.y is slice blockIdx.y (32 rows), thread
// x its row x; slot k of the row at off + k * 32 + x.  The grid covers
// the slices of the real rows only (packed rows [0, n_rows) are the real
// rows, perm the identity past them).
template <typename ValT, int Code>
__global__ void __launch_bounds__(split::kRows * split::kMaxLanes)
ell_spmv_split(const int* __restrict__ cols, const ValT* __restrict__ vals,
                const int* __restrict__ off, const int* __restrict__ lens,
                const int* __restrict__ perm, int n_rows, int n_pad,
                const float* __restrict__ x, float* __restrict__ y, Tail t) {
  const int64_t r = (int64_t)blockIdx.y * split::kRows + threadIdx.x;
  const int stride = split::slot_stride();
  float acc = 0.f;
  if (r < n_rows) {
    const int len = lens[r];
    const int64_t e0 = (int64_t)off[blockIdx.y] + threadIdx.x;
    const int* ci = cols + e0;
    const ValT* vi = vals + e0;
#pragma unroll 4
    for (int k = split::first_slot(); k < len; k += stride)
      acc += to_f32(vi[(int64_t)k * split::kRows]) *
             x[ci[(int64_t)k * split::kRows]];
  }
  float sum;
  if (split::reduce(acc, &sum) && r < n_rows) {
    const int64_t i = perm ? perm[r] : r;
    y[i] = finish<Code>(t, i, sum);
  }
  finish_padding<Code>(n_rows, n_pad, t, y);
}

template <typename ValT, int T, int V, int Code>
int launch_sliced(const int* cols, const ValT* vals, const int* off,
                  const int* width, const int* perm, int n_slices,
                  int n_rows, int n_pad, const float* x, float* y,
                  const Tail& t, cudaStream_t s) {
  int64_t blocks = ((int64_t)n_slices * 32 + kThreads - 1) / kThreads;
  ell_spmv<ValT, T, V, Code><<<(unsigned)blocks, kThreads, 0, s>>>(
      cols, vals, off, width, perm, n_slices, n_rows, n_pad, x, y, t);
  return (int)cudaGetLastError();
}

template <typename ValT, int T, int Code>
int launch_t(int vec, const int* cols, const ValT* vals, const int* off,
             const int* width, const int* perm, int n_slices, int n_rows,
             int n_pad, const float* x, float* y, const Tail& t,
             cudaStream_t s) {
  switch (vec) {
    case 1: return launch_sliced<ValT, T, 1, Code>(
        cols, vals, off, width, perm, n_slices, n_rows, n_pad, x, y, t, s);
    case 4: return launch_sliced<ValT, T, 4, Code>(
        cols, vals, off, width, perm, n_slices, n_rows, n_pad, x, y, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename ValT, int Code>
int launch(int lanes, int vec, const int* cols, const ValT* vals,
           const int* off, const int* width, const int* perm,
           const int* lens, int n_slices, int n_rows, int n_pad, int g,
           int cluster, const float* x, float* y, const Tail& t,
           cudaStream_t s) {
  if (g * cluster > 1 && n_rows > 0) {
    if (lanes != 1 || vec != 1) return (int)cudaErrorInvalidValue;
    return split::launch(ell_spmv_split<ValT, Code>, g, cluster, n_rows, s,
                         cols, vals, off, lens, perm, n_rows, n_pad, x, y,
                         t);
  }
#define SELL_T(T)                                                       \
  case T:                                                               \
    return launch_t<ValT, T, Code>(vec, cols, vals, off, width, perm,    \
                                   n_slices, n_rows, n_pad, x, y, t, s);
  switch (lanes) {
    SELL_T(1) SELL_T(2) SELL_T(4) SELL_T(8) SELL_T(16) SELL_T(32)
  }
#undef SELL_T
  return (int)cudaErrorInvalidValue;
}

template <int Code>
int launch_code(int val_bf16, int lanes, int vec, const int* cols,
                const void* vals, const int* off, const int* width,
                const int* perm, const int* lens, int n_slices, int n_rows,
                int n_pad, int g, int cluster, const float* v, float* y,
                const Tail& t, cudaStream_t s) {
  if (val_bf16)
    return launch<__nv_bfloat16, Code>(
        lanes, vec, cols, static_cast<const __nv_bfloat16*>(vals), off,
        width, perm, lens, n_slices, n_rows, n_pad, g, cluster, v, y, t, s);
  return launch<float, Code>(lanes, vec, cols,
                             static_cast<const float*>(vals), off, width,
                             perm, lens, n_slices, n_rows, n_pad, g, cluster,
                             v, y, t, s);
}

}  // namespace

// val_bf16: 0 = fp32 values, 1 = bf16 values.  lanes (T) in 1, 2, 4, ...,
// 32 and vec (V) 1 or 4 as packed; n_slices * (32 / T) >= n_pad >=
// n_rows, packed rows [0, n_rows) the real ones; perm null when the rows
// are in their own order (sigma = 1).  g (lanes of a block) and
// cluster (blocks) from the wrapper's chooser; g = cluster = 1 is the
// sliced kernel, anything else the split rows (T = V = 1 only).  tail:
// a TailCode, with b, dinv, x (n_pad entries each, null where the tail
// reads none) and s0 (JACOBI's omega); y must not alias v or them.
extern "C" int ell_fused_launch(int val_bf16, int lanes, int vec,
                                const int* cols, const void* vals,
                                const int* off, const int* width,
                                const int* perm, const int* lens,
                                int n_slices, int n_rows, int n_pad, int g,
                                int cluster, const float* v, float* y,
                                int tail, const float* b, const float* dinv,
                                const float* x, float s0, void* stream) {
  if (lanes < 1 || lanes > 32 || n_rows < 0 || n_pad < n_rows ||
      n_slices < 0 || (int64_t)n_slices * (32 / lanes) < n_pad || g < 1 ||
      cluster < 1 || tail < SPMV || tail > ADD ||
      ((tail == RESIDUAL || tail == JACOBI) && !b) ||
      (tail == JACOBI && !dinv) || ((tail == JACOBI || tail == ADD) && !x))
    return (int)cudaErrorInvalidValue;
  if (n_slices == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tail t = {b, dinv, x, s0};
  switch (tail) {
    case SPMV: return launch_code<SPMV>(val_bf16, lanes, vec, cols, vals,
                                        off, width, perm, lens, n_slices,
                                        n_rows, n_pad, g, cluster, v, y, t,
                                        s);
    case RESIDUAL: return launch_code<RESIDUAL>(val_bf16, lanes, vec, cols,
                                                vals, off, width, perm, lens,
                                                n_slices, n_rows, n_pad, g,
                                                cluster, v, y, t, s);
    case JACOBI: return launch_code<JACOBI>(val_bf16, lanes, vec, cols, vals,
                                            off, width, perm, lens, n_slices,
                                            n_rows, n_pad, g, cluster, v, y,
                                            t, s);
    case ADD: return launch_code<ADD>(val_bf16, lanes, vec, cols, vals, off,
                                      width, perm, lens, n_slices, n_rows,
                                      n_pad, g, cluster, v, y, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

// y = A x: ell_fused_launch with no tail.
extern "C" int ell_spmv_launch(int val_bf16, int lanes, int vec,
                               const int* cols, const void* vals,
                               const int* off, const int* width,
                               const int* perm, const int* lens,
                               int n_slices, int n_rows, int n_pad, int g,
                               int cluster, const float* x, float* y,
                               void* stream) {
  return ell_fused_launch(val_bf16, lanes, vec, cols, vals, off, width, perm,
                          lens, n_slices, n_rows, n_pad, g, cluster, x, y,
                          SPMV, nullptr, nullptr, nullptr, 0.f, stream);
}
