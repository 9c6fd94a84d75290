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
// 2 flops per band entry (~0.5 flop/byte, far under any compute roof).  The
// only gain is to keep enough bytes in flight to reach HBM's rate.
//
// Design.  A block of kThreads threads owns a tile of TR rows; each thread
// owns R consecutive rows (8 for bf16 bands, 4 for fp32), so every band,
// vector and output access is one 16-byte load or store per thread.
// Blocks of 128 threads (1,024 bf16 or 512 fp32 rows) were 2-3 % faster
// than blocks of 256 on the 192^3 fine level.
//  * The band count is a template parameter for the counts the port's
//    configurations use (7: 3-D Poisson; 21: 2-D elasticity's fine level):
//    the band loop is unrolled, offsets are constant-bank reads, and a
//    thread issues its band loads kChunk at a time with no test, all 7 of
//    3-D Poisson's before its first multiply-add.  (Holding all 21 of
//    2-D elasticity's in registers halved the resident blocks and was
//    slower.)  Any other count up to 32 runs a run-time-count
//    instantiation.  dia_instantiation() says which one a count gets.
//  * v is staged per tile in shared memory with a halo on each side
//    (zeros outside [0, n_pad), written while staging), so the band loop
//    has no bounds test.  The launch picks the halo from the offsets
//    (choose_halo): 192 for 3-D Poisson at 192^3, 1028 for 2-D elasticity
//    at 512^2.  Offsets inside it read their window from shared memory
//    (two or three 16-byte reads and a uniform shift when off is not a
//    multiple of 4); offsets beyond it (3-D Poisson's +-n^2 planes, L2
//    hits) read v from global memory, 16 bytes at a time when off is a
//    multiple of 4.
//  * Band streams are read with evict-first loads so they do not push the
//    reused v planes out of L2.
// Sums run over d in ascending order in fp32 with one fused multiply-add
// per band, as the first port of this kernel did (same bits).
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W power limit), as
// a share of the real bytes over 3.35 TB/s: on the 192^3 fine level the
// Chebyshev step 84 % (bf16 bands), SpMV 78 % (bf16) and 85 % (fp32),
// against 61 %, 45 % and 63 % for the one-thread-per-row kernel it
// replaced; on 2-D elasticity's fine level (512^2, 44 MB table, L2
// flushed) 48-53 %: a launch's fixed ~7 us against a 11-14 us bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kMaxBands = 32;   // params.AMGParams.dia_max_bands
constexpr int kThreads = 128;
constexpr int kMaxHalo = 2048;  // v entries staged on each side of a tile
constexpr int kChunk = 8;       // band loads a thread issues at a time
constexpr int kRowAlign = 8;    // n_pad % kRowAlign == 0 (16-byte band rows)

struct Offsets {
  int v[kMaxBands];
};

enum Tail : int { SPMV = 0, RESIDUAL = 1, DINV_RESIDUAL = 2, JACOBI = 3,
                  CHEB = 4 };

// fp32 vectors each tail reads besides v: b, dinv, x
template <int TAIL>
struct TailVecs {
  static constexpr int n = TAIL == SPMV ? 0 : TAIL == RESIDUAL ? 1
                           : TAIL == DINV_RESIDUAL ? 2 : 3;
};

template <typename BandT>
struct Rows {                   // rows per thread: 16 bytes of one band
  static constexpr int value = 16 / sizeof(BandT);
};

template <typename BandT>
__host__ __device__ constexpr int tile_rows() {   // rows per block
  return kThreads * Rows<BandT>::value;
}

// the band counts compiled as template parameters (0: run-time count)
template <typename BandT>
int compiled_count(int n_bands) {
  if (n_bands == 7) return 7;
  if (sizeof(BandT) == 4 && n_bands == 21) return 21;
  return 0;
}

// 16 bytes of one band row, widened to fp32 (bf16: the exact widening)
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

template <int R>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&f)[R]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
    f[4 * q] = t.x;
    f[4 * q + 1] = t.y;
    f[4 * q + 2] = t.z;
    f[4 * q + 3] = t.w;
  }
}

template <int R>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&f)[R]) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
}

// R entries of the staged v from index w on; s = w & 3 is the same for
// every thread (w = h + t * R + off, h a multiple of 4), so the switch
// does not diverge
template <int R>
__device__ __forceinline__ void near_window(const float* sv, int w,
                                            float (&f)[R]) {
  const int s = w & 3;
  const float4* p = reinterpret_cast<const float4*>(sv + (w - s));
  float c[R + 4];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 t = p[q];
    c[4 * q] = t.x;
    c[4 * q + 1] = t.y;
    c[4 * q + 2] = t.z;
    c[4 * q + 3] = t.w;
  }
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) f[k] = c[k];
    return;
  }
  const float4 t = p[R / 4];
  c[R] = t.x;
  c[R + 1] = t.y;
  c[R + 2] = t.z;
  c[R + 3] = t.w;
  switch (s) {
    case 1:
#pragma unroll
      for (int k = 0; k < R; ++k) f[k] = c[k + 1];
      break;
    case 2:
#pragma unroll
      for (int k = 0; k < R; ++k) f[k] = c[k + 2];
      break;
    default:
#pragma unroll
      for (int k = 0; k < R; ++k) f[k] = c[k + 3];
  }
}

// R entries of v from global index j0 on (0 outside [0, n)): 16-byte
// loads when j0 is a multiple of 4 (n is), scalar loads otherwise
template <int R>
__device__ __forceinline__ void far_window(const float* __restrict__ v,
                                           int64_t n, int64_t j0,
                                           float (&f)[R]) {
  if ((j0 & 3) == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int64_t j = j0 + 4 * q;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= 0 && j < n) t = __ldg(reinterpret_cast<const float4*>(v + j));
      f[4 * q] = t.x;
      f[4 * q + 1] = t.y;
      f[4 * q + 2] = t.z;
      f[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t j = j0 + k;
      f[k] = (j >= 0 && j < n) ? __ldg(v + j) : 0.f;
    }
  }
}

// bands d0 .. min(d0 + C, nb) - 1 of one thread's rows, evict-first
template <typename BandT, int C>
__device__ __forceinline__ void load_bands(const BandT* __restrict__ bands,
                                           int64_t n, int64_t i0, int d0,
                                           int nb, uint4 (&bv)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (d0 + c < nb)
      bv[c] = __ldcs(reinterpret_cast<const uint4*>(
          bands + (int64_t)(d0 + c) * n + i0));
}

// acc[k] += band[k] * v[i0 + k + off] for one band; sv holds the tile's
// v with a halo of h entries on each side
template <int R>
__device__ __forceinline__ void add_band(const uint4& band, int off,
                                         const float* sv, int h, int t,
                                         const float* __restrict__ v,
                                         int64_t n, int64_t i0,
                                         float (&acc)[R]) {
  float w[R], a[R];
  if (off >= -h && off <= h)
    near_window<R>(sv, h + t * R + off, w);
  else
    far_window<R>(v, n, i0 + off, w);
  widen(band, a);
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] += a[k] * w[k];
}

// the tail on one thread's R rows; vec[0..2] = b, dinv, x as the tail
// reads them, dv = v at the thread's own rows (CHEB)
template <int TAIL, int R>
__device__ __forceinline__ void tail_store(const float (&acc)[R],
                                           const float (&vb)[R],
                                           const float (&vd)[R],
                                           const float (&vx)[R],
                                           const float (&dv)[R], float s0,
                                           float s1, int64_t i0,
                                           float* __restrict__ y0,
                                           float* __restrict__ y1,
                                           float* __restrict__ y2) {
  float o0[R];
  if constexpr (TAIL == CHEB) {
    float o1[R], o2[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float r2 = vb[k] - vd[k] * acc[k];
      o0[k] = vx[k] + dv[k];
      o1[k] = r2;
      o2[k] = s0 * dv[k] + s1 * r2;
    }
    store_vec<R>(y1 + i0, o1);
    store_vec<R>(y2 + i0, o2);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if constexpr (TAIL == SPMV) o0[k] = acc[k];
      else if constexpr (TAIL == RESIDUAL) o0[k] = vb[k] - acc[k];
      else if constexpr (TAIL == DINV_RESIDUAL)
        o0[k] = vd[k] * (vb[k] - acc[k]);
      else o0[k] = vx[k] + s0 * vd[k] * (vb[k] - acc[k]);
    }
  }
  store_vec<R>(y0 + i0, o0);
}

struct Args {
  const void* bands;
  Offsets offs;
  int n_bands, n_pad;
  int halo;                     // a multiple of 4, <= kMaxHalo
  const float *v, *b, *dinv, *x;
  float s0, s1;
  float *y0, *y1, *y2;
};

template <typename BandT, int TAIL, int NB>
__global__ void __launch_bounds__(kThreads)
dia_tile(const Args a) {
  constexpr int R = Rows<BandT>::value;
  constexpr int TR = tile_rows<BandT>();
  constexpr int C = NB > 0 && NB < kChunk ? NB : kChunk;
  extern __shared__ __align__(16) float sv[];   // TR + 2 * halo entries
  const int64_t n = a.n_pad;
  const int h = a.halo;
  const int nb = NB > 0 ? NB : a.n_bands;
  const int t = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * TR;
  const int64_t i0 = tile0 + (int64_t)t * R;
  const bool live = i0 < n;
  const BandT* bands = static_cast<const BandT*>(a.bands);

  uint4 bv[C];
  if (live) load_bands<BandT, C>(bands, n, i0, 0, nb, bv);
  float vb[R], vd[R], vx[R];
  if (live) {
    if constexpr (TailVecs<TAIL>::n >= 1) load_vec<R>(a.b + i0, vb);
    if constexpr (TailVecs<TAIL>::n >= 2) load_vec<R>(a.dinv + i0, vd);
    if constexpr (TailVecs<TAIL>::n >= 3) load_vec<R>(a.x + i0, vx);
  }
  // stage v[tile0 - h, tile0 + TR + h), zeros outside [0, n)
  for (int c = t; c < (TR + 2 * h) / 4; c += kThreads) {
    const int64_t g = tile0 - h + 4 * c;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < n) val = __ldg(reinterpret_cast<const float4*>(a.v + g));
    reinterpret_cast<float4*>(sv)[c] = val;
  }
  __syncthreads();
  if (!live) return;

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < nb; d0 += C) {
    if (d0 > 0) load_bands<BandT, C>(bands, n, i0, d0, nb, bv);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (d0 + c < nb)
        add_band<R>(bv[c], a.offs.v[d0 + c], sv, h, t, a.v, n, i0, acc);
  }
  float dv[R];
  if constexpr (TAIL == CHEB) near_window<R>(sv, h + t * R, dv);
  tail_store<TAIL, R>(acc, vb, vd, vx, dv, a.s0, a.s1, i0, a.y0, a.y1,
                      a.y2);
}

template <typename BandT, int TAIL, int NB>
int launch_one(const Args& a, cudaStream_t s) {
  constexpr int TR = tile_rows<BandT>();
  const unsigned tiles = (unsigned)((a.n_pad + TR - 1) / TR);
  const size_t smem = (size_t)(TR + 2 * a.halo) * sizeof(float);
  dia_tile<BandT, TAIL, NB><<<tiles, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename BandT, int NB>
int launch_tail(int tail, const Args& a, cudaStream_t s) {
  switch (tail) {
    case SPMV: return launch_one<BandT, SPMV, NB>(a, s);
    case RESIDUAL: return launch_one<BandT, RESIDUAL, NB>(a, s);
    case DINV_RESIDUAL: return launch_one<BandT, DINV_RESIDUAL, NB>(a, s);
    case JACOBI: return launch_one<BandT, JACOBI, NB>(a, s);
    case CHEB: return launch_one<BandT, CHEB, NB>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename BandT>
int launch(int tail, const Args& a, cudaStream_t s) {
  switch (compiled_count<BandT>(a.n_bands)) {
    case 7: return launch_tail<BandT, 7>(tail, a, s);
    case 21:
      if constexpr (sizeof(BandT) == 4) return launch_tail<BandT, 21>(tail, a, s);
      return (int)cudaErrorInvalidValue;
    default: return launch_tail<BandT, 0>(tail, a, s);
  }
}

// The halo staged around each tile: of 0 and every |offset| rounded up to
// a multiple of 4 (at most kMaxHalo), the one for which a tile of tr rows
// reads the fewest v entries: tr + 2 h staged, plus tr from global memory
// for each band beyond h.  3-D Poisson at 192^3: 192 (the +-36864 planes
// from global memory); 2-D elasticity at 512^2: 1028 (all 21 bands).
int choose_halo(const int* offsets, int n_bands, int tr) {
  int best = 0;
  long long best_cost = -1;
  for (int c = -1; c < n_bands; ++c) {
    const int h = c < 0 ? 0 : (std::abs(offsets[c]) + 3) / 4 * 4;
    if (h > kMaxHalo) continue;
    long long cost = tr + 2LL * h;
    for (int d = 0; d < n_bands; ++d)
      if (std::abs(offsets[d]) > h) cost += tr;
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && h < best)) {
      best = h;
      best_cost = cost;
    }
  }
  return best;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// band_bf16: 0 = fp32 bands, 1 = bf16 bands.  offsets: host array of
// n_bands ints.  Pointers a tail does not read may be null; the others
// must be 16-byte aligned, and n_pad a multiple of 8.
extern "C" int dia_fused_launch(int band_bf16, int tail, const void* bands,
                                int n_bands, const int* offsets, int n_pad,
                                const float* v, const float* b,
                                const float* dinv, const float* x, float s0,
                                float s1, float* y0, float* y1, float* y2,
                                void* stream) {
  if (n_bands < 1 || n_bands > kMaxBands || n_pad < 0 ||
      n_pad % kRowAlign != 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {bands, v, b, dinv, x, y0, y1, y2};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (n_pad == 0) return (int)cudaGetLastError();
  Args a = {};
  a.bands = bands;
  for (int d = 0; d < n_bands; ++d) a.offs.v[d] = offsets[d];
  a.n_bands = n_bands;
  a.n_pad = n_pad;
  a.halo = choose_halo(offsets, n_bands,
                       band_bf16 ? tile_rows<__nv_bfloat16>()
                                 : tile_rows<float>());
  a.v = v;
  a.b = b;
  a.dinv = dinv;
  a.x = x;
  a.s0 = s0;
  a.s1 = s1;
  a.y0 = y0;
  a.y1 = y1;
  a.y2 = y2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return launch<__nv_bfloat16>(tail, a, s);
  return launch<float>(tail, a, s);
}

// The band count of the instantiation dia_fused_launch runs for n_bands
// bands (0: the run-time-count one).  No CUDA call.
extern "C" int dia_instantiation(int band_bf16, int n_bands) {
  return band_bf16 ? compiled_count<__nv_bfloat16>(n_bands)
                   : compiled_count<float>(n_bands);
}

// The halo dia_fused_launch stages for these offsets.  No CUDA call.
extern "C" int dia_halo(int band_bf16, int n_bands, const int* offsets) {
  if (n_bands < 1 || n_bands > kMaxBands) return -1;
  return choose_halo(offsets, n_bands,
                     band_bf16 ? tile_rows<__nv_bfloat16>()
                               : tile_rows<float>());
}
