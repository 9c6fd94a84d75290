// The refinement pass's finish on a DIA fine level, in fp64, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's df64 residual
// (sparsh_amg_tpu/ops/df64_ops.py::residual_df64, inside its fused
// refine_finish) is plain XLA, and so is the port's plain version,
// ops/fp64.py::finish64_plain (21 PyTorch kernels and 3 copies over fp64
// vectors on the 192^3 fine level).  Each refinement pass ends with it:
//
//   x64[i] += d[i]                        d: the pass's fp32 correction
//   r[i]    = b64[i] - az[i],  az[i] = sum_d bands[d, i] * x64[i + off_d]
//   b[i]    = fp32(r[i])                  the next pass's right-hand side
//   rr      = sum_i r[i]^2                ||r||^2 in fp64, into prog[4]
//
// The arithmetic is the plain version's, so x64 and b come out with its
// bits: d widened to fp64 and added once; each band's product rounded on
// its own and added to az in ascending d from 0.0 (__dmul_rn, __dadd_rn:
// no FMA contraction, as PyTorch's separate multiply and add kernels);
// r = b64 - az rounded once (__dsub_rn); the fp32 cast rounds to nearest.
// rr sums per-block partials (a fixed tree in each block) in block order
// in the last block to finish: the same bits from launch to launch, not
// those of cuBLAS's ddot (a few ulps apart).
//
// Two launches.  The x update and the neighbour reads would race in one:
// a block that wrote x64 + d in place could be read as a neighbour by a
// block still expecting the old x64.  So launch 1 updates x64 (and zeroes
// the reduction's ticket counter); launch 2 reads the updated x64.  The
// other order (launch 1 reads x64 + d at every neighbour, launch 2 writes
// x64) moves more bytes: launch 1 would read d as well at the staged halo
// and the far bands, and it cannot reuse the tail of x64 that launch 1
// here leaves in L2.
//
// What bounds it is bytes: D fp64 bands (8 B a row each), x64 in and out
// and d (launch 1: 20 B a row), x64 and b64 in and the fp32 b out (launch
// 2: 20 B a row) against 2 flops per band entry.  On the 192^3 fine level
// (7 bands, 7,077,888 rows) that is 396 + 142 + 142 = 680 MB, ~0.20 ms at
// 3.35 TB/s.
//
// Design (as csrc/dia_spmv.cu's, for 8-byte rows).  A block of kThreads
// threads owns a tile of TR = 2 kThreads rows; each thread owns 2
// consecutive rows, so every band, x64 and b64 access is one 16-byte load
// (the fp32 b store is 8 bytes).
//  * The band count is a template parameter for 7 (3-D Poisson: all seven
//    band loads issued before the first multiply); any other count up to
//    32 runs the run-time-count instantiation, its band loads kChunk at a
//    time.
//  * x64 is staged per tile in shared memory with a halo on each side
//    (zeros outside [0, n_pad)), chosen at launch from the offsets
//    (choose_halo: 192 for 3-D Poisson at 192^3, 1028 for 2-D elasticity
//    at 512^2).  Offsets beyond it (3-D Poisson's +-n^2 planes) read x64
//    from global memory, where the planes of nearby tiles keep it in L2.
//  * Bands and b64 are read once, with evict-first loads, so they do not
//    push the reused x64 out of L2.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kMaxBands = 32;   // params.AMGParams.dia_max_bands
constexpr int kThreads = 256;
constexpr int kRows = 2;        // rows a thread owns: 16 bytes of a band
constexpr int kTileRows = kThreads * kRows;
constexpr int kMaxHalo = 2048;  // x64 entries staged on each side of a tile
constexpr int kChunk = 8;       // band loads a thread issues at a time
constexpr int kRowAlign = 2;    // n_pad % kRowAlign == 0 (16-byte band rows)
constexpr int kUpdateRows = 4;  // rows a thread of the x update owns

struct Offsets {
  int v[kMaxBands];
};

struct Args {
  const double* bands;
  Offsets offs;
  int n_bands, n_pad;
  int halo;                     // even, <= kMaxHalo
  const double* x64;
  const double* b64;
  float* b;
  double* partials;             // gridDim.x block sums
  unsigned* ticket;             // blocks done; 0 before launch 2
  double* rr;
};

// launch 1: x64 += d (d widened to fp64: one rounded add), and the
// reduction's ticket set to 0 for launch 2
__global__ void __launch_bounds__(kThreads)
dia_finish64_update(double* __restrict__ x64, const float* __restrict__ d,
                    int64_t n, unsigned* __restrict__ ticket) {
  const int64_t i0 =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kUpdateRows;
  if (i0 == 0) *ticket = 0u;
  if (i0 + kUpdateRows <= n) {
    const float4 dv = *reinterpret_cast<const float4*>(d + i0);
    double2* px = reinterpret_cast<double2*>(x64 + i0);
    const double2 a = px[0], c = px[1];
    px[0] = make_double2(__dadd_rn(a.x, (double)dv.x),
                         __dadd_rn(a.y, (double)dv.y));
    px[1] = make_double2(__dadd_rn(c.x, (double)dv.z),
                         __dadd_rn(c.y, (double)dv.w));
  } else {
    for (int64_t i = i0; i < n; ++i)
      x64[i] = __dadd_rn(x64[i], (double)d[i]);
  }
}

// 2 entries of the staged x64 from index w on; w & 1 is the same for
// every thread (w = h + 2 t + off, h even), so the branch does not diverge
__device__ __forceinline__ void near_window(const double* sx, int w,
                                            double (&f)[kRows]) {
  if ((w & 1) == 0) {
    const double2 t = *reinterpret_cast<const double2*>(sx + w);
    f[0] = t.x;
    f[1] = t.y;
  } else {
    f[0] = sx[w];
    f[1] = sx[w + 1];
  }
}

// 2 entries of x64 from global index j0 on (0 outside [0, n)): one 16-byte
// load when j0 is even (n is), two 8-byte loads otherwise
__device__ __forceinline__ void far_window(const double* __restrict__ x,
                                           int64_t n, int64_t j0,
                                           double (&f)[kRows]) {
  if ((j0 & 1) == 0) {
    double2 t = make_double2(0.0, 0.0);
    if (j0 >= 0 && j0 < n) t = __ldg(reinterpret_cast<const double2*>(x + j0));
    f[0] = t.x;
    f[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t j = j0 + k;
      f[k] = (j >= 0 && j < n) ? __ldg(x + j) : 0.0;
    }
  }
}

// bands d0 .. min(d0 + C, nb) - 1 of one thread's rows, evict-first
template <int C>
__device__ __forceinline__ void load_bands(const double* __restrict__ bands,
                                           int64_t n, int64_t i0, int d0,
                                           int nb, double2 (&bv)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (d0 + c < nb)
      bv[c] = __ldcs(reinterpret_cast<const double2*>(
          bands + (int64_t)(d0 + c) * n + i0));
}

// az[k] += band[k] * x64[i0 + k + off], the product rounded on its own
__device__ __forceinline__ void add_band(const double2& band, int off,
                                         const double* sx, int h, int t,
                                         const double* __restrict__ x,
                                         int64_t n, int64_t i0,
                                         double (&az)[kRows]) {
  double w[kRows];
  if (off >= -h && off <= h)
    near_window(sx, h + t * kRows + off, w);
  else
    far_window(x, n, i0 + off, w);
  az[0] = __dadd_rn(az[0], __dmul_rn(band.x, w[0]));
  az[1] = __dadd_rn(az[1], __dmul_rn(band.y, w[1]));
}

// the block's sum of v in a fixed order (warp shuffles, then the warps'
// sums in warp order); thread 0 gets it
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();              // warp_sums free from any earlier use
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
  return total;
}

// launch 2: r = b64 - A x64, b = fp32(r), the block's sum of r^2; the
// last block to finish sums the blocks' sums in block order into *rr
template <int NB>
__global__ void __launch_bounds__(kThreads)
dia_finish64_residual(const Args a) {
  constexpr int C = NB > 0 && NB < kChunk ? NB : kChunk;
  extern __shared__ __align__(16) double sx[];   // TR + 2 * halo entries
  __shared__ double warp_sums[kThreads / 32];
  __shared__ bool last;
  const int64_t n = a.n_pad;
  const int h = a.halo;
  const int nb = NB > 0 ? NB : a.n_bands;
  const int t = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * kTileRows;
  const int64_t i0 = tile0 + (int64_t)t * kRows;
  const bool live = i0 < n;

  double2 bv[C];
  double2 bb = make_double2(0.0, 0.0);
  if (live) {
    load_bands<C>(a.bands, n, i0, 0, nb, bv);
    bb = __ldcs(reinterpret_cast<const double2*>(a.b64 + i0));
  }
  // stage x64[tile0 - h, tile0 + TR + h), zeros outside [0, n)
  for (int c = t; c < (kTileRows + 2 * h) / 2; c += kThreads) {
    const int64_t g = tile0 - h + 2 * c;
    double2 val = make_double2(0.0, 0.0);
    if (g >= 0 && g < n)
      val = __ldg(reinterpret_cast<const double2*>(a.x64 + g));
    reinterpret_cast<double2*>(sx)[c] = val;
  }
  __syncthreads();

  double sq = 0.0;
  if (live) {
    double az[kRows] = {0.0, 0.0};
#pragma unroll
    for (int d0 = 0; d0 < nb; d0 += C) {
      if (d0 > 0) load_bands<C>(a.bands, n, i0, d0, nb, bv);
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (d0 + c < nb)
          add_band(bv[c], a.offs.v[d0 + c], sx, h, t, a.x64, n, i0, az);
    }
    const double r0 = __dsub_rn(bb.x, az[0]), r1 = __dsub_rn(bb.y, az[1]);
    *reinterpret_cast<float2*>(a.b + i0) =
        make_float2(__double2float_rn(r0), __double2float_rn(r1));
    sq = r0 * r0 + r1 * r1;
  }

  const double block = block_sum(sq, warp_sums);
  if (t == 0) {
    a.partials[blockIdx.x] = block;
    __threadfence();            // the sum is visible before the ticket
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: thread t sums blocks t, t + kThreads, ... in order
  double s = 0.0;
  for (unsigned k = t; k < gridDim.x; k += kThreads)
    s += __ldcg(a.partials + k);
  const double total = block_sum(s, warp_sums);
  if (t == 0) *a.rr = total;
}

// The halo staged around each tile: of 0 and every |offset| rounded up to
// even (at most kMaxHalo), the one for which a tile reads the fewest x64
// entries: TR + 2 h staged, plus TR from global memory for each band
// beyond h.  3-D Poisson at 192^3: 192 (the +-36864 planes from global
// memory); 2-D elasticity at 512^2: 1028 (all 21 bands).
int choose_halo(const int* offsets, int n_bands) {
  int best = 0;
  long long best_cost = -1;
  for (int c = -1; c < n_bands; ++c) {
    const int h = c < 0 ? 0 : (std::abs(offsets[c]) + 1) / 2 * 2;
    if (h > kMaxHalo) continue;
    long long cost = kTileRows + 2LL * h;
    for (int d = 0; d < n_bands; ++d)
      if (std::abs(offsets[d]) > h) cost += kTileRows;
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && h < best)) {
      best = h;
      best_cost = cost;
    }
  }
  return best;
}

unsigned n_tiles(int n_pad) {
  return (unsigned)(((int64_t)n_pad + kTileRows - 1) / kTileRows);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// fp64 entries of the scratch dia_finish64_launch takes for n_pad rows:
// one sum per tile and the ticket.  No CUDA call.
extern "C" int dia_finish64_scratch(int n_pad) {
  return n_pad < 0 ? -1 : (int)n_tiles(n_pad) + 1;
}

// The halo dia_finish64_launch stages for these offsets, or -1 for a band
// count it does not take.  No CUDA call.
extern "C" int dia_finish64_halo(int n_bands, const int* offsets) {
  if (n_bands < 1 || n_bands > kMaxBands) return -1;
  return choose_halo(offsets, n_bands);
}

// x64 += d; b = fp32(b64 - A x64); *rr = ||b64 - A x64||^2, A the fp64
// DIA table bands (n_bands, n_pad) with host offsets[n_bands].  x64, b64,
// bands (fp64), d, b (fp32) must be 16-byte aligned, n_pad even and > 0, and
// scratch hold dia_finish64_scratch(n_pad) fp64 entries.  Two launches on
// `stream`; returns cudaGetLastError() after each.
extern "C" int dia_finish64_launch(const double* bands, int n_bands,
                                   const int* offsets, int n_pad, double* x64,
                                   const float* d, const double* b64,
                                   float* b, double* scratch, double* rr,
                                   void* stream) {
  if (n_bands < 1 || n_bands > kMaxBands || n_pad < 1 ||
      n_pad % kRowAlign != 0 || rr == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {bands, x64, d, b64, b};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = n_tiles(n_pad);
  Args a = {};
  a.bands = bands;
  for (int k = 0; k < n_bands; ++k) a.offs.v[k] = offsets[k];
  a.n_bands = n_bands;
  a.n_pad = n_pad;
  a.halo = choose_halo(offsets, n_bands);
  a.x64 = x64;
  a.b64 = b64;
  a.b = b;
  a.partials = scratch;
  a.ticket = reinterpret_cast<unsigned*>(scratch + tiles);
  a.rr = rr;

  const int64_t threads = ((int64_t)n_pad + kUpdateRows - 1) / kUpdateRows;
  const unsigned ublocks = (unsigned)((threads + kThreads - 1) / kThreads);
  dia_finish64_update<<<ublocks, kThreads, 0, s>>>(x64, d, n_pad, a.ticket);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t smem = (size_t)(kTileRows + 2 * a.halo) * sizeof(double);
  if (n_bands == 7)
    dia_finish64_residual<7><<<tiles, kThreads, smem, s>>>(a);
  else
    dia_finish64_residual<0><<<tiles, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
