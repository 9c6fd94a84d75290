// Split-row launch shared by ell_spmv.cu and block_ell_spmv.cu (sm_90a).
//
// A row whose slots are too many for one thread is split over P = G * S
// threads: a block holds kRows = 32 rows along threadIdx.x (so a warp
// still reads slot k of 32 neighbouring rows coalesced) by G lanes along
// threadIdx.y, and a thread-block cluster of S blocks along blockIdx.x
// splits the same rows' slots further.  Thread (x, g) of cluster rank s
// takes slots q, q + P, q + 2P, ... of its row, q = s * G + g.
//
// The partial sums are added in a fixed order, with no atomics, so two
// launches give the same bits: lanes 0..G-1 in shared memory, then, where
// S > 1, ranks 0..S-1 of the cluster through distributed shared memory
// (rank 0 reads the other blocks' totals after a cluster barrier).  One
// launch; the grid is (S, ceil(rows / 32)), the cluster (S, 1, 1).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace split {

namespace cg = cooperative_groups;

constexpr int kRows = 32;       // rows of a block, along threadIdx.x
constexpr int kMaxLanes = 32;   // G: 32 x 32 = 1024 threads at most
constexpr int kMaxCluster = 8;  // S: the portable cluster size

// The first slot of this thread and the slot stride.
__device__ __forceinline__ int first_slot() {
  return blockIdx.x * blockDim.y + threadIdx.y;
}
__device__ __forceinline__ int slot_stride() {
  return gridDim.x * blockDim.y;
}

// Sum the partials `acc` of row `row` (lanes, then cluster ranks, in
// order) and store the sum at y[row] when row < n; zero y[n, n_pad).
// Every thread of the grid must call it (it holds block and cluster
// barriers).
__device__ __forceinline__ void reduce_store(float acc, int64_t row,
                                             int64_t n, int64_t n_pad,
                                             float* __restrict__ y) {
  __shared__ float part[kMaxLanes][kRows];
  __shared__ float total[kRows];
  const int rx = threadIdx.x, g = threadIdx.y;
  part[g][rx] = acc;
  __syncthreads();
  if (g == 0) {
    float t = part[0][rx];
    for (int h = 1; h < (int)blockDim.y; ++h) t += part[h][rx];
    total[rx] = t;
  }
  if (gridDim.x > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's totals are written
    if (cluster.block_rank() == 0 && g == 0) {
      float t = total[rx];
      for (unsigned r = 1; r < gridDim.x; ++r)
        t += cluster.map_shared_rank(&total[0], r)[rx];
      if (row < n) y[row] = t;
    }
    cluster.sync();  // no block leaves while rank 0 reads its totals
  } else if (g == 0 && row < n) {
    y[row] = total[rx];
  }
  if (blockIdx.x == 0) {  // padding rows
    const int64_t step = (int64_t)gridDim.y * kRows * blockDim.y;
    for (int64_t j = n + ((int64_t)blockIdx.y * blockDim.y + g) * kRows + rx;
         j < n_pad; j += step)
      y[j] = 0.f;
  }
}

// Launch kernel(args...) on a (cluster, ceil(rows / 32)) grid of
// (32, lanes) blocks, clustered along x.  Returns a cudaError_t.
template <typename... Exp, typename... Act>
int launch(void (*kernel)(Exp...), int lanes, int cluster, int64_t rows,
           cudaStream_t stream, Act... args) {
  const int64_t row_blocks = (rows + kRows - 1) / kRows;
  if (lanes < 1 || lanes > kMaxLanes || cluster < 1 ||
      cluster > kMaxCluster || row_blocks < 1 || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)row_blocks, 1);
  cfg.blockDim = dim3(kRows, (unsigned)lanes, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace split
