// The thread-block cluster machinery of the SBDF sweeps (fused_shared.cu,
// fused_two_matrix.cu): the cluster's shape, the energy sum that stands in
// for the one-block kernels' 1024-thread reduction tree (also used by the
// grid-wide forwards), the reverse sweeps' row phases, the launch of one
// cluster and its capacity query, and the dispatch from a width mg to the
// kernel instance of mg = 128 R.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace smo {

// One cluster of kClusterCtas CTAs of kClusterThreads threads on as many
// SMs. 16 is above the portable cluster size (8): the kernels set
// cudaFuncAttributeNonPortableClusterSizeAllowed.
constexpr int kClusterCtas = 16;
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kRefWarps = kThreads / 32;   // the one-block kernels' reduction tree

// sum_j w_j u_j^2 as the one-block forwards' block_sum forms it (thread j
// of 1024 holds w_j u_j^2 and, above mg = 1024, adds w u^2 of j + 1024;
// then warp sums, then a sum of the 32 warp sums), with this block's
// kClusterThreads threads standing in for the 1024-thread block's: the
// warp sums go to red[32]. A __syncthreads must pass before red is read.
// mg <= 2048.
__device__ __forceinline__ void energy_partials(const float* u, const float* ws, int mg,
                                                float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kRefWarps / kClusterWarps;
  float p[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int j = (warp + v * kClusterWarps) * 32 + lane;
    p[v] = j < mg ? add_energy(0.f, ws[j], u[j]) : 0.f;
    if (j + kThreads < mg) p[v] = add_energy(p[v], ws[j + kThreads], u[j + kThreads]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < kPer; ++v) p[v] += __shfl_xor_sync(0xffffffffu, p[v], off);
  if (lane == 0)
#pragma unroll
    for (int v = 0; v < kPer; ++v) red[warp + v * kClusterWarps] = p[v];
}

// The one-block reverse kernels' row phases at width mg: their thread
// (p, column group) of 1024 sums the rows p, p + P, ... of its columns; a
// cluster's or a grid's thread (p, column) sums the same rows in the same
// order.
__host__ __device__ constexpr int row_phases(int mg) { return kThreads / (mg / 4); }

// The launch of `clusters` clusters of kClusterCtas CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory each (a row launch
// runs one cluster per row; the clusters need not be resident at once).
// The kernel's attributes are set once per device; `ready` is the flag set
// of that kernel.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int threads,
                           bool (&ready)[kMaxDevices], cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr, cudaStream_t st, int clusters = 1) {
  const cudaError_t err = set_once(ready, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kClusterCtas * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

// clusters of `kernel` that the card can hold at once (> 0 when it can be
// scheduled), or -cudaError_t
template <typename Kernel>
int cluster_capacity(Kernel kernel, size_t smem, int threads, bool (&ready)[kMaxDevices]) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, smem, threads, ready, cfg, attr, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename Kernel, typename... Args>
int cluster_launch(Kernel kernel, int clusters, size_t smem, int threads,
                   bool (&ready)[kMaxDevices], cudaStream_t st, Args... args) {
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, smem, threads, ready, cfg, attr, st, clusters);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K<V, R>::launch(args...) and K<V, R>::capacity() for the R of
// mg = 128 R, R <= kMaxR (the widths a cluster kernel has instances for),
// or cudaErrorInvalidValue (as -cudaErrorInvalidValue for the capacity)
template <template <bool, int> class K, bool V, int kMaxR, typename... Args>
int launch_by_mg(int mg, Args... args) {
  static_assert(kMaxR >= 5 && kMaxR <= 7, "instances for mg = 128 .. 128 kMaxR");
  switch (mg) {
    case 128: return K<V, 1>::launch(args...);
    case 256: return K<V, 2>::launch(args...);
    case 384: return K<V, 3>::launch(args...);
    case 512: return K<V, 4>::launch(args...);
    case 640: return K<V, 5>::launch(args...);
    case 768:
      if constexpr (kMaxR >= 6) return K<V, 6>::launch(args...);
      break;
    case 896:
      if constexpr (kMaxR >= 7) return K<V, 7>::launch(args...);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <template <bool, int> class K, bool V, int kMaxR>
int capacity_by_mg(int mg) {
  static_assert(kMaxR >= 5 && kMaxR <= 7, "instances for mg = 128 .. 128 kMaxR");
  switch (mg) {
    case 128: return K<V, 1>::capacity();
    case 256: return K<V, 2>::capacity();
    case 384: return K<V, 3>::capacity();
    case 512: return K<V, 4>::capacity();
    case 640: return K<V, 5>::capacity();
    case 768:
      if constexpr (kMaxR >= 6) return K<V, 6>::capacity();
      break;
    case 896:
      if constexpr (kMaxR >= 7) return K<V, 7>::capacity();
      break;
    default: break;
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace smo
