// Helpers shared by the fused integrators (fused_shared.cu,
// fused_two_matrix.cu, kdyn_step.cu): block-wide sums, the Kahan step and the energy
// term, each written once with its rounding pinned, so that both
// instantiations of a forward kernel (with and without the energy
// series) give the same J bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace smo {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Kahan step, the same operations as solvers/scan_utils.py:kahan_add,
// with the rounding pinned (no contraction, no reassociation).
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float value) {
  const float y = __fsub_rn(value, comp);
  const float t = __fadd_rn(acc, y);
  comp = __fsub_rn(__fsub_rn(t, acc), y);
  acc = t;
}

// part + w u^2: (w * u) rounded, then one fused multiply-add with u and
// part. Written with intrinsics so no instantiation contracts it
// differently.
__device__ __forceinline__ float add_energy(float part, float w, float u) {
  return __fmaf_rn(__fmul_rn(w, u), u, part);
}

// Block-wide sum of per-thread partials of a block of kNumWarps warps,
// valid in thread 0 only. Its __syncthreads also publishes every
// shared-memory write made before it; a block barrier must pass before
// `red` (kNumWarps floats) is used again.
template <int kNumWarps = kWarps>
__device__ __forceinline__ float block_sum(float part, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float total = 0.f;
  if (warp == 0) total = warp_sum(lane < kNumWarps ? red[lane] : 0.f);
  return total;
}

}  // namespace smo
