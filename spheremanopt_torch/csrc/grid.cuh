// The grid-wide forwards' machinery (fused_two_matrix.cu, fused_shared.cu):
// u crosses between the CTAs through L2 as step-tagged 64-bit words, and
// the kernels run as one cooperative launch of co-resident CTAs of
// kClusterThreads threads, with a capacity query that tells the wrapper
// whether the card can hold them at once.
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"

namespace smo {

// Polls before a wait counts as lost (~seconds): then the kernel traps.
constexpr unsigned kMaxPolls = 1u << 22;

// A (value, tag) pair is one 64-bit word, the value's bits low and the tag
// high, stored and loaded as one 64-bit access: a single access is atomic
// under the PTX memory model (a vector access is not), so a reader that
// sees a tag sees the value stored with it.
__device__ __forceinline__ void store_tagged(unsigned long long* pair, float x, unsigned tag) {
  const unsigned long long v =
      static_cast<unsigned long long>(tag) << 32 | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(pair), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_tagged(const unsigned long long* pair) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(pair));
  return v;
}

// all of u from a slot of mg (value, tag) words, two words a thread a
// round, each polled until it carries `tag`; with f != nullptr also
// f = poly(u), the step's polynomial (g for two matrices, v for one)
template <typename Poly>
__device__ __forceinline__ void read_tagged(const unsigned long long* slot, unsigned tag, int mg,
                                            Poly poly, float* u, float* f) {
  for (int k = threadIdx.x; k < mg / 2; k += kClusterThreads) {
    unsigned long long v0, v1;
    unsigned polls = 0;
    do {
      v0 = load_tagged(slot + 2 * k);
      v1 = load_tagged(slot + 2 * k + 1);
      if (++polls > kMaxPolls) __trap();
    } while (static_cast<unsigned>(v0 >> 32) != tag || static_cast<unsigned>(v1 >> 32) != tag);
    const float x0 = __uint_as_float(static_cast<unsigned>(v0));
    const float x1 = __uint_as_float(static_cast<unsigned>(v1));
    u[2 * k] = x0;
    u[2 * k + 1] = x1;
    if (f != nullptr) {
      f[2 * k] = poly(x0);
      f[2 * k + 1] = poly(x1);
    }
  }
}

// The grid kernel's attributes: the largest dynamic shared memory the card
// allows a block, set once per device (a launch's own size varies with
// mg); `ready` is the flag set of that kernel.
template <typename Kernel>
cudaError_t grid_attributes(Kernel kernel, bool (&ready)[kMaxDevices], int& optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return set_once(ready, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  });
}

// CTAs of `kernel` with `smem` bytes each that the card can hold at once
// (0 when one CTA does not fit an SM), or -cudaError_t
template <typename Kernel>
int grid_capacity(Kernel kernel, size_t smem, bool (&ready)[kMaxDevices]) {
  int optin = 0, dev = 0, sms = 0, occ = 0;
  cudaError_t err = grid_attributes(kernel, ready, optin);
  if (err == cudaSuccess && smem > (size_t)optin) return 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kClusterThreads, smem);
  return err == cudaSuccess ? occ * sms : -static_cast<int>(err);
}

// The type of a kernel parameter, in a context where it is not deduced
template <typename T>
struct Param {
  using type = T;
};

// One cooperative launch of `ctas` CTAs, the arguments converted to the
// kernel's parameter types: a grid that the card cannot hold at once fails
// at launch
template <typename... Params>
int grid_launch(void (*kernel)(Params...), int ctas, size_t smem, bool (&ready)[kMaxDevices],
                cudaStream_t st, typename Param<Params>::type... args) {
  int optin = 0;
  const cudaError_t err = grid_attributes(kernel, ready, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* ptrs[] = {&args...};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                    dim3(ctas), dim3(kClusterThreads), ptrs,
                                                    smem, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace smo
