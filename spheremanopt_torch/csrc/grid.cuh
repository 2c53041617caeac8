// The grid-wide sweeps' machinery (fused_two_matrix.cu, fused_shared.cu):
// u (lambda in a reverse sweep) crosses between the CTAs through L2 as
// step-tagged 64-bit words, and the kernels run as one cooperative launch
// of co-resident CTAs of kClusterThreads threads, with a capacity query
// that tells the wrapper whether the card can hold them at once; the
// reverse sweeps' layout of their chains in shared memory and the chains'
// sums.
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"

namespace smo {

// The reverse grids keep each thread's chain (the entries of rows p,
// p + P, ... of one column, and the same rows of lambda) contiguous in
// shared memory, so that it reads them as float4s: floats between two
// chains of `terms` entries, rounded up to an odd number of float4s, so
// that eight consecutive chains start in eight different bank groups.
__host__ __device__ constexpr int chain_stride(int terms) { return 4 * (((terms + 3) / 4) | 1); }

// Where the reverse grids keep lambda_j: in row j's phase's chain, at
// (j mod P) ts + j / P.
__device__ __forceinline__ int lam_pos(int j, int P, int ts) { return (j % P) * ts + j / P; }

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

// Rounds of a CTA's threads over the mg / 2 word pairs of a slot, mg <= 2048
constexpr int kMaxPairRounds = 2048 / 2 / kClusterThreads;

// All of lambda from a slot of mg (value, tag) words into the reverse
// grids' layout: pos[2 r] and pos[2 r + 1] are this thread's places
// (lam_pos) of words 2k and 2k + 1, k = tid + r kClusterThreads. Unlike
// read_tagged, a thread's loads of all its rounds are in flight at once,
// and only the words without the tag are loaded again.
__device__ __forceinline__ void read_tagged_lambda(const unsigned long long* slot, unsigned tag,
                                                   int mg, float* lam,
                                                   const int (&pos)[2 * kMaxPairRounds]) {
  unsigned long long v[2 * kMaxPairRounds];
  const int k0 = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kMaxPairRounds; ++r) {
    const int k = k0 + r * kClusterThreads;
    v[2 * r] = v[2 * r + 1] = 0ull;
    if (k < mg / 2) {
      v[2 * r] = load_tagged(slot + 2 * k);
      v[2 * r + 1] = load_tagged(slot + 2 * k + 1);
    }
  }
  for (unsigned polls = 0;; ++polls) {
    bool done = true;
#pragma unroll
    for (int r = 0; r < kMaxPairRounds; ++r) {
      const int k = k0 + r * kClusterThreads;
      if (k < mg / 2
          && (static_cast<unsigned>(v[2 * r] >> 32) != tag
              || static_cast<unsigned>(v[2 * r + 1] >> 32) != tag)) {
        done = false;
        v[2 * r] = load_tagged(slot + 2 * k);
        v[2 * r + 1] = load_tagged(slot + 2 * k + 1);
      }
    }
    if (done) break;
    if (polls > kMaxPolls) __trap();
  }
#pragma unroll
  for (int r = 0; r < kMaxPairRounds; ++r) {
    if (k0 + r * kClusterThreads < mg / 2) {
      lam[pos[2 * r]] = __uint_as_float(static_cast<unsigned>(v[2 * r]));
      lam[pos[2 * r + 1]] = __uint_as_float(static_cast<unsigned>(v[2 * r + 1]));
    }
  }
}

// pos of read_tagged_lambda for this thread
__device__ __forceinline__ void lambda_places(int mg, int P, int ts,
                                              int (&pos)[2 * kMaxPairRounds]) {
#pragma unroll
  for (int r = 0; r < kMaxPairRounds; ++r) {
    const int j = 2 * (threadIdx.x + r * kClusterThreads);
    pos[2 * r] = j < mg ? lam_pos(j, P, ts) : 0;
    pos[2 * r + 1] = j < mg ? lam_pos(j + 1, P, ts) : 0;
  }
}

// Float4s of a reverse chain loaded one batch ahead of the sums
constexpr int kChainQuads = 4;

// s[v] += x[v][m] l[m] for m = 0 .. nt - 1 and each of the kN operands,
// in that order, each product one rounded multiply-add (__fmaf_rn) as in
// the one-block reverse kernels' column sums; x[v] and l 16-byte aligned.
// Whole float4s go in batches of kChainQuads, each loaded while the batch
// before it is summed (whole pairs of batches without a test on the sums:
// a test there cost a branch a float4); the last nt mod 4 terms one by
// one.
template <int kN>
__device__ __forceinline__ void chain_sums(const float* const (&x)[kN], const float* l, int nt,
                                           float (&s)[kN]) {
  const int nq = nt / 4;
  float4 xa[kN][kChainQuads], la[kChainQuads], xb[kN][kChainQuads], lb[kChainQuads];
  const auto load = [&](float4 (&xv)[kN][kChainQuads], float4 (&lv)[kChainQuads], int q0) {
#pragma unroll
    for (int u = 0; u < kChainQuads; ++u) {
      if (q0 + u < nq) {
        lv[u] = reinterpret_cast<const float4*>(l)[q0 + u];
#pragma unroll
        for (int v = 0; v < kN; ++v) xv[v][u] = reinterpret_cast<const float4*>(x[v])[q0 + u];
      }
    }
  };
  const auto sum = [&](const float4 (&xv)[kN][kChainQuads], const float4 (&lv)[kChainQuads],
                       int left) {  // the first min(left, kChainQuads) float4s
#pragma unroll
    for (int u = 0; u < kChainQuads; ++u) {
      if (u < left) {
#pragma unroll
        for (int v = 0; v < kN; ++v) {
          s[v] = __fmaf_rn(xv[v][u].x, lv[u].x, s[v]);
          s[v] = __fmaf_rn(xv[v][u].y, lv[u].y, s[v]);
          s[v] = __fmaf_rn(xv[v][u].z, lv[u].z, s[v]);
          s[v] = __fmaf_rn(xv[v][u].w, lv[u].w, s[v]);
        }
      }
    }
  };
  load(xa, la, 0);
  int q0 = 0;
  for (; q0 + 2 * kChainQuads <= nq; q0 += 2 * kChainQuads) {
    load(xb, lb, q0 + kChainQuads);
    sum(xa, la, kChainQuads);
    load(xa, la, q0 + 2 * kChainQuads);
    sum(xb, lb, kChainQuads);
  }
  if (q0 < nq) {  // fewer than 2 kChainQuads float4s left
    load(xb, lb, q0 + kChainQuads);
    sum(xa, la, nq - q0);
    sum(xb, lb, nq - q0 - kChainQuads);
  }
  for (int m = 4 * nq; m < nt; ++m) {
#pragma unroll
    for (int v = 0; v < kN; ++v) s[v] = __fmaf_rn(x[v][m], l[m], s[v]);
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
