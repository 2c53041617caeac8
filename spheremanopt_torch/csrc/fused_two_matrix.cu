// Two-matrix fused SBDF integrator for SHB23: u' = A u + B (c2 u^2 + c3 u^3).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_two_matrix.py:
//   sm_fused_fwd, sm_fused_fwd_block
//                 <- _fwd_kernel (_run_fwd; has_traj and has_ser as the
//                    traj / ser pointers): the cluster route and the
//                    one-block route of the same forward
//   sm_fused_bwd, sm_fused_bwd_block
//                 <- _bwd_kernel (_run_bwd): the cluster route and the
//                    one-block route of the same reverse sweep; with
//                    op_grads it stores the lambda history that op_grads.cu
//                    turns into dA and dB (the `lam_hist` pointer)
//
// SHB23's step has two dense (mg, mg) f32 propagators: A = A_lin (the
// Chebyshev-tau solve of the linear operator, entries ~1/dt) and
// B = A_nl (the same solve behind the dealias projector), 1 MiB each at
// mg = 512, over 2000 sequential steps.
//
// What bounds them on an H100: each step is two batch-1 GEMVs, and the
// steps depend on each other, so a step's time is latency: reading
// 2 MiB of A and B (at mg = 512) and passing one barrier. Its arithmetic,
// 2 * 2 mg^2 flop, takes ~16 ns at the card's f32 peak; the sweep's bound
// is 31.5 us of operations.
//
// sm_fused_fwd (forward, mg <= 640): one thread-block cluster of 16 CTAs
// on 16 SMs. The TPU kernel keeps both matrices in VMEM for the whole
// solve; one SM's 227 KB of shared memory holds neither, but 16 SMs hold
// both: CTA rank r keeps rows [r mg/16, (r+1) mg/16) of A and of B in its
// shared memory (2 x 64 KB at mg = 512) for all N steps, and every CTA
// keeps all of u (ping-pong), g and w. A step:
//   * every CTA forms g = c2 u^2 + c3 u^3 from its full copy of u;
//   * each warp computes its rows' dot products in the lane and k order
//     of the one-block kernel below (fwd_dot4), so u, the trajectory and
//     J come out bitwise equal to it;
//   * each row's value goes into every CTA's next-u buffer through
//     distributed shared memory (lane l < 16 stores to rank l), and one
//     cluster.sync() a step publishes it (u is double-buffered, so one
//     barrier is enough);
//   * the trajectory: each CTA stores its own slice of the row; J and
//     the series: rank 0, from its local u, with the one-block kernel's
//     1024-thread reduction tree (energy_partials), its last level
//     overlapped with rank 0's share of the product.
// A and B are read once from device memory; a step reads ~160 KB of
// shared memory per SM (the rows, then u and g once per warp) and passes
// one cluster barrier: 2.2 us a step on an H100 SXM at 700 W, against
// 21 us for the one-block kernel at mg = 512.
// The cluster holds the operators while 2 mg^2 4 / 16 bytes fit one SM
// (mg <= 640); a larger mg takes sm_fused_fwd_block, one thread block
// that streams A and B from the 50 MB L2 every step (one warp per row,
// float4 loads), bound by one SM's L2 read rate (~191 GB/s measured).
// The wrapper chooses by shape; each route launches its kernel or fails.
//
// sm_fused_bwd (reverse, mg <= 640): the forward's cluster transposed.
// lambda_n = A^T lambda + g'(u_n) (B^T lambda) + s w u_n needs columns of
// A and B, so CTA rank r keeps columns [r mg/16, (r+1) mg/16) of A and of
// B in its shared memory for the whole sweep, and every CTA keeps all of
// lambda (ping-pong). A step:
//   * the CTA's P x (mg/16) threads (P = 1024 / (mg/4) row phases) form
//     the column partial sums over rows p, p + P, ... in ascending order,
//     exactly as the one-block kernel's threads (p, column group) do for
//     each of their four columns;
//   * each new entry adds the P partials in phase order and applies the
//     pinned update of common.cuh, from the CTA's slice of the trajectory
//     row (loaded while the partial sums run), and goes into every CTA's
//     next-lambda buffer through distributed shared memory; one
//     cluster.sync() a step publishes it;
//   * with the lambda history, each CTA stores its slice of lambda_{n+1}.
// With that order lambda_0 and the history are bitwise the one-block
// kernel's. The cost: only P x (mg/16) = 240-256 threads a CTA, each a
// dependent chain of mg / P multiply-adds per matrix (64 at mg = 512),
// reading 2 mg^2 4 / 16 bytes of shared memory a step.
// A larger mg takes sm_fused_bwd_block: one thread block; A and B stay in
// global memory and L2. It computes A^T lambda and B^T lambda in a
// column-partitioned loop (thread (p, column group) sums rows p, p + P,
// ... of four columns), with one lambda read per row for both products;
// the state (lambda, partials) lives in shared memory.
//
// The energy series is a template flag, chosen from the `ser` pointer at
// launch, as in fused_shared.cu (a runtime test sits on thread 0's
// per-step path); the pinned rounding of common.cuh keeps J bitwise the
// same in both instantiations. The lambda history of the reverse sweep
// is a template flag too, chosen from `lam_hist`; with the update's
// rounding pinned in common.cuh, lambda_0 is bitwise the same in both
// instantiations.
//
// The launchers launch on the given stream, do not synchronise, and
// return cudaGetLastError() (or the launch's error). The caller
// guarantees mg % 128 == 0, 128 <= mg <= 2048 (sm_fused_fwd and
// sm_fused_bwd: mg <= 640), contiguous f32 buffers on one device.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using smo::kThreads;
using smo::kWarps;

// g(u) = c2 u^2 + c3 u^3 and one float4 of a row's dot products with u
// and g(u): written once for both forward kernels, so the cluster's u
// is bitwise the one-block kernel's.
__device__ __forceinline__ float g_poly(float c2, float c3, float u) {
  return c2 * u * u + c3 * u * u * u;
}

__device__ __forceinline__ float fwd_dot4(float s, const float4 aa, const float4 uu,
                                          const float4 bb, const float4 gg) {
  s += aa.x * uu.x + aa.y * uu.y + aa.z * uu.z + aa.w * uu.w;
  s += bb.x * gg.x + bb.y * gg.y + bb.z * gg.z + bb.w * gg.w;
  return s;
}

// Forward, one block (sm_fused_fwd_block): N steps; J_sum = Kahan sum
// over n = 0..N of sum_j w_j u_n,j^2. traj (N rows) is written when
// non-null, ser (N + 1 energies) when kSeries. Shared memory: u[2][mg]
// (ping-pong), g[mg], w[mg], red[32].
template <bool kSeries>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ w, const float* __restrict__ u0,
                 float c2, float c3, int n_steps, int mg, float* __restrict__ uT,
                 float* __restrict__ jsum, float* __restrict__ traj,
                 float* __restrict__ ser) {
  extern __shared__ float4 smem4[];
  float* u = reinterpret_cast<float*>(smem4);
  float* un = u + mg;
  float* g = un + mg;
  float* ws = g + mg;
  float* red = ws + mg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg4 = mg / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* g4 = reinterpret_cast<const float4*>(g);

  for (int j = tid; j < mg; j += kThreads) {
    u[j] = u0[j];
    ws[j] = w[j];
  }
  __syncthreads();

  float acc = 0.f, comp = 0.f;  // live in thread 0
  for (int n = 0; n < n_steps; ++n) {
    // pre-step state: energy partials, trajectory row, g = c2 u^2 + c3 u^3
    float part = 0.f;
    for (int j = tid; j < mg; j += kThreads) {
      const float uj = u[j];
      part = smo::add_energy(part, ws[j], uj);
      if (traj != nullptr) traj[(size_t)n * mg + j] = uj;
      g[j] = g_poly(c2, c3, uj);
    }
    const float e = smo::block_sum(part, red);  // its __syncthreads publishes g
    if (tid == 0) {
      if constexpr (kSeries) ser[n] = e;
      smo::kahan_add(acc, comp, e);
    }
    // un = A u + B g: one warp per row pair, float4 loads across the rows
    const float4* u4 = reinterpret_cast<const float4*>(u);
    for (int r = warp; r < mg; r += kWarps) {
      const float4* arow = a4 + (size_t)r * mg4;
      const float4* brow = b4 + (size_t)r * mg4;
      float s = 0.f;
#pragma unroll 4
      for (int k = lane; k < mg4; k += 32) {
        s = fwd_dot4(s, __ldg(arow + k), u4[k], __ldg(brow + k), g4[k]);
      }
      s = smo::warp_sum(s);
      if (lane == 0) un[r] = s;
    }
    __syncthreads();  // un complete; u and g free for the next step
    float* t = u;
    u = un;
    un = t;
  }

  float part = 0.f;
  for (int j = tid; j < mg; j += kThreads) {
    const float uj = u[j];
    part = smo::add_energy(part, ws[j], uj);
    uT[j] = uj;
  }
  const float eN = smo::block_sum(part, red);
  if (tid == 0) {
    if constexpr (kSeries) ser[n_steps] = eN;
    smo::kahan_add(acc, comp, eN);
    *jsum = acc;
  }
}

// Forward, one cluster (sm_fused_fwd): the same recurrence, J and
// outputs as fused_fwd_kernel, on kClusterCtas CTAs of kClusterThreads
// threads, mg = 128 R. Each warp owns R rows (rank's rows warp, warp + 8,
// ...) and a lane R float4s of each: those of k = lane + 32 i, the
// one-block kernel's k order. Shared memory: A rows, B rows (8 R x mg
// each), u[2][mg], g[mg], w[mg], red[32].
constexpr int kClusterCtas = 16;
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kRefWarps = kThreads / 32;   // the one-block kernel's reduction tree

__host__ __device__ constexpr size_t cluster_smem_bytes(int R) {
  return (2 * (size_t)(8 * R) * (128 * R) + 4 * (size_t)(128 * R) + 32) * sizeof(float);
}

// sum_j w_j u_j^2 as fused_fwd_kernel's block_sum forms it (thread j of
// 1024 holds w_j u_j^2, then warp sums, then a sum of the 32 warp sums),
// with this block's warps standing in for the 1024-thread block's: the
// warp sums go to red[32]. A __syncthreads must pass before red is read.
__device__ __forceinline__ void energy_partials(const float* u, const float* ws, int mg,
                                                float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kRefWarps / kClusterWarps;
  float p[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int j = (warp + v * kClusterWarps) * 32 + lane;
    p[v] = j < mg ? smo::add_energy(0.f, ws[j], u[j]) : 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < kPer; ++v) p[v] += __shfl_xor_sync(0xffffffffu, p[v], off);
  if (lane == 0)
#pragma unroll
    for (int v = 0; v < kPer; ++v) red[warp + v * kClusterWarps] = p[v];
}

template <bool kSeries, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_fwd_cluster_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ w, const float* __restrict__ u0,
                         float c2, float c3, int n_steps, float* __restrict__ uT,
                         float* __restrict__ jsum, float* __restrict__ traj,
                         float* __restrict__ ser) {
  constexpr int mg = 128 * R, mg4 = mg / 4, rows = mg / kClusterCtas;
  static_assert(rows == kClusterWarps * R, "one warp per R rows");
  static_assert(mg <= kThreads, "one element per thread of the reduction tree");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rank * rows;
  extern __shared__ float4 smem4[];
  float4* as4 = smem4;                 // rows x mg4
  float4* bs4 = as4 + rows * mg4;
  float* u = reinterpret_cast<float*>(bs4 + rows * mg4);
  float* un = u + mg;
  float* g = un + mg;
  float* ws = g + mg;
  float* red = ws + mg;
  const float4* g4 = reinterpret_cast<const float4*>(g);

  const float4* a4 = reinterpret_cast<const float4*>(a) + (size_t)r0 * mg4;
  const float4* b4 = reinterpret_cast<const float4*>(b) + (size_t)r0 * mg4;
  for (int i = tid; i < rows * mg4; i += kClusterThreads) {
    as4[i] = __ldg(a4 + i);
    bs4[i] = __ldg(b4 + i);
  }
  for (int j = tid; j < mg; j += kClusterThreads) {
    u[j] = u0[j];
    ws[j] = w[j];
  }
  cluster.sync();   // every CTA has started and holds u_0 before any remote store

  float acc = 0.f, comp = 0.f;  // live in rank 0's thread 0
  for (int n = 0; n < n_steps; ++n) {
    for (int j = tid; j < mg; j += kClusterThreads) g[j] = g_poly(c2, c3, u[j]);
    if (traj != nullptr && tid < rows) traj[(size_t)n * mg + r0 + tid] = u[r0 + tid];
    if (rank == 0) energy_partials(u, ws, mg, red);
    __syncthreads();   // g and red complete
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4 ur[R], gr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ur[i] = u4[lane + 32 * i];
      gr[i] = g4[lane + 32 * i];
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int rl = warp + q * kClusterWarps;
      const float4* arow = as4 + rl * mg4;
      const float4* brow = bs4 + rl * mg4;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i)
        s = fwd_dot4(s, arow[lane + 32 * i], ur[i], brow[lane + 32 * i], gr[i]);
      s = smo::warp_sum(s);   // every lane holds the same sum
      if (lane < kClusterCtas) cluster.map_shared_rank(un, lane)[r0 + rl] = s;
    }
    if (rank == 0 && warp == 0) {
      const float e = smo::warp_sum(red[lane]);
      if (lane == 0) {
        if constexpr (kSeries) ser[n] = e;
        smo::kahan_add(acc, comp, e);
      }
    }
    cluster.sync();   // un complete in every CTA; u, g and red free
    float* t = u;
    u = un;
    un = t;
  }

  if (tid < rows) uT[r0 + tid] = u[r0 + tid];
  if (rank == 0) {
    energy_partials(u, ws, mg, red);
    __syncthreads();
    if (warp == 0) {
      const float eN = smo::warp_sum(red[lane]);
      if (lane == 0) {
        if constexpr (kSeries) ser[n_steps] = eN;
        smo::kahan_add(acc, comp, eN);
        *jsum = acc;
      }
    }
  }
}

// The launch of one cluster of kClusterCtas CTAs of `threads` threads and
// `smem` bytes of dynamic shared memory. The kernel's attributes are set
// once per device; `ready` is the flag set of that kernel.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int threads,
                           bool (&ready)[smo::kMaxDevices], cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr, cudaStream_t st) {
  const cudaError_t err = smo::set_once(ready, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kClusterCtas);
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
int cluster_capacity(Kernel kernel, size_t smem, int threads,
                     bool (&ready)[smo::kMaxDevices]) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, smem, threads, ready, cfg, attr, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename Kernel, typename... Args>
int cluster_launch(Kernel kernel, size_t smem, int threads, bool (&ready)[smo::kMaxDevices],
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, smem, threads, ready, cfg, attr, st);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kSeries, int R>
struct FwdCluster {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity() {
    return cluster_capacity(fused_fwd_cluster_kernel<kSeries, R>, cluster_smem_bytes(R),
                            kClusterThreads, ready);
  }
  static int launch(cudaStream_t st, const float* a, const float* b, const float* w,
                    const float* u0, float c2, float c3, int n_steps, float* uT, float* jsum,
                    float* traj, float* ser) {
    return cluster_launch(fused_fwd_cluster_kernel<kSeries, R>, cluster_smem_bytes(R),
                          kClusterThreads, ready, st, a, b, w, u0, c2, c3, n_steps, uT,
                          jsum, traj, ser);
  }
};

// K<V, R>::launch(args...) and K<V, R>::capacity() for the R of
// mg = 128 R (the cluster kernels' widths), or cudaErrorInvalidValue
template <template <bool, int> class K, bool V, typename... Args>
int launch_by_mg(int mg, Args... args) {
  switch (mg) {
    case 128: return K<V, 1>::launch(args...);
    case 256: return K<V, 2>::launch(args...);
    case 384: return K<V, 3>::launch(args...);
    case 512: return K<V, 4>::launch(args...);
    case 640: return K<V, 5>::launch(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <template <bool, int> class K, bool V>
int capacity_by_mg(int mg) {
  switch (mg) {
    case 128: return K<V, 1>::capacity();
    case 256: return K<V, 2>::capacity();
    case 384: return K<V, 3>::capacity();
    case 512: return K<V, 4>::capacity();
    case 640: return K<V, 5>::capacity();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward, one block (sm_fused_bwd_block): lambda_N = s w u_N, then for
// n = N-1..0
//   lambda_n = A^T lambda_{n+1} + (2 c2 u_n + 3 c3 u_n^2) * (B^T lambda_{n+1})
//              + s w u_n,
// with s = *scale and u_n = traj row n. Thread (p, cg) sums rows
// p, p + P, ... of column group cg (4 columns, one float4) of A and of
// B, each product one rounded multiply-add; the P partial sums of each
// meet in shared memory.
// With kLamHist, step n also stores the lambda_{n+1} it consumes as row n
// of lam_hist (N rows), for dA = sum_n lambda_{n+1} (x) u_n and
// dB = sum_n lambda_{n+1} (x) g(u_n) (op_grads.cu).
// Shared memory: lam[mg], partA[P * mg], partB[P * mg]
// (P * mg = 4 * active threads <= 4096 floats each).
template <bool kLamHist>
__global__ void __launch_bounds__(kThreads)
fused_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ w, const float* __restrict__ uT,
                 const float* __restrict__ traj, float c2, float c3,
                 const float* __restrict__ scale, int n_steps, int mg,
                 float* __restrict__ lam_out, float* __restrict__ lam_hist) {
  extern __shared__ float4 smem4[];
  const int ncg = mg / 4;
  const int P = kThreads / ncg;
  float* lam = reinterpret_cast<float*>(smem4);
  float4* pa4 = reinterpret_cast<float4*>(lam + mg);
  float4* pb4 = pa4 + (size_t)P * ncg;
  const float* pa = reinterpret_cast<const float*>(pa4);
  const float* pb = reinterpret_cast<const float*>(pb4);
  const int tid = threadIdx.x;
  const int cg = tid % ncg, p = tid / ncg;
  const bool active = p < P;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float s = *scale;

  for (int j = tid; j < mg; j += kThreads) lam[j] = smo::cost_term(s, w[j], uT[j]);
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float* urow = traj + row;
    if (active) {
      float4 sa = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 sb = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = p; i < mg; i += P) {
        const float4 aa = __ldg(a4 + (size_t)i * ncg + cg);
        const float4 bb = __ldg(b4 + (size_t)i * ncg + cg);
        const float l = lam[i];
        sa.x = __fmaf_rn(aa.x, l, sa.x);
        sa.y = __fmaf_rn(aa.y, l, sa.y);
        sa.z = __fmaf_rn(aa.z, l, sa.z);
        sa.w = __fmaf_rn(aa.w, l, sa.w);
        sb.x = __fmaf_rn(bb.x, l, sb.x);
        sb.y = __fmaf_rn(bb.y, l, sb.y);
        sb.z = __fmaf_rn(bb.z, l, sb.z);
        sb.w = __fmaf_rn(bb.w, l, sb.w);
      }
      pa4[p * ncg + cg] = sa;
      pb4[p * ncg + cg] = sb;
    }
    __syncthreads();  // all lam reads done, partials ready
    for (int j = tid; j < mg; j += kThreads) {
      float wa = 0.f, wb = 0.f;
      for (int q = 0; q < P; ++q) {
        wa += pa[q * mg + j];
        wb += pb[q * mg + j];
      }
      const float un = urow[j];
      const float gprime = smo::poly_prime(0.f, 2.f * c2, 3.f * c3, un);
      if constexpr (kLamHist) lam_hist[row + j] = lam[j];  // lambda_{n+1}
      lam[j] = __fadd_rn(__fmaf_rn(gprime, wb, wa), smo::cost_term(s, w[j], un));
    }
    __syncthreads();
  }
  for (int j = tid; j < mg; j += kThreads) lam_out[j] = lam[j];
}

// Backward, one cluster (sm_fused_bwd): the recurrence, lambda_0 and the
// history of fused_bwd_kernel on kClusterCtas CTAs of kClusterThreads
// threads, mg = 128 R. CTA rank r owns the C = mg / 16 columns from
// c0 = r C; thread t < P C stands in for the one-block kernel's thread
// (p, column group) for one column: p = t / C, column c0 + t % C, with the
// one-block kernel's P = 1024 / (mg / 4) row phases. Shared memory: A's
// and B's columns (mg x C each, row-major), lambda[2][mg] (ping-pong),
// the partials (P x C each), w and u_n of the columns.
__host__ __device__ constexpr int bwd_phases(int R) { return kThreads / (32 * R); }

__host__ __device__ constexpr size_t bwd_cluster_smem_bytes(int R) {
  return (2 * (size_t)(128 * R) * (8 * R) + 2 * (size_t)(128 * R)
          + 2 * (size_t)bwd_phases(R) * (8 * R) + 2 * (size_t)(8 * R)) * sizeof(float);
}

template <bool kLamHist, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_cluster_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ w, const float* __restrict__ uT,
                         const float* __restrict__ traj, float c2, float c3,
                         const float* __restrict__ scale, int n_steps,
                         float* __restrict__ lam_out, float* __restrict__ lam_hist) {
  constexpr int mg = 128 * R, C = mg / kClusterCtas, P = bwd_phases(R);
  static_assert(P * C <= kClusterThreads, "one thread per (phase, column)");
  static_assert(P == kThreads / (mg / 4), "the one-block kernel's row phases");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = rank * C;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [mg][C]
  float* bs = as + mg * C;
  float* lam = bs + mg * C;
  float* lamn = lam + mg;
  float* pa = lamn + mg;  // [P][C]
  float* pb = pa + P * C;
  float* ws = pb + P * C;  // [C]
  float* us = ws + C;      // [C]

  for (int idx = tid; idx < mg * C; idx += kClusterThreads) {
    const size_t src = (size_t)(idx / C) * mg + c0 + idx % C;
    as[idx] = __ldg(a + src);
    bs[idx] = __ldg(b + src);
  }
  const float s = *scale;
  for (int j = tid; j < mg; j += kClusterThreads) lam[j] = smo::cost_term(s, w[j], uT[j]);
  if (tid < C) ws[tid] = w[c0 + tid];
  cluster.sync();  // every CTA has started and holds lambda_N before any remote store

  const int p = tid / C, col = tid % C;
  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float un = tid < C ? traj[row + c0 + tid] : 0.f;  // in flight during the sums
    if (tid < P * C) {
      float sa = 0.f, sb = 0.f;
#pragma unroll 4
      for (int i = p; i < mg; i += P) {
        const float l = lam[i];
        sa = __fmaf_rn(as[i * C + col], l, sa);
        sb = __fmaf_rn(bs[i * C + col], l, sb);
      }
      pa[p * C + col] = sa;
      pb[p * C + col] = sb;
    }
    if (tid < C) us[tid] = un;
    __syncthreads();  // partials and u_n ready
    // (column, destination rank) pairs: the entry is formed once per
    // destination, consecutive threads store consecutive columns
    for (int t = tid; t < kClusterCtas * C; t += kClusterThreads) {
      const int c = t % C, dst = t / C;
      float wa = 0.f, wb = 0.f;
      for (int q = 0; q < P; ++q) {
        wa += pa[q * C + c];
        wb += pb[q * C + c];
      }
      const float u = us[c];
      const float gprime = smo::poly_prime(0.f, 2.f * c2, 3.f * c3, u);
      cluster.map_shared_rank(lamn, dst)[c0 + c] =
          __fadd_rn(__fmaf_rn(gprime, wb, wa), smo::cost_term(s, ws[c], u));
      if constexpr (kLamHist) {
        if (dst == rank) lam_hist[row + c0 + c] = lam[c0 + c];  // lambda_{n+1}
      }
    }
    cluster.sync();  // lamn complete in every CTA; lam, partials and u_n free
    float* t = lam;
    lam = lamn;
    lamn = t;
  }
  if (tid < C) lam_out[c0 + tid] = lam[c0 + tid];
}

template <bool kLamHist, int R>
struct BwdCluster {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity() {
    return cluster_capacity(fused_bwd_cluster_kernel<kLamHist, R>,
                            bwd_cluster_smem_bytes(R), kClusterThreads, ready);
  }
  static int launch(cudaStream_t st, const float* a, const float* b, const float* w,
                    const float* uT, const float* traj, float c2, float c3,
                    const float* scale, int n_steps, float* lam_out, float* lam_hist) {
    return cluster_launch(fused_bwd_cluster_kernel<kLamHist, R>, bwd_cluster_smem_bytes(R),
                          kClusterThreads, ready, st, a, b, w, uT, traj, c2, c3, scale,
                          n_steps, lam_out, lam_hist);
  }
};

}  // namespace

extern "C" {

int sm_fused_fwd(const float* a, const float* b, const float* w, const float* u0,
                 float c2, float c3, int n_steps, int mg, float* uT, float* jsum,
                 float* traj, float* ser, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ser != nullptr
             ? launch_by_mg<FwdCluster, true>(mg, st, a, b, w, u0, c2, c3, n_steps, uT, jsum,
                                              traj, ser)
             : launch_by_mg<FwdCluster, false>(mg, st, a, b, w, u0, c2, c3, n_steps, uT, jsum,
                                               traj, ser);
}

// Clusters of sm_fused_fwd (with the series when `series`) that the card
// can hold at once for this mg: 0 means it cannot be scheduled; a
// negative value is -cudaError_t.
int sm_fused_fwd_capacity(int mg, int series) {
  return series ? capacity_by_mg<FwdCluster, true>(mg) : capacity_by_mg<FwdCluster, false>(mg);
}

int sm_fused_fwd_block(const float* a, const float* b, const float* w, const float* u0,
                       float c2, float c3, int n_steps, int mg, float* uT, float* jsum,
                       float* traj, float* ser, void* stream) {
  const size_t smem = (4 * (size_t)mg + 32) * sizeof(float);
  const auto kernel = ser != nullptr ? fused_fwd_kernel<true> : fused_fwd_kernel<false>;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, w, u0, c2, c3, n_steps, mg, uT, jsum, traj, ser);
  return static_cast<int>(cudaGetLastError());
}

int sm_fused_bwd(const float* a, const float* b, const float* w, const float* uT,
                 const float* traj, float c2, float c3, const float* scale,
                 int n_steps, int mg, float* lam_out, float* lam_hist,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lam_hist != nullptr
             ? launch_by_mg<BwdCluster, true>(mg, st, a, b, w, uT, traj, c2, c3, scale,
                                              n_steps, lam_out, lam_hist)
             : launch_by_mg<BwdCluster, false>(mg, st, a, b, w, uT, traj, c2, c3, scale,
                                               n_steps, lam_out, lam_hist);
}

// Clusters of sm_fused_bwd (with the lambda history when `hist`) that the
// card can hold at once for this mg, as sm_fused_fwd_capacity.
int sm_fused_bwd_capacity(int mg, int hist) {
  return hist ? capacity_by_mg<BwdCluster, true>(mg) : capacity_by_mg<BwdCluster, false>(mg);
}

int sm_fused_bwd_block(const float* a, const float* b, const float* w, const float* uT,
                       const float* traj, float c2, float c3, const float* scale,
                       int n_steps, int mg, float* lam_out, float* lam_hist,
                       void* stream) {
  const int ncg = mg / 4;
  const int P = kThreads / ncg;
  const size_t smem = ((size_t)mg + 8 * (size_t)P * ncg) * sizeof(float);
  const auto kernel = lam_hist != nullptr ? fused_bwd_kernel<true>
                                          : fused_bwd_kernel<false>;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, w, uT, traj, c2, c3, scale, n_steps, mg, lam_out, lam_hist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
