// Shared-matrix fused SBDF integrator for SH23: u' = B (lin u + c2 u^2 + c3 u^3).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_two_matrix.py:
//   sm_fused_fwd_shared_grid, sm_fused_fwd_shared_block
//                        <- _fwd_kernel_shared (_run_fwd_shared; has_traj
//                           and has_ser as the traj / ser pointers): the
//                           grid-wide route and the one-block route of the
//                           same forward
//   sm_fused_bwd_shared, sm_fused_bwd_shared_grid, sm_fused_bwd_shared_block
//                        <- _bwd_kernel_shared (_run_bwd_shared): the cluster
//                           route, the grid-wide route and the one-block
//                           route of the same reverse sweep; with op_grads
//                           it stores the lambda history that op_grads.cu
//                           turns into dB (the `lam_hist` pointer)
//   sm_fused_fwd_shared_rows, sm_fused_bwd_shared_rows
//                        <- the same two kernels under jax.vmap (a sweep's
//                           R rows: pallas_call's batching rule gives each
//                           a grid over the rows, one launch for all of
//                           them): R forwards in one grid launch, R reverse
//                           clusters in one launch
//
// What bounds them on an H100: every step is a batch-1 GEMV with the
// (mg, mg) f32 step matrix B (1 MiB at mg = 512), and the steps are
// sequential, so a step's time is latency: reading B and passing a
// barrier. Its arithmetic, 2 mg^2 flop, takes ~8 ns at the card's f32 peak.
// The TPU kernel keeps B in VMEM for the whole solve; one SM's 227 KB of
// shared memory cannot hold it.
//
// sm_fused_fwd_shared_grid (forward, every mg <= 2048 whose rows of B and
// the state fit a CTA: every width on an H100 SXM and an H100 PCIe): the
// two-matrix grid forward of fused_two_matrix.cu with one matrix. One
// persistent cooperative kernel, one CTA on each of up to all SMs: CTA b
// keeps rows = ceil(mg / SMs) contiguous rows of B (4 at mg = 512, 8 KB;
// 8 at 1024, 32 KB; 16 at 2048, 128 KB) in shared memory for the whole
// solve; u crosses through L2 as step-tagged 64-bit words (grid.cuh),
// every CTA reads all of u_n and forms v itself (v_poly, shared with the
// one-block kernel), each warp computes its rows' dot products in the
// one-block kernel's lane and k order (shared_dot4), and CTA 0 forms J and
// the series with the one-block kernel's reduction tree (energy_partials,
// cluster.cuh). u_T, J, the trajectory and the series are bitwise the
// one-block kernel's. The wrapper raises if the card cannot hold the CTAs
// at once. It replaced a 16-CTA cluster that kept B's rows on 16 SMs and
// passed u through distributed shared memory with one cluster.sync() a
// step: at N = 200 the grid took 0.239 / 0.262 / 0.381 / 0.333 ms against
// the cluster's 0.297 / 0.389 / 0.461 / 0.614 at mg = 256 / 512 / 640 /
// 896 (H100 SXM at 700 W, tools/time_reverse_sweeps.py).
// sm_fused_fwd_shared_block is one block of 1024 threads on one SM that
// streams B from the 50 MB L2 every step (one warp per row, float4 loads),
// bound by one SM's L2 read rate: the route where a CTA's rows do not fit,
// and the kernel the grid is held to bit for bit. The wrapper chooses by
// shape; each route launches its kernel or fails.
//
// sm_fused_bwd_shared (reverse, mg <= 896): one thread-block cluster of
// 16 CTAs on 16 SMs, the two-matrix reverse cluster of
// fused_two_matrix.cu with one matrix. lambda_n = v'(u_n) (B^T lambda)
// + s w u_n needs columns of B, so CTA rank r keeps columns
// [r mg/16, (r+1) mg/16) of B in its shared memory (64 KB at mg = 512) for
// the whole sweep, and every CTA keeps all of lambda (ping-pong). A step:
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
// kernel's. mg^2 4 / 16 bytes of columns and 2 mg + (P + 2) mg / 16 floats
// of state fit 227 KB up to mg = 896.
// sm_fused_bwd_shared_grid (reverse, mg > 896 while a CTA's columns of B
// and the state fit: every width on an H100 SXM and PCIe): the two-matrix
// grid reverse of fused_two_matrix.cu with one matrix. CTA c keeps cols =
// ceil(mg / SMs) contiguous columns of B (64 KB at mg = 1024, 128 KB at
// 2048) in shared memory as its threads' chains, and lambda as each
// phase's chain; the chains keep the one-block kernel's order, and lambda
// crosses between the CTAs as step-tagged words. lambda_0 and the history
// are bitwise the one-block kernel's. Why the cluster stays at mg <= 896:
// at N = 200 the grid took 0.359 ms at mg = 512 against the cluster's
// 0.294-0.300, and 0.39 / 0.34 / 0.37 against 0.19 / 0.18 / 0.28 at
// mg = 128 / 256 / 384 (its exchange through L2 costs more a step than
// the cluster's barrier); it was ahead from mg = 640 on, 0.408 / 0.407 /
// 0.481 against 0.434-0.444 / 0.523-0.534 / 0.682-0.687 at mg = 640 / 768 /
// 896, which stay the cluster's (H100 SXM at 700 W,
// tools/time_reverse_sweeps.py).
// sm_fused_bwd_shared_block: one thread block; B stays in global memory
// and, after the first step, in L2; the small state (lambda, the partial
// sums) lives in shared memory. Thread (p, column group) sums rows p,
// p + P, ... of four columns. It is the route only where a grid's columns
// do not fit, and the kernel the cluster and the grid are held to bit for
// bit. The wrapper chooses by shape; each route launches its kernel or
// fails.
//
// Rows (a sweep of R independent starting points, the vmapped form):
// sm_fused_fwd_shared_rows is the grid forward over up to kMaxStates = 8
// states at once (smo::fwd_rows in grid.cuh). A step is R GEMVs with the
// same B, so each warp reads a float4 of its row of B from shared memory
// once and applies it to all R states' v (one register chain per state,
// each in the one-row kernel's order): one step's latency (the exchange
// through L2, which now carries R vectors) serves R rows. CTA s forms
// state s's J, so no CTA sums more
// than one energy a step (with all of them on CTA 0 and the reads 4
// rounds deep the forward took 6.275 ms at R = 8, mg = 512, N = 1000;
// 3.717 with them spread and the reads 8 deep); the
// wrapper splits B's rows over 64 CTAs (`rows_partition`), which beat one
// CTA an SM at R = 8 (3.385 against 3.757 ms: each CTA reads the R vectors
// back every step, so fewer CTAs move fewer bytes through L2; H100 SXM at
// 700 W, chip_smoke.py phase 5 and tools/time_row_kernels.py).
// sm_fused_bwd_shared_rows launches the
// reverse cluster once per row, R clusters in one launch; the clusters are
// independent, so those the card holds at once run side by side. Each
// row's u_T, J, trajectory and lambda_0 are bitwise the one-row kernels'
// on that row. Only the mg <= 896 widths of the cluster have row kernels;
// a wider sweep runs its rows one at a time (the wrapper raises there).
//
// The energy series is a template flag, chosen from the `ser` pointer at
// launch: a runtime test of the pointer on thread 0's per-step path made
// every step measurably slower on an H100. J stays bitwise the
// same in both instantiations because the energy term and the Kahan step
// round as common.cuh pins them. The lambda history of the reverse sweep
// is a template flag for the same reason, chosen from `lam_hist`; the
// store does not touch lambda's arithmetic, and the update rounds as
// common.cuh pins it, so lambda_0 is bitwise the same in both
// instantiations.
//
// The launchers launch on the given stream, do not synchronise, and
// return cudaGetLastError() (or the launch's error) so the caller can
// raise on a refused launch. The caller guarantees mg % 128 == 0,
// 128 <= mg <= 2048 (sm_fused_bwd_shared: mg <= 896), contiguous f32
// buffers on one device. The grids launch cooperatively, so a grid that
// the card cannot hold at once fails at launch; a word that never gets its
// tag traps (a launch failure), it does not hang.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"
#include "grid.cuh"

namespace cg = cooperative_groups;

namespace {

using smo::row_phases;
using smo::kClusterCtas;
using smo::kClusterThreads;
using smo::kClusterWarps;
using smo::kMaxStates;
using smo::kThreads;
using smo::kWarps;

// The reverse cluster holds B's columns while mg^2 4 / 16 bytes fit one
// SM: instances for mg = 128 R, R <= kMaxR.
constexpr int kMaxR = 7;

// v(u) = lin u + c2 u^2 + c3 u^3 and one float4 of a row's dot product
// with v: written once for both forward kernels, so that the grid's u
// is bitwise the one-block kernel's.
__device__ __forceinline__ float v_poly(float lin, float c2, float c3, float u) {
  return lin * u + c2 * u * u + c3 * u * u * u;
}

__device__ __forceinline__ float shared_dot4(float s, const float4 bb, const float4 vv) {
  s += bb.x * vv.x + bb.y * vv.y + bb.z * vv.z + bb.w * vv.w;
  return s;
}

// Forward, one block (sm_fused_fwd_shared_block): N steps; J_sum = Kahan
// sum over n = 0..N of sum_j w_j u_n,j^2. traj (N rows) is written when
// non-null, ser (N + 1 energies) when kSeries. Shared memory: u[mg],
// v[mg], w[mg], red[32].
template <bool kSeries>
__global__ void __launch_bounds__(kThreads)
fused_fwd_shared_kernel(const float* __restrict__ b, const float* __restrict__ w,
                        const float* __restrict__ u0, float c2, float c3, float lin,
                        int n_steps, int mg, float* __restrict__ uT,
                        float* __restrict__ jsum, float* __restrict__ traj,
                        float* __restrict__ ser) {
  extern __shared__ float4 smem4[];
  float* u = reinterpret_cast<float*>(smem4);
  float* v = u + mg;
  float* ws = v + mg;
  float* red = ws + mg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg4 = mg / 4;
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* v4 = reinterpret_cast<const float4*>(v);

  for (int j = tid; j < mg; j += kThreads) {
    u[j] = u0[j];
    ws[j] = w[j];
  }
  __syncthreads();

  float acc = 0.f, comp = 0.f;  // live in thread 0
  for (int n = 0; n < n_steps; ++n) {
    // pre-step state: energy partials, trajectory row, v = lin u + g(u)
    float part = 0.f;
    for (int j = tid; j < mg; j += kThreads) {
      const float uj = u[j];
      part = smo::add_energy(part, ws[j], uj);
      if (traj != nullptr) traj[(size_t)n * mg + j] = uj;
      v[j] = v_poly(lin, c2, c3, uj);
    }
    const float e = smo::block_sum(part, red);  // its __syncthreads publishes v
    if (tid == 0) {
      if constexpr (kSeries) ser[n] = e;
      smo::kahan_add(acc, comp, e);
    }
    // u_new = B v: one warp per row, float4 loads across the row
    for (int r = warp; r < mg; r += kWarps) {
      const float4* row = b4 + (size_t)r * mg4;
      float s = 0.f;
#pragma unroll 4
      for (int k = lane; k < mg4; k += 32) s = shared_dot4(s, __ldg(row + k), v4[k]);
      s = smo::warp_sum(s);
      if (lane == 0) u[r] = s;
    }
    __syncthreads();
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

// Forward, grid-wide (sm_fused_fwd_shared_grid): the recurrence, J and
// outputs of fused_fwd_shared_kernel on ceil(mg / rows) co-resident CTAs
// of kClusterThreads threads, the two-matrix grid forward of
// fused_two_matrix.cu with one matrix; CTA b owns rows [b rows,
// min((b + 1) rows, mg)), warp w its rows w, w + 8, ... ubuf (4 mg
// floats) holds two slots of mg (value, tag) pairs (grid.cuh): step n
// reads u_n (u0 at n = 0, else slot (n - 1) & 1, tag n) and writes u_{n+1}
// to slot n & 1 with tag n + 1. Shared memory: B rows (rows x mg), u[mg],
// v[mg], w[mg], red[32].
__host__ __device__ constexpr size_t shared_grid_smem_bytes(int mg, int rows) {
  return ((size_t)rows * mg + 3 * (size_t)mg + 32) * sizeof(float);
}

template <bool kSeries>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_fwd_shared_grid_kernel(const float* __restrict__ b, const float* __restrict__ w,
                             const float* __restrict__ u0, float c2, float c3, float lin,
                             int n_steps, int mg, int rows, float* __restrict__ uT,
                             float* __restrict__ jsum, float* __restrict__ traj,
                             float* __restrict__ ser, float* __restrict__ ubuf) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg4 = mg / 4, r0 = blockIdx.x * rows;
  const int nr = min(rows, mg - r0);
  const bool lead = blockIdx.x == 0;
  extern __shared__ float4 smem4[];
  float4* bs4 = smem4;  // rows x mg4
  float4* u4 = bs4 + (size_t)rows * mg4;
  float4* v4 = u4 + mg4;
  float* u = reinterpret_cast<float*>(u4);
  float* v = reinterpret_cast<float*>(v4);
  float* ws = v + mg;
  float* red = ws + mg;
  auto* pairs = reinterpret_cast<unsigned long long*>(ubuf);  // [2][mg] (value, tag)
  const auto vp = [=](float x) { return v_poly(lin, c2, c3, x); };

  const float4* b4 = reinterpret_cast<const float4*>(b) + (size_t)r0 * mg4;
  for (int i = tid; i < nr * mg4; i += kClusterThreads) bs4[i] = __ldg(b4 + i);
  if (lead)
    for (int j = tid; j < mg; j += kClusterThreads) ws[j] = w[j];
  for (int i = blockIdx.x * kClusterThreads + tid; i < 2 * mg; i += gridDim.x * kClusterThreads)
    pairs[i] = 0ull;  // no tag: steps count from 1
  grid.sync();      // the tags are clear before any CTA stores u_1

  float acc = 0.f, comp = 0.f;  // live in CTA 0's thread 0
  for (int n = 0; n < n_steps; ++n) {
    if (n == 0) {
      for (int j = tid; j < mg; j += kClusterThreads) {
        const float x = u0[j];
        u[j] = x;
        v[j] = vp(x);
      }
    } else {
      smo::read_tagged(pairs + (size_t)((n - 1) & 1) * mg, n, mg, vp, u, v);
    }
    __syncthreads();  // u and v complete (and at n = 0 the rows and w)
    if (traj != nullptr)
      for (int i = tid; i < nr; i += kClusterThreads) traj[(size_t)n * mg + r0 + i] = u[r0 + i];
    if (lead) {
      smo::energy_partials(u, ws, mg, red);
      __syncthreads();  // red complete
    }
    unsigned long long* dst = pairs + (size_t)(n & 1) * mg;
    for (int rl = warp; rl < nr; rl += kClusterWarps) {
      const float4* row = bs4 + (size_t)rl * mg4;
      float s = 0.f;
#pragma unroll 4
      for (int k = lane; k < mg4; k += 32) s = shared_dot4(s, row[k], v4[k]);
      s = smo::warp_sum(s);
      if (lane == 0) smo::store_tagged(dst + r0 + rl, s, n + 1);
    }
    if (lead && warp == 0) {
      const float e = smo::warp_sum(red[lane]);
      if (lane == 0) {
        if constexpr (kSeries) ser[n] = e;
        smo::kahan_add(acc, comp, e);
      }
    }
    __syncthreads();  // u, v and red free for the next step
  }

  // u_N: each CTA stores its rows of u_T; CTA 0 forms e_N and J
  if (n_steps == 0) {
    for (int j = tid; j < mg; j += kClusterThreads) u[j] = u0[j];
  } else {
    smo::read_tagged(pairs + (size_t)((n_steps - 1) & 1) * mg, n_steps, mg, vp, u,
                     static_cast<float*>(nullptr));
  }
  __syncthreads();
  for (int i = tid; i < nr; i += kClusterThreads) uT[r0 + i] = u[r0 + i];
  if (lead) {
    smo::energy_partials(u, ws, mg, red);
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

template <bool kSeries>
struct FwdSharedGrid {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity(int mg, int rows) {
    return smo::grid_capacity(fused_fwd_shared_grid_kernel<kSeries>,
                              shared_grid_smem_bytes(mg, rows), ready);
  }
  static int launch(const float* b, const float* w, const float* u0, float c2, float c3,
                    float lin, int n_steps, int mg, int rows, float* uT, float* jsum,
                    float* traj, float* ser, float* ubuf, cudaStream_t st) {
    return smo::grid_launch(fused_fwd_shared_grid_kernel<kSeries>, (mg + rows - 1) / rows,
                            shared_grid_smem_bytes(mg, rows), ready, st, b, w, u0, c2, c3, lin,
                            n_steps, mg, rows, uT, jsum, traj, ser, ubuf);
  }
};

// Backward, one block (sm_fused_bwd_shared_block): lambda_N = s w u_N,
// then for n = N-1..0
//   lambda_n = (lin + 2 c2 u_n + 3 c3 u_n^2) * (B^T lambda_{n+1}) + s w u_n,
// with s = *scale and u_n = traj row n. Thread (p, cg) sums rows
// p, p + P, ... of column group cg (4 columns, one float4), each product
// one rounded multiply-add, pinned so that the cluster and the grid
// reproduce it; the P partial sums meet in shared memory.
// With kLamHist, step n also stores the lambda_{n+1} it consumes as row n
// of lam_hist (N rows), for the operator cotangent dB = sum_n
// lambda_{n+1} (x) v(u_n) (op_grads.cu).
// Shared memory: lam[mg], part[P * mg] (P * mg = 4 * active threads).
template <bool kLamHist>
__global__ void __launch_bounds__(kThreads)
fused_bwd_shared_kernel(const float* __restrict__ b, const float* __restrict__ w,
                        const float* __restrict__ uT, const float* __restrict__ traj,
                        float c2, float c3, float lin, const float* __restrict__ scale,
                        int n_steps, int mg, float* __restrict__ lam_out,
                        float* __restrict__ lam_hist) {
  extern __shared__ float4 smem4[];
  const int ncg = mg / 4;
  const int P = kThreads / ncg;
  float* lam = reinterpret_cast<float*>(smem4);
  float4* part4 = reinterpret_cast<float4*>(lam + mg);
  const float* part = lam + mg;
  const int tid = threadIdx.x;
  const int cg = tid % ncg, p = tid / ncg;
  const bool active = p < P;
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float s = *scale;

  for (int j = tid; j < mg; j += kThreads) lam[j] = smo::cost_term(s, w[j], uT[j]);
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float* urow = traj + row;
    if (active) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = p; i < mg; i += P) {
        const float4 bb = __ldg(b4 + (size_t)i * ncg + cg);
        const float l = lam[i];
        a.x = __fmaf_rn(bb.x, l, a.x);
        a.y = __fmaf_rn(bb.y, l, a.y);
        a.z = __fmaf_rn(bb.z, l, a.z);
        a.w = __fmaf_rn(bb.w, l, a.w);
      }
      part4[p * ncg + cg] = a;
    }
    __syncthreads();  // all lam reads done, partials ready
    for (int j = tid; j < mg; j += kThreads) {
      float wb = 0.f;
      for (int q = 0; q < P; ++q) wb += part[q * mg + j];
      const float un = urow[j];
      const float vprime = smo::poly_prime(lin, 2.f * c2, 3.f * c3, un);
      if constexpr (kLamHist) lam_hist[row + j] = lam[j];  // lambda_{n+1}
      lam[j] = __fmaf_rn(vprime, wb, smo::cost_term(s, w[j], un));
    }
    __syncthreads();
  }
  for (int j = tid; j < mg; j += kThreads) lam_out[j] = lam[j];
}

// Backward, grid-wide (sm_fused_bwd_shared_grid): the recurrence, lambda_0
// and the history of fused_bwd_shared_kernel on ceil(mg / cols)
// co-resident CTAs of kClusterThreads threads, the two-matrix grid reverse
// of fused_two_matrix.cu with one matrix: CTA c owns the columns [c0, c0 +
// nc), c0 = c cols; its thread t < P cols sums the rows p, p + P, ... of
// column c0 + t % cols, p = t / cols, in the one-block kernel's order,
// from its chain of B and lambda's chain of phase p, each contiguous in
// shared memory (ts = chain_stride(ceil(mg / P)) floats a chain); lambda
// crosses between the CTAs as step-tagged words in lbuf (4 mg floats:
// step k reads slot (k - 1) & 1, tag k, and writes slot k & 1, tag k + 1).
// Shared memory: B's chains [P][cols][ts], lambda [P][ts], the partials
// (P x cols).
__host__ __device__ constexpr size_t shared_bwd_grid_smem_bytes(int mg, int cols) {
  const int P = smo::row_phases(mg);
  const size_t ts = smo::chain_stride((mg + P - 1) / P);
  return ((size_t)P * (cols + 1) * ts + (size_t)P * cols) * sizeof(float);
}

template <bool kLamHist>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_shared_grid_kernel(const float* __restrict__ b, const float* __restrict__ w,
                             const float* __restrict__ uT, const float* __restrict__ traj,
                             float c2, float c3, float lin, const float* __restrict__ scale,
                             int n_steps, int mg, int cols, float* __restrict__ lam_out,
                             float* __restrict__ lam_hist, float* __restrict__ lbuf) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int P = smo::row_phases(mg), ts = smo::chain_stride((mg + P - 1) / P);
  const int c0 = blockIdx.x * cols, nc = min(cols, mg - c0);
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [P][cols][ts]
  float* lam = bs + (size_t)P * cols * ts;      // [P][ts]
  float* pb = lam + (size_t)P * ts;             // [P][cols]
  auto* pairs = reinterpret_cast<unsigned long long*>(lbuf);  // [2][mg] (value, tag)

  for (int idx = tid; idx < mg * cols; idx += kClusterThreads) {
    const int i = idx / cols, c = idx % cols;
    if (c < nc) bs[((i % P) * cols + c) * ts + i / P] = __ldg(b + (size_t)i * mg + c0 + c);
  }
  const float s = *scale;
  for (int j = tid; j < mg; j += kClusterThreads)
    lam[smo::lam_pos(j, P, ts)] = smo::cost_term(s, w[j], uT[j]);
  const float wc = tid < nc ? w[c0 + tid] : 0.f;
  const int kpos = tid < nc ? smo::lam_pos(c0 + tid, P, ts) : 0;
  int pos[2 * smo::kMaxPairRounds];
  smo::lambda_places(mg, P, ts, pos);
  for (int i = blockIdx.x * kClusterThreads + tid; i < 2 * mg; i += gridDim.x * kClusterThreads)
    pairs[i] = 0ull;  // no tag: steps count from 1
  grid.sync();      // the tags are clear before any CTA stores lambda_{N-1}

  const int p = tid / cols, col = tid % cols;
  const bool active = p < P && col < nc;
  const int nt = active ? (mg - p + P - 1) / P : 0;  // rows p, p + P, ... < mg
  const float* const xs[1] = {bs + (active ? (size_t)(p * cols + col) * ts : 0)};
  const float* lchain = lam + (active ? (size_t)p * ts : 0);
  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float un = tid < nc ? traj[row + c0 + tid] : 0.f;  // in flight during the wait
    if (k > 0) smo::read_tagged_lambda(pairs + (size_t)((k - 1) & 1) * mg, k, mg, lam, pos);
    __syncthreads();  // lambda_{n+1} complete
    const float keep = tid < nc ? lam[kpos] : 0.f;  // lambda_{n+1} of the history
    if (active) {
      float sb[1] = {0.f};
      smo::chain_sums<1>(xs, lchain, nt, sb);
      pb[p * cols + col] = sb[0];
    }
    __syncthreads();  // partials ready; lambda_{n+1} read
    if (tid < nc) {
      float wb = 0.f;
      for (int q = 0; q < P; ++q) wb += pb[q * cols + tid];
      const float vprime = smo::poly_prime(lin, 2.f * c2, 3.f * c3, un);
      const float x = __fmaf_rn(vprime, wb, smo::cost_term(s, wc, un));
      if constexpr (kLamHist) lam_hist[row + c0 + tid] = keep;  // lambda_{n+1}
      if (k + 1 < n_steps)
        smo::store_tagged(pairs + (size_t)(k & 1) * mg + c0 + tid, x, k + 1);
      else
        lam_out[c0 + tid] = x;
    }
  }
  if (n_steps == 0 && tid < nc) lam_out[c0 + tid] = lam[kpos];
}

template <bool kLamHist>
struct BwdSharedGrid {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity(int mg, int cols) {
    return smo::grid_capacity(fused_bwd_shared_grid_kernel<kLamHist>,
                              shared_bwd_grid_smem_bytes(mg, cols), ready);
  }
  static int launch(const float* b, const float* w, const float* uT, const float* traj,
                    float c2, float c3, float lin, const float* scale, int n_steps, int mg,
                    int cols, float* lam_out, float* lam_hist, float* lbuf, cudaStream_t st) {
    return smo::grid_launch(fused_bwd_shared_grid_kernel<kLamHist>, (mg + cols - 1) / cols,
                            shared_bwd_grid_smem_bytes(mg, cols), ready, st, b, w, uT, traj, c2,
                            c3, lin, scale, n_steps, mg, cols, lam_out, lam_hist, lbuf);
  }
};

// Backward, one cluster (sm_fused_bwd_shared): the recurrence, lambda_0 and
// the history of fused_bwd_shared_kernel on kClusterCtas CTAs of
// kClusterThreads threads, mg = 128 R. CTA rank r owns the C = mg / 16
// columns from c0 = r C; thread t < P C stands in for the one-block
// kernel's thread (p, column group) for one column: p = t / C, column
// c0 + t % C. Shared memory: B's columns (mg x C, row-major),
// lambda[2][mg] (ping-pong), the partials (P x C), w and u_n of the
// columns. A launch of several clusters (sm_fused_bwd_shared_rows) runs
// one sweep per cluster: cluster q reads row q of u_T and of scale, its
// (N, mg) block of the trajectory, and writes row q of lambda_0 (and its
// block of the history); B is every cluster's.
__host__ __device__ constexpr size_t bwd_shared_cluster_smem_bytes(int R) {
  return ((size_t)(128 * R) * (8 * R) + 2 * (size_t)(128 * R)
          + (size_t)row_phases(128 * R) * (8 * R) + 2 * (size_t)(8 * R)) * sizeof(float);
}

template <bool kLamHist, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_shared_cluster_kernel(const float* __restrict__ b, const float* __restrict__ w,
                                const float* __restrict__ uT, const float* __restrict__ traj,
                                float c2, float c3, float lin,
                                const float* __restrict__ scale, int n_steps,
                                float* __restrict__ lam_out, float* __restrict__ lam_hist) {
  constexpr int mg = 128 * R, C = mg / kClusterCtas, P = row_phases(mg);
  static_assert(P * C <= kClusterThreads, "one thread per (phase, column)");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = rank * C;
  const size_t q = blockIdx.x / kClusterCtas;   // this cluster's sweep
  uT += q * mg;
  traj += q * n_steps * mg;
  scale += q;
  lam_out += q * mg;
  if constexpr (kLamHist) lam_hist += q * n_steps * mg;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [mg][C]
  float* lam = bs + mg * C;
  float* lamn = lam + mg;
  float* pb = lamn + mg;   // [P][C]
  float* ws = pb + P * C;  // [C]
  float* us = ws + C;      // [C]

  for (int idx = tid; idx < mg * C; idx += kClusterThreads)
    bs[idx] = __ldg(b + (size_t)(idx / C) * mg + c0 + idx % C);
  const float s = *scale;
  for (int j = tid; j < mg; j += kClusterThreads) lam[j] = smo::cost_term(s, w[j], uT[j]);
  if (tid < C) ws[tid] = w[c0 + tid];
  cluster.sync();  // every CTA has started and holds lambda_N before any remote store

  const int p = tid / C, col = tid % C;
  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float un = tid < C ? traj[row + c0 + tid] : 0.f;  // in flight during the sums
    if (tid < P * C) {
      float sb = 0.f;
#pragma unroll 4
      for (int i = p; i < mg; i += P) sb = __fmaf_rn(bs[i * C + col], lam[i], sb);
      pb[p * C + col] = sb;
    }
    if (tid < C) us[tid] = un;
    __syncthreads();  // partials and u_n ready
    // (column, destination rank) pairs: the entry is formed once per
    // destination, consecutive threads store consecutive columns
    for (int t = tid; t < kClusterCtas * C; t += kClusterThreads) {
      const int c = t % C, dst = t / C;
      float wb = 0.f;
      for (int q = 0; q < P; ++q) wb += pb[q * C + c];
      const float u = us[c];
      const float vprime = smo::poly_prime(lin, 2.f * c2, 3.f * c3, u);
      cluster.map_shared_rank(lamn, dst)[c0 + c] =
          __fmaf_rn(vprime, wb, smo::cost_term(s, ws[c], u));
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
struct BwdSharedCluster {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity() {
    return smo::cluster_capacity(fused_bwd_shared_cluster_kernel<kLamHist, R>,
                                 bwd_shared_cluster_smem_bytes(R), kClusterThreads, ready);
  }
  static int launch(cudaStream_t st, int clusters, const float* b, const float* w,
                    const float* uT, const float* traj, float c2, float c3, float lin,
                    const float* scale, int n_steps, float* lam_out, float* lam_hist) {
    return smo::cluster_launch(fused_bwd_shared_cluster_kernel<kLamHist, R>, clusters,
                               bwd_shared_cluster_smem_bytes(R), kClusterThreads, ready, st,
                               b, w, uT, traj, c2, c3, lin, scale, n_steps, lam_out,
                               lam_hist);
  }
};

// Forward over rows, grid-wide (sm_fused_fwd_shared_rows): smo::fwd_rows
// with B alone, each state's v = v_poly(u) and shared_dot4, the one-row
// grid's polynomial and dot, so each state is bitwise
// fused_fwd_shared_grid_kernel on it.
struct SharedRowStep {
  float lin, c2, c3;
  __device__ __forceinline__ float poly(float x) const { return v_poly(lin, c2, c3, x); }
  __device__ __forceinline__ float dot(float s, const float4 bb, const float4 vv) const {
    return shared_dot4(s, bb, vv);
  }
};

__global__ void __launch_bounds__(kClusterThreads, 1)
fused_fwd_shared_rows_kernel(const float* __restrict__ b, const float* __restrict__ w,
                             const float* __restrict__ u0, float c2, float c3, float lin,
                             int n_steps, int mg, int rows, int ns, float* __restrict__ uT,
                             float* __restrict__ jsum, float* __restrict__ traj,
                             float* __restrict__ ubuf) {
  smo::fwd_rows(b, w, u0, SharedRowStep{lin, c2, c3}, n_steps, mg, rows, ns, uT, jsum, traj,
                ubuf);
}

struct FwdSharedRows {
  static inline bool ready[smo::kMaxDevices] = {};
  static size_t smem(int mg, int rows, int ns) {
    return smo::fwd_rows_smem_bytes(mg, rows, ns);
  }
  static int capacity(int mg, int rows, int ns) {
    return smo::grid_capacity(fused_fwd_shared_rows_kernel, smem(mg, rows, ns), ready);
  }
  static int launch(const float* b, const float* w, const float* u0, float c2, float c3,
                    float lin, int n_steps, int mg, int rows, int ns, float* uT, float* jsum,
                    float* traj, float* ubuf, cudaStream_t st) {
    return smo::grid_launch(fused_fwd_shared_rows_kernel, (mg + rows - 1) / rows,
                            smem(mg, rows, ns), ready, st, b, w, u0, c2, c3, lin, n_steps, mg,
                            rows, ns, uT, jsum, traj, ubuf);
  }
};

}  // namespace

extern "C" {

// The grid-wide forward at (mg, rows): ceil(mg / rows) CTAs, which the
// card must hold at once; ubuf is 4 mg floats of scratch.
int sm_fused_fwd_shared_grid(const float* b, const float* w, const float* u0, float c2,
                             float c3, float lin, int n_steps, int mg, int rows, float* uT,
                             float* jsum, float* traj, float* ser, float* ubuf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > mg) return static_cast<int>(cudaErrorInvalidValue);
  return ser != nullptr ? FwdSharedGrid<true>::launch(b, w, u0, c2, c3, lin, n_steps, mg, rows,
                                                      uT, jsum, traj, ser, ubuf, st)
                        : FwdSharedGrid<false>::launch(b, w, u0, c2, c3, lin, n_steps, mg, rows,
                                                       uT, jsum, traj, ser, ubuf, st);
}

// CTAs of sm_fused_fwd_shared_grid (with the series when `series`) that the
// card can hold at once at (mg, rows): fewer than ceil(mg / rows) means the
// launch cannot run; a negative value is -cudaError_t.
int sm_fused_fwd_shared_grid_capacity(int mg, int rows, int series) {
  return series ? FwdSharedGrid<true>::capacity(mg, rows)
                : FwdSharedGrid<false>::capacity(mg, rows);
}

int sm_fused_fwd_shared_block(const float* b, const float* w, const float* u0, float c2,
                              float c3, float lin, int n_steps, int mg, float* uT,
                              float* jsum, float* traj, float* ser, void* stream) {
  const size_t smem = (3 * (size_t)mg + 32) * sizeof(float);
  const auto kernel = ser != nullptr ? fused_fwd_shared_kernel<true>
                                     : fused_fwd_shared_kernel<false>;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, w, u0, c2, c3, lin, n_steps, mg, uT, jsum, traj, ser);
  return static_cast<int>(cudaGetLastError());
}

int sm_fused_bwd_shared(const float* b, const float* w, const float* uT,
                        const float* traj, float c2, float c3, float lin,
                        const float* scale, int n_steps, int mg, float* lam_out,
                        float* lam_hist, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lam_hist != nullptr
             ? smo::launch_by_mg<BwdSharedCluster, true, kMaxR>(
                   mg, st, 1, b, w, uT, traj, c2, c3, lin, scale, n_steps, lam_out, lam_hist)
             : smo::launch_by_mg<BwdSharedCluster, false, kMaxR>(
                   mg, st, 1, b, w, uT, traj, c2, c3, lin, scale, n_steps, lam_out, lam_hist);
}

// The cluster reverse over ns rows: one cluster per row in one launch
// (16 ns CTAs; clusters that the card cannot hold at once wait for a free
// one), row q from row q of uT, scale (ns,) and lam_out and the (N, mg)
// block q of traj, each row's lambda_0 bitwise sm_fused_bwd_shared's on
// that row. mg <= 896, as sm_fused_bwd_shared; its capacity query holds.
int sm_fused_bwd_shared_rows(const float* b, const float* w, const float* uT,
                             const float* traj, float c2, float c3, float lin,
                             const float* scale, int n_steps, int mg, int ns, float* lam_out,
                             void* stream) {
  return smo::launch_by_mg<BwdSharedCluster, false, kMaxR>(
      mg, static_cast<cudaStream_t>(stream), ns, b, w, uT, traj, c2, c3, lin, scale, n_steps,
      lam_out, static_cast<float*>(nullptr));
}

// The grid-wide forward over ns <= kMaxStates rows at (mg, rows):
// ceil(mg / rows) >= ns CTAs, which the card must hold at once; u0, uT (ns, mg),
// jsum (ns,), traj (ns, N, mg) or null; ubuf is 4 ns mg floats of scratch.
int sm_fused_fwd_shared_rows(const float* b, const float* w, const float* u0, float c2,
                             float c3, float lin, int n_steps, int mg, int rows, int ns,
                             float* uT, float* jsum, float* traj, float* ubuf, void* stream) {
  if (rows < 1 || rows > mg || ns < 1 || ns > kMaxStates || (mg + rows - 1) / rows < ns)
    return static_cast<int>(cudaErrorInvalidValue);
  return FwdSharedRows::launch(b, w, u0, c2, c3, lin, n_steps, mg, rows, ns, uT, jsum, traj,
                               ubuf, static_cast<cudaStream_t>(stream));
}

// CTAs of sm_fused_fwd_shared_rows that the card can hold at once at
// (mg, rows, ns), as sm_fused_fwd_shared_grid_capacity.
int sm_fused_fwd_shared_rows_capacity(int mg, int rows, int ns) {
  return FwdSharedRows::capacity(mg, rows, ns);
}

// Clusters of sm_fused_bwd_shared (with the lambda history when `hist`)
// that the card can hold at once for this mg, as
// sm_fused_fwd_shared_capacity.
int sm_fused_bwd_shared_capacity(int mg, int hist) {
  return hist ? smo::capacity_by_mg<BwdSharedCluster, true, kMaxR>(mg)
              : smo::capacity_by_mg<BwdSharedCluster, false, kMaxR>(mg);
}

// The grid-wide reverse sweep at (mg, cols): ceil(mg / cols) CTAs, which the
// card must hold at once; lbuf is 4 mg floats of scratch.
int sm_fused_bwd_shared_grid(const float* b, const float* w, const float* uT,
                             const float* traj, float c2, float c3, float lin,
                             const float* scale, int n_steps, int mg, int cols, float* lam_out,
                             float* lam_hist, float* lbuf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols < 1 || cols > mg || smo::row_phases(mg) * cols > kClusterThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return lam_hist != nullptr
             ? BwdSharedGrid<true>::launch(b, w, uT, traj, c2, c3, lin, scale, n_steps, mg,
                                           cols, lam_out, lam_hist, lbuf, st)
             : BwdSharedGrid<false>::launch(b, w, uT, traj, c2, c3, lin, scale, n_steps, mg,
                                            cols, lam_out, lam_hist, lbuf, st);
}

// CTAs of sm_fused_bwd_shared_grid (with the lambda history when `hist`)
// that the card can hold at once at (mg, cols), as
// sm_fused_fwd_shared_grid_capacity.
int sm_fused_bwd_shared_grid_capacity(int mg, int cols, int hist) {
  return hist ? BwdSharedGrid<true>::capacity(mg, cols) : BwdSharedGrid<false>::capacity(mg, cols);
}

int sm_fused_bwd_shared_block(const float* b, const float* w, const float* uT,
                              const float* traj, float c2, float c3, float lin,
                              const float* scale, int n_steps, int mg, float* lam_out,
                              float* lam_hist, void* stream) {
  const int ncg = mg / 4;
  const int P = kThreads / ncg;
  const size_t smem = ((size_t)mg + 4 * (size_t)P * ncg) * sizeof(float);
  const auto kernel = lam_hist != nullptr ? fused_bwd_shared_kernel<true>
                                          : fused_bwd_shared_kernel<false>;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, w, uT, traj, c2, c3, lin, scale, n_steps, mg, lam_out, lam_hist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
