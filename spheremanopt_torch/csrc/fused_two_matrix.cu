// Two-matrix fused SBDF integrator for SHB23: u' = A u + B (c2 u^2 + c3 u^3).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_two_matrix.py:
//   sm_fused_fwd_grid, sm_fused_fwd_block
//                 <- _fwd_kernel (_run_fwd; has_traj and has_ser as the
//                    traj / ser pointers): the grid-wide route and the
//                    one-block route of the same forward
//   sm_fused_bwd, sm_fused_bwd_grid, sm_fused_bwd_block
//                 <- _bwd_kernel (_run_bwd): the cluster route, the
//                    grid-wide route and the one-block route of the same
//                    reverse sweep; with op_grads it stores the lambda
//                    history that op_grads.cu turns into dA and dB (the
//                    `lam_hist` pointer)
//   sm_fused_fwd_rows, sm_fused_bwd_rows
//                 <- the same two kernels under jax.vmap (a sweep's R
//                    rows, one launch for all of them): the forward as
//                    groups of CTAs in one cooperative launch, the reverse
//                    as clusters of G rows each (fused_rows.cuh)
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
// sm_fused_fwd_grid (forward, every mg <= 2048 whose rows of A and the
// state fit a CTA: every width on an H100 SXM's 132 SMs and an H100 PCIe's
// 114). The TPU kernel keeps both matrices in VMEM for the whole solve; one
// SM's 227 KB holds neither (2 MB at mg = 512, 8 MB at 1024), but the
// card's ~30 MB of shared memory holds both up to mg = 1792 (SXM; 1664 on
// the PCIe card). One persistent cooperative kernel, one CTA on each of up
// to all SMs: CTA b keeps `rows` = ceil(mg / SMs) contiguous rows of A and
// of B (4 of each at mg = 512, 8 at 1024) in shared memory for the whole
// solve. u crosses through L2 as tagged words (grid.cuh): each warp
// computes its rows' dot products in the one-block kernel's lane and k
// order (fwd_dot4) and stores each entry of u_{n+1} with its step number
// n + 1 as one 64-bit word into a global buffer of two slots (ping-pong);
// every CTA reads all of u_{n+1} back with 64-bit loads, polling until
// every word carries the tag, and forms g itself. The tag is the step's
// barrier: a CTA that has seen all of u_{n+1} knows every CTA has
// finished reading u_n (each CTA's stores of u_{n+1} depend on those
// reads), so slot n & 1 is free for u_{n+2}. One grid.sync() per launch,
// after the tags are cleared. Each CTA stores its slice of the trajectory
// row; CTA 0 forms J and the series from the u it has read, with the
// one-block kernel's reduction tree (energy_partials, which covers
// mg <= 2048). u_T, J, the trajectory and the series are bitwise the
// one-block kernel's. The wrapper computes the partition from the card's
// SM count and shared memory and raises if the card cannot hold the CTAs
// at once (the polling needs every CTA resident: the launch is
// cooperative).
// Above the width where both matrices' rows fit (mg = 2048 on an H100
// SXM: 16 rows of each, 256 KB, against 227), a template flag (kStreamB)
// keeps all of the CTA's A rows and the first rows_b of its B rows that
// fit beside them and the state (9 of 16 at mg = 2048), and reads the
// other B rows from global memory every step: B (16 MB) stays in the
// 50 MB L2, and 7.3 MB of it crosses to the SMs a step. Each warp loads
// its first streamed row's float4s into registers before it waits for
// u_n, so that read overlaps the exchange; the chain of each row keeps
// fwd_dot4's order, so the bits do not change. The flag is a template
// parameter, as the series is: the instance without it, which every
// narrower mg runs, has no test on its per-step path.
// Why no cluster below mg = 640: a 16-CTA cluster holding the rows on 16
// SMs with one cluster.sync() a step took 4.42 ms at mg = 512, N = 2000,
// against 2.30 ms here (1.15 us a step); 3.09 / 3.78 / 5.74 ms against
// 2.32 / 2.40 / 3.49 at mg = 256 / 384 / 640; only at mg = 128 (one row
// a CTA) was it ahead, 2.38 against 2.84 ms. Why no grid.sync(): with
// one a step in place of the tags the sweep took 0.49 ms at mg = 1024,
// N = 200, against 0.43 ms tagged. (H100 SXM at 700 W,
// tools/time_reverse_sweeps.py.)
// sm_fused_fwd_block is one thread block that streams A and B from the
// 50 MB L2 every step (one warp per row, float4 loads), bound by one SM's
// L2 read rate (~191 GB/s measured): the route on a card where even A's
// rows do not fit, and the kernel the grid is held to bit for bit. The
// wrapper chooses by shape; each route launches its kernel or fails.
//
// sm_fused_bwd (reverse, mg <= 640): one thread-block cluster of 16 CTAs
// on 16 SMs. lambda_n = A^T lambda + g'(u_n) (B^T lambda) + s w u_n needs
// columns of A and B, so CTA rank r keeps columns [r mg/16, (r+1) mg/16) of A and of
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
// sm_fused_bwd_grid (reverse, mg > 640 while a CTA's columns of A and the
// state fit: every width on an H100 SXM and PCIe): the forward grid's
// machinery with the cluster's column partition spread over every SM.
// CTA c keeps cols = ceil(mg / SMs) contiguous columns of A and of B (8 of
// each at mg = 1024) in shared memory, each thread's chain (rows p, p + P,
// ... of its column) contiguous and each phase's chain of lambda too, so
// that a thread reads float4s (chain_sums, grid.cuh, each batch loaded
// while the one before it is summed); the chains keep the one-block
// kernel's order, each entry adds the P partials in phase order and
// applies the pinned update of common.cuh, and goes out as one step-tagged
// 64-bit word; every CTA reads all of lambda_n back, polling every word
// of its rounds at once, which is the step's barrier, as in the forward.
// lambda_N is formed by every CTA, so no exchange precedes the first step;
// each CTA loads its slice of u_n before it waits for lambda. lambda_0
// and the history are bitwise the one-block kernel's. The cost: one
// dependent chain of mg / P multiply-adds per matrix and thread (256 at
// mg = 1024, 1024 at 2048, fixed by the bits) on ~32 threads of the CTA,
// and the exchange. Above the width where both matrices' columns fit
// (mg = 1920 and 2048 on an H100 SXM), a template flag (kStreamB) keeps
// all of the CTA's A columns and the first cols_b of its B columns that
// fit beside them, the state and the stages (8 of 16 at mg = 2048 on the
// SXM), and stages the other B columns from L2 a chunk of kStageRows rows
// at a time, kStages chunks deep, with 16-byte cp.async from a copy of B
// with each column's chains contiguous (`bperm`, made by the wrapper once a
// call); the chunks run ahead across the steps, so the first ones of a step
// arrive while the CTA waits for lambda. The chains keep their order, so
// the bits do not change; the instance without the flag, which every
// narrower mg runs, has no test on its per-step path.
// Why the cluster stays at mg <= 640: at N = 200 the grid took 0.377 /
// 0.383 ms at mg = 512 against the cluster's 0.365-0.370, and 0.41 / 0.35
// / 0.39 against 0.19 / 0.23 / 0.33 at mg = 128 / 256 / 384: the exchange
// through L2 costs ~1 us a step, the cluster's barrier less; at mg = 640
// the grid was ahead, 0.437 against 0.557-0.565 ms, and that width stays
// the cluster's (H100 SXM at 700 W, tools/time_reverse_sweeps.py).
// sm_fused_bwd_block: one thread block; A and B stay in global memory and
// L2. It computes A^T lambda and B^T lambda in a column-partitioned loop
// (thread (p, column group) sums rows p, p + P, ... of four columns), with
// one lambda read per row for both products; the state (lambda, partials)
// lives in shared memory. It is the route only where a grid's A columns
// do not fit, and the kernel the cluster and the grid are held to bit for
// bit.
//
// Rows (a sweep of R starting points, the vmapped form): sm_fused_fwd_rows
// and sm_fused_bwd_rows launch the kernels of fused_rows.cuh (compiled in
// fused_rows_g1.cu and fused_rows_g2.cu, one group size G each): the
// forward as ceil(R / G) groups of CTAs, each exchanging only its own rows'
// u, the reverse as ceil(R / G) clusters of 16 CTAs, each carrying G rows;
// both keep each CTA's share of A and B in registers. Each row's u_T, J,
// trajectory and lambda_0 are bitwise the one-row kernels' on that row.
// Only the mg <= 640 widths of the cluster have row kernels.
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
// guarantees mg % 128 == 0, 128 <= mg <= 2048 (sm_fused_bwd: mg <= 640),
// contiguous f32 buffers on one device. The grids launch cooperatively,
// so a grid that the card cannot hold at once fails at launch; a word
// that never gets its tag traps (a launch failure), it does not hang.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"
#include "fused_rows.cuh"
#include "grid.cuh"

namespace cg = cooperative_groups;

namespace {

using smo::row_phases;
using smo::capacity_by_mg;
using smo::cluster_capacity;
using smo::cluster_launch;
using smo::energy_partials;
using smo::fwd_dot4;
using smo::g_poly;
using smo::kClusterCtas;
using smo::kClusterThreads;
using smo::kClusterWarps;
using smo::kMaxStates;
using smo::kThreads;
using smo::kWarps;
using smo::launch_by_mg;

// The reverse cluster holds A's and B's columns while 2 mg^2 4 / 16
// bytes fit one SM: instances for mg = 128 R, R <= kMaxR.
constexpr int kMaxR = 5;

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

// Forward, grid-wide (sm_fused_fwd_grid): the recurrence, J and outputs of
// fused_fwd_kernel on ceil(mg / rows) co-resident CTAs of kClusterThreads
// threads; CTA b owns rows [b rows, min((b + 1) rows, mg)), warp w its
// rows w, w + 8, ... ubuf (4 mg floats) holds two slots of mg (value, tag)
// pairs: step n reads u_n (u0 at n = 0, else slot (n - 1) & 1, tag n) and
// writes u_{n+1} to slot n & 1 with tag n + 1. Shared memory: A rows
// (rows x mg), the first rows_b of the CTA's B rows (rows_b x mg),
// u[mg], g[mg], w[mg], red[32]. Without kStreamB, rows_b = rows. With it,
// the CTA's other B rows stay in global memory (B stays in L2) and are read
// every step; they are a contiguous run of row indices, so the warps'
// round-robin rows spread them within one row of each other.
__host__ __device__ constexpr size_t grid_smem_bytes(int mg, int rows, int rows_b) {
  return ((size_t)(rows + rows_b) * mg + 3 * (size_t)mg + 32) * sizeof(float);
}

// float4s of a row a lane takes (k = lane + 32 i) at mg <= 2048
constexpr int kMaxLaneK = 2048 / 128;

// The lane's float4s of a row in global memory, all loads in flight at once
__device__ __forceinline__ void load_lane_row(float4 (&dst)[kMaxLaneK], const float4* row,
                                              int lane, int nk) {
#pragma unroll
  for (int i = 0; i < kMaxLaneK; ++i)
    if (i < nk) dst[i] = __ldg(row + lane + 32 * i);
}

template <bool kSeries, bool kStreamB>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_fwd_grid_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ w, const float* __restrict__ u0, float c2,
                      float c3, int n_steps, int mg, int rows, int rows_b,
                      float* __restrict__ uT, float* __restrict__ jsum,
                      float* __restrict__ traj, float* __restrict__ ser,
                      float* __restrict__ ubuf) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg4 = mg / 4, r0 = blockIdx.x * rows;
  const int nr = min(rows, mg - r0);
  const bool lead = blockIdx.x == 0;
  extern __shared__ float4 smem4[];
  float4* as4 = smem4;  // rows x mg4
  float4* bs4 = as4 + (size_t)rows * mg4;
  float4* u4 = bs4 + (size_t)(kStreamB ? rows_b : rows) * mg4;
  float4* g4 = u4 + mg4;
  float* u = reinterpret_cast<float*>(u4);
  float* g = reinterpret_cast<float*>(g4);
  float* ws = g + mg;
  float* red = ws + mg;
  auto* pairs = reinterpret_cast<unsigned long long*>(ubuf);  // [2][mg] (value, tag)
  const auto gp = [=](float x) { return g_poly(c2, c3, x); };

  const float4* a4 = reinterpret_cast<const float4*>(a) + (size_t)r0 * mg4;
  const float4* b4 = reinterpret_cast<const float4*>(b) + (size_t)r0 * mg4;
  for (int i = tid; i < nr * mg4; i += kClusterThreads) {
    as4[i] = __ldg(a4 + i);
    if (!kStreamB || i < rows_b * mg4) bs4[i] = __ldg(b4 + i);
  }
  if (lead)
    for (int j = tid; j < mg; j += kClusterThreads) ws[j] = w[j];
  for (int i = blockIdx.x * kClusterThreads + tid; i < 2 * mg; i += gridDim.x * kClusterThreads)
    pairs[i] = 0ull;  // no tag: steps count from 1
  grid.sync();      // the tags are clear before any CTA stores u_1

  // kStreamB: the warp's first streamed row (rs), whose B float4s are
  // loaded before the wait for u_n, and the registers of a streamed row
  const int nk = mg4 / 32;
  const int rs = rows_b + ((warp - rows_b) % kClusterWarps + kClusterWarps) % kClusterWarps;
  float4 bq[kMaxLaneK];

  float acc = 0.f, comp = 0.f;  // live in CTA 0's thread 0
  for (int n = 0; n < n_steps; ++n) {
    if constexpr (kStreamB) {
      if (rs < nr) load_lane_row(bq, b4 + (size_t)rs * mg4, lane, nk);
    }
    if (n == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(u0);
      for (int k = tid; k < mg4; k += kClusterThreads) {
        const float4 x = __ldg(src4 + k);
        u4[k] = x;
        g4[k] = make_float4(g_poly(c2, c3, x.x), g_poly(c2, c3, x.y), g_poly(c2, c3, x.z),
                            g_poly(c2, c3, x.w));
      }
    } else {
      smo::read_tagged(pairs + (size_t)((n - 1) & 1) * mg, n, mg, gp, u, g);
    }
    __syncthreads();  // u and g complete (and at n = 0 the rows and w)
    if (traj != nullptr)
      for (int i = tid; i < nr; i += kClusterThreads) traj[(size_t)n * mg + r0 + i] = u[r0 + i];
    if (lead) {
      energy_partials(u, ws, mg, red);
      __syncthreads();  // red complete
    }
    unsigned long long* dst = pairs + (size_t)(n & 1) * mg;
    for (int rl = warp; rl < nr; rl += kClusterWarps) {
      const float4* arow = as4 + (size_t)rl * mg4;
      float s = 0.f;
      if (!kStreamB || rl < rows_b) {
        const float4* brow = bs4 + (size_t)rl * mg4;
#pragma unroll 4
        for (int k = lane; k < mg4; k += 32) s = fwd_dot4(s, arow[k], u4[k], brow[k], g4[k]);
      } else {  // B's row from L2, then the same chain as above
        if (rl != rs) load_lane_row(bq, b4 + (size_t)rl * mg4, lane, nk);
#pragma unroll
        for (int i = 0; i < kMaxLaneK; ++i) {
          const int k = lane + 32 * i;
          if (i < nk) s = fwd_dot4(s, arow[k], u4[k], bq[i], g4[k]);
        }
      }
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
    __syncthreads();  // u, g and red free for the next step
  }

  // u_N: each CTA stores its rows of u_T; CTA 0 forms e_N and J
  if (n_steps == 0) {
    for (int j = tid; j < mg; j += kClusterThreads) u[j] = u0[j];
  } else {
    smo::read_tagged(pairs + (size_t)((n_steps - 1) & 1) * mg, n_steps, mg, gp, u,
                     static_cast<float*>(nullptr));
  }
  __syncthreads();
  for (int i = tid; i < nr; i += kClusterThreads) uT[r0 + i] = u[r0 + i];
  if (lead) {
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

template <bool kSeries, bool kStreamB>
struct FwdGrid {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity(int mg, int rows, int rows_b) {
    return smo::grid_capacity(fused_fwd_grid_kernel<kSeries, kStreamB>,
                              grid_smem_bytes(mg, rows, rows_b), ready);
  }
  static int launch(const float* a, const float* b, const float* w, const float* u0, float c2,
                    float c3, int n_steps, int mg, int rows, int rows_b, float* uT, float* jsum,
                    float* traj, float* ser, float* ubuf, cudaStream_t st) {
    return smo::grid_launch(fused_fwd_grid_kernel<kSeries, kStreamB>, (mg + rows - 1) / rows,
                            grid_smem_bytes(mg, rows, rows_b), ready, st, a, b, w, u0, c2, c3,
                            n_steps, mg, rows, rows_b, uT, jsum, traj, ser, ubuf);
  }
};

// FwdGrid<kSeries, kStreamB>::f(args...) for the flags at run time:
// kStreamB when fewer than `rows` B rows stay in shared memory
template <template <bool, bool> class K, typename F>
int by_flags(bool series, bool stream, F f) {
  if (series) return stream ? f(K<true, true>{}) : f(K<true, false>{});
  return stream ? f(K<false, true>{}) : f(K<false, false>{});
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

// Backward, grid-wide (sm_fused_bwd_grid): the recurrence, lambda_0 and the
// history of fused_bwd_kernel on ceil(mg / cols) co-resident CTAs of
// kClusterThreads threads. CTA c owns the columns [c0, c0 + nc), c0 =
// c cols; its thread t < P cols stands in for the one-block kernel's thread
// (p, column group) for one column: p = t / cols, column c0 + t % cols,
// with the one-block kernel's P = 1024 / (mg / 4) row phases (row_phases).
// Each thread's chain (rows p, p + P, ... of its column) is contiguous in
// shared memory, ts = chain_stride(ceil(mg / P)) floats a chain, and so is
// each phase's chain of lambda (lam_pos). lbuf (4 mg floats) holds two
// slots of mg (value, tag) words (grid.cuh): step k (lambda_{n+1} ->
// lambda_n, n = N - 1 - k) reads lambda_{n+1} (lambda_N, which every CTA
// forms itself, at k = 0; else slot (k - 1) & 1, tag k) and writes
// lambda_n to slot k & 1 with tag k + 1; the last step writes lambda_0 to
// lam_out. Shared memory: A's chains [P][cols][ts], the chains of the
// first cols_b of the CTA's B columns [P][cols_b][ts], lambda [P][ts],
// with kStreamB (cols_b < cols) kStages stages of kStageRows rows of the
// other B columns, [P][cols - cols_b][tsc], tsc = chain_stride(kStageRows
// / P), then the partials (P x cols of each matrix). Without kStreamB,
// cols_b = cols; with it, P divides kStageRows / 2 (the last chunk of a
// step may be half of one), and the stages are copied from bperm, B with
// each column's chains contiguous: B[p + P m][c] at (c P + p) (mg / P) +
// m, so that a chunk of a chain is whole 16-byte pieces.
constexpr int kStageRows = 256, kStages = 3;

__host__ __device__ constexpr size_t bwd_grid_smem_bytes(int mg, int cols, int cols_b) {
  const int P = smo::row_phases(mg);
  const size_t ts = smo::chain_stride((mg + P - 1) / P);
  const size_t staged =
      cols_b < cols ? (size_t)kStages * P * (cols - cols_b) * smo::chain_stride(kStageRows / P)
                    : 0;
  return ((size_t)P * (cols + cols_b + 1) * ts + staged + 2 * (size_t)P * cols) * sizeof(float);
}

// 16 bytes from global to shared memory without a register (cp.async)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <bool kLamHist, bool kStreamB>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_grid_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ bperm, const float* __restrict__ w,
                      const float* __restrict__ uT,
                      const float* __restrict__ traj, float c2, float c3,
                      const float* __restrict__ scale, int n_steps, int mg, int cols,
                      int cols_b, float* __restrict__ lam_out, float* __restrict__ lam_hist,
                      float* __restrict__ lbuf) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int P = smo::row_phases(mg), ts = smo::chain_stride((mg + P - 1) / P);
  const int c0 = blockIdx.x * cols, nc = min(cols, mg - c0);
  const int nb = kStreamB ? cols_b : cols;             // B columns kept
  const int ns = kStreamB ? max(nc - cols_b, 0) : 0;   // B columns staged from L2
  const int tpc = kStageRows / P, tsc = smo::chain_stride(tpc);  // a chunk's terms a chain
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [P][cols][ts]
  float* bs = as + (size_t)P * cols * ts;       // [P][nb][ts]
  float* lam = bs + (size_t)P * nb * ts;        // [P][ts]
  float* stage = lam + (size_t)P * ts;          // [kStages][P][ns][tsc]
  float* pa = stage + (kStreamB ? (size_t)kStages * P * (cols - cols_b) * tsc : 0);  // [P][cols]
  float* pb = pa + P * cols;                                                          // [P][cols]
  auto* pairs = reinterpret_cast<unsigned long long*>(lbuf);  // [2][mg] (value, tag)

  for (int idx = tid; idx < mg * cols; idx += kClusterThreads) {
    const int i = idx / cols, c = idx % cols;
    if (c < nc) {
      const size_t src = (size_t)i * mg + c0 + c;
      const int q = i % P, m = i / P;
      as[(q * cols + c) * ts + m] = __ldg(a + src);
      if (c < nb) bs[(q * nb + c) * ts + m] = __ldg(b + src);
    }
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

  // kStreamB: the chunks of the staged columns (chunk j: rows j kStageRows
  // on, terms(j) = min(kStageRows, mg - j kStageRows) / P of each of their
  // chains) go to the stages in turn, kStages - 1 chunks ahead of the sums
  // and across the steps (B does not change), so the first chunks of a
  // step are in flight while the CTA waits for lambda. The threads of the
  // first warp, which sum chains, copy nothing; terms(j) / 4 and P (powers
  // of 2): shifts.
  const int nch = (mg + kStageRows - 1) / kStageRows, lp = __ffs(P) - 1;
  const auto terms = [&](int j) { return min(kStageRows, mg - j * kStageRows) / P; };
  int next = 0;  // the chunk of a step that the next copy fetches
  const auto issue = [&](int g) {  // chunk g of the sweep: chunk `next` of a step
    if constexpr (kStreamB) {
      if (tid >= 32) {
        float* dst = stage + (size_t)(g % kStages) * ns * P * tsc;
        const float* src = bperm + (size_t)(c0 + cols_b) * mg + (size_t)next * tpc;
        const int lq = __ffs(terms(next) / 4) - 1;
        for (int e = tid - 32; e < (ns * P) << lq; e += kClusterThreads - 32) {
          const int chain = e >> lq, q4 = e & ((1 << lq) - 1);  // chain = c P + p
          const int to = ((chain & (P - 1)) * ns + (chain >> lp)) * tsc;  // phase-major
          cp_async16(dst + to + 4 * q4, src + (size_t)chain * (mg / P) + 4 * q4);
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      next = next + 1 == nch ? 0 : next + 1;
    }
  };
  int g = 0;
  for (int q = 0; q < kStages - 1; ++q) issue(q);

  const int p = tid / cols, col = tid % cols;
  const bool active = p < P && col < nc;
  const int nt = active ? (mg - p + P - 1) / P : 0;  // rows p, p + P, ... < mg
  const float* achain = as + (active ? (size_t)(p * cols + col) * ts : 0);
  const float* lchain = lam + (active ? (size_t)p * ts : 0);
  for (int k = 0; k < n_steps; ++k) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
    const float un = tid < nc ? traj[row + c0 + tid] : 0.f;  // in flight during the wait
    if (k > 0) smo::read_tagged_lambda(pairs + (size_t)((k - 1) & 1) * mg, k, mg, lam, pos);
    __syncthreads();  // lambda_{n+1} complete
    const float keep = tid < nc ? lam[kpos] : 0.f;  // lambda_{n+1} of the history
    float sab[2] = {0.f, 0.f};
    if constexpr (!kStreamB) {
      if (active) {
        const float* const xs[2] = {achain, bs + (size_t)(p * cols + col) * ts};
        smo::chain_sums<2>(xs, lchain, nt, sab);
      }
    } else {  // the same chains, a chunk of kStageRows rows at a time
      for (int j = 0; j < nch; ++j, ++g) {
        asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
        __syncthreads();  // chunk g staged; the stage of chunk g - 1 free
        issue(g + kStages - 1);
        if (active) {
          const int m0 = j * tpc;
          const float* bchain =
              col < cols_b
                  ? bs + (size_t)(p * cols_b + col) * ts + m0
                  : stage + ((size_t)(g % kStages) * P * ns + p * ns + col - cols_b) * tsc;
          const float* const xs[2] = {achain + m0, bchain};
          smo::chain_sums<2>(xs, lchain + m0, terms(j), sab);
        }
      }
    }
    if (active) {
      pa[p * cols + col] = sab[0];
      pb[p * cols + col] = sab[1];
    }
    __syncthreads();  // partials ready; lambda_{n+1} read
    if (tid < nc) {
      float wa = 0.f, wb = 0.f;
      for (int q = 0; q < P; ++q) {
        wa += pa[q * cols + tid];
        wb += pb[q * cols + tid];
      }
      const float gprime = smo::poly_prime(0.f, 2.f * c2, 3.f * c3, un);
      const float x = __fadd_rn(__fmaf_rn(gprime, wb, wa), smo::cost_term(s, wc, un));
      if constexpr (kLamHist) lam_hist[row + c0 + tid] = keep;  // lambda_{n+1}
      if (k + 1 < n_steps)
        smo::store_tagged(pairs + (size_t)(k & 1) * mg + c0 + tid, x, k + 1);
      else
        lam_out[c0 + tid] = x;
    }
  }
  if (n_steps == 0 && tid < nc) lam_out[c0 + tid] = lam[kpos];
  if constexpr (kStreamB) asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <bool kLamHist, bool kStreamB>
struct BwdGrid {
  static inline bool ready[smo::kMaxDevices] = {};
  static int capacity(int mg, int cols, int cols_b) {
    return smo::grid_capacity(fused_bwd_grid_kernel<kLamHist, kStreamB>,
                              bwd_grid_smem_bytes(mg, cols, cols_b), ready);
  }
  static int launch(const float* a, const float* b, const float* bperm, const float* w,
                    const float* uT, const float* traj, float c2, float c3, const float* scale,
                    int n_steps, int mg, int cols, int cols_b, float* lam_out, float* lam_hist,
                    float* lbuf, cudaStream_t st) {
    return smo::grid_launch(fused_bwd_grid_kernel<kLamHist, kStreamB>, (mg + cols - 1) / cols,
                            bwd_grid_smem_bytes(mg, cols, cols_b), ready, st, a, b, bperm, w, uT,
                            traj, c2, c3, scale, n_steps, mg, cols, cols_b, lam_out, lam_hist,
                            lbuf);
  }
};

// Backward, one cluster (sm_fused_bwd): the recurrence, lambda_0 and the
// history of fused_bwd_kernel on kClusterCtas CTAs of kClusterThreads
// threads, mg = 128 R. CTA rank r owns the C = mg / 16 columns from
// c0 = r C; thread t < P C stands in for the one-block kernel's thread
// (p, column group) for one column: p = t / C, column c0 + t % C, with the
// one-block kernel's P = 1024 / (mg / 4) row phases. Shared memory: A's
// and B's columns (mg x C each, row-major), lambda[2][mg] (ping-pong),
// the partials (P x C each), w and u_n of the columns. Cluster q of a
// launch reads row q of u_T and scale and its (N, mg) block of the
// trajectory, and writes row q of lambda_0 (sm_fused_bwd launches one, so
// q = 0).
__host__ __device__ constexpr size_t bwd_cluster_smem_bytes(int R) {
  return (2 * (size_t)(128 * R) * (8 * R) + 2 * (size_t)(128 * R)
          + 2 * (size_t)row_phases(128 * R) * (8 * R) + 2 * (size_t)(8 * R)) * sizeof(float);
}

template <bool kLamHist, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_cluster_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ w, const float* __restrict__ uT,
                         const float* __restrict__ traj, float c2, float c3,
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
  static int launch(cudaStream_t st, int clusters, const float* a, const float* b,
                    const float* w, const float* uT, const float* traj, float c2, float c3,
                    const float* scale, int n_steps, float* lam_out, float* lam_hist) {
    return cluster_launch(fused_bwd_cluster_kernel<kLamHist, R>, clusters,
                          bwd_cluster_smem_bytes(R), kClusterThreads, ready, st, a, b, w, uT,
                          traj, c2, c3, scale, n_steps, lam_out, lam_hist);
  }
};

// The row kernels of fused_rows.cuh for groups of `group` (1, 2) rows a
// launch of ns <= kMaxStates rows: the launchers of fused_rows_g<group>.cu
template <typename F>
int by_group(int group, F f) {
  switch (group) {
    case 1: return f(smo::fused_fwd_rows_g1, smo::fused_fwd_rows_capacity_g1,
                     smo::fused_bwd_rows_g1, smo::fused_bwd_rows_capacity_g1);
    case 2: return f(smo::fused_fwd_rows_g2, smo::fused_fwd_rows_capacity_g2,
                     smo::fused_bwd_rows_g2, smo::fused_bwd_rows_capacity_g2);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The grid-wide forward at (mg, rows, rows_b): ceil(mg / rows) CTAs, which
// the card must hold at once, each keeping rows_b <= rows of its B rows in
// shared memory (the kStreamB instance when rows_b < rows); ubuf is 4 mg
// floats of scratch.
int sm_fused_fwd_grid(const float* a, const float* b, const float* w, const float* u0,
                      float c2, float c3, int n_steps, int mg, int rows, int rows_b, float* uT,
                      float* jsum, float* traj, float* ser, float* ubuf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > mg || rows_b < 0 || rows_b > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_flags<FwdGrid>(ser != nullptr, rows_b < rows, [&](auto k) {
    return decltype(k)::launch(a, b, w, u0, c2, c3, n_steps, mg, rows, rows_b, uT, jsum, traj,
                               ser, ubuf, st);
  });
}

// CTAs of sm_fused_fwd_grid (with the series when `series`) that the card
// can hold at once at (mg, rows, rows_b): fewer than ceil(mg / rows) means
// the launch cannot run; a negative value is -cudaError_t.
int sm_fused_fwd_grid_capacity(int mg, int rows, int rows_b, int series) {
  return by_flags<FwdGrid>(series != 0, rows_b < rows,
                           [&](auto k) { return decltype(k)::capacity(mg, rows, rows_b); });
}

// The dynamic shared memory (bytes) that a block may opt in to on the
// current device, from which the wrapper works out the grid route's
// widest mg; a negative value is -cudaError_t.
int sm_smem_optin(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : -static_cast<int>(err);
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
             ? launch_by_mg<BwdCluster, true, kMaxR>(mg, st, 1, a, b, w, uT, traj, c2, c3,
                                                     scale, n_steps, lam_out, lam_hist)
             : launch_by_mg<BwdCluster, false, kMaxR>(mg, st, 1, a, b, w, uT, traj, c2, c3,
                                                      scale, n_steps, lam_out, lam_hist);
}

// The grouped forward over ns <= kMaxStates rows: ceil(ns / group) groups
// of `ctas` CTAs of `rows` rows of the operators (ctas = ceil(mg / rows)),
// which the card must hold at once; ceil(rows / 8) <= fwd_row_slots(mg,
// group) and ctas >= min(group, ns). u0, uT (ns, mg), jsum (ns,), traj
// (ns, N, mg) or null; ubuf is 4 ns mg floats of scratch. Each row's u_T, J
// and trajectory are bitwise sm_fused_fwd_grid's on that row.
int sm_fused_fwd_rows(const float* a, const float* b, const float* w, const float* u0,
                      float c2, float c3, int n_steps, int mg, int group, int ctas, int rows,
                      int ns, float* uT, float* jsum, float* traj, float* ubuf, void* stream) {
  if (group < 1 || ns < 1 || ns > kMaxStates || rows < 1 || rows > mg
      || ctas != (mg + rows - 1) / rows || ctas < (group < ns ? group : ns)
      || (rows + kClusterWarps - 1) / kClusterWarps > smo::fwd_row_slots(mg, group))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_group(group, [&](auto fwd, auto, auto, auto) {
    return fwd(mg, (ns + group - 1) / group, a, b, w, u0, c2, c3, n_steps, ns, ctas, rows, uT,
               jsum, traj, ubuf, static_cast<cudaStream_t>(stream));
  });
}

// CTAs of sm_fused_fwd_rows that the card can hold at once at (mg, group,
// rows); a negative value is -cudaError_t.
int sm_fused_fwd_rows_capacity(int mg, int group, int rows) {
  return by_group(group, [&](auto, auto cap, auto, auto) { return cap(mg, rows); });
}

// The reverse over ns <= kMaxStates rows: ceil(ns / group) clusters of 16
// CTAs, cluster q carrying rows [q group, min((q + 1) group, ns)) of uT,
// scale (ns,), lam_out (ns, mg) and traj (ns, N, mg); each row's lambda_0
// bitwise sm_fused_bwd's on that row. mg <= 640; the clusters need not be
// resident at once (sm_fused_bwd_rows_capacity: how many are).
int sm_fused_bwd_rows(const float* a, const float* b, const float* w, const float* uT,
                      const float* traj, float c2, float c3, const float* scale, int n_steps,
                      int mg, int group, int ns, float* lam_out, void* stream) {
  if (group < 1 || ns < 1 || ns > kMaxStates) return static_cast<int>(cudaErrorInvalidValue);
  return by_group(group, [&](auto, auto, auto bwd, auto) {
    return bwd(mg, (ns + group - 1) / group, a, b, w, uT, traj, c2, c3, scale, n_steps, ns,
               lam_out, static_cast<cudaStream_t>(stream));
  });
}

// Clusters of sm_fused_bwd_rows that the card can hold at once at (mg,
// group); a negative value is -cudaError_t.
int sm_fused_bwd_rows_capacity(int mg, int group) {
  return by_group(group, [&](auto, auto, auto, auto cap) { return cap(mg); });
}

// Clusters of sm_fused_bwd (with the lambda history when `hist`) that the
// card can hold at once for this mg, as sm_fused_fwd_capacity.
int sm_fused_bwd_capacity(int mg, int hist) {
  return hist ? capacity_by_mg<BwdCluster, true, kMaxR>(mg)
              : capacity_by_mg<BwdCluster, false, kMaxR>(mg);
}

// The grid-wide reverse sweep at (mg, cols, cols_b): ceil(mg / cols) CTAs,
// which the card must hold at once, each keeping cols_b <= cols of its B
// columns in shared memory (the kStreamB instance when cols_b < cols,
// which stages the others from bperm, B in phase order, and needs it;
// the other instance takes null); lbuf is 4 mg floats of scratch.
int sm_fused_bwd_grid(const float* a, const float* b, const float* bperm, const float* w,
                      const float* uT, const float* traj, float c2, float c3, const float* scale,
                      int n_steps, int mg, int cols, int cols_b, float* lam_out, float* lam_hist,
                      float* lbuf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = smo::row_phases(mg);
  if (cols < 1 || cols > mg || cols_b < 0 || cols_b > cols || P * cols > kClusterThreads
      || (cols_b < cols && ((kStageRows / 2) % P != 0 || bperm == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_flags<BwdGrid>(lam_hist != nullptr, cols_b < cols, [&](auto k) {
    return decltype(k)::launch(a, b, bperm, w, uT, traj, c2, c3, scale, n_steps, mg, cols,
                               cols_b, lam_out, lam_hist, lbuf, st);
  });
}

// CTAs of sm_fused_bwd_grid (with the lambda history when `hist`) that the
// card can hold at once at (mg, cols, cols_b), as sm_fused_fwd_grid_capacity.
int sm_fused_bwd_grid_capacity(int mg, int cols, int cols_b, int hist) {
  return by_flags<BwdGrid>(hist != 0, cols_b < cols,
                           [&](auto k) { return decltype(k)::capacity(mg, cols, cols_b); });
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
