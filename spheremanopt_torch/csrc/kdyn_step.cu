// Fused kinematic-dynamo integrator: N CNAB1 induction steps, and the
// hand-transposed reverse sweep, one launch each.
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/kdyn_step.py:
//   sm_kdyn_fwd       <- _fwd_kernel       (run_forward)
//   sm_kdyn_fwd_traj  <- _fwd_traj_kernel  (_run_fwd_traj)
//   sm_kdyn_bwd       <- _bwd_kernel       (_run_bwd)
//
// One step maps the (re, im) coefficient planes b (3, n, n, kz),
// kz = n/2 + 1, through
//   to_grid (complex DFT synthesis along x and y, real-output synthesis
//   along z, onto the (3, mg, mg, mg) grid), e = u x B on the grid,
//   to_coeff (analysis along z, y, x, band mask), F = i k x e,
//   rhs = rhs_fac b + F, Leray projection, lhs_inv, mean mode zeroed.
// The reverse sweep carries lambda through the exact transpose of that
// map and accumulates u_bar += to_grid(b_n) x e_bar_n from the stored
// states.
//
// What bounds them on an H100: arithmetic, in principle (about 47 MFLOP
// per forward step and 70 MFLOP per reverse step against a few MB of
// operands), but the steps depend on each other and one step is far too
// small to fill the card, so the sweep is bound by the latency of the
// step's stages. The TPU kernel keeps the whole 36^3 grid in VMEM; one
// SM cannot hold it (560 KB against 227 KB), and it need not exist: the
// transforms are separable, and after the x and y synthesis everything
// up to the y analysis is local to one (a, b) pencil of the grid. What
// the design does:
//   * one persistent cooperative kernel per sweep, all blocks
//     co-resident (two or so of 128 threads on each SM); the forward has
//     a grid-wide barrier between the five stages of a step:
//     x-synthesis | y-synthesis | per pencil: z-synthesis, cross
//     product, z-analysis | y-analysis | x-analysis fused with the
//     mode-space tail (curl, rhs, Leray, lhs_inv) and the energy;
//   * the intermediates (well under 2 MB) go through global memory and
//     stay in the 50 MB L2; the eight DFT matrices sit in shared memory;
//   * J and the per-step energies are sums of per-block partials taken
//     in a fixed order (no float atomics), and the Kahan accumulation
//     over the steps lives in one thread with the pinned rounding of
//     common.cuh, so J is the same from run to run.
// The reverse sweep (sm_kdyn_bwd) has its own partition, with two
// grid-wide barriers a step instead of five. The transforms are
// separable, so the x-direction work and the y/z-direction work get
// different owners, and the only exchanges through L2 are q1, g1 and r4:
//   * stage X, by mode column (Y, z), tasks of two adjacent columns
//     (adjacent in every array the stage reads and writes; 156 tasks at
//     n = 24): r4 of the
//     column -> x-synthesis^T plus the direct term (and the integrated
//     cost's term) -> lambda_n; the head of the next transposed step
//     (local to a mode, all three components at hand); the x-analysis^T
//     of its p0 -> q1, and the x-synthesis of the next stored state -> g1
//     (that chain does not depend on lambda);
//   * stage YZ, by x-grid slab a, split into S groups of <= 6 y-grid
//     points b so that the ~216 tasks spread over the card (36 slabs
//     alone would leave 96 of 132 SMs idle): the y-analysis^T of q1 and
//     y-synthesis of g1 onto the group's b, the pencil work (z-stages,
//     cross products, u_bar), the z-synthesis^T, and the group's share of
//     the y-synthesis^T; stage X adds the S shares in group order.
//   q2, g2 and r3 stay in shared memory. Blocks of 256 threads, two on an
//   SM, one block per task of the larger stage: a block that has to run
//   two tasks of a stage doubles that stage's time. Measured on an H100
//   SXM at 700 W (n = 24, 2000 steps): 31.6 ms a sweep with 6 groups,
//   two-column X tasks and one grid point a thread for all three
//   components in the z-stage (34.3 ms with one output a thread); 3, 4
//   or 9 groups, 1, 3 or 8 columns, or blocks of 384 or 512 threads took
//   38.1-63.5 ms. The shape of the KDyn configuration
//   (n = 24, mg = 36) has its own instance with the shape as constants:
//   with run-time strides the stages were bound by integer address work
//   (57 ms). A split by cluster
//   (exchanging the shares through distributed shared memory) was not
//   taken: it needs cluster dimensions and a cooperative launch in one
//   launch, and the shares cost one read of S small planes a step.
//   Every sum has a fixed order and no float atomics: the grid point
//   (a, b, k) keeps its owner thread for the sweep, so u_bar accumulates
//   without atomics, and two calls give the same bits. S follows from
//   (n, mg) alone, not from the card.
// Thread-block clusters with the state in distributed shared memory and
// tensor-core transforms are the later, faster designs.
//
// The forward with and without the trajectory, and with and without the
// integrated cost, are instantiations of one template.
//
// All functions launch on the given stream, do not synchronise, and
// return a cudaError_t as int. The caller guarantees contiguous f32
// buffers on the current device, `consts` packed as (Ffr, Ffi (n, mg),
// Fzr, Fzi (kz, mg), Bfr, Bfi (mg, n), Bzr, Bzi (mg, kz), k (3, n, n, kz),
// inv_k2, lhs_inv, rhs_fac, keep, pw, mean_mask (n, n, kz)), a scratch
// buffer `work` of sm_kdyn_work_floats(n, mg) floats, n_steps >= 1, and
// u_bar zeroed.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The forward kernels: small blocks, as many on an SM as the registers
// allow. The sweeps are bound by latency, and the stages want ~170-190
// registers a thread: a bound that forces fewer (two blocks of 256
// threads, 128 registers) spills in the mode-space stage and slowed the
// plain forward by 40 % on an H100; 128 threads with the registers left
// free was the fastest of the sizes tried (64 to 1024). The reverse
// sweep's blocks are below (kBwdThreads).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // at most; the occupancy query decides
constexpr int kMaxBlocks = 4096;  // slots for the per-block energy partials

struct Dims {
  int n, mg, kz;
  int nkz;           // n * kz
  int s1;            // modes of one component: n * n * kz
  int s;             // 3 * s1
  int p1;            // 3 * mg * n * kz
  int p2;            // 3 * mg * mg * kz
  int mats;          // floats of the eight DFT matrices
  int warp_scratch;  // floats of one warp's pencil scratch
  __host__ __device__ Dims(int n_, int mg_) : n(n_), mg(mg_), kz(n_ / 2 + 1) {
    nkz = n * kz;
    s1 = n * nkz;
    s = 3 * s1;
    p1 = 3 * mg * nkz;
    p2 = 3 * mg * mg * kz;
    mats = 4 * n * mg + 4 * kz * mg;
    warp_scratch = 12 * kz + 6 * mg;
  }
  __host__ __device__ long long work_floats() const {  // the forward's scratch
    return 4LL * s + 6LL * p1 + 6LL * p2 + kMaxBlocks;
  }
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)(mats + kWarps * warp_scratch) * sizeof(float);
  }
};

struct Mats {  // in shared memory
  const float *Ffr, *Ffi, *Fzr, *Fzi, *Bfr, *Bfi, *Bzr, *Bzi;
};

struct Factors {  // in global memory, constant for the whole launch
  const float *k, *inv_k2, *lhs_inv, *rhs_fac, *keep, *pw, *mean_mask;
};

template <int kT>
__device__ Mats load_mats(float* smem, const float* consts, const Dims& d) {
  for (int i = threadIdx.x; i < d.mats; i += kT) smem[i] = __ldg(consts + i);
  __syncthreads();
  Mats m;
  m.Ffr = smem;
  m.Ffi = m.Ffr + d.n * d.mg;
  m.Fzr = m.Ffi + d.n * d.mg;
  m.Fzi = m.Fzr + d.kz * d.mg;
  m.Bfr = m.Fzi + d.kz * d.mg;
  m.Bfi = m.Bfr + d.mg * d.n;
  m.Bzr = m.Bfi + d.mg * d.n;
  m.Bzi = m.Bzr + d.mg * d.kz;
  return m;
}

__device__ Factors factors(const float* consts, const Dims& d) {
  Factors f;
  f.k = consts + d.mats;
  f.inv_k2 = f.k + 3 * d.s1;
  f.lhs_inv = f.inv_k2 + d.s1;
  f.rhs_fac = f.lhs_inv + d.s1;
  f.keep = f.rhs_fac + d.s1;
  f.pw = f.keep + d.s1;
  f.mean_mask = f.pw + d.s1;
  return f;
}

// Sum of the per-block partials in a fixed order, by one warp.
__device__ float sum_partials(const float* epart, int nblocks, int lane) {
  float s = 0.f;
  for (int b = lane; b < nblocks; b += 32) s += epart[b];
  return smo::warp_sum(s);
}

// sum_j M_j x_j (or conj(M_j) x_j) of `len` complex terms: the matrix
// entries `js` apart in shared memory, the operand `stride` apart.
template <bool kConj>
__device__ __forceinline__ void cdot(const float* mr, const float* mi, int js,
                                     const float* xr, const float* xi, int stride,
                                     int len, float& outr, float& outi) {
  float r = 0.f, im = 0.f;
  for (int j = 0; j < len; ++j) {
    const float a = mr[j * js], b = mi[j * js];
    const float x = xr[(size_t)j * stride], y = xi[(size_t)j * stride];
    if constexpr (kConj) {
      r += a * x + b * y;
      im += a * y - b * x;
    } else {
      r += a * x - b * y;
      im += a * y + b * x;
    }
  }
  outr = r;
  outi = im;
}

// cdot with four independent partial sums (terms j = 4 i + q go to sum
// q; the sums meet as (s0 + s1) + (s2 + s3)), so that a thread's loads and
// multiply-adds overlap instead of waiting on one chain: the reverse
// sweep's stages are a few short dot products per thread.
template <bool kConj>
__device__ __forceinline__ void cdot4(const float* mr, const float* mi, int js,
                                      const float* xr, const float* xi, int stride,
                                      int len, float& outr, float& outi) {
  float r[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
#pragma unroll
  for (; j + 4 <= len; j += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a = mr[(j + q) * js], b = mi[(j + q) * js];
      const float x = xr[(size_t)(j + q) * stride], y = xi[(size_t)(j + q) * stride];
      if constexpr (kConj) {
        r[q] += a * x + b * y;
        im[q] += a * y - b * x;
      } else {
        r[q] += a * x - b * y;
        im[q] += a * y + b * x;
      }
    }
  }
  for (int q = 0; j < len; ++j, ++q) {
    const float a = mr[j * js], b = mi[j * js];
    const float x = xr[(size_t)j * stride], y = xi[(size_t)j * stride];
    if constexpr (kConj) {
      r[q] += a * x + b * y;
      im[q] += a * y - b * x;
    } else {
      r[q] += a * x - b * y;
      im[q] += a * y + b * x;
    }
  }
  outr = (r[0] + r[1]) + (r[2] + r[3]);
  outi = (im[0] + im[1]) + (im[2] + im[3]);
}

// out[o, m, i] = sum_j M(m, j) in[o, j, i] over the whole grid, with
// M(m, j) = M[m * ms + j * js] (conjugated when kConj): one complex DFT
// stage along the middle axis of an (O, J, I) array.
template <bool kConj>
__device__ void caxis(const float* Mr, const float* Mi, int ms, int js,
                      const float* inr, const float* ini, float* outr, float* outi,
                      int O, int M, int J, int I, int gtid, int gthreads) {
  const int total = O * M * I;
  for (int idx = gtid; idx < total; idx += gthreads) {
    const int i = idx % I, m = (idx / I) % M, o = idx / (I * M);
    const int base = o * J * I + i;
    float r, im;
    cdot<kConj>(Mr + m * ms, Mi + m * ms, js, inr + base, ini + base, I, J, r, im);
    outr[idx] = r;  // idx == (o * M + m) * I + i
    outi[idx] = im;
  }
}

// Forward pencil stage. For each (a, b): B = z-synthesis of g2[:, a, b, :]
// (real output), e = u x B, h3[:, a, b, :] = z-analysis of e.
__device__ void pencils_fwd(const Mats& M, const Dims& d, const float* u,
                            const float* g2r, const float* g2i, float* h3r,
                            float* h3i, float* ws, int gwarp, int gwarps, int lane) {
  const int mg = d.mg, kz = d.kz;
  const size_t grid1 = (size_t)mg * mg * mg;
  float* sr = ws;  // [3][kz]
  float* si = sr + 3 * kz;
  float* gs = ws + 12 * kz;  // [3][mg]
  float* es = gs + 3 * mg;   // [3][mg]
  for (int p = gwarp; p < mg * mg; p += gwarps) {  // p = a * mg + b
    for (int t = lane; t < 3 * kz; t += 32) {
      const int c = t / kz, z = t % kz;
      const size_t src = ((size_t)c * mg * mg + p) * kz + z;
      sr[t] = g2r[src];
      si[t] = g2i[src];
    }
    __syncwarp();
    for (int t = lane; t < 3 * mg; t += 32) {
      const int c = t / mg, k = t % mg;
      float g = 0.f;
      for (int z = 0; z < kz; ++z)
        g += M.Bzr[k * kz + z] * sr[c * kz + z] - M.Bzi[k * kz + z] * si[c * kz + z];
      gs[t] = g;
    }
    __syncwarp();
    for (int k = lane; k < mg; k += 32) {
      const size_t ui = (size_t)p * mg + k;
      const float u0 = __ldg(u + ui), u1 = __ldg(u + grid1 + ui),
                  u2 = __ldg(u + 2 * grid1 + ui);
      const float b0 = gs[k], b1 = gs[mg + k], b2 = gs[2 * mg + k];
      es[k] = u1 * b2 - u2 * b1;
      es[mg + k] = u2 * b0 - u0 * b2;
      es[2 * mg + k] = u0 * b1 - u1 * b0;
    }
    __syncwarp();
    for (int t = lane; t < 3 * kz; t += 32) {
      const int c = t / kz, z = t % kz;
      float cr = 0.f, ci = 0.f;
      for (int k = 0; k < mg; ++k) {
        const float e = es[c * mg + k];
        cr += M.Fzr[z * mg + k] * e;
        ci += M.Fzi[z * mg + k] * e;
      }
      const size_t dst = ((size_t)c * mg * mg + p) * kz + z;
      h3r[dst] = cr;
      h3i[dst] = ci;
    }
    __syncwarp();  // the scratch is free for the next pencil
  }
}

// Mode-space tail of the forward step at mode m: band mask, F = i k x e,
// rhs = rhs_fac b + F, Leray projection, lhs_inv, mean mode zeroed.
__device__ __forceinline__ void step_tail(const Factors& F, int s1, int m,
                                          const float* br, const float* bi,
                                          float* er, float* ei, float* nr, float* ni) {
  const float keep = __ldg(F.keep + m);
  const float k0 = __ldg(F.k + m), k1 = __ldg(F.k + s1 + m),
              k2 = __ldg(F.k + 2 * s1 + m);
  const float rf = __ldg(F.rhs_fac + m), li = __ldg(F.lhs_inv + m),
              ik2 = __ldg(F.inv_k2 + m), mm = __ldg(F.mean_mask + m);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    er[c] *= keep;
    ei[c] *= keep;
  }
  // multiplying by i maps (re, im) -> (-im, re)
  const float rr0 = rf * br[0] - (k1 * ei[2] - k2 * ei[1]);
  const float rr1 = rf * br[1] - (k2 * ei[0] - k0 * ei[2]);
  const float rr2 = rf * br[2] - (k0 * ei[1] - k1 * ei[0]);
  const float ri0 = rf * bi[0] + (k1 * er[2] - k2 * er[1]);
  const float ri1 = rf * bi[1] + (k2 * er[0] - k0 * er[2]);
  const float ri2 = rf * bi[2] + (k0 * er[1] - k1 * er[0]);
  const float pr = (k0 * rr0 + k1 * rr1 + k2 * rr2) * ik2;
  const float pi = (k0 * ri0 + k1 * ri1 + k2 * ri2) * ik2;
  nr[0] = (rr0 - k0 * pr) * li * mm;
  nr[1] = (rr1 - k1 * pr) * li * mm;
  nr[2] = (rr2 - k2 * pr) * li * mm;
  ni[0] = (ri0 - k0 * pi) * li * mm;
  ni[1] = (ri1 - k1 * pi) * li * mm;
  ni[2] = (ri2 - k2 * pi) * li * mm;
}

// Head of the transposed step at mode m, from lambda (three components):
// t = mean mask, lhs_inv, k-projector; the direct term d = rhs_fac t; and
// the cotangent of the analysed e, (e_r, e_i)_bar = (-k x t_i, k x t_r),
// band-masked. Outputs three components each.
struct ModeFactors {
  float keep, k0, k1, k2, rf, lhs, ik2, mm;
};

__device__ __forceinline__ ModeFactors mode_factors(const Factors& F, int s1, int m) {
  return {__ldg(F.keep + m),    __ldg(F.k + m),        __ldg(F.k + s1 + m),
          __ldg(F.k + 2 * s1 + m), __ldg(F.rhs_fac + m), __ldg(F.lhs_inv + m),
          __ldg(F.inv_k2 + m),  __ldg(F.mean_mask + m)};
}

__device__ __forceinline__ void adjoint_head(const ModeFactors& f, const float* lr,
                                             const float* li, float* dr, float* di,
                                             float* p0r, float* p0i) {
  const float keep = f.keep, k0 = f.k0, k1 = f.k1, k2 = f.k2;
  const float rf = f.rf, lhs = f.lhs, ik2 = f.ik2, mm = f.mm;
  float tr[3], ti[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tr[c] = lhs * (mm * lr[c]);
    ti[c] = lhs * (mm * li[c]);
  }
  const float pr = (k0 * tr[0] + k1 * tr[1] + k2 * tr[2]) * ik2;
  const float pi = (k0 * ti[0] + k1 * ti[1] + k2 * ti[2]) * ik2;
  tr[0] -= k0 * pr;
  tr[1] -= k1 * pr;
  tr[2] -= k2 * pr;
  ti[0] -= k0 * pi;
  ti[1] -= k1 * pi;
  ti[2] -= k2 * pi;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dr[c] = rf * tr[c];
    di[c] = rf * ti[c];
  }
  p0r[0] = -keep * (k1 * ti[2] - k2 * ti[1]);
  p0r[1] = -keep * (k2 * ti[0] - k0 * ti[2]);
  p0r[2] = -keep * (k0 * ti[1] - k1 * ti[0]);
  p0i[0] = keep * (k1 * tr[2] - k2 * tr[1]);
  p0i[1] = keep * (k2 * tr[0] - k0 * tr[2]);
  p0i[2] = keep * (k0 * tr[1] - k1 * tr[0]);
}

struct FwdParams {
  const float *br0, *bi0, *u, *consts;
  int n, mg, n_steps;
  float dt;
  float *brT, *biT, *J, *trr, *tri, *work;
};

// Forward: N steps from (br0, bi0). J = E(b_T), or with kIntegrated
// dt * Kahan sum of E(b_0) .. E(b_{N-1}), then E(b_T). With kTraj row i of
// (trr, tri) is the state before step i.
template <bool kTraj, bool kIntegrated>
__global__ void __launch_bounds__(kThreads, 1) kdyn_fwd_kernel(const FwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const Dims d(p.n, p.mg);
  const Mats M = load_mats<kThreads>(smem, p.consts, d);
  const Factors F = factors(p.consts, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = blockIdx.x * kThreads + tid, gthreads = gridDim.x * kThreads;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;
  const bool summer = blockIdx.x == 0 && warp == 0;
  float* ws = smem + d.mats + warp * d.warp_scratch;
  float* sr = p.work;  // the state
  float* si = sr + d.s;
  float* g1r = si + d.s;  // after the x synthesis (3, mg, n, kz)
  float* g1i = g1r + d.p1;
  float* g2r = g1i + d.p1;  // after the y synthesis (3, mg, mg, kz)
  float* g2i = g2r + d.p2;
  float* h3r = g2i + d.p2;  // after the z analysis (3, mg, mg, kz)
  float* h3i = h3r + d.p2;
  float* h4r = h3i + d.p2;  // after the y analysis (3, mg, n, kz)
  float* h4i = h4r + d.p1;
  float* epart = h4i + d.p1;  // per-block energy partials

  float part = 0.f;
  for (int idx = gtid; idx < d.s; idx += gthreads) {
    const float r = p.br0[idx], i = p.bi0[idx];
    sr[idx] = r;
    si[idx] = i;
    if constexpr (kTraj) {
      p.trr[idx] = r;
      p.tri[idx] = i;
    }
    if constexpr (kIntegrated) part += __ldg(F.pw + idx % d.s1) * (r * r + i * i);
  }
  if constexpr (kIntegrated) {
    const float total = smo::block_sum<kWarps>(part, red);
    if (tid == 0) epart[blockIdx.x] = total;
  }
  grid.sync();

  float acc = 0.f, comp = 0.f;  // live in lane 0 of the summer warp
  for (int step = 0; step < p.n_steps; ++step) {
    if constexpr (kIntegrated) {
      if (summer) {
        const float e = sum_partials(epart, gridDim.x, lane);  // E(b_step)
        if (lane == 0) smo::kahan_add(acc, comp, e);
      }
    }
    caxis<false>(M.Bfr, M.Bfi, d.n, 1, sr, si, g1r, g1i, 3, d.mg, d.n, d.nkz, gtid,
                 gthreads);
    grid.sync();
    caxis<false>(M.Bfr, M.Bfi, d.n, 1, g1r, g1i, g2r, g2i, 3 * d.mg, d.mg, d.n, d.kz,
                 gtid, gthreads);
    grid.sync();
    pencils_fwd(M, d, p.u, g2r, g2i, h3r, h3i, ws, gwarp, gwarps, lane);
    grid.sync();
    caxis<false>(M.Ffr, M.Ffi, d.mg, 1, h3r, h3i, h4r, h4i, 3 * d.mg, d.n, d.mg, d.kz,
                 gtid, gthreads);
    grid.sync();
    // x analysis, one thread per mode for all three components, then
    // the mode-space tail
    const bool last = step == p.n_steps - 1;
    part = 0.f;
    for (int m = gtid; m < d.s1; m += gthreads) {
      const int X = m / d.nkz, yz = m % d.nkz;
      float er[3], ei[3], br[3], bi[3], nr[3], ni[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int base = c * d.mg * d.nkz + yz;
        cdot<false>(M.Ffr + X * d.mg, M.Ffi + X * d.mg, 1, h4r + base, h4i + base,
                    d.nkz, d.mg, er[c], ei[c]);
        br[c] = sr[c * d.s1 + m];
        bi[c] = si[c * d.s1 + m];
      }
      step_tail(F, d.s1, m, br, bi, er, ei, nr, ni);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int idx = c * d.s1 + m;
        sr[idx] = nr[c];
        si[idx] = ni[c];
        if constexpr (kTraj) {
          if (!last) {
            p.trr[(size_t)(step + 1) * d.s + idx] = nr[c];
            p.tri[(size_t)(step + 1) * d.s + idx] = ni[c];
          }
        }
      }
      if (kIntegrated || last)
        part += __ldg(F.pw + m) * (nr[0] * nr[0] + ni[0] * ni[0] + nr[1] * nr[1] +
                                   ni[1] * ni[1] + nr[2] * nr[2] + ni[2] * ni[2]);
    }
    if (kIntegrated || last) {
      // the grid barrier below frees `red` for the next step
      const float total = smo::block_sum<kWarps>(part, red);
      if (tid == 0) epart[blockIdx.x] = total;
    }
    grid.sync();
  }

  for (int idx = gtid; idx < d.s; idx += gthreads) {
    p.brT[idx] = sr[idx];
    p.biT[idx] = si[idx];
  }
  if (summer) {
    const float eT = sum_partials(epart, gridDim.x, lane);
    if (lane == 0) {
      if constexpr (kIntegrated) {
        smo::kahan_add(acc, comp, eT);
        *p.J = p.dt * acc;
      } else {
        *p.J = eT;
      }
    }
  }
}

struct BwdParams {
  const float *u, *brT, *biT, *gbar, *consts, *trr, *tri;
  int n, mg, n_steps;
  float dt;
  float *b0r_bar, *b0i_bar, *ubar, *work;
};

// The reverse sweep's partition (see the header). Stage YZ: task (a, grp)
// owns the x-grid slab a and the y-grid points b0 .. b0 + nb - 1,
// b0 = grp nb, of the S groups of a slab; stage X: task `chunk` owns the
// kColChunk (Y, z) mode columns from chunk kColChunk. S and nb follow from
// (n, mg) alone, so the sums' order does not depend on the card.
constexpr int kBwdThreads = 256;
constexpr int kBwdBlocksPerSm = 2;   // at most; the occupancy query decides
constexpr int kPencilsPerTask = 6;   // y-grid points of a stage-YZ task, at most
constexpr int kColChunk = 2;         // mode columns of a stage-X task
constexpr int kPts = 2;              // grid points a thread holds in stage YZ
constexpr int kMaxGroups = 16;       // groups S of a slab, at most (mg <= 96)
constexpr int kLoads = 4;            // global loads a thread keeps in flight

struct BwdDims : Dims {
  int S, nb, tasks, chunks;
  __host__ __device__ BwdDims(int n_, int mg_) : Dims(n_, mg_) {
    S = (mg + kPencilsPerTask - 1) / kPencilsPerTask;
    nb = (mg + S - 1) / S;
    tasks = mg * S;
    chunks = (nkz + kColChunk - 1) / kColChunk;
  }
  // d (2 s), q1 and g1 (4 p1), the S groups' shares of r4 (2 S p1)
  __host__ __device__ long long bwd_work_floats() const {
    return 2LL * s + 4LL * p1 + 2LL * S * p1;
  }
  __host__ __device__ int yz_floats() const { return 12 * nkz + 18 * nb * kz + 3 * nb * mg; }
  __host__ __device__ int x_floats() const { return kColChunk * (6 * mg + 30 * n); }
  __host__ __device__ size_t bwd_smem_bytes() const {
    const int buf = yz_floats() > x_floats() ? yz_floats() : x_floats();
    return (size_t)(mats + buf) * sizeof(float);
  }
};

struct BwdCtx {
  BwdDims d;
  Mats M;
  Factors F;
  const BwdParams* p;
  float* buf;                    // shared memory after the matrices
  float *dr, *di;                // direct term rhs_fac t (3, n, n, kz)
  float *q1r, *q1i, *g1r, *g1i;  // (3, mg, n, kz): x-analysis^T of p0, x-synthesis of b
  float *r4r, *r4i;              // S x (3, mg, n, kz): each group's share of r4
  float wT, wI;
};

// Stage YZ of a reverse step: for each task (a, grp), the y-analysis^T of
// q1 and the y-synthesis of g1 onto the task's y-grid points, the pencil
// work (z-analysis^T -> e_bar, z-synthesis of the stored state -> B_n,
// u_bar += B_n x e_bar, z-synthesis^T of e_bar x u -> r3) and the task's
// share of the y-synthesis^T, sum over its b of conj(Bf(b, Y)) r3.
template <int kN, int kMG>
__device__ __forceinline__ void bwd_stage_yz(const BwdCtx& x) {
  const BwdDims d = kN ? BwdDims(kN, kMG) : x.d;  // constants in the specialised instance
  const Mats& M = x.M;
  const BwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, kz = d.kz, nkz = d.nkz, nb = d.nb;
  const size_t grid1 = (size_t)mg * mg * mg;
  float* sq1r = x.buf;  // [3][nkz] each: the slab of q1 and of g1
  float* sq1i = sq1r + 3 * nkz;
  float* sg1r = sq1i + 3 * nkz;
  float* sg1i = sg1r + 3 * nkz;
  float* q2r = sg1i + 3 * nkz;  // [3][nb][kz] each
  float* q2i = q2r + 3 * nb * kz;
  float* g2r = q2i + 3 * nb * kz;
  float* g2i = g2r + 3 * nb * kz;
  float* r3r = g2i + 3 * nb * kz;
  float* r3i = r3r + 3 * nb * kz;
  float* eb = r3i + 3 * nb * kz;  // [3][nb][mg]: e_bar x u
  const int cs = nb * mg;         // its component stride
  for (int task = blockIdx.x; task < d.tasks; task += gridDim.x) {
    const int a = task / d.S, grp = task % d.S;
    const int b0 = grp * nb, nbl = min(nb, mg - b0), npts = nbl * mg;
    // this thread's grid points (pt = bl mg + k): u and u_bar in flight
    // during the y stage
    float uu[kPts][3], ub[kPts][3];
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kBwdThreads;
      if (pt < npts) {
        const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          uu[q][c] = __ldg(p.u + c * grid1 + gi);
          ub[q][c] = p.ubar[c * grid1 + gi];
        }
      }
    }
    // the slab of q1 and g1, kLoads elements a thread in flight at once
    for (int i0 = tid; i0 < 3 * nkz; i0 += kLoads * kBwdThreads) {
      float v[kLoads][4];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = i0 + q * kBwdThreads;
        if (i < 3 * nkz) {
          const size_t src = ((size_t)(i / nkz) * mg + a) * nkz + i % nkz;
          v[q][0] = x.q1r[src];
          v[q][1] = x.q1i[src];
          v[q][2] = x.g1r[src];
          v[q][3] = x.g1i[src];
        }
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = i0 + q * kBwdThreads;
        if (i < 3 * nkz) {
          sq1r[i] = v[q][0];
          sq1i[i] = v[q][1];
          sg1r[i] = v[q][2];
          sg1i[i] = v[q][3];
        }
      }
    }
    __syncthreads();
    for (int o = tid; o < 3 * nbl * kz; o += kBwdThreads) {
      const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz, b = b0 + bl;
      const int dst = (c * nb + bl) * kz + z;
      cdot4<true>(M.Ffr + b, M.Ffi + b, mg, sq1r + c * nkz + z, sq1i + c * nkz + z, kz, n,
                 q2r[dst], q2i[dst]);
      cdot4<false>(M.Bfr + b * n, M.Bfi + b * n, 1, sg1r + c * nkz + z, sg1i + c * nkz + z,
                  kz, n, g2r[dst], g2i[dst]);
    }
    __syncthreads();
    // at this thread's grid points (bl, k): z-analysis^T -> e_bar and
    // z-synthesis -> B_n, all three components at once (the matrix
    // entries shared), then u_bar += B_n x e_bar and e_bar x u
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kBwdThreads;
      if (pt < npts) {
        const int bl = pt / mg, k = pt % mg;
        float e[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int z = 0; z < kz; ++z) {
          const float fr = M.Fzr[z * mg + k], fi = M.Fzi[z * mg + k];
          const float br = M.Bzr[k * kz + z], bi = M.Bzi[k * kz + z];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int src = (c * nb + bl) * kz + z;
            e[c] += fr * q2r[src] + fi * q2i[src];
            v[c] += br * g2r[src] - bi * g2i[src];
          }
        }
        const float u0 = uu[q][0], u1 = uu[q][1], u2 = uu[q][2];
        const size_t gi = ((size_t)a * mg + b0) * mg + pt;
        p.ubar[gi] = ub[q][0] + (v[1] * e[2] - v[2] * e[1]);
        p.ubar[grid1 + gi] = ub[q][1] + (v[2] * e[0] - v[0] * e[2]);
        p.ubar[2 * grid1 + gi] = ub[q][2] + (v[0] * e[1] - v[1] * e[0]);
        eb[pt] = e[1] * u2 - e[2] * u1;
        eb[cs + pt] = e[2] * u0 - e[0] * u2;
        eb[2 * cs + pt] = e[0] * u1 - e[1] * u0;
      }
    }
    __syncthreads();
    for (int o = tid; o < 3 * nbl * kz; o += kBwdThreads) {
      const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz;
      const float* gs = eb + c * cs + bl * mg;
      float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};  // k mod 4
      int k = 0;
#pragma unroll
      for (; k + 4 <= mg; k += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[q] += M.Bzr[(k + q) * kz + z] * gs[k + q];
          ai[q] -= M.Bzi[(k + q) * kz + z] * gs[k + q];
        }
      }
      for (int q = 0; k < mg; ++k, ++q) {
        ar[q] += M.Bzr[k * kz + z] * gs[k];
        ai[q] -= M.Bzi[k * kz + z] * gs[k];
      }
      r3r[(c * nb + bl) * kz + z] = (ar[0] + ar[1]) + (ar[2] + ar[3]);
      r3i[(c * nb + bl) * kz + z] = (ai[0] + ai[1]) + (ai[2] + ai[3]);
    }
    __syncthreads();
    for (int o = tid; o < 3 * nkz; o += kBwdThreads) {
      const int c = o / nkz, col = o % nkz, Y = col / kz, z = col % kz;
      float vr, vi;
      cdot4<true>(M.Bfr + b0 * n + Y, M.Bfi + b0 * n + Y, n, r3r + c * nb * kz + z,
                 r3i + c * nb * kz + z, kz, nbl, vr, vi);
      const size_t dst = (size_t)grp * d.p1 + ((size_t)c * mg + a) * nkz + col;
      x.r4r[dst] = vr;
      x.r4i[dst] = vi;
    }
    __syncthreads();  // the buffers are free for the next task
  }
}

// Stage X at the end of reverse step kk (kk = -1: the start of the sweep,
// from lambda_T): for each task's mode columns, r4 (the groups' shares
// added in group order), the x-synthesis^T plus the direct term (and the
// integrated cost's term) -> lambda_n; on the last step b0_bar = lambda_0,
// else the head of the next transposed step (d to memory, p0), the
// x-analysis^T of p0 -> q1 and the x-synthesis of the next stored state
// -> g1.
template <bool kIntegrated, int kN, int kMG>
__device__ __forceinline__ void bwd_stage_x(const BwdCtx& x, int kk) {
  const BwdDims d = kN ? BwdDims(kN, kMG) : x.d;
  const Mats& M = x.M;
  const Factors& F = x.F;
  const BwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, nkz = d.nkz, s1 = d.s1;
  const int tm = 3 * n;  // modes (c, X) of one column
  const bool first = kk < 0, last = kk == p.n_steps - 1;
  const long long state = (long long)(p.n_steps - 1 - kk) * d.s;  // b_{N-1-kk}
  const long long next = state - d.s;                              // b_{N-2-kk}
  constexpr int CT = kColChunk;
  float* r4sr = x.buf;  // [CT][3 mg] each
  float* r4si = r4sr + CT * 3 * mg;
  float* lamr = r4si + CT * 3 * mg;  // [CT][3 n] each, as are the rest
  float* lami = lamr + CT * tm;
  float* p0r = lami + CT * tm;
  float* p0i = p0r + CT * tm;
  float* dsr = p0i + CT * tm;
  float* dsi = dsr + CT * tm;
  float* bir = dsi + CT * tm;
  float* bii = bir + CT * tm;
  float* bnr = bii + CT * tm;
  float* bni = bnr + CT * tm;
  for (int chunk = blockIdx.x; chunk < d.chunks; chunk += gridDim.x) {
    const int col0 = chunk * CT, nc = min(CT, nkz - col0);
    // the head's factors of this thread's mode (j, X), in flight early
    const bool header = !last && tid < n * nc;
    const int hj = tid / n, hX = tid % n, hm = hX * nkz + col0 + hj;
    ModeFactors hf{};
    if (header) hf = mode_factors(F, s1, hm);
    // the columns' mode-space inputs, (c, X, j) with j fastest
    for (int o = tid; o < tm * nc; o += kBwdThreads) {
      const int j = o % nc, cx = o / nc, c = cx / n, X = cx % n;
      const int m = X * nkz + col0 + j, idx = c * s1 + m, sl = j * tm + cx;
      if (first) {
        const float w = x.wT * __ldg(F.pw + m);
        lamr[sl] = w * p.brT[idx];
        lami[sl] = w * p.biT[idx];
      } else {
        dsr[sl] = x.dr[idx];
        dsi[sl] = x.di[idx];
        if constexpr (kIntegrated) {  // the integrated cost's term, w b_n
          const float w = x.wI * __ldg(F.pw + m);
          bir[sl] = w * p.trr[state + idx];
          bii[sl] = w * p.tri[state + idx];
        }
      }
      if (!last) {
        bnr[sl] = p.trr[next + idx];
        bni[sl] = p.tri[next + idx];
      }
    }
    if (!first) {
      for (int o = tid; o < 3 * mg * nc; o += kBwdThreads) {
        const int j = o % nc, ca = o / nc;  // ca = c mg + a
        const size_t src = (size_t)ca * nkz + col0 + j;
        float sr[kMaxGroups], si[kMaxGroups];  // all loads in flight at once
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          if (g < d.S) {
            sr[g] = x.r4r[(size_t)g * d.p1 + src];
            si[g] = x.r4i[(size_t)g * d.p1 + src];
          }
        }
        float vr = 0.f, vi = 0.f;
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          if (g < d.S) {
            vr += sr[g];
            vi += si[g];
          }
        }
        r4sr[j * 3 * mg + ca] = vr;
        r4si[j * 3 * mg + ca] = vi;
      }
    }
    __syncthreads();
    if (!first) {
      for (int o = tid; o < tm * nc; o += kBwdThreads) {
        const int j = o / tm, cx = o % tm, c = cx / n, X = cx % n;
        const int m = X * nkz + col0 + j, sl = j * tm + cx;
        float lr, li;
        cdot4<true>(M.Bfr + X, M.Bfi + X, n, r4sr + j * 3 * mg + c * mg,
                   r4si + j * 3 * mg + c * mg, 1, mg, lr, li);
        lr += dsr[sl];
        li += dsi[sl];
        if constexpr (kIntegrated) {
          lr += bir[sl];
          li += bii[sl];
        }
        if (last) {
          p.b0r_bar[c * s1 + m] = lr;
          p.b0i_bar[c * s1 + m] = li;
        } else {
          lamr[sl] = lr;
          lami[sl] = li;
        }
      }
      __syncthreads();
    }
    if (!last) {
      if (header) {
        float lr[3], li[3], hdr[3], hdi[3], hpr[3], hpi[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lr[c] = lamr[hj * tm + c * n + hX];
          li[c] = lami[hj * tm + c * n + hX];
        }
        adjoint_head(hf, lr, li, hdr, hdi, hpr, hpi);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x.dr[c * s1 + hm] = hdr[c];
          x.di[c * s1 + hm] = hdi[c];
          p0r[hj * tm + c * n + hX] = hpr[c];
          p0i[hj * tm + c * n + hX] = hpi[c];
        }
      }
      __syncthreads();
      for (int o = tid; o < 3 * mg * nc; o += kBwdThreads) {
        const int j = o % nc, ca = o / nc, c = ca / mg, a = ca % mg;
        const int base = j * tm + c * n;
        float qr, qi, gr, gi;
        cdot4<true>(M.Ffr + a, M.Ffi + a, mg, p0r + base, p0i + base, 1, n, qr, qi);
        cdot4<false>(M.Bfr + a * n, M.Bfi + a * n, 1, bnr + base, bni + base, 1, n, gr, gi);
        const size_t dst = (size_t)ca * nkz + col0 + j;
        x.q1r[dst] = qr;
        x.q1i[dst] = qi;
        x.g1r[dst] = gr;
        x.g1i[dst] = gi;
      }
    }
    __syncthreads();  // the buffers are free for the next task
  }
}

// Reverse sweep: lambda_T = w_T gbar pw b_T (w_T = 2, or 2 dt with
// kIntegrated); for n = N-1 .. 0: lambda_n = S^T lambda_{n+1}
// (+ 2 dt gbar pw b_n with kIntegrated), u_bar += to_grid(b_n) x e_bar_n.
// Two grid-wide barriers a step: after stage YZ and after stage X.
// (kN, kMG) = (0, 0) takes the shape from p; otherwise it must be (n, mg),
// and the shape is a compile-time constant (strides and trip counts fold,
// which cuts the stages' integer work about in half at n = 24).
template <bool kIntegrated, int kN, int kMG>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
kdyn_bwd_kernel(const BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  BwdCtx x{BwdDims(p.n, p.mg)};
  x.M = load_mats<kBwdThreads>(smem, p.consts, x.d);
  x.F = factors(p.consts, x.d);
  x.p = &p;
  x.buf = smem + x.d.mats;
  x.dr = p.work;
  x.di = x.dr + x.d.s;
  x.q1r = x.di + x.d.s;
  x.q1i = x.q1r + x.d.p1;
  x.g1r = x.q1i + x.d.p1;
  x.g1i = x.g1r + x.d.p1;
  x.r4r = x.g1i + x.d.p1;
  x.r4i = x.r4r + (size_t)x.d.S * x.d.p1;
  const float g = __ldg(p.gbar);
  x.wT = (kIntegrated ? 2.f * p.dt : 2.f) * g;
  x.wI = 2.f * p.dt * g;

  bwd_stage_x<kIntegrated, kN, kMG>(x, -1);
  grid.sync();
  for (int kk = 0; kk < p.n_steps; ++kk) {
    bwd_stage_yz<kN, kMG>(x);
    grid.sync();
    bwd_stage_x<kIntegrated, kN, kMG>(x, kk);
    if (kk + 1 < p.n_steps) grid.sync();
  }
}

// Cooperative launch with every block co-resident: at most `per_sm`
// blocks of `threads` on each SM, fewer if the kernel's resources allow
// fewer, and at most `max_blocks`. `need` is the scratch the launch reads.
template <typename Params>
int launch(void (*kernel)(const Params), Params& params, int threads, int per_sm,
           int max_blocks, size_t smem, long long need, long long work_floats,
           void* stream) {
  if (params.n < 2 || params.mg < params.n || params.n_steps < 1 || work_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int blocks = sms * (occ < per_sm ? occ : per_sm);
  if (blocks > max_blocks) blocks = max_blocks;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kTraj>
int launch_fwd(FwdParams& p, int integrated, long long work_floats, void* stream) {
  const Dims d(p.n, p.mg);
  const auto kernel = integrated ? kdyn_fwd_kernel<kTraj, true> : kdyn_fwd_kernel<kTraj, false>;
  return launch(kernel, p, kThreads, kBlocksPerSm, kMaxBlocks, d.smem_bytes(),
                d.work_floats(), work_floats, stream);
}

// One block per task of the larger stage, at most.
int launch_bwd(BwdParams& p, int integrated, long long work_floats, void* stream) {
  const BwdDims d(p.n, p.mg);
  if (d.nb * d.mg > kPts * kBwdThreads || d.S > kMaxGroups || d.n * kColChunk > kBwdThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  // the KDyn configuration's shape (24^3 modes on the 36^3 grid) has its
  // own instance
  const bool main = p.n == 24 && p.mg == 36;
  const auto kernel = integrated ? (main ? kdyn_bwd_kernel<true, 24, 36> : kdyn_bwd_kernel<true, 0, 0>)
                                 : (main ? kdyn_bwd_kernel<false, 24, 36> : kdyn_bwd_kernel<false, 0, 0>);
  return launch(kernel, p, kBwdThreads, kBwdBlocksPerSm,
                d.tasks > d.chunks ? d.tasks : d.chunks, d.bwd_smem_bytes(),
                d.bwd_work_floats(), work_floats, stream);
}

}  // namespace

extern "C" {

// Floats of scratch that a launch at (n, mg) needs (the larger of the
// forward's and the reverse sweep's).
int sm_kdyn_work_floats(int n, int mg) {
  const long long f = Dims(n, mg).work_floats(), b = BwdDims(n, mg).bwd_work_floats();
  return static_cast<int>(f > b ? f : b);
}

int sm_kdyn_fwd(const float* br0, const float* bi0, const float* u,
                const float* consts, int n, int mg, int n_steps, int integrated,
                float dt, float* brT, float* biT, float* J, float* work,
                long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, nullptr, nullptr, work};
  return launch_fwd<false>(p, integrated, work_floats, stream);
}

int sm_kdyn_fwd_traj(const float* br0, const float* bi0, const float* u,
                     const float* consts, int n, int mg, int n_steps, int integrated,
                     float dt, float* brT, float* biT, float* J, float* trr,
                     float* tri, float* work, long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, trr, tri, work};
  return launch_fwd<true>(p, integrated, work_floats, stream);
}

int sm_kdyn_bwd(const float* u, const float* brT, const float* biT, const float* gbar,
                const float* consts, const float* trr, const float* tri, int n, int mg,
                int n_steps, int integrated, float dt, float* b0r_bar, float* b0i_bar,
                float* ubar, float* work, long long work_floats, void* stream) {
  BwdParams p{u, brT, biT, gbar, consts, trr, tri, n, mg, n_steps, dt,
              b0r_bar, b0i_bar, ubar, work};
  return launch_bwd(p, integrated, work_floats, stream);
}

}  // extern "C"
