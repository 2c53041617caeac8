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
//     co-resident (two or so of 128 threads on each SM), with a
//     grid-wide barrier between the five stages of a step:
//     x-synthesis | y-synthesis | per pencil: z-synthesis, cross
//     product, z-analysis | y-analysis | x-analysis fused with the
//     mode-space tail (curl, rhs, Leray, lhs_inv) and the energy;
//   * the intermediates (well under 2 MB) go through global memory and
//     stay in the 50 MB L2; the eight DFT matrices sit in shared memory;
//   * J and the per-step energies are sums of per-block partials taken
//     in a fixed order (no float atomics), and the Kahan accumulation
//     over the steps lives in one thread with the pinned rounding of
//     common.cuh, so J is the same from run to run;
//   * in the reverse sweep each pencil has one owner warp for the whole
//     sweep, so u_bar accumulates without atomics; the synthesis of the
//     stored state b_n rides in the same stages as the lambda chain.
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

// Small blocks, as many on an SM as the registers allow. The sweeps are
// bound by latency, and the stages want ~170-190 registers a thread: a
// bound that forces fewer (two blocks of 256 threads, 128 registers)
// spills in the mode-space stage and slowed the plain forward by 40 %
// and the reverse sweep by 5 % on an H100; 128 threads with the
// registers left free was the fastest of the sizes tried (64 to 1024).
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
  __host__ __device__ long long work_floats() const {
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

__device__ Mats load_mats(float* smem, const float* consts, const Dims& d) {
  for (int i = threadIdx.x; i < d.mats; i += kThreads) smem[i] = __ldg(consts + i);
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

// Reverse pencil stage. For each (a, b): e_bar = z-analysis^T of
// q2[:, a, b, :], B_n = z-synthesis of g2[:, a, b, :] (the stored state),
// u_bar[:, a, b, :] += B_n x e_bar, and r3[:, a, b, :] = z-synthesis^T of
// e_bar x u. A pencil keeps its warp for the whole sweep.
__device__ void pencils_bwd(const Mats& M, const Dims& d, const float* u,
                            const float* q2r, const float* q2i, const float* g2r,
                            const float* g2i, float* r3r, float* r3i, float* ubar,
                            float* ws, int gwarp, int gwarps, int lane) {
  const int mg = d.mg, kz = d.kz;
  const size_t grid1 = (size_t)mg * mg * mg;
  float* qr = ws;  // [3][kz] each
  float* qi = qr + 3 * kz;
  float* gr = qi + 3 * kz;
  float* gi = gr + 3 * kz;
  float* gs = ws + 12 * kz;  // [3][mg]: B_n, then e_bar x u
  float* es = gs + 3 * mg;   // [3][mg]: e_bar
  for (int p = gwarp; p < mg * mg; p += gwarps) {
    for (int t = lane; t < 3 * kz; t += 32) {
      const int c = t / kz, z = t % kz;
      const size_t src = ((size_t)c * mg * mg + p) * kz + z;
      qr[t] = q2r[src];
      qi[t] = q2i[src];
      gr[t] = g2r[src];
      gi[t] = g2i[src];
    }
    __syncwarp();
    for (int t = lane; t < 3 * mg; t += 32) {
      const int c = t / mg, k = t % mg;
      float e = 0.f, b = 0.f;
      for (int z = 0; z < kz; ++z) {
        e += M.Fzr[z * mg + k] * qr[c * kz + z] + M.Fzi[z * mg + k] * qi[c * kz + z];
        b += M.Bzr[k * kz + z] * gr[c * kz + z] - M.Bzi[k * kz + z] * gi[c * kz + z];
      }
      es[t] = e;
      gs[t] = b;
    }
    __syncwarp();
    for (int k = lane; k < mg; k += 32) {
      const size_t ui = (size_t)p * mg + k;
      const float u0 = __ldg(u + ui), u1 = __ldg(u + grid1 + ui),
                  u2 = __ldg(u + 2 * grid1 + ui);
      const float e0 = es[k], e1 = es[mg + k], e2 = es[2 * mg + k];
      const float b0 = gs[k], b1 = gs[mg + k], b2 = gs[2 * mg + k];
      ubar[ui] += b1 * e2 - b2 * e1;
      ubar[grid1 + ui] += b2 * e0 - b0 * e2;
      ubar[2 * grid1 + ui] += b0 * e1 - b1 * e0;
      gs[k] = e1 * u2 - e2 * u1;
      gs[mg + k] = e2 * u0 - e0 * u2;
      gs[2 * mg + k] = e0 * u1 - e1 * u0;
    }
    __syncwarp();
    for (int t = lane; t < 3 * kz; t += 32) {
      const int c = t / kz, z = t % kz;
      float a = 0.f, b = 0.f;
      for (int k = 0; k < mg; ++k) {
        const float g = gs[c * mg + k];
        a += M.Bzr[k * kz + z] * g;
        b -= M.Bzi[k * kz + z] * g;
      }
      const size_t dst = ((size_t)c * mg * mg + p) * kz + z;
      r3r[dst] = a;
      r3i[dst] = b;
    }
    __syncwarp();
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

// Head of the transposed step at mode m, from lambda: t = mean mask,
// lhs_inv, k-projector; the direct term d = rhs_fac t; and the cotangent
// of the analysed e, (e_r, e_i)_bar = (-k x t_i, k x t_r), band-masked.
__device__ __forceinline__ void adjoint_head(const Factors& F, int s1, int m,
                                             const float* lr, const float* li,
                                             float* dr, float* di, float* p0r,
                                             float* p0i) {
  const float keep = __ldg(F.keep + m);
  const float k0 = __ldg(F.k + m), k1 = __ldg(F.k + s1 + m),
              k2 = __ldg(F.k + 2 * s1 + m);
  const float rf = __ldg(F.rhs_fac + m), lhs = __ldg(F.lhs_inv + m),
              ik2 = __ldg(F.inv_k2 + m), mm = __ldg(F.mean_mask + m);
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
    dr[c * s1 + m] = rf * tr[c];
    di[c * s1 + m] = rf * ti[c];
  }
  p0r[m] = -keep * (k1 * ti[2] - k2 * ti[1]);
  p0r[s1 + m] = -keep * (k2 * ti[0] - k0 * ti[2]);
  p0r[2 * s1 + m] = -keep * (k0 * ti[1] - k1 * ti[0]);
  p0i[m] = keep * (k1 * tr[2] - k2 * tr[1]);
  p0i[s1 + m] = keep * (k2 * tr[0] - k0 * tr[2]);
  p0i[2 * s1 + m] = keep * (k0 * tr[1] - k1 * tr[0]);
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
  const Mats M = load_mats(smem, p.consts, d);
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

// Reverse sweep: lambda_T = w_T gbar pw b_T (w_T = 2, or 2 dt with
// kIntegrated); for n = N-1 .. 0: lambda_n = S^T lambda_{n+1}
// (+ 2 dt gbar pw b_n with kIntegrated), u_bar += to_grid(b_n) x e_bar_n.
template <bool kIntegrated>
__global__ void __launch_bounds__(kThreads, 1) kdyn_bwd_kernel(const BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const Dims d(p.n, p.mg);
  const Mats M = load_mats(smem, p.consts, d);
  const Factors F = factors(p.consts, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = blockIdx.x * kThreads + tid, gthreads = gridDim.x * kThreads;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;
  float* ws = smem + d.mats + warp * d.warp_scratch;
  float* dr = p.work;  // the direct term rhs_fac t (3, n, n, kz)
  float* di = dr + d.s;
  float* p0r = di + d.s;  // cotangent of the analysed e (3, n, n, kz)
  float* p0i = p0r + d.s;
  float* q1r = p0i + d.s;  // lambda chain after x, then y analysis^T
  float* q1i = q1r + d.p1;
  float* g1r = q1i + d.p1;  // stored state after x, then y synthesis
  float* g1i = g1r + d.p1;
  float* r4r = g1i + d.p1;  // lambda chain after y synthesis^T
  float* r4i = r4r + d.p1;
  float* q2r = r4i + d.p1;
  float* q2i = q2r + d.p2;
  float* g2r = q2i + d.p2;
  float* g2i = g2r + d.p2;
  float* r3r = g2i + d.p2;  // lambda chain after z synthesis^T
  float* r3i = r3r + d.p2;

  const float g = __ldg(p.gbar);
  const float wT = (kIntegrated ? 2.f * p.dt : 2.f) * g;
  const float wI = 2.f * p.dt * g;

  for (int m = gtid; m < d.s1; m += gthreads) {
    const float w = wT * __ldg(F.pw + m);
    float lr[3], li[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lr[c] = w * p.brT[c * d.s1 + m];
      li[c] = w * p.biT[c * d.s1 + m];
    }
    adjoint_head(F, d.s1, m, lr, li, dr, di, p0r, p0i);
  }
  grid.sync();

  for (int kk = 0; kk < p.n_steps; ++kk) {
    const float* tr_r = p.trr + (size_t)(p.n_steps - 1 - kk) * d.s;  // b_n
    const float* tr_i = p.tri + (size_t)(p.n_steps - 1 - kk) * d.s;
    caxis<true>(M.Ffr, M.Ffi, 1, d.mg, p0r, p0i, q1r, q1i, 3, d.mg, d.n, d.nkz, gtid,
                gthreads);
    caxis<false>(M.Bfr, M.Bfi, d.n, 1, tr_r, tr_i, g1r, g1i, 3, d.mg, d.n, d.nkz, gtid,
                 gthreads);
    grid.sync();
    caxis<true>(M.Ffr, M.Ffi, 1, d.mg, q1r, q1i, q2r, q2i, 3 * d.mg, d.mg, d.n, d.kz,
                gtid, gthreads);
    caxis<false>(M.Bfr, M.Bfi, d.n, 1, g1r, g1i, g2r, g2i, 3 * d.mg, d.mg, d.n, d.kz,
                 gtid, gthreads);
    grid.sync();
    pencils_bwd(M, d, p.u, q2r, q2i, g2r, g2i, r3r, r3i, p.ubar, ws, gwarp, gwarps,
                lane);
    grid.sync();
    caxis<true>(M.Bfr, M.Bfi, 1, d.n, r3r, r3i, r4r, r4i, 3 * d.mg, d.n, d.mg, d.kz,
                gtid, gthreads);
    grid.sync();
    // x synthesis^T, one thread per mode for all three components, plus
    // the direct term; then the head of the next transposed step
    const bool last = kk == p.n_steps - 1;
    for (int m = gtid; m < d.s1; m += gthreads) {
      const int X = m / d.nkz, yz = m % d.nkz;
      const float w = wI * __ldg(F.pw + m);
      float lr[3], li[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int base = c * d.mg * d.nkz + yz;
        cdot<true>(M.Bfr + X, M.Bfi + X, d.n, r4r + base, r4i + base, d.nkz, d.mg,
                   lr[c], li[c]);
        lr[c] += dr[c * d.s1 + m];
        li[c] += di[c * d.s1 + m];
        if constexpr (kIntegrated) {
          lr[c] += w * tr_r[c * d.s1 + m];
          li[c] += w * tr_i[c * d.s1 + m];
        }
      }
      if (last) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p.b0r_bar[c * d.s1 + m] = lr[c];
          p.b0i_bar[c * d.s1 + m] = li[c];
        }
      } else {
        adjoint_head(F, d.s1, m, lr, li, dr, di, p0r, p0i);
      }
    }
    grid.sync();
  }
}

// Cooperative launch with every block co-resident: at most kBlocksPerSm
// blocks on each SM, fewer if the kernel's resources allow fewer.
template <typename Params>
int launch(void (*kernel)(const Params), Params& params, long long work_floats,
           void* stream) {
  const Dims d(params.n, params.mg);
  if (params.n < 2 || params.mg < params.n || params.n_steps < 1 ||
      work_floats < d.work_floats())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = d.smem_bytes();
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int blocks = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kTraj>
int launch_fwd(FwdParams& p, int integrated, long long work_floats, void* stream) {
  return integrated ? launch(kdyn_fwd_kernel<kTraj, true>, p, work_floats, stream)
                    : launch(kdyn_fwd_kernel<kTraj, false>, p, work_floats, stream);
}

}  // namespace

extern "C" {

// Floats of scratch that a launch at (n, mg) needs.
int sm_kdyn_work_floats(int n, int mg) {
  return static_cast<int>(Dims(n, mg).work_floats());
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
  return integrated ? launch(kdyn_bwd_kernel<true>, p, work_floats, stream)
                    : launch(kdyn_bwd_kernel<false>, p, work_floats, stream);
}

}  // extern "C"
