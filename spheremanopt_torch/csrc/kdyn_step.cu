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
// up to the y analysis is local to one (a, b) pencil of the grid.
//
// Both sweeps are one persistent cooperative kernel with the same
// partition and two grid-wide barriers a step. The x-direction work and
// the y/z-direction work get different owners, and only three arrays
// cross between them through L2:
//   * stage X, by mode column (Y, z), tasks of kColChunk adjacent columns
//     (adjacent in every array the stage reads and writes; 156 tasks at
//     n = 24), all three components and every X of its columns at hand;
//   * stage YZ, by x-grid slab a, split into S groups of <= 6 y-grid
//     points b so that the ~216 tasks spread over the card (36 slabs
//     alone would leave 96 of 132 SMs idle); the y-stage, the pencils'
//     z-stages and cross products, and the group's share of the y-stage
//     back to mode columns; stage X adds the S shares in group order
//     (add_shares).
// Forward (sm_kdyn_fwd, sm_kdyn_fwd_traj): stage X adds the shares of h4
// (the y-analysed e), runs the x-analysis, the mode-space tail (curl, rhs,
// Leray, lhs_inv: local to a mode, all three components at hand), writes
// the new state (and the trajectory row), forms the chunk's energy, and
// runs the x-synthesis of the new state -> g1; stage YZ runs the
// y-synthesis of g1 onto its b, the pencils (z-synthesis, u x B,
// z-analysis) and its share of the y-analysis -> h4. Only g1 and the
// shares of h4 cross; g2 and h3 stay in shared memory.
// Reverse (sm_kdyn_bwd): stage X: r4 of the column -> x-synthesis^T plus
// the direct term (and the integrated cost's term) -> lambda_n; the head
// of the next transposed step; the x-analysis^T of its p0 -> q1, and the
// x-synthesis of the next stored state -> g1. Stage YZ: the y-analysis^T
// of q1 and y-synthesis of g1 onto the group's b, the pencil work
// (z-stages, cross products, u_bar), the z-synthesis^T, and the group's
// share of the y-synthesis^T -> r4. q2, g2 and r3 stay in shared memory.
//
// Blocks of 256 threads, two on an SM, one block per task of the larger
// stage: a block that has to run two tasks of a stage doubles that
// stage's time. Measured on an H100 SXM at 700 W (n = 24, 2000 steps),
// for the reverse: 31.6 ms a sweep with 6 groups, two-column X tasks and
// one grid point a thread for all three components in the z-stage (34.3
// ms with one output a thread); 3, 4 or 9 groups, 1, 3 or 8 columns, or
// blocks of 384 or 512 threads took 38.1-63.5 ms; the forward takes
// 28.4 ms a sweep (27.5 without the trajectory), against 50.5 ms with
// one grid-wide stage per transform (five barriers a step). The shape
// of the KDyn configuration (n = 24, mg = 36) has its own instance of
// each sweep with the shape as constants: with run-time strides the
// reverse's stages were bound by integer address work (57 ms). A split
// by cluster (exchanging the shares through distributed shared memory)
// was not taken: it needs cluster dimensions and a cooperative launch in
// one launch, and the shares cost one read of S small planes a step.
// Every sum has a fixed order and no float atomics, and none depends on
// the number of blocks the card holds: S follows from (n, mg) alone; the
// energies are per-chunk partials summed in chunk order by one warp, and
// the Kahan accumulation over the steps lives in one thread with the
// pinned rounding of common.cuh; the grid point (a, b, k) keeps its
// owner thread for the sweep, so u_bar accumulates without atomics. Two
// calls give the same bits. Thread-block clusters with the state in
// distributed shared memory and tensor-core transforms are the later,
// faster designs.
//
// The forward with and without the trajectory, and with and without the
// integrated cost, are instantiations of one template.
//
// Rows (sm_kdyn_fwd_rows, sm_kdyn_fwd_traj_rows, sm_kdyn_bwd_rows: the
// same kernels under the JAX package's jax.vmap, where pallas_call's
// batching rule gives each a grid over a sweep's rows): R <= kMaxRows
// independent sweeps of one constant pack in one launch, the kRows
// instances of the same two templates. Stage YZ's task index runs over R x
// tasks and stage X's over R x chunks in the same grid-stride loops, row
// t / tasks (t / chunks); the two grid-wide barriers a step stay two, and
// the DFT matrices are staged into shared memory once for every row. Each
// row has its own operands (the (R, ...) arrays, one row's size apart),
// its own slab of `work`, and its own Kahan sum, in thread 32 r of the
// last block (warp r sums row r's partials). The order of every sum
// depends on (n, mg) alone and a (row, task) keeps its owner thread for
// the sweep, so each row's outputs are bitwise the one-row kernel's on
// that row. One row at n = 24 is 216 YZ tasks and 156 X chunks on at most
// 264 co-resident blocks; R = 8 is 1728 and 1248 on the same blocks, so a
// row launch saves barriers and launches, not stage work.
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

// The partition of both sweeps (see the header). Stage YZ: task (a, grp)
// owns the x-grid slab a and the y-grid points b0 .. b0 + nb - 1,
// b0 = grp nb, of the S groups of a slab; stage X: task `chunk` owns the
// kColChunk (Y, z) mode columns from chunk kColChunk. S and nb follow from
// (n, mg) alone, so the sums' order does not depend on the card.
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartBlocksPerSm = 2;  // at most; the occupancy query decides
constexpr int kPencilsPerTask = 6;   // y-grid points of a stage-YZ task, at most
constexpr int kColChunk = 2;         // mode columns of a stage-X task
constexpr int kPts = 2;              // grid points a thread holds in stage YZ
constexpr int kMaxGroups = 16;       // groups S of a slab, at most (mg <= 96)
constexpr int kLoads = 4;            // global loads a thread keeps in flight
constexpr int kMaxRows = kPartWarps; // rows of a row launch: one warp's Kahan sum each

struct Dims {
  int n, mg, kz;
  int nkz;   // n * kz
  int s1;    // modes of one component: n * n * kz
  int s;     // 3 * s1
  int p1;    // 3 * mg * n * kz
  int mats;  // floats of the eight DFT matrices
  __host__ __device__ Dims(int n_, int mg_) : n(n_), mg(mg_), kz(n_ / 2 + 1) {
    nkz = n * kz;
    s1 = n * nkz;
    s = 3 * s1;
    p1 = 3 * mg * nkz;
    mats = 4 * n * mg + 4 * kz * mg;
  }
};

struct PartDims : Dims {
  int S, nb, tasks, chunks;
  __host__ __device__ PartDims(int n_, int mg_) : Dims(n_, mg_) {
    S = mg > 0 ? (mg + kPencilsPerTask - 1) / kPencilsPerTask : 1;
    nb = (mg + S - 1) / S;
    tasks = mg * S;
    chunks = (nkz + kColChunk - 1) / kColChunk;
  }
  // the state (2 s), g1 (2 p1), the S groups' shares of h4 (2 S p1), the
  // chunks' energy partials of two steps (2 chunks)
  __host__ __device__ long long fwd_work_floats() const {
    return 2LL * s + 2LL * p1 + 2LL * S * p1 + 2LL * chunks;
  }
  // d (2 s), q1 and g1 (4 p1), the S groups' shares of r4 (2 S p1)
  __host__ __device__ long long bwd_work_floats() const {
    return 2LL * s + 4LL * p1 + 2LL * S * p1;
  }
  __host__ __device__ int fwd_yz_floats() const {
    return 6 * nkz + 12 * nb * kz + 3 * nb * mg;
  }
  __host__ __device__ int fwd_x_floats() const { return kColChunk * (6 * mg + 18 * n); }
  __host__ __device__ int bwd_yz_floats() const {
    return 12 * nkz + 18 * nb * kz + 3 * nb * mg;
  }
  __host__ __device__ int bwd_x_floats() const { return kColChunk * (6 * mg + 30 * n); }
  __host__ __device__ size_t smem_bytes(int yz, int x) const {
    return (size_t)(mats + (yz > x ? yz : x)) * sizeof(float);
  }
  __host__ __device__ size_t fwd_smem_bytes() const {
    return smem_bytes(fwd_yz_floats(), fwd_x_floats());
  }
  __host__ __device__ size_t bwd_smem_bytes() const {
    return smem_bytes(bwd_yz_floats(), bwd_x_floats());
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

// Sum of the per-chunk partials in a fixed order, by one warp.
__device__ float sum_partials(const float* epart, int n, int lane) {
  float s = 0.f;
  for (int b = lane; b < n; b += 32) s += epart[b];
  return smo::warp_sum(s);
}

// sum_j M_j x_j (or conj(M_j) x_j) of `len` complex terms, the matrix
// entries `js` apart in shared memory, the operand `stride` apart, with
// four independent partial sums (terms j = 4 i + q go to sum q; the sums
// meet as (s0 + s1) + (s2 + s3)), so that a thread's loads and
// multiply-adds overlap instead of waiting on one chain: the stages are a
// few short dot products per thread.
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

// Stage YZ's input: the slab a of kP (3, mg, n, kz) arrays,
// dst[q][c nkz + col] = src[q][(c mg + a) nkz + col], kLoads elements a
// thread in flight at once.
template <int kP>
__device__ __forceinline__ void load_slab(const float* const* src, float* const* dst, int a,
                                          int mg, int nkz) {
  for (int i0 = threadIdx.x; i0 < 3 * nkz; i0 += kLoads * kPartThreads) {
    float v[kLoads][kP];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * kPartThreads;
      if (i < 3 * nkz) {
        const size_t at = ((size_t)(i / nkz) * mg + a) * nkz + i % nkz;
#pragma unroll
        for (int w = 0; w < kP; ++w) v[q][w] = src[w][at];
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = i0 + q * kPartThreads;
      if (i < 3 * nkz) {
#pragma unroll
        for (int w = 0; w < kP; ++w) dst[w][i] = v[q][w];
      }
    }
  }
}

// Stage X's input: the S groups' shares of a (3, mg, n, kz) array at the
// chunk's nc columns from col0, added in group order:
// (dr, di)[j 3 mg + c mg + a] = sum_g (shr, shi)[g][(c mg + a) nkz + col0 + j].
__device__ __forceinline__ void add_shares(const PartDims& d, const float* shr,
                                           const float* shi, int col0, int nc, float* dr,
                                           float* di) {
  for (int o = threadIdx.x; o < 3 * d.mg * nc; o += kPartThreads) {
    const int j = o % nc, ca = o / nc;  // ca = c mg + a
    const size_t src = (size_t)ca * d.nkz + col0 + j;
    float sr[kMaxGroups], si[kMaxGroups];  // all loads in flight at once
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < d.S) {
        sr[g] = shr[(size_t)g * d.p1 + src];
        si[g] = shi[(size_t)g * d.p1 + src];
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
    dr[j * 3 * d.mg + ca] = vr;
    di[j * 3 * d.mg + ca] = vi;
  }
}

// The mode-space factors of mode m.
struct ModeFactors {
  float keep, k0, k1, k2, rf, lhs, ik2, mm;
};

__device__ __forceinline__ ModeFactors mode_factors(const Factors& F, int s1, int m) {
  return {__ldg(F.keep + m),    __ldg(F.k + m),        __ldg(F.k + s1 + m),
          __ldg(F.k + 2 * s1 + m), __ldg(F.rhs_fac + m), __ldg(F.lhs_inv + m),
          __ldg(F.inv_k2 + m),  __ldg(F.mean_mask + m)};
}

// Mode-space tail of the forward step at one mode, from the state b and
// the analysed e (three components each): band mask, F = i k x e,
// rhs = rhs_fac b + F, Leray projection, lhs_inv, mean mode zeroed.
__device__ __forceinline__ void step_tail(const ModeFactors& f, const float* br,
                                          const float* bi, const float* er_in,
                                          const float* ei_in, float* nr, float* ni) {
  const float k0 = f.k0, k1 = f.k1, k2 = f.k2, rf = f.rf, li = f.lhs, ik2 = f.ik2,
              mm = f.mm;
  float er[3], ei[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    er[c] = er_in[c] * f.keep;
    ei[c] = ei_in[c] * f.keep;
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

// pw |b|^2 of one mode, three components.
__device__ __forceinline__ float mode_energy(float pw, const float* r, const float* i) {
  return pw * (r[0] * r[0] + i[0] * i[0] + r[1] * r[1] + i[1] * i[1] + r[2] * r[2] +
               i[2] * i[2]);
}

// Head of the transposed step at mode m, from lambda (three components):
// t = mean mask, lhs_inv, k-projector; the direct term d = rhs_fac t; and
// the cotangent of the analysed e, (e_r, e_i)_bar = (-k x t_i, k x t_r),
// band-masked. Outputs three components each.
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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdParams {
  const float *br0, *bi0, *u, *consts;
  int n, mg, n_steps;
  float dt;
  float *brT, *biT, *J, *trr, *tri, *work;
  int rows = 1;  // R: the (R, ...) arrays of a row launch
};

struct FwdCtx {
  PartDims d;
  Mats M;
  Factors F;
  const FwdParams* p;
  float* buf;  // shared memory after the matrices
  float* red;  // [kPartWarps] of shared memory, for block_sum
};

// Row `row` of a launch: its operands, `row` rows into the (R, ...)
// arrays, and its own slab of `work` (a one-row launch: row 0, the arrays
// themselves).
struct FwdRow {
  const float *br0, *bi0, *u;
  float *brT, *biT, *J, *trr, *tri;
  float *sr, *si;    // the state (3, n, n, kz)
  float *g1r, *g1i;  // (3, mg, n, kz): x-synthesis of the state
  float *h4r, *h4i;  // S x (3, mg, n, kz): each group's share of h4
  float* epart;      // [2][chunks]: the chunks' energy partials, by step parity
};

__device__ __forceinline__ FwdRow fwd_row(const FwdParams& p, const PartDims& d, int row) {
  const size_t s = (size_t)row * d.s, g = (size_t)row * 3 * d.mg * d.mg * d.mg;
  const size_t traj = s * p.n_steps;
  FwdRow r;
  r.br0 = p.br0 + s;
  r.bi0 = p.bi0 + s;
  r.u = p.u + g;
  r.brT = p.brT + s;
  r.biT = p.biT + s;
  r.J = p.J + row;
  r.trr = p.trr ? p.trr + traj : nullptr;
  r.tri = p.tri ? p.tri + traj : nullptr;
  r.sr = p.work + (size_t)row * d.fwd_work_floats();
  r.si = r.sr + d.s;
  r.g1r = r.si + d.s;
  r.g1i = r.g1r + d.p1;
  r.h4r = r.g1i + d.p1;
  r.h4i = r.h4r + (size_t)d.S * d.p1;
  r.epart = r.h4i + (size_t)d.S * d.p1;
  return r;
}

// Stage YZ of a forward step: for each task (a, grp) of each row, the
// y-synthesis of the slab a of g1 onto the task's y-grid points, the
// pencil work (z-synthesis -> B, e = u x B, z-analysis -> h3) and the
// task's share of the y-analysis, sum over its b of Ff(Y, b) h3.
template <int kN, int kMG, bool kRows>
__device__ __forceinline__ void fwd_stage_yz(const FwdCtx& x) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;  // constants in the specialised instance
  const Mats& M = x.M;
  const FwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, kz = d.kz, nkz = d.nkz, nb = d.nb;
  const int R = kRows ? p.rows : 1;
  const size_t grid1 = (size_t)mg * mg * mg;
  float* sg1r = x.buf;  // [3][nkz] each: the slab of g1
  float* sg1i = sg1r + 3 * nkz;
  float* g2r = sg1i + 3 * nkz;  // [3][nb][kz] each
  float* g2i = g2r + 3 * nb * kz;
  float* h3r = g2i + 3 * nb * kz;
  float* h3i = h3r + 3 * nb * kz;
  float* es = h3i + 3 * nb * kz;  // [3][nb][mg]: e = u x B
  const int cs = nb * mg;         // its component stride
  float* const dst[2] = {sg1r, sg1i};
  for (int t = blockIdx.x; t < R * d.tasks; t += gridDim.x) {
    const int row = kRows ? t / d.tasks : 0, task = t - row * d.tasks;
    const FwdRow r = fwd_row(p, d, row);
    const int a = task / d.S, grp = task % d.S;
    const int b0 = grp * nb, nbl = min(nb, mg - b0), npts = nbl * mg;
    // u at this thread's grid points (pt = bl mg + k), in flight during
    // the y stage
    float uu[kPts][3];
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kPartThreads;
      if (pt < npts) {
        const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
        for (int c = 0; c < 3; ++c) uu[q][c] = __ldg(r.u + c * grid1 + gi);
      }
    }
    const float* src[2] = {r.g1r, r.g1i};
    load_slab<2>(src, dst, a, mg, nkz);
    __syncthreads();
    for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
      const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz, b = b0 + bl;
      const int at = (c * nb + bl) * kz + z;
      cdot4<false>(M.Bfr + b * n, M.Bfi + b * n, 1, sg1r + c * nkz + z, sg1i + c * nkz + z,
                   kz, n, g2r[at], g2i[at]);
    }
    __syncthreads();
    // at this thread's grid points (bl, k): z-synthesis (real output) of
    // all three components at once (the matrix entries shared), then
    // e = u x B
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kPartThreads;
      if (pt < npts) {
        const int bl = pt / mg, k = pt % mg;
        float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int z = 0; z < kz; ++z) {
          const float br = M.Bzr[k * kz + z], bi = M.Bzi[k * kz + z];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int at = (c * nb + bl) * kz + z;
            v[c] += br * g2r[at] - bi * g2i[at];
          }
        }
        const float u0 = uu[q][0], u1 = uu[q][1], u2 = uu[q][2];
        es[pt] = u1 * v[2] - u2 * v[1];
        es[cs + pt] = u2 * v[0] - u0 * v[2];
        es[2 * cs + pt] = u0 * v[1] - u1 * v[0];
      }
    }
    __syncthreads();
    // z-analysis: h3 = sum over k of Fz(z, k) e(k)
    for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
      const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz;
      const float* e = es + c * cs + bl * mg;
      const float* fr = M.Fzr + z * mg;
      const float* fi = M.Fzi + z * mg;
      float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};  // k mod 4
      int k = 0;
#pragma unroll
      for (; k + 4 <= mg; k += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[q] += fr[k + q] * e[k + q];
          ai[q] += fi[k + q] * e[k + q];
        }
      }
      for (int q = 0; k < mg; ++k, ++q) {
        ar[q] += fr[k] * e[k];
        ai[q] += fi[k] * e[k];
      }
      h3r[(c * nb + bl) * kz + z] = (ar[0] + ar[1]) + (ar[2] + ar[3]);
      h3i[(c * nb + bl) * kz + z] = (ai[0] + ai[1]) + (ai[2] + ai[3]);
    }
    __syncthreads();
    for (int o = tid; o < 3 * nkz; o += kPartThreads) {
      const int c = o / nkz, col = o % nkz, Y = col / kz, z = col % kz;
      float vr, vi;
      cdot4<false>(M.Ffr + Y * mg + b0, M.Ffi + Y * mg + b0, 1, h3r + c * nb * kz + z,
                   h3i + c * nb * kz + z, kz, nbl, vr, vi);
      const size_t at = (size_t)grp * d.p1 + ((size_t)c * mg + a) * nkz + col;
      r.h4r[at] = vr;
      r.h4i[at] = vi;
    }
    __syncthreads();  // the buffers are free for the next task
  }
}

// Stage X of forward step `step` (step = -1: the start of the sweep, from
// b_0): for each task's mode columns of each row, h4 (the groups' shares
// added in group order), the x-analysis, the mode-space tail -> b_{step+1}
// (to the state, the trajectory row step + 1, or b_T on the last step)
// and its energy partial, then the x-synthesis of b_{step+1} -> g1. Warp
// r of the last block adds row r's E(b_step) to its Kahan sum meanwhile
// (with kIntegrated; the chunks write E(b_{step+1}) to the other half of
// epart).
template <bool kTraj, bool kIntegrated, int kN, int kMG, bool kRows>
__device__ __forceinline__ void fwd_stage_x(const FwdCtx& x, int step, float& acc,
                                            float& comp) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
  const Mats& M = x.M;
  const FwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, nkz = d.nkz, s1 = d.s1;
  const int R = kRows ? p.rows : 1, warp = tid / 32, lane = tid % 32;
  const int tm = 3 * n;  // modes (c, X) of one column
  const bool first = step < 0, last = step == p.n_steps - 1;
  const bool energy = kIntegrated || last;
  constexpr int CT = kColChunk;
  float* h4sr = x.buf;  // [CT][3 mg] each
  float* h4si = h4sr + CT * 3 * mg;
  float* bsr = h4si + CT * 3 * mg;  // [CT][3 n] each, as are the rest: b_step
  float* bsi = bsr + CT * tm;
  float* er = bsi + CT * tm;  // the x-analysed e
  float* ei = er + CT * tm;
  float* bnr = ei + CT * tm;  // b_{step+1}
  float* bni = bnr + CT * tm;
  if (kIntegrated && !first && blockIdx.x == gridDim.x - 1 && warp < R) {
    const float e = sum_partials(fwd_row(p, d, warp).epart + (step & 1) * d.chunks,
                                 d.chunks, lane);
    if (lane == 0) smo::kahan_add(acc, comp, e);  // row `warp`'s E(b_step)
  }
  for (int t = blockIdx.x; t < R * d.chunks; t += gridDim.x) {
    const int row = kRows ? t / d.chunks : 0, chunk = t - row * d.chunks;
    const FwdRow r = fwd_row(p, d, row);
    const float* inr = first ? r.br0 : r.sr;
    const float* ini = first ? r.bi0 : r.si;
    float* epart = r.epart + ((step + 1) & 1) * d.chunks;
    const int col0 = chunk * CT, nc = min(CT, nkz - col0);
    // the tail's factors of this thread's mode (j, X), in flight early
    const bool tailer = tid < n * nc;
    const int hj = tid / n, hX = tid % n, hm = hX * nkz + col0 + hj;
    ModeFactors hf{};
    float hpw = 0.f;
    if (tailer) {
      if (!first) hf = mode_factors(x.F, s1, hm);
      hpw = __ldg(x.F.pw + hm);
    }
    // the columns' state, (c, X, j) with j fastest
    for (int o = tid; o < tm * nc; o += kPartThreads) {
      const int j = o % nc, cx = o / nc, c = cx / n, X = cx % n;
      const int idx = c * s1 + X * nkz + col0 + j, sl = j * tm + cx;
      bsr[sl] = inr[idx];
      bsi[sl] = ini[idx];
    }
    if (!first) add_shares(d, r.h4r, r.h4i, col0, nc, h4sr, h4si);
    __syncthreads();
    if (!first) {
      for (int o = tid; o < tm * nc; o += kPartThreads) {
        const int j = o / tm, cx = o % tm, c = cx / n, X = cx % n;
        cdot4<false>(M.Ffr + X * mg, M.Ffi + X * mg, 1, h4sr + j * 3 * mg + c * mg,
                     h4si + j * 3 * mg + c * mg, 1, mg, er[j * tm + cx], ei[j * tm + cx]);
      }
      __syncthreads();
    }
    float part = 0.f;
    if (tailer) {
      float b_r[3], b_i[3], nr[3], ni[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b_r[c] = bsr[hj * tm + c * n + hX];
        b_i[c] = bsi[hj * tm + c * n + hX];
      }
      if (first) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          nr[c] = b_r[c];
          ni[c] = b_i[c];
        }
      } else {
        float e_r[3], e_i[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          e_r[c] = er[hj * tm + c * n + hX];
          e_i[c] = ei[hj * tm + c * n + hX];
        }
        step_tail(hf, b_r, b_i, e_r, e_i, nr, ni);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int idx = c * s1 + hm;
        bnr[hj * tm + c * n + hX] = nr[c];
        bni[hj * tm + c * n + hX] = ni[c];
        if (last) {
          r.brT[idx] = nr[c];
          r.biT[idx] = ni[c];
        } else {
          r.sr[idx] = nr[c];
          r.si[idx] = ni[c];
          if constexpr (kTraj) {
            r.trr[(size_t)(step + 1) * d.s + idx] = nr[c];
            r.tri[(size_t)(step + 1) * d.s + idx] = ni[c];
          }
        }
      }
      if (energy) part = mode_energy(hpw, nr, ni);
    }
    if (energy) {
      // its __syncthreads also publishes b_{step+1}; the one at the end of
      // the task frees `red`
      const float total = smo::block_sum<kPartWarps>(part, x.red);
      if (tid == 0) epart[chunk] = total;
    } else {
      __syncthreads();
    }
    if (!last) {
      for (int o = tid; o < 3 * mg * nc; o += kPartThreads) {
        const int j = o % nc, ca = o / nc, c = ca / mg, a = ca % mg;
        const int base = j * tm + c * n;
        float gr, gi;
        cdot4<false>(M.Bfr + a * n, M.Bfi + a * n, 1, bnr + base, bni + base, 1, n, gr, gi);
        const size_t at = (size_t)ca * nkz + col0 + j;
        r.g1r[at] = gr;
        r.g1i[at] = gi;
      }
    }
    __syncthreads();  // the buffers are free for the next task
  }
}

// Forward: N steps from (br0, bi0) of each row. J = E(b_T), or with
// kIntegrated dt * Kahan sum of E(b_0) .. E(b_{N-1}), then E(b_T). With
// kTraj row i of (trr, tri) is the state before step i. Two grid-wide
// barriers a step: after stage YZ and after stage X. (kN, kMG) as in
// kdyn_bwd_kernel; kRows: p.rows rows (else one).
template <bool kTraj, bool kIntegrated, int kN, int kMG, bool kRows>
__global__ void __launch_bounds__(kPartThreads, kPartBlocksPerSm)
kdyn_fwd_kernel(const FwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red[kPartWarps];
  FwdCtx x{PartDims(p.n, p.mg)};
  x.M = load_mats<kPartThreads>(smem, p.consts, x.d);
  x.F = factors(p.consts, x.d);
  x.p = &p;
  x.buf = smem + x.d.mats;
  x.red = red;

  float acc = 0.f, comp = 0.f;  // row r's live in thread 32 r of the last block
  fwd_stage_x<kTraj, kIntegrated, kN, kMG, kRows>(x, -1, acc, comp);
  grid.sync();
  for (int step = 0; step < p.n_steps; ++step) {
    fwd_stage_yz<kN, kMG, kRows>(x);
    grid.sync();
    fwd_stage_x<kTraj, kIntegrated, kN, kMG, kRows>(x, step, acc, comp);
    grid.sync();
  }
  const int R = kRows ? p.rows : 1, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (blockIdx.x == gridDim.x - 1 && warp < R) {
    const FwdRow r = fwd_row(p, x.d, warp);
    const float eT = sum_partials(r.epart + (p.n_steps & 1) * x.d.chunks, x.d.chunks, lane);
    if (lane == 0) {
      if constexpr (kIntegrated) {
        smo::kahan_add(acc, comp, eT);
        *r.J = p.dt * acc;
      } else {
        *r.J = eT;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// reverse
// ---------------------------------------------------------------------------

struct BwdParams {
  const float *u, *brT, *biT, *gbar, *consts, *trr, *tri;
  int n, mg, n_steps;
  float dt;
  float *b0r_bar, *b0i_bar, *ubar, *work;
  int rows = 1;  // R: the (R, ...) arrays of a row launch
};

struct BwdCtx {
  PartDims d;
  Mats M;
  Factors F;
  const BwdParams* p;
  float* buf;  // shared memory after the matrices
};

// Row `row` of a launch, as FwdRow.
struct BwdRow {
  const float *u, *brT, *biT, *gbar, *trr, *tri;
  float *b0r_bar, *b0i_bar, *ubar;
  float *dr, *di;                // direct term rhs_fac t (3, n, n, kz)
  float *q1r, *q1i, *g1r, *g1i;  // (3, mg, n, kz): x-analysis^T of p0, x-synthesis of b
  float *r4r, *r4i;              // S x (3, mg, n, kz): each group's share of r4
};

__device__ __forceinline__ BwdRow bwd_row(const BwdParams& p, const PartDims& d, int row) {
  const size_t s = (size_t)row * d.s, g = (size_t)row * 3 * d.mg * d.mg * d.mg;
  const size_t traj = s * p.n_steps;
  BwdRow r;
  r.u = p.u + g;
  r.brT = p.brT + s;
  r.biT = p.biT + s;
  r.gbar = p.gbar + row;
  r.trr = p.trr + traj;
  r.tri = p.tri + traj;
  r.b0r_bar = p.b0r_bar + s;
  r.b0i_bar = p.b0i_bar + s;
  r.ubar = p.ubar + g;
  r.dr = p.work + (size_t)row * d.bwd_work_floats();
  r.di = r.dr + d.s;
  r.q1r = r.di + d.s;
  r.q1i = r.q1r + d.p1;
  r.g1r = r.q1i + d.p1;
  r.g1i = r.g1r + d.p1;
  r.r4r = r.g1i + d.p1;
  r.r4i = r.r4r + (size_t)d.S * d.p1;
  return r;
}

// Stage YZ of a reverse step: for each task (a, grp) of each row, the
// y-analysis^T of q1 and the y-synthesis of g1 onto the task's y-grid
// points, the pencil work (z-analysis^T -> e_bar, z-synthesis of the
// stored state -> B_n, u_bar += B_n x e_bar, z-synthesis^T of e_bar x u
// -> r3) and the task's share of the y-synthesis^T, sum over its b of
// conj(Bf(b, Y)) r3.
template <int kN, int kMG, bool kRows>
__device__ __forceinline__ void bwd_stage_yz(const BwdCtx& x) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;  // constants in the specialised instance
  const Mats& M = x.M;
  const BwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, kz = d.kz, nkz = d.nkz, nb = d.nb;
  const int R = kRows ? p.rows : 1;
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
  float* const dst[4] = {sq1r, sq1i, sg1r, sg1i};
  for (int t = blockIdx.x; t < R * d.tasks; t += gridDim.x) {
    const int row = kRows ? t / d.tasks : 0, task = t - row * d.tasks;
    const BwdRow r = bwd_row(p, d, row);
    const int a = task / d.S, grp = task % d.S;
    const int b0 = grp * nb, nbl = min(nb, mg - b0), npts = nbl * mg;
    // this thread's grid points (pt = bl mg + k): u and u_bar in flight
    // during the y stage
    float uu[kPts][3], ub[kPts][3];
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kPartThreads;
      if (pt < npts) {
        const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          uu[q][c] = __ldg(r.u + c * grid1 + gi);
          ub[q][c] = r.ubar[c * grid1 + gi];
        }
      }
    }
    const float* src[4] = {r.q1r, r.q1i, r.g1r, r.g1i};
    load_slab<4>(src, dst, a, mg, nkz);
    __syncthreads();
    for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
      const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz, b = b0 + bl;
      const int at = (c * nb + bl) * kz + z;
      cdot4<true>(M.Ffr + b, M.Ffi + b, mg, sq1r + c * nkz + z, sq1i + c * nkz + z, kz, n,
                 q2r[at], q2i[at]);
      cdot4<false>(M.Bfr + b * n, M.Bfi + b * n, 1, sg1r + c * nkz + z, sg1i + c * nkz + z,
                  kz, n, g2r[at], g2i[at]);
    }
    __syncthreads();
    // at this thread's grid points (bl, k): z-analysis^T -> e_bar and
    // z-synthesis -> B_n, all three components at once (the matrix
    // entries shared), then u_bar += B_n x e_bar and e_bar x u
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int pt = tid + q * kPartThreads;
      if (pt < npts) {
        const int bl = pt / mg, k = pt % mg;
        float e[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int z = 0; z < kz; ++z) {
          const float fr = M.Fzr[z * mg + k], fi = M.Fzi[z * mg + k];
          const float br = M.Bzr[k * kz + z], bi = M.Bzi[k * kz + z];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int at = (c * nb + bl) * kz + z;
            e[c] += fr * q2r[at] + fi * q2i[at];
            v[c] += br * g2r[at] - bi * g2i[at];
          }
        }
        const float u0 = uu[q][0], u1 = uu[q][1], u2 = uu[q][2];
        const size_t gi = ((size_t)a * mg + b0) * mg + pt;
        r.ubar[gi] = ub[q][0] + (v[1] * e[2] - v[2] * e[1]);
        r.ubar[grid1 + gi] = ub[q][1] + (v[2] * e[0] - v[0] * e[2]);
        r.ubar[2 * grid1 + gi] = ub[q][2] + (v[0] * e[1] - v[1] * e[0]);
        eb[pt] = e[1] * u2 - e[2] * u1;
        eb[cs + pt] = e[2] * u0 - e[0] * u2;
        eb[2 * cs + pt] = e[0] * u1 - e[1] * u0;
      }
    }
    __syncthreads();
    for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
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
    for (int o = tid; o < 3 * nkz; o += kPartThreads) {
      const int c = o / nkz, col = o % nkz, Y = col / kz, z = col % kz;
      float vr, vi;
      cdot4<true>(M.Bfr + b0 * n + Y, M.Bfi + b0 * n + Y, n, r3r + c * nb * kz + z,
                 r3i + c * nb * kz + z, kz, nbl, vr, vi);
      const size_t at = (size_t)grp * d.p1 + ((size_t)c * mg + a) * nkz + col;
      r.r4r[at] = vr;
      r.r4i[at] = vi;
    }
    __syncthreads();  // the buffers are free for the next task
  }
}

// Stage X at the end of reverse step kk (kk = -1: the start of the sweep,
// from lambda_T): for each task's mode columns of each row, r4 (the
// groups' shares added in group order), the x-synthesis^T plus the direct
// term (and the integrated cost's term) -> lambda_n; on the last step
// b0_bar = lambda_0, else the head of the next transposed step (d to
// memory, p0), the x-analysis^T of p0 -> q1 and the x-synthesis of the
// next stored state -> g1. The cost's weights w_T = 2 gbar (2 dt gbar
// with kIntegrated) and w_I = 2 dt gbar are the row's.
template <bool kIntegrated, int kN, int kMG, bool kRows>
__device__ __forceinline__ void bwd_stage_x(const BwdCtx& x, int kk) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
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
  const int R = kRows ? p.rows : 1;
  for (int t = blockIdx.x; t < R * d.chunks; t += gridDim.x) {
    const int row = kRows ? t / d.chunks : 0, chunk = t - row * d.chunks;
    const BwdRow r = bwd_row(p, d, row);
    const float g = __ldg(r.gbar);
    const float wT = (kIntegrated ? 2.f * p.dt : 2.f) * g, wI = 2.f * p.dt * g;
    const int col0 = chunk * CT, nc = min(CT, nkz - col0);
    // the head's factors of this thread's mode (j, X), in flight early
    const bool header = !last && tid < n * nc;
    const int hj = tid / n, hX = tid % n, hm = hX * nkz + col0 + hj;
    ModeFactors hf{};
    if (header) hf = mode_factors(F, s1, hm);
    // the columns' mode-space inputs, (c, X, j) with j fastest
    for (int o = tid; o < tm * nc; o += kPartThreads) {
      const int j = o % nc, cx = o / nc, c = cx / n, X = cx % n;
      const int m = X * nkz + col0 + j, idx = c * s1 + m, sl = j * tm + cx;
      if (first) {
        const float w = wT * __ldg(F.pw + m);
        lamr[sl] = w * r.brT[idx];
        lami[sl] = w * r.biT[idx];
      } else {
        dsr[sl] = r.dr[idx];
        dsi[sl] = r.di[idx];
        if constexpr (kIntegrated) {  // the integrated cost's term, w b_n
          const float w = wI * __ldg(F.pw + m);
          bir[sl] = w * r.trr[state + idx];
          bii[sl] = w * r.tri[state + idx];
        }
      }
      if (!last) {
        bnr[sl] = r.trr[next + idx];
        bni[sl] = r.tri[next + idx];
      }
    }
    if (!first) add_shares(d, r.r4r, r.r4i, col0, nc, r4sr, r4si);
    __syncthreads();
    if (!first) {
      for (int o = tid; o < tm * nc; o += kPartThreads) {
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
          r.b0r_bar[c * s1 + m] = lr;
          r.b0i_bar[c * s1 + m] = li;
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
          r.dr[c * s1 + hm] = hdr[c];
          r.di[c * s1 + hm] = hdi[c];
          p0r[hj * tm + c * n + hX] = hpr[c];
          p0i[hj * tm + c * n + hX] = hpi[c];
        }
      }
      __syncthreads();
      for (int o = tid; o < 3 * mg * nc; o += kPartThreads) {
        const int j = o % nc, ca = o / nc, c = ca / mg, a = ca % mg;
        const int base = j * tm + c * n;
        float qr, qi, gr, gi;
        cdot4<true>(M.Ffr + a, M.Ffi + a, mg, p0r + base, p0i + base, 1, n, qr, qi);
        cdot4<false>(M.Bfr + a * n, M.Bfi + a * n, 1, bnr + base, bni + base, 1, n, gr, gi);
        const size_t at = (size_t)ca * nkz + col0 + j;
        r.q1r[at] = qr;
        r.q1i[at] = qi;
        r.g1r[at] = gr;
        r.g1i[at] = gi;
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
// which cuts the stages' integer work about in half at n = 24). kRows:
// p.rows rows (else one), each with its own gbar.
template <bool kIntegrated, int kN, int kMG, bool kRows>
__global__ void __launch_bounds__(kPartThreads, kPartBlocksPerSm)
kdyn_bwd_kernel(const BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  BwdCtx x{PartDims(p.n, p.mg)};
  x.M = load_mats<kPartThreads>(smem, p.consts, x.d);
  x.F = factors(p.consts, x.d);
  x.p = &p;
  x.buf = smem + x.d.mats;

  bwd_stage_x<kIntegrated, kN, kMG, kRows>(x, -1);
  grid.sync();
  for (int kk = 0; kk < p.n_steps; ++kk) {
    bwd_stage_yz<kN, kMG, kRows>(x);
    grid.sync();
    bwd_stage_x<kIntegrated, kN, kMG, kRows>(x, kk);
    if (kk + 1 < p.n_steps) grid.sync();
  }
}

// Cooperative launch of a sweep with every block co-resident: at most
// kPartBlocksPerSm blocks of kPartThreads on each SM, fewer if the
// kernel's resources allow fewer, and at most one per task of the larger
// stage over all rows. `row_work` is the scratch one row reads. Shapes
// past the partition's limits (the pencil points of a task, the groups of
// a slab, the modes of a stage-X task) and row counts outside 1 ..
// kMaxRows give cudaErrorInvalidValue.
template <typename Params>
int launch(void (*kernel)(const Params), Params& params, size_t smem, long long row_work,
           long long work_floats, void* stream) {
  const PartDims d(params.n, params.mg);
  if (params.n < 2 || params.mg < params.n || params.n_steps < 1 || params.rows < 1 ||
      params.rows > kMaxRows || work_floats < params.rows * row_work ||
      d.nb * d.mg > kPts * kPartThreads || d.S > kMaxGroups ||
      d.n * kColChunk > kPartThreads)
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kPartThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int blocks = sms * (occ < kPartBlocksPerSm ? occ : kPartBlocksPerSm);
  const int max_blocks = params.rows * (d.tasks > d.chunks ? d.tasks : d.chunks);
  if (blocks > max_blocks) blocks = max_blocks;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kPartThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The KDyn configuration's shape (24^3 modes on the 36^3 grid) has its own
// instance of each sweep.
bool main_shape(int n, int mg) { return n == 24 && mg == 36; }

template <bool kTraj, bool kRows>
int launch_fwd(FwdParams& p, int integrated, long long work_floats, void* stream) {
  const PartDims d(p.n, p.mg);
  const bool main = main_shape(p.n, p.mg);
  const auto kernel = integrated ? (main ? kdyn_fwd_kernel<kTraj, true, 24, 36, kRows>
                                         : kdyn_fwd_kernel<kTraj, true, 0, 0, kRows>)
                                 : (main ? kdyn_fwd_kernel<kTraj, false, 24, 36, kRows>
                                         : kdyn_fwd_kernel<kTraj, false, 0, 0, kRows>);
  return launch(kernel, p, d.fwd_smem_bytes(), d.fwd_work_floats(), work_floats, stream);
}

template <bool kRows>
int launch_bwd(BwdParams& p, int integrated, long long work_floats, void* stream) {
  const PartDims d(p.n, p.mg);
  const bool main = main_shape(p.n, p.mg);
  const auto kernel = integrated ? (main ? kdyn_bwd_kernel<true, 24, 36, kRows>
                                         : kdyn_bwd_kernel<true, 0, 0, kRows>)
                                 : (main ? kdyn_bwd_kernel<false, 24, 36, kRows>
                                         : kdyn_bwd_kernel<false, 0, 0, kRows>);
  return launch(kernel, p, d.bwd_smem_bytes(), d.bwd_work_floats(), work_floats, stream);
}

}  // namespace

extern "C" {

// csrc/kdyn_rows.cu compiles this file with SMO_KDYN_ROWS defined: the row
// launches' instances then build in an nvcc process of their own, beside
// the one-row ones (one file with both took twice as long to compile as
// either half, and the longest source sets the build's time).
#ifndef SMO_KDYN_ROWS

// Floats of scratch that a launch at (n, mg) needs for each of its rows
// (the larger of the forward's and the reverse sweep's).
int sm_kdyn_work_floats(int n, int mg) {
  const PartDims d(n, mg);
  const long long f = d.fwd_work_floats(), b = d.bwd_work_floats();
  return static_cast<int>(f > b ? f : b);
}

int sm_kdyn_fwd(const float* br0, const float* bi0, const float* u,
                const float* consts, int n, int mg, int n_steps, int integrated,
                float dt, float* brT, float* biT, float* J, float* work,
                long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, nullptr, nullptr, work};
  return launch_fwd<false, false>(p, integrated, work_floats, stream);
}

int sm_kdyn_fwd_traj(const float* br0, const float* bi0, const float* u,
                     const float* consts, int n, int mg, int n_steps, int integrated,
                     float dt, float* brT, float* biT, float* J, float* trr,
                     float* tri, float* work, long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, trr, tri, work};
  return launch_fwd<true, false>(p, integrated, work_floats, stream);
}

int sm_kdyn_bwd(const float* u, const float* brT, const float* biT, const float* gbar,
                const float* consts, const float* trr, const float* tri, int n, int mg,
                int n_steps, int integrated, float dt, float* b0r_bar, float* b0i_bar,
                float* ubar, float* work, long long work_floats, void* stream) {
  BwdParams p{u, brT, biT, gbar, consts, trr, tri, n, mg, n_steps, dt,
              b0r_bar, b0i_bar, ubar, work};
  return launch_bwd<false>(p, integrated, work_floats, stream);
}

#else  // SMO_KDYN_ROWS

// The row launches: `rows` (1 .. kMaxRows) sweeps of one constant pack,
// each operand an (R, ...) array of the one-row launch's operands (J and
// gbar (R,)), and rows x sm_kdyn_work_floats(n, mg) floats of scratch.

int sm_kdyn_fwd_rows(const float* br0, const float* bi0, const float* u,
                     const float* consts, int n, int mg, int n_steps, int integrated,
                     float dt, int rows, float* brT, float* biT, float* J, float* work,
                     long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, nullptr, nullptr, work,
              rows};
  return launch_fwd<false, true>(p, integrated, work_floats, stream);
}

int sm_kdyn_fwd_traj_rows(const float* br0, const float* bi0, const float* u,
                          const float* consts, int n, int mg, int n_steps, int integrated,
                          float dt, int rows, float* brT, float* biT, float* J, float* trr,
                          float* tri, float* work, long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, trr, tri, work, rows};
  return launch_fwd<true, true>(p, integrated, work_floats, stream);
}

int sm_kdyn_bwd_rows(const float* u, const float* brT, const float* biT, const float* gbar,
                     const float* consts, const float* trr, const float* tri, int n, int mg,
                     int n_steps, int integrated, float dt, int rows, float* b0r_bar,
                     float* b0i_bar, float* ubar, float* work, long long work_floats,
                     void* stream) {
  BwdParams p{u, brT, biT, gbar, consts, trr, tri, n, mg, n_steps, dt,
              b0r_bar, b0i_bar, ubar, work, rows};
  return launch_bwd<true>(p, integrated, work_floats, stream);
}

#endif  // SMO_KDYN_ROWS

}  // extern "C"
