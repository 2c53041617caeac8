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
// The stages are bound by the SM's load/store pipe, which shared-memory
// reads (stage YZ) and the stage-X tasks' L2 traffic share: a stage-X
// task reads each group's shares of its two mode columns as 8-byte pieces
// of 32-byte sectors (the chunk-major layout that made those reads whole
// sectors scattered stage YZ's writes instead and lost more than it won).
// So the matrices sit in shared memory as (re, im) pairs with odd row
// strides (one load a complex entry, and no two of the rows a warp reads
// on one bank pair: stage X's matrix reads had 3- and 4-way conflicts),
// and dot products' last terms use fixed indices (a run-time index put a
// partial-sum array in local memory): 27.1 -> 23.1 ms a forward, 32.5 ->
// 29.1 ms a reverse (tools/time_kdyn_rows.py, H100 80GB HBM3 at 700 W).
//
// The forward with and without the trajectory, and with and without the
// integrated cost, are instantiations of one template.
//
// Rows (sm_kdyn_fwd_rows, sm_kdyn_fwd_traj_rows, sm_kdyn_bwd_rows: the
// same kernels under the JAX package's jax.vmap, where pallas_call's
// batching rule gives each a grid over a sweep's rows): R <= kMaxRows
// independent sweeps of one constant pack in one launch. A stage task
// steps a group of G rows at once (row_group: G = 2 for 2 and for 5 .. 8
// rows, 4 for 3 or 4; one row is the one-row kernel, the G = 1 instance
// of the same templates): the task loads the G rows' operands with their
// loads in flight together, reads each DFT-matrix entry and mode factor
// once for the G rows, and each thread carries G independent dot chains
// (4 G partial sums) where one row gave it one. Measured with one task a
// block (R = G, n = 24, the probe tool): a stage-YZ task takes 3.4, 5.6,
// 9.0 us forward and 4.6, 8.1, 14.8 reverse at G = 1, 2, 4 (~1.7 + 1.8 G
// and ~1.2 + 3.4 G), a stage-X task 3.1, 5.9, 12.1 and 3.5, 6.6, 15.7
// (~3 G and ~4 G): rows share the matrix reads but not the load/store
// pipe, and G = 8 (29.7 / 53.1 us a YZ task) spills registers at two
// blocks an SM. The row groups run in two halves half a step apart
// (HalfStage), so that one half's stage-YZ tasks share the stages with
// the other half's stage-X tasks; that gained 6-11 % at R = 8. Each row
// has its own operands (the (R, ...) arrays, one row's size apart), its
// own slab of `work` and shared buffers, and its own Kahan sum, in thread
// 32 r of the last block (warp r sums row r's partials); a partial last
// group repeats its last row and stores nothing of the repeats. A row's
// arithmetic is the same expressions in the same order whatever G is
// (cdot4's partial sums, add_shares' group order, the chunks' partials,
// block_sum_rows), and a row's stages keep their order, so each row's
// outputs are bitwise the one-row kernel's on that row.
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

// The launch parameters, and the row launches of each row-group size
// (kdyn_rows_g<G>.cu, a translation unit each), in a named namespace so
// that the translation units share them.
namespace smo_kdyn {

struct FwdParams {
  const float *br0, *bi0, *u, *consts;
  int n, mg, n_steps;
  float dt;
  float *brT, *biT, *J, *trr, *tri, *work;
  int rows = 1;  // R: the (R, ...) arrays of a row launch
#ifdef SMO_KDYN_PROBE
  unsigned long long* probe = nullptr;  // the probe build's stamps
#endif
};

struct BwdParams {
  const float *u, *brT, *biT, *gbar, *consts, *trr, *tri;
  int n, mg, n_steps;
  float dt;
  float *b0r_bar, *b0i_bar, *ubar, *work;
  int rows = 1;  // R: the (R, ...) arrays of a row launch
#ifdef SMO_KDYN_PROBE
  unsigned long long* probe = nullptr;  // the probe build's stamps
#endif
};

// A row launch of p.rows rows whose stage tasks step kG rows each.
template <int kG>
int fwd_rows(FwdParams& p, bool traj, int integrated, long long work_floats, void* stream);
template <int kG>
int bwd_rows(BwdParams& p, int integrated, long long work_floats, void* stream);

}  // namespace smo_kdyn

namespace {

using smo_kdyn::BwdParams;
using smo_kdyn::FwdParams;

// The partition of both sweeps (see the header). Stage YZ: task (a, grp)
// owns the x-grid slab a and the y-grid points b0 .. b0 + nb - 1,
// b0 = grp nb, of the S groups of a slab; stage X: task `chunk` owns the
// kColChunk (Y, z) mode columns from chunk kColChunk. S and nb follow from
// (n, mg) alone, so the sums' order does not depend on the card. A task
// steps kG rows of a row launch at once (kG = 1: the one-row kernels).
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
  int mats;  // floats of the eight DFT matrices in the constant pack
  // The matrices in shared memory: Ff (n, mg), Fz (kz, mg), Bf (mg, n),
  // Bz (mg, kz) as (re, im) pairs, each row `*s` pairs apart; the strides
  // are odd, so that the rows' entries that a warp reads at once (a column
  // over up to 16 rows) fall on distinct bank pairs.
  int ffs, fzs, bfs, bzs;
  int smats;  // floats of them
  __host__ __device__ Dims(int n_, int mg_) : n(n_), mg(mg_), kz(n_ / 2 + 1) {
    nkz = n * kz;
    s1 = n * nkz;
    s = 3 * s1;
    p1 = 3 * mg * nkz;
    mats = 4 * n * mg + 4 * kz * mg;
    ffs = mg | 1;
    fzs = mg | 1;
    bfs = n | 1;
    bzs = kz | 1;
    smats = 2 * (n * ffs + kz * fzs + mg * bfs + mg * bzs);
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
  // Stage YZ's shared floats for one row: the slab (kP (re, im) planes of
  // 3 nkz), with the pencils' real e (3 nb mg) over it once the y-stage
  // has read it, then the y-stage's outputs (kP planes of 3 nb kz pairs),
  // with the z-stage's output over the first once the pencils have read
  // them. Even, so that every row's pairs stay 8-byte aligned.
  __host__ __device__ int yz_slab_floats(int kP) const {
    const int slab = kP * 6 * nkz, e = 3 * nb * mg;
    return slab > e ? slab : (e + 1) & ~1;
  }
  __host__ __device__ int yz_floats(int kP) const {
    return yz_slab_floats(kP) + kP * 6 * nb * kz;
  }
  __host__ __device__ int fwd_yz_floats() const { return yz_floats(1); }
  __host__ __device__ int fwd_x_floats() const { return kColChunk * (6 * mg + 18 * n); }
  __host__ __device__ int bwd_yz_floats() const { return yz_floats(2); }
  __host__ __device__ int bwd_x_floats() const { return kColChunk * (6 * mg + 30 * n); }
  // g rows' buffers of the larger stage, after the matrices
  __host__ __device__ size_t smem_bytes(int yz, int x) const {
    return (size_t)(smats + (yz > x ? yz : x)) * sizeof(float);
  }
  __host__ __device__ size_t fwd_smem_bytes(int g) const {
    return smem_bytes(g * fwd_yz_floats(), g * fwd_x_floats());
  }
  __host__ __device__ size_t bwd_smem_bytes(int g) const {
    return smem_bytes(g * bwd_yz_floats(), g * bwd_x_floats());
  }
};

struct Mats {  // in shared memory: (re, im) pairs, rows Dims::*s pairs apart
  const float2 *Ff, *Fz, *Bf, *Bz;
};

// The matrices in `smem` (as load_mats leaves them) at the strides of d.
__device__ __forceinline__ Mats mats_at(const float* smem, const Dims& d) {
  Mats m;
  m.Ff = reinterpret_cast<const float2*>(smem);
  m.Fz = m.Ff + d.n * d.ffs;
  m.Bf = m.Fz + d.kz * d.fzs;
  m.Bz = m.Bf + d.mg * d.bfs;
  return m;
}

struct Factors {  // in global memory, constant for the whole launch
  const float *k, *inv_k2, *lhs_inv, *rhs_fac, *keep, *pw, *mean_mask;
};

// Stage the pack's matrices (Ffr, Ffi (n, mg), Fzr, Fzi (kz, mg), Bfr, Bfi
// (mg, n), Bzr, Bzi (mg, kz)) into shared memory as mats_at reads them.
template <int kT>
__device__ void load_mats(float* smem, const float* consts, const Dims& d) {
  const int rows[4] = {d.n, d.kz, d.mg, d.mg}, cols[4] = {d.mg, d.mg, d.n, d.kz};
  const int strides[4] = {d.ffs, d.fzs, d.bfs, d.bzs};
  float2* dst = reinterpret_cast<float2*>(smem);
  const float* src = consts;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int size = rows[w] * cols[w];
    for (int i = threadIdx.x; i < size; i += kT)
      dst[(i / cols[w]) * strides[w] + i % cols[w]] =
          make_float2(__ldg(src + i), __ldg(src + size + i));
    src += 2 * size;
    dst += rows[w] * strides[w];
  }
  __syncthreads();
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

// Rounding pinned (no instance may contract these differently, so a row's
// bits do not depend on the code around it): a x - b y and a x + b y as a
// fused multiply-add of a's product with b's rounded first; a complex
// multiply-add r + (a x - b y), i + (a y + b x) (or the conjugate's
// r + (a x + b y), i + (a y - b x)) adds each of those after. (Before the
// rounding was pinned, the compiler chose per call site which product to
// fuse, so these kernels' bits moved from the parent's by a few ulps.)
__device__ __forceinline__ float fms(float a, float x, float b, float y) {
  return __fmaf_rn(a, x, -__fmul_rn(b, y));
}
__device__ __forceinline__ float fpm(float a, float x, float b, float y) {
  return __fmaf_rn(a, x, __fmul_rn(b, y));
}
template <bool kConj>
__device__ __forceinline__ void cmac(float a, float b, float x, float y, float& r, float& i) {
  if constexpr (kConj) {
    r = __fadd_rn(r, fpm(a, x, b, y));
    i = __fadd_rn(i, fms(a, y, b, x));
  } else {
    r = __fadd_rn(r, fms(a, x, b, y));
    i = __fadd_rn(i, fpm(a, y, b, x));
  }
}

// sum_j M_j x_j (or conj(M_j) x_j) of `len` complex terms for kG
// operands at once, the matrix entries `js` pairs apart in shared memory
// and read once for all of them, operand g `rs` pairs after operand 0,
// its terms `stride` pairs apart. Each operand has four independent
// partial sums (terms j = 4 i + q go to sum q; the sums meet as
// (s0 + s1) + (s2 + s3)), so that a thread's loads and multiply-adds
// overlap instead of waiting on one chain: 4 kG chains a thread. Operand
// g's arithmetic is the same expressions whatever kG is, so its sum is
// the same bits.
template <bool kConj, int kG>
__device__ __forceinline__ void cdot4(const float2* m, int js, const float2* x, int rs,
                                      int stride, int len, float (&outr)[kG],
                                      float (&outi)[kG]) {
  float r[kG][4], im[kG][4];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int q = 0; q < 4; ++q) r[g][q] = im[g][q] = 0.f;
  }
  int j = 0;
#pragma unroll
  for (; j + 4 <= len; j += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 mv = m[(j + q) * js];
      const float a = mv.x, b = mv.y;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float2 xv = x[g * rs + (size_t)(j + q) * stride];
        cmac<kConj>(a, b, xv.x, xv.y, r[g][q], im[g][q]);
      }
    }
  }
  // the last len % 4 terms go to sums 0, 1, 2 (indices known at compile
  // time, so the sums stay in registers)
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (j + q < len) {
      const float2 mv = m[(j + q) * js];
      const float a = mv.x, b = mv.y;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float2 xv = x[g * rs + (size_t)(j + q) * stride];
        cmac<kConj>(a, b, xv.x, xv.y, r[g][q], im[g][q]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    outr[g] = (r[g][0] + r[g][1]) + (r[g][2] + r[g][3]);
    outi[g] = (im[g][0] + im[g][1]) + (im[g][2] + im[g][3]);
  }
}

// Probe builds (tools/probe_kdyn_tasks.py compiles with SMO_KDYN_PROBE,
// which gives the launch parameters a `probe` buffer): thread 0 of each
// block stamps clock64() at the start of each stage and at the end of
// each of its tasks, for kProbeSteps steps from kProbeFrom, into
// probe[4 + ((block kProbeSteps + step) 2 + stage) kProbeSlots + slot];
// block 0 stamps (clock64, globaltimer) at the start and the end of the
// launch into probe[0 .. 3], which give the SM clock. Elsewhere the
// probes are empty.
#ifdef SMO_KDYN_PROBE
constexpr int kProbeFrom = 4, kProbeSteps = 8, kProbeSlots = 8;
#endif
template <typename Params>
__device__ __forceinline__ void probe(const Params& p, int step, int stage, int slot) {
#ifdef SMO_KDYN_PROBE
  const int s = step - kProbeFrom;
  if (threadIdx.x == 0 && p.probe && s >= 0 && s < kProbeSteps && slot < kProbeSlots)
    p.probe[4 + ((blockIdx.x * kProbeSteps + s) * 2 + stage) * kProbeSlots + slot] = clock64();
#endif
}
template <typename Params>
__device__ __forceinline__ void probe_clock(const Params& p, int at) {
#ifdef SMO_KDYN_PROBE
  if (threadIdx.x == 0 && blockIdx.x == 0 && p.probe) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.probe[2 * at] = clock64();
    p.probe[2 * at + 1] = t;
  }
#endif
}

// Stage YZ's input: the slab a of kP (re, im) pairs of (3, mg, n, kz)
// arrays, dst[w][c nkz + col] = (src[2 w], src[2 w + 1])[(c mg + a) nkz + col],
// kL elements a thread in flight at once (2 kL kP loads).
template <int kP, int kL>
__device__ __forceinline__ void load_slab(const float* const (&src)[2 * kP],
                                          float2* const (&dst)[kP], int a, int mg, int nkz) {
  for (int i0 = threadIdx.x; i0 < 3 * nkz; i0 += kL * kPartThreads) {
    float v[kL][2 * kP];
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = i0 + q * kPartThreads;
      if (i < 3 * nkz) {
        const size_t at = ((size_t)(i / nkz) * mg + a) * nkz + i % nkz;
#pragma unroll
        for (int w = 0; w < 2 * kP; ++w) v[q][w] = src[w][at];
      }
    }
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = i0 + q * kPartThreads;
      if (i < 3 * nkz) {
#pragma unroll
        for (int w = 0; w < kP; ++w) dst[w][i] = make_float2(v[q][2 * w], v[q][2 * w + 1]);
      }
    }
  }
}

// Stage X's input for kG rows: the S groups' shares of a (3, mg, n, kz)
// (re, im) pair of arrays at the chunk's nc columns from col0, added in
// group order: dst[g xs + j 3 mg + c mg + a] =
// sum_s (shr, shi)[g][s][(c mg + a) nkz + col0 + j]. kSC groups' loads of
// every row are in flight at once.
template <int kG, int kSC>
__device__ __forceinline__ void add_shares(const PartDims& d, const float* const (&shr)[kG],
                                           const float* const (&shi)[kG], int col0, int nc,
                                           float2* dst, int xs) {
  for (int o = threadIdx.x; o < 3 * d.mg * nc; o += kPartThreads) {
    const int j = o % nc, ca = o / nc;  // ca = c mg + a
    const size_t src = (size_t)ca * d.nkz + col0 + j;
    float vr[kG], vi[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) vr[g] = vi[g] = 0.f;
    for (int s0 = 0; s0 < d.S; s0 += kSC) {
      float sr[kG][kSC], si[kG][kSC];
#pragma unroll
      for (int s = 0; s < kSC; ++s) {
        if (s0 + s < d.S) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            sr[g][s] = shr[g][(size_t)(s0 + s) * d.p1 + src];
            si[g][s] = shi[g][(size_t)(s0 + s) * d.p1 + src];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSC; ++s) {
        if (s0 + s < d.S) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            vr[g] += sr[g][s];
            vi[g] += si[g][s];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) dst[g * xs + j * 3 * d.mg + ca] = make_float2(vr[g], vi[g]);
  }
}

// Groups of add_shares' loads in flight at once for kG rows: all of them
// for one row, at most 24 / kG (48 loads a thread) for several.
template <int kG>
__host__ __device__ constexpr int shares_in_flight() {
  return kG == 1 ? kMaxGroups : 24 / kG;
}

// Elements a thread of load_slab keeps in flight for kG rows of kP
// planes: kLoads for one row, else as many as keep 16 loads in flight.
template <int kG, int kP>
__host__ __device__ constexpr int slab_in_flight() {
  return kG == 1 ? kLoads : (16 / (kG * kP) > 1 ? 16 / (kG * kP) : 1);
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


// smo::block_sum of kG partials at once (the same sums, one barrier for
// all), valid in thread 0 only; `red` holds kG kPartWarps floats.
template <int kG>
__device__ __forceinline__ void block_sum_rows(const float (&part)[kG], float* red,
                                               float (&total)[kG]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) w[g] = smo::warp_sum(part[g]);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) red[g * kPartWarps + warp] = w[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    total[g] = 0.f;
    if (warp == 0) total[g] = smo::warp_sum(lane < kPartWarps ? red[g * kPartWarps + lane] : 0.f);
  }
}

// The rows of a stage task: row group rg of a launch of R rows, kG rows a
// group, is rows r0 .. r0 + gn - 1; the last group may hold fewer than kG,
// and its missing rows repeat row r0 + gn - 1 (computed, never stored).
template <int kG>
struct RowGroup {
  int r0, gn;
  __device__ RowGroup(int rg, int R) : r0(rg * kG), gn(kG == 1 ? 1 : min(kG, R - rg * kG)) {}
  __device__ int row(int g) const { return r0 + (g < gn ? g : gn - 1); }
  __device__ bool stores(int g) const { return kG == 1 || g < gn; }
};

// A launch runs its row groups as two halves half a step apart (row
// groups 0 .. gh - 1 and gh .. groups - 1, gh = ceil(groups / 2); one
// group, as in the one-row kernel, leaves the second half empty): at
// stage k, half h runs its own stage k - h of X(-1), YZ(0), X(0), YZ(1),
// ..., X(N-1), so that a stage holds one half's stage-YZ tasks beside the
// other half's stage-X tasks and an SM can run them side by side (6-11 %
// at R = 8 on an H100: both kinds load the same load/store pipe); 2N + 2
// stages, one grid-wide barrier each (the one-row kernel's last is empty).
// A row keeps its stages, their order and its tasks, so its outputs are
// the same bits as in the one-half order.
struct HalfStage {
  int kind;  // 0: no task, 1: stage YZ, 2: stage X
  int step;  // of that stage (X(-1): -1)
  int rg0, ng;  // the half's row groups rg0 .. rg0 + ng - 1
};

__device__ __forceinline__ HalfStage half_stage(int k, int h, int n_steps, int groups) {
  const int gh = (groups + 1) / 2, l = k - h;
  HalfStage s{0, 0, h ? gh : 0, h ? groups - gh : gh};
  if (l >= 0 && l <= 2 * n_steps) {
    s.kind = (l & 1) ? 1 : 2;
    s.step = (l & 1) ? (l - 1) / 2 : l / 2 - 1;
  }
  return s;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdCtx {
  PartDims d;
  Factors F;
  const FwdParams* p;
  const float* smem;  // the matrices (load_mats), then the stages' buffers
  float* buf;         // shared memory after the matrices
  float* red;         // [kG][kPartWarps] of shared memory, for block_sum_rows
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

// Stage YZ of a forward step, task (a, grp) of row group rg (kG rows): the
// y-synthesis of the slab a of each row's g1 onto the task's y-grid
// points, the pencil work (z-synthesis -> B, e = u x B, z-analysis -> h3)
// and the task's share of the y-analysis, sum over its b of Ff(Y, b) h3.
// Every matrix entry is read once for the kG rows.
template <int kN, int kMG, int kG>
__device__ __forceinline__ void fwd_task_yz(const FwdCtx& x, int rg, int task) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;  // constants in the specialised instance
  const Mats M = mats_at(x.smem, d);
  const FwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, kz = d.kz, nkz = d.nkz, nb = d.nb;
  const int R = p.rows;
  const size_t grid1 = (size_t)mg * mg * mg;
  const int rs = d.fwd_yz_floats();     // row g's buffers are g rs floats on
  const int rs2 = rs / 2;               // in (re, im) pairs
  float2* sg1 = reinterpret_cast<float2*>(x.buf);  // [3][nkz]: the slab of g1
  float* es = x.buf;                     // [3][nb][mg]: e = u x B, over the slab
  float2* g2 = reinterpret_cast<float2*>(x.buf + d.yz_slab_floats(1));  // [3][nb][kz]
  float2* h3 = g2;                       // [3][nb][kz], over g2
  const int cs = nb * mg;                // es's component stride
  const RowGroup<kG> G(rg, R);
  // row g's operands, computed where they are used (an array of kG rows'
  // pointers would hold 2 kG registers for each)
  const auto r = [&](int g) { return fwd_row(p, d, G.row(g)); };
  const int a = task / d.S, grp = task % d.S;
  const int b0 = grp * nb, nbl = min(nb, mg - b0), npts = nbl * mg;
  // u at this thread's grid points (pt = bl mg + k), in flight during
  // the y stage
  float uu[kG][kPts][3];
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    const int pt = tid + q * kPartThreads;
    if (pt < npts) {
      const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int c = 0; c < 3; ++c) uu[g][q][c] = __ldg(r(g).u + c * grid1 + gi);
      }
    }
  }
  {
    const float* src[2 * kG];
    float2* dst[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      src[2 * g] = r(g).g1r;
      src[2 * g + 1] = r(g).g1i;
      dst[g] = sg1 + g * rs2;
    }
    load_slab<kG, slab_in_flight<kG, 2>()>(src, dst, a, mg, nkz);
  }
  __syncthreads();
  for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
    const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz, b = b0 + bl;
    const int at = (c * nb + bl) * kz + z;
    float vr[kG], vi[kG];
    cdot4<false, kG>(M.Bf + b * d.bfs, 1, sg1 + c * nkz + z, rs2, kz, n, vr, vi);
#pragma unroll
    for (int g = 0; g < kG; ++g) g2[g * rs2 + at] = make_float2(vr[g], vi[g]);
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
      float v[kG][3];
#pragma unroll
      for (int g = 0; g < kG; ++g) v[g][0] = v[g][1] = v[g][2] = 0.f;
#pragma unroll
      for (int z = 0; z < kz; ++z) {
        const float2 bz = M.Bz[k * d.bzs + z];
        const float br = bz.x, bi = bz.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float2 gv = g2[g * rs2 + (c * nb + bl) * kz + z];
            v[g][c] = __fadd_rn(v[g][c], fms(br, gv.x, bi, gv.y));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float u0 = uu[g][q][0], u1 = uu[g][q][1], u2 = uu[g][q][2];
        float* e = es + g * rs;
        e[pt] = fms(u1, v[g][2], u2, v[g][1]);
        e[cs + pt] = fms(u2, v[g][0], u0, v[g][2]);
        e[2 * cs + pt] = fms(u0, v[g][1], u1, v[g][0]);
      }
    }
  }
  __syncthreads();
  // z-analysis: h3 = sum over k of Fz(z, k) e(k)
  for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
    const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz;
    const float* e = es + c * cs + bl * mg;
    const float2* fz = M.Fz + z * d.fzs;
    float ar[kG][4], ai[kG][4];  // k mod 4
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ar[g][q] = ai[g][q] = 0.f;
    }
    int k = 0;
#pragma unroll
    for (; k + 4 <= mg; k += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = fz[k + q];
        const float f_r = f.x, f_i = f.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float ev = e[g * rs + k + q];
          ar[g][q] = __fmaf_rn(f_r, ev, ar[g][q]);
          ai[g][q] = __fmaf_rn(f_i, ev, ai[g][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {  // the last mg % 4 terms
      if (k + q < mg) {
        const float2 f = fz[k + q];
        const float f_r = f.x, f_i = f.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float ev = e[g * rs + k + q];
          ar[g][q] = __fmaf_rn(f_r, ev, ar[g][q]);
          ai[g][q] = __fmaf_rn(f_i, ev, ai[g][q]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      h3[g * rs2 + (c * nb + bl) * kz + z] =
          make_float2((ar[g][0] + ar[g][1]) + (ar[g][2] + ar[g][3]),
                      (ai[g][0] + ai[g][1]) + (ai[g][2] + ai[g][3]));
  }
  __syncthreads();
  for (int o = tid; o < 3 * nkz; o += kPartThreads) {
    const int c = o / nkz, col = o % nkz, Y = col / kz, z = col % kz;
    float vr[kG], vi[kG];
    cdot4<false, kG>(M.Ff + Y * d.ffs + b0, 1, h3 + c * nb * kz + z, rs2, kz, nbl, vr, vi);
    const size_t at = (size_t)grp * d.p1 + ((size_t)c * mg + a) * nkz + col;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (G.stores(g)) {
        r(g).h4r[at] = vr[g];
        r(g).h4i[at] = vi[g];
      }
    }
  }
  __syncthreads();  // the buffers are free for the next task
}

// At stage X of forward step `step`, warp r of the last block adds row r's
// E(b_step) (the chunks' partials of step - 1) to its Kahan sum, for the
// rows lo .. hi - 1 (with kIntegrated, from step 0 on; the chunks write
// E(b_{step+1}) to the other half of epart meanwhile).
template <bool kIntegrated>
__device__ __forceinline__ void fwd_x_kahan(const FwdCtx& x, int step, int lo, int hi,
                                            float& acc, float& comp) {
  const FwdParams& p = *x.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool first = step < 0;
  const PartDims& d = x.d;
  if (kIntegrated && !first && blockIdx.x == gridDim.x - 1 && warp >= lo && warp < hi) {
    const float e = sum_partials(fwd_row(p, d, warp).epart + (step & 1) * d.chunks,
                                 d.chunks, lane);
    if (lane == 0) smo::kahan_add(acc, comp, e);  // row `warp`'s E(b_step)
  }
}

// Stage X of forward step `step` (step = -1: the start of the sweep, from
// b_0), task `chunk` of row group rg (kG rows): for the task's mode
// columns, h4 (the groups' shares added in group order), the x-analysis,
// the mode-space tail -> b_{step+1} (to the state, the trajectory row
// step + 1, or b_T on the last step) and its energy partial, then the
// x-synthesis of b_{step+1} -> g1; the mode factors and matrix entries
// read once for the kG rows.
template <bool kTraj, bool kIntegrated, int kN, int kMG, int kG>
__device__ __forceinline__ void fwd_task_x(const FwdCtx& x, int rg, int chunk, int step) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
  const Mats M = mats_at(x.smem, d);
  const FwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, nkz = d.nkz, s1 = d.s1;
  const int R = p.rows;
  const int tm = 3 * n;  // modes (c, X) of one column
  const bool first = step < 0, last = step == p.n_steps - 1;
  const bool energy = kIntegrated || last;
  constexpr int CT = kColChunk;
  const int xs = d.fwd_x_floats() / 2;  // row g's buffers are g xs pairs on
  float2* h4s = reinterpret_cast<float2*>(x.buf);  // [CT][3 mg]
  float2* bs = h4s + CT * 3 * mg;  // [CT][3 n], as are the rest: b_step
  float2* es = bs + CT * tm;       // the x-analysed e
  float2* bn = es + CT * tm;       // b_{step+1}
  const RowGroup<kG> G(rg, R);
  const auto r = [&](int g) { return fwd_row(p, d, G.row(g)); };
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
#pragma unroll
    for (int g = 0; g < kG; ++g)
      bs[g * xs + sl] = make_float2((first ? r(g).br0 : r(g).sr)[idx],
                                    (first ? r(g).bi0 : r(g).si)[idx]);
  }
  if (!first) {
    const float* shr[kG];
    const float* shi[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      shr[g] = r(g).h4r;
      shi[g] = r(g).h4i;
    }
    add_shares<kG, shares_in_flight<kG>()>(d, shr, shi, col0, nc, h4s, xs);
  }
  __syncthreads();
  if (!first) {
    for (int o = tid; o < tm * nc; o += kPartThreads) {
      const int j = o / tm, cx = o % tm, c = cx / n, X = cx % n;
      float vr[kG], vi[kG];
      cdot4<false, kG>(M.Ff + X * d.ffs, 1, h4s + j * 3 * mg + c * mg, xs, 1, mg, vr, vi);
#pragma unroll
      for (int g = 0; g < kG; ++g) es[g * xs + j * tm + cx] = make_float2(vr[g], vi[g]);
    }
    __syncthreads();
  }
  float part[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) part[g] = 0.f;
  if (tailer) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int hs = g * xs + hj * tm + hX;  // (c = 0, X) of the thread's column
      float b_r[3], b_i[3], nr[3], ni[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 b = bs[hs + c * n];
        b_r[c] = b.x;
        b_i[c] = b.y;
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
          const float2 e = es[hs + c * n];
          e_r[c] = e.x;
          e_i[c] = e.y;
        }
        step_tail(hf, b_r, b_i, e_r, e_i, nr, ni);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int idx = c * s1 + hm;
        bn[hs + c * n] = make_float2(nr[c], ni[c]);
        if (!G.stores(g)) continue;
        if (last) {
          r(g).brT[idx] = nr[c];
          r(g).biT[idx] = ni[c];
        } else {
          r(g).sr[idx] = nr[c];
          r(g).si[idx] = ni[c];
          if constexpr (kTraj) {
            r(g).trr[(size_t)(step + 1) * d.s + idx] = nr[c];
            r(g).tri[(size_t)(step + 1) * d.s + idx] = ni[c];
          }
        }
      }
      if (energy) part[g] = mode_energy(hpw, nr, ni);
    }
  }
  if (energy) {
    // its __syncthreads also publishes b_{step+1}; the one at the end of
    // the task frees `red`
    float total[kG];
    block_sum_rows<kG>(part, x.red, total);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (G.stores(g)) r(g).epart[((step + 1) & 1) * d.chunks + chunk] = total[g];
      }
    }
  } else {
    __syncthreads();
  }
  if (!last) {
    for (int o = tid; o < 3 * mg * nc; o += kPartThreads) {
      const int j = o % nc, ca = o / nc, c = ca / mg, a = ca % mg;
      float gr[kG], gi[kG];
      cdot4<false, kG>(M.Bf + a * d.bfs, 1, bn + j * tm + c * n, xs, 1, n, gr, gi);
      const size_t at = (size_t)ca * nkz + col0 + j;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (G.stores(g)) {
          r(g).g1r[at] = gr[g];
          r(g).g1i[at] = gi[g];
        }
      }
    }
  }
  __syncthreads();  // the buffers are free for the next task
}

// Stage k of the forward (HalfStage): each half's tasks of its own stage,
// and the Kahan terms of the half that runs stage X.
template <bool kTraj, bool kIntegrated, int kN, int kMG, int kG>
__device__ __forceinline__ void fwd_stage(const FwdCtx& x, int k, float& acc, float& comp) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
  const FwdParams& p = *x.p;
  const int R = p.rows, groups = (R + kG - 1) / kG;
  const HalfStage h0 = half_stage(k, 0, p.n_steps, groups);
  const HalfStage h1 = half_stage(k, 1, p.n_steps, groups);
  const int c0 = h0.kind ? h0.ng * (h0.kind == 1 ? d.tasks : d.chunks) : 0;
  const int c1 = h1.kind ? h1.ng * (h1.kind == 1 ? d.tasks : d.chunks) : 0;
  if (h0.kind == 2) fwd_x_kahan<kIntegrated>(x, h0.step, 0, min(R, h1.rg0 * kG), acc, comp);
  if (h1.kind == 2) fwd_x_kahan<kIntegrated>(x, h1.step, h1.rg0 * kG, R, acc, comp);
  // the probe's (step, stage YZ 0 / X 1): half 0's, or half 1's at the end
  const HalfStage hp = h0.kind ? h0 : h1;
  const int pstep = hp.step, pstage = hp.kind == 1 ? 0 : 1;
  int slot = 0;
  probe(p, pstep, pstage, slot++);
  for (int t = blockIdx.x; t < c0 + c1; t += gridDim.x) {
    const bool second = t >= c0;
    const HalfStage h = second ? h1 : h0;
    const int i = second ? t - c0 : t;
    if (h.kind == 1) {
      fwd_task_yz<kN, kMG, kG>(x, h.rg0 + i / d.tasks, i % d.tasks);
    } else {
      fwd_task_x<kTraj, kIntegrated, kN, kMG, kG>(x, h.rg0 + i / d.chunks, i % d.chunks, h.step);
    }
    probe(p, pstep, pstage, slot++);
  }
}

// Forward: N steps from (br0, bi0) of each row. J = E(b_T), or with
// kIntegrated dt * Kahan sum of E(b_0) .. E(b_{N-1}), then E(b_T). With
// kTraj row i of (trr, tri) is the state before step i. Two grid-wide
// barriers a step: after stage YZ and after stage X. (kN, kMG) as in
// kdyn_bwd_kernel; kG = 1: one row, else p.rows rows, kG rows a stage task,
// the row groups in two halves half a step apart (HalfStage).
template <bool kTraj, bool kIntegrated, int kN, int kMG, int kG>
__global__ void __launch_bounds__(kPartThreads, kPartBlocksPerSm)
kdyn_fwd_kernel(const FwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red[kG * kPartWarps];
  probe_clock(p, 0);
  FwdCtx x{PartDims(p.n, p.mg)};
  load_mats<kPartThreads>(smem, p.consts, x.d);
  x.F = factors(p.consts, x.d);
  x.p = &p;
  x.smem = smem;
  x.buf = smem + x.d.smats;
  x.red = red;

  float acc = 0.f, comp = 0.f;  // row r's live in thread 32 r of the last block
  for (int k = 0; k <= 2 * p.n_steps + 1; ++k) {
    fwd_stage<kTraj, kIntegrated, kN, kMG, kG>(x, k, acc, comp);
    grid.sync();
  }
  const int R = p.rows, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
  probe_clock(p, 1);
}

// ---------------------------------------------------------------------------
// reverse
// ---------------------------------------------------------------------------

struct BwdCtx {
  PartDims d;
  Factors F;
  const BwdParams* p;
  const float* smem;  // the matrices (load_mats), then the stages' buffers
  float* buf;         // shared memory after the matrices
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

// Stage YZ of a reverse step, task (a, grp) of row group rg (kG rows): the
// y-analysis^T of q1 and the y-synthesis of g1 onto the task's y-grid
// points, the pencil work (z-analysis^T -> e_bar, z-synthesis of the
// stored state -> B_n, u_bar += B_n x e_bar, z-synthesis^T of e_bar x u
// -> r3) and the task's share of the y-synthesis^T, sum over its b of
// conj(Bf(b, Y)) r3. Every matrix entry is read once for the kG rows.
template <int kN, int kMG, int kG>
__device__ __forceinline__ void bwd_task_yz(const BwdCtx& x, int rg, int task) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;  // constants in the specialised instance
  const Mats M = mats_at(x.smem, d);
  const BwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, kz = d.kz, nkz = d.nkz, nb = d.nb;
  const int R = p.rows;
  const size_t grid1 = (size_t)mg * mg * mg;
  const int rs = d.bwd_yz_floats();      // row g's buffers are g rs floats on
  const int rs2 = rs / 2;                // in (re, im) pairs
  float2* sq1 = reinterpret_cast<float2*>(x.buf);  // [3][nkz]: the slab of q1
  float2* sg1 = sq1 + 3 * nkz;                     // and of g1
  float* eb = x.buf;                     // [3][nb][mg]: e_bar x u, over the slab
  float2* q2 = reinterpret_cast<float2*>(x.buf + d.yz_slab_floats(2));  // [3][nb][kz]
  float2* g2 = q2 + 3 * nb * kz;
  float2* r3 = q2;                       // [3][nb][kz], over q2
  const int cs = nb * mg;                // eb's component stride
  const RowGroup<kG> G(rg, R);
  // row g's operands, computed where they are used
  const auto r = [&](int g) { return bwd_row(p, d, G.row(g)); };
  const int a = task / d.S, grp = task % d.S;
  const int b0 = grp * nb, nbl = min(nb, mg - b0), npts = nbl * mg;
  // this thread's grid points (pt = bl mg + k): u and u_bar in flight
  // during the y stage
  float uu[kG][kPts][3], ub[kG][kPts][3];
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    const int pt = tid + q * kPartThreads;
    if (pt < npts) {
      const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          uu[g][q][c] = __ldg(r(g).u + c * grid1 + gi);
          ub[g][q][c] = r(g).ubar[c * grid1 + gi];
        }
      }
    }
  }
  {
    const float* src[4 * kG];
    float2* dst[2 * kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      src[4 * g] = r(g).q1r;
      src[4 * g + 1] = r(g).q1i;
      src[4 * g + 2] = r(g).g1r;
      src[4 * g + 3] = r(g).g1i;
      dst[2 * g] = sq1 + g * rs2;
      dst[2 * g + 1] = sg1 + g * rs2;
    }
    load_slab<2 * kG, slab_in_flight<kG, 4>()>(src, dst, a, mg, nkz);
  }
  __syncthreads();
  for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
    const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz, b = b0 + bl;
    const int at = (c * nb + bl) * kz + z;
    float vr[kG], vi[kG];
    cdot4<true, kG>(M.Ff + b, d.ffs, sq1 + c * nkz + z, rs2, kz, n, vr, vi);
#pragma unroll
    for (int g = 0; g < kG; ++g) q2[g * rs2 + at] = make_float2(vr[g], vi[g]);
    cdot4<false, kG>(M.Bf + b * d.bfs, 1, sg1 + c * nkz + z, rs2, kz, n, vr, vi);
#pragma unroll
    for (int g = 0; g < kG; ++g) g2[g * rs2 + at] = make_float2(vr[g], vi[g]);
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
      float e[kG][3], v[kG][3];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int c = 0; c < 3; ++c) e[g][c] = v[g][c] = 0.f;
      }
#pragma unroll
      for (int z = 0; z < kz; ++z) {
        const float2 fz = M.Fz[z * d.fzs + k], bz = M.Bz[k * d.bzs + z];
        const float fr = fz.x, fi = fz.y, br = bz.x, bi = bz.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int at = g * rs2 + (c * nb + bl) * kz + z;
            const float2 qv = q2[at], gv = g2[at];
            e[g][c] = __fadd_rn(e[g][c], fpm(fr, qv.x, fi, qv.y));
            v[g][c] = __fadd_rn(v[g][c], fms(br, gv.x, bi, gv.y));
          }
        }
      }
      const size_t gi = ((size_t)a * mg + b0) * mg + pt;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float u0 = uu[g][q][0], u1 = uu[g][q][1], u2 = uu[g][q][2];
        if (G.stores(g)) {
          float* ubar = r(g).ubar;
          ubar[gi] = __fadd_rn(ub[g][q][0], fms(v[g][1], e[g][2], v[g][2], e[g][1]));
          ubar[grid1 + gi] = __fadd_rn(ub[g][q][1], fms(v[g][2], e[g][0], v[g][0], e[g][2]));
          ubar[2 * grid1 + gi] = __fadd_rn(ub[g][q][2], fms(v[g][0], e[g][1], v[g][1], e[g][0]));
        }
        float* w = eb + g * rs;
        w[pt] = fms(e[g][1], u2, e[g][2], u1);
        w[cs + pt] = fms(e[g][2], u0, e[g][0], u2);
        w[2 * cs + pt] = fms(e[g][0], u1, e[g][1], u0);
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < 3 * nbl * kz; o += kPartThreads) {
    const int c = o / (nbl * kz), bl = (o / kz) % nbl, z = o % kz;
    const float* gs = eb + c * cs + bl * mg;
    float ar[kG][4], ai[kG][4];  // k mod 4
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ar[g][q] = ai[g][q] = 0.f;
    }
    int k = 0;
#pragma unroll
    for (; k + 4 <= mg; k += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bz = M.Bz[(k + q) * d.bzs + z];
        const float zr = bz.x, zi = bz.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float gv = gs[g * rs + k + q];
          ar[g][q] = __fmaf_rn(zr, gv, ar[g][q]);
          ai[g][q] = __fmaf_rn(-zi, gv, ai[g][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {  // the last mg % 4 terms
      if (k + q < mg) {
        const float2 bz = M.Bz[(k + q) * d.bzs + z];
        const float zr = bz.x, zi = bz.y;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float gv = gs[g * rs + k + q];
          ar[g][q] = __fmaf_rn(zr, gv, ar[g][q]);
          ai[g][q] = __fmaf_rn(-zi, gv, ai[g][q]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g)
      r3[g * rs2 + (c * nb + bl) * kz + z] =
          make_float2((ar[g][0] + ar[g][1]) + (ar[g][2] + ar[g][3]),
                      (ai[g][0] + ai[g][1]) + (ai[g][2] + ai[g][3]));
  }
  __syncthreads();
  for (int o = tid; o < 3 * nkz; o += kPartThreads) {
    const int c = o / nkz, col = o % nkz, Y = col / kz, z = col % kz;
    float vr[kG], vi[kG];
    cdot4<true, kG>(M.Bf + b0 * d.bfs + Y, d.bfs, r3 + c * nb * kz + z, rs2, kz, nbl, vr,
                    vi);
    const size_t at = (size_t)grp * d.p1 + ((size_t)c * mg + a) * nkz + col;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (G.stores(g)) {
        r(g).r4r[at] = vr[g];
        r(g).r4i[at] = vi[g];
      }
    }
  }
  __syncthreads();  // the buffers are free for the next task
}

// Stage X at the end of reverse step kk (kk = -1: the start of the sweep,
// from lambda_T), task `chunk` of row group rg (kG rows): for the task's
// mode columns, r4 (the groups' shares added in group order), the
// x-synthesis^T plus the direct term (and the integrated cost's term) ->
// lambda_n; on the last step b0_bar = lambda_0, else the head of the next
// transposed step (d to memory, p0), the x-analysis^T of p0 -> q1 and the
// x-synthesis of the next stored state -> g1; the mode factors and matrix
// entries read once for the kG rows. The cost's weights w_T = 2 gbar
// (2 dt gbar with kIntegrated) and w_I = 2 dt gbar are the row's.
template <bool kIntegrated, int kN, int kMG, int kG>
__device__ __forceinline__ void bwd_task_x(const BwdCtx& x, int rg, int chunk, int kk) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
  const Mats M = mats_at(x.smem, d);
  const Factors& F = x.F;
  const BwdParams& p = *x.p;
  const int tid = threadIdx.x, mg = d.mg, n = d.n, nkz = d.nkz, s1 = d.s1;
  const int tm = 3 * n;  // modes (c, X) of one column
  const bool first = kk < 0, last = kk == p.n_steps - 1;
  const long long state = (long long)(p.n_steps - 1 - kk) * d.s;  // b_{N-1-kk}
  const long long next = state - d.s;                              // b_{N-2-kk}
  constexpr int CT = kColChunk;
  const int xs = d.bwd_x_floats() / 2;  // row g's buffers are g xs pairs on
  float2* r4s = reinterpret_cast<float2*>(x.buf);  // [CT][3 mg]
  float2* lam = r4s + CT * 3 * mg;  // [CT][3 n], as are the rest
  float2* p0 = lam + CT * tm;
  float2* ds = p0 + CT * tm;
  float2* bi = ds + CT * tm;
  float2* bn = bi + CT * tm;
  const int R = p.rows;
  const RowGroup<kG> G(rg, R);
  const auto r = [&](int g) { return bwd_row(p, d, G.row(g)); };
  float wT[kG], wI[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float gb = __ldg(r(g).gbar);
    wT[g] = (kIntegrated ? 2.f * p.dt : 2.f) * gb;
    wI[g] = 2.f * p.dt * gb;
  }
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
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int gs = g * xs + sl;
      if (first) {
        const float w = wT[g] * __ldg(F.pw + m);
        lam[gs] = make_float2(w * r(g).brT[idx], w * r(g).biT[idx]);
      } else {
        ds[gs] = make_float2(r(g).dr[idx], r(g).di[idx]);
        if constexpr (kIntegrated) {  // the integrated cost's term, w b_n
          const float w = wI[g] * __ldg(F.pw + m);
          bi[gs] = make_float2(w * r(g).trr[state + idx], w * r(g).tri[state + idx]);
        }
      }
      if (!last) bn[gs] = make_float2(r(g).trr[next + idx], r(g).tri[next + idx]);
    }
  }
  if (!first) {
    const float* shr[kG];
    const float* shi[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      shr[g] = r(g).r4r;
      shi[g] = r(g).r4i;
    }
    add_shares<kG, shares_in_flight<kG>()>(d, shr, shi, col0, nc, r4s, xs);
  }
  __syncthreads();
  if (!first) {
    for (int o = tid; o < tm * nc; o += kPartThreads) {
      const int j = o / tm, cx = o % tm, c = cx / n, X = cx % n;
      const int m = X * nkz + col0 + j, sl = j * tm + cx;
      float lr[kG], li[kG];
      cdot4<true, kG>(M.Bf + X, d.bfs, r4s + j * 3 * mg + c * mg, xs, 1, mg, lr, li);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int gs = g * xs + sl;
        const float2 dv = ds[gs];
        lr[g] += dv.x;
        li[g] += dv.y;
        if constexpr (kIntegrated) {
          const float2 bv = bi[gs];
          lr[g] += bv.x;
          li[g] += bv.y;
        }
        if (last) {
          if (G.stores(g)) {
            r(g).b0r_bar[c * s1 + m] = lr[g];
            r(g).b0i_bar[c * s1 + m] = li[g];
          }
        } else {
          lam[gs] = make_float2(lr[g], li[g]);
        }
      }
    }
    __syncthreads();
  }
  if (!last) {
    if (header) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int hs = g * xs + hj * tm + hX;  // (c = 0, X) of the thread's column
        float lr[3], li[3], hdr[3], hdi[3], hpr[3], hpi[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 l = lam[hs + c * n];
          lr[c] = l.x;
          li[c] = l.y;
        }
        adjoint_head(hf, lr, li, hdr, hdi, hpr, hpi);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (G.stores(g)) {
            r(g).dr[c * s1 + hm] = hdr[c];
            r(g).di[c * s1 + hm] = hdi[c];
          }
          p0[hs + c * n] = make_float2(hpr[c], hpi[c]);
        }
      }
    }
    __syncthreads();
    for (int o = tid; o < 3 * mg * nc; o += kPartThreads) {
      const int j = o % nc, ca = o / nc, c = ca / mg, a = ca % mg;
      const int base = j * tm + c * n;
      float qr[kG], qi[kG], gr[kG], gi[kG];
      cdot4<true, kG>(M.Ff + a, d.ffs, p0 + base, xs, 1, n, qr, qi);
      cdot4<false, kG>(M.Bf + a * d.bfs, 1, bn + base, xs, 1, n, gr, gi);
      const size_t at = (size_t)ca * nkz + col0 + j;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (G.stores(g)) {
          r(g).q1r[at] = qr[g];
          r(g).q1i[at] = qi[g];
          r(g).g1r[at] = gr[g];
          r(g).g1i[at] = gi[g];
        }
      }
    }
  }
  __syncthreads();  // the buffers are free for the next task
}

// Stage k of the reverse sweep (HalfStage): each half's tasks of its own
// stage.
template <bool kIntegrated, int kN, int kMG, int kG>
__device__ __forceinline__ void bwd_stage(const BwdCtx& x, int k) {
  const PartDims d = kN ? PartDims(kN, kMG) : x.d;
  const BwdParams& p = *x.p;
  const int groups = (p.rows + kG - 1) / kG;
  const HalfStage h0 = half_stage(k, 0, p.n_steps, groups);
  const HalfStage h1 = half_stage(k, 1, p.n_steps, groups);
  const int c0 = h0.kind ? h0.ng * (h0.kind == 1 ? d.tasks : d.chunks) : 0;
  const int c1 = h1.kind ? h1.ng * (h1.kind == 1 ? d.tasks : d.chunks) : 0;
  // the probe's (step, stage YZ 0 / X 1): half 0's, or half 1's at the end
  const HalfStage hp = h0.kind ? h0 : h1;
  const int pstep = hp.step, pstage = hp.kind == 1 ? 0 : 1;
  int slot = 0;
  probe(p, pstep, pstage, slot++);
  for (int t = blockIdx.x; t < c0 + c1; t += gridDim.x) {
    const bool second = t >= c0;
    const HalfStage h = second ? h1 : h0;
    const int i = second ? t - c0 : t;
    if (h.kind == 1) {
      bwd_task_yz<kN, kMG, kG>(x, h.rg0 + i / d.tasks, i % d.tasks);
    } else {
      bwd_task_x<kIntegrated, kN, kMG, kG>(x, h.rg0 + i / d.chunks, i % d.chunks, h.step);
    }
    probe(p, pstep, pstage, slot++);
  }
}

// Reverse sweep: lambda_T = w_T gbar pw b_T (w_T = 2, or 2 dt with
// kIntegrated); for n = N-1 .. 0: lambda_n = S^T lambda_{n+1}
// (+ 2 dt gbar pw b_n with kIntegrated), u_bar += to_grid(b_n) x e_bar_n.
// Two grid-wide barriers a step: after stage YZ and after stage X.
// (kN, kMG) = (0, 0) takes the shape from p; otherwise it must be (n, mg),
// and the shape is a compile-time constant (strides and trip counts fold,
// which cuts the stages' integer work about in half at n = 24). kG = 1:
// one row, else p.rows rows, each with its own gbar, kG rows a
// stage task, the row groups in two halves half a step apart (HalfStage).
template <bool kIntegrated, int kN, int kMG, int kG>
__global__ void __launch_bounds__(kPartThreads, kPartBlocksPerSm)
kdyn_bwd_kernel(const BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  probe_clock(p, 0);
  BwdCtx x{PartDims(p.n, p.mg)};
  load_mats<kPartThreads>(smem, p.consts, x.d);
  x.F = factors(p.consts, x.d);
  x.p = &p;
  x.smem = smem;
  x.buf = smem + x.d.smats;

  for (int k = 0; k <= 2 * p.n_steps + 1; ++k) {
    bwd_stage<kIntegrated, kN, kMG, kG>(x, k);
    if (k < 2 * p.n_steps + 1) grid.sync();
  }
  probe_clock(p, 1);
}

// Cooperative launch of a sweep with every block co-resident: at most
// kPartBlocksPerSm blocks of kPartThreads on each SM, fewer if the
// kernel's resources allow fewer, and at most one per task of the larger
// stage over all row groups (g rows a task).
// `row_work` is the scratch one row reads. Shapes past the partition's
// limits (the pencil points of a task, the groups of a slab, the modes of
// a stage-X task) and row counts outside 1 .. kMaxRows give
// cudaErrorInvalidValue.
template <typename Params>
int launch(void (*kernel)(const Params), Params& params, size_t smem, int g,
           long long row_work, long long work_floats, void* stream) {
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
  const int max_blocks = (params.rows + g - 1) / g * (d.tasks > d.chunks ? d.tasks : d.chunks);
  if (blocks > max_blocks) blocks = max_blocks;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kPartThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The KDyn configuration's shape (24^3 modes on the 36^3 grid) has its own
// instance of each sweep.
bool main_shape(int n, int mg) { return n == 24 && mg == 36; }

template <bool kTraj, int kG>
int launch_fwd(FwdParams& p, int integrated, long long work_floats, void* stream) {
  const PartDims d(p.n, p.mg);
  const bool main = main_shape(p.n, p.mg);
  const auto kernel = integrated ? (main ? kdyn_fwd_kernel<kTraj, true, 24, 36, kG>
                                         : kdyn_fwd_kernel<kTraj, true, 0, 0, kG>)
                                 : (main ? kdyn_fwd_kernel<kTraj, false, 24, 36, kG>
                                         : kdyn_fwd_kernel<kTraj, false, 0, 0, kG>);
  return launch(kernel, p, d.fwd_smem_bytes(kG), kG, d.fwd_work_floats(),
                work_floats, stream);
}

template <int kG>
int launch_bwd(BwdParams& p, int integrated, long long work_floats, void* stream) {
  const PartDims d(p.n, p.mg);
  const bool main = main_shape(p.n, p.mg);
  const auto kernel = integrated ? (main ? kdyn_bwd_kernel<true, 24, 36, kG>
                                         : kdyn_bwd_kernel<true, 0, 0, kG>)
                                 : (main ? kdyn_bwd_kernel<false, 24, 36, kG>
                                         : kdyn_bwd_kernel<false, 0, 0, kG>);
  return launch(kernel, p, d.bwd_smem_bytes(kG), kG, d.bwd_work_floats(),
                work_floats, stream);
}

}  // namespace

// The row launches of group size SMO_KDYN_ROWS_G: csrc/kdyn_rows_g<G>.cu
// compiles this file with it defined, so that the instances of each group
// size build in an nvcc process of their own, beside the one-row ones and
// each other (one file with the one-row and the row instances took twice
// as long to compile as either half, and the longest source sets the
// build's time).
#ifdef SMO_KDYN_ROWS_G
namespace smo_kdyn {

template <>
int fwd_rows<SMO_KDYN_ROWS_G>(FwdParams& p, bool traj, int integrated, long long work_floats,
                              void* stream) {
  constexpr int G = SMO_KDYN_ROWS_G;
  return traj ? launch_fwd<true, G>(p, integrated, work_floats, stream)
              : launch_fwd<false, G>(p, integrated, work_floats, stream);
}

template <>
int bwd_rows<SMO_KDYN_ROWS_G>(BwdParams& p, int integrated, long long work_floats,
                              void* stream) {
  constexpr int G = SMO_KDYN_ROWS_G;
  return launch_bwd<G>(p, integrated, work_floats, stream);
}

}  // namespace smo_kdyn
#else  // the one-row launches, and the row launches' choice of group size

namespace smo_kdyn {
template <>
int fwd_rows<2>(FwdParams&, bool, int, long long, void*);
template <>
int fwd_rows<4>(FwdParams&, bool, int, long long, void*);
template <>
int bwd_rows<2>(BwdParams&, int, long long, void*);
template <>
int bwd_rows<4>(BwdParams&, int, long long, void*);
}  // namespace smo_kdyn

namespace {

#ifdef SMO_KDYN_PROBE
int g_force_group = 0;                  // the group size of every row launch of R > 1
unsigned long long* g_stamps = nullptr;  // the launches' probe buffer
#define SMO_KDYN_STAMPS(params) (params).probe = g_stamps
#else
#define SMO_KDYN_STAMPS(params)
#endif

// Rows a stage task of a row launch of R rows steps: R itself up to 2,
// 4 for 3 or 4 rows, 2 above (tools/probe_kdyn_tasks.py on an H100: a
// 4-row task costs ~2.6 one-row tasks, and 5 .. 8 rows in 2-row groups
// beat 4-row groups).
int row_group(int rows) {
#ifdef SMO_KDYN_PROBE
  if (g_force_group && rows > 1) return g_force_group;
#endif
  return rows <= 2 ? rows : rows <= 4 ? 4 : 2;
}

int fwd_rows(FwdParams& p, bool traj, int integrated, long long work_floats, void* stream) {
  SMO_KDYN_STAMPS(p);
  if (p.rows < 1 || p.rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_group(p.rows)) {
    case 1:  // the one-row kernel
      return traj ? launch_fwd<true, 1>(p, integrated, work_floats, stream)
                  : launch_fwd<false, 1>(p, integrated, work_floats, stream);
    case 2: return smo_kdyn::fwd_rows<2>(p, traj, integrated, work_floats, stream);
    default: return smo_kdyn::fwd_rows<4>(p, traj, integrated, work_floats, stream);
  }
}

int bwd_rows(BwdParams& p, int integrated, long long work_floats, void* stream) {
  SMO_KDYN_STAMPS(p);
  if (p.rows < 1 || p.rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_group(p.rows)) {
    case 1: return launch_bwd<1>(p, integrated, work_floats, stream);
    case 2: return smo_kdyn::bwd_rows<2>(p, integrated, work_floats, stream);
    default: return smo_kdyn::bwd_rows<4>(p, integrated, work_floats, stream);
  }
}

}  // namespace

extern "C" {

// Floats of scratch that a launch at (n, mg) needs for each of its rows
// (the larger of the forward's and the reverse sweep's).
int sm_kdyn_work_floats(int n, int mg) {
  const PartDims d(n, mg);
  const long long f = d.fwd_work_floats(), b = d.bwd_work_floats();
  return static_cast<int>(f > b ? f : b);
}

// Rows a stage task of a row launch of `rows` rows steps.
int sm_kdyn_row_group(int rows) { return row_group(rows); }

int sm_kdyn_fwd(const float* br0, const float* bi0, const float* u,
                const float* consts, int n, int mg, int n_steps, int integrated,
                float dt, float* brT, float* biT, float* J, float* work,
                long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, nullptr, nullptr, work};
  SMO_KDYN_STAMPS(p);
  return launch_fwd<false, 1>(p, integrated, work_floats, stream);
}

int sm_kdyn_fwd_traj(const float* br0, const float* bi0, const float* u,
                     const float* consts, int n, int mg, int n_steps, int integrated,
                     float dt, float* brT, float* biT, float* J, float* trr,
                     float* tri, float* work, long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, trr, tri, work};
  SMO_KDYN_STAMPS(p);
  return launch_fwd<true, 1>(p, integrated, work_floats, stream);
}

int sm_kdyn_bwd(const float* u, const float* brT, const float* biT, const float* gbar,
                const float* consts, const float* trr, const float* tri, int n, int mg,
                int n_steps, int integrated, float dt, float* b0r_bar, float* b0i_bar,
                float* ubar, float* work, long long work_floats, void* stream) {
  BwdParams p{u, brT, biT, gbar, consts, trr, tri, n, mg, n_steps, dt,
              b0r_bar, b0i_bar, ubar, work};
  SMO_KDYN_STAMPS(p);
  return launch_bwd<1>(p, integrated, work_floats, stream);
}

// The row launches: `rows` (1 .. kMaxRows) sweeps of one constant pack,
// each operand an (R, ...) array of the one-row launch's operands (J and
// gbar (R,)), and rows x sm_kdyn_work_floats(n, mg) floats of scratch;
// their stage tasks step sm_kdyn_row_group(rows) rows each (one row: the
// one-row kernel).

int sm_kdyn_fwd_rows(const float* br0, const float* bi0, const float* u,
                     const float* consts, int n, int mg, int n_steps, int integrated,
                     float dt, int rows, float* brT, float* biT, float* J, float* work,
                     long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, nullptr, nullptr, work,
              rows};
  return fwd_rows(p, false, integrated, work_floats, stream);
}

int sm_kdyn_fwd_traj_rows(const float* br0, const float* bi0, const float* u,
                          const float* consts, int n, int mg, int n_steps, int integrated,
                          float dt, int rows, float* brT, float* biT, float* J, float* trr,
                          float* tri, float* work, long long work_floats, void* stream) {
  FwdParams p{br0, bi0, u, consts, n, mg, n_steps, dt, brT, biT, J, trr, tri, work, rows};
  return fwd_rows(p, true, integrated, work_floats, stream);
}

int sm_kdyn_bwd_rows(const float* u, const float* brT, const float* biT, const float* gbar,
                     const float* consts, const float* trr, const float* tri, int n, int mg,
                     int n_steps, int integrated, float dt, int rows, float* b0r_bar,
                     float* b0i_bar, float* ubar, float* work, long long work_floats,
                     void* stream) {
  BwdParams p{u, brT, biT, gbar, consts, trr, tri, n, mg, n_steps, dt,
              b0r_bar, b0i_bar, ubar, work, rows};
  return bwd_rows(p, integrated, work_floats, stream);
}

#ifdef SMO_KDYN_PROBE
// Probe builds: the launches' stamps go to `stamps` (4 + blocks x
// kProbeSteps x 2 x kProbeSlots words, zeroed by the caller; null: none),
// and every row launch of R > 1 takes `group` rows a task (0:
// row_group's choice).
int smo_kdyn_probe(void* stamps, int group) {
  g_force_group = group;
  g_stamps = static_cast<unsigned long long*>(stamps);
  return 0;
}
#endif

}  // extern "C"

#endif  // SMO_KDYN_ROWS_G
