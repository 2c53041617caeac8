// SHB23's row kernels (rows 3r and 4r): the two-matrix forward and reverse
// sweeps of fused_two_matrix.cu over a sweep's R <= kMaxStates rows in one
// launch, the port of the JAX package's jax.vmap over ops/pallas/
// fused_two_matrix.py's _run_fwd (_fwd_kernel) and _run_bwd (_bwd_kernel),
// where pallas_call's batching rule gives each kernel a grid over the rows.
// Each row is bitwise its one-row kernel on that row: the forward's u_T, J
// and trajectory sm_fused_fwd_grid's, the reverse's lambda_0 sm_fused_bwd's.
// Only the places change (where the operands sit, which threads run which
// row), never a sum's order.
//
// What bounds them on an H100: the steps depend on each other, so a step's
// time is latency: an exchange of the new state between the SMs and the
// reads of A and B (2 MiB at mg = 512) from where they sit. The rows of a
// sweep are independent, so the design spends the SMs on rows: the
// operators sit in registers, which an SM has more of (256 KB) than shared
// memory (227 KB), and each group of CTAs exchanges only its own rows.
//
// Forward (sm_fused_fwd_rows, fused_fwd_rows_kernel): one cooperative
// launch of ceil(R / G) groups of `ctas` CTAs; group q serves rows
// [q G, min((q + 1) G, R)) and its CTAs split A's and B's rows, `rows` a CTA
// (CTA c of a group rows [c rows, min((c + 1) rows, mg))), so a CTA reads
// its group's G mg step-tagged words a step (grid.cuh), not R mg. Warp w
// owns the CTA's rows w, w + 8, ... (its row slots); a lane keeps its
// float4s of A's and B's rows in the first kRegSlots slots in registers
// for the whole sweep (128 floats at mg = 512 and 32 rows a CTA), the rest
// in shared memory (only where a CTA's rows do not fit kOpFloats: mg = 640
// at G = 1). A step loads each state's float4s of u and g once
// for all the warp's rows; each (row, state) chain is fwd_dot4 in the
// one-row grid's lane and k order, then warp_sum. CTA j < G of a group
// forms row j's J with the one-row grid's reduction tree (energy_partials,
// Kahan).
//
// Reverse (sm_fused_bwd_rows, fused_bwd_rows_kernel): ceil(R / G) clusters
// of kClusterCtas CTAs, cluster q carrying rows [q G, ...). CTA rank r owns
// the columns [r C, (r + 1) C), C = mg / 16, as the one-row cluster does;
// its thread (p, col) keeps its chain of A's and of B's column (rows p,
// p + P, ..., P = row_phases(mg)) in registers up to kOpTerms terms (56 + 56
// of 64 at mg = 512), the rest of the chain in shared memory, and runs G
// chains per matrix, one a row, in the one-row order with __fmaf_rn. lambda is [mg][G] (ping-pong), so one load serves
// the G rows' lambda_i; each new entry adds the P partials in phase order
// and applies the pinned update of common.cuh, and goes to every CTA of the
// cluster through distributed shared memory, G values a store; one
// cluster.sync() a step. A CTA's shared memory holds the state, the
// partials and the chains' tails, not all of A and B: the one-row cluster's
// 137 KB at mg = 512 fall to ~31 KB.
//
// G (rows a group or a cluster carries) is a template parameter, chosen
// by the wrapper from R (ops/cuda/fused_two_matrix.py fwd_row_group,
// bwd_row_group); fused_rows_g1.cu and fused_rows_g2.cu each compile one G
// in their own nvcc process. With -DSMO_ROWS_PROBE (the timing tool's
// probe build, tools/time_row_kernels.py --probe) the kernels also record
// clock64() stamps of each step's parts.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster.cuh"
#include "common.cuh"
#include "grid.cuh"

namespace smo {

// g(u) = c2 u^2 + c3 u^3 and one float4 of a row's dot products with u
// and g(u): written once for every two-matrix forward (fused_two_matrix.cu
// and the rows here), so each gives the one-block kernel's bits.
__device__ __forceinline__ float g_poly(float c2, float c3, float u) {
  return c2 * u * u + c3 * u * u * u;
}

__device__ __forceinline__ float fwd_dot4(float s, const float4 aa, const float4 uu,
                                          const float4 bb, const float4 gg) {
  s += aa.x * uu.x + aa.y * uu.y + aa.z * uu.z + aa.w * uu.w;
  s += bb.x * gg.x + bb.y * gg.y + bb.z * gg.z + bb.w * gg.w;
  return s;
}

// 0.f that the compiler cannot see through: a row's dot-product chain
// starts from it as the one-row grid's loop starts from its loop-carried
// sum, so the compiler cannot fold the start into the chain's first terms
__device__ __forceinline__ float opaque_zero() {
  float z;
  asm("mov.b32 %0, 0;" : "=f"(z));
  return z;
}

#ifdef SMO_ROWS_PROBE
// The probe build's clock64() stamps (tools/time_row_kernels.py --stamps):
// for kProbeSteps steps from kProbeFrom, thread 0 of each of the first
// kProbeCtas CTAs records kProbeMarks points of a step (kernel 0 the
// forward: u_n complete in the CTA, the products done, the tagged stores
// issued, the trajectory and energy done, the step's last barrier passed;
// kernel 1 the reverse: the step's start, the chains done, the partials
// complete, the entries stored to the cluster, cluster.sync() passed)
constexpr int kProbeFrom = 1000, kProbeSteps = 16, kProbeCtas = 256, kProbeMarks = 5;
static __device__ long long probe_stamps[2][kProbeCtas][kProbeSteps][kProbeMarks];
__device__ __forceinline__ void probe_stamp(int kernel, int step, int which) {
  if (threadIdx.x == 0 && step >= kProbeFrom && step < kProbeFrom + kProbeSteps
      && blockIdx.x < kProbeCtas)
    probe_stamps[kernel][blockIdx.x][step - kProbeFrom][which] = clock64();
}
#define SMO_ROWS_STAMP(kernel, step, which) probe_stamp(kernel, step, which)
#else
#define SMO_ROWS_STAMP(kernel, step, which)
#endif

// read_tagged over a group's slot of n words (kPairs or fewer word pairs a
// thread): this thread's pairs are loaded, `overlap()` runs while the loads
// are in flight, then only the words without the tag are loaded again until
// all carry it (as read_tagged_lambda); u, and f = poly(u) unless f is null
template <int kPairs, typename Poly, typename F>
__device__ __forceinline__ void read_tagged_group(const unsigned long long* slot, unsigned tag,
                                                  int n, Poly poly, float* u, float* f,
                                                  F overlap) {
  const int half = n / 2, k0 = threadIdx.x;
  unsigned long long v[2 * kPairs];
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int k = k0 + r * kClusterThreads;
    v[2 * r] = v[2 * r + 1] = 0ull;
    if (k < half) {
      v[2 * r] = load_tagged(slot + 2 * k);
      v[2 * r + 1] = load_tagged(slot + 2 * k + 1);
    }
  }
  overlap();
  for (unsigned polls = 0;; ++polls) {
    bool done = true;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int k = k0 + r * kClusterThreads;
      if (k < half
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
  for (int r = 0; r < kPairs; ++r) {
    const int k = k0 + r * kClusterThreads;
    if (k < half) {
      const float x0 = __uint_as_float(static_cast<unsigned>(v[2 * r]));
      const float x1 = __uint_as_float(static_cast<unsigned>(v[2 * r + 1]));
      u[2 * k] = x0;
      u[2 * k + 1] = x1;
      if (f != nullptr) {
        f[2 * k] = poly(x0);
        f[2 * k + 1] = poly(x1);
      }
    }
  }
}

// Floats of the operators a forward thread keeps in registers (its float4s
// of its warp's rows), and terms of each of a reverse thread's two chains
// (A's and B's) kept in registers: at 64 terms (mg = 512) ptxas spilled
// 16-24 bytes a thread in the reverse, which also holds its chains' loads
// of lambda in flight
constexpr int kOpFloats = 128;
constexpr int kOpTerms = 56;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Row slots a warp has at width mg and G rows a group: the rows of a CTA
// of the narrowest group a card of >= 128 SMs gives (ceil(8 / G) groups of
// 16 G CTAs), over the 8 warps; kRegSlots of them in registers
__host__ __device__ constexpr int fwd_row_slots(int mg, int G) {
  return (mg / 128 + G - 1) / G;
}
__host__ __device__ constexpr int fwd_reg_slots(int mg, int G) {
  return fwd_row_slots(mg, G) < kOpFloats / (8 * (mg / 128)) ? fwd_row_slots(mg, G)
                                                              : kOpFloats / (8 * (mg / 128));
}

// Shared memory of a forward CTA with `rows` rows: the rows past its warps'
// register slots (of A and of B), u[2][G][mg] (ping-pong), g[G][mg],
// w[mg], red[32]
__host__ __device__ constexpr size_t fwd_rows_group_smem(int mg, int G, int rows, int reg_slots) {
  const int shared = rows > kClusterWarps * reg_slots ? rows - kClusterWarps * reg_slots : 0;
  return (2 * (size_t)shared * mg + 3 * (size_t)G * mg + mg + 32) * sizeof(float);
}

template <int kR, int kG>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_fwd_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ w, const float* __restrict__ u0, float c2,
                      float c3, int n_steps, int ns, int ctas, int rows,
                      float* __restrict__ uT, float* __restrict__ jsum,
                      float* __restrict__ traj, float* __restrict__ ubuf) {
  constexpr int mg = 128 * kR, mg4 = mg / 4, nk = kR;
  constexpr int kSlots = fwd_row_slots(mg, kG);
  constexpr int kRegSlots = fwd_reg_slots(mg, kG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / ctas, cq = blockIdx.x - q * ctas;  // group, CTA in the group
  const int s0 = q * kG, ng = min(kG, ns - s0);                  // the group's rows
  const int r0 = cq * rows, nr = min(rows, mg - r0);             // the CTA's operator rows
  const int own = cq < ng ? cq : -1;  // the row whose J this CTA forms
  const int nw = ng * mg;             // words of one of the group's slots
  const int rsh = max(rows - kClusterWarps * kRegSlots, 0);
  extern __shared__ float4 smem4[];
  float4* as4 = smem4;                  // [rsh][mg4]: the rows past the register slots
  float4* bs4 = as4 + (size_t)rsh * mg4;
  float4* u4 = bs4 + (size_t)rsh * mg4;  // [2][kG][mg4]: u_n in buffer n & 1
  float4* g4 = u4 + 2 * kG * mg4;        // [kG][mg4]
  float* u = reinterpret_cast<float*>(u4);
  float* f = reinterpret_cast<float*>(g4);
  float* ws = f + kG * mg;
  float* red = ws + mg;  // [32]
  // the group's two slots of ng mg (value, tag) words, from word 2 s0 mg
  auto* pairs = reinterpret_cast<unsigned long long*>(ubuf) + (size_t)2 * s0 * mg;
  const auto poly = [=](float x) { return g_poly(c2, c3, x); };

  const float4* a4 = reinterpret_cast<const float4*>(a) + (size_t)r0 * mg4;
  const float4* b4 = reinterpret_cast<const float4*>(b) + (size_t)r0 * mg4;
  float4 ar[kRegSlots][nk], br[kRegSlots][nk];
#pragma unroll
  for (int i = 0; i < kRegSlots; ++i) {
    const int rl = warp + kClusterWarps * i;
#pragma unroll
    for (int j = 0; j < nk; ++j) {
      ar[i][j] = rl < nr ? __ldg(a4 + (size_t)rl * mg4 + lane + 32 * j) : float4{};
      br[i][j] = rl < nr ? __ldg(b4 + (size_t)rl * mg4 + lane + 32 * j) : float4{};
    }
  }
  const int nsh = max(nr - kClusterWarps * kRegSlots, 0);
  const size_t sh0 = (size_t)kClusterWarps * kRegSlots * mg4;
  for (int i = tid; i < nsh * mg4; i += kClusterThreads) {
    as4[i] = __ldg(a4 + sh0 + i);
    bs4[i] = __ldg(b4 + sh0 + i);
  }
  if (own >= 0)
    for (int j = tid; j < mg; j += kClusterThreads) ws[j] = w[j];

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = blockIdx.x * kClusterThreads + tid; i < 2 * ns * mg;
       i += gridDim.x * kClusterThreads)
    reinterpret_cast<unsigned long long*>(ubuf)[i] = 0ull;  // no tag: steps count from 1
  grid.sync();  // the tags are clear before any CTA stores u_1

  // CTA `own` forms e_{n-1}, row own's energy of u_{n-1}, while its loads of
  // u_n are in flight (the one-row grid's CTA 0 forms e_n in step n: the
  // same sums in the same order, off the exchange's path), and adds it to J
  // after the step's first barrier
  constexpr int kPairs = (kG * mg / 2 + kClusterThreads - 1) / kClusterThreads;
  const auto energy_of = [&](const float* uprev) {
    if (own >= 0) energy_partials(uprev + own * mg, ws, mg, red);
  };
  float acc = 0.f, comp = 0.f;  // live in thread 0 of CTA `own`
  for (int n = 0; n < n_steps; ++n) {
    float* un = u + (n & 1) * kG * mg;  // u_n (and g = poly(u_n) in f)
    const float* uprev = u + ((n + 1) & 1) * kG * mg;
    const float4* un4 = reinterpret_cast<const float4*>(un);
    if (n == 0) {
      for (int j = tid; j < nw; j += kClusterThreads) {
        const float x = u0[(size_t)s0 * mg + j];
        un[j] = x;
        f[j] = poly(x);
      }
    } else {
      read_tagged_group<kPairs>(pairs + (size_t)((n - 1) & 1) * nw, n, nw, poly, un, f,
                                [&] { energy_of(uprev); });
    }
    __syncthreads();  // u and g complete (and at n = 0 the rows and w; red)
    SMO_ROWS_STAMP(0, n, 0);
    if (n > 0 && own >= 0 && warp == 0) {
      const float e = warp_sum(red[lane]);
      if (lane == 0) kahan_add(acc, comp, e);
    }
    float sum[kSlots][kG];
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
#pragma unroll
      for (int s = 0; s < kG; ++s) sum[i][s] = opaque_zero();
    if constexpr (nk == 1) {
      // one float4 a lane: the one-row grid's loop over k (its `#pragma
      // unroll 4` over a run-time trip count, here one trip), so that the
      // compiler shapes the chain as it does there (the same chain written
      // out once left the grid's bits at step 1 at mg = 128)
      int mg4_rt;
      asm("mov.b32 %0, %1;" : "=r"(mg4_rt) : "r"(mg4));
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int rl = warp + kClusterWarps * i;
        if (rl < nr) {
          float4 aa, bb;
          if (i < kRegSlots) {
            aa = ar[i < kRegSlots ? i : 0][0];
            bb = br[i < kRegSlots ? i : 0][0];
          } else {
            const size_t x = (size_t)(rl - kClusterWarps * kRegSlots) * mg4 + lane;
            aa = as4[x];
            bb = bs4[x];
          }
#pragma unroll
          for (int s = 0; s < kG; ++s) {
            if (s < ng) {
              float dot = 0.f;
#pragma unroll 4
              for (int k = lane; k < mg4_rt; k += 32)
                dot = fwd_dot4(dot, aa, un4[s * mg4 + k], bb, g4[s * mg4 + k]);
              sum[i][s] = dot;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < (nk > 1 ? nk : 0); ++j) {
      const int k = lane + 32 * j;
      float4 uu[kG], gg[kG];
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        uu[s] = s < ng ? un4[s * mg4 + k] : float4{};
        gg[s] = s < ng ? g4[s * mg4 + k] : float4{};
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int rl = warp + kClusterWarps * i;
        if (rl < nr) {
          float4 aa, bb;
          if (i < kRegSlots) {
            aa = ar[i < kRegSlots ? i : 0][j];
            bb = br[i < kRegSlots ? i : 0][j];
          } else {
            const size_t x = (size_t)(rl - kClusterWarps * kRegSlots) * mg4 + k;
            aa = as4[x];
            bb = bs4[x];
          }
#pragma unroll
          for (int s = 0; s < kG; ++s)
            if (s < ng) sum[i][s] = fwd_dot4(sum[i][s], aa, uu[s], bb, gg[s]);
        }
      }
    }
    SMO_ROWS_STAMP(0, n, 1);
    unsigned long long* dst = pairs + (size_t)(n & 1) * nw;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int rl = warp + kClusterWarps * i;
      if (rl < nr) {
#pragma unroll
        for (int s = 0; s < kG; ++s) {
          if (s < ng) {
            const float x = warp_sum(sum[i][s]);
            if (lane == 0) store_tagged(dst + s * mg + r0 + rl, x, n + 1);
          }
        }
      }
    }
    SMO_ROWS_STAMP(0, n, 2);
    if (traj != nullptr)
      for (int i = tid; i < ng * nr; i += kClusterThreads) {
        const int s = i / nr, r = r0 + i % nr;
        traj[((size_t)(s0 + s) * n_steps + n) * mg + r] = un[s * mg + r];
      }
    SMO_ROWS_STAMP(0, n, 3);
    __syncthreads();  // f and red free for the next step
    SMO_ROWS_STAMP(0, n, 4);
  }

  // u_N: each CTA stores its rows of its group's u_T; CTA j < ng forms row
  // j's e_{N-1}, e_N and J
  float* uN = u + (n_steps & 1) * kG * mg;
  if (n_steps == 0) {
    for (int j = tid; j < nw; j += kClusterThreads) uN[j] = u0[(size_t)s0 * mg + j];
  } else {
    read_tagged_group<kPairs>(pairs + (size_t)((n_steps - 1) & 1) * nw, n_steps, nw, poly, uN,
                              static_cast<float*>(nullptr),
                              [&] { energy_of(u + ((n_steps + 1) & 1) * kG * mg); });
  }
  __syncthreads();
  for (int i = tid; i < ng * nr; i += kClusterThreads) {
    const int j = (i / nr) * mg + r0 + i % nr;
    uT[(size_t)s0 * mg + j] = uN[j];
  }
  if (own >= 0) {
    if (n_steps > 0 && warp == 0) {
      const float e = warp_sum(red[lane]);
      if (lane == 0) kahan_add(acc, comp, e);
    }
    __syncthreads();  // red read
    energy_partials(uN + own * mg, ws, mg, red);
    __syncthreads();
    if (warp == 0) {
      const float eN = warp_sum(red[lane]);
      if (lane == 0) {
        kahan_add(acc, comp, eN);
        jsum[s0 + own] = acc;
      }
    }
  }
}

template <int kR, int kG>
struct FwdRowsG {
  static inline bool ready[kMaxDevices] = {};
  static size_t smem(int rows) {
    return fwd_rows_group_smem(128 * kR, kG, rows, fwd_reg_slots(128 * kR, kG));
  }
  static int capacity(int rows) {
    return grid_capacity(fused_fwd_rows_kernel<kR, kG>, smem(rows), ready);
  }
  static int launch(int groups, const float* a, const float* b, const float* w, const float* u0,
                    float c2, float c3, int n_steps, int ns, int ctas, int rows, float* uT,
                    float* jsum, float* traj, float* ubuf, cudaStream_t st) {
    return grid_launch(fused_fwd_rows_kernel<kR, kG>, groups * ctas, smem(rows), ready, st, a,
                       b, w, u0, c2, c3, n_steps, ns, ctas, rows, uT, jsum, traj, ubuf);
  }
};

// ---------------------------------------------------------------------------
// reverse
// ---------------------------------------------------------------------------

// A reverse chain at width mg: T = ceil(mg / P) terms, of which kRT (at
// most kOpTerms, whole float4s) sit in registers and the other kST in
// shared memory, ts floats apart (chain_stride: eight consecutive
// threads' float4s in eight bank groups); lambda sits in the chains' order
// too, phase q's terms from q lts (lam_pos), G floats a term, so that a
// thread loads four terms of its chain for its G rows as G float4s
template <int kR>
struct BwdRowsShape {
  static constexpr int mg = 128 * kR, C = mg / kClusterCtas, P = row_phases(mg);
  static constexpr int T = (mg + P - 1) / P;
  static constexpr int kRT = T <= kOpTerms ? T : kOpTerms;
  static constexpr int kST = T - kRT;
  static constexpr int ts = kST > 0 ? chain_stride(kST) : 0;
  static constexpr int lts = chain_stride(T);
};

// Shared memory of a reverse CTA: the chains' tails (A's and B's),
// lambda[2][P][lts][G], the partials [P C][G] of each matrix, u_n [C][G],
// w [C]
__host__ __device__ constexpr size_t bwd_rows_group_smem(int mg, int G, int ts) {
  return (2 * (size_t)row_phases(mg) * (mg / kClusterCtas) * ts +
          2 * (size_t)row_phases(mg) * chain_stride((mg + row_phases(mg) - 1) / row_phases(mg)) *
              G +
          2 * (size_t)row_phases(mg) * (mg / kClusterCtas) * G +
          (size_t)(mg / kClusterCtas) * G + mg / kClusterCtas) *
         sizeof(float);
}

// G (1 or 2) floats from (to) 16-byte aligned shared memory in one access
template <int kG>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[kG]) {
  static_assert(kG == 1 || kG == 2, "one or two rows");
  if constexpr (kG == 1) {
    v[0] = p[0];
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
}

// 4 G floats (four terms of a chain for G rows) in G float4 loads
template <int kG>
__device__ __forceinline__ void load_quad(const float* p, float (&v)[4 * kG]) {
#pragma unroll
  for (int h = 0; h < kG; ++h) {
    const float4 x = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = x.x;
    v[4 * h + 1] = x.y;
    v[4 * h + 2] = x.z;
    v[4 * h + 3] = x.w;
  }
}

template <int kG>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[kG]) {
  static_assert(kG == 1 || kG == 2, "one or two rows");
  if constexpr (kG == 1)
    p[0] = v[0];
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int kR, int kG>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_bwd_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ w, const float* __restrict__ uT,
                      const float* __restrict__ traj, float c2, float c3,
                      const float* __restrict__ scale, int n_steps, int ns,
                      float* __restrict__ lam_out) {
  using S = BwdRowsShape<kR>;
  constexpr int mg = S::mg, C = S::C, P = S::P, T = S::T, kRT = S::kRT, kST = S::kST,
                ts = S::ts, lts = S::lts;
  static_assert(P * C <= kClusterThreads, "one thread per (phase, column)");
  static_assert(kRT % 4 == 0 || kST == 0, "the chain's tail starts on a float4");
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, c0 = rank * C;
  const int s0 = static_cast<int>(blockIdx.x / kClusterCtas) * kG, ng = min(kG, ns - s0);
  extern __shared__ float4 smem4[];
  float* ash = reinterpret_cast<float*>(smem4);  // [P C][ts]: the chains' tails
  float* bsh = ash + P * C * ts;
  float* lam = bsh + P * C * ts;  // [P][lts][kG]
  float* lamn = lam + P * lts * kG;
  float* pa = lamn + P * lts * kG;  // [P C][kG]
  float* pb = pa + P * C * kG;      // [P C][kG]
  float* us = pb + P * C * kG;      // [C][kG]
  float* ws = us + C * kG;          // [C]

  // thread (p, col): its chain, rows p, p + P, ... < mg of column c0 + col
  const int p = tid / C, col = tid % C;
  const bool active = tid < P * C;
  const int nt = active ? (mg - p + P - 1) / P : 0;
  float ar[kRT], br[kRT];
#pragma unroll
  for (int m = 0; m < kRT; ++m) {
    const size_t src = (size_t)(p + P * m) * mg + c0 + col;
    ar[m] = m < nt ? __ldg(a + src) : 0.f;
    br[m] = m < nt ? __ldg(b + src) : 0.f;
  }
  if (active)
    for (int m = kRT; m < kRT + kST; ++m) {
      const size_t src = (size_t)(p + P * m) * mg + c0 + col;
      ash[tid * ts + m - kRT] = m < nt ? __ldg(a + src) : 0.f;
      bsh[tid * ts + m - kRT] = m < nt ? __ldg(b + src) : 0.f;
    }
  float sc[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) sc[g] = g < ng ? scale[s0 + g] : 0.f;
  for (int idx = tid; idx < mg * kG; idx += kClusterThreads) {
    const int j = idx / kG, g = idx % kG;
    lam[lam_pos(j, P, lts) * kG + g] =
        g < ng ? cost_term(scale[s0 + g], w[j], uT[(size_t)(s0 + g) * mg + j]) : 0.f;
  }
  if (tid < C) ws[tid] = w[c0 + tid];
  cluster.sync();  // every CTA has started and holds lambda_N before any remote store

  // u_n of (column, row) pair tid + v kClusterThreads, v < kUn, loaded a
  // step ahead (in flight during the step before)
  constexpr int kUn = (C * kG + kClusterThreads - 1) / kClusterThreads;
  float un[kUn], un_next[kUn];
  const auto load_un = [&](int k, float (&dst)[kUn]) {
    const size_t row = (size_t)(n_steps - 1 - k) * mg;
#pragma unroll
    for (int v = 0; v < kUn; ++v) {
      const int idx = tid + v * kClusterThreads, c = idx / kG, g = idx % kG;
      dst[v] = idx < C * kG && g < ng ? traj[(size_t)(s0 + g) * n_steps * mg + row + c0 + c]
                                      : 0.f;
    }
  };
  if (n_steps > 0) load_un(0, un_next);
  for (int k = 0; k < n_steps; ++k) {
#pragma unroll
    for (int v = 0; v < kUn; ++v) un[v] = un_next[v];
    if (k + 1 < n_steps) load_un(k + 1, un_next);
    SMO_ROWS_STAMP(1, k, 0);
    if (active) {
      // the chains, four terms (rows p + P m, m = 4 m4 .. 4 m4 + 3) at a time:
      // lambda's four terms for the G rows in G float4 loads, the matrices'
      // from registers (m < kRT) or the tail's float4s
      float sa[kG], sb[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) sa[g] = sb[g] = 0.f;
#pragma unroll
      for (int m4 = 0; m4 < (T + 3) / 4; ++m4) {
        float l[4 * kG], xa[4], xb[4];
        load_quad<kG>(lam + (p * lts + 4 * m4) * kG, l);
        if (4 * m4 >= kRT) {
          const float4 ta = reinterpret_cast<const float4*>(ash + tid * ts)[m4 - kRT / 4];
          const float4 tb = reinterpret_cast<const float4*>(bsh + tid * ts)[m4 - kRT / 4];
          xa[0] = ta.x, xa[1] = ta.y, xa[2] = ta.z, xa[3] = ta.w;
          xb[0] = tb.x, xb[1] = tb.y, xb[2] = tb.z, xb[3] = tb.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = 4 * m4 + e < kRT ? 4 * m4 + e : 0;
            xa[e] = ar[m];
            xb[e] = br[m];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * m4 + e < nt) {
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              sa[g] = __fmaf_rn(xa[e], l[e * kG + g], sa[g]);
              sb[g] = __fmaf_rn(xb[e], l[e * kG + g], sb[g]);
            }
          }
        }
      }
      SMO_ROWS_STAMP(1, k, 1);
      store_rows<kG>(pa + tid * kG, sa);
      store_rows<kG>(pb + tid * kG, sb);
    }
#pragma unroll
    for (int v = 0; v < kUn; ++v)
      if (tid + v * kClusterThreads < C * kG) us[tid + v * kClusterThreads] = un[v];
    __syncthreads();  // partials and u_n ready
    SMO_ROWS_STAMP(1, k, 2);
    // (column, destination rank) pairs: the G entries of a column are
    // formed once per destination, consecutive threads store consecutive
    // columns
    for (int t = tid; t < kClusterCtas * C; t += kClusterThreads) {
      const int c = t % C, dst = t / C;
      float wa[kG], wb[kG], xa[kG], xb[kG], v[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) wa[g] = wb[g] = 0.f;
#pragma unroll
      for (int qq = 0; qq < P; ++qq) {
        load_rows<kG>(pa + (qq * C + c) * kG, xa);
        load_rows<kG>(pb + (qq * C + c) * kG, xb);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          wa[g] += xa[g];
          wb[g] += xb[g];
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float u = us[c * kG + g];
        const float gprime = poly_prime(0.f, 2.f * c2, 3.f * c3, u);
        v[g] = __fadd_rn(__fmaf_rn(gprime, wb[g], wa[g]), cost_term(sc[g], ws[c], u));
      }
      store_rows<kG>(cluster.map_shared_rank(lamn, dst) + lam_pos(c0 + c, P, lts) * kG, v);
    }
    SMO_ROWS_STAMP(1, k, 3);
    cluster.sync();  // lamn complete in every CTA; lam, partials and u_n free
    SMO_ROWS_STAMP(1, k, 4);
    float* t = lam;
    lam = lamn;
    lamn = t;
  }
  for (int idx = tid; idx < C * kG; idx += kClusterThreads) {
    const int c = idx / kG, g = idx % kG;
    if (g < ng)
      lam_out[(size_t)(s0 + g) * mg + c0 + c] = lam[lam_pos(c0 + c, P, lts) * kG + g];
  }
}

template <int kR, int kG>
struct BwdRowsG {
  static inline bool ready[kMaxDevices] = {};
  static constexpr size_t smem = bwd_rows_group_smem(128 * kR, kG, BwdRowsShape<kR>::ts);
  static int capacity() {
    return cluster_capacity(fused_bwd_rows_kernel<kR, kG>, smem, kClusterThreads, ready);
  }
  static int launch(int clusters, const float* a, const float* b, const float* w,
                    const float* uT, const float* traj, float c2, float c3, const float* scale,
                    int n_steps, int ns, float* lam_out, cudaStream_t st) {
    return cluster_launch(fused_bwd_rows_kernel<kR, kG>, clusters, smem, kClusterThreads, ready,
                          st, a, b, w, uT, traj, c2, c3, scale, n_steps, ns, lam_out);
  }
};

// f(std::integral_constant<int, kR>) for the kR of mg = 128 kR <= 640 (the
// reverse clusters' widths, at which the row kernels exist), else `bad`
template <typename F>
int by_row_width(int mg, F f, int bad) {
  switch (mg) {
    case 128: return f(std::integral_constant<int, 1>{});
    case 256: return f(std::integral_constant<int, 2>{});
    case 384: return f(std::integral_constant<int, 3>{});
    case 512: return f(std::integral_constant<int, 4>{});
    case 640: return f(std::integral_constant<int, 5>{});
    default: return bad;
  }
}

// One G's launchers, compiled in fused_rows_g<G>.cu and called from
// fused_two_matrix.cu's exported functions; a launch returns a
// cudaError_t, a capacity a count (CTAs of the forward, clusters of the
// reverse) or -cudaError_t
#define SMO_ROWS_DECLARE(G)                                                                    \
  int fused_fwd_rows_g##G(int mg, int groups, const float* a, const float* b, const float* w,  \
                          const float* u0, float c2, float c3, int n_steps, int ns, int ctas,  \
                          int rows, float* uT, float* jsum, float* traj, float* ubuf,          \
                          cudaStream_t st);                                                    \
  int fused_fwd_rows_capacity_g##G(int mg, int rows);                                          \
  int fused_bwd_rows_g##G(int mg, int clusters, const float* a, const float* b,                \
                          const float* w, const float* uT, const float* traj, float c2,        \
                          float c3, const float* scale, int n_steps, int ns, float* lam_out,   \
                          cudaStream_t st);                                                    \
  int fused_bwd_rows_capacity_g##G(int mg);
#ifdef SMO_ROWS_PROBE
// The stamps of one G's translation unit (probe build only)
#define SMO_ROWS_PROBE_DEFINE(G)                                                   \
  extern "C" int smo_rows_stamps_g##G(void* dst) {                                 \
    return static_cast<int>(cudaMemcpyFromSymbol(dst, probe_stamps, sizeof(probe_stamps))); \
  }
#else
#define SMO_ROWS_PROBE_DEFINE(G)
#endif

SMO_ROWS_DECLARE(1)
SMO_ROWS_DECLARE(2)

#define SMO_ROWS_DEFINE(G)                                                                     \
  int fused_fwd_rows_g##G(int mg, int groups, const float* a, const float* b, const float* w,  \
                          const float* u0, float c2, float c3, int n_steps, int ns, int ctas,  \
                          int rows, float* uT, float* jsum, float* traj, float* ubuf,          \
                          cudaStream_t st) {                                                   \
    return by_row_width(                                                                       \
        mg,                                                                                    \
        [&](auto r) {                                                                          \
          return FwdRowsG<decltype(r)::value, G>::launch(groups, a, b, w, u0, c2, c3, n_steps, \
                                                         ns, ctas, rows, uT, jsum, traj, ubuf, \
                                                         st);                                  \
        },                                                                                     \
        static_cast<int>(cudaErrorInvalidValue));                                              \
  }                                                                                            \
  int fused_fwd_rows_capacity_g##G(int mg, int rows) {                                         \
    return by_row_width(                                                                       \
        mg, [&](auto r) { return FwdRowsG<decltype(r)::value, G>::capacity(rows); },           \
        -static_cast<int>(cudaErrorInvalidValue));                                             \
  }                                                                                            \
  int fused_bwd_rows_g##G(int mg, int clusters, const float* a, const float* b,                \
                          const float* w, const float* uT, const float* traj, float c2,        \
                          float c3, const float* scale, int n_steps, int ns, float* lam_out,   \
                          cudaStream_t st) {                                                   \
    return by_row_width(                                                                       \
        mg,                                                                                    \
        [&](auto r) {                                                                          \
          return BwdRowsG<decltype(r)::value, G>::launch(clusters, a, b, w, uT, traj, c2, c3,  \
                                                         scale, n_steps, ns, lam_out, st);     \
        },                                                                                     \
        static_cast<int>(cudaErrorInvalidValue));                                              \
  }                                                                                            \
  int fused_bwd_rows_capacity_g##G(int mg) {                                                   \
    return by_row_width(                                                                       \
        mg, [&](auto r) { return BwdRowsG<decltype(r)::value, G>::capacity(); },               \
        -static_cast<int>(cudaErrorInvalidValue));                                             \
  }                                                                                            \
  SMO_ROWS_PROBE_DEFINE(G)

}  // namespace smo
