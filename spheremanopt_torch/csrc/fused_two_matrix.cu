// Two-matrix fused SBDF integrator for SHB23: u' = A u + B (c2 u^2 + c3 u^3).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_two_matrix.py:
//   sm_fused_fwd  <- _fwd_kernel (_run_fwd; has_traj and has_ser as the
//                    traj / ser pointers)
//   sm_fused_bwd  <- _bwd_kernel (_run_bwd); with op_grads it stores the
//                    lambda history that op_grads.cu turns into dA and dB
//                    (the `lam_hist` pointer)
//
// SHB23's step has two dense (mg, mg) f32 propagators: A = A_lin (the
// Chebyshev-tau solve of the linear operator, entries ~1/dt) and
// B = A_nl (the same solve behind the dealias projector), 1 MiB each at
// mg = 512, over 2000 sequential steps.
//
// What bounds them on an H100: each step is two batch-1 GEMVs, and the
// steps depend on each other. The TPU kernel keeps both matrices in
// VMEM; one SM's 227 KB of shared memory holds neither, so here A and B
// stay in global memory and, after the first step, in the 50 MB L2.
// One thread block runs the whole solve in one launch, as on the TPU:
// each step one SM reads 2 MiB out of L2 at about 2 flop per 4 bytes,
// so the kernel is bound by one SM's L2 read rate and the step-to-step
// dependency, not by arithmetic. What the design does about it:
//   * the forward reads row r of A and of B in one pass (one warp per
//     row, float4 loads, neighbouring lanes on neighbouring addresses),
//     so u and g(u) each come out of shared memory once per row;
//   * the reverse sweep computes A^T lambda and B^T lambda in the same
//     column-partitioned loop as the shared-matrix reverse kernel, with
//     one lambda read per row for both products;
//   * the state (u ping-pong, g, w, lambda) lives in shared memory; only
//     A, B and the trajectory rows touch device memory.
// Splitting A and B over a 16-CTA thread-block cluster is the later,
// faster design.
//
// The energy series is a template flag, chosen from the `ser` pointer at
// launch, as in fused_shared.cu (a runtime test sits on thread 0's
// per-step path); the pinned rounding of common.cuh keeps J bitwise the
// same in both instantiations. The lambda history of the reverse sweep
// is a template flag too, chosen from `lam_hist`; with the update's
// rounding pinned in common.cuh, lambda_0 is bitwise the same in both
// instantiations.
//
// Both functions launch on the given stream, do not synchronise, and
// return cudaGetLastError(). The caller guarantees mg % 128 == 0,
// 128 <= mg <= 2048, contiguous f32 buffers on one device.

#include "common.cuh"

namespace {

using smo::kThreads;
using smo::kWarps;

// Forward: N steps; J_sum = Kahan sum over n = 0..N of sum_j w_j u_n,j^2.
// traj (N rows) is written when non-null, ser (N + 1 energies) when
// kSeries. Shared memory: u[2][mg] (ping-pong), g[mg], w[mg], red[32].
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
      g[j] = c2 * uj * uj + c3 * uj * uj * uj;
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
        const float4 aa = __ldg(arow + k);
        const float4 bb = __ldg(brow + k);
        const float4 uu = u4[k];
        const float4 gg = g4[k];
        s += aa.x * uu.x + aa.y * uu.y + aa.z * uu.z + aa.w * uu.w;
        s += bb.x * gg.x + bb.y * gg.y + bb.z * gg.z + bb.w * gg.w;
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

// Backward: lambda_N = s w u_N, then for n = N-1..0
//   lambda_n = A^T lambda_{n+1} + (2 c2 u_n + 3 c3 u_n^2) * (B^T lambda_{n+1})
//              + s w u_n,
// with s = *scale and u_n = traj row n. Thread (p, cg) sums rows
// p, p + P, ... of column group cg (4 columns, one float4) of A and of
// B; the P partial sums of each meet in shared memory.
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

  for (int j = tid; j < mg; j += kThreads) lam[j] = s * (w[j] * uT[j]);
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
        sa.x += aa.x * l;
        sa.y += aa.y * l;
        sa.z += aa.z * l;
        sa.w += aa.w * l;
        sb.x += bb.x * l;
        sb.y += bb.y * l;
        sb.z += bb.z * l;
        sb.w += bb.w * l;
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

}  // namespace

extern "C" {

int sm_fused_fwd(const float* a, const float* b, const float* w, const float* u0,
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
