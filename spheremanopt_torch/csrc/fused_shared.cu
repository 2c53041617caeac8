// Shared-matrix fused SBDF integrator for SH23: u' = B (lin u + c2 u^2 + c3 u^3).
//
// Replaces the TPU (Pallas) kernels of the JAX package's
// ops/pallas/fused_two_matrix.py:
//   sm_fused_fwd_shared  <- _fwd_kernel_shared (_run_fwd_shared; has_traj
//                           and has_ser as the traj / ser pointers)
//   sm_fused_bwd_shared  <- _bwd_kernel_shared (_run_bwd_shared, op_grads=False)
//
// What bounds them on an H100: every step is a batch-1 GEMV with the
// (mg, mg) f32 step matrix B (1 MiB at mg = 512), and the steps are
// sequential. The TPU kernel keeps B in VMEM for the whole solve; one
// SM's 227 KB of shared memory cannot hold it, so here B stays in global
// memory and, after the first step, in the 50 MB L2. One thread block
// runs the whole solve (one launch, as on the TPU): the per-step cost is
// one SM pulling 1 MiB out of L2, about 2 flop per 4 bytes, so the
// kernel is bound by a single SM's L2 bandwidth and by the step-to-step
// dependency, not by arithmetic. The design keeps the small state (u, v
// or lambda, the weights) in shared memory, reads B as float4 with
// neighbouring threads on neighbouring addresses, and never touches
// device memory for anything but B and the trajectory rows. Splitting B
// over a thread-block cluster's distributed shared memory is the later,
// faster design.
//
// The energy series is a template flag, chosen from the `ser` pointer at
// launch: a runtime test of the pointer on thread 0's per-step path made
// every step measurably slower on an H100. J stays bitwise the
// same in both instantiations because the energy term and the Kahan step
// round as common.cuh pins them.
//
// Both functions launch on the given stream, do not synchronise, and
// return cudaGetLastError() so the caller can raise on a refused launch.
// The caller guarantees mg % 128 == 0, 128 <= mg <= 2048, contiguous
// f32 buffers on one device.

#include "common.cuh"

namespace {

using smo::kThreads;
using smo::kWarps;

// Forward: N steps; J_sum = Kahan sum over n = 0..N of sum_j w_j u_n,j^2.
// traj (N rows) is written when non-null, ser (N + 1 energies) when
// kSeries. Shared memory: u[mg], v[mg], w[mg], red[32].
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
      v[j] = lin * uj + c2 * uj * uj + c3 * uj * uj * uj;
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
      for (int k = lane; k < mg4; k += 32) {
        const float4 bb = __ldg(row + k);
        const float4 vv = v4[k];
        s += bb.x * vv.x + bb.y * vv.y + bb.z * vv.z + bb.w * vv.w;
      }
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

// Backward: lambda_N = s w u_N, then for n = N-1..0
//   lambda_n = (lin + 2 c2 u_n + 3 c3 u_n^2) * (B^T lambda_{n+1}) + s w u_n,
// with s = *scale and u_n = traj row n. Thread (p, cg) sums rows
// p, p + P, ... of column group cg (4 columns, one float4); the P
// partial sums meet in shared memory.
// Shared memory: lam[mg], part[P * mg] (P * mg = 4 * active threads).
__global__ void __launch_bounds__(kThreads)
fused_bwd_shared_kernel(const float* __restrict__ b, const float* __restrict__ w,
                        const float* __restrict__ uT, const float* __restrict__ traj,
                        float c2, float c3, float lin, const float* __restrict__ scale,
                        int n_steps, int mg, float* __restrict__ lam_out) {
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

  for (int j = tid; j < mg; j += kThreads) lam[j] = s * (w[j] * uT[j]);
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    const float* urow = traj + (size_t)(n_steps - 1 - k) * mg;
    if (active) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = p; i < mg; i += P) {
        const float4 bb = __ldg(b4 + (size_t)i * ncg + cg);
        const float l = lam[i];
        a.x += bb.x * l;
        a.y += bb.y * l;
        a.z += bb.z * l;
        a.w += bb.w * l;
      }
      part4[p * ncg + cg] = a;
    }
    __syncthreads();  // all lam reads done, partials ready
    for (int j = tid; j < mg; j += kThreads) {
      float wb = 0.f;
      for (int q = 0; q < P; ++q) wb += part[q * mg + j];
      const float un = urow[j];
      const float vprime = lin + 2.f * c2 * un + 3.f * c3 * un * un;
      lam[j] = vprime * wb + s * (w[j] * un);
    }
    __syncthreads();
  }
  for (int j = tid; j < mg; j += kThreads) lam_out[j] = lam[j];
}

}  // namespace

extern "C" {

int sm_fused_fwd_shared(const float* b, const float* w, const float* u0, float c2,
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
                        void* stream) {
  const int ncg = mg / 4;
  const int P = kThreads / ncg;
  const size_t smem = ((size_t)mg + 4 * (size_t)P * ncg) * sizeof(float);
  fused_bwd_shared_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, w, uT, traj, c2, c3, lin, scale, n_steps, mg, lam_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
