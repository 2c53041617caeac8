// Operator cotangents of the fused reverse sweeps, as one product over all
// SMs:
//
//   out[r, c] = sum_n lam_hist[n, r] * f(traj[n, c])
//
// Replaces the op_grads=True branches of the TPU (Pallas) kernels of the
// JAX package's ops/pallas/fused_two_matrix.py:
//   shared mode     <- _bwd_kernel_shared (:203-206): dB += lambda_{n+1} (x) v(u_n),
//                      v(u) = lin u + c2 u^2 + c3 u^3, one output
//   two-matrix mode <- _bwd_kernel (:125-129): dA += lambda_{n+1} (x) u_n and
//                      dB += lambda_{n+1} (x) g(u_n), g(u) = c2 u^2 + c3 u^3,
//                      two outputs from one pass over the tiles
// lam_hist (N, mg) is the history that the reverse-sweep kernels store
// with their kLamHist flag (row n = lambda_{n+1}); traj (N, mg) is the
// forward trajectory (row n = u_n).
//
// Why not the TPU's design: the TPU kernel adds an (mg, mg) outer product
// into a VMEM-resident cotangent at every step. On Hopper that is a
// read-modify-write of 1 MiB (2 MiB with two outputs) a step from the one
// SM that runs the sweep, which would double the sweep. The sum over the
// steps is a matrix product, Lambda^T f(U), and this kernel runs it after
// the sweep over the whole card.
//
// What bounds it on an H100: operations. 2 mg^2 N flop per output (0.52
// GFLOP for SH23, mg = 512, N = 1000: 7.8 us at the 67 TFLOP/s f32 peak;
// 2.1 GFLOP for SHB23's pair, N = 2000: 31 us) against 5 and 10 MB of
// traffic (1.5 and 3 us at 3.35 TB/s). The design: a plain tiled f32
// product with FMA in f32 (no TF32, as every parity check of the port
// assumes): 64 x 64 output tiles, 256 threads with a 4 x 4 register tile
// each, 16 steps of Lambda and f(U) a stage in shared memory, f applied
// as the U tile is loaded. 512 x 512 outputs give only 64 tiles for 132
// SMs, so N is split over blocks (about two blocks per SM) and a second,
// fixed-order pass sums the split partials: the result repeats bit for
// bit, with no atomics. wgmma/TMA are for a later, faster version.
//
// sm_op_grads launches both passes on the given stream, does not
// synchronise, and returns cudaGetLastError(). The caller guarantees
// mg % 128 == 0, 128 <= mg <= 2048, contiguous f32 buffers on one device,
// and `part` of sm_op_grads_splits(mg, n_steps) * n_out * mg * mg floats.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;         // output tile: kTile x kTile
constexpr int kBK = 16;           // steps per shared-memory stage
constexpr int kOpThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTargetBlocks = 264;  // about two blocks on each of 132 SMs

// Steps per split: enough splits for kTargetBlocks blocks, a multiple of kBK.
int chunk_of(int mg, int n_steps) {
  const int tiles = (mg / kTile) * (mg / kTile);
  const int want = (kTargetBlocks + tiles - 1) / tiles;
  int chunk = (n_steps + want - 1) / want;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  return chunk > kBK ? chunk : kBK;
}

int splits_of(int mg, int n_steps) {
  const int chunk = chunk_of(mg, n_steps);
  const int s = (n_steps + chunk - 1) / chunk;
  return s > 1 ? s : 1;
}

__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 f) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], f.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], f.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], f.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], f.w, acc[i][3]);
  }
}

__device__ __forceinline__ void store4(float* out, int mg, int r, int c,
                                       const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(r + i) * mg + c) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// Block (x, y, z) sums steps [z chunk, (z + 1) chunk) of output tile
// (rows y kTile.., columns x kTile..) into part[z] (kTwo: part[z][0] for
// u, part[z][1] for g(u); else part[z] for v(u)).
template <bool kTwo>
__global__ void __launch_bounds__(kOpThreads)
op_grads_kernel(const float* __restrict__ lam, const float* __restrict__ traj,
                int n_steps, int mg, int chunk, float c2, float c3, float lin,
                float* __restrict__ part) {
  __shared__ __align__(16) float ls[kBK][kTile];
  __shared__ __align__(16) float fs[kBK][kTile];   // v(u), or u (kTwo)
  __shared__ __align__(16) float gs[kTwo ? kBK : 1][kTile];  // g(u) (kTwo)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int n0 = blockIdx.z * chunk;
  const int n1 = min(n_steps, n0 + chunk);
  const int lr = tid / 16, lc = (tid % 16) * 4;   // this thread's load: 4 floats
  float acc[4][4] = {}, acg[4][4] = {};

  for (int nb = n0; nb < n1; nb += kBK) {
    const int n = nb + lr;
    float4 l = make_float4(0.f, 0.f, 0.f, 0.f), u = l;
    if (n < n1) {   // rows past the chunk's end load as 0: f(0) = 0
      l = __ldg(reinterpret_cast<const float4*>(lam + (size_t)n * mg + r0 + lc));
      u = __ldg(reinterpret_cast<const float4*>(traj + (size_t)n * mg + c0 + lc));
    }
    *reinterpret_cast<float4*>(&ls[lr][lc]) = l;
    const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = uv[j];
      if constexpr (kTwo) {
        fs[lr][lc + j] = x;
        gs[lr][lc + j] = c2 * x * x + c3 * x * x * x;
      } else {
        fs[lr][lc + j] = lin * x + c2 * x * x + c3 * x * x * x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ls[kk][ty * 4]);
      outer4(acc, a, *reinterpret_cast<const float4*>(&fs[kk][tx * 4]));
      if constexpr (kTwo)
        outer4(acg, a, *reinterpret_cast<const float4*>(&gs[kk][tx * 4]));
    }
    __syncthreads();
  }

  const size_t mm = (size_t)mg * mg;
  float* out = part + (size_t)blockIdx.z * (kTwo ? 2 : 1) * mm;
  store4(out, mg, r0 + ty * 4, c0 + tx * 4, acc);
  if constexpr (kTwo) store4(out + mm, mg, r0 + ty * 4, c0 + tx * 4, acg);
}

// out[e] = sum_{s = 0..splits-1} part[s][e], in that order, e < n4 float4s.
__global__ void op_grads_reduce(const float4* __restrict__ part, int splits,
                                size_t n4, float4* __restrict__ out) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[e];
    for (int z = 1; z < splits; ++z) {
      const float4 p = part[(size_t)z * n4 + e];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[e] = s;
  }
}

}  // namespace

extern "C" {

// Number of N-splits (the leading extent of the `part` workspace).
int sm_op_grads_splits(int mg, int n_steps) { return splits_of(mg, n_steps); }

// two != 0: out[0] = sum_n lam_n (x) u_n, out[1] = sum_n lam_n (x) g(u_n);
// else out[0] = sum_n lam_n (x) v(u_n). out holds n_out (mg, mg) matrices.
int sm_op_grads(const float* lam_hist, const float* traj, int n_steps, int mg,
                int two, float c2, float c3, float lin, float* part, float* out,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = chunk_of(mg, n_steps), splits = splits_of(mg, n_steps);
  const dim3 grid(mg / kTile, mg / kTile, splits);
  if (two)
    op_grads_kernel<true><<<grid, kOpThreads, 0, st>>>(lam_hist, traj, n_steps, mg,
                                                       chunk, c2, c3, lin, part);
  else
    op_grads_kernel<false><<<grid, kOpThreads, 0, st>>>(lam_hist, traj, n_steps, mg,
                                                        chunk, c2, c3, lin, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n4 = (two ? 2 : 1) * (size_t)mg * mg / 4;
  op_grads_reduce<<<264, 256, 0, st>>>(reinterpret_cast<const float4*>(part), splits,
                                       n4, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
