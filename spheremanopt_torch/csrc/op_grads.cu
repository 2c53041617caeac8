// Operator cotangents of the fused reverse sweeps, as one product over all
// SMs on the tensor cores:
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
// GFLOP for SH23, mg = 512, N = 1000; 2.1 GFLOP for SHB23's pair, N =
// 2000) against 5 and 10 MB of traffic (1.5 and 3 us at 3.35 TB/s). In
// f32 outside the tensor cores (67 TFLOP/s) that is 7.8 and 31 us, and
// cuBLAS's f32 GEMM gets more out of that pipe than a hand-written SIMT
// kernel does. The tensor cores take TF32 (495 TFLOP/s), which keeps 10
// mantissa bits; the port keeps f32 accuracy (allow_tf32 stays False), so
// the product is run as 3xTF32: each operand x is split into
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi),
// and the tensor cores accumulate lo*hi + hi*lo + hi*hi in f32 (the
// small terms first; lo*lo, ~2^-22 relative, is dropped). Three TF32
// products: 3 * 2 mg^2 N n_out / 495 TFLOP/s = 3.2 us (SH23) and 12.7 us
// (SHB23's pair).
//
// The design:
//   * mma.sync.m16n8k8.tf32 (not wgmma): wgmma takes TF32 operands only
//     K-major from shared memory, behind descriptors and a swizzle, while
//     both operands here are stored MN-major (the step is the slow
//     index). mma.sync reads its fragments from an MN-major tile directly
//     (a padded row of 136 floats puts the 32 lanes of a fragment load on
//     32 banks), so the tiles need no transpose.
//   * 128 x 128 output tiles, 256 threads (8 warps as 2 x 4, 64 x 32 each:
//     4 x 4 m16n8 accumulators of 4 floats), 16 steps a stage, two stages:
//     the next stage's tiles are loaded into registers while the tensor
//     cores run on the current one, then f is applied, the values are
//     split into hi and lo and stored to the other stage's buffers.
//   * a stage's six products per tile sum into a fresh accumulator that
//     is then added to the running sum in f32 (round to nearest): the
//     tensor cores' own f32 accumulation does not round to nearest, and
//     a chain of ~190 products per tile (SHB23: 500 steps a block) let
//     its error grow to ~1e-5 of the largest entry against ~1e-6 for the
//     f32 loop.
//   * two-matrix mode: a tile's 128 columns are 64 columns of u and the
//     same 64 of g(u), so one Lambda tile feeds both dA and dB.
//   * 512 x 512 outputs give 16 (shared) or 32 (two-matrix) tiles for 132
//     SMs, so N is split over blocks, about one block on each SM, and a
//     second, fixed-order pass sums the split partials: no atomics, and
//     the result repeats bit for bit. The split (chunk, splits) comes
//     from the caller (ops/cuda/fused_two_matrix.py, op_grads_split).
//
// sm_op_grads launches both passes on the given stream (one when splits
// is 1: the product then writes `out` itself), does not synchronise, and
// returns cudaGetLastError(). The caller guarantees mg % 128 == 0,
// 128 <= mg <= 2048, chunk % 16 == 0, splits = ceil(n_steps / chunk),
// contiguous f32 buffers on one device, and `part` of
// splits * n_out * mg * mg floats when splits > 1.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;          // output tile rows (r)
constexpr int kBN = 128;          // output tile columns (c; two-matrix: 64 of u, 64 of g)
constexpr int kBK = 16;           // steps per shared-memory stage
constexpr int kPad = 8;           // row pad: fragment loads hit 32 distinct banks
constexpr int kLd = kBM + kPad;   // 136 floats a staged row (kBM == kBN)
constexpr int kOpThreads = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWM = 64, kWN = 32; // a warp's output tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kStageFloats = 4 * kBK * kLd;   // A hi, A lo, B hi, B lo
constexpr size_t kSmemBytes = 2 * kStageFloats * sizeof(float);

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ ~2^-22 x): both TF32 values, stored as f32 bit patterns.
__device__ __forceinline__ void split4(const float4 x, float* hi, float* lo) {
  const float xv[4] = {x.x, x.y, x.z, x.w};
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __uint_as_float(to_tf32(xv[i]));
    l[i] = __uint_as_float(to_tf32(xv[i] - h[i]));
  }
  *reinterpret_cast<float4*>(hi) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo) = make_float4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage's global loads, held in registers until they are staged:
// two float4 of Lambda (16 steps x 128 rows) and two of the trajectory
// (shared: 16 x 128 columns; two-matrix: one float4, 16 x 64 columns).
struct StageRegs {
  float4 l[2], u[2];
};

template <bool kTwo>
__device__ __forceinline__ void load_stage(StageRegs& s, const float* __restrict__ lam,
                                           const float* __restrict__ traj, int mg,
                                           int r0, int c0, int nb, int n1) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kOpThreads, row = i / 32, col = (i % 32) * 4;
    const int n = nb + row;
    s.l[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n1)   // rows past the chunk's end load as 0: f(0) = 0
      s.l[j] = __ldg(reinterpret_cast<const float4*>(lam + (size_t)n * mg + r0 + col));
  }
  if constexpr (kTwo) {
    const int row = tid / 16, col = (tid % 16) * 4, n = nb + row;
    s.u[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n1)
      s.u[0] = __ldg(reinterpret_cast<const float4*>(traj + (size_t)n * mg + c0 + col));
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kOpThreads, row = i / 32, col = (i % 32) * 4;
      const int n = nb + row;
      s.u[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < n1)
        s.u[j] = __ldg(reinterpret_cast<const float4*>(traj + (size_t)n * mg + c0 + col));
    }
  }
}

__device__ __forceinline__ float4 map4(const float4 x, float a1, float a2, float a3) {
  // a1 x + a2 x^2 + a3 x^3, elementwise: v(u) (a1 = lin) or g(u) (a1 = 0)
  const float xv[4] = {x.x, x.y, x.z, x.w};
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = a1 * xv[i] + a2 * xv[i] * xv[i] + a3 * xv[i] * xv[i] * xv[i];
  return make_float4(y[0], y[1], y[2], y[3]);
}

// f applied, split, stored: stage buffer = [A hi | A lo | B hi | B lo],
// each kBK rows of kLd floats (row = step, column = r or c in the tile).
template <bool kTwo>
__device__ __forceinline__ void store_stage(const StageRegs& s, float* stage, float c2,
                                            float c3, float lin) {
  float* ahi = stage;
  float* alo = ahi + kBK * kLd;
  float* bhi = alo + kBK * kLd;
  float* blo = bhi + kBK * kLd;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kOpThreads, o = (i / 32) * kLd + (i % 32) * 4;
    split4(s.l[j], ahi + o, alo + o);
  }
  if constexpr (kTwo) {
    const int o = (tid / 16) * kLd + (tid % 16) * 4;
    split4(s.u[0], bhi + o, blo + o);                     // u: tile columns 0..63
    const float4 g = map4(s.u[0], 0.f, c2, c3);
    split4(g, bhi + o + kBN / 2, blo + o + kBN / 2);      // g(u): columns 64..127
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kOpThreads, o = (i / 32) * kLd + (i % 32) * 4;
      split4(map4(s.u[j], lin, c2, c3), bhi + o, blo + o);   // v(u)
    }
  }
}

// Block (x, y, z) sums steps [z chunk, (z + 1) chunk) of output tile
// (rows y kBM.., tile columns x) into dst (part[z], or out when there is
// one split). Shared: columns x kBN.. of the one output. Two-matrix:
// columns x kBN/2.. of output 0 (u) and of output 1 (g(u)).
template <bool kTwo>
__global__ void __launch_bounds__(kOpThreads, 1)
op_grads_tc_kernel(const float* __restrict__ lam, const float* __restrict__ traj,
                   int n_steps, int mg, int chunk, float c2, float c3, float lin,
                   float* __restrict__ dst) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;   // warp tile origin
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * (kTwo ? kBN / 2 : kBN);
  const int n0 = blockIdx.z * chunk;
  const int n1 = min(n_steps, n0 + chunk);
  float acc[kMT][kNT][4] = {};

  StageRegs regs;
  load_stage<kTwo>(regs, lam, traj, mg, r0, c0, n0, n1);
  store_stage<kTwo>(regs, smem, c2, c3, lin);
  __syncthreads();

  const int n_stages = (n1 - n0 + kBK - 1) / kBK;
  for (int st = 0; st < n_stages; ++st) {
    const bool more = st + 1 < n_stages;
    float part[kMT][kNT][4] = {};   // this stage's sums, on the tensor cores
    if (more) load_stage<kTwo>(regs, lam, traj, mg, r0, c0, n0 + (st + 1) * kBK, n1);
    const float* cur = smem + (st & 1) * kStageFloats;
    const float* ahi = cur;
    const float* alo = ahi + kBK * kLd;
    const float* bhi = alo + kBK * kLd;
    const float* blo = bhi + kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int k0 = (kk + t) * kLd, k4 = (kk + t + 4) * kLd;
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = wn + nt * 8 + g;
        bh[nt][0] = __float_as_uint(bhi[k0 + c]);
        bh[nt][1] = __float_as_uint(bhi[k4 + c]);
        bl[nt][0] = __float_as_uint(blo[k0 + c]);
        bl[nt][1] = __float_as_uint(blo[k4 + c]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm + mt * 16 + g;
        const uint32_t ah[4] = {__float_as_uint(ahi[k0 + r]), __float_as_uint(ahi[k0 + r + 8]),
                                __float_as_uint(ahi[k4 + r]), __float_as_uint(ahi[k4 + r + 8])};
        const uint32_t al[4] = {__float_as_uint(alo[k0 + r]), __float_as_uint(alo[k0 + r + 8]),
                                __float_as_uint(alo[k4 + r]), __float_as_uint(alo[k4 + r + 8])};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {   // small terms first
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    if (more) store_stage<kTwo>(regs, smem + ((st + 1) & 1) * kStageFloats, c2, c3, lin);
    __syncthreads();
  }

  // accumulator (mt, nt): rows wm + 16 mt + g (+ 8), columns wn + 8 nt + 2 t (+ 1)
  const size_t mm = (size_t)mg * mg;
  float* out = dst + (size_t)blockIdx.z * (kTwo ? 2 : 1) * mm;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    int col = wn + nt * 8 + 2 * t;
    float* o = out;
    if constexpr (kTwo) {
      if (col >= kBN / 2) {
        o += mm;
        col -= kBN / 2;
      }
    }
    col += c0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = r0 + wm + mt * 16 + g;
      *reinterpret_cast<float2*>(o + (size_t)r * mg + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + (size_t)(r + 8) * mg + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
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

template <bool kTwo>
cudaError_t launch_product(const float* lam, const float* traj, int n_steps, int mg,
                           int chunk, int splits, float c2, float c3, float lin,
                           float* dst, cudaStream_t st) {
  const auto kernel = op_grads_tc_kernel<kTwo>;
  static bool ready[smo::kMaxDevices] = {};
  const cudaError_t err = smo::set_once(ready, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmemBytes));
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((kTwo ? 2 : 1) * mg / kBN, mg / kBM, splits);
  kernel<<<grid, kOpThreads, kSmemBytes, st>>>(lam, traj, n_steps, mg, chunk, c2, c3,
                                               lin, dst);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// two != 0: out[0] = sum_n lam_n (x) u_n, out[1] = sum_n lam_n (x) g(u_n);
// else out[0] = sum_n lam_n (x) v(u_n). out holds n_out (mg, mg) matrices.
int sm_op_grads(const float* lam_hist, const float* traj, int n_steps, int mg,
                int two, float c2, float c3, float lin, int chunk, int splits,
                float* part, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? part : out;
  const cudaError_t err =
      two ? launch_product<true>(lam_hist, traj, n_steps, mg, chunk, splits, c2, c3, lin,
                                 dst, st)
          : launch_product<false>(lam_hist, traj, n_steps, mg, chunk, splits, c2, c3, lin,
                                  dst, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = (two ? 2 : 1) * (size_t)mg * mg / 4;
  op_grads_reduce<<<264, 256, 0, st>>>(reinterpret_cast<const float4*>(part), splits,
                                       n4, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
