// Fused dense forward for Hopper (sm_90a): out = act(x @ w + b).
//
// Replaces the TPU kernel src/repro/kernels/dense.py::_dense_fwd_kernel
// (pallas_call in _forward; entry dense_pallas, dispatched by
// src/repro/kernels/ops.py::dense).  Same contract: x (M, K) and w (K, N)
// row-major, b (N,) optional, f32 accumulation, bias + relu fused into the
// epilogue, output in x's dtype.
//
// Two instances behind a plain C interface (built with nvcc, loaded with
// ctypes by repro_torch/kernels/build.py):
//   * dense_fwd_bf16: bf16 operands on the tensor cores through
//     nvcuda::wmma 16x16x16 fragments with f32 accumulators.  This is the
//     LM serving path: every q/k/v/o and MLP projection.
//   * dense_fwd_f32: plain FMA on the CUDA cores, no TF32, so it agrees
//     with a full-f32 reference (the CNN path and the tests).  Its body is
//     the split-K product of gemm_f32.cuh, shared with K2 (dense_bwd.cu).
//
// What bounds it.  Serving decodes M = 4 rows (one per cache slot) through
// weights that are read once per step: the work is 2 flops per weight
// byte pair, far below the ~295 flop/byte where the H100's bf16 tensor
// cores become the limit.  One Yi-6B decode step moves 11.07 GB of bf16
// projection weights, at least 3.3 ms at 3.35 TB/s.  Per launch:
//   (4096 -> 11008): 90.2 MB, at least 26.9 us;
//   (4096 ->  4096): 33.6 MB, at least 10.0 us;
//   (4096 ->   512):  4.2 MB, at least 1.25 us.
// Prefill (M <= 24) is bound the same way.
//
// What the design does about it.  Each block owns one BM x 64 output tile
// and streams its 64-column weight panel through shared memory exactly
// once, in 16-byte vector loads (neighbouring threads on neighbouring
// addresses) whenever the row strides and pointers allow, so device
// memory sees each weight byte once per launch.  Rows are tiled at
// BM = 16 when M <= 16, so a decode step does not waste shared memory and
// tensor-core work on 60 empty rows of a 64-row tile.  The K loop is
// synchronous (load, barrier, multiply): few bytes are in flight per SM
// and narrow layers launch few blocks, so this kernel sits well above the
// bound.  cp.async/TMA pipelining, wgmma and a split-K shape for M = 4
// are later work.
//
// The f32 instance trains the CNN's FC stack at M = 64 rows: (64, 192,
// 2000), five of (64, 2000, 2000) and (64, 2000, 10) a step.  At (64,
// 2000, 2000) a launch does 0.512 GFLOP (7.6 us at the 67 TFLOP/s f32 FMA
// peak) against 16.5 MB of operands (4.9 us at 3.35 TB/s): the FMA rate
// bounds it.  One 64 x 64 tile per block gave 32 blocks for 132 SMs, each
// walking K = 2000 in 125 synchronous steps, so the card sat idle waiting
// on memory.  Now the reduction is split over K across blocks
// (gemm_f32.cuh): `splits` slices, chosen from the shapes by
// kernels/dense.py dense_splits (8 at (64, 2000, 2000): 256 blocks, two
// an SM), each filling a two-stage cp.async ring while it multiplies;
// pass 2 adds the slices' partials in slice order and applies bias and
// relu (pass 1 does that itself when splits == 1).  The tensor cores stay
// out: TF32 keeps about three decimal digits and would miss the 1e-5
// x max|ref| gate of a forward; a 3xTF32 split is later work.
//
// Ragged M, N and K are handled by masked loads (zero fill) and a masked
// epilogue store.  b may be null.  Each entry point returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_f32.cuh"

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int kWarps = 4;
constexpr int kThreadsBf16 = 32 * kWarps;
constexpr int kBN = 16 * kWarps;  // one 16-column fragment strip per warp
constexpr int kBK = 64;
constexpr int kPadH = 8;          // bf16 pad: rows stay 16-byte aligned
constexpr int kPadF = 4;          // f32 pad of the epilogue tile

template <int BM>
__global__ void __launch_bounds__(kThreadsBf16)
dense_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ b,
                      __nv_bfloat16* __restrict__ out,
                      int M, int N, int K, int relu, int vec) {
  constexpr int FM = BM / 16;
  __shared__ __align__(128) __nv_bfloat16 xs[BM][kBK + kPadH];
  __shared__ __align__(128) __nv_bfloat16 ws[kBK][kBN + kPadH];
  __shared__ __align__(128) float cs[BM][kBN + kPadF];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile (BM x kBK), in chunks of 8 along K
    for (int c = tid; c < BM * kBK / 8; c += kThreadsBf16) {
      const int r = c / (kBK / 8);
      const int kc = (c % (kBK / 8)) * 8;
      const int gr = m0 + r;
      const int gk = k0 + kc;
      __nv_bfloat16* dst = &xs[r][kc];
      if (vec && gr < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gk + e < K) ? x[(size_t)gr * K + gk + e] : zero;
      }
    }
    // w tile (kBK x kBN), in chunks of 8 along N
    for (int c = tid; c < kBK * kBN / 8; c += kThreadsBf16) {
      const int r = c / (kBN / 8);
      const int nc = (c % (kBN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      __nv_bfloat16* dst = &ws[r][nc];
      if (vec && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, &ws[kk][warp * 16], kBN + kPadH);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, &xs[i * 16][kk], kBK + kPadH);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
    wmma::store_matrix_sync(&cs[i * 16][warp * 16], acc[i], kBN + kPadF,
                            wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * kBN; c += kThreadsBf16) {
    const int r = c / kBN;
    const int n = c % kBN;
    const int gr = m0 + r;
    const int gn = n0 + n;
    if (gr < M && gn < N) {
      float v = cs[r][n];
      if (b != nullptr) v += b[gn];
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)gr * N + gn] = __float2bfloat16(v);
    }
  }
}

// ---------------------------------------------------------------- f32
// The two passes of gemm_f32.cuh under K1's names (w read as (K, N)).
__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mask,
                     const float* __restrict__ b, float* __restrict__ part,
                     float* __restrict__ out, int M, int N, int K, int relu,
                     int splits, int depth, int vecA, int vecB) {
  gemm_f32::splitk_tile<false, false>(x, w, mask, b, part, out, M, N, K,
                                      relu, splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_fwd_f32_sum_kernel(const float* __restrict__ part,
                         const float* __restrict__ b, float* __restrict__ out,
                         int M, int N, int relu, int splits) {
  gemm_f32::splitk_sum(part, b, out, M, N, relu, splits);
}

}  // namespace

extern "C" int dense_fwd_bf16(const void* x, const void* w, const void* b,
                              void* out, int M, int N, int K, int relu,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (N % 8 == 0) &&
                  ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= 16) {
    dim3 grid((N + kBN - 1) / kBN, 1);
    dense_fwd_bf16_kernel<16><<<grid, kThreadsBf16, 0, s>>>(
        xp, wp, bp, op, M, N, K, relu, vec);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64);
    dense_fwd_bf16_kernel<64><<<grid, kThreadsBf16, 0, s>>>(
        xp, wp, bp, op, M, N, K, relu, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int dense_fwd_f32(const void* x, const void* w, const void* b,
                             void* part, void* out, int M, int N, int K,
                             int relu, int splits, int depth, void* stream) {
  return gemm_f32::splitk_launch<false>(
      dense_fwd_f32_kernel, dense_fwd_f32_sum_kernel,
      static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
      static_cast<const float*>(b), static_cast<float*>(part),
      static_cast<float*>(out), M, N, K, relu, splits, depth,
      static_cast<cudaStream_t>(stream));
}
