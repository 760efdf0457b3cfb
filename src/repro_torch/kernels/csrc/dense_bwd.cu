// Dense backward for Hopper (sm_90a): K2 (input gradient) and K3 (weight
// and bias gradient) of the fused dense layer, in f32.
//
// Replaces the TPU kernels of src/repro/kernels/dense.py:
//   * _dense_dx_kernel (pallas_call in _backward_dx): dx = g @ w^T;
//   * _dense_dwdb_kernel (pallas_call in _backward_dwdb): dw = x^T g and
//     db = sum over rows of g, one task per output-neuron block, f32
//     outputs.
// The relu mask that _dense_bwd applies to g before both calls
// (g * (out > 0), out being the saved forward output) is folded into the
// loads here: `mask` is that output, or null for no activation.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py).  Each entry point returns cudaGetLastError() after its
// launch and never synchronises.  Operands are row-major f32: g (M, Dout),
// w (Din, Dout), x (M, Din).  All f32 FMA on the CUDA cores with f32
// accumulation, no TF32: the reference's gradient gate is 1e-4 x scale.
//
// What bounds them.  The CNN's FC stack trains at M = 64 rows: each
// gradient launch does 2 x 64 x Din x Dout flops over a Din x Dout weight
// (or weight gradient) of 4 bytes an element, 32 flops per weight byte,
// above the 20 flops a byte where the H100's f32 FMA peak (67 TFLOP/s)
// meets its memory rate (3.35 TB/s).  At (2000 -> 2000) a launch moves
// 16.5 MB (4.9 us) and does 0.51 GFLOP (7.6 us): the f32 FMA rate bounds
// both kernels at the hidden widths.
//
// What the design does about it.
//   * K2 is the split-K product of gemm_f32.cuh, shared with K1's f32
//     instance (dense_fwd.cu), with B(k, n) = w[n][k]: w^T read by index
//     in 16-byte copies along Dout, so no transposed copy is made.  The
//     reduction (Dout) is split across blocks into `splits` slices, chosen
//     from the shapes by kernels/dense.py dense_splits (8 at 2000 -> 2000:
//     256 blocks where one tile a block gave 32; 14 for the 192-wide dx of
//     the first FC layer, 42 blocks where it had 3), each slice filling a
//     two-stage cp.async ring while it multiplies.  The relu mask rides
//     along: the mask tile is copied beside g's and each thread zeroes its
//     own chunk of g where the mask is not > 0 before the block reads it.
//     Pass 2 adds the slices' partials in slice order: no atomics, and a
//     rerun gives identical bits.
//   * K3 contracts over only 64 rows while its output is up to 2000 x
//     2000, so it tiles the OUTPUT (64 x 64 per block, 1024 blocks at
//     2000 x 2000) and walks the rows inside the block, 16 at a time.  The
//     blocks of the first row of tiles also sum g's rows for db, so one
//     launch writes both outputs.
// Neither uses the tensor cores: TF32 keeps about three decimal digits and
// would break the 1e-4 gradient gate (a 3xTF32 split is later work).  K3
// does not pipeline its loads and sits above its bound.  Ragged M, Din and
// Dout are masked loads with zero fill and a masked store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_f32.cuh"

namespace {

constexpr int kB = 64;        // 64 x 64 output tile
constexpr int kBK = 16;       // reduction step through shared memory
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float masked(const float* __restrict__ g,
                                        const float* __restrict__ mask,
                                        size_t i) {
  const float v = g[i];
  return (mask == nullptr || mask[i] > 0.0f) ? v : 0.0f;
}

// K2: dx (M, Din) = (g masked) @ w^T, the reduction over Dout: the two
// passes of gemm_f32.cuh under K2's names.
__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ mask, const float* __restrict__ bias,
                float* __restrict__ part, float* __restrict__ dx, int M,
                int Din, int Dout, int relu, int splits, int depth, int vecA,
                int vecB) {
  gemm_f32::splitk_tile<true, true>(g, w, mask, bias, part, dx, M, Din, Dout,
                                    relu, splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dx_sum_kernel(const float* __restrict__ part,
                    const float* __restrict__ bias, float* __restrict__ dx,
                    int M, int Din, int relu, int splits) {
  gemm_f32::splitk_sum(part, bias, dx, M, Din, relu, splits);
}

// K3: dw (Din, Dout) = x^T (g masked); db (Dout) = sum_m (g masked).
// Block (blockIdx.x, blockIdx.y) owns dw[k0 : k0+64, n0 : n0+64].
__global__ void __launch_bounds__(kThreads)
dense_dwdb_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mask, float* __restrict__ dw,
                  float* __restrict__ db, int M, int Din, int Dout) {
  __shared__ float xs[kBK][kB];  // xs[m][k] = x[m0 + m][k0 + k]
  __shared__ float gs[kBK][kB];  // gs[m][n] = g[m0 + m][n0 + n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.y * kB;
  const int n0 = blockIdx.x * kB;
  const bool sums_db = blockIdx.y == 0 && ty == 0;
  float acc[4][4] = {};
  float dbacc[4] = {};

  for (int m0 = 0; m0 < M; m0 += kBK) {
    for (int c = tid; c < kBK * kB; c += kThreads) {
      const int m = c / kB;
      const int k = c % kB;
      const int gm = m0 + m;
      const int gk = k0 + k;
      xs[m][k] = (gm < M && gk < Din) ? x[(size_t)gm * Din + gk] : 0.0f;
    }
    for (int c = tid; c < kBK * kB; c += kThreads) {
      const int m = c / kB;
      const int n = c % kB;
      const int gm = m0 + m;
      const int gn = n0 + n;
      gs[m][n] = (gm < M && gn < Dout)
                     ? masked(g, mask, (size_t)gm * Dout + gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kBK; ++m) {
      float a[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[m][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bg[j] = gs[m][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bg[j], acc[i][j]);
      if (sums_db) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dbacc[j] += bg[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gk < Din && gn < Dout) dw[(size_t)gk * Dout + gn] = acc[i][j];
    }
  }
  if (sums_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < Dout) db[gn] = dbacc[j];
    }
  }
}

}  // namespace

extern "C" int dense_dx_f32(const void* g, const void* w, const void* mask,
                            void* part, void* dx, int M, int Din, int Dout,
                            int splits, int depth, void* stream) {
  return gemm_f32::splitk_launch<true>(
      dense_dx_kernel, dense_dx_sum_kernel, static_cast<const float*>(g),
      static_cast<const float*>(w), static_cast<const float*>(mask), nullptr,
      static_cast<float*>(part), static_cast<float*>(dx), M, Din, Dout, 0,
      splits, depth, static_cast<cudaStream_t>(stream));
}

extern "C" int dense_dwdb_f32(const void* x, const void* g, const void* mask,
                              void* dw, void* db, int M, int Din, int Dout,
                              void* stream) {
  if (M <= 0 || Din <= 0 || Dout <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Dout + kB - 1) / kB, (Din + kB - 1) / kB);
  dense_dwdb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mask), static_cast<float*>(dw),
      static_cast<float*>(db), M, Din, Dout);
  return (int)cudaGetLastError();
}
