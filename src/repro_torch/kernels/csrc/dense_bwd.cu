// Dense backward for Hopper (sm_90a): K2 (input gradient) and K3 (weight
// and bias gradient) of the fused dense layer, in f32.
//
// Replaces the TPU kernels of src/repro/kernels/dense.py:
//   * _dense_dx_kernel (pallas_call in _backward_dx): dx = g @ w^T;
//   * _dense_dwdb_kernel (pallas_call in _backward_dwdb): dw = x^T g and
//     db = sum over rows of g, one task per output-neuron block, f32
//     outputs.
// The relu mask that _dense_bwd applies to g before both calls
// (g * (out > 0), out being the saved forward output) is staged beside g
// and applied in shared memory: `mask` is that output, or null for no
// activation.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py).  Each entry point returns cudaGetLastError() after its
// launches and never synchronises.  Operands are row-major f32: g (M,
// Dout), w (Din, Dout), x (M, Din).  All f32 FMA on the CUDA cores with
// f32 accumulation, no TF32: the reference's gradient gate is 1e-4 x
// scale.
//
// What bounds them.  The CNN's FC stack trains at M = 64 rows: each
// launch does 2 x 64 x Din x Dout flops over a Din x Dout weight (K2) or
// weight gradient (K3) of 4 bytes an element.  At 2000 -> 2000 that is
// 0.51 GFLOP (7.6 us at 67 TFLOP/s) against 16.5 MB (4.9 us at 3.35
// TB/s): the f32 FMA rate bounds both.  K3's reduction is only the 64
// rows, so its time is the 16 MB gradient written after a short product.
//
// What the design does about it.  Both are instances of the split-K tile
// product in gemm_f32.cuh (shared with K1's f32 instance), under their
// own kernel names:
//   * K2: C (M, Din) = (g masked) w^T, w^T read by index in 16-byte
//     copies along Dout, the reduction (Dout) split into slices chosen by
//     kernels/dense.py dense_splits so the blocks fill the card;
//   * K3: C (Din + 1, Dout) = [x, 1]^T (g masked): x^T read by index in
//     16-byte copies along Din, a virtual row of ones after x's last
//     column, so row Din of C is db, summed in the same fixed order as dw
//     with no branch in the inner loop; rows 0 .. Din - 1 are dw.  The
//     launcher's (Din + 1, Dout) output holds both as contiguous views.
//     Its 64-row reduction is one slice at case7 (dense.dwdb_splits); a
//     long reduction on a small output splits.
// Pass 2 adds the slices' partials in slice order: no atomics, and a
// rerun gives identical bits.  Ragged M, Din and Dout are loaded element
// by element with zero fill and stored masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_f32.cuh"

namespace {

// K2: dx (M, Din) = (g masked) @ w^T, the reduction over Dout.
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

// K3: dwdb (Din + 1, Dout) = [x, 1]^T (g masked), the reduction over the
// M rows; here rows = Din + 1 and K = M.  Two register tiles (gemm_f32.cuh
// AtTile): 64 x 64, and 128 x 64 for outputs of 528 64 x 64 tiles or more.
__global__ void __launch_bounds__(gemm_f32::AtTile<false>::kThreads)
dense_dwdb_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mask, float* __restrict__ part,
                  float* __restrict__ dwdb, int rows, int Dout, int M,
                  int splits, int depth, int vecA, int vecB) {
  gemm_f32::splitk_tile_at<false>(x, g, mask, part, dwdb, rows, Dout, M,
                                  splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::AtTile<true>::kThreads, 4)
dense_dwdb_wide_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ mask,
                       float* __restrict__ part, float* __restrict__ dwdb,
                       int rows, int Dout, int M, int splits, int depth,
                       int vecA, int vecB) {
  gemm_f32::splitk_tile_at<true>(x, g, mask, part, dwdb, rows, Dout, M,
                                 splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dwdb_sum_kernel(const float* __restrict__ part,
                      const float* __restrict__ bias,
                      float* __restrict__ dwdb, int rows, int Dout, int relu,
                      int splits) {
  gemm_f32::splitk_sum(part, bias, dwdb, rows, Dout, relu, splits);
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

// K3: dwdb is (Din + 1, Dout): dw in its first Din rows, db in the last;
// (splits, depth) cut the M rows (kernels/dense.py dwdb_splits).
extern "C" int dense_dwdb_f32(const void* x, const void* g, const void* mask,
                              void* part, void* dwdb, int M, int Din,
                              int Dout, int splits, int depth, void* stream) {
  if (Din <= 0) return (int)cudaErrorInvalidValue;
  return gemm_f32::splitk_launch_at(
      dense_dwdb_kernel, dense_dwdb_wide_kernel, dense_dwdb_sum_kernel,
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mask), static_cast<float*>(part),
      static_cast<float*>(dwdb), Din + 1, Dout, M, splits, depth,
      static_cast<cudaStream_t>(stream));
}
