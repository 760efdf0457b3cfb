// RMSNorm forward for Hopper (sm_90a): K9.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call in rmsnorm_pallas; entry ops.rmsnorm).  Same contract: for
// every row of x (rows, d), out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and cast to x's dtype.  x is bf16 or f32, scale (d,) is
// f32 or bf16 (the port's norm scales are f32 masters).  Forward only, as
// in the reference.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); the entry point returns cudaGetLastError() after its launch
// and never synchronises.
//
// What bounds it: bytes.  It reads x and writes out once (plus the small
// scale vector), about 2 flops per byte.  One Gemma-2 decode-step norm,
// 4 rows of d = 4608 in bf16, moves 92 KB: under 0.03 us at 3.35 TB/s, so
// at decode the launch itself dominates; a 4500-row prefill norm moves
// 83 MB, at least 25 us.
//
// What the design does about it: one block per row.  Each thread sums x^2
// over 16-byte vectors of the row (8 bf16 or 4 f32, neighbouring threads
// on neighbouring addresses); the unaligned head and the ragged tail of a
// row (any d, any row start) go element by element.  A warp-shuffle and
// shared-memory reduction gives the row's sum; the second pass re-reads
// the row (from L1/L2: a row is at most a few tens of KB) and writes
// x * r * scale with the same vector shape.  The block is as wide as the
// row's vectors need, between one warp and 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x / 32;
  float total = 0.0f;
  for (int w = 0; w < nwarps; ++w) total += red[w];
  return total;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);   // elements in one 16-byte vector
  __shared__ float red[kMaxThreads / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const T* xr = x + base;
  T* orow = out + base;
  const int tid = threadIdx.x;

  // [0, head) unaligned, [head, head + nv * V) 16-byte vectors, the rest
  // a ragged tail; out shares x's alignment only when both pointers agree
  // modulo 16, otherwise everything goes element by element
  const uintptr_t ax = (uintptr_t)xr;
  int head = (int)(((16 - ax % 16) % 16) / sizeof(T));
  const bool vec = (ax % sizeof(T) == 0) &&
                   ((uintptr_t)orow % 16 == ax % 16) && head <= d;
  if (!vec) head = d;
  const int nv = (d - head) / V;
  const int tail = head + nv * V;

  float ss = 0.0f;
  for (int i = tid; i < head; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  for (int i = tid; i < nv; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr + head)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = to_f(e[j]);
      ss += v * v;
    }
  }
  for (int i = tail + tid; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)d + eps);

  for (int i = tid; i < head; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
  for (int i = tid; i < nv; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr + head)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
    const int c0 = head + i * V;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = from_f<T>(to_f(e[j]) * r * to_f(scale[c0 + j]));
    reinterpret_cast<uint4*>(orow + head)[i] = packed;
  }
  for (int i = tail + tid; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int threads = ((d + V - 1) / V + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                        : threads);
  rmsnorm_kernel<T, S><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (rows, d) of one dtype (x_bf16: bf16, else f32); scale (d,)
// (scale_bf16: bf16, else f32).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, int x_bf16, int scale_bf16,
                           float eps, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s)
        : launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  return scale_bf16
      ? launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s)
      : launch<float, float>(x, scale, out, rows, d, eps, s);
}
