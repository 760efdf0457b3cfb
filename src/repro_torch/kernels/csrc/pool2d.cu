// Non-overlapping max pooling for Hopper (sm_90a), NHWC, f32: the forward
// (K7) and its backward (K8).
//
// Replaces the TPU kernels of src/repro/kernels/pool2d.py:
//   * _pool_fwd_kernel (pallas_call in _forward): the max over each
//     window x window tile (window == stride); the remainder rows and
//     columns that do not fill a window are dropped;
//   * _pool_bwd_kernel (pallas_call in _backward): each window's
//     cotangent goes to every position equal to the window's max (the
//     saved forward output), split evenly by the number of ties; the
//     remainder gets 0.  Inputs after a relu tie at zero often, so ties are
//     the normal case: g / count is exactly the reference's g * 1 / count.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); each entry point returns cudaGetLastError() after its launch
// and never synchronises.
//
// What bounds them: bytes.  K7 reads x once and writes a quarter of it;
// K8 reads x, out and g and writes dx, a few compares per element.  At
// case7, B = 64 the largest pass (32 x 32 x 12) moves 3.1 MB in and
// 0.8 MB out, about 1 us at 3.35 TB/s.
//
// What the design does about it: one thread per output element (K7) or
// per input element (K8), channels innermost, so neighbouring threads
// read and write neighbouring floats.  K8's thread re-reads its window
// (window^2 floats, from L1/L2) to count the ties instead of keeping an
// index buffer, as the reference keeps none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                int H, int W, int C, int k) {
  const int Ho = H / k;
  const int Wo = W / k;
  const size_t n = (size_t)B * Ho * Wo * C;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int c = idx % C;
  size_t t = idx / C;
  const int wo = t % Wo;
  t /= Wo;
  const int ho = t % Ho;
  const int b = t / Ho;
  const float* base = x + (((size_t)b * H + ho * k) * W + wo * k) * C + c;
  float m = base[0];
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) {
      const float v = base[((size_t)i * W + j) * C];
      if (v > m) m = v;
    }
  out[idx] = m;
}

__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ out,
                const float* __restrict__ g, float* __restrict__ dx, int B,
                int H, int W, int C, int k) {
  const int Ho = H / k;
  const int Wo = W / k;
  const size_t n = (size_t)B * H * W * C;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int c = idx % C;
  size_t t = idx / C;
  const int w = t % W;
  t /= W;
  const int h = t % H;
  const int b = t / H;
  const int ho = h / k;
  const int wo = w / k;
  float v = 0.0f;
  if (ho < Ho && wo < Wo) {
    const size_t o = (((size_t)b * Ho + ho) * Wo + wo) * C + c;
    const float m = out[o];
    if (x[idx] == m) {
      const float* base =
          x + (((size_t)b * H + ho * k) * W + wo * k) * C + c;
      float count = 0.0f;
      for (int i = 0; i < k; ++i)
        for (int j = 0; j < k; ++j)
          count += (base[((size_t)i * W + j) * C] == m) ? 1.0f : 0.0f;
      v = g[o] / count;
    }
  }
  dx[idx] = v;
}

}  // namespace

extern "C" int max_pool2d_fwd_f32(const void* x, void* out, int B, int H,
                                  int W, int C, int k, void* stream) {
  if (B <= 0 || C <= 0 || k <= 0 || H / k <= 0 || W / k <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * (H / k) * (W / k) * C;
  pool_fwd_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), B, H, W, C, k);
  return (int)cudaGetLastError();
}

extern "C" int max_pool2d_bwd_f32(const void* x, const void* out,
                                  const void* g, void* dx, int B, int H,
                                  int W, int C, int k, void* stream) {
  if (B <= 0 || C <= 0 || k <= 0 || H / k <= 0 || W / k <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * H * W * C;
  pool_bwd_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(out),
      static_cast<const float*>(g), static_cast<float*>(dx), B, H, W, C, k);
  return (int)cudaGetLastError();
}
