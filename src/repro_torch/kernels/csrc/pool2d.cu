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
// K8 reads x, out and g once and writes dx once, a few compares per
// element.  At case7, B = 64 the largest K8 pass (32 x 32 x 12) reads
// 4.7 MB (x 3.1, out and g 0.8 each) and writes 3.1 MB: about 2.4 us at
// 3.35 TB/s.
//
// What the designs do about it.  Both give a thread one (image, output
// window, group of 4 channels), with one 32-bit division chain (64-bit
// only past 2^31 elements), and read each input once as 16-byte vectors.
// K7 (its first design: a thread per output float, three 64-bit div/mod
// chains and 4-byte loads, 16% of its bound) takes the max of its k x k
// vectors lane by lane, in the reference's row-major order, and writes
// one vector.  K8 reads its window's out and g once, reads its k x k x
// vectors (held in registers for the CNN's window of 2; any other window
// reads them again for the writes), counts each lane's ties in registers
// and writes its k x k dx vectors once.  K8's dropped remainder rows and
// columns are zeroed by an extra range of threads of the same launch.
// The launch geometry (lanes, threads a block, blocks) comes from
// pool2d.py's fwd_plan and bwd_plan: blocks of 256, 128 or 64 threads,
// the largest that still gives every SM a block.  C % 4 != 0 or a
// pointer off 16 bytes takes the same kernels one channel a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// L lanes of float: one 16-byte vector (L = 4) or one float.
template <int L>
struct Lanes {
  float v[L];
};

template <int L>
__device__ __forceinline__ Lanes<L> load_lanes(const float* p) {
  Lanes<L> r;
  if constexpr (L == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int L>
__device__ __forceinline__ void store_lanes(float* p, const Lanes<L>& r) {
  if constexpr (L == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  else
    *p = r.v[0];
}

// Threads [0, n): one (image, output window, group of L channels) each,
// channel groups fastest: the max of the window's K * K vectors (K == 0:
// any window, in a loop), lane by lane in row-major order with a strict
// compare, as the first design took it.  I is the index type: 32-bit
// unless x passes 2^31 elements.
template <int K, int L, typename I>
__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const float* __restrict__ x, float* __restrict__ out, I H,
                I W, I C, I k_any, I n) {
  const I k = K > 0 ? (I)K : k_any;
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const I Ho = H / k, Wo = W / k, Q = C / L;
  const I q = idx % Q;
  I t = idx / Q;
  const I wo = t % Wo;
  t /= Wo;
  const I ho = t % Ho;
  const I b = t / Ho;
  const float* xw = x + ((b * H + ho * k) * W + wo * k) * C + q * L;
  Lanes<L> m;
  if constexpr (K > 0) {
    Lanes<L> xv[K * K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j)
        xv[i * K + j] = load_lanes<L>(xw + ((I)i * W + j) * C);
    m = xv[0];
#pragma unroll
    for (int p = 1; p < K * K; ++p)
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (xv[p].v[l] > m.v[l]) m.v[l] = xv[p].v[l];
  } else {
    m = load_lanes<L>(xw);
    for (I i = 0; i < k; ++i)
      for (I j = 0; j < k; ++j) {
        const Lanes<L> xv = load_lanes<L>(xw + (i * W + j) * C);
#pragma unroll
        for (int l = 0; l < L; ++l)
          if (xv.v[l] > m.v[l]) m.v[l] = xv.v[l];
      }
  }
  store_lanes<L>(out + idx * L, m);   // ((b Ho + ho) Wo + wo) C + q L
}

// dx of one lane group at one window position: g / count where x is the
// window's max, else 0 (the reference's g * mask / counts).
template <int L>
__device__ __forceinline__ Lanes<L> routed(const Lanes<L>& xv,
                                           const Lanes<L>& m,
                                           const Lanes<L>& gv,
                                           const float (&count)[L]) {
  Lanes<L> r;
#pragma unroll
  for (int l = 0; l < L; ++l)
    r.v[l] = xv.v[l] == m.v[l] ? gv.v[l] / count[l] : 0.0f;
  return r;
}

// Threads [0, n_main): one (image, output window, group of L channels)
// each, channel groups fastest; K > 0 holds the window's K * K x vectors
// in registers, K == 0 (any window) reads them again for the writes.
// Threads [n_main, n_total): one (image, remainder position, channel
// group) each, remainder rows (h >= Ho * k) first, then the remainder
// columns of the pooled rows; they write zeros.  I is the index type:
// 32-bit unless x passes 2^31 elements.
template <int K, int L, typename I>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ out,
                const float* __restrict__ g, float* __restrict__ dx, I H,
                I W, I C, I k_any, I n_main, I n_total) {
  const I k = K > 0 ? (I)K : k_any;
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_total) return;
  const I Ho = H / k, Wo = W / k, Q = C / L;
  if (idx < n_main) {
    const I q = idx % Q;
    I t = idx / Q;
    const I wo = t % Wo;
    t /= Wo;
    const I ho = t % Ho;
    const I b = t / Ho;
    const I o = ((b * Ho + ho) * Wo + wo) * C + q * L;
    const Lanes<L> m = load_lanes<L>(out + o);
    const Lanes<L> gv = load_lanes<L>(g + o);
    const float* xw = x + ((b * H + ho * k) * W + wo * k) * C + q * L;
    float* dw = dx + ((b * H + ho * k) * W + wo * k) * C + q * L;
    float count[L];
#pragma unroll
    for (int l = 0; l < L; ++l) count[l] = 0.0f;
    if constexpr (K > 0) {
      Lanes<L> xv[K * K];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          xv[i * K + j] = load_lanes<L>(xw + ((I)i * W + j) * C);
#pragma unroll
      for (int p = 0; p < K * K; ++p)
#pragma unroll
        for (int l = 0; l < L; ++l)
          count[l] += xv[p].v[l] == m.v[l] ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          store_lanes<L>(dw + ((I)i * W + j) * C,
                         routed<L>(xv[i * K + j], m, gv, count));
    } else {
      for (I i = 0; i < k; ++i)
        for (I j = 0; j < k; ++j) {
          const Lanes<L> xv = load_lanes<L>(xw + (i * W + j) * C);
#pragma unroll
          for (int l = 0; l < L; ++l)
            count[l] += xv.v[l] == m.v[l] ? 1.0f : 0.0f;
        }
      for (I i = 0; i < k; ++i)
        for (I j = 0; j < k; ++j)
          store_lanes<L>(dw + (i * W + j) * C,
                         routed<L>(load_lanes<L>(xw + (i * W + j) * C), m,
                                   gv, count));
    }
    return;
  }
  const I r = idx - n_main;
  const I q = r % Q;
  I p = r / Q;
  const I Hk = Ho * k, Wk = Wo * k;
  const I per_image = (H - Hk) * W + Hk * (W - Wk);
  const I b = p / per_image;
  p %= per_image;
  I h, w;
  if (p < (H - Hk) * W) {
    h = Hk + p / W;
    w = p % W;
  } else {
    p -= (H - Hk) * W;
    h = p / (W - Wk);
    w = Wk + p % (W - Wk);
  }
  Lanes<L> zero;
#pragma unroll
  for (int l = 0; l < L; ++l) zero.v[l] = 0.0f;
  store_lanes<L>(dx + ((b * H + h) * W + w) * C + q * L, zero);
}

// launch(window, index) for the instance of window k: the window a
// std::integral_constant, 2 (the CNN's) or 0 (any, read at run time); the
// index type's zero, 32-bit unless `wide` (past 2^31 elements).
template <typename Launch>
int by_instance(long long k, bool wide, Launch launch) {
  using Any = std::integral_constant<int, 0>;
  if (wide) return launch(Any{}, 0ull);
  if (k == 2) return launch(std::integral_constant<int, 2>{}, 0u);
  return launch(Any{}, 0u);
}

}  // namespace

// lanes 4 or 1 channels a thread (4: C % 4 == 0 and both pointers on 16
// bytes), `threads` a block, `blocks` blocks covering the output windows'
// lane groups (pool2d.py ``fwd_plan``).
extern "C" int max_pool2d_fwd_f32(const void* x, void* out, int B, int H,
                                  int W, int C, int k, int lanes,
                                  int threads, int blocks, void* stream) {
  if (B <= 0 || C <= 0 || k <= 0 || H / k <= 0 || W / k <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = lanes == 4 && C % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (!(vec || lanes == 1) || threads <= 0 || threads > kThreads)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * (H / k) * (W / k) * (C / lanes);
  if ((long long)blocks * threads < n ||
      (long long)(blocks - 1) * threads >= n)
    return (int)cudaErrorInvalidValue;
  const bool wide = (long long)B * H * W * C >= (1LL << 31);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  return by_instance(k, wide, [&](auto window, auto index) {
    constexpr int K = decltype(window)::value;
    using I = decltype(index);
    if (vec)
      pool_fwd_kernel<K, 4, I><<<blocks, threads, 0, s>>>(
          xf, of, (I)H, (I)W, (I)C, (I)k, (I)n);
    else
      pool_fwd_kernel<K, 1, I><<<blocks, threads, 0, s>>>(
          xf, of, (I)H, (I)W, (I)C, (I)k, (I)n);
    return (int)cudaGetLastError();
  });
}

// lanes 4 or 1 channels a thread (4: C % 4 == 0 and every pointer on 16
// bytes), `threads` a block, `blocks` blocks covering the windows' and the
// remainder's threads (pool2d.py ``bwd_plan``).
extern "C" int max_pool2d_bwd_f32(const void* x, const void* out,
                                  const void* g, void* dx, int B, int H,
                                  int W, int C, int k, int lanes,
                                  int threads, int blocks, void* stream) {
  if (B <= 0 || C <= 0 || k <= 0 || H / k <= 0 || W / k <= 0)
    return (int)cudaErrorInvalidValue;
  const long long Ho = H / k, Wo = W / k;
  const long long per_image =
      (long long)(H - Ho * k) * W + Ho * k * (W - Wo * k);
  const bool vec = lanes == 4 && C % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)out | (uintptr_t)g |
                    (uintptr_t)dx) % 16 == 0;
  if (!(vec || lanes == 1) || threads <= 0 || threads > kThreads)
    return (int)cudaErrorInvalidValue;
  const long long Q = C / lanes;
  const long long n_main = B * Ho * Wo * Q;
  const long long n_total = n_main + B * per_image * Q;
  if ((long long)blocks * threads < n_total ||
      (long long)(blocks - 1) * threads >= n_total)
    return (int)cudaErrorInvalidValue;
  const bool wide = (long long)B * H * W * C >= (1LL << 31);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* of = static_cast<const float*>(out);
  const float* gf = static_cast<const float*>(g);
  float* df = static_cast<float*>(dx);
  return by_instance(k, wide, [&](auto window, auto index) {
    constexpr int K = decltype(window)::value;
    using I = decltype(index);
    if (vec)
      pool_bwd_kernel<K, 4, I><<<blocks, threads, 0, s>>>(
          xf, of, gf, df, (I)H, (I)W, (I)C, (I)k, (I)n_main, (I)n_total);
    else
      pool_bwd_kernel<K, 1, I><<<blocks, threads, 0, s>>>(
          xf, of, gf, df, (I)H, (I)W, (I)C, (I)k, (I)n_main, (I)n_total);
    return (int)cudaGetLastError();
  });
}
