// Flash attention forward for Hopper (sm_90a): K10.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pallas_call in flash_attention_pallas; entry
// ops.flash_attention).  Same contract: q (B, H, Sq, D), k and v
// (B, KH, Sk, D), out (B, H, Sq, D) in q's dtype (bf16 or f32); query
// head h reads kv head h / (H / KH); s = (q . k) * scale with
// scale = 1 / sqrt(D), then the tanh soft-cap s = tanh(s / cap) * cap,
// then the masks (kv padding, causal with the ends aligned
// k <= q + Sk - Sq, sliding window (q + Sk - Sq) - k < window), masked
// scores a finite -1e30; online softmax with m, l and acc in f32, p kept in
// f32 for the PV product, out = acc / max(l, 1e-20).  Forward only.
//
// A row with no live key (causal with Sq > Sk, q < Sq - Sk) gets what the
// TPU kernel gives it: every score there is -1e30, so p = 1 at each of the
// nk * tk padded key positions the TPU grid walks (tk = min(k_tile, Sk)),
// and the row returns sum(v) / (nk * tk).  This kernel skips key tiles
// that lie wholly outside the causal or window band, which is exact for
// every row that has a live key (a skipped tile would add p = 0, or be
// wiped by alpha = exp(-1e30 - m) = 0), so it computes that row
// separately: pad_len = nk * tk comes from the wrapper.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); the entry point returns cudaGetLastError() after its launch
// and never synchronises.
//
// What bounds it: operations.  Over the live (q, k) pairs it does 4 * D
// flops each (QK and PV) and reads q, k, v and writes out once; at
// Gemma-2's S = 8192, H = 32, D = 128, causal, that is 550 GFLOP against
// 64 MB, far above the H100's ~295 flop per byte.  The bound is the bf16
// tensor-core rate, 989 TFLOP/s: 0.56 ms.
//
// What the design does about it, for now: little.  This is the simple,
// right kernel.  One block of 256 threads per (b, h, 64-row q tile); the
// q tile and one 64-row k tile and v tile at a time are staged in shared
// memory as f32 (rows padded by one float so the 16 threads of a
// half-warp read 16 banks); each thread computes a 4 x 4 block of scores
// and a 4 x (D/16) block of the output on the CUDA cores in f32 FMA; four
// threads own a row's softmax statistics and combine them by warp
// shuffles.  Both products run on the f32 FMA units (67 TFLOP/s), not the
// tensor cores, and shared-memory loads feed them: the kernel is expected
// an order of magnitude above the bound.  Tensor-core products (bf16 QK
// with f32 accumulation is exact per product; PV with p in f32 needs a
// split of p or TF32-free f32), cp.async/TMA double buffering and a
// larger q tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTQ = 64;         // query rows per block
constexpr int kTK = 64;         // key rows per tile
constexpr float kNegInf = -1e30f;

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

// Shared-memory layout, in floats, for a padded head dim DP = 16 * NJ.
template <int NJ>
struct Smem {
  static constexpr int DP = 16 * NJ;
  static constexpr int QS = DP + 1;          // q and k row strides
  static constexpr int PS = kTK + 1;         // p row stride
  static constexpr int q = 0;
  static constexpr int k = q + kTQ * QS;
  static constexpr int v = k + kTK * QS;
  static constexpr int p = v + kTK * DP;
  static constexpr int m = p + kTQ * PS;
  static constexpr int l = m + kTQ;
  static constexpr int alpha = l + kTQ;
  static constexpr int floats = alpha + kTQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Stage rows [r0, r0 + n) of a (rows, D) matrix into dst (n x DP, row
// stride ld) as f32, zero beyond `rows` and beyond D.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, int r0,
                                      int n, int rows, int D) {
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    const int gr = r0 + r;
    dst[r * ld + c] =
        (gr < rows && c < D) ? to_f(src[(size_t)gr * D + c]) : 0.0f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int KH,
                 int Sq, int Sk, int D, int causal, int window, int pad_len,
                 float scale, float softcap) {
  using L = Smem<NJ>;
  constexpr int DP = L::DP;
  extern __shared__ float sm[];
  float* qs = sm + L::q;
  float* ks = sm + L::k;
  float* vs = sm + L::v;
  float* ps = sm + L::p;
  float* ms = sm + L::m;
  float* ls = sm + L::l;
  float* as = sm + L::alpha;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int shift = Sk - Sq;                 // causal ends aligned

  const T* qb = q + ((size_t)b * H + h) * Sq * D;
  const T* kb = k + ((size_t)b * KH + kvh) * Sk * D;
  const T* vb = v + ((size_t)b * KH + kvh) * Sk * D;
  T* ob = out + ((size_t)b * H + h) * Sq * D;

  stage<T, DP>(qs, L::QS, qb, q0, kTQ, Sq, D);
  if (tid < kTQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
  }

  // key range that can hold a live key for some row of this tile
  const int q_last = min(q0 + kTQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_last + shift + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + shift - window + 1);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = (k_begin / kTK) * kTK; k0 < k_end; k0 += kTK) {
    __syncthreads();   // previous tile's k, v, p fully read
    stage<T, DP>(ks, L::QS, kb, k0, kTK, Sk, D);
    stage<T, DP>(vs, DP, vb, k0, kTK, Sk, D);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * L::QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool live = kp < Sk;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && qp - kp < window;
        ps[r * L::PS + c] = live ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 keys each
    {
      const int r = tid / 4;
      const int c0 = (tid % 4) * 16;
      float* pr = ps + r * L::PS + c0;
      float mx = pr[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (tid % 4 == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, for rows ty + 16i and columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = as[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * L::PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  // rows with no live key: sum(v) / pad_len, as the TPU kernel's padding
  // gives them (only where causal and q + Sk - Sq < 0)
  const bool dead_rows = causal && q0 + shift < 0;
  if (dead_rows) {
    float* vsum = ps;   // DP floats, p is no longer needed
    for (int c = tid; c < DP; c += kThreads) {
      float t = 0.0f;
      if (c < D)
        for (int kk = 0; kk < Sk; ++kk) t += to_f(vb[(size_t)kk * D + c]);
      vsum[c] = t / (float)pad_len;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr >= Sq) continue;
    const bool dead = causal && qr + shift < 0;
    const float inv_l = 1.0f / fmaxf(ls[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        ob[(size_t)qr * D + c] =
            from_f<T>(dead ? ps[c] : acc[i][j] * inv_l);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, int D, int causal, int window,
           int pad_len, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Smem<NJ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, Sk, D,
      causal, window, pad_len, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KH, int Sq, int Sk, int D, int causal, int window,
             int pad_len, float scale, float softcap, cudaStream_t s) {
#define FLASH_CASE(NJ)                                                    \
  if (D <= 16 * NJ)                                                       \
    return launch<T, NJ>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, window, \
                         pad_len, scale, softcap, s);
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(6)
  FLASH_CASE(8)
  FLASH_CASE(16)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out (B, H, Sq, D); k, v (B, KH, Sk, D); one dtype (bf16: bf16, else
// f32).  window <= 0: none.  softcap <= 0: none.  pad_len = nk * tk of the
// TPU kernel's key padding, for rows with no live key.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KH, int Sq, int Sk, int D, int causal,
                                   int window, int pad_len, int bf16,
                                   float scale, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 256 || pad_len < Sk || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                                   window, pad_len, scale, softcap, s);
  return dispatch<float>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, window,
                         pad_len, scale, softcap, s);
}
