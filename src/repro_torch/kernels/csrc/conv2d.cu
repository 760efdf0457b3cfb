// Stride-1 NHWC x HWIO convolution for Hopper (sm_90a), in f32: the
// forward (K4), the input gradient (K5) and the weight/bias gradient (K6).
//
// Replaces the TPU kernels of src/repro/kernels/conv2d.py:
//   * _conv_fwd_kernel (pallas_call in _forward): conv + bias + relu;
//   * _conv_dx_kernel (pallas_call in _backward_dx): the VALID correlation
//     of the padded cotangent with the spatially flipped, channel-swapped
//     filter.  The Pallas code runs K4's body (_im2col_accum) on those
//     operands; here K5 is the same kernel as K4, reading the cotangent
//     with the mirrored padding and the filter flipped by index;
//   * _conv_dw_kernel (pallas_call in _backward_dw): dw[i,j,ci,co] =
//     sum_{b,h,w} xpad[b,h+i,w+j,ci] g[b,h,w,co], f32 output.  The conv
//     bias gradient (db = sum g, plain jnp in _conv2d_bwd) is folded in.
// The relu mask (g * (out > 0) in _conv2d_bwd) is folded into the loads
// of K5 and K6: `mask` is the saved forward output, or null.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); each entry point returns cudaGetLastError() after its
// launches and never synchronises.  f32 FMA with f32 accumulation, no
// TF32 (the reference's gradient gate is 1e-4 x scale).
//
// Padding is done by bounds checks on the input index, never by a padded
// copy: the input pixel of output (ho, wo) under tap (i, j) is
// (ho + i - pt, wo + j - pl), zero outside the input.  SAME has pt =
// (kh - 1) / 2 before and the rest after (even k too), VALID pt = 0.  K5
// reads the cotangent with pt' = kh - 1 - pt, which is the reference's
// (kh - 1 - ph, ph) SAME and (kh - 1, kh - 1) VALID cotangent padding.
//
// What bounds them.  The Table-2 CNN's convolutions are narrow (Cin 3 or
// 12, Cout 12, 3 x 3 taps).  At case7, B = 64 layer 0's forward moves
// 3.9 MB (1.2 us at 3.35 TB/s) for 42 MFLOP (0.6 us at 67 TFLOP/s): bytes
// bound it; layer 1 (16 x 16 x 12) moves 1.6 MB (0.5 us) for the same
// flops: the f32 FMA rate bounds it.  The deep 4 x 4 layers are a few
// microseconds of launch and little else.
//
// What the design does about it.
//   * K4/K5 are an implicit GEMM: rows are B.Ho.Wo output pixels, the
//     reduction is kh.kw.Cin taps, columns are Cout.  A block owns 64
//     pixels x 16 channels (Cout = 12 wastes a quarter of the columns,
//     not the 52 of 64 that K1's square tile would), gathers the im2col
//     tile into shared memory 32 taps at a time (neighbouring threads on
//     neighbouring channels of one pixel) and keeps 4 accumulators a
//     thread.  bias + relu are fused into the store.
//   * K6's reduction over B.H.W is 65 536 long at layer 0 while its output
//     is 3 x 3 x 3 x 12 + 12 floats.  One thread per output would leave the
//     card empty, so pass 1 splits B.H.W into `splits` chunks, one block
//     per (64 taps x 16 channels x chunk), each writing its partial sums
//     to a scratch buffer (splits, K + 1, Cout).  Row K of the reduction
//     is a constant 1, which makes its sums db.  Pass 2 adds the partials
//     in split order.  No float atomics: two runs give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output pixels (K4/K5) or taps (K6) per block
constexpr int kBN = 16;  // channels per block
constexpr int kBK = 32;  // reduction step through shared memory

struct Geometry {
  int B, Hi, Wi, Ci;  // input of this pass (the cotangent for K5)
  int Ho, Wo, Co;     // output of this pass (the input gradient for K5)
  int kh, kw, pt, pl;
};

// The input element under output pixel r and tap k, zero outside the
// input; mask (same shape as the input) zeroes where it is not > 0.
__device__ __forceinline__ float im2col(const float* __restrict__ in,
                                        const float* __restrict__ mask,
                                        const Geometry& q, int r, int k) {
  const int c = k % q.Ci;
  const int t = k / q.Ci;
  const int j = t % q.kw;
  const int i = t / q.kw;
  const int wo = r % q.Wo;
  const int u = r / q.Wo;
  const int ho = u % q.Ho;
  const int b = u / q.Ho;
  const int hi = ho + i - q.pt;
  const int wi = wo + j - q.pl;
  if (hi < 0 || hi >= q.Hi || wi < 0 || wi >= q.Wi) return 0.0f;
  const size_t idx = (((size_t)b * q.Hi + hi) * q.Wi + wi) * q.Ci + c;
  const float v = in[idx];
  return (mask == nullptr || mask[idx] > 0.0f) ? v : 0.0f;
}

// K4 (kFlip = false) and K5 (kFlip = true), two instances of one body:
//   out[r, o] = act(sum_k im2col(in)[r, k] * W[k, o] + bias[o]),
// W[k, o] = w[i, j, c, o] (HWIO, forward) or w[kh-1-i, kw-1-j, o, c]
// (flipped and channel-swapped, input gradient).
template <bool kFlip>
__global__ void __launch_bounds__(kThreads)
conv_igemm_kernel(const float* __restrict__ in, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ out,
                  Geometry q, int relu) {
  __shared__ float xt[kBK][kBM + 1];  // xt[k][r]
  __shared__ float wt[kBK][kBN];      // wt[k][o]

  const int M = q.B * q.Ho * q.Wo;
  const int K = q.kh * q.kw * q.Ci;
  const int tid = threadIdx.x;
  const int tr = tid / 4;  // this thread's pixel in the tile
  const int tc = tid % 4;  // its channels: tc, tc + 4, tc + 8, tc + 12
  const int r0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  float acc[4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int kk = e % kBK;
      const int rr = e / kBK;
      const int r = r0 + rr;
      const int k = k0 + kk;
      xt[kk][rr] = (r < M && k < K) ? im2col(in, mask, q, r, k) : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int oo = e % kBN;
      const int kk = e / kBN;
      const int k = k0 + kk;
      const int o = o0 + oo;
      float v = 0.0f;
      if (k < K && o < q.Co) {
        if (kFlip) {
          const int c = k % q.Ci;
          const int t = k / q.Ci;
          const int j = t % q.kw;
          const int i = t / q.kw;
          v = w[((((size_t)(q.kh - 1 - i) * q.kw + (q.kw - 1 - j)) * q.Co) +
                 o) * q.Ci + c];
        } else {
          v = w[(size_t)k * q.Co + o];
        }
      }
      wt[kk][oo] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float a = xt[kk][tr];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, wt[kk][tc + 4 * j], acc[j]);
    }
    __syncthreads();
  }

  const int r = r0 + tr;
  if (r < M) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tc + 4 * j;
      if (o < q.Co) {
        float v = acc[j];
        if (bias != nullptr) v += bias[o];
        if (relu) v = fmaxf(v, 0.0f);
        out[(size_t)r * q.Co + o] = v;
      }
    }
  }
}

// K6 pass 1.  Geometry is the forward's: in = x (B, Hi, Wi, Ci), the
// cotangent g is (B, Ho, Wo, Co).  Block (kt, ot, s) sums taps
// [64 kt, 64 kt + 64) x channels [16 ot, 16 ot + 16) over rows
// [s chunk, (s + 1) chunk) into part[s].
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ mask,
                       float* __restrict__ part, Geometry q, int chunk) {
  __shared__ float xs[kBK][kBM + 1];  // xs[r][k]: im2col, plus the ones row
  __shared__ float gs[kBK][kBN];      // gs[r][o]

  const int R = q.B * q.Ho * q.Wo;
  const int K = q.kh * q.kw * q.Ci;
  const int tid = threadIdx.x;
  const int tk = tid / 4;
  const int tc = tid % 4;
  const int k0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int rbeg = blockIdx.z * chunk;
  const int rend = min(R, rbeg + chunk);
  float acc[4] = {};

  for (int rb = rbeg; rb < rend; rb += kBK) {
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int kk = e % kBM;
      const int rr = e / kBM;
      const int r = rb + rr;
      const int k = k0 + kk;
      float v = 0.0f;
      if (r < rend) {
        if (k < K) v = im2col(x, nullptr, q, r, k);
        else if (k == K) v = 1.0f;
      }
      xs[rr][kk] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int oo = e % kBN;
      const int rr = e / kBN;
      const int r = rb + rr;
      const int o = o0 + oo;
      float v = 0.0f;
      if (r < rend && o < q.Co) {
        const size_t idx = (size_t)r * q.Co + o;
        v = g[idx];
        if (mask != nullptr && !(mask[idx] > 0.0f)) v = 0.0f;
      }
      gs[rr][oo] = v;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kBK; ++rr) {
      const float a = xs[rr][tk];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, gs[rr][tc + 4 * j], acc[j]);
    }
    __syncthreads();
  }

  const int k = k0 + tk;
  if (k <= K) {
    float* dst = part + ((size_t)blockIdx.z * (K + 1) + k) * q.Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tc + 4 * j;
      if (o < q.Co) dst[o] = acc[j];
    }
  }
}

// K6 pass 2: dw and db from the partials, added in split order.
__global__ void __launch_bounds__(kThreads)
conv_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                      float* __restrict__ db, int K, int Co, int splits) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int n = (K + 1) * Co;
  if (idx >= n) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * n + idx];
  if (idx < K * Co) dw[idx] = s;
  else db[idx - K * Co] = s;
}

}  // namespace

extern "C" int conv2d_igemm_f32(const void* in, const void* w,
                                const void* bias, const void* mask,
                                void* out, int B, int Hi, int Wi, int Ci,
                                int Ho, int Wo, int Co, int kh, int kw,
                                int pt, int pl, int flip, int relu,
                                void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Co <= 0 || kh <= 0 ||
      kw <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry q{B, Hi, Wi, Ci, Ho, Wo, Co, kh, kw, pt, pl};
  const int M = B * Ho * Wo;
  dim3 grid((M + kBM - 1) / kBM, (Co + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const float*>(in);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  if (flip)
    conv_igemm_kernel<true><<<grid, kThreads, 0, s>>>(ip, wp, bp, mp, op, q,
                                                      relu);
  else
    conv_igemm_kernel<false><<<grid, kThreads, 0, s>>>(ip, wp, bp, mp, op, q,
                                                       relu);
  return (int)cudaGetLastError();
}

extern "C" int conv2d_dw_f32(const void* x, const void* g, const void* mask,
                             void* part, void* dw, void* db, int B, int Hi,
                             int Wi, int Ci, int Ho, int Wo, int Co, int kh,
                             int kw, int pt, int pl, int splits,
                             void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Co <= 0 || kh <= 0 ||
      kw <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry q{B, Hi, Wi, Ci, Ho, Wo, Co, kh, kw, pt, pl};
  const int R = B * Ho * Wo;
  const int K = kh * kw * Ci;
  const int chunk = (R + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((K + 1 + kBM - 1) / kBM, (Co + kBN - 1) / kBN, splits);
  conv_dw_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mask), static_cast<float*>(part), q, chunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = (K + 1) * Co;
  conv_dw_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), K, Co, splits);
  return (int)cudaGetLastError();
}
