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
//     is the (K + 1) x Co table (28 x 12 at layer 0, 109 x 12 after; row K
//     is a constant 1, whose sums are db).  Pass 1 gives a block one tile
//     of output pixels (tb images x th rows x tw columns, chosen from the
//     shapes by kernels/conv2d.py dw_tile: 16-256 pixels, a tile an SM
//     where B.H.W allows), stages the tile's x patch with its halo and the
//     masked g once in shared memory (x read from device memory once, not
//     kh.kw times) and lets each thread sum 4 taps x 4 channels over a
//     share of the tile's pixels; pass 2 adds the tiles' partials, 32
//     neighbouring outputs a block, 8 warps over every 8th tile, then the
//     8 sums in warp order.  No float atomics: two runs give identical
//     bits.  A block may take up to the device's opt-in shared memory
//     (227 KB on H100); a shape where even one pixel's patch does not fit
//     (kh.kw.Cin above about 58 000 floats) is refused.  What is left: the
//     4 x 4 layers' tiles are mostly copy latency, and a patch read by
//     several tap-group blocks (grid.y > 1, wide Cin) is staged by each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output pixels per K4/K5 block
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

// K6 pass 1.  Geometry is the forward's: x (B, Hi, Wi, Ci), the cotangent
// g (B, Ho, Wo, Co).  Block (tile, tap chunk, channel chunk) owns the
// output pixels of one tile (tb images x th rows x tw columns, clipped at
// the edges) and stages, once, the tile's x patch with its (kh - 1) x
// (kw - 1) halo (zero outside the input) and the masked g of its channel
// chunk (ct <= 16 channels) in shared memory: rows of contiguous floats,
// neighbouring lanes on neighbouring addresses, every copy in flight at
// once (4-byte cp.async; a tile of a 4 x 4 layer is mostly latency).
// Each thread owns 4 taps x 4 channels of the (K + 1) x Co table (row K
// is the constant 1 whose sums are db) and sums them over every pg_n-th
// pixel of the tile from shared memory; the pg_n pixel groups are then
// added in group order and the tile's sums written to part[tile].  No
// division per element of the sums: each pixel's patch offset is staged
// beside it.
template <bool kVec>
__device__ __forceinline__ void dw_accumulate(
    float (&acc)[4][4], const float* __restrict__ xs,
    const float* __restrict__ gs, const int* __restrict__ xo, int P,
    int pg, int pg_n, int ct, int cg, const int (&off)[4],
    const bool (&one)[4]) {
#pragma unroll 4
  for (int p = pg; p < P; p += pg_n) {
    const float* xp = xs + xo[p];
    const float4 gv = *reinterpret_cast<const float4*>(gs + p * ct + cg * 4);
    float xv[4];
    if (kVec) {   // four neighbouring channels of one tap
      const float4 v = *reinterpret_cast<const float4*>(xp + off[0]);
      xv[0] = v.x;
      xv[1] = v.y;
      xv[2] = v.z;
      xv[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) xv[t] = one[t] ? 1.0f : xp[off[t]];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc[t][0] = fmaf(xv[t], gv.x, acc[t][0]);
      acc[t][1] = fmaf(xv[t], gv.y, acc[t][1]);
      acc[t][2] = fmaf(xv[t], gv.z, acc[t][2]);
      acc[t][3] = fmaf(xv[t], gv.w, acc[t][3]);
    }
  }
}

// The layout of one K6 pass-1 block, from the shapes alone.  The launcher's
// tile chooser sizes tiles by the same bytes (conv2d.py dw_smem); the C
// entry refuses a tile over the limit, and conv2d_dw_smem below lets a
// test on the card hold the two to each other.
struct DwPlan {
  int K, ct, cg_n, groups, tgb, jobs, pg_n, P, PH, PW, xs_n;
  __host__ __device__ DwPlan(const Geometry& q, int tb, int th, int tw) {
    K = q.kh * q.kw * q.Ci;
    ct = q.Co < 13 ? (q.Co + 3) / 4 * 4 : 16;   // channels a block owns
    cg_n = ct / 4;
    groups = (K + 1 + 3) / 4;           // 4-tap groups of the K + 1 rows
    tgb = kThreads / cg_n;              // tap groups a block owns
    if (groups < tgb) tgb = groups;
    jobs = tgb * cg_n;
    pg_n = kThreads / jobs;             // pixel groups
    P = tb * th * tw;
    PH = th + q.kh - 1;
    PW = tw + q.kw - 1;
    xs_n = (tb * PH * PW * q.Ci + 3) / 4 * 4;
  }
  __host__ __device__ size_t smem() const {   // x, g, mask, offsets
    const size_t stage =
        sizeof(float) * ((size_t)xs_n + 2 * (size_t)P * ct + P);
    const size_t red = sizeof(float) * (size_t)pg_n * jobs * 16;
    return stage > red ? stage : red;
  }
};


__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ mask,
                       float* __restrict__ part, Geometry q, int tb, int th,
                       int tw) {
  extern __shared__ __align__(16) float sm[];
  const DwPlan d(q, tb, th, tw);
  float* xs = sm;                          // tb x PH x PW x Ci
  float* gs = xs + d.xs_n;                 // P x ct, then the mask's P x ct
  int* xo = reinterpret_cast<int*>(gs + 2 * d.P * d.ct);  // P patch offsets
  float* red = sm;                         // pg_n x jobs x 16, after the sums

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ntw = (q.Wo + tw - 1) / tw;
  const int nth = (q.Ho + th - 1) / th;
  const int w0 = (blockIdx.x % ntw) * tw;
  const int h0 = (blockIdx.x / ntw % nth) * th;
  const int b0 = blockIdx.x / ntw / nth * tb;
  const int tg0 = blockIdx.y * d.tgb;
  const int co0 = blockIdx.z * d.ct;

  // Stage `rows` rows of `len` floats into dst (row r at r * len) with
  // 4-byte cp.async copies, every one of them in flight at once: warp w
  // takes rows w, w + 8, ...; row(r, off, lo, hi) places row r in the
  // source once (element e at src + off + e; elements [lo, hi) lie inside
  // it, the rest is zero-filled).
  auto stage = [&](float* dst, const float* src, int rows, int len,
                   auto row) {
    for (int r = warp; r < rows; r += kThreads / 32) {
      long long off = 0;
      int lo = 0, hi = 0;
      row(r, off, lo, hi);
      for (int e = lane; e < len; e += 32) {
        const bool ok = e >= lo && e < hi;
        cp_async::copy4(dst + r * len + e, src + (ok ? off + e : 0), ok);
      }
    }
  };

  // x patch: tb x PH rows of PW x Ci floats, each a contiguous run of one
  // input row (zero outside it)
  const int row_len = q.Wi * q.Ci;
  const int lo_x = (w0 - q.pl) * q.Ci;
  stage(xs, x, tb * d.PH, d.PW * q.Ci,
        [&](int r, long long& off, int& lo, int& hi) {
          const int bb = b0 + r / d.PH;
          const int h = h0 - q.pt + r % d.PH;
          if (bb >= q.B || h < 0 || h >= q.Hi) return;
          off = ((long long)bb * q.Hi + h) * row_len + lo_x;
          lo = -lo_x;
          hi = row_len - lo_x;
        });
  // g and its mask: tb x th rows of tw pixels x ct channels; where the
  // block owns every channel (ct == Co) a row is one contiguous run, else
  // element by element
  float* ms = gs + d.P * d.ct;
  if (d.ct == q.Co) {
    const int lim = min(tw, q.Wo - w0) * q.Co;
    auto g_row = [&](int r, long long& off, int& lo, int& hi) {
      const int bb = b0 + r / th;
      const int h = h0 + r % th;
      if (bb >= q.B || h >= q.Ho) return;
      off = (((long long)bb * q.Ho + h) * q.Wo + w0) * q.Co;
      hi = lim;
    };
    stage(gs, g, tb * th, tw * d.ct, g_row);
    if (mask != nullptr) stage(ms, mask, tb * th, tw * d.ct, g_row);
  } else {
    for (int e = tid; e < d.P * d.ct; e += kThreads) {
      const int c = e % d.ct;
      const int p = e / d.ct;
      const int w = p % tw;
      const int h = h0 + p / tw % th;
      const int bb = b0 + p / tw / th;
      const bool ok = bb < q.B && h < q.Ho && w0 + w < q.Wo && co0 + c < q.Co;
      const long long i =
          ok ? (((long long)bb * q.Ho + h) * q.Wo + w0 + w) * q.Co + co0 + c
             : 0;
      cp_async::copy4(gs + e, g + i, ok);
      if (mask != nullptr) cp_async::copy4(ms + e, mask + i, ok);
    }
  }
  cp_async::commit();
  for (int p = tid; p < d.P; p += kThreads) {
    const int w = p % tw;
    const int h = p / tw % th;
    const int bb = p / tw / th;
    xo[p] = ((bb * d.PH + h) * d.PW + w) * q.Ci;
  }
  cp_async::wait<0>();
  __syncthreads();
  if (mask != nullptr)   // g where the forward's output is > 0
    for (int e = tid; e < d.P * d.ct; e += kThreads)
      if (!(ms[e] > 0.0f)) gs[e] = 0.0f;
  __syncthreads();

  // this thread's 4 taps x 4 channels, and its pixel group
  const int job = tid % d.jobs;
  const int pg = tid / d.jobs;
  const int cg = job % d.cg_n;
  const int kt = (tg0 + job / d.cg_n) * 4;
  int off[4];
  bool one[4];
  int tc = kt % q.Ci;              // tap kt's channel, column and row;
  int tj = kt / q.Ci % q.kw;       // the next taps step through them
  int ti = kt / q.Ci / q.kw;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    off[t] = kt + t < d.K ? (ti * d.PW + tj) * q.Ci + tc : 0;
    one[t] = kt + t == d.K;
    if (++tc == q.Ci) {
      tc = 0;
      if (++tj == q.kw) {
        tj = 0;
        ++ti;
      }
    }
  }
  float acc[4][4] = {};
  if (pg < d.pg_n) {
    if (q.Ci % 4 == 0 && kt + 4 <= d.K)
      dw_accumulate<true>(acc, xs, gs, xo, d.P, pg, d.pg_n, d.ct, cg, off,
                          one);
    else
      dw_accumulate<false>(acc, xs, gs, xo, d.P, pg, d.pg_n, d.ct, cg, off,
                           one);
  }
  __syncthreads();                         // the staged tiles are done
  if (pg < d.pg_n) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(pg * d.jobs + job) * 16 + t * 4 + c] = acc[t][c];
  }
  __syncthreads();
  // the pixel groups' sums in group order; one thread an entry
  const int K1 = d.K + 1;
  float* dst = part + (size_t)blockIdx.x * K1 * q.Co;
  for (int e = tid; e < d.jobs * 16; e += kThreads) {
    const int jb = e / 16;
    const int k = (tg0 + jb / d.cg_n) * 4 + e % 16 / 4;
    const int co = co0 + (jb % d.cg_n) * 4 + e % 4;
    float s = 0.0f;
    for (int p = 0; p < d.pg_n; ++p) s += red[(p * d.jobs + jb) * 16 + e % 16];
    if (k < K1 && co < q.Co) dst[(size_t)k * q.Co + co] = s;
  }
}

// K6 pass 2: dw and db from the tiles' partials.  A block owns 32
// neighbouring outputs; its 8 warps' lanes add every 8th tile's partial
// (warp w: tiles w, w + 8, ...), then one warp adds the 8 sums in warp
// order.  A fixed order: identical bits on a rerun.
constexpr int kRedOut = 32;
constexpr int kRedGroups = kThreads / kRedOut;

__global__ void __launch_bounds__(kThreads)
conv_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                      float* __restrict__ db, int K, int Co, int splits) {
  __shared__ float sums[kRedGroups][kRedOut];
  const int n = (K + 1) * Co;
  const int lane = threadIdx.x % kRedOut;
  const int grp = threadIdx.x / kRedOut;
  const int o = blockIdx.x * kRedOut + lane;
  float s = 0.0f;
  if (o < n)
    for (int p = grp; p < splits; p += kRedGroups) s += part[(size_t)p * n + o];
  sums[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || o >= n) return;
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kRedGroups; ++w) t += sums[w][lane];
  if (o < K * Co) dw[o] = t;
  else db[o - K * Co] = t;
}

// Let K6's pass 1 take up to the device's opt-in shared memory per block;
// once per device.  Sets *limit to that many bytes.
int allow_dw_smem(size_t* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int optin[64] = {};
  if (dev < 64 && optin[dev] > 0) {
    *limit = (size_t)optin[dev];
    return 0;
  }
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_dw_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) optin[dev] = bytes;
  *limit = (size_t)bytes;
  return 0;
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

// K6: (tb, th, tw) is the output-pixel tile of one pass-1 block
// (kernels/conv2d.py dw_tile); part holds the (tiles, K + 1, Co) f32
// partial sums.
extern "C" int conv2d_dw_f32(const void* x, const void* g, const void* mask,
                             void* part, void* dw, void* db, int B, int Hi,
                             int Wi, int Ci, int Ho, int Wo, int Co, int kh,
                             int kw, int pt, int pl, int tb, int th, int tw,
                             void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Co <= 0 || kh <= 0 ||
      kw <= 0 || tb <= 0 || th <= 0 || tw <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry q{B, Hi, Wi, Ci, Ho, Wo, Co, kh, kw, pt, pl};
  const DwPlan d(q, tb, th, tw);
  size_t limit = 0;
  const int set = allow_dw_smem(&limit);
  if (set != 0) return set;
  if (d.smem() > limit) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((B + tb - 1) / tb) *
                          ((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)tiles, (d.groups + d.tgb - 1) / d.tgb,
            (Co + d.ct - 1) / d.ct);
  conv_dw_partial_kernel<<<grid, kThreads, d.smem(), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mask), static_cast<float*>(part), q, tb, th,
      tw);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = (d.K + 1) * Co;
  conv_dw_reduce_kernel<<<(n + kRedOut - 1) / kRedOut, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), d.K, Co, (int)tiles);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a K6 pass-1 block takes for the (tb, th, tw)
// tile (DwPlan::smem), for holding the launcher's tile chooser
// (kernels/conv2d.py dw_smem) to the kernel's layout.
extern "C" long long conv2d_dw_smem(int Ci, int Co, int kh, int kw, int tb,
                                    int th, int tw) {
  const Geometry q{1, 1, 1, Ci, 1, 1, Co, kh, kw, 0, 0};
  return (long long)DwPlan(q, tb, th, tw).smem();
}
