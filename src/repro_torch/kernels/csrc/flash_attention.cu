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
// Two kernels, picked by flash_attention_fwd's bf16 flag; one block of
// 256 threads (8 warps) per (b, h, 64-row q tile), walking the 64-row key
// tiles of the causal/window band; four neighbouring lanes own a row's
// softmax statistics (m, l, alpha in shared memory) and combine them by
// warp shuffles; each thread keeps a 4 x (D/16) block of acc, rows ty +
// 16 i and columns tx + 16 j, in registers.
//
// flash_fwd_bf16_kernel (bf16 q, k, v: the models' dtype).  The first
// design ran both products as f32 FMA on the CUDA cores (67 TFLOP/s) fed
// from shared memory and sat 66x above the bound.  Now the products run
// on the tensor cores (nvcuda::wmma 16x16x16 bf16, f32 accumulators):
//   * q, k and v are staged in shared memory as bf16 (rows padded by 8,
//     head dim padded with zero columns to DP = a multiple of 16) by
//     16-byte cp.async copies where D is a multiple of 8, element by
//     element otherwise; k and v go in two copy groups, so v is still
//     landing while QK runs;
//   * QK: each warp computes two 16 x 16 score fragments (row strip w % 4,
//     column strips 2 (w / 4) and 2 (w / 4) + 1) over DP / 16 products and
//     stores them to an f32 score tile.  A product of two bf16 values is
//     exact in f32, so only the order and rounding of the sums change;
//   * scale, soft-cap, the masks and the online softmax stay on the CUDA
//     cores in f32, as in the first design;
//   * PV: p is split as p_hi = bf16(p) and p_lo = bf16(p - p_hi), two bf16
//     tiles, and each warp accumulates p_hi v + p_lo v for its output
//     fragments (row strip w % 4, column strips w / 4 + 2 t): about 16
//     bits of p, where p alone in bf16 (8 bits) would not hold the gate of
//     one bf16 ulp of the output;
//   * a wmma accumulator's element layout is opaque, so each key tile's PV
//     product goes to an f32 tile in shared memory (aliasing the score
//     tile, which the softmax has consumed) and each thread applies acc =
//     acc * alpha + pv to its own rows and columns.
// Shared memory (dynamic): q, k, v 3 x 64 x (DP + 8) bf16, the score / PV
// tile max(64 x 68, 64 x (DP + 4)) f32, p_hi and p_lo 2 x 64 x 72 bf16:
// 105,216 bytes at D = 128 (two blocks an SM), 187,136 at D = 256.  What
// is left: cp.async double buffering of k and v across key tiles, a
// 128-row q tile, S and P kept in registers (mma.sync fragments of known
// layout) instead of shared memory, and wgmma.
//
// flash_fwd_f32_kernel (f32 q, k, v): the first design, unchanged.  The
// q tile and one 64-row k and v tile at a time are staged as f32 (rows
// padded by one float so the 16 threads of a half-warp read 16 banks);
// each thread computes a 4 x 4 block of scores and its acc block in f32
// FMA.  bf16 products of f32 inputs would not be exact, and TF32 keeps
// three digits, so the tensor cores stay out; expected an order of
// magnitude above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 16 x 16, 8 warps
constexpr int kTQ = 64;         // query rows per block
constexpr int kTK = 64;         // key rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// The key range that can hold a live key for some row of the q tile at
// q0: [begin, end), begin rounded down to a key tile.
__device__ __forceinline__ int2 key_range(int q0, int Sq, int Sk, int causal,
                                          int window) {
  const int shift = Sk - Sq;
  const int q_last = min(q0 + kTQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_last + shift + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + shift - window + 1);
  return make_int2((k_begin / kTK) * kTK, k_end);
}

// The block's output rows, from acc (rows ty + 16 i, columns tx + 16 j)
// and the row sums l.  Rows with no live key (only where causal and q +
// Sk - Sq < 0) get sum(v) / pad_len, as the TPU kernel's padding gives
// them; `vsum` is DP floats of shared memory the caller no longer needs.
// Starts with a barrier: the caller's last reads of shared memory are done.
template <typename T, int NJ>
__device__ __forceinline__ void write_rows(
    T* __restrict__ ob, const T* __restrict__ vb, const float (&acc)[4][NJ],
    const float* ls, float* vsum, int q0, int Sq, int Sk, int D, int causal,
    int pad_len) {
  constexpr int DP = 16 * NJ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int shift = Sk - Sq;
  __syncthreads();
  if (causal && q0 + shift < 0) {
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
        ob[(size_t)qr * D + c] = from_f<T>(dead ? vsum[c] : acc[i][j] * inv_l);
    }
  }
}

// ------------------------------------------------------------ f32 (FMA)
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
// stride ld), zero beyond `rows` and beyond D.
template <int DP>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src, int r0,
                                      int n, int rows, int D) {
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    const int gr = r0 + r;
    dst[r * ld + c] = (gr < rows && c < D) ? src[(size_t)gr * D + c] : 0.0f;
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int KH, int Sq, int Sk, int D, int causal,
                     int window, int pad_len, float scale, float softcap) {
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

  const float* qb = q + ((size_t)b * H + h) * Sq * D;
  const float* kb = k + ((size_t)b * KH + kvh) * Sk * D;
  const float* vb = v + ((size_t)b * KH + kvh) * Sk * D;
  float* ob = out + ((size_t)b * H + h) * Sq * D;

  stage<DP>(qs, L::QS, qb, q0, kTQ, Sq, D);
  if (tid < kTQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
  }
  const int2 kr = key_range(q0, Sq, Sk, causal, window);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = kr.x; k0 < kr.y; k0 += kTK) {
    __syncthreads();   // previous tile's k, v, p fully read
    stage<DP>(ks, L::QS, kb, k0, kTK, Sk, D);
    stage<DP>(vs, DP, vb, k0, kTK, Sk, D);
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
  write_rows<float, NJ>(ob, vb, acc, ls, ps, q0, Sq, Sk, D, causal, pad_len);
}

// ---------------------------------------------------- bf16 (tensor cores)
constexpr int kPadB = 8;            // bf16 row pad: rows stay 16-byte aligned
constexpr int kLdS = kTK + 4;       // f32 score tile row stride
constexpr int kLdP = kTK + kPadB;   // p_hi / p_lo row stride, bf16

// Shared-memory layout, in bytes, for a padded head dim DP = 16 * NJ;
// every region starts on 32 bytes, as wmma's loads and stores ask.
template <int NJ>
struct SmemBf16 {
  static constexpr int DP = 16 * NJ;
  static constexpr int LD = DP + kPadB;      // q, k, v row stride (bf16)
  static constexpr int LDO = DP + 4;         // PV tile row stride (f32)
  static constexpr size_t tile = (size_t)kTQ * LD * sizeof(bf16);
  static constexpr size_t q = 0;
  static constexpr size_t k = q + tile;
  static constexpr size_t v = k + tile;
  static constexpr size_t sp = v + tile;     // the scores, then PV
  static constexpr size_t sp_bytes =
      sizeof(float) * kTQ * (kLdS > LDO ? kLdS : LDO);
  static constexpr size_t hi = sp + sp_bytes;
  static constexpr size_t lo = hi + (size_t)kTQ * kLdP * sizeof(bf16);
  static constexpr size_t m = lo + (size_t)kTQ * kLdP * sizeof(bf16);
  static constexpr size_t l = m + kTQ * sizeof(float);
  static constexpr size_t alpha = l + kTQ * sizeof(float);
  static constexpr size_t bytes = alpha + kTQ * sizeof(float);
};

// Stage rows [r0, r0 + 64) of a (rows, D) bf16 matrix into dst (64 x DP,
// row stride DP + kPadB), zero beyond `rows` and beyond D: 16-byte
// cp.async copies where `vec` (D a multiple of 8, pointers aligned),
// element by element otherwise.
template <int DP>
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int rows, int D, int vec) {
  constexpr int LD = DP + kPadB;
  constexpr int CH = DP / 8;       // 16-byte chunks a row
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < kTK * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = r0 + r;
    bf16* d = dst + r * LD + c;
    if (vec) {
      const bool ok = gr < rows && c < D;
      cp_async::copy16(d, src + (ok ? (size_t)gr * D + c : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < rows && c + e < D) ? src[(size_t)gr * D + c + e] : zero;
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int H, int KH, int Sq, int Sk, int D, int causal,
                      int window, int pad_len, float scale, float softcap,
                      int vec) {
  using L = SmemBf16<NJ>;
  constexpr int DP = L::DP;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::sp);
  bf16* phi = reinterpret_cast<bf16*>(smem + L::hi);
  bf16* plo = reinterpret_cast<bf16*>(smem + L::lo);
  float* ms = reinterpret_cast<float*>(smem + L::m);
  float* ls = reinterpret_cast<float*>(smem + L::l);
  float* as = reinterpret_cast<float*>(smem + L::alpha);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int shift = Sk - Sq;                 // causal ends aligned

  const bf16* qb = q + ((size_t)b * H + h) * Sq * D;
  const bf16* kb = k + ((size_t)b * KH + kvh) * Sk * D;
  const bf16* vb = v + ((size_t)b * KH + kvh) * Sk * D;
  bf16* ob = out + ((size_t)b * H + h) * Sq * D;

  stage_bf16<DP>(qs, qb, q0, Sq, D, vec);
  cp_async::commit();
  if (tid < kTQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
  }
  const int2 kr = key_range(q0, Sq, Sk, causal, window);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  const int wi = warp % 4;          // the warp's 16-row strip of the tile
  for (int k0 = kr.x; k0 < kr.y; k0 += kTK) {
    __syncthreads();   // previous tile's k, v and PV tile fully read
    stage_bf16<DP>(ks, kb, k0, Sk, D, vec);
    cp_async::commit();
    stage_bf16<DP>(vs, vb, k0, Sk, D, vec);
    cp_async::commit();
    cp_async::wait<1>();             // q and k landed; v may be in flight
    __syncthreads();

    // scores: rows of strip wi against key strips 2 (warp / 4) + {0, 1}
    {
      const int j0 = (warp / 4) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s0, s1;
      wmma::fill_fragment(s0, 0.0f);
      wmma::fill_fragment(s1, 0.0f);
#pragma unroll
      for (int d = 0; d < DP; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            b0, b1;
        wmma::load_matrix_sync(a, qs + wi * 16 * LD + d, LD);
        wmma::load_matrix_sync(b0, ks + j0 * 16 * LD + d, LD);
        wmma::load_matrix_sync(b1, ks + (j0 + 1) * 16 * LD + d, LD);
        wmma::mma_sync(s0, a, b0, s0);
        wmma::mma_sync(s1, a, b1, s1);
      }
      wmma::store_matrix_sync(ss + wi * 16 * kLdS + j0 * 16, s0, kLdS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(ss + wi * 16 * kLdS + (j0 + 1) * 16, s1, kLdS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // scale, soft-cap, masks and the online softmax in f32: four
    // neighbouring lanes share a row, 16 keys each; p leaves as p_hi, p_lo
    {
      const int r = tid / 4;
      const int c0 = (tid % 4) * 16;
      const int qp = q0 + r + shift;
      float x[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int kp = k0 + c0 + c;
        float t = ss[r * kLdS + c0 + c] * scale;
        if (softcap > 0.0f) t = tanhf(t / softcap) * softcap;
        bool live = kp < Sk;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && qp - kp < window;
        x[c] = live ? t : kNegInf;
      }
      float mx = x[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) mx = fmaxf(mx, x[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(x[c] - m_new);
        const bf16 p_hi = __float2bfloat16(p);
        phi[r * kLdP + c0 + c] = p_hi;
        plo[r * kLdP + c0 + c] = __float2bfloat16(p - __bfloat162float(p_hi));
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
    cp_async::wait<0>();             // v landed
    __syncthreads();

    // PV = p_hi v + p_lo v into the PV tile (the scores are consumed):
    // rows of strip wi, column strips warp / 4 + 2 t
    for (int j = warp / 4; j < NJ; j += 2) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(bv, vs + kk * LD + j * 16, LD);
        wmma::load_matrix_sync(a, phi + wi * 16 * kLdP + kk, kLdP);
        wmma::mma_sync(o, a, bv, o);
        wmma::load_matrix_sync(a, plo + wi * 16 * kLdP + kk, kLdP);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(ss + wi * 16 * L::LDO + j * 16, o, L::LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // acc = acc * alpha + PV, for rows ty + 16i and columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float alpha = as[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = acc[i][j] * alpha + ss[r * L::LDO + tx + 16 * j];
    }
  }
  cp_async::wait<0>();   // q's copies, where no key tile was walked
  write_rows<bf16, NJ>(ob, vb, acc, ls, ss, q0, Sq, Sk, D, causal, pad_len);
}

template <int NJ>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int KH, int Sq, int Sk, int D, int causal,
                int window, int pad_len, float scale, float softcap,
                cudaStream_t stream) {
  const size_t smem = SmemBf16<NJ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_fwd_bf16_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, KH, Sq, Sk, D,
      causal, window, pad_len, scale, softcap, vec);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int KH, int Sq, int Sk, int D, int causal,
               int window, int pad_len, float scale, float softcap,
               cudaStream_t stream) {
  const size_t smem = Smem<NJ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_fwd_f32_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KH, Sq, Sk,
      D, causal, window, pad_len, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out (B, H, Sq, D); k, v (B, KH, Sk, D); one dtype (bf16: bf16, else
// f32).  window <= 0: none.  softcap <= 0: none.  pad_len = nk * tk of the
// TPU kernel's key padding, for rows with no live key.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KH, int Sq, int Sk, int D, int causal,
                                   int window, int pad_len, int bf16_io,
                                   float scale, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > 256 || pad_len < Sk || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(NJ)                                                      \
  if (D <= 16 * NJ)                                                         \
    return bf16_io ? launch_bf16<NJ>(q, k, v, out, B, H, KH, Sq, Sk, D,     \
                                     causal, window, pad_len, scale,        \
                                     softcap, s)                            \
                   : launch_f32<NJ>(q, k, v, out, B, H, KH, Sq, Sk, D,      \
                                    causal, window, pad_len, scale, softcap, \
                                    s);
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(6)
  FLASH_CASE(8)
  FLASH_CASE(16)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
