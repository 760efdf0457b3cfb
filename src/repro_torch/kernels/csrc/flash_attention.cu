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
// tensor-core rate, 989 TFLOP/s: 0.56 ms.  In f32 it is the FMA rate, 67
// TFLOP/s, or, for the three TF32 products a 3xTF32 split does, 3 x the
// flops at 495 TFLOP/s (2.5x lower).
//
// Two kernels, picked by flash_attention_fwd's bf16 flag, each a block
// per (b, h, 64-row q tile) walking the key tiles of the causal/window
// band.  flash_fwd_bf16_kernel: 256 threads (8 warps), 64-row key tiles;
// four neighbouring lanes own a row's softmax statistics (m, l, alpha in
// shared memory) and combine them by warp shuffles; each thread keeps a
// 4 x (D/16) block of acc, rows ty + 16 i and columns tx + 16 j, in
// registers.
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
// flash_fwd_f32_kernel (f32 q, k, v).  The first design ran both products
// as f32 FMA fed by scalar shared loads (8 loads per 16 FMAs in QK),
// staged k and v element by element and synchronously, took 115 KB of
// shared memory at D = 128 (one block an SM) and three block barriers a
// key tile for the softmax: 22% of the FMA bound.  Now the products run
// on the tensor cores in 3xTF32 (mma.sync m16n8k8, inline PTX): each
// operand is split as x_hi = tf32(x), x_lo = tf32(x - x_hi) (rounded as
// cvt.rna rounds, by two integer operations) and a b = a_lo b_hi + a_hi
// b_lo + a_hi b_hi in f32 accumulators, about 22 bits of each operand
// where one TF32 product (11) misses the f32 gate
// (tests/test_torch_flash_numerics.py models both):
//   * 4 warps, FlashAttention-2 style: a warp owns 16 q rows; scores stay
//     in registers as C fragments; scale, soft-cap, masks and the online
//     softmax run there, each row's max and sum combined by shuffles
//     within the lane quad, with no block barrier; the masks are skipped
//     on tiles live for every row; p's C fragment is PV's A fragment as
//     it stands (the k index taken as (2t, 2t + 1));
//   * q, then 32-row k and v tiles through a two-stage cp.async ring (16
//     bytes a copy; 4 where D % 4 != 0 or a pointer is off 16 bytes), so
//     tile j + 1 lands while tile j computes; rows padded so that fragment
//     loads are free of bank conflicts;
//   * shared memory: q 64 x (DP + 8), k 2 x 32 x (DP + 8), v 2 x 32 x
//     (DP + 4) floats: 103,424 bytes at D = 128 (two blocks an SM),
//     201,728 at D = 256 (one).
// What bounds it now: issue slots and mma.sync latency.  A warp's 32-key
// tile at D = 128 is 384 mma.sync beside 1,680 integer and f32
// instructions that split its 336 operands (five each: every warp splits
// the whole k and v tile again) and the scale, soft-cap, masks and
// softmax of its 512 scores, with two warps a scheduler to hide the
// latency.
// Left: the splits done once a tile for the block (it needs the shared
// memory of a second block), a 128-row q tile, and wgmma.

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

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// The key range that can hold a live key for some row of the q tile at
// q0: [begin, end), begin rounded down to a key tile of TK rows.
template <int TK>
__device__ __forceinline__ int2 key_range(int q0, int Sq, int Sk, int causal,
                                          int window) {
  const int shift = Sk - Sq;
  const int q_last = min(q0 + kTQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_last + shift + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + shift - window + 1);
  return make_int2((k_begin / TK) * TK, k_end);
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

// ---------------------------------------------- f32 (3xTF32 on mma.sync)
constexpr int kThreadsF = 128;   // 4 warps, 16 q rows each
constexpr int kTKF = 32;         // key rows per tile

// Shared-memory layout, in floats, for a padded head dim DP = 16 * NJ: q,
// then a two-stage ring of k and v tiles.  q and k rows are padded by 8
// floats, so the float2 fragment loads (lanes g = 0..7, t = 0..3 at g *
// LDQ + 2 t) hit every bank once per half-warp; v rows by 4, so the
// scalar loads of key rows 2 t and 2 t + 1 at column g do.  Every region
// and row starts on 16 bytes, as cp.async asks.
template <int NJ>
struct SmemF32 {
  static constexpr int DP = 16 * NJ;
  static constexpr int LDQ = DP + 8;     // q and k row stride
  static constexpr int LDV = DP + 4;     // v row stride
  static constexpr int q = 0;
  static constexpr int k = q + kTQ * LDQ;            // stages 0, 1
  static constexpr int v = k + 2 * kTKF * LDQ;       // stages 0, 1
  static constexpr int floats = v + 2 * kTKF * LDV;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Copy rows [r0, r0 + R) of a (rows, D) f32 matrix into dst (R x DP, row
// stride ld), zero beyond `rows` and beyond D: 16-byte cp.async copies
// where `vec` (D a multiple of 4, pointers on 16 bytes), 4-byte ones
// otherwise.  The caller commits the group.
template <int R, int DP>
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int r0, int rows, int D, int vec) {
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < R * CH; i += kThreadsF) {
      const int r = i / CH;
      const int c = (i % CH) * 4;
      const int gr = r0 + r;
      const bool ok = gr < rows && c < D;
      cp_async::copy16(dst + r * ld + c, src + (ok ? (size_t)gr * D + c : 0),
                       ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += kThreadsF) {
      const int r = i / DP;
      const int c = i % DP;
      const int gr = r0 + r;
      const bool ok = gr < rows && c < D;
      cp_async::copy4(dst + r * ld + c, src + (ok ? (size_t)gr * D + c : 0),
                      ok);
    }
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
// from zero, 10 mantissa bits (half of the low 13 bits' range added to
// the magnitude, then the 13 bits cleared): the cvt's bits for every
// finite x, by two integer operations, where the cvt compiles to a longer
// compare-and-select sequence on sm_90a.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (about 2^-22 |x|), hi and lo TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block of 4 warps per (b, h, 64-row q tile); warp w owns rows 16 w ..
// 16 w + 15, lane (g = lane / 4, t = lane % 4) rows g and g + 8 of them.
// The m16n8k8 fragments take their 8-deep k index in the order (2 t, 2 t
// + 1) for fragment slots (t, t + 4), the same in A and B, so a sum over
// k is unchanged: q and k fragments are float2 loads, and a score tile's
// C fragment (rows g, g + 8, keys 2 t, 2 t + 1 of each 8-key group) is
// the A fragment of PV as it stands, with no shuffle.
template <int NJ>
__global__ void __launch_bounds__(kThreadsF)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int KH, int Sq, int Sk, int D, int causal,
                     int window, int pad_len, float scale, float softcap,
                     int vec) {
  using L = SmemF32<NJ>;
  constexpr int DP = L::DP;
  constexpr int LDQ = L::LDQ;
  constexpr int LDV = L::LDV;
  constexpr int NT = kTKF / 8;   // 8-key groups of a tile
  constexpr int NO = DP / 8;     // 8-column groups of the output
  extern __shared__ __align__(16) float sm[];
  float* qs = sm + L::q;

  const int tid = threadIdx.x;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = (tid / 32) * 16 + g;        // this lane's rows: r0, r0 + 8
  const int q0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int shift = Sk - Sq;                 // causal ends aligned
  const int qp[2] = {q0 + r0 + shift, q0 + r0 + 8 + shift};
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  const float* qb = q + ((size_t)b * H + h) * Sq * D;
  const float* kb = k + ((size_t)b * KH + kvh) * Sk * D;
  const float* vb = v + ((size_t)b * KH + kvh) * Sk * D;
  float* ob = out + ((size_t)b * H + h) * Sq * D;

  const int2 kr = key_range<kTKF>(q0, Sq, Sk, causal, window);
  const int nk = kr.y > kr.x ? (kr.y - kr.x + kTKF - 1) / kTKF : 0;
  stage_f32<kTQ, DP>(qs, LDQ, qb, q0, Sq, D, vec);
  if (nk > 0) {
    stage_f32<kTKF, DP>(sm + L::k, LDQ, kb, kr.x, Sk, D, vec);
    stage_f32<kTKF, DP>(sm + L::v, LDV, vb, kr.x, Sk, D, vec);
  }
  cp_async::commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};   // this lane's share of each row's sum

  for (int i = 0; i < nk; ++i) {
    const int k0 = kr.x + i * kTKF;
    if (i + 1 < nk) {   // tile i + 1 lands while tile i computes
      const int st = (i + 1) % 2;
      stage_f32<kTKF, DP>(sm + L::k + st * kTKF * LDQ, LDQ, kb, k0 + kTKF,
                          Sk, D, vec);
      stage_f32<kTKF, DP>(sm + L::v + st * kTKF * LDV, LDV, vb, k0 + kTKF,
                          Sk, D, vec);
    }
    cp_async::commit();
    cp_async::wait<1>();             // q and tile i landed
    __syncthreads();
    const float* ks = sm + L::k + (i % 2) * kTKF * LDQ;
    const float* vs = sm + L::v + (i % 2) * kTKF * LDV;

    // s = q k^T: rows r0 and r0 + 8 against keys k0 + 8 n + 2 t + {0, 1};
    // the small terms in their own accumulators sl, so that eight chains
    // of dependent mma.sync run side by side, not four
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(qs + r0 * LDQ + 8 * kk + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(
          qs + (r0 + 8) * LDQ + 8 * kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(
            ks + (8 * n + g) * LDQ + 8 * kk + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        mma_tf32(sl[n], al, bh);
        mma_tf32(sl[n], ah, bl);
        mma_tf32(s[n], ah, bh);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];

    // scale, soft-cap (x / cap taken as x * (1 / cap)) and masks in f32,
    // the masks only where the tile is not live for every row of the block;
    // each row's max over its quad
    const bool all_live =
        k0 + kTKF <= Sk && (!causal || k0 + kTKF - 1 <= q0 + shift) &&
        (window <= 0 || q0 + kTQ - 1 + shift - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.0f) x = tanhf(x * inv_cap) * softcap;
        if (!all_live) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qr = qp[e / 2];
          bool live = kp < Sk;
          if (causal) live = live && kp <= qr;
          if (window > 0) live = live && qr - kp < window;
          if (!live) x = kNegInf;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);
        l[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];

    // o += p v: key group j's score fragment is PV's A fragment; v's B
    // fragment is key rows 2 t and 2 t + 1 of the group at column g
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* v0 = vs + (8 * j + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[8 * n], bh[0], bl[0]);
        split_tf32(v0[LDV + 8 * n], bh[1], bl[1]);
        mma_tf32(o[n], al, bh);   // 3xTF32, the small terms first
        mma_tf32(o[n], ah, bl);
        mma_tf32(o[n], ah, bh);
      }
    }
    __syncthreads();   // stage i % 2 fully read before tile i + 2 lands
  }
  cp_async::wait<0>();   // q's copies, where no key tile was walked
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // Rows with no live key (only where causal and q + Sk - Sq < 0) get
  // sum(v) / pad_len, as the TPU kernel's padding gives them.
  float* vsum = sm + L::k;   // the k ring, no longer read
  if (causal && q0 + shift < 0) {
    __syncthreads();
    for (int c = tid; c < DP; c += kThreadsF) {
      float a = 0.0f;
      if (c < D)
        for (int kk = 0; kk < Sk; ++kk) a += vb[(size_t)kk * D + c];
      vsum[c] = a / (float)pad_len;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + r0 + 8 * r;
    if (qr >= Sq) continue;
    const bool dead = causal && qr + shift < 0;
    const float inv_l = 1.0f / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c < D)
          ob[(size_t)qr * D + c] = dead ? vsum[c] : o[n][2 * r + e] * inv_l;
      }
  }
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
  const int2 kr = key_range<kTK>(q0, Sq, Sk, causal, window);

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
  const size_t smem = SmemF32<NJ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_fwd_f32_kernel<NJ>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  dim3 grid((Sq + kTQ - 1) / kTQ, H, B);
  flash_fwd_f32_kernel<NJ><<<grid, kThreadsF, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KH, Sq, Sk,
      D, causal, window, pad_len, scale, softcap, vec);
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
