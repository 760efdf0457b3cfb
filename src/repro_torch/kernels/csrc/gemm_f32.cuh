// Split-K f32 tile product for Hopper (sm_90a), shared by K1's f32
// instance (dense_fwd.cu, dense_fwd_f32), K2 (dense_bwd.cu, dense_dx_f32)
// and K3 (dense_bwd.cu, dense_dwdb_f32).  Header only: each source wraps
// these device functions in __global__ kernels of its own name, so a
// profile tells the three apart.  K1 and K2 run splitk_tile, K3
// splitk_tile_at (its operand form and register tiles); the ring, the
// slices, the masking and pass 2 are the same.
//
//   C[m, n] = sum_k A(m, k) * B(k, n), three operand forms:
//   K1 <kWT false>: A = x (M, K) row-major, B(k, n) = w[k * N + n];
//   K2 <kWT true, kMasked>: A = g (M, K) masked by mask[m, k] > 0 (the
//     relu mask, the saved forward output; may be null), B(k, n) =
//     w[n * K + k] (w^T read by index, w is (N, K));
//   K3 <kAT, kMasked>: A(m, k) = x[k * (M - 1) + m] for m < M - 1 (x^T
//     read by index, x is (K, M - 1)) and 1 for m = M - 1, B(k, n) =
//     g[k * N + n] masked by mask[k, n] > 0: rows 0 .. M - 2 of C are dw =
//     x^T g, row M - 1 is db = the sum of g's rows, both in one fixed order.
//
// What bounds them.  At the CNN's FC widths (M = 64 rows at case7) each
// product does 2 x 64 x 2000 x 2000 flops over a 16 MB weight or weight
// gradient, 32 flops a byte, above the 20 where the H100's f32 FMA peak
// (67 TFLOP/s) meets its memory rate: the FMA rate bounds them (7.6 us a
// 2000 x 2000 launch, the bytes 4.9 us).  Next in line is shared memory:
// it delivers 128 bytes a clock to an SM, so a 4 x 4 register tile fed
// by two 16-byte reads a k (16 FMAs) keeps the FMA pipes at most half
// busy.  No TF32: the gradient gate is 1e-4 x scale.
//
// What the design does about it.  Pass 1 (splitk_tile): a block owns one
// 64 x 64 output tile and one contiguous slice of K, `depth` deep (a
// multiple of kDepth) except the last; blockIdx.z picks the slice.
// kernels/dense.py picks splits and depth from the shapes (dense_splits,
// split_depth), so blocks fill the card where the tiles alone do not; the
// launcher refuses a pair that leaves part of K out or a slice empty.  256
// threads hold 4 x 4 outputs each in registers, the columns (and K3's
// rows) picked so that every shared-memory read is a conflict-free
// 16-byte load.  The slice walks K in steps of kDepth = 16 through a
// two-stage shared-memory ring: while the block multiplies one step,
// cp.async 16-byte copies (cp.async.cg, zero fill past an edge) bring the
// next.  An operand takes that path where its row stride is a multiple of
// 4 floats and its pointer 16-byte aligned (vecA, vecB, decided once per
// launch); otherwise the same kernel loads it element by element into the
// same ring.  A mask is copied beside its operand and each thread zeroes
// its own chunk where the mask is not > 0 before the block reads it.  With
// one slice (splits == 1) pass 1 applies the epilogue (bias, relu) and
// writes the output; otherwise it writes its partial sums to part[z][M][N]
// and pass 2 (splitk_sum) adds them in slice order, then applies the
// epilogue.  No float atomics: a rerun gives identical bits.
//
// Shared memory: K1/K2 stage A (and the mask) as 64 rows of 16 k (rows
// padded to 20 floats), K1's w as 16 k x 64 columns (68), K2's w^T as 64
// columns x 16 k.  K3 stages x^T as 16 k x 64 or 128 rows, g and its mask
// as 16 k x 64 columns, so its threads read both operands along their
// rows and columns.  Rows are padded so 16-byte rows stay aligned and the
// reads above hit distinct banks.  K3's output is up to 2001 x 2000 over a
// 64-deep reduction, where the 64 x 64 tile of 4 x 4 ran at the speed of
// torch.matmul and no faster, held by shared memory as above: where the
// output has 528 64 x 64 tiles or more (four 128-thread blocks an SM),
// K3 takes a 128 x 64 tile of 8 x 8 registers a thread, four 16-byte
// reads a k for 64 FMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace gemm_f32 {

constexpr int kTile = 64;     // output tile, rows and columns
constexpr int kDepth = 16;    // K step through shared memory
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kDepth + 4;   // k-contiguous tile rows (A, mask, w^T)
constexpr int kLdN = kTile + 4;   // n-contiguous tile rows (w, g)

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four elements of row `r` of a row-major matrix (stride ld), starting at
// column c, zero where r >= rows or a column >= cols; with `mask`, zero
// also where the mask's element is not > 0.
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        const float* __restrict__ mask,
                                        int r, int c, int rows, int cols,
                                        int ld) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t i = (size_t)r * ld + c + e;
    const bool in = r < rows && c + e < cols;
    v[e] = in && (mask == nullptr || mask[i] > 0.0f) ? p[i] : 0.0f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kWT, bool kMasked>
struct Smem {
  float a[2][kTile][kLd];                        // a[s][m][k]
  float m[kMasked ? 2 : 1][kMasked ? kTile : 1][kLd];
  float b[2][kWT ? kTile : kDepth][kWT ? kLd : kLdN];  // [n][k] or [k][n]
};

// Pass 1: see the note at the top.  grid (ceil(N/64), ceil(M/64), splits).
template <bool kWT, bool kMasked>
__device__ __forceinline__ void splitk_tile(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ mask, const float* __restrict__ bias,
    float* __restrict__ part, float* __restrict__ out, int M, int N, int K,
    int relu, int splits, int depth, int vecA, int vecB) {
  __shared__ __align__(16) Smem<kWT, kMasked> sm;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int kbeg = min(K, (int)blockIdx.z * depth);
  const int kend = min(K, kbeg + depth);
  const int steps = (kend - kbeg + kDepth - 1) / kDepth;
  const bool masked = mask != nullptr;   // read only where kMasked

  // This thread's 16-byte chunk of each operand tile.
  const int ar = tid / 4, ac = (tid % 4) * 4;    // A, mask, w^T: row, k
  const int bk = tid / 16, bc = (tid % 16) * 4;  // w: k, column

  auto load = [&](int s, int k0) {
    // A (and the mask): 64 rows x 16 k; rows past M, k past kend are zero
    {
      const int r = m0 + ar, k = k0 + ac;
      if (vecA) {
        const bool ok = r < M && k < kend;
        const size_t i = ok ? (size_t)r * K + k : 0;
        cp_async::copy16(&sm.a[s][ar][ac], A + i, ok);
        if constexpr (kMasked)
          if (masked) cp_async::copy16(&sm.m[s][ar][ac], mask + i, ok);
      } else {
        *reinterpret_cast<float4*>(&sm.a[s][ar][ac]) =
            load4(A, kMasked ? mask : nullptr, r, k, M, kend, K);
      }
    }
    if constexpr (kWT) {   // w^T: 64 columns n x 16 k, from w (N, K)
      const int n = n0 + ar, k = k0 + ac;
      if (vecB) {
        const bool ok = n < N && k < kend;
        cp_async::copy16(&sm.b[s][ar][ac],
                         W + (ok ? (size_t)n * K + k : 0), ok);
      } else {
        *reinterpret_cast<float4*>(&sm.b[s][ar][ac]) =
            load4(W, nullptr, n, k, N, kend, K);
      }
    } else {     // w: 16 k x 64 columns n, from w (K, N)
      const int k = k0 + bk, n = n0 + bc;
      if (vecB) {
        const bool ok = k < kend && n < N;
        cp_async::copy16(&sm.b[s][bk][bc],
                         W + (ok ? (size_t)k * N + n : 0), ok);
      } else {
        *reinterpret_cast<float4*>(&sm.b[s][bk][bc]) =
            load4(W, nullptr, k, n, kend, N, N);
      }
    }
  };

  float acc[4][4] = {};
  if (steps > 0) load(0, kbeg);
  cp_async::commit();
  for (int t = 0; t < steps; ++t) {
    const int s = t & 1;
    if (t + 1 < steps) load(s ^ 1, kbeg + (t + 1) * kDepth);
    cp_async::commit();
    cp_async::wait<1>();   // every group but the newest: step t has landed
    if constexpr (kMasked) {
      if (masked && vecA) {  // this thread's own copies are visible to it
        float4* a = reinterpret_cast<float4*>(&sm.a[s][ar][ac]);
        const float4 mk =
            *reinterpret_cast<const float4*>(&sm.m[s][ar][ac]);
        float4 v = *a;
        v.x = mk.x > 0.0f ? v.x : 0.0f;
        v.y = mk.y > 0.0f ? v.y : 0.0f;
        v.z = mk.z > 0.0f ? v.z : 0.0f;
        v.w = mk.w > 0.0f ? v.w : 0.0f;
        *a = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < kDepth; k4 += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(&sm.a[s][ty + 16 * i][k4]);
      if constexpr (kWT) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&sm.b[s][tx + 16 * j][k4]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[4];
        if constexpr (kWT) {
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = lane(bv[j], kk);
        } else {
          const float4 row =
              *reinterpret_cast<const float4*>(&sm.b[s][k4 + kk][4 * tx]);
          b[0] = row.x; b[1] = row.y; b[2] = row.z; b[3] = row.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const bool whole = splits == 1;
  float* dst = whole ? out : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + (kWT ? tx + 16 * j : 4 * tx + j);
      if (c >= N) continue;
      float v = acc[i][j];
      if (whole) {
        if (bias != nullptr) v += bias[c];
        if (relu) v = fmaxf(v, 0.0f);
      }
      dst[(size_t)r * N + c] = v;
    }
  }
}

// Pass 2: out = epilogue(sum of the `splits` partials, in slice order);
// one thread per output element.
__device__ __forceinline__ void splitk_sum(const float* __restrict__ part,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int M,
                                           int N, int relu, int splits) {
  const size_t n = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * n + idx];
  if (bias != nullptr) v += bias[idx % N];
  if (relu) v = fmaxf(v, 0.0f);
  out[idx] = v;
}

// Whether an operand can take the 16-byte path: row stride a multiple of
// 4 floats and a 16-byte-aligned pointer (null counts as aligned).
inline bool vec_ok(int ld, const void* p) {
  return ld % 4 == 0 && (uintptr_t)p % 16 == 0;
}

// Launch pass 1 (and pass 2 when splits > 1) on `stream`: pass1 and pass2
// are the __global__ wrappers of splitk_tile<kWT, ...> and splitk_sum.
// Returns cudaGetLastError() after the last launch; never synchronises.
template <bool kWT, typename P1, typename P2>
inline int splitk_launch(P1 pass1, P2 pass2, const float* A, const float* W,
                         const float* mask, const float* bias, float* part,
                         float* out, int M, int N, int K, int relu,
                         int splits, int depth, cudaStream_t stream) {
  // the slices cover K, none is empty, each starts on a kDepth step
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || depth <= 0 ||
      depth % kDepth != 0 || (long long)splits * depth < K ||
      (long long)(splits - 1) * depth >= K ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vecA = vec_ok(K, A) && vec_ok(K, mask);
  const int vecB = vec_ok(kWT ? K : N, W);
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  pass1<<<grid, kThreads, 0, stream>>>(A, W, mask, bias, part, out, M, N, K,
                                       relu, splits, depth, vecA, vecB);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)M * N;
  pass2<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, bias, out, M, N, relu, splits);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// K3's form: C (M, N) = A B with A = [x^T; 1] (x (K, M - 1) read by index,
// row M - 1 ones) and B = g (K, N) masked by mask > 0.
// ----------------------------------------------------------------------

// Four elements of rows m .. m + 3 of A = [x^T; 1] at column k (x's row
// stride is rows - 1); zero at rows >= rows or k >= kend.
__device__ __forceinline__ float4 load4_at(const float* __restrict__ x,
                                           int k, int m, int kend,
                                           int rows) {
  const int ld = rows - 1;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = m + e;
    v[e] = k >= kend || r >= rows ? 0.0f
           : r == ld ? 1.0f : x[(size_t)k * ld + r];
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The register tile of a K3 block: 64 x 64 outputs by 256 threads of 4 x 4
// (rows 4 ty + i, columns 4 tx + j), or (kBig) 128 x 64 by 128 threads of
// 8 x 8 (rows 64 gi + 4 ty + i, columns 32 gj + 4 tx + j), which reads
// shared memory half as often per FMA.
template <bool kBig>
struct AtTile {
  static constexpr int kThreads = kBig ? 128 : 256;
  static constexpr int kRows = kBig ? 128 : 64;   // output rows a block
  static constexpr int kRG = kBig ? 2 : 1;   // 4-row groups a thread
  static constexpr int kCG = kBig ? 2 : 1;   // 4-column groups a thread
  static constexpr int kTX = kTile / (4 * kCG);   // threads along a row
};

template <bool kBig>
struct SmemAt {
  float a[2][kDepth][AtTile<kBig>::kRows + 4];   // a[s][k][m]
  float b[2][kDepth][kLdN];                      // b[s][k][n]
  float m[2][kDepth][kLdN];                      // b's mask
};

// Pass 1 of K3: grid (ceil(N/64), ceil(M/kRows), splits), the same ring,
// slices and partials as splitk_tile; no epilogue.
template <bool kBig>
__device__ __forceinline__ void splitk_tile_at(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ mask, float* __restrict__ part,
    float* __restrict__ out, int M, int N, int K, int splits, int depth,
    int vecA, int vecB) {
  using T = AtTile<kBig>;
  constexpr int kR = T::kRows;
  __shared__ __align__(16) SmemAt<kBig> sm;

  const int tid = threadIdx.x;
  const int tx = tid % T::kTX;
  const int ty = tid / T::kTX;
  const int m0 = blockIdx.y * kR;
  const int n0 = blockIdx.x * kTile;
  const int kbeg = min(K, (int)blockIdx.z * depth);
  const int kend = min(K, kbeg + depth);
  const int steps = (kend - kbeg + kDepth - 1) / kDepth;
  const bool masked = mask != nullptr;
  const int ld = M - 1;   // x's row stride, and A's row of ones

  // 16-byte chunks: A's kDepth x kR / 4, B's (and the mask's) kDepth x 16
  auto load = [&](int s, int k0) {
#pragma unroll
    for (int c = tid; c < kDepth * kR / 4; c += T::kThreads) {
      const int kk = c / (kR / 4), mm = c % (kR / 4) * 4;
      const int k = k0 + kk, m = m0 + mm;
      float* dst = &sm.a[s][kk][mm];
      if (vecA && m != ld) {   // ld % 4 == 0: all in x or all past it
        const bool ok = k < kend && m < ld;
        cp_async::copy16(dst, x + (ok ? (size_t)k * ld + m : 0), ok);
      } else {
        *reinterpret_cast<float4*>(dst) = load4_at(x, k, m, kend, M);
      }
    }
#pragma unroll
    for (int c = tid; c < kDepth * kTile / 4; c += T::kThreads) {
      const int kk = c / (kTile / 4), nn = c % (kTile / 4) * 4;
      const int k = k0 + kk, n = n0 + nn;
      if (vecB) {
        const bool ok = k < kend && n < N;
        const size_t i = ok ? (size_t)k * N + n : 0;
        cp_async::copy16(&sm.b[s][kk][nn], g + i, ok);
        if (masked) cp_async::copy16(&sm.m[s][kk][nn], mask + i, ok);
      } else {
        *reinterpret_cast<float4*>(&sm.b[s][kk][nn]) =
            load4(g, mask, k, n, kend, N, N);
      }
    }
  };

  float acc[4 * T::kRG][4 * T::kCG] = {};
  if (steps > 0) load(0, kbeg);
  cp_async::commit();
  for (int t = 0; t < steps; ++t) {
    const int s = t & 1;
    if (t + 1 < steps) load(s ^ 1, kbeg + (t + 1) * kDepth);
    cp_async::commit();
    cp_async::wait<1>();   // every group but the newest: step t has landed
    if (masked && vecB) {  // this thread's own copies are visible to it
#pragma unroll
      for (int c = tid; c < kDepth * kTile / 4; c += T::kThreads) {
        const int kk = c / (kTile / 4), nn = c % (kTile / 4) * 4;
        float4* b = reinterpret_cast<float4*>(&sm.b[s][kk][nn]);
        const float4 mk = *reinterpret_cast<const float4*>(&sm.m[s][kk][nn]);
        float4 v = *b;
        v.x = mk.x > 0.0f ? v.x : 0.0f;
        v.y = mk.y > 0.0f ? v.y : 0.0f;
        v.z = mk.z > 0.0f ? v.z : 0.0f;
        v.w = mk.w > 0.0f ? v.w : 0.0f;
        *b = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4 * T::kRG], b[4 * T::kCG];
#pragma unroll
      for (int gi = 0; gi < T::kRG; ++gi) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sm.a[s][kk][64 * gi + 4 * ty]);
        a[4 * gi] = v.x; a[4 * gi + 1] = v.y;
        a[4 * gi + 2] = v.z; a[4 * gi + 3] = v.w;
      }
#pragma unroll
      for (int gj = 0; gj < T::kCG; ++gj) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sm.b[s][kk][kTile / T::kCG * gj + 4 * tx]);
        b[4 * gj] = v.x; b[4 * gj + 1] = v.y;
        b[4 * gj + 2] = v.z; b[4 * gj + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * T::kRG; ++i)
#pragma unroll
        for (int j = 0; j < 4 * T::kCG; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = splits == 1 ? out : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4 * T::kRG; ++i) {
    const int r = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (r >= M) continue;
    float* row = dst + (size_t)r * N;
#pragma unroll
    for (int gj = 0; gj < T::kCG; ++gj) {
      const int c = n0 + kTile / T::kCG * gj + 4 * tx;
      if (N % 4 == 0) {   // 16-byte stores, neighbouring lanes adjacent
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * gj], acc[i][4 * gj + 1],
                          acc[i][4 * gj + 2], acc[i][4 * gj + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) row[c + j] = acc[i][4 * gj + j];
      }
    }
  }
}

// 64 x 64 tiles (K3's M rows by N) at or past which K3 takes the 128 x 64
// register tile: four of its 128-thread blocks on every SM.  The slices
// never split there (dense_splits stops at 264 blocks).
constexpr long long kBigTiles = 4 * 132;

// Launch K3: pass1 / big are the __global__ wrappers of
// splitk_tile_at<false> / <true>, pass2 of splitk_sum.  Returns
// cudaGetLastError() after the last launch; never synchronises.
template <typename P1, typename PB, typename P2>
inline int splitk_launch_at(P1 pass1, PB big, P2 pass2, const float* x,
                            const float* g, const float* mask, float* part,
                            float* out, int M, int N, int K, int splits,
                            int depth, cudaStream_t stream) {
  if (M < 2 || N <= 0 || K <= 0 || splits <= 0 || depth <= 0 ||
      depth % kDepth != 0 || (long long)splits * depth < K ||
      (long long)(splits - 1) * depth >= K ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vecA = vec_ok(M - 1, x);
  const int vecB = vec_ok(N, g) && vec_ok(N, mask);
  const long long tiles =
      (long long)((N + kTile - 1) / kTile) * ((M + kTile - 1) / kTile);
  if (splits == 1 && tiles >= kBigTiles) {
    constexpr int kR = AtTile<true>::kRows;
    dim3 grid((N + kTile - 1) / kTile, (M + kR - 1) / kR, 1);
    big<<<grid, AtTile<true>::kThreads, 0, stream>>>(
        x, g, mask, part, out, M, N, K, splits, depth, vecA, vecB);
    return (int)cudaGetLastError();
  }
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  pass1<<<grid, AtTile<false>::kThreads, 0, stream>>>(
      x, g, mask, part, out, M, N, K, splits, depth, vecA, vecB);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)M * N;
  pass2<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, nullptr, out, M, N, 0, splits);
  return (int)cudaGetLastError();
}

}  // namespace gemm_f32
