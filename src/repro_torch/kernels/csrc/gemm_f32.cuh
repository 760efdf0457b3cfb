// Split-K f32 tile product for Hopper (sm_90a), shared by K1's f32
// instance (dense_fwd.cu, dense_fwd_f32) and K2 (dense_bwd.cu,
// dense_dx_f32).  Header only: each source wraps these device functions in
// __global__ kernels of its own name, so a profile tells K1 from K2.
//
//   C[m, n] = sum_k A[m, k] * B(k, n)
//   A (M, K) row-major with row stride K (x for K1, g for K2);
//   B(k, n) = w[k * N + n] (kWT false: w is (K, N), K1)
//          or w[n * K + k] (kWT true: w^T read by index, w is (N, K), K2);
//   kMasked: A[m, k] counts only where mask[m, k] > 0 (K2's relu mask, the
//   saved forward output; mask may still be null).
//
// Pass 1 (splitk_tile): a block owns one 64 x 64 output tile and one
// contiguous slice of K, `depth` deep (a multiple of kDepth) except the
// last; blockIdx.z picks the slice.  kernels/dense.py picks splits and
// depth from the shapes (dense_splits, split_depth); the launcher refuses
// a pair that leaves part of K out or a slice empty.  256 threads hold 4 x 4 outputs each in
// registers: rows ty + 16 i, columns 4 tx + j (kWT false) or tx + 16 j
// (kWT true), the columns picked so that every shared-memory read is a
// conflict-free 16-byte load.  The slice walks K in steps of kDepth = 16
// through a two-stage shared-memory ring: while the block multiplies one
// step, cp.async 16-byte copies (cp.async.cg, zero fill past an edge) bring
// the next.  An operand takes that path where its row stride is a multiple
// of 4 floats and its pointer 16-byte aligned (vecA, vecB, decided once per
// launch); otherwise the same kernel loads it element by element into the
// same ring.  A block whose slice is empty writes zeros.
// With one slice (splits == 1) pass 1 applies the epilogue (bias, relu) and
// writes the output; otherwise it writes its partial sums to
// part[z][M][N] and pass 2 (splitk_sum) adds them in slice order, then
// applies the epilogue.  No float atomics: a rerun gives identical bits.
//
// Shared memory: A and the mask 2 x 64 x 20 floats each, B 2 x 16 x 68
// (kWT false) or 2 x 64 x 20 floats (kWT true); rows padded so 16-byte
// rows stay aligned and the reads above hit distinct banks (w^T's rows,
// 20 floats apart, land eight threads of a 16-byte read on eight distinct
// bank quads).  The 64 x 64 tile of the first design is kept: ptxas
// (-Xptxas -v, sm_90a) gives pass 1 64 registers and 19,024 (K1) or
// 30,720 (K2) bytes of shared memory, no spill in K2 and 4 bytes in K1,
// so two to four blocks fit an SM and a 2000 -> 2000 layer's 256 blocks
// run in one wave.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace gemm_f32 {

constexpr int kTile = 64;     // output tile, rows and columns
constexpr int kDepth = 16;    // K step through shared memory
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kDepth + 4;   // k-contiguous tile rows (A, mask, w^T)
constexpr int kLdN = kTile + 4;   // n-contiguous tile rows (w)

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

}  // namespace gemm_f32
