// Fused dense forward for Hopper (sm_90a): out = act(x @ w + b).
//
// Replaces the TPU kernel src/repro/kernels/dense.py::_dense_fwd_kernel
// (pallas_call in _forward; entry dense_pallas, dispatched by
// src/repro/kernels/ops.py::dense).  Same contract: x (M, K) and w (K, N)
// row-major, b (N,) optional, f32 accumulation, bias + relu fused into the
// epilogue, output in x's dtype.
//
// Two instances behind a plain C interface (built with nvcc, loaded with
// ctypes by repro_torch/kernels/build.py):
//   * dense_fwd_bf16: bf16 operands on the tensor cores through
//     nvcuda::wmma 16x16x16 fragments with f32 accumulators.  This is the
//     LM serving path: every q/k/v/o and MLP projection.  At M <= 16
//     (decode) a split-K weight stream (dense_fwd_bf16_splitk and
//     dense_fwd_bf16_splitk_sum); above (prefill) the tile kernel
//     dense_fwd_bf16_kernel<64>.
//   * dense_fwd_f32: plain FMA on the CUDA cores, no TF32, so it agrees
//     with a full-f32 reference (the CNN path and the tests).  Its body is
//     the split-K product of gemm_f32.cuh, shared with K2 (dense_bwd.cu).
//
// What bounds the bf16 instance: bytes.  Serving decodes M = 4 rows (one
// per cache slot) through weights that are read once per step: 2 flops
// per weight byte pair, far below the ~295 flop/byte where the H100's
// bf16 tensor cores become the limit.  One Yi-6B decode step moves 11.07
// GB of bf16 projection weights, at least 3.3 ms at 3.35 TB/s.  Per
// launch, Yi-6B: 4096 -> 11008 90.2 MB (26.9 us), 4096 -> 4096 33.6 MB
// (10.0 us), 4096 -> 512 4.2 MB (1.25 us); Gemma-2: 4608 -> 36864 and
// 36864 -> 4608 339.7 MB each (101 us), 4608 -> 4096 37.7 MB (11.3 us).
//
// What the decode design does about it.  The first design gave each
// block one 64-column panel and walked all of K in a synchronous load,
// barrier, multiply loop: N / 64 blocks (8 at N = 512), few bytes in
// flight, 0.16-0.18 ms a launch whatever N was.  Now:
//   * the reduction over K is split across blocks: grid (N / 64 tiles,
//     splits), block (tile, z) reducing the z-th `depth`-deep slice of K.
//     kernels/dense.py bf16_splits picks (splits, depth) from the shapes:
//     the deepest slice (a multiple of the 64-deep K step, at most 1024)
//     that still gives two blocks an SM, so every Yi-6B, Phi-3 and
//     Gemma-2 decode projection launches 288-2880 blocks (4096 -> 512:
//     64 slices of one step); the launcher refuses a pair that leaves
//     part of K out or a slice empty;
//   * the block's weight panel streams through a 4-stage cp.async ring of
//     64 x 64 tiles (16-byte cp.async.cg copies, eight neighbouring
//     threads on one 128-byte row), so three stages, 24 KB, are in flight
//     while the tensor cores multiply the fourth; the pattern of
//     gemm_f32.cuh.  Where N or K is not a multiple of 8 or a pointer is
//     not 16-byte aligned (`vec` false) the same ring fills element by
//     element;
//   * the block's x slice (M rows, `depth` columns) is staged once, in the
//     first copy group; rows M..15 of the 16-row wmma fragment are zeroed
//     once;
//   * four warps each own a 16-column strip: per ring stage four bf16
//     16x16x16 products into one f32 accumulator fragment;
//   * the partial sums are added in slice order, without atomics, by a
//     second launch from the same C entry (dense_fwd_bf16_splitk_sum,
//     one thread an output: sum, bias, relu, bf16 cast), as
//     gemm_f32::splitk_launch does; pass 1 writes the output itself when
//     splits == 1.  A last-arriving-block sum would save that launch but
//     needs arrival counters kept at zero between calls and streams; the
//     second launch keeps the kernel stateless and a rerun bit-identical.
// Shared memory: x slice 16 x (depth + 8) bf16 (33 KB at depth 1024) plus
// the ring 4 x 64 x 72 bf16 (36.9 KB), dynamic; the f32 epilogue tile
// aliases the ring.  What is left: TMA copies with an mbarrier ring,
// wgmma, and a persistent grid that walks tiles and slices so one block's
// epilogue overlaps the next one's loads.
//
// Prefill (M > 16) keeps the first design: BM = 64 rows, one 64-column
// panel a block, a synchronous K loop.
//
// The f32 instance trains the CNN's FC stack at M = 64 rows: (64, 192,
// 2000), five of (64, 2000, 2000) and (64, 2000, 10) a step.  At (64,
// 2000, 2000) a launch does 0.512 GFLOP (7.6 us at the 67 TFLOP/s f32 FMA
// peak) against 16.5 MB of operands (4.9 us at 3.35 TB/s): the FMA rate
// bounds it.  One 64 x 64 tile per block gave 32 blocks for 132 SMs, each
// walking K = 2000 in 125 synchronous steps, so the card sat idle waiting
// on memory.  Now the reduction is split over K across blocks
// (gemm_f32.cuh): `splits` slices, chosen from the shapes by
// kernels/dense.py dense_splits (8 at (64, 2000, 2000): 256 blocks, two
// an SM), each filling a two-stage cp.async ring while it multiplies;
// pass 2 adds the slices' partials in slice order and applies bias and
// relu (pass 1 does that itself when splits == 1).  The tensor cores stay
// out: TF32 keeps about three decimal digits and would miss the 1e-5
// x max|ref| gate of a forward; a 3xTF32 split is later work.
//
// Ragged M, N and K are handled by masked loads (zero fill) and a masked
// epilogue store.  b may be null.  Each entry point returns
// cudaGetLastError() after the launch; it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gemm_f32.cuh"

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int kWarps = 4;
constexpr int kThreadsBf16 = 32 * kWarps;
constexpr int kBN = 16 * kWarps;  // one 16-column fragment strip per warp
constexpr int kBK = 64;
constexpr int kPadH = 8;          // bf16 pad: rows stay 16-byte aligned
constexpr int kPadF = 4;          // f32 pad of the epilogue tile

template <int BM>
__global__ void __launch_bounds__(kThreadsBf16)
dense_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ b,
                      __nv_bfloat16* __restrict__ out,
                      int M, int N, int K, int relu, int vec) {
  constexpr int FM = BM / 16;
  __shared__ __align__(128) __nv_bfloat16 xs[BM][kBK + kPadH];
  __shared__ __align__(128) __nv_bfloat16 ws[kBK][kBN + kPadH];
  __shared__ __align__(128) float cs[BM][kBN + kPadF];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile (BM x kBK), in chunks of 8 along K
    for (int c = tid; c < BM * kBK / 8; c += kThreadsBf16) {
      const int r = c / (kBK / 8);
      const int kc = (c % (kBK / 8)) * 8;
      const int gr = m0 + r;
      const int gk = k0 + kc;
      __nv_bfloat16* dst = &xs[r][kc];
      if (vec && gr < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gk + e < K) ? x[(size_t)gr * K + gk + e] : zero;
      }
    }
    // w tile (kBK x kBN), in chunks of 8 along N
    for (int c = tid; c < kBK * kBN / 8; c += kThreadsBf16) {
      const int r = c / (kBN / 8);
      const int nc = (c % (kBN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      __nv_bfloat16* dst = &ws[r][nc];
      if (vec && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, &ws[kk][warp * 16], kBN + kPadH);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, &xs[i * 16][kk], kBK + kPadH);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
    wmma::store_matrix_sync(&cs[i * 16][warp * 16], acc[i], kBN + kPadF,
                            wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * kBN; c += kThreadsBf16) {
    const int r = c / kBN;
    const int n = c % kBN;
    const int gr = m0 + r;
    const int gn = n0 + n;
    if (gr < M && gn < N) {
      float v = cs[r][n];
      if (b != nullptr) v += b[gn];
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)gr * N + gn] = __float2bfloat16(v);
    }
  }
}

// ------------------------------------------------ bf16 split-K, M <= 16
constexpr int kRows = 16;          // one wmma row fragment holds M <= 16
constexpr int kStep = 64;          // K rows per ring stage (the slice step)
constexpr int kMaxDepth = 1024;    // deepest slice: its x rows fit smem
constexpr int kStages = 4;         // ring depth
constexpr int kLdW = kBN + kPadH;  // ring tile row stride, bf16
constexpr int kStageElems = kStep * kLdW;
constexpr int kSumThreads = 256;

inline size_t splitk_smem(int depth) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kRows * (depth + kPadH) + (size_t)kStages * kStageElems);
}

// Pass 1: block (tile, z) multiplies x's columns [z * depth, z * depth +
// depth) by that slice of w's 64-column panel; see the note at the top.
__global__ void __launch_bounds__(kThreadsBf16)
dense_fwd_bf16_splitk(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ part,
                      __nv_bfloat16* __restrict__ out, int M, int N, int K,
                      int relu, int splits, int depth, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = depth + kPadH;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // 16 x ldx
  __nv_bfloat16* ring = xs + kRows * ldx;
  float* cs = reinterpret_cast<float*>(ring);  // epilogue, once the ring idles

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * kBN;
  const int z = blockIdx.y;
  const int kbeg = z * depth;
  const int kend = min(K, kbeg + depth);
  const int steps = (kend - kbeg + kStep - 1) / kStep;
  const int chunks = steps * (kStep / 8);   // 16-byte chunks of an x row
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // x slice, once: rows M..15 zero, rows < M zero past kend
  for (int c = tid; c < (kRows - M) * chunks; c += kThreadsBf16)
    *reinterpret_cast<uint4*>(xs + (M + c / chunks) * ldx +
                              (c % chunks) * 8) = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < M * chunks; c += kThreadsBf16) {
    const int r = c / chunks;
    const int kc = (c % chunks) * 8;
    const int gk = kbeg + kc;
    __nv_bfloat16* dst = xs + r * ldx + kc;
    if (vec) {
      const bool ok = gk < kend;
      cp_async::copy16(dst, x + (ok ? (size_t)r * K + gk : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = gk + e < kend ? x[(size_t)r * K + gk + e] : zero;
    }
  }

  // one 64 x 64 weight tile (K step t of the slice) into ring slot `slot`
  auto load_w = [&](int slot, int t) {
    const int k0 = kbeg + t * kStep;
    __nv_bfloat16* st = ring + slot * kStageElems;
#pragma unroll
    for (int i = 0; i < kStep * kBN / 8 / kThreadsBf16; ++i) {
      const int c = tid + i * kThreadsBf16;
      const int r = c / (kBN / 8);
      const int nc = (c % (kBN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      __nv_bfloat16* dst = st + r * kLdW + nc;
      if (vec) {
        const bool ok = gk < kend && gn < N;
        cp_async::copy16(dst, w + (ok ? (size_t)gk * N + gn : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < kend && gn + e < N) ? w[(size_t)gk * N + gn + e]
                                             : zero;
      }
    }
  };

  // copy groups: 0 = the x slice and step 0, then one per step
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load_w(t, t);
    cp_async::commit();
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int t = 0; t < steps; ++t) {
    cp_async::wait<kStages - 2>();   // step t (and the x slice) landed
    __syncthreads();                // ... for every thread; slot t-1 free
    if (t + kStages - 1 < steps)
      load_w((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async::commit();
    const __nv_bfloat16* st = ring + (t % kStages) * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(af, xs + t * kStep + kk, ldx);
      wmma::load_matrix_sync(bf, st + kk * kLdW + warp * 16, kLdW);
      wmma::mma_sync(acc, af, bf, acc);
    }
  }
  cp_async::wait<0>();
  __syncthreads();                  // the ring is idle: cs may alias it
  wmma::store_matrix_sync(cs + warp * 16, acc, kBN + kPadF,
                          wmma::mem_row_major);
  __syncthreads();
  const bool whole = splits == 1;
  for (int c = tid; c < M * kBN; c += kThreadsBf16) {
    const int r = c / kBN;
    const int gn = n0 + c % kBN;
    if (gn >= N) continue;
    float v = cs[r * (kBN + kPadF) + c % kBN];
    if (whole) {
      if (b != nullptr) v += b[gn];
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)r * N + gn] = __float2bfloat16(v);
    } else {
      part[((size_t)z * M + r) * N + gn] = v;
    }
  }
}

// Pass 2: out = bf16(epilogue(sum of the slices' partials, in slice
// order)); one thread an output element.
__global__ void __launch_bounds__(kSumThreads)
dense_fwd_bf16_splitk_sum(const float* __restrict__ part,
                          const float* __restrict__ b,
                          __nv_bfloat16* __restrict__ out, int M, int N,
                          int relu, int splits) {
  const size_t n = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (idx >= n) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * n + idx];
  if (b != nullptr) v += b[idx % N];
  if (relu) v = fmaxf(v, 0.0f);
  out[idx] = __float2bfloat16(v);
}

// ---------------------------------------------------------------- f32
// The two passes of gemm_f32.cuh under K1's names (w read as (K, N)).
__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mask,
                     const float* __restrict__ b, float* __restrict__ part,
                     float* __restrict__ out, int M, int N, int K, int relu,
                     int splits, int depth, int vecA, int vecB) {
  gemm_f32::splitk_tile<false, false>(x, w, mask, b, part, out, M, N, K,
                                      relu, splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_fwd_f32_sum_kernel(const float* __restrict__ part,
                         const float* __restrict__ b, float* __restrict__ out,
                         int M, int N, int relu, int splits) {
  gemm_f32::splitk_sum(part, b, out, M, N, relu, splits);
}

// Let the split-K pass use more than 48 KB of dynamic shared memory: once
// per device, since a decode step launches it 224 times and the call costs
// the host microseconds each time.
int allow_splitk_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(dense_fwd_bf16_splitk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)splitk_smem(kMaxDepth));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

}  // namespace

// x (M, K), w (K, N) bf16; b (N,) f32 or null; out (M, N) bf16.  At
// M <= 16, (splits, depth) cut K into slices (kernels/dense.py
// bf16_splits) and part holds the (splits, M, N) f32 partial sums, null
// when splits == 1; above, they are not read.
extern "C" int dense_fwd_bf16(const void* x, const void* w, const void* b,
                              void* part, void* out, int M, int N, int K,
                              int relu, int splits, int depth,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (N % 8 == 0) &&
                  ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M > kRows) {
    dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64);
    dense_fwd_bf16_kernel<64><<<grid, kThreadsBf16, 0, s>>>(
        xp, wp, bp, op, M, N, K, relu, vec);
    return (int)cudaGetLastError();
  }
  // the slices cover K, none is empty, each starts on a K step
  if (splits <= 0 || splits > 65535 || depth <= 0 || depth % kStep != 0 ||
      depth > kMaxDepth || (long long)splits * depth < K ||
      (long long)(splits - 1) * depth >= K ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = allow_splitk_smem();
  if (err != 0) return err;
  auto* pp = static_cast<float*>(part);
  dim3 grid((N + kBN - 1) / kBN, splits);
  dense_fwd_bf16_splitk<<<grid, kThreadsBf16, splitk_smem(depth), s>>>(
      xp, wp, bp, pp, op, M, N, K, relu, splits, depth, vec);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  const size_t n = (size_t)M * N;
  dense_fwd_bf16_splitk_sum<<<(unsigned)((n + kSumThreads - 1) / kSumThreads),
                              kSumThreads, 0, s>>>(pp, bp, op, M, N, relu,
                                                   splits);
  return (int)cudaGetLastError();
}

extern "C" int dense_fwd_f32(const void* x, const void* w, const void* b,
                             void* part, void* out, int M, int N, int K,
                             int relu, int splits, int depth, void* stream) {
  return gemm_f32::splitk_launch<false>(
      dense_fwd_f32_kernel, dense_fwd_f32_sum_kernel,
      static_cast<const float*>(x), static_cast<const float*>(w), nullptr,
      static_cast<const float*>(b), static_cast<float*>(part),
      static_cast<float*>(out), M, N, K, relu, splits, depth,
      static_cast<cudaStream_t>(stream));
}
