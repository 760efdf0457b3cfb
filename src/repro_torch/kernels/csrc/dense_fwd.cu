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
//   * dense_fwd_bf16: bf16 operands on the tensor cores with f32
//     accumulators.  This is the LM serving path: every q/k/v/o and MLP
//     projection.  At M <= 16 (decode) a split-K weight stream of
//     nvcuda::wmma 16x16x16 fragments (dense_fwd_bf16_splitk and
//     dense_fwd_bf16_splitk_sum); above (prefill) a tile GEMM of
//     mma.sync m16n8k16 products (dense_fwd_bf16_tile), split over K where
//     its tiles alone would leave the card idle.
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
// What the decode design (M <= 16) does about it:
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
// Prefill (M > 16): one tile GEMM, dense_fwd_bf16_tile, in two instances
// chosen by the shapes:
//   * 17 <= M <= 64 is still a weight stream (x @ w moves K N bf16 weight
//     bytes for 2 M flops each: 27 us at 11008 -> 4096, as at M = 4).
//     dense_fwd_bf16_tile<1>: 64 x 128 tiles, 4 warps, x's rows staged
//     beside w in each ring stage (no depth cap from an x slice), and the
//     reduction split over K like the decode stream (bf16_splits: slices
//     at least 128 deep until two blocks an SM run; 288 blocks at 11008
//     -> 4096), partials added in slice order by the same second launch.
//     Row fragments past M skip their products.
//   * M > 64 turns compute-bound (2 M flops a weight pair: at M = 5000,
//     Gemma-2's 4608 -> 36864 is 1.70 TFLOP, 1.72 ms at 989 TFLOP/s).
//     dense_fwd_bf16_tile<2>: 128 x 128 tiles, 8 warps of 64 x 32, the
//     same ring and products, blocks ordered in groups of 8 row tiles so
//     the blocks in flight share w panels through L2; K splits only where
//     the tiles fill fewer than 132 SMs (M = 128 at N = 4096 gives 32
//     tiles).
// Both keep 4 x 4 m16n8k16 accumulators (64 f32) a thread, fed by ldmatrix
// from a 4-stage cp.async ring of 32-deep stages (55 KB and 74 KB of
// dynamic shared memory), every fragment of a 16-deep step loaded before
// its products, with bias, relu and the bf16 cast fused into the store.
// What bounds the compute-bound instance is mma.sync, which issues at
// about half of wgmma's rate on Hopper; what is left is wgmma fed by TMA,
// with a persistent grid.

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
#include "mma_bf16.cuh"

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int kWarps = 4;
constexpr int kThreadsBf16 = 32 * kWarps;
constexpr int kBN = 16 * kWarps;  // one 16-column fragment strip per warp
constexpr int kPadH = 8;          // bf16 pad: rows stay 16-byte aligned
constexpr int kPadF = 4;          // f32 pad of the epilogue tile

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

// ------------------------------------------------ bf16 tile GEMM, M > 16
// Block (tile, z): a BM x 128 output tile over the z-th `depth`-deep slice
// of K, BM = 64 WM.  4 WM warps, each owning a 64 x 32 warp tile: 4 x 4
// mma.sync m16n8k16 products per 16-deep step, f32 accumulators in
// registers.  x's rows and w's panel stream together through a 4-stage
// cp.async ring of 32-deep stages; fragments come from ldmatrix (w
// transposed on the way) on rows padded by 16 bytes, so the eight row
// addresses of each 8 x 8 matrix fall on distinct banks.
constexpr int kTBN = 128;          // output columns a block owns
constexpr int kTBK = 32;           // K rows per ring stage (the slice step)
constexpr int kTStages = 4;        // ring depth
constexpr int kLdA = kTBK + kPadH;   // 40 bf16: 80-byte x rows
constexpr int kLdB = kTBN + kPadH;   // 136 bf16: 272-byte w rows
constexpr int kGroup = 8;          // row tiles in one group of the block order

template <int WM>
inline size_t tile_smem() {
  return sizeof(__nv_bfloat16) * kTStages *
         ((size_t)64 * WM * kLdA + (size_t)kTBK * kLdB);
}

template <int WM>
__global__ void __launch_bounds__(128 * WM)
dense_fwd_bf16_tile(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ part,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K,
                    int relu, int splits, int depth, int vec) {
  constexpr int BM = 64 * WM;
  constexpr int kThreads = 128 * WM;
  constexpr int kStageA = BM * kLdA;
  constexpr int kStageB = kTBK * kLdB;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kTStages * kStageA;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wr = (warp / 4) * 64;    // the warp tile's first row in the block
  const int wc = (warp % 4) * 32;    // ... and first column
  // blocks in groups of kGroup row tiles, row tiles fastest: the blocks
  // that run together share a few w panels and x tiles through L2
  // instead of streaming every w panel once per row tile
  const int tm = (M + BM - 1) / BM;
  const int tn = (N + kTBN - 1) / kTBN;
  const int first = blockIdx.x / (kGroup * tn) * kGroup;
  const int rows = min(kGroup, tm - first);
  const int in_group = blockIdx.x % (kGroup * tn);
  const int m0 = (first + in_group % rows) * BM;
  const int n0 = in_group / rows * kTBN;
  const int z = blockIdx.z;
  const int kbeg = z * depth;
  const int kend = min(K, kbeg + depth);
  const int steps = (kend - kbeg + kTBK - 1) / kTBK;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // stage t of the slice (x's BM x 32 tile and w's 32 x 128 panel) into
  // ring slot `slot`, zero outside [kbeg, kend) x M x N
  auto load = [&](int slot, int t) {
    const int k0 = kbeg + t * kTBK;
    __nv_bfloat16* a = sa + slot * kStageA;
    __nv_bfloat16* bs = sb + slot * kStageB;
#pragma unroll
    for (int i = 0; i < BM * (kTBK / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kTBK / 8);
      const int kc = (c % (kTBK / 8)) * 8;
      const int gr = m0 + r;
      const int gk = k0 + kc;
      __nv_bfloat16* dst = a + r * kLdA + kc;
      if (vec) {
        const bool ok = gr < M && gk < kend;
        cp_async::copy16(dst, x + (ok ? (size_t)gr * K + gk : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gk + e < kend) ? x[(size_t)gr * K + gk + e]
                                             : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < kTBK * (kTBN / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kTBN / 8);
      const int nc = (c % (kTBN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      __nv_bfloat16* dst = bs + r * kLdB + nc;
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

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // the warp's 16-row fragments that hold a row < M (warp-uniform)
  const int live = min(4, max(0, (M - m0 - wr + 15) / 16));

  for (int t = 0; t < kTStages - 1; ++t) {
    if (t < steps) load(t, t);
    cp_async::commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async::wait<kTStages - 2>();   // stage t landed
    __syncthreads();                 // ... for every thread; slot t-1 free
    if (t + kTStages - 1 < steps)
      load((t + kTStages - 1) % kTStages, t + kTStages - 1);
    cp_async::commit();
    const __nv_bfloat16* a = sa + (t % kTStages) * kStageA + wr * kLdA;
    const __nv_bfloat16* bs = sb + (t % kTStages) * kStageB + wc;
#pragma unroll
    for (int kk = 0; kk < kTBK; kk += 16) {
      // every fragment of the step first, then the products, so the
      // loads of one step overlap the products of the last
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_bf16::ldmatrix_x4(
            af[i], a + (i * 16 + lane % 16) * kLdA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // two n8 tiles an ldmatrix
        unsigned r[4];
        mma_bf16::ldmatrix_x4_trans(
            r, bs + (kk + lane % 16) * kLdB + j * 16 + (lane / 16) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (WM > 1 || i < live)   // the stream skips fragments past M
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16::mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async::wait<0>();

  // epilogue from the accumulators: element e of fragment (i, j) is row
  // lane / 4 (+ 8 for e >= 2), column 2 (lane % 4) + e % 2
  const bool whole = splits == 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = m0 + wr + i * 16 + lane / 4 + h * 8;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wc + j * 8 + (lane % 4) * 2;
        float v0 = acc[i][j][2 * h];
        float v1 = acc[i][j][2 * h + 1];
        if (whole) {
          if (b != nullptr) {
            if (gn < N) v0 += b[gn];
            if (gn + 1 < N) v1 += b[gn + 1];
          }
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          __nv_bfloat16* o = out + (size_t)gr * N + gn;
          if (vec && gn < N) {   // N % 8 == 0: the pair is in the row
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (gn < N) o[0] = __float2bfloat16(v0);
            if (gn + 1 < N) o[1] = __float2bfloat16(v1);
          }
        } else {
          float* p = part + ((size_t)z * M + gr) * N + gn;
          if (vec && gn < N) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (gn < N) p[0] = v0;
            if (gn + 1 < N) p[1] = v1;
          }
        }
      }
    }
  }
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

// Let the split-K pass and the tile GEMM use more than 48 KB of dynamic
// shared memory: once per device, since a decode step launches K1 224
// times and the call costs the host microseconds each time.
int allow_bf16_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return 0;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(dense_fwd_bf16_splitk, attr,
                             (int)splitk_smem(kMaxDepth));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_fwd_bf16_tile<1>, attr,
                               (int)tile_smem<1>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_fwd_bf16_tile<2>, attr,
                               (int)tile_smem<2>());
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

}  // namespace

// x (M, K), w (K, N) bf16; b (N,) f32 or null; out (M, N) bf16.
// (splits, depth) cut K into slices (kernels/dense.py bf16_splits): at
// M <= 16 for the split-K stream (depth a multiple of 64, at most 1024),
// above for the tile GEMM (depth a multiple of 32).  part holds the
// (splits, M, N) f32 partial sums, null when splits == 1.
extern "C" int dense_fwd_bf16(const void* x, const void* w, const void* b,
                              void* part, void* out, int M, int N, int K,
                              int relu, int splits, int depth,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (N % 8 == 0) &&
                  ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  const bool tile = M > kRows;
  const int step = tile ? kTBK : kStep;
  // the slices cover K, none is empty, each starts on a K step
  if (splits <= 0 || splits > 65535 || depth <= 0 || depth % step != 0 ||
      (!tile && depth > kMaxDepth) || (long long)splits * depth < K ||
      (long long)(splits - 1) * depth >= K ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = allow_bf16_smem();
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  if (!tile) {
    dim3 grid((N + kBN - 1) / kBN, splits);
    dense_fwd_bf16_splitk<<<grid, kThreadsBf16, splitk_smem(depth), s>>>(
        xp, wp, bp, pp, op, M, N, K, relu, splits, depth, vec);
  } else {   // 64-row tiles up to M = 64, 128-row ones beyond
    const int WM = M <= 64 ? 1 : 2;
    const long long tiles = (long long)((M + 64 * WM - 1) / (64 * WM)) *
                            ((N + kTBN - 1) / kTBN);
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, 1, splits);
    if (WM == 1)
      dense_fwd_bf16_tile<1><<<grid, 128, tile_smem<1>(), s>>>(
          xp, wp, bp, pp, op, M, N, K, relu, splits, depth, vec);
    else
      dense_fwd_bf16_tile<2><<<grid, 256, tile_smem<2>(), s>>>(
          xp, wp, bp, pp, op, M, N, K, relu, splits, depth, vec);
  }
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
