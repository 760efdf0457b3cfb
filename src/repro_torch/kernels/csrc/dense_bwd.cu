// Dense backward for Hopper (sm_90a): K2 (input gradient) and K3 (weight
// and bias gradient) of the fused dense layer, in f32 and in bf16.
//
// Replaces the TPU kernels of src/repro/kernels/dense.py:
//   * _dense_dx_kernel (pallas_call in _backward_dx): dx = g @ w^T, f32
//     accumulation, written in x's dtype;
//   * _dense_dwdb_kernel (pallas_call in _backward_dwdb): dw = x^T g and
//     db = sum over rows of g, one task per output-neuron block, f32
//     outputs (the caller casts them to the weight's dtype).
// The relu mask that _dense_bwd applies to g before both calls
// (g * (out > 0), out being the saved forward output) is staged beside g
// and applied in shared memory (f32) or to the fragments (bf16): `mask`
// is that output, or null for no activation.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py).  Each entry point returns cudaGetLastError() after its
// launches and never synchronises.  Operands are row-major: g (M, Dout),
// w (Din, Dout), x (M, Din), all f32 or all bf16.
//
// f32 (the CNN's FC stack).  All f32 FMA on the CUDA cores with f32
// accumulation, no TF32: the reference's gradient gate is 1e-4 x scale.
// The CNN trains at M = 64 rows: each launch does 2 x 64 x Din x Dout
// flops over a Din x Dout weight (K2) or weight gradient (K3) of 4 bytes
// an element.  At 2000 -> 2000 that is 0.51 GFLOP (7.6 us at 67 TFLOP/s)
// against 16.5 MB (4.9 us at 3.35 TB/s): the f32 FMA rate bounds both.
// Both are instances of the split-K tile product in gemm_f32.cuh (shared
// with K1's f32 instance), under their own kernel names:
//   * K2: C (M, Din) = (g masked) w^T, w^T read by index in 16-byte
//     copies along Dout, the reduction (Dout) split into slices chosen by
//     kernels/dense.py dense_splits so the blocks fill the card;
//   * K3: C (Din + 1, Dout) = [x, 1]^T (g masked): x^T read by index in
//     16-byte copies along Din, a virtual row of ones after x's last
//     column, so row Din of C is db, summed in the same fixed order as dw
//     with no branch in the inner loop; rows 0 .. Din - 1 are dw.  The
//     launcher's (Din + 1, Dout) output holds both as contiguous views.
//     Its 64-row reduction is one slice at case7 (dense.dwdb_splits); a
//     long reduction on a small output splits.
// Pass 2 adds the slices' partials in slice order: no atomics, and a
// rerun gives identical bits.  Ragged M, Din and Dout are loaded element
// by element with zero fill and stored masked.
//
// bf16 (the LM's projections, B x S = 1024 rows at a training step):
// the bf16 instances of src/repro/kernels/dense.py's _dense_dx_kernel
// (:59) and _dense_dwdb_kernel (:69).  At Phi-3-mini's 3072 -> 8192 a
// launch does 51.5 GFLOP (52 us at 989 TFLOP/s) against 73 MB moved by
// K2, and by K3 writing bf16 dw (22 us at 3.35 TB/s): the tensor cores
// bound both.  A Phi-3 8-layer step's 56 launches of each are
// 1.876 ms of tensor-core time.  Two routes, chosen by shape in
// kernels/dense.py bwd_bf16_plan, each its own C entry:
//
// * dense_bwd_wgmma (dense_dx_bf16_wgmma, dense_dwdb_bf16_wgmma): every
//   unmasked operand set whose widths are multiples of 8 and whose
//   pointers are 16-byte aligned, so every LM projection.  What held the
//   tile GEMM below to 21-26% of the bound, and what this design does:
//   1. mma.sync fed by ldmatrix from a cp.async ring that every thread
//      fills: here one producer thread issues 2-D TMA loads (wgmma_bf16.cuh)
//      into a ring of 4-6 stages, 64 K deep, 128-byte swizzled, on
//      full/empty mbarriers; two consumer warpgroups (setmaxnreg 232, the
//      producer's 40) run wgmma.mma_async m64nNk16 straight from the ring
//      with f32 accumulators in registers, one stage's products kept in
//      flight while the next stage's are issued.  K2's operands (g [m][k],
//      w [n][k]) are both K-major; K3's (x lying [k][m], g lying [k][n])
//      are both MN-major, read with wgmma's transpose bits (boxes of 64
//      m or n x 64 k; the descriptor's leading offset steps 64 columns,
//      its stride offset 8 K rows).  Out-of-bounds boxes (ragged M, Din or
//      Dout) arrive zero-filled;
//   2. 128 x 128 tiles that left the card part idle: the output tile is
//      128 x N with N = 128, 192 or 256 chosen per shape so the tiles fill
//      whole waves of 132 SMs (K2 at (1024, 3072): 128 tiles of 128 x
//      192), and the grid is persistent, one block an SM walking its
//      tiles, so one tile's epilogue overlaps the next tile's loads (K3
//      reduces only M = 1024 rows, 16 stages a tile);
//   3. K3's f32 dw, cast at once by the caller: dw is written in the
//      caller's dtype, bf16 rounded once to nearest even from the f32
//      accumulators, the same bits as .to(torch.bfloat16) of the f32 dw;
//   4. K3's ones row for db, which no LM projection asks for: db is
//      computed only where asked, by a fixed-order column sum of g
//      (dense_db_colsum) in the same entry.
//   The epilogue stages a warp's 16 rows x 32 columns in shared memory
//   and stores whole 16-byte row segments.  Every tile walks all of K in
//   one fixed order with no split and no atomics, so a rerun gives
//   identical bits.
//
// * dense_bwd_bf16_tile (dense_dx_bf16, dense_dwdb_bf16): the relu-masked
//   and the unaligned cases (no LM path runs them).
//   - K2: C (M, Din) = (g masked) w^T.  g is the A operand, staged as it
//     lies ([m][k], k = Dout contiguous); w is already the B operand's
//     "col" layout ([n][k]: Din rows, Dout contiguous), so both load with
//     plain ldmatrix; dx is written once in bf16 from the f32
//     accumulators;
//   - K3: C (Din + 1, Dout) = [x, 1]^T (g masked), the reduction over the
//     M rows.  Both operands lie k-major (x [k][m], g [k][n]), so both
//     load with ldmatrix.trans; the ones column at m = Din is written into
//     x's staged tile by a plain store, so row Din of C is db, summed in
//     the same order as dw; dw and db are f32.
//   Each block owns a 128 x 128 output tile: 8 warps of 64 x 32, 4 x 4
//   mma.sync m16n8k16 products per 16-deep step with f32 accumulators,
//   operands (and the mask, beside its operand) streamed through a
//   4-stage cp.async ring of 32-deep stages on rows padded by 16 bytes;
//   the mask's fragments come from the same ldmatrix and zero the masked
//   operand's (bf16 g x (out > 0), as the plain version multiplies).  The
//   reduction is not split, so a rerun gives identical bits.  Ragged
//   shapes or unaligned pointers load element by element with zero fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "cp_async.cuh"
#include "gemm_f32.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace wg = wgmma_bf16;

// K2: dx (M, Din) = (g masked) @ w^T, the reduction over Dout.
__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ mask, const float* __restrict__ bias,
                float* __restrict__ part, float* __restrict__ dx, int M,
                int Din, int Dout, int relu, int splits, int depth, int vecA,
                int vecB) {
  gemm_f32::splitk_tile<true, true>(g, w, mask, bias, part, dx, M, Din, Dout,
                                    relu, splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dx_sum_kernel(const float* __restrict__ part,
                    const float* __restrict__ bias, float* __restrict__ dx,
                    int M, int Din, int relu, int splits) {
  gemm_f32::splitk_sum(part, bias, dx, M, Din, relu, splits);
}

// K3: dwdb (Din + 1, Dout) = [x, 1]^T (g masked), the reduction over the
// M rows; here rows = Din + 1 and K = M.  Two register tiles (gemm_f32.cuh
// AtTile): 64 x 64, and 128 x 64 for outputs of 528 64 x 64 tiles or more.
__global__ void __launch_bounds__(gemm_f32::AtTile<false>::kThreads)
dense_dwdb_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mask, float* __restrict__ part,
                  float* __restrict__ dwdb, int rows, int Dout, int M,
                  int splits, int depth, int vecA, int vecB) {
  gemm_f32::splitk_tile_at<false>(x, g, mask, part, dwdb, rows, Dout, M,
                                  splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::AtTile<true>::kThreads, 4)
dense_dwdb_wide_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const float* __restrict__ mask,
                       float* __restrict__ part, float* __restrict__ dwdb,
                       int rows, int Dout, int M, int splits, int depth,
                       int vecA, int vecB) {
  gemm_f32::splitk_tile_at<true>(x, g, mask, part, dwdb, rows, Dout, M,
                                 splits, depth, vecA, vecB);
}

__global__ void __launch_bounds__(gemm_f32::kThreads)
dense_dwdb_sum_kernel(const float* __restrict__ part,
                      const float* __restrict__ bias,
                      float* __restrict__ dwdb, int rows, int Dout, int relu,
                      int splits) {
  gemm_f32::splitk_sum(part, bias, dwdb, rows, Dout, relu, splits);
}

// ------------------------------------------------------------------ bf16
// dense_bwd_bf16_tile<kDx, kMasked>: C (Mo, No) = A (Mo, K) B (K, No),
// f32 accumulators.  kDx (K2): A = g [m][k], B = w [n][k], mask beside
// A, C = dx in bf16.  !kDx (K3): A = [x, 1]^T lying [k][m] (m < Din from
// x, m = Din ones), B = g [k][n], mask beside B, C = dwdb in f32.
constexpr int kBM = 128;           // output rows a block owns
constexpr int kBN = 128;           // output columns a block owns
constexpr int kBK = 32;            // K rows per ring stage
constexpr int kStages = 4;         // ring depth
constexpr int kThreads = 256;      // 8 warps: 2 x 4 warp tiles of 64 x 32
constexpr int kPad = 8;            // bf16 pad: 16 bytes a row
constexpr int kLdK = kBK + kPad;   // 40: a [row][k] tile's row stride
constexpr int kLdR = kBN + kPad;   // 136: a [k][row] tile's row stride
constexpr int kTileKC = kBM * kLdK;  // a 128 x 32 [row][k] tile
constexpr int kTileKR = kBK * kLdR;  // a 32 x 128 [k][row] tile
constexpr int kGroup = 8;          // row tiles in one group of the block order

using bf16 = __nv_bfloat16;

template <bool kMasked>
inline size_t bwd_smem() {
  // K2: A, B (and the mask) are [row][k] tiles; K3: [k][row] tiles
  return sizeof(bf16) * kStages * (kMasked ? 3 : 2) *
         (size_t)(kTileKC > kTileKR ? kTileKC : kTileKR);
}

// 128 rows x 32 k of src (rows r0.., row stride ld, k contiguous) into
// dst [row][k], zero outside rows < rlim and k < klim.
__device__ __forceinline__ void stage_kc(bf16* dst, const bf16* src,
                                         size_t ld, int r0, int rlim, int k0,
                                         int klim, bool vec) {
  const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < kBM * (kBK / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (kBK / 8);
    const int kc = (c % (kBK / 8)) * 8;
    const int gr = r0 + r;
    const int gk = k0 + kc;
    bf16* d = dst + r * kLdK + kc;
    if (vec) {
      const bool ok = gr < rlim && gk < klim;
      cp_async::copy16(d, src + (ok ? (size_t)gr * ld + gk : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < rlim && gk + e < klim) ? src[(size_t)gr * ld + gk + e]
                                            : zero;
    }
  }
}

// 32 k x 128 columns of src (k rows k0.., row stride ld, columns
// contiguous) into dst [k][col], zero outside k < klim and col < clim;
// column `ones` (-1: none) is 1 where k < klim (K3's row of db).
__device__ __forceinline__ void stage_kr(bf16* dst, const bf16* src,
                                         size_t ld, int k0, int klim, int c0,
                                         int clim, int ones, bool vec) {
  const bf16 zero = __float2bfloat16(0.0f);
  const bf16 one = __float2bfloat16(1.0f);
#pragma unroll
  for (int i = 0; i < kBK * (kBN / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (kBN / 8);
    const int nc = (c % (kBN / 8)) * 8;
    const int gk = k0 + r;
    const int gc = c0 + nc;
    bf16* d = dst + r * kLdR + nc;
    if (vec && gc != ones) {   // vec: `ones` (= clim) starts a chunk
      const bool ok = gk < klim && gc < clim;
      cp_async::copy16(d, src + (ok ? (size_t)gk * ld + gc : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = gk >= klim ? zero
               : gc + e < clim ? src[(size_t)gk * ld + gc + e]
               : gc + e == ones ? one : zero;
    }
  }
}

// v (two bf16) x (m > 0), as the plain version's g * (out > 0)
__device__ __forceinline__ unsigned relu_mask(unsigned v, unsigned m) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __hgt2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                     __float2bfloat162_rn(0.0f)));
  return *reinterpret_cast<const unsigned*>(&r);
}

template <bool kDx, bool kMasked>
__global__ void __launch_bounds__(kThreads)
dense_bwd_bf16_tile(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const bf16* __restrict__ mask, void* __restrict__ c,
                    int Mo, int No, int K, int ones, int vec) {
  constexpr int kStage = kTileKC > kTileKR ? kTileKC : kTileKR;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kStages * kStage;
  bf16* sm = sb + kStages * kStage;   // the mask's ring (kMasked)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wr = (warp / 4) * 64;    // the warp tile's first row in the block
  const int wc = (warp % 4) * 32;    // ... and first column
  // blocks in groups of kGroup row tiles, row tiles fastest, as K1's tile
  // GEMM orders them: the blocks in flight share B panels through L2
  const int tm = (Mo + kBM - 1) / kBM;
  const int tn = (No + kBN - 1) / kBN;
  const int first = blockIdx.x / (kGroup * tn) * kGroup;
  const int rows = min(kGroup, tm - first);
  const int in_group = blockIdx.x % (kGroup * tn);
  const int m0 = (first + in_group % rows) * kBM;
  const int n0 = in_group / rows * kBN;
  const int steps = (K + kBK - 1) / kBK;

  auto load = [&](int slot, int t) {
    const int k0 = t * kBK;
    bf16* da = sa + slot * kStage;
    bf16* db = sb + slot * kStage;
    if constexpr (kDx) {   // g [m][k] (ld K), w [n][k] (ld K)
      stage_kc(da, a, K, m0, Mo, k0, K, vec);
      stage_kc(db, b, K, n0, No, k0, K, vec);
      if constexpr (kMasked)
        stage_kc(sm + slot * kStage, mask, K, m0, Mo, k0, K, vec);
    } else {               // x [k][m] (ld Din = ones), g [k][n] (ld No)
      stage_kr(da, a, ones, k0, K, m0, ones, ones, vec);
      stage_kr(db, b, No, k0, K, n0, No, -1, vec);
      if constexpr (kMasked)
        stage_kr(sm + slot * kStage, mask, No, k0, K, n0, No, -1, vec);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load(t, t);
    cp_async::commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async::wait<kStages - 2>();   // stage t landed
    __syncthreads();                 // ... for every thread; slot t-1 free
    if (t + kStages - 1 < steps)
      load((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async::commit();
    const bf16* ta = sa + (t % kStages) * kStage;
    const bf16* tb = sb + (t % kStages) * kStage;
    const bf16* tmk = sm + (t % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4][4], bf[4][2];
      // lane l addresses row l % 8 of 8 x 8 matrix q = l / 8
      const int q = lane / 8, r8 = lane % 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kDx) {   // [m][k]: matrices (m, k) 0-7/8-15 by l / 16
          const int off = (wr + i * 16 + lane % 16) * kLdK + kk +
                          (lane / 16) * 8;
          mma_bf16::ldmatrix_x4(af[i], ta + off);
          if constexpr (kMasked) {
            unsigned mf[4];
            mma_bf16::ldmatrix_x4(mf, tmk + off);
#pragma unroll
            for (int e = 0; e < 4; ++e) af[i][e] = relu_mask(af[i][e], mf[e]);
          }
        } else {               // [k][m], transposed: (m0, k0), (m8, k0),
          //                      (m0, k8), (m8, k8)
          mma_bf16::ldmatrix_x4_trans(
              af[i], ta + (kk + r8 + (q / 2) * 8) * kLdR + wr + i * 16 +
                         (q % 2) * 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // two n8 tiles an ldmatrix
        unsigned r[4];
        int off;
        if constexpr (kDx) {   // [n][k]: (n0, k0), (n0, k8), (n8, k0), (n8, k8)
          off = (wc + j * 16 + r8 + (q / 2) * 8) * kLdK + kk + (q % 2) * 8;
          mma_bf16::ldmatrix_x4(r, tb + off);
        } else {               // [k][n], transposed, as K1's w panel
          off = (kk + lane % 16) * kLdR + wc + j * 16 + (lane / 16) * 8;
          mma_bf16::ldmatrix_x4_trans(r, tb + off);
          if constexpr (kMasked) {
            unsigned mf[4];
            mma_bf16::ldmatrix_x4_trans(mf, tmk + off);
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = relu_mask(r[e], mf[e]);
          }
        }
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16::mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async::wait<0>();

  // element e of fragment (i, j) is row lane / 4 (+ 8 for e >= 2), column
  // 2 (lane % 4) + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = m0 + wr + i * 16 + lane / 4 + h * 8;
      if (gr >= Mo) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wc + j * 8 + (lane % 4) * 2;
        if (gn >= No) continue;
        const float v0 = acc[i][j][2 * h];
        const float v1 = acc[i][j][2 * h + 1];
        if constexpr (kDx) {
          bf16* o = static_cast<bf16*>(c) + (size_t)gr * No + gn;
          if (vec) {   // No % 8 == 0: the pair is in the row
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (gn + 1 < No) o[1] = __float2bfloat16(v1);
          }
        } else {
          float* o = static_cast<float*>(c) + (size_t)gr * No + gn;
          if (vec) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (gn + 1 < No) o[1] = v1;
          }
        }
      }
    }
  }
}

// Let the bf16 tile GEMM use more than 48 KB of dynamic shared memory:
// once per device and instance.
template <bool kDx, bool kMasked>
int bwd_bf16_launch(const bf16* a, const bf16* b, const bf16* mask, void* c,
                    int Mo, int No, int K, int ones, int vec,
                    cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(dense_bwd_bf16_tile<kDx, kMasked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bwd_smem<kMasked>());
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  const long long tiles = (long long)((Mo + kBM - 1) / kBM) *
                          ((No + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dense_bwd_bf16_tile<kDx, kMasked>
      <<<(unsigned)tiles, kThreads, bwd_smem<kMasked>(), s>>>(
          a, b, mask, c, Mo, No, K, ones, vec);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return p == nullptr || (uintptr_t)p % 16 == 0;
}

// ----------------------------------------------- bf16, TMA and wgmma
// dense_bwd_wgmma<kDx, kBN, OutT>: C (Mo, No) = A (Mo, K) B (K, No) with
// f32 accumulators, for unmasked operands whose widths are multiples of 8
// and whose pointers are 16-byte aligned (every LM projection; routed by
// kernels/dense.py bwd_bf16_plan).  kDx (K2): A = g [m][k], B = w [n][k],
// both K-major, C = dx in bf16.  !kDx (K3): A = x lying [k][m], B = g
// lying [k][n], both MN-major (the transpose bits set), C = dw in f32 or
// bf16.  A persistent block walks tiles t = blockIdx.x, + gridDim.x, ...:
// tile t owns rows (t % tiles_m) 128 and columns (t / tiles_m) kBN, so
// the row tiles of one column panel run side by side and share its B
// panel through L2.
constexpr int kWgBM = 128;            // output rows a tile: 64 a warpgroup
constexpr int kWgBK = 64;             // K a ring stage: one swizzle row
constexpr int kWgHalf = 64 * kWgBK * 2;   // a warpgroup's A rows (8 KB)
constexpr int kWgThreads = 384;       // consumers: warpgroups 0, 1; producer 2
constexpr int kWgMaxStages = 6;
constexpr int kWgStageLd = 40;        // staging row stride in 4-byte words
constexpr int kWgStaging = 16 * kWgStageLd * 4;   // a consumer warp's tile
constexpr int kSmemLimit = 232448;    // an H100 block's opt-in shared memory

inline size_t wgmma_smem(int bn, int stages) {
  return 1024 + (size_t)stages * (kWgBM + bn) * kWgBK * 2 +
         8 * kWgStaging + 2 * kWgMaxStages * sizeof(uint64_t);
}

// This warp's 16 rows of the tile (rows r0 .., columns n0 .. n0 + kBN - 1)
// into c (Mo, No), 32 columns at a time through the warp's own staging
// tile (rows padded to 40 words, so the fragments' pair writes hit 32
// banks), then 16-byte stores of whole row segments (No % 8 == 0: a
// segment is all in or all out).  bf16 rounds once, to nearest even, as
// .to(torch.bfloat16) of the f32 value.
template <int kBN, typename OutT>
__device__ __forceinline__ void wgmma_store(const float (&acc)[kBN / 2],
                                            float* stage,
                                            OutT* __restrict__ c, int r0,
                                            int n0, int Mo, int No,
                                            int lane) {
  constexpr bool kF32 = std::is_same<OutT, float>::value;
  constexpr int kSeg = kF32 ? 8 : 4;   // 16-byte segments in 32 columns
  constexpr int kLd = kF32 ? kWgStageLd : kWgStageLd / 2;   // 4-byte words
#pragma unroll
  for (int ch = 0; ch < kBN / 32; ++ch) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;
        const int col = jj * 8 + (lane % 4) * 2;
        const float v0 = acc[4 * (4 * ch + jj) + 2 * h];
        const float v1 = acc[4 * (4 * ch + jj) + 2 * h + 1];
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(stage + row * kLd + col) =
              make_float2(v0, v1);
        } else {
          reinterpret_cast<__nv_bfloat162*>(stage)[row * kLd + col / 2] =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 16 * kSeg / 32; ++p) {
      const int row = lane / kSeg + p * (32 / kSeg);
      const int seg = lane % kSeg;
      const int gr = r0 + row;
      const int gc = n0 + ch * 32 + seg * (16 / (int)sizeof(OutT));
      const uint4 v =
          *reinterpret_cast<const uint4*>(stage + row * kLd + seg * 4);
      if (gr < Mo && gc < No)
        *reinterpret_cast<uint4*>(c + (size_t)gr * No + gc) = v;
    }
    __syncwarp();
  }
}

template <bool kDx, int kBN, typename OutT>
__global__ void __launch_bounds__(kWgThreads, 1)
dense_bwd_wgmma(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                OutT* __restrict__ c, int Mo, int No, int K, int stages) {
  constexpr int kABytes = kWgBM * kWgBK * 2;
  constexpr int kStage = kABytes + kBN * kWgBK * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + (1024 - wg::smem_u32(smem_raw) % 1024) % 1024;
  float* staging = reinterpret_cast<float*>(ring + stages * kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + 8 * (kWgStaging / 4));
  uint64_t* empty = full + kWgMaxStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_m = (Mo + kWgBM - 1) / kWgBM;
  const int tiles = tiles_m * ((No + kBN - 1) / kBN);
  const int kblocks = (K + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::bar_init(&full[s], 1);    // the producer's expect_tx + TMA bytes
      wg::bar_init(&empty[s], 8);   // lane 0 of every consumer warp
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {   // producer: one thread keeps the ring full
    wg::regs_dec<40>();
    if (warp == 8 && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t % tiles_m * kWgBM;
        const int n0 = t / tiles_m * kBN;
        for (int kb = 0; kb < kblocks; ++kb) {
          wg::bar_wait(&empty[s], phase ^ 1);
          unsigned char* sa = ring + s * kStage;
          unsigned char* sb = sa + kABytes;
          const int k0 = kb * kWgBK;
          wg::bar_expect_tx(&full[s], kStage);
          if constexpr (kDx) {   // boxes of 64 k x 128 rows, 64 k x kBN rows
            wg::tma_load_2d(sa, &ta, &full[s], k0, m0);
            wg::tma_load_2d(sb, &tb, &full[s], k0, n0);
          } else {               // boxes of 64 m (or n) x 64 k
            wg::tma_load_2d(sa, &ta, &full[s], m0, k0);
            wg::tma_load_2d(sa + kWgHalf, &ta, &full[s], m0 + 64, k0);
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              wg::tma_load_2d(sb + j * kWgHalf, &tb, &full[s], n0 + 64 * j,
                              k0);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {           // consumers: warpgroup `half` owns rows 64 half ..
    wg::regs_inc<232>();
    const int half = warp / 4;
    float acc[kBN / 2];
    int s = 0, last = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t % tiles_m * kWgBM;
      const int n0 = t / tiles_m * kBN;
      for (int kb = 0; kb < kblocks; ++kb) {
        wg::bar_wait(&full[s], phase);
        const uint32_t sa = wg::smem_u32(ring + s * kStage) + half * kWgHalf;
        const uint32_t sb = wg::smem_u32(ring + s * kStage) + kABytes;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // K-major: 16 k are 32 bytes along the row; MN-major: 16 rows.
          // MN-major B's 64-column panels lie kWgHalf apart (leading).
          const uint64_t da =
              kDx ? wg::desc_sw128(sa + kk * 32, 16, 1024)
                  : wg::desc_sw128(sa + kk * 2048, kWgHalf, 1024);
          const uint64_t db =
              kDx ? wg::desc_sw128(sb + kk * 32, 16, 1024)
                  : wg::desc_sw128(sb + kk * 2048, kWgHalf, 1024);
          wg::mma<kBN, kDx ? 0 : 1>(acc, da, db, kb > 0 || kk > 0);
        }
        wg::commit();
        if (kb > 0) {   // this stage's products stay in flight; the last
          wg::wait<1>();   // stage's are done: hand its slot back
          if (lane == 0) wg::bar_arrive(&empty[last]);
        }
        last = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      wg::wait<0>();
      wg::fence_regs(acc);
      if (lane == 0) wg::bar_arrive(&empty[last]);
      wgmma_store<kBN>(acc, staging + warp * (kWgStaging / 4), c,
                       m0 + half * 64 + (warp % 4) * 16, n0, Mo, No, lane);
    }
  }
}

// db (Dout) f32 = the sum of g's M rows, in a fixed order: a block owns
// 64 columns, its 256 threads 32 column pairs x 8 row slices (rows slice,
// slice + 8, ...), the slices added in order.  Dout % 8 == 0.
__global__ void __launch_bounds__(256)
dense_db_colsum(const bf16* __restrict__ g, float* __restrict__ db, int M,
                int Dout) {
  __shared__ float2 part[8][32];
  const int pair = threadIdx.x % 32;
  const int slice = threadIdx.x / 32;
  const int col = blockIdx.x * 64 + pair * 2;
  float2 sum = make_float2(0.0f, 0.0f);
  if (col < Dout) {
    for (int r = slice; r < M; r += 8) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + (size_t)r * Dout +
                                                    col));
      sum.x += v.x;
      sum.y += v.y;
    }
  }
  part[slice][pair] = sum;
  __syncthreads();
  if (slice == 0 && col < Dout) {
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      sum.x += part[i][pair].x;
      sum.y += part[i][pair].y;
    }
    db[col] = sum.x;
    db[col + 1] = sum.y;
  }
}

template <bool kDx, int kBN, typename OutT>
int wgmma_launch_n(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                   int Mo, int No, int K, int stages, int grid,
                   cudaStream_t s) {
  const size_t smem = wgmma_smem(kBN, stages);
  if (stages < 2 || stages > kWgMaxStages || smem > (size_t)kSmemLimit ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(dense_bwd_wgmma<kDx, kBN, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  dense_bwd_wgmma<kDx, kBN, OutT><<<grid, kWgThreads, smem, s>>>(
      ta, tb, static_cast<OutT*>(c), Mo, No, K, stages);
  return (int)cudaGetLastError();
}

template <bool kDx, typename OutT>
int wgmma_launch(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                 int Mo, int No, int K, int bn, int stages, int grid,
                 cudaStream_t s) {
  switch (bn) {
    case 128:
      return wgmma_launch_n<kDx, 128, OutT>(ta, tb, c, Mo, No, K, stages,
                                            grid, s);
    case 192:
      return wgmma_launch_n<kDx, 192, OutT>(ta, tb, c, Mo, No, K, stages,
                                            grid, s);
    case 256:
      return wgmma_launch_n<kDx, 256, OutT>(ta, tb, c, Mo, No, K, stages,
                                            grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What TMA and the 16-byte stores take: widths a multiple of 8 (rows of
// 16-byte multiples), every pointer 16-byte aligned and set.
inline bool wgmma_ok(int M, int Din, int Dout, int bn,
                     std::initializer_list<const void*> ptrs) {
  if (M <= 0 || Din <= 0 || Dout <= 0 || Din % 8 || Dout % 8) return false;
  if (bn != 128 && bn != 192 && bn != 256) return false;
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return false;
  return true;
}

}  // namespace

extern "C" int dense_dx_f32(const void* g, const void* w, const void* mask,
                            void* part, void* dx, int M, int Din, int Dout,
                            int splits, int depth, void* stream) {
  return gemm_f32::splitk_launch<true>(
      dense_dx_kernel, dense_dx_sum_kernel, static_cast<const float*>(g),
      static_cast<const float*>(w), static_cast<const float*>(mask), nullptr,
      static_cast<float*>(part), static_cast<float*>(dx), M, Din, Dout, 0,
      splits, depth, static_cast<cudaStream_t>(stream));
}

// K3: dwdb is (Din + 1, Dout): dw in its first Din rows, db in the last;
// (splits, depth) cut the M rows (kernels/dense.py dwdb_splits).
extern "C" int dense_dwdb_f32(const void* x, const void* g, const void* mask,
                              void* part, void* dwdb, int M, int Din,
                              int Dout, int splits, int depth, void* stream) {
  if (Din <= 0) return (int)cudaErrorInvalidValue;
  return gemm_f32::splitk_launch_at(
      dense_dwdb_kernel, dense_dwdb_wide_kernel, dense_dwdb_sum_kernel,
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mask), static_cast<float*>(part),
      static_cast<float*>(dwdb), Din + 1, Dout, M, splits, depth,
      static_cast<cudaStream_t>(stream));
}

// K2 in bf16: dx (M, Din) bf16 = (g masked) @ w^T; g and mask (M, Dout),
// w (Din, Dout), all bf16; mask null for no activation.
extern "C" int dense_dx_bf16(const void* g, const void* w, const void* mask,
                             void* dx, int M, int Din, int Dout,
                             void* stream) {
  if (M <= 0 || Din <= 0 || Dout <= 0) return (int)cudaErrorInvalidValue;
  const int vec = Dout % 8 == 0 && Din % 8 == 0 && aligned16(g) &&
                  aligned16(w) && aligned16(mask) && aligned16(dx);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* wp = static_cast<const bf16*>(w);
  const auto* mp = static_cast<const bf16*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask ? bwd_bf16_launch<true, true>(gp, wp, mp, dx, M, Din, Dout, -1,
                                            vec, s)
              : bwd_bf16_launch<true, false>(gp, wp, mp, dx, M, Din, Dout,
                                             -1, vec, s);
}

// K3 in bf16: dwdb (Din + 1, Dout) f32 = [x, 1]^T (g masked): dw in its
// first Din rows, db in the last; x (M, Din), g and mask (M, Dout) bf16.
extern "C" int dense_dwdb_bf16(const void* x, const void* g,
                               const void* mask, void* dwdb, int M, int Din,
                               int Dout, void* stream) {
  if (M <= 0 || Din <= 0 || Dout <= 0) return (int)cudaErrorInvalidValue;
  const int vec = Din % 8 == 0 && Dout % 8 == 0 && aligned16(x) &&
                  aligned16(g) && aligned16(mask) && aligned16(dwdb);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  const auto* mp = static_cast<const bf16*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask ? bwd_bf16_launch<false, true>(xp, gp, mp, dwdb, Din + 1, Dout,
                                             M, Din, vec, s)
              : bwd_bf16_launch<false, false>(xp, gp, mp, dwdb, Din + 1,
                                              Dout, M, Din, vec, s);
}

// K2 in bf16 through TMA and wgmma: dx (M, Din) bf16 = g w^T, no mask; g
// (M, Dout), w (Din, Dout) bf16; (bn, stages, grid) from kernels/dense.py
// bwd_bf16_plan.  Returns 0, a cudaError, or wgmma_bf16::kEncodeError +
// the CUresult of a refused tensor map.
extern "C" int dense_dx_bf16_wgmma(const void* g, const void* w, void* dx,
                                   int M, int Din, int Dout, int bn,
                                   int stages, int grid, void* stream) {
  if (!wgmma_ok(M, Din, Dout, bn, {g, w, dx}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = wg::map_2d(&ta, g, M, Dout, kWgBM, kWgBK);
  if (err == 0) err = wg::map_2d(&tb, w, Din, Dout, bn, kWgBK);
  if (err != 0) return err;
  return wgmma_launch<true, bf16>(ta, tb, dx, M, Din, Dout, bn, stages,
                                  grid, static_cast<cudaStream_t>(stream));
}

// K3 in bf16 through TMA and wgmma: dw (Din, Dout) = x^T g, f32 or (dw_bf16)
// bf16, and where db is set db (Dout) f32 = the sum of g's rows (a second
// small kernel, dense_db_colsum); no mask; x (M, Din), g (M, Dout) bf16.
extern "C" int dense_dwdb_bf16_wgmma(const void* x, const void* g, void* dw,
                                     void* db, int M, int Din, int Dout,
                                     int bn, int stages, int grid,
                                     int dw_bf16, void* stream) {
  if (!wgmma_ok(M, Din, Dout, bn, {x, g, dw}) || !aligned16(db))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = wg::map_2d(&ta, x, M, Din, kWgBK, 64);
  if (err == 0) err = wg::map_2d(&tb, g, M, Dout, kWgBK, 64);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dw_bf16 ? wgmma_launch<false, bf16>(ta, tb, dw, Din, Dout, M, bn,
                                            stages, grid, s)
                : wgmma_launch<false, float>(ta, tb, dw, Din, Dout, M, bn,
                                             stages, grid, s);
  if (err != 0 || db == nullptr) return err;
  dense_db_colsum<<<(Dout + 63) / 64, 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<float*>(db), M, Dout);
  return (int)cudaGetLastError();
}
