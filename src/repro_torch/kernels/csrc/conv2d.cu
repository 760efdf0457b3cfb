// Stride-1 NHWC x HWIO convolution for Hopper (sm_90a), in f32: the
// forward (K4), the input gradient (K5) and the weight/bias gradient (K6).
//
// Replaces the TPU kernels of src/repro/kernels/conv2d.py:
//   * _conv_fwd_kernel (pallas_call in _forward): conv + bias + relu;
//   * _conv_dx_kernel (pallas_call in _backward_dx): the VALID correlation
//     of the padded cotangent with the spatially flipped, channel-swapped
//     filter.  The Pallas code runs K4's body (_im2col_accum) on those
//     operands; here K5 is the other instance of K4's template, reading
//     the cotangent with the mirrored padding and the filter flipped by
//     index;
//   * _conv_dw_kernel (pallas_call in _backward_dw): dw[i,j,ci,co] =
//     sum_{b,h,w} xpad[b,h+i,w+j,ci] g[b,h,w,co], f32 output.  The conv
//     bias gradient (db = sum g, plain jnp in _conv2d_bwd) is folded in.
// The relu mask (g * (out > 0) in _conv2d_bwd) is staged beside the
// cotangent and applied in shared memory by K5 and K6: `mask` is the saved
// forward output, or null.
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); each entry point returns cudaGetLastError() after its
// launches and never synchronises.  f32 FMA with f32 accumulation, no
// TF32 (the reference's gradient gate is 1e-4 x scale); fixed summation
// orders and no float atomics, so a rerun gives identical bits.
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
// flops.  The seven 4 x 4 layers are 1024 output pixels each: there one
// round trip to memory and the launch, not bytes or flops, set the time.
//
// What the designs do about it.  Every kernel gives a block one tile of
// output pixels (tb images x th rows x tw columns, chosen from the shapes
// by kernels/conv2d.py: conv_tile for K4/K5, dw_tile for K6), at least one
// tile an SM where B.Ho.Wo allows, and stages what the tile needs once in
// shared memory, every cp.async copy in flight together (stage_rows): the
// tile's x patch with its (kh - 1) x (kw - 1) halo, zero outside the
// input, so each input element is fetched once, not once a tap.
//   * K4/K5 (conv_tile_kernel<kFlip>) also stage the filter panel of the
//     block's output channels (at most 16; grid.y walks wider Cout) and the
//     bias.  Each patch pixel's channels sit at a stride of an odd number
//     of 16-byte quads, rounded up from the channel count (Cin 3 -> 4, 12
//     -> 12), so a quarter-warp's 16-byte reads of neighbouring pixels hit
//     distinct banks.  A thread owns 4 pixels x 4 output channels and one
//     slice of the reduction's (tap, channel quad) units, strided; per unit
//     four 16-byte patch reads and four filter rows feed 64 FMAs, with the
//     unit's patch offset read from a table, so there is no division in the
//     inner loop.  The slices' partials meet in shared memory and are added
//     in slice order, then bias + relu are applied and the outputs stored,
//     neighbouring threads on neighbouring channels.  Where the patch and
//     the filter panel do not fit the block's shared memory (wide Cin, or
//     a wide filter), the block walks the reduction in chunks of channels
//     (and, past that, of taps) through a two-stage cp.async ring; case7
//     takes one chunk.  K5 flips the filter as it stages it and masks the
//     staged cotangent.
//   * K6's reduction over B.H.W is 65 536 long at layer 0 while its output
//     is the (K + 1) x Co table (28 x 12 at layer 0, 109 x 12 after; row K
//     is a constant 1, whose sums are db).  Pass 1 stages the patch and
//     the masked g of a tile and lets each thread sum 4 taps x 4 channels
//     over a share of the tile's pixels; pass 2 adds the tiles' partials,
//     32 neighbouring outputs a block, 8 warps over every 8th tile, then
//     the 8 sums in warp order.
// A block may take up to the device's opt-in shared memory (227 KB on
// H100; opt_in_smem).  K6 refuses a shape where even one pixel's patch
// does not fit (kh.kw.Cin above about 58 000 floats); K4/K5 refuse only a
// shape where one pixel's single-channel patch (K5: and its mask), twice
// for the ring, does not (K4 from 81 x 81 taps, K5 from 59 x 59).  What is
// left: a 4 x 4 layer's block is mostly copy latency, and a patch read
// by several blocks of one tile (grid.y > 1: wide Cout for K4/K5, wide Cin
// for K6) is staged by each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int B, Hi, Wi, Ci;  // input of this pass (the cotangent for K5)
  int Ho, Wo, Co;     // output of this pass (the input gradient for K5)
  int kh, kw, pt, pl;
};

// Stage `rows` rows of `len` floats into dst (row r at dst + r * pitch)
// with cp.async copies, every one of them in flight at once: each group of
// kLanes neighbouring threads (a power of two up to a warp; a warp where
// rows are long, as K6's are, 4 for K4/K5's short rows) takes rows g,
// g + 256 / kLanes, ..., its lanes on neighbouring addresses.
// row(r, off, lo, hi) places row r in the source once: element e (lo <= e
// < hi) comes from src + off + e, the rest of the row is zero-filled.
// kVec: 16-byte copies (len, pitch, off, lo and hi multiples of 4, src
// 16-byte aligned), else 4-byte.  The caller commits the group.
template <bool kVec, int kLanes, typename Row>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* __restrict__ src,
                                           int rows, int len, Row row) {
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x % kLanes;
  for (int r = threadIdx.x / kLanes; r < rows; r += kThreads / kLanes) {
    long long off = 0;
    int lo = 0, hi = 0;
    row(r, off, lo, hi);
    for (int e = lane * kW; e < len; e += kLanes * kW) {
      const bool ok = e >= lo && e < hi;
      float* d = dst + r * pitch + e;
      const float* s = src + (ok ? off + e : 0);
      if (kVec)
        cp_async::copy16(d, s, ok);
      else
        cp_async::copy4(d, s, ok);
    }
  }
}

// ----------------------------------------------------------------------
// K4 and K5: out[r, o] = act(sum_{t, c} in(r, t, c) W[t, c, o] + bias[o])
// over output pixels r, taps t = (i, j) and input channels c;
// W[t, c, o] = w[i, j, c, o] (HWIO, forward) or w[kh-1-i, kw-1-j, o, c]
// (flipped and channel-swapped: the input gradient).
// ----------------------------------------------------------------------

// The layout of one K4/K5 block, from the shapes alone.  The launcher's
// chooser sizes tiles and chunks by the same bytes (conv2d.py
// conv_smem); the C entry refuses a block over the limit, and
// conv2d_tile_smem below lets a test on the card hold the two equal.
struct ConvPlan {
  int T;        // taps kh.kw
  int cn, cgn;  // output channels a block owns (a multiple of 4), quads
  int cc, cq;   // input channels a chunk holds, its quads (rounded up)
  int tc, ntc;  // taps a chunk holds, tap chunks
  int cs;       // floats a patch pixel takes: cq quads, made odd
  int nch, nst; // chunks, ring stages (2 where there is more than one)
  int PH, PW, P, U;   // patch rows and columns, tile pixels, P / 4 rounded up
  int jobs, units, rs;  // (pixel quad, channel quad) jobs, reduction
                        // units (tap, channel quad) a chunk, slices of them
  int xs_n, ms_n, ws_n, stage_n, region;
  __host__ __device__ ConvPlan(const Geometry& q, int tb, int th, int tw,
                               int chunk, int taps, bool flip) {
    T = q.kh * q.kw;
    cn = q.Co < 16 ? (q.Co + 3) / 4 * 4 : 16;
    cgn = cn / 4;
    cc = chunk;
    cq = (cc + 3) / 4;
    tc = taps;
    ntc = (T + tc - 1) / tc;
    cs = cq % 2 == 1 ? 4 * cq : 4 * cq + 4;
    nch = (q.Ci + cc - 1) / cc * ntc;
    nst = nch > 1 ? 2 : 1;
    PH = th + q.kh - 1;
    PW = tw + q.kw - 1;
    P = tb * th * tw;
    U = (P + 3) / 4;
    jobs = U * cgn;
    units = tc * cq;
    rs = kThreads / jobs;
    if (rs > units) rs = units;
    if (rs < 1) rs = 1;
    xs_n = tb * PH * PW * cs;
    ms_n = flip ? xs_n : 0;          // K5's mask patch
    ws_n = tc * 4 * cq * cn;
    stage_n = xs_n + ms_n + ws_n;
    const int red_n = rs * jobs * 16;   // the slices' partials, after
    region = nst * stage_n > red_n ? nst * stage_n : red_n;
  }
  // floats of the ring (or the partials), then the bias, the patch offsets
  // of every tap's channel quads and two tables of the tile's pixels (ints)
  __host__ __device__ size_t smem() const {
    return sizeof(float) * ((size_t)region + cn + (size_t)T * cq +
                            2 * (size_t)P);
  }
};

// One slice of the reduction: units sl, sl + rs, ... of the chunk's
// `units`; the chunk's unit r is its tap r / cq, channel quad r % cq, and
// uo[r] is its offset in the patch.
__device__ __forceinline__ void conv_accumulate(
    float4 (&acc)[4], const float* __restrict__ xs,
    const float* __restrict__ ws, const int* __restrict__ uo,
    const int (&xo)[4], int sl, int rs, int units, int cn, int cg) {
#pragma unroll 2
  for (int r = sl; r < units; r += rs) {
    const float* xp = xs + uo[r];
    const float* wp = ws + r * 4 * cn + cg * 4;
    const float4 w0 = *reinterpret_cast<const float4*>(wp);
    const float4 w1 = *reinterpret_cast<const float4*>(wp + cn);
    const float4 w2 = *reinterpret_cast<const float4*>(wp + 2 * cn);
    const float4 w3 = *reinterpret_cast<const float4*>(wp + 3 * cn);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(xp + xo[k]);
      float4& a = acc[k];
      a.x = fmaf(x.x, w0.x, a.x);
      a.y = fmaf(x.x, w0.y, a.y);
      a.z = fmaf(x.x, w0.z, a.z);
      a.w = fmaf(x.x, w0.w, a.w);
      a.x = fmaf(x.y, w1.x, a.x);
      a.y = fmaf(x.y, w1.y, a.y);
      a.z = fmaf(x.y, w1.z, a.z);
      a.w = fmaf(x.y, w1.w, a.w);
      a.x = fmaf(x.z, w2.x, a.x);
      a.y = fmaf(x.z, w2.y, a.y);
      a.z = fmaf(x.z, w2.z, a.z);
      a.w = fmaf(x.z, w2.w, a.w);
      a.x = fmaf(x.w, w3.x, a.x);
      a.y = fmaf(x.w, w3.y, a.y);
      a.z = fmaf(x.w, w3.z, a.z);
      a.w = fmaf(x.w, w3.w, a.w);
    }
  }
}

// Block (tile, channel tile) of K4 (kFlip false) or K5 (kFlip true):
// grid (tiles, ceil(Co / cn)).  vec_x: the input (and mask) take 16-byte
// copies (Ci and the chunk multiples of 4, pointers aligned); vec_w: the
// filter does (K4 with Co a multiple of 4).
template <bool kFlip>
__global__ void __launch_bounds__(kThreads)
conv_tile_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ mask, float* __restrict__ out,
                 Geometry q, int tb, int th, int tw, int chunk, int taps,
                 int relu, int vec_x, int vec_w) {
  extern __shared__ __align__(16) float sm[];
  const ConvPlan d(q, tb, th, tw, chunk, taps, kFlip);
  float* red = sm;                          // after the last chunk
  float* bs = sm + d.region;                // cn
  int* uo = reinterpret_cast<int*>(bs + d.cn);   // T x cq patch offsets
  int* po = uo + d.T * d.cq;   // P: each tile pixel's output pixel, or -1
  int* pr = po + d.P;       // P: its first partial in red

  const int tid = threadIdx.x;
  const int ntw = (q.Wo + tw - 1) / tw;
  const int nth = (q.Ho + th - 1) / th;
  const int w0 = (blockIdx.x % ntw) * tw;
  const int h0 = (blockIdx.x / ntw % nth) * th;
  const int b0 = blockIdx.x / ntw / nth * tb;
  const int o0 = blockIdx.y * d.cn;
  const bool masked = kFlip && mask != nullptr;

  // chunk ch (channels c0 .. c0 + nc, taps t0 .. t0 + tc) of the patch,
  // its mask and the filter panel into ring stage ch % nst
  auto stage_chunk = [&](int ch) {
    float* xs = sm + (ch % d.nst) * d.stage_n;
    float* ms = xs + d.xs_n;
    float* ws = ms + d.ms_n;
    const int c0 = ch / d.ntc * d.cc;
    const int t0 = ch % d.ntc * d.tc;
    const int nc = min(d.cc, q.Ci - c0);
    // one row per patch pixel: its nc channels, zero outside the input
    auto px = [&](int r, long long& off, int& lo, int& hi) {
      const int ww = r % d.PW;
      const int hh = r / d.PW % d.PH;
      const int bb = b0 + r / d.PW / d.PH;
      const int hi_ = h0 - q.pt + hh;
      const int wi = w0 - q.pl + ww;
      if (bb >= q.B || hi_ < 0 || hi_ >= q.Hi || wi < 0 || wi >= q.Wi) return;
      off = (((long long)bb * q.Hi + hi_) * q.Wi + wi) * q.Ci + c0;
      hi = nc;
    };
    const int rows = tb * d.PH * d.PW;
    if (vec_x) {
      stage_rows<true, 4>(xs, d.cs, in, rows, d.cs, px);
      if (masked) stage_rows<true, 4>(ms, d.cs, mask, rows, d.cs, px);
    } else {
      stage_rows<false, 4>(xs, d.cs, in, rows, d.cs, px);
      if (masked) stage_rows<false, 4>(ms, d.cs, mask, rows, d.cs, px);
    }
    // the filter panel ws[(t * 4 cq + c) * cn + o] of taps t0 + t
    const int cc4 = 4 * d.cq;
    if (!kFlip) {   // rows (t, c) of w[t0 + t, c0 + c, o0 : o0 + cn]
      auto wrow = [&](int r, long long& off, int& lo, int& hi) {
        const int t = r / cc4;
        const int c = r - t * cc4;
        if (c >= nc || t0 + t >= d.T) return;
        off = ((long long)(t0 + t) * q.Ci + c0 + c) * q.Co + o0;
        hi = min(d.cn, q.Co - o0);
      };
      if (vec_w)
        stage_rows<true, 4>(ws, d.cn, w, d.tc * cc4, d.cn, wrow);
      else
        stage_rows<false, 4>(ws, d.cn, w, d.tc * cc4, d.cn, wrow);
    } else {  // w[T - 1 - t0 - t, o0 + o, c0 + c]: contiguous along c
      const int n = d.tc * d.cn * cc4;
      for (int e = tid; e < n; e += kThreads) {
        const int c = e % cc4;
        const int o = e / cc4 % d.cn;
        const int t = e / cc4 / d.cn;
        const bool ok = c < nc && o0 + o < q.Co && t0 + t < d.T;
        const long long i =
            ok ? ((long long)(d.T - 1 - t0 - t) * q.Co + o0 + o) * q.Ci +
                     c0 + c
               : 0;
        cp_async::copy4(ws + (t * cc4 + c) * d.cn + o, w + i, ok);
      }
    }
  };

  stage_chunk(0);
  for (int o = tid; o < d.cn; o += kThreads) {
    const bool ok = bias != nullptr && o0 + o < q.Co;
    cp_async::copy4(bs + o, ok ? bias + o0 + o : w, ok);
  }
  cp_async::commit();
  // the tables, while the copies fly
  for (int r = tid; r < d.T * d.cq; r += kThreads) {
    const int t = r / d.cq;
    uo[r] = ((t / q.kw) * d.PW + t % q.kw) * d.cs + 4 * (r - t * d.cq);
  }
  for (int p = tid; p < d.P; p += kThreads) {
    const int ww = p % tw;
    const int hh = p / tw % th;
    const int bb = p / tw / th;
    const bool ok = b0 + bb < q.B && h0 + hh < q.Ho && w0 + ww < q.Wo;
    po[p] = ok ? ((b0 + bb) * q.Ho + h0 + hh) * q.Wo + w0 + ww : -1;
    pr[p] = p / d.U * 4 * d.jobs + p % d.U;
  }
  // this thread's job: pixels u + k U (k < 4) x channel quad cg, and its
  // reduction slice
  const int job = tid % d.jobs;
  const int sl = tid / d.jobs;
  const int u = job % d.U;
  const int cg = job / d.U;
  int xo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = u + k * d.U;
    xo[k] = p < d.P ? (((p / tw / th) * d.PH + p / tw % th) * d.PW + p % tw)
                          * d.cs
                    : 0;
  }
  float4 acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int ch = 0; ch < d.nch; ++ch) {
    if (ch + 1 < d.nch) stage_chunk(ch + 1);
    cp_async::commit();
    cp_async::wait<1>();      // every group but the newest: chunk ch
    __syncthreads();
    float* xs = sm + (ch % d.nst) * d.stage_n;
    if (masked) {             // the cotangent where the output is > 0
      const float* ms = xs + d.xs_n;
      for (int e = tid; e < d.xs_n; e += kThreads)
        if (!(ms[e] > 0.0f)) xs[e] = 0.0f;
      __syncthreads();
    }
    const int t0 = ch % d.ntc * d.tc;
    if (sl < d.rs)
      conv_accumulate(acc, xs, xs + d.xs_n + d.ms_n, uo + t0 * d.cq, xo, sl,
                      d.rs, min(d.tc, d.T - t0) * d.cq, d.cn, cg);
    __syncthreads();          // stage ch % nst is free again
  }

  // the slices' partials: red[(s * 16 + k * 4 + c) * jobs + job]
  if (sl < d.rs) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* r = red + (sl * 16 + k * 4) * d.jobs + job;
      r[0] = acc[k].x;
      r[d.jobs] = acc[k].y;
      r[2 * d.jobs] = acc[k].z;
      r[3 * d.jobs] = acc[k].w;
    }
  }
  __syncthreads();
  // output (pixel p, channel o): the slices in slice order, bias, relu
  const int n = d.P * d.cn;
  const int dp = kThreads / d.cn;
  const int dq = kThreads % d.cn;
  int p = tid / d.cn;
  int o = tid % d.cn;
  for (int e = tid; e < n; e += kThreads) {
    const int at = po[p];
    if (at >= 0 && o0 + o < q.Co) {
      const float* rp = red + pr[p] + (o & 3) * d.jobs + (o >> 2) * d.U;
      float v = rp[0];
      for (int s = 1; s < d.rs; ++s) v += rp[s * 16 * d.jobs];
      if (bias != nullptr) v += bs[o];
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)at * q.Co + o0 + o] = v;
    }
    o += dq;
    p += dp;
    if (o >= d.cn) {
      o -= d.cn;
      ++p;
    }
  }
}

// ----------------------------------------------------------------------
// K6 pass 1.  Geometry is the forward's: x (B, Hi, Wi, Ci), the cotangent
// g (B, Ho, Wo, Co).  Block (tile, tap chunk, channel chunk) owns the
// output pixels of one tile (clipped at the edges) and stages, once, the
// tile's x patch with its halo and the masked g of its channel chunk (ct
// <= 16 channels): rows of contiguous floats (4-byte copies).  Each thread
// owns 4 taps x 4 channels of the (K + 1) x Co table (row K is the
// constant 1 whose sums are db) and sums them over every pg_n-th pixel of
// the tile from shared memory; the pg_n pixel groups are then added in
// group order and the tile's sums written to part[tile].  No division per
// element of the sums: each pixel's patch offset is staged beside it.
// ----------------------------------------------------------------------
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
  const int ntw = (q.Wo + tw - 1) / tw;
  const int nth = (q.Ho + th - 1) / th;
  const int w0 = (blockIdx.x % ntw) * tw;
  const int h0 = (blockIdx.x / ntw % nth) * th;
  const int b0 = blockIdx.x / ntw / nth * tb;
  const int tg0 = blockIdx.y * d.tgb;
  const int co0 = blockIdx.z * d.ct;

  // x patch: tb x PH rows of PW x Ci floats, each a contiguous run of one
  // input row (zero outside it)
  const int row_len = q.Wi * q.Ci;
  const int lo_x = (w0 - q.pl) * q.Ci;
  stage_rows<false, 32>(xs, d.PW * q.Ci, x, tb * d.PH, d.PW * q.Ci,
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
    stage_rows<false, 32>(gs, tw * d.ct, g, tb * th, tw * d.ct, g_row);
    if (mask != nullptr)
      stage_rows<false, 32>(ms, tw * d.ct, mask, tb * th, tw * d.ct, g_row);
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

// Let `kernel` take up to the device's opt-in shared memory a block,
// dynamically; once per (kernel, device), `slot` naming the kernel.  Sets
// *limit to that many bytes.
constexpr int kSlots = 3;   // K6 pass 1, K4, K5

template <typename Kernel>
int opt_in_smem(Kernel* kernel, int slot, size_t* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int optin[kSlots][64] = {};
  if (dev < 64 && optin[slot][dev] > 0) {
    *limit = (size_t)optin[slot][dev];
    return 0;
  }
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) optin[slot][dev] = bytes;
  *limit = (size_t)bytes;
  return 0;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// K4 (flip = 0: in = x, w (kh, kw, Ci, Co), bias, no mask) and K5 (flip =
// 1: in = the cotangent g (B, Hi, Wi, Ci), w the forward's filter (kh,
// kw, Co, Ci), mask the forward's output or null).  (tb, th, tw) is a
// block's tile of output pixels, and `chunk` input channels of `taps` taps
// are what it stages at a time (kernels/conv2d.py conv_tile).
extern "C" int conv2d_tile_f32(const void* in, const void* w,
                               const void* bias, const void* mask,
                               void* out, int B, int Hi, int Wi, int Ci,
                               int Ho, int Wo, int Co, int kh, int kw,
                               int pt, int pl, int flip, int relu, int tb,
                               int th, int tw, int chunk, int taps,
                               void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Ci <= 0 || Co <= 0 || kh <= 0 ||
      kw <= 0 || tb <= 0 || th <= 0 || tw <= 0 || chunk <= 0 || chunk > Ci ||
      taps <= 0 || taps > kh * kw || (long long)tb * th * tw > 256 ||
      (long long)B * Ho * Wo > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Geometry q{B, Hi, Wi, Ci, Ho, Wo, Co, kh, kw, pt, pl};
  const ConvPlan d(q, tb, th, tw, chunk, taps, flip != 0);
  size_t limit = 0;
  const int set = flip ? opt_in_smem(conv_tile_kernel<true>, 2, &limit)
                       : opt_in_smem(conv_tile_kernel<false>, 1, &limit);
  if (set != 0) return set;
  if (d.smem() > limit) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((B + tb - 1) / tb) *
                          ((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const auto* ip = static_cast<const float*>(in);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<float*>(out);
  const int vec_x = Ci % 4 == 0 && chunk % 4 == 0 && aligned16(in) &&
                    (mask == nullptr || aligned16(mask));
  const int vec_w = !flip && Co % 4 == 0 && aligned16(w);
  dim3 grid((unsigned)tiles, (Co + d.cn - 1) / d.cn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flip)
    conv_tile_kernel<true><<<grid, kThreads, d.smem(), s>>>(
        ip, wp, bp, mp, op, q, tb, th, tw, chunk, taps, relu, vec_x,
        vec_w);
  else
    conv_tile_kernel<false><<<grid, kThreads, d.smem(), s>>>(
        ip, wp, bp, mp, op, q, tb, th, tw, chunk, taps, relu, vec_x,
        vec_w);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a K4 (flip = 0) or K5 (flip = 1) block takes for
// the (tb, th, tw) tile, `chunk` channels and `taps` taps
// (ConvPlan::smem), for holding the launcher's chooser (kernels/conv2d.py
// conv_smem) to the kernel.
extern "C" long long conv2d_tile_smem(int Ci, int Co, int kh, int kw,
                                      int tb, int th, int tw, int chunk,
                                      int taps, int flip) {
  const Geometry q{1, 1, 1, Ci, 1, 1, Co, kh, kw, 0, 0};
  return (long long)ConvPlan(q, tb, th, tw, chunk, taps, flip != 0).smem();
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
  const int set = opt_in_smem(conv_dw_partial_kernel, 0, &limit);
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
