// RMSNorm for Hopper (sm_90a): K9, forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call in rmsnorm_pallas; entry ops.rmsnorm).  Same contract: for
// every row of x (rows, d), out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and cast to x's dtype.  x is bf16 or f32, scale (d,) is
// f32 or bf16 (the port's norm scales are f32 masters).  The reference's
// kernel is forward only and its models differentiate the jnp norm
// (src/repro/models/layers.py rms_norm) with jax.grad; rmsnorm_bwd below
// computes that gradient (see its comment).
//
// Plain C interface (nvcc, loaded with ctypes by repro_torch/kernels/
// build.py); each entry point returns cudaGetLastError() after its
// launches and never synchronises.  The launch geometry comes from the
// wrapper (rmsnorm.py ``rms_plan``, ``bwd_plan``).
//
// What bounds it: bytes.  It reads x and writes out once (plus the small
// scale vector), about 2 flops per byte.  One Gemma-2 decode-step norm,
// 4 rows of d = 4608 in bf16, moves 92 KB: under 0.03 us at 3.35 TB/s, so
// at decode one round trip to memory and the launch dominate; a 5000-row
// prefill norm moves 92 MB, at least 27.5 us.
//
// What the design does about it (rmsnorm_rows_kernel: x and the scale on
// 16 bytes, d a whole number of 16-byte vectors, at most 12288):
//   * the row is read once and stays in registers: a group of `group`
//     threads (a warp or more) holds it as NV 16-byte vectors a thread (NV
//     fixed at compile time, at most 9, so a thread's loads issue back to
//     back), sums x^2 with shuffles (past one warp, once through shared
//     memory) and writes x * r * scale from the same registers, with no
//     second pass;
//   * the scale is copied into shared memory once per block with cp.async,
//     in flight with the rows' loads, and read as 16-byte vectors instead
//     of 8 scalar L2 loads per output vector;
//   * a block of 256 threads holds 256 / group consecutive rows, one pass
//     (on the card, one pass beat blocks that walk over the rows at every
//     prefill shape tried); up to 132 rows each gets its own block of up
//     to 256 threads, so a decode step's norm is one round trip.
// Other rows (an unaligned start, a ragged or wider d) take
// rmsnorm_chunked_kernel: a block a row, 16-byte vectors between an
// unaligned head and a ragged tail, two passes over the row (the second
// from L1/L2).  Every geometry sums in a fixed order: reruns give
// identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;          // the widest block of either kernel
constexpr int kStageBytes = 48 * 1024; // the staged scale, without opt-in
// the backward's staged scale, at most d f32 values, beside its 128 static
// bytes
constexpr int kBwdMaxD = (kStageBytes - 1024) / 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The V scale values of columns [c, c + V) from the staged scale, in f32.
template <int V, typename S>
__device__ __forceinline__ void read_scale(const S* staged, int c,
                                           float (&s)[V]) {
  if constexpr (sizeof(S) == 4) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(staged + c)[q];
      s[4 * q + 0] = f.x;
      s[4 * q + 1] = f.y;
      s[4 * q + 2] = f.z;
      s[4 * q + 3] = f.w;
    }
  } else {                             // V bf16: 16 bytes (V = 8) or 8
    uint4 raw;
    if constexpr (V == 8)
      raw = *reinterpret_cast<const uint4*>(staged + c);
    else
      *reinterpret_cast<uint2*>(&raw) =
          *reinterpret_cast<const uint2*>(staged + c);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = to_f(e[q]);
  }
}

// x (rows, d) with every row 16-byte aligned and d = nv * V; a block of
// blockDim.x threads holds blockDim.x / group consecutive rows, `group`
// threads a row (a multiple of 32), thread t of a group vectors t,
// t + group, ... (NV of them, the last ones masked past nv).  The scale
// (16-byte aligned, d * sizeof(S) a multiple of 16) is staged as it is.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, int group,
                    float eps) {
  constexpr int V = 16 / sizeof(T);    // elements in one 16-byte vector
  extern __shared__ uint4 staged4[];   // the scale: d values of S
  __shared__ float red[kThreads / 32];
  const S* staged = reinterpret_cast<const S*>(staged4);
  const int tid = threadIdx.x;
  const int t = tid % group;
  const int warps = group / 32;        // warps a row
  const int nv = d / V;
  const long long r = (long long)blockIdx.x * (blockDim.x / group) +
                      tid / group;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + r * nv;
  uint4* orow = reinterpret_cast<uint4*>(out) + r * nv;

  // the scale's copy into shared memory and the row's loads, all in
  // flight together
  const int n16 = d * (int)sizeof(S) / 16;
  for (int c = tid; c < n16; c += blockDim.x)
    cp_async::copy16(staged4 + c, reinterpret_cast<const uint4*>(scale) + c,
                     true);
  cp_async::commit();
  uint4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * group;
    v[j] = (r < rows && i < nv) ? __ldg(xr + i)
                                : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float f = to_f(e[q]);
      ss += f * f;
    }
  }
  // only the raw vectors stay live across the reduction: the f32 values
  // are converted again below, not kept (twice the registers in bf16)
#pragma unroll
  for (int j = 0; j < NV; ++j)
    asm volatile("" : "+r"(v[j].x), "+r"(v[j].y), "+r"(v[j].z),
                 "+r"(v[j].w));
  ss = warp_sum(ss);
  if (warps > 1 && tid % 32 == 0) red[tid / 32] = ss;
  cp_async::wait<0>();
  __syncthreads();                     // the scale, and the warps' sums
  if (warps > 1) {
    ss = 0.0f;
    for (int w = 0; w < warps; ++w) ss += red[tid / group * warps + w];
  }
  if (r >= rows) return;
  const float rs = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * group;
    if (i < nv) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      float s[V];
      read_scale<V>(staged, i * V, s);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = from_f<T>(to_f(e[q]) * rs * s[q]);
      orow[i] = packed;
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x / 32;
  float total = 0.0f;
  for (int w = 0; w < nwarps; ++w) total += red[w];
  return total;
}

// Any row: a block a row, [0, head) unaligned, [head, head + nv * V)
// 16-byte vectors, the rest a ragged tail; out shares x's alignment only
// when both pointers agree modulo 16, otherwise everything goes element
// by element.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_chunked_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const T* xr = x + base;
  T* orow = out + base;
  const int tid = threadIdx.x;

  const uintptr_t ax = (uintptr_t)xr;
  int head = (int)(((16 - ax % 16) % 16) / sizeof(T));
  const bool vec = (ax % sizeof(T) == 0) &&
                   ((uintptr_t)orow % 16 == ax % 16) && head <= d;
  if (!vec) head = d;
  const int nv = (d - head) / V;
  const int tail = head + nv * V;

  float ss = 0.0f;
  for (int i = tid; i < head; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  for (int i = tid; i < nv; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr + head)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = to_f(e[j]);
      ss += v * v;
    }
  }
  for (int i = tail + tid; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)d + eps);

  for (int i = tid; i < head; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
  for (int i = tid; i < nv; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr + head)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
    const int c0 = head + i * V;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = from_f<T>(to_f(e[j]) * r * to_f(scale[c0 + j]));
    reinterpret_cast<uint4*>(orow + head)[i] = packed;
  }
  for (int i = tail + tid; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
}

template <typename T, typename S, int NV>
int launch_rows(const void* x, const void* scale, void* out, int rows, int d,
                int group, int block, int grid, float eps,
                cudaStream_t stream) {
  rmsnorm_rows_kernel<T, S, NV><<<grid, block, d * sizeof(S), stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, group, eps);
  return (int)cudaGetLastError();
}

// The instances of NV: rmsnorm.py's _PER_THREAD.
template <typename T, typename S>
int dispatch_rows(int per_thread, const void* x, const void* scale,
                  void* out, int rows, int d, int group, int block, int grid,
                  float eps, cudaStream_t s) {
#define RMS_ROWS(n)                                                         \
  case n:                                                                   \
    return launch_rows<T, S, n>(x, scale, out, rows, d, group, block, grid, \
                                eps, s);
  switch (per_thread) {
    RMS_ROWS(1) RMS_ROWS(2) RMS_ROWS(3) RMS_ROWS(4) RMS_ROWS(6) RMS_ROWS(8)
    RMS_ROWS(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RMS_ROWS
}

template <typename T, typename S>
int launch_chunked(const void* x, const void* scale, void* out, int rows,
                   int d, int block, float eps, cudaStream_t stream) {
  rmsnorm_chunked_kernel<T, S><<<rows, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- backward
// Per row, with r = rsqrt(mean x^2 + eps): dx = r (g s - x c1) where
// c1 = r^2 mean((g s) x), and the row adds g (x r) to dscale.  Block b
// owns rows [b * rpb, (b + 1) * rpb) and writes its dscale partial to
// part[b] (straight to dscale when it is the only block); a second launch
// adds the partials in block order (rmsnorm_bwd_reduce_kernel).  No two
// threads share a column of a partial, so there are no atomics.
//
// rmsnorm_bwd_rows_kernel: the block is one group of threads; thread t
// holds vectors t, t + group, ... (NV of them, V columns each) of the
// row's x and g in registers, the row's two sums go through shuffles and
// (past one warp) a parity-buffered shared array, and dx is written from
// the same registers; the thread's columns of the dscale partial stay in
// registers across the block's rows.  `vec` (x, g, dx, the scale and the
// partials on 16 bytes, d a whole number of vectors and the scale of
// 16-byte vectors): every vector moves as one 16-byte access and the
// scale is staged by cp.async, as in the forward.  Otherwise (an
// unaligned start, a ragged d) every element moves alone and the columns
// past d are zeros, which add nothing to the sums.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int d, int rpb,
                        int vec, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint4 staged4[];   // the scale: nv * V values of S
  __shared__ float red[2][2][kThreads / 32];   // [row parity][sum][warp]
  S* staged = reinterpret_cast<S*>(staged4);
  const int tid = threadIdx.x;
  const int group = blockDim.x;
  const int warps = group / 32;
  const int nv = (d + V - 1) / V;
  if (vec) {
    const int n16 = d * (int)sizeof(S) / 16;
    for (int c = tid; c < n16; c += group)
      cp_async::copy16(staged4 + c,
                       reinterpret_cast<const uint4*>(scale) + c, true);
    cp_async::commit();
    cp_async::wait<0>();
  } else {
    for (int c = tid; c < nv * V; c += group)
      staged[c] = c < d ? scale[c] : from_f<S>(0.0f);
  }
  __syncthreads();

  float acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[j][q] = 0.0f;
  const int r0 = blockIdx.x * rpb;
  const int r1 = min(rows, r0 + rpb);
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * d;
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * group;
      if (vec) {
        const bool ok = i < nv;
        xv[j] = ok ? __ldg(reinterpret_cast<const uint4*>(x + base) + i)
                   : make_uint4(0u, 0u, 0u, 0u);
        gv[j] = ok ? __ldg(reinterpret_cast<const uint4*>(g + base) + i)
                   : make_uint4(0u, 0u, 0u, 0u);
      } else {
        T* xe = reinterpret_cast<T*>(&xv[j]);
        T* ge = reinterpret_cast<T*>(&gv[j]);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int c = i * V + q;
          const bool ok = i < nv && c < d;
          xe[q] = ok ? __ldg(x + base + c) : from_f<T>(0.0f);
          ge[q] = ok ? __ldg(g + base + c) : from_f<T>(0.0f);
        }
      }
    }
    float ss = 0.0f, t = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * group;
      if (i >= nv) continue;
      const T* xe = reinterpret_cast<const T*>(&xv[j]);
      const T* ge = reinterpret_cast<const T*>(&gv[j]);
      float s[V];
      read_scale<V>(staged, i * V, s);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xf = to_f(xe[q]);
        ss += xf * xf;
        t += to_f(ge[q]) * s[q] * xf;
      }
    }
    ss = warp_sum(ss);
    t = warp_sum(t);
    if (warps > 1) {
      // rows alternate buffers: a buffer is rewritten two rows on, after
      // every thread has passed the next row's barrier
      const int p = (row - r0) & 1;
      if (tid % 32 == 0) {
        red[p][0][tid / 32] = ss;
        red[p][1][tid / 32] = t;
      }
      __syncthreads();
      ss = 0.0f;
      t = 0.0f;
      for (int w = 0; w < warps; ++w) {
        ss += red[p][0][w];
        t += red[p][1][w];
      }
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float c1 = r * r * (t / (float)d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * group;
      if (i >= nv) continue;
      const T* xe = reinterpret_cast<const T*>(&xv[j]);
      const T* ge = reinterpret_cast<const T*>(&gv[j]);
      float s[V];
      read_scale<V>(staged, i * V, s);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xf = to_f(xe[q]);
        const float gf = to_f(ge[q]);
        o[q] = from_f<T>(r * (gf * s[q] - xf * c1));
        acc[j][q] += gf * (xf * r);
      }
      if (vec) {
        reinterpret_cast<uint4*>(dx + base)[i] = packed;
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q)
          if (i * V + q < d) dx[base + i * V + q] = o[q];
      }
    }
  }
  float* out = part + (size_t)blockIdx.x * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = tid + j * group;
    if (i >= nv) continue;
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      if (vec) {
        reinterpret_cast<float4*>(out)[(i * V + q) / 4] = make_float4(
            acc[j][q], acc[j][q + 1], acc[j][q + 2], acc[j][q + 3]);
      } else {
#pragma unroll
        for (int k = q; k < q + 4; ++k)
          if (i * V + k < d) out[i * V + k] = acc[j][k];
      }
    }
  }
}

// dscale[c] = the blocks' partials of column c, added in block order: a
// block of 32 x kSumRows threads takes 32 columns; thread (c, y) sums the
// partial rows y, y + kSumRows, ... in order, and the kSumRows sums are
// added in order of y.
constexpr int kSumRows = 8;

__global__ void __launch_bounds__(32 * kSumRows)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kSumRows][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int y = threadIdx.y;
  float v = 0.0f;
  if (c < d)
    for (int b = y; b < blocks; b += kSumRows) v += part[(size_t)b * d + c];
  sums[y][threadIdx.x] = v;
  __syncthreads();
  if (y != 0 || c >= d) return;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumRows; ++k) total += sums[k][threadIdx.x];
  dscale[c] = total;
}

template <typename T, typename S, int NV>
void launch_bwd_rows(const void* x, const void* scale, const void* g,
                     void* dx, float* part, int rows, int d, int rpb,
                     int block, int grid, int vec, float eps,
                     cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const size_t staged = ((size_t)(d + V - 1) / V * V * sizeof(S) + 15) / 16;
  rmsnorm_bwd_rows_kernel<T, S, NV><<<grid, block, staged * 16, s>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, d, rpb, vec,
      eps);
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx,
               void* part, void* dscale, int rows, int d, int per_thread,
               int rpb, int block, int grid, int vec, float eps,
               cudaStream_t s) {
  // one block writes dscale itself; more write partials, then one sum
  float* first = static_cast<float*>(grid == 1 ? dscale : part);
  switch (per_thread) {   // rmsnorm.py's _BWD_PER_THREAD
#define RMS_BWD_ROWS(n)                                                     \
  case n:                                                                   \
    launch_bwd_rows<T, S, n>(x, scale, g, dx, first, rows, d, rpb, block,  \
                             grid, vec, eps, s);                            \
    break;
    RMS_BWD_ROWS(1) RMS_BWD_ROWS(2) RMS_BWD_ROWS(3) RMS_BWD_ROWS(4)
    RMS_BWD_ROWS(6) RMS_BWD_ROWS(8) RMS_BWD_ROWS(12)
#undef RMS_BWD_ROWS
    default:
      return (int)cudaErrorInvalidValue;
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0 || grid == 1) return rc;
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale), grid,
      d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (rows, d) of one dtype (x_bf16: bf16, else f32); scale (d,)
// (scale_bf16: bf16, else f32).  per_thread > 0: rmsnorm_rows_kernel with
// that NV, `group` threads a row, blocks of `block` threads, `grid` blocks;
// per_thread == 0: rmsnorm_chunked_kernel, a block of `block` threads a
// row (group and grid unused).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, int x_bf16, int scale_bf16,
                           int group, int per_thread, int block, int grid,
                           float eps, void* stream) {
  if (rows <= 0 || d <= 0 || block <= 0 || block > kThreads ||
      block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_thread == 0) {
    if (x_bf16)
      return scale_bf16
          ? launch_chunked<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows,
                                                         d, block, eps, s)
          : launch_chunked<__nv_bfloat16, float>(x, scale, out, rows, d,
                                                 block, eps, s);
    return scale_bf16
        ? launch_chunked<float, __nv_bfloat16>(x, scale, out, rows, d, block,
                                               eps, s)
        : launch_chunked<float, float>(x, scale, out, rows, d, block, eps, s);
  }
  // the row kernel's preconditions: aligned rows of whole vectors, a
  // group of whole warps that tiles the block, room for the scale, every
  // vector of a row covered, and a grid of one pass over the rows
  const int V = x_bf16 ? 8 : 4;
  const long long scale_bytes = (long long)d * (scale_bf16 ? 2 : 4);
  const long long per_block = group > 0 ? block / group : 0;
  if (group <= 0 || group % 32 != 0 || block % group != 0 || d % V != 0 ||
      ((uintptr_t)x | (uintptr_t)out | (uintptr_t)scale) % 16 != 0 ||
      scale_bytes % 16 != 0 || scale_bytes > kStageBytes ||
      (long long)group * per_thread < d / V ||
      grid != (rows + per_block - 1) / per_block)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return scale_bf16
        ? dispatch_rows<bf16, bf16>(per_thread, x, scale, out, rows, d,
                                    group, block, grid, eps, s)
        : dispatch_rows<bf16, float>(per_thread, x, scale, out, rows, d,
                                     group, block, grid, eps, s);
  return scale_bf16
      ? dispatch_rows<float, bf16>(per_thread, x, scale, out, rows, d, group,
                                   block, grid, eps, s)
      : dispatch_rows<float, float>(per_thread, x, scale, out, rows, d, group,
                                    block, grid, eps, s);
}

// The gradient of out = x * rsqrt(mean(x^2) + eps) * scale (f32 inside,
// as jax.grad computes the reference's jnp norm) for the cotangent g of
// out: per row, with r = rsqrt(mean x^2 + eps), x^ = x r and dy = g s,
//   dx = r (dy - x^ mean(dy x^))     (written in x's dtype)
//   dscale = sum over rows of g x^   (f32)
// r is recomputed from x, as the forward saves nothing.  x, g, dx (rows,
// d) of one dtype (x_bf16: bf16, else f32), scale (d,) (scale_bf16).
// `grid` blocks of `block` threads, `rpb` rows each, `per_thread` (NV)
// vectors of a row a thread (rmsnorm.py bwd_plan): none empty, together
// every row and every vector of a row.  With more than one block `part`
// holds their (grid, d) f32 partials, summed in block order into dscale
// by a second launch.  No atomics: a rerun gives identical bits.
// What bounds it: bytes (x and g read, dx written, 19 MB at a 1024 x
// 3072 bf16 LM step's norm: 5.6 us at 3.35 TB/s; the partials add grid x
// d floats, written and read once).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* g,
                           void* dx, void* part, void* dscale, int rows,
                           int d, int x_bf16, int scale_bf16, int per_thread,
                           int block, int rpb, int grid, float eps,
                           void* stream) {
  const int V = x_bf16 ? 8 : 4;
  const long long scale_bytes = (long long)d * (scale_bf16 ? 2 : 4);
  if (rows <= 0 || d <= 0 || d > kBwdMaxD || block <= 0 ||
      block > kThreads || block % 32 != 0 || per_thread <= 0 ||
      (long long)block * per_thread < (d + V - 1) / V || rpb <= 0 ||
      grid <= 0 || (long long)grid * rpb < rows ||
      (long long)(grid - 1) * rpb >= rows || (grid > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // whole 16-byte vectors: every row, the scale and the partials aligned
  const int vec =
      d % V == 0 && scale_bytes % 16 == 0 &&
      ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx | (uintptr_t)scale |
       (uintptr_t)(grid > 1 ? part : dscale)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return scale_bf16
        ? launch_bwd<bf16, bf16>(x, scale, g, dx, part, dscale, rows, d,
                                 per_thread, rpb, block, grid, vec, eps, s)
        : launch_bwd<bf16, float>(x, scale, g, dx, part, dscale, rows, d,
                                  per_thread, rpb, block, grid, vec, eps, s);
  return scale_bf16
      ? launch_bwd<float, bf16>(x, scale, g, dx, part, dscale, rows, d,
                                per_thread, rpb, block, grid, vec, eps, s)
      : launch_bwd<float, float>(x, scale, g, dx, part, dscale, rows, d,
                                 per_thread, rpb, block, grid, vec, eps, s);
}
