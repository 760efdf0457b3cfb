// cp.async helpers shared by the kernels that stream tiles through a
// shared-memory ring (gemm_f32.cuh, dense_fwd.cu, flash_attention.cu) or
// stage a tile or a vector (conv2d.cu, rmsnorm.cu): 16-byte global ->
// shared copies that bypass L1 (cp.async.cg) and 4-byte ones
// (cp.async.ca), zero-filled where `valid` is false, committed in groups
// and waited on by count.

#pragma once

#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* smem, const void* gmem,
                                      bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's committed groups are in
// flight: every older group has landed.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace cp_async
