// Shared by every CUDA source of volsync_tpu_torch: the launch-status
// convention of the ctypes binding (ops/_build.py), and the cp.async
// helpers of the staged kernels (K1 in sha256.cu, merkle.cu).
//
// Each exported launcher takes raw device pointers, sizes, the device
// index and the CUDA stream as plain C arguments, launches on that
// stream without synchronising, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch. Outputs are allocated by
// the wrapper; kernels allocate nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VT_EXPORT extern "C" __attribute__((visibility("default")))

VT_EXPORT const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int vt_begin(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Asynchronous global -> shared copies (cp.async, LDGSTS in SASS): the
// bytes land in shared memory without passing through registers, so a
// thread can issue the loads of a later stage and compute on an earlier
// one. ``src_bytes`` below the copy size zero-fills the rest (0: a zero
// copy that reads nothing). A thread sees its own copies after
// vt_cp_async_wait<N>() (at most N of its committed groups still in
// flight); other threads see them after a barrier.
__device__ __forceinline__ void vt_cp_async16(void* smem, const void* gmem,
                                              int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// The same copy allocated in L1 too (cp.async.ca), for a kernel whose
// threads on one SM copy the same bytes again (K2's padding lanes all
// hash row 0): the repeats hit L1 instead of queueing on one L2 slice.
__device__ __forceinline__ void vt_cp_async16_l1(void* smem,
                                                 const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void vt_cp_async4(void* smem, const void* gmem,
                                             int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void vt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void vt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
