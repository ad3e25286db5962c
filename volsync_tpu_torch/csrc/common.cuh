// Shared by every CUDA source of volsync_tpu_torch: the launch-status
// convention of the ctypes binding (ops/_build.py).
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
