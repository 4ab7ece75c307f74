// Shared by every kernel library: a plain C interface loaded with ctypes.
// Each entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that the Python
// wrapper can raise on a launch the runtime refused.
#pragma once
#include <cuda_runtime.h>

#define KEY_SENTINEL (-1)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
