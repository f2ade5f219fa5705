// Shared by every kernel library of repro_torch.
//
// Each .cu file in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (see kernels/build.py). Every
// exported launch function takes the caller's stream, launches one kernel
// on it, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise when a launch was refused.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define REPRO_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bits of the lanes below this one in a warp (lanemask_lt).
__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}
