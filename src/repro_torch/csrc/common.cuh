// Shared by every kernel library of the port: the error-string entry point
// that the Python wrappers call when a launch returns an error code.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
