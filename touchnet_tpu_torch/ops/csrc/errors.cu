// Copyright (c) 2026 touchnet_tpu authors.
// Error text for the cudaError_t codes the kernel entries return.

#include <cuda_runtime.h>

extern "C" const char* tn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
