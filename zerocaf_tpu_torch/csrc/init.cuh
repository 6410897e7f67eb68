// The plain C entry point that every kernel library exports beside its
// launchers.
//
// Each .cu file of csrc/ is compiled on its own into its own shared library
// (zerocaf_tpu_torch/ops/kernels/build.py).  The kernels' constants are
// constant-initialised in field32.cuh, so a library needs no set-up before
// its first launch.  Every .cu file includes this header once.

#pragma once

#include <cuda_runtime.h>

extern "C" {

const char* zc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
