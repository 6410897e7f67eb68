// The plain C entry points that every kernel library exports.
//
// Each .cu file of csrc/ is compiled on its own into its own shared library
// (zerocaf_tpu_torch/ops/kernels/build.py), so each library holds its own
// copy of the __constant__ tables of field.cuh and field32.cuh.  Every .cu
// file includes this header once, after field.cuh, and build.py calls
// zc_init on every library before its first launch to write field.cuh's
// (field32.cuh's are constant-initialised).

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

extern "C" {

const char* zc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes the fold constants of p and r (host pointers to 12 int32 each)
// into this library's constant memory on the current device.
int zc_init(const int32_t* fold_p, const int32_t* fold_r) {
  int32_t fold[2][zc::NC];
  for (int i = 0; i < zc::NC; ++i) {
    fold[0][i] = fold_p[i];
    fold[1][i] = fold_r[i];
  }
  return static_cast<int>(cudaMemcpyToSymbol(zc::c_fold, fold, sizeof(fold)));
}

}  // extern "C"
