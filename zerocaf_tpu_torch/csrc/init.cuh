// The plain C entry points that every kernel library exports.
//
// Each .cu file of csrc/ is compiled on its own into its own shared library
// (zerocaf_tpu_torch/ops/kernels/build.py), so each library holds its own
// copy of the __constant__ tables of field.cuh.  Every .cu file includes
// this header once, after field.cuh, and build.py calls zc_init on every
// library before its first launch.

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

extern "C" {

const char* zc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes the fold constants of p and r and the curve's d and 2d (host
// pointers to 12, 12, 22 and 22 int32) into this library's constant memory
// on the current device.
int zc_init(const int32_t* fold_p, const int32_t* fold_r, const int32_t* d,
            const int32_t* d2) {
  int32_t fold[2][zc::NC];
  for (int i = 0; i < zc::NC; ++i) {
    fold[0][i] = fold_p[i];
    fold[1][i] = fold_r[i];
  }
  cudaError_t err = cudaMemcpyToSymbol(zc::c_fold, fold, sizeof(fold));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(zc::c_d, d, zc::L * sizeof(int32_t));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(zc::c_d2, d2, zc::L * sizeof(int32_t));
  return static_cast<int>(err);
}

}  // extern "C"
