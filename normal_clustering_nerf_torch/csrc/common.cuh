// Shared by every kernel library of the port: each library is a plain C
// interface loaded with ctypes (normal_clustering_nerf_torch/kernels.py).
// A launcher returns cudaGetLastError() right after its launch, so a
// refused launch (bad configuration, too many resources) reaches Python
// as a nonzero code instead of going unnoticed.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* ncn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline int ncn_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}
