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

constexpr unsigned FULL = 0xffffffffu;   // every lane of a warp

static inline int ncn_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// n contiguous values of src (f32, or bf16 when BF16) into shared memory
// as f32, in rows of `width` values `stride` floats apart, by the block's
// threads tid < nt: 16-byte loads where src is 16-byte aligned, and a bf16
// widened by a shift (it is the top half of its f32).
template <bool BF16>
__device__ __forceinline__ void ncn_stage(const void* __restrict__ src, int n,
                                          int width, int stride, float* dst,
                                          int tid, int nt) {
  constexpr int PER16 = BF16 ? 8 : 4;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int words = n / PER16;
    for (int i = tid; i < words; i += nt) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + i);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < PER16; ++k) {
        const int e = i * PER16 + k;
        float v;
        if constexpr (BF16)
          v = __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
        else
          v = __uint_as_float(w[k]);
        dst[(e / width) * stride + e % width] = v;
      }
    }
    done = words * PER16;
  }
  for (int e = done + tid; e < n; e += nt) {
    float v;
    if constexpr (BF16)
      v = __uint_as_float(static_cast<unsigned>(
                              static_cast<const unsigned short*>(src)[e])
                          << 16);
    else
      v = static_cast<const float*>(src)[e];
    dst[(e / width) * stride + e % width] = v;
  }
}
