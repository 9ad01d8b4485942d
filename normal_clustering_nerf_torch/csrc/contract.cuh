// The contraction of a hash-grid encode's Jacobian with the cotangent:
// the position gradient of H13 (`brick_contract`, brick_hash.cu) and H14
// (`hash_grid_contract`, hash_grid.cu), whose forwards write the Jacobian
// in one layout, (M, L, F = 2, 3) f32. Why a launch of its own, and what
// bounds it: hash_grid.cu's note.
#pragma once
#include "common.cuh"

namespace contract {

constexpr int TILE = 32;   // samples a block takes

// A block takes TILE samples, stages their J rows (padded to 6L + 4
// floats) and their cotangent (f32 or bf16, widened) with 16-byte loads,
// and a thread per (sample, axis) adds g[l][f] * J[l][f][a] over (l, f)
// in order from 0; no atomics.
constexpr int CONTRACT_THREADS = 128;

template <bool BF16>
__global__ void __launch_bounds__(CONTRACT_THREADS) contract_kernel(
    const void* __restrict__ g, const float* __restrict__ jac,
    float* __restrict__ dx, int M, int L) {
  extern __shared__ float4 smem[];
  const int K = 2 * L, jstride = 3 * K + 4, gstride = K + 1;
  float* js = reinterpret_cast<float*>(smem);
  float* gs = js + TILE * jstride;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(jac + 3LL * K * m0, rows * 3 * K, 3 * K, jstride, js, tid,
                   nt);
  ncn_stage<BF16>(static_cast<const char*>(g) + (BF16 ? 2LL : 4LL) * K * m0,
                  rows * K, K, gstride, gs, tid, nt);
  __syncthreads();
  for (int e = tid; e < rows * 3; e += nt) {
    const int i = e / 3, a = e - 3 * i;
    const float* gi = gs + i * gstride;
    const float* ji = js + i * jstride + a;
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) s = __fadd_rn(s, __fmul_rn(gi[k], ji[3 * k]));
    dx[3LL * m0 + e] = s;
  }
}

// dx (M, 3) f32 from jac (M, L, 2, 3) f32 and g (M, 2L), f32 or bf16.
inline int launch(const void* g, const void* jac, void* dx, int M, int L,
                  int g_bf16, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * TILE * (6 * L + 4 + 2 * L + 1);
  auto kernel = g_bf16 ? contract_kernel<true> : contract_kernel<false>;
  if (bytes > 48 * 1024) {   // the opt-in holds per device: set it each time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ncn_blocks(M, TILE), CONTRACT_THREADS, bytes, stream>>>(
      g, static_cast<const float*>(jac), static_cast<float*>(dx), M, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace contract
