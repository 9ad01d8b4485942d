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

// Rows of `width` floats (a multiple of 4) of src, one after another, into
// shared memory rows `stride` floats apart (a multiple of 4), by threads
// tid < nt, 16 bytes a copy with cp.async: no registers hold the data, so
// the copies run on while the threads go on; `ncn_async_wait` waits for
// the thread's own copies (a barrier after it makes them the block's).
// The lines are marked first to leave the L2 (evict_first): data read
// once must not push out what a kernel's atomics reuse there. src and dst
// must be 16-byte aligned.
__device__ __forceinline__ void ncn_stage_async(const float* __restrict__ src,
                                                int rows, int width,
                                                int stride, float* dst,
                                                int tid, int nt) {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  const int per = width / 4;
  for (int q = tid; q < rows * per; q += nt) {
    const int i = q / per, w = q - i * per;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + i * stride + 4 * w));
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
        ::"r"(d), "l"(src + static_cast<long long>(i) * width + 4 * w),
        "l"(policy)
        : "memory");
  }
}

__device__ __forceinline__ void ncn_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ncn_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The inverse of ncn_stage: n values of shared-memory rows (`width` values
// `stride` floats apart) written contiguously to dst as f32, or rounded
// once to bf16 when BF16, by the block's threads tid < nt: 16-byte stores
// where dst is 16-byte aligned.
// With STREAM the 16-byte stores are streaming ones (st.global.cs): data
// that no kernel reads again soon should not push out of the L2 what the
// kernel's own loads reuse.
template <bool BF16, bool STREAM = false>
__device__ __forceinline__ void ncn_unstage(const float* src, int n, int width,
                                            int stride, void* __restrict__ dst,
                                            int tid, int nt) {
  constexpr int PER16 = BF16 ? 8 : 4;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int words = n / PER16;
    for (int i = tid; i < words; i += nt) {
      float v[PER16];
#pragma unroll
      for (int k = 0; k < PER16; ++k) {
        const int e = i * PER16 + k;
        v[k] = src[(e / width) * stride + e % width];
      }
      uint4 u;
      if constexpr (BF16)
        u = make_uint4(ncn_pack_bf16(v[0], v[1]), ncn_pack_bf16(v[2], v[3]),
                       ncn_pack_bf16(v[4], v[5]), ncn_pack_bf16(v[6], v[7]));
      else
        u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3]));
      if constexpr (STREAM)
        __stcs(reinterpret_cast<uint4*>(dst) + i, u);
      else
        reinterpret_cast<uint4*>(dst)[i] = u;
    }
    done = words * PER16;
  }
  for (int e = done + tid; e < n; e += nt) {
    const float v = src[(e / width) * stride + e % width];
    if constexpr (BF16)
      static_cast<__nv_bfloat16*>(dst)[e] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(dst)[e] = v;
  }
}

// The 8 corners' float2 rows (H7) or slots (H5), counted from `table`, as
// 4 pairs (a, a ^ S): S = 1 pairs the z neighbours (a dense tcnn level,
// every brick row), S = 4 the x neighbours (a hashed tcnn level, where
// x's prime is 1). Each pair's first row comes as the float4 of its
// aligned row pair, which holds the second row too when both share it; a
// lane whose second row lies elsewhere loads it as a float2 (the other
// lanes are masked off that load). `table` must be 16-byte aligned.
template <int S>
__device__ __forceinline__ void ncn_load_pairs(
    const float* __restrict__ table, const int row[8], float2 v[8]) {
  float4 q[4];
  float2 u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = S == 1 ? 2 * k : k;
    q[k] = __ldg(reinterpret_cast<const float4*>(table) + (row[a] >> 1));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = S == 1 ? 2 * k : k, b = a ^ S;
    u[k] = make_float2(0.0f, 0.0f);
    if ((row[b] >> 1) != (row[a] >> 1))
      u[k] = __ldg(reinterpret_cast<const float2*>(table) + row[b]);
  }
  // each half selected in place: the same selection through a helper
  // compiled H5 to 33 registers and ~7% slower on the card
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = S == 1 ? 2 * k : k, b = a ^ S;
    const int ra = row[a], rb = row[b];
    v[a] = (ra & 1) ? make_float2(q[k].z, q[k].w)
                    : make_float2(q[k].x, q[k].y);
    v[b] = (rb >> 1) != (ra >> 1) ? u[k]
           : (rb & 1)             ? make_float2(q[k].z, q[k].w)
                                  : make_float2(q[k].x, q[k].y);
  }
}
