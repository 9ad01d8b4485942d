// Device helpers shared by the warp-per-ray marches: K1 (march_sv.cu) and
// H9/H10/H11 (march_fine.cu). Every t, position and cell is the JAX
// reference's operations in its order (__fmul_rn/__fadd_rn/__fdiv_rn; the
// libraries are built with --fmad=false), so that a sample on a cell or
// supervoxel boundary lands where the reference puts it.
#pragma once
#include <math.h>

#include "common.cuh"

// occupancy_lookup's cell of one coordinate (ray_march.py:83-86):
// clip(0.5 * (x / mip_bound + 1) * G, 0, G - 1) truncated to int. With
// inv_mb = 1 / mip_bound given (non-zero) for a power-of-two mip_bound,
// x / mip_bound is taken as x * inv_mb: the same real value, so the same
// correctly rounded float, for a multiply in place of a division.
__device__ __forceinline__ int cell_of(float x, float mip_bound, int G,
                                       float inv_mb = 0.0f) {
  const float q = inv_mb != 0.0f ? __fmul_rn(x, inv_mb)
                                 : __fdiv_rn(x, mip_bound);
  float v = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(q, 1.0f)),
                      static_cast<float>(G));
  v = fminf(fmaxf(v, 0.0f), static_cast<float>(G - 1));
  return static_cast<int>(v);
}

// lattice step k of a ray: t0 + k*lo, never accumulated
__device__ __forceinline__ float step_t(float t0, int k, float lo) {
  return __fadd_rn(t0, __fmul_rn(static_cast<float>(k), lo));
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  return lt;
}

// 0-based position of the need-th (1-based) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int need) {
  for (int i = 1; i < need; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// rank_targets (ray_march.py:341-373): the 1-based occupied rank slot i
// holds, and through `span` (when given) the occupied steps it stands for.
__device__ __forceinline__ int target_rank(int i, int K1, int K2, int E,
                                           bool tail, int* span = nullptr) {
  if (span) *span = 1;
  if (!tail || i < K1) return i + 1;
  const int j = i - K1 + 1;
  if (E <= K2) return K1 + j;
  const int cur = (j * E) / K2;
  if (span) *span = max(cur - ((j - 1) * E) / K2, 1);
  return K1 + cur;
}

// Its inverse, stratified_budget's rule (ray_march.py:320-338): the slot
// of occupied rank x (1-based) and its span, or -1 if x is not kept.
__device__ __forceinline__ int slot_of_rank(int x, int K1, int K2, int E,
                                            bool tail, int* span) {
  *span = 1;
  if (x <= K1) return x - 1;
  if (!tail) return -1;
  int y = x - K1;                       // rank inside the tail, >= 1
  if (E <= K2) return K1 + y - 1;
  int js = (y * K2 + E - 1) / E;        // ceil(y*K2/E)
  if ((js * E) / K2 != y) return -1;
  *span = y - ((js - 1) * E) / K2;
  return K1 + js - 1;
}

// 1 / m when m is a positive power of two (exact), else 0 (host side)
inline float pow2_inverse(float m) {
  int e;
  return m > 0.0f && frexpf(m, &e) == 0.5f ? ldexpf(1.0f, 1 - e) : 0.0f;
}
