// H2: triplane + coarse-grid encode, forward and backward.
//
// Replaces the JAX package's `triplane_encode_vjp`
// (normal_clustering_nerf_tpu/models/triplane.py:196-253: `_encode_impl`
// forward, `_tp_bwd` backward with need_dx=False).
//
// Layout (feature-major "v2" rows, triplane.py:41-46): each of the three
// planes (xy, xz, yz) is a table of nb2^2 rows of 128 values, row = one
// 4x4-vertex brick, lane f*16 + s for feature f < 8 and slot s = lu*4 + lv;
// the coarse grid is nb3^3 rows of 256 values, lane f*64 + s with
// s = lx*16 + ly*4 + lz. A position needs 4 slots of one row per plane
// (bilinear) and 8 slots of one grid row (trilinear).
//
// Forward: one thread per sample computes the brick row and the corner
// weights exactly as the JAX geometry does (clip(x*(R-1), 0, R-2+1e-6),
// floor, 1-f / f, products in the same order) and folds only the 4 (or 8)
// needed slots of each feature: 4*8*3 + 8*4 = 128 values read instead of
// the 3*128 + 256 of whole rows. With bf16 rows (bf16 compute), each table
// value and weight is rounded to bf16 and their product rounded to bf16
// before the f32 sum, as the JAX fold does after casting the table.
// The f32 master tables are read directly, so no bf16 copy of the tables
// is made per call.
//
// Backward: one thread per sample adds g[f] * w[s] into the 4 (8) touched
// slots of each table with fp32 atomicAdd (the JAX version scatter-adds in
// bf16 under bf16 compute; fp32 is exact up to summation order).
//
// Bound on the H100: memory latency. Both directions are random 4-byte
// accesses into 56 MB of tables (bigger than the 50 MB L2): ~50 32-byte
// sectors per sample, no reuse inside a thread. The design keeps each
// access to the slots actually needed, keeps many samples in flight (one
// thread each, 256 per block) to hide the latency, and lets the atomics
// resolve in L2 (`atomicAdd` without a used result compiles to RED).
#include "common.cuh"

namespace {

constexpr int FP = 8;      // plane features (16 slots * 8 = 128 lanes)
constexpr int FG = 4;      // grid features (64 slots * 4 = 256 lanes)

struct Axis {
  int brick, slot;   // brick index, local slot of the lower vertex
  float w0, w1;      // weights of the lower / upper vertex
};

__device__ __forceinline__ Axis axis_of(float x, int res, float hi) {
  float pos = __fmul_rn(x, static_cast<float>(res - 1));
  pos = fminf(fmaxf(pos, 0.0f), hi);
  float p0f = floorf(pos);
  float f = __fsub_rn(pos, p0f);
  int p0 = static_cast<int>(p0f);
  Axis a;
  a.brick = p0 / 3;
  a.slot = p0 - 3 * a.brick;
  a.w0 = __fsub_rn(1.0f, f);
  a.w1 = f;
  return a;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float fold_term(float v, float w, bool bf16) {
  if (!bf16) return __fmul_rn(v, w);
  return bf16r(__fmul_rn(bf16r(v), bf16r(w)));
}

__global__ void triplane_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ planes,
    const float* __restrict__ grid, float* __restrict__ out, int M,
    int plane_res, int nb2, int grid_res, int nb3, int plane_rows,
    float plane_hi, float grid_hi, int bf16) {
  int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float p[3] = {x[3 * m], x[3 * m + 1], x[3 * m + 2]};
  const int pa[3] = {0, 0, 1}, pb[3] = {1, 2, 2};
  float* o = out + static_cast<size_t>(m) * (3 * FP + FG);
  for (int pi = 0; pi < 3; ++pi) {
    Axis u = axis_of(p[pa[pi]], plane_res, plane_hi);
    Axis v = axis_of(p[pb[pi]], plane_res, plane_hi);
    const float* row = planes +
        (static_cast<size_t>(pi) * plane_rows + u.brick * nb2 + v.brick) * 128;
    const int s00 = u.slot * 4 + v.slot;
    const int s[4] = {s00, s00 + 1, s00 + 4, s00 + 5};
    const float w[4] = {__fmul_rn(u.w0, v.w0), __fmul_rn(u.w0, v.w1),
                        __fmul_rn(u.w1, v.w0), __fmul_rn(u.w1, v.w1)};
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc = __fadd_rn(acc, fold_term(row[f * 16 + s[c]], w[c], bf16));
      o[pi * FP + f] = acc;
    }
  }
  Axis ax = axis_of(p[0], grid_res, grid_hi);
  Axis ay = axis_of(p[1], grid_res, grid_hi);
  Axis az = axis_of(p[2], grid_res, grid_hi);
  const float* row = grid +
      static_cast<size_t>((ax.brick * nb3 + ay.brick) * nb3 + az.brick) * 256;
  const int s000 = ax.slot * 16 + ay.slot * 4 + az.slot;
  int s[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    s[c] = s000 + cx * 16 + cy * 4 + cz;
    w[c] = __fmul_rn(__fmul_rn(cx ? ax.w1 : ax.w0, cy ? ay.w1 : ay.w0),
                     cz ? az.w1 : az.w0);
  }
#pragma unroll
  for (int f = 0; f < FG; ++f) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc = __fadd_rn(acc, fold_term(row[f * 64 + s[c]], w[c], bf16));
    o[3 * FP + f] = acc;
  }
}

__global__ void triplane_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    float* __restrict__ d_planes, float* __restrict__ d_grid, int M,
    int plane_res, int nb2, int grid_res, int nb3, int plane_rows,
    float plane_hi, float grid_hi) {
  int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float p[3] = {x[3 * m], x[3 * m + 1], x[3 * m + 2]};
  const int pa[3] = {0, 0, 1}, pb[3] = {1, 2, 2};
  const float* gm = g + static_cast<size_t>(m) * (3 * FP + FG);
  for (int pi = 0; pi < 3; ++pi) {
    Axis u = axis_of(p[pa[pi]], plane_res, plane_hi);
    Axis v = axis_of(p[pb[pi]], plane_res, plane_hi);
    float* row = d_planes +
        (static_cast<size_t>(pi) * plane_rows + u.brick * nb2 + v.brick) * 128;
    const int s00 = u.slot * 4 + v.slot;
    const int s[4] = {s00, s00 + 1, s00 + 4, s00 + 5};
    const float w[4] = {__fmul_rn(u.w0, v.w0), __fmul_rn(u.w0, v.w1),
                        __fmul_rn(u.w1, v.w0), __fmul_rn(u.w1, v.w1)};
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      float gf = gm[pi * FP + f];
#pragma unroll
      for (int c = 0; c < 4; ++c) atomicAdd(row + f * 16 + s[c], __fmul_rn(gf, w[c]));
    }
  }
  Axis ax = axis_of(p[0], grid_res, grid_hi);
  Axis ay = axis_of(p[1], grid_res, grid_hi);
  Axis az = axis_of(p[2], grid_res, grid_hi);
  float* row = d_grid +
      static_cast<size_t>((ax.brick * nb3 + ay.brick) * nb3 + az.brick) * 256;
  const int s000 = ax.slot * 16 + ay.slot * 4 + az.slot;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    int s = s000 + cx * 16 + cy * 4 + cz;
    float w = __fmul_rn(__fmul_rn(cx ? ax.w1 : ax.w0, cy ? ay.w1 : ay.w0),
                        cz ? az.w1 : az.w0);
#pragma unroll
    for (int f = 0; f < FG; ++f)
      atomicAdd(row + f * 64 + s, __fmul_rn(gm[3 * FP + f], w));
  }
}

}  // namespace

extern "C" int triplane_fwd(const void* x, const void* planes,
                            const void* grid, void* out, int M, int plane_res,
                            int nb2, int grid_res, int nb3, int plane_rows,
                            float plane_hi, float grid_hi, int bf16,
                            cudaStream_t stream) {
  const int threads = 256;
  triplane_fwd_kernel<<<ncn_blocks(M, threads), threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(planes),
      static_cast<const float*>(grid), static_cast<float*>(out), M, plane_res,
      nb2, grid_res, nb3, plane_rows, plane_hi, grid_hi, bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int triplane_bwd(const void* x, const void* g, void* d_planes,
                            void* d_grid, int M, int plane_res, int nb2,
                            int grid_res, int nb3, int plane_rows,
                            float plane_hi, float grid_hi,
                            cudaStream_t stream) {
  const int threads = 256;
  triplane_bwd_kernel<<<ncn_blocks(M, threads), threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(d_planes), static_cast<float*>(d_grid), M,
      plane_res, nb2, grid_res, nb3, plane_rows, plane_hi, grid_hi);
  return static_cast<int>(cudaGetLastError());
}
