// H5 / H6: brick-hash multiresolution encode, forward and table gradient.
//
// Replaces the JAX package's `brick_encode_vjp`
// (normal_clustering_nerf_tpu/models/brick_hash.py:198-243: forward
// `_brick_encode_impl` :178-195, backward `_brick_vjp_bwd` :208-240 with
// need_dx=False), and with it the Pallas row-gather probes that measured
// its gather stage on the TPU: `pallas16` (experiments/pallas_gather2.py:77,
// the 16-level gather tab[l][idx[l]]) and its one-level forms
// `pallas_gather` (experiments/pallas_gather_probe.py:44), `pallas_rows`
// (pallas_gather2.py:41), `v1_gather`, `v2_gather`, `v3_gather`
// (pallas_gather3.py:60, :80, :111).
//
// Layout (brick_hash.py:13-28): level l's table is n_bricks rows of 64
// slots x F = 2 features, lane s*2 + f, slot s = lx*16 + ly*4 + lz. A cell
// with base vertex p0 lies in brick b = p0 // 3 with local slots l0 = p0 -
// 3b and l1 = min(p0+1, res-1) - 3b per axis. The brick's row is dense,
// (b0*nb + b1)*nb + b2, when nb^3 <= n_bricks, else the tcnn XOR-prime
// hash of b, & (n_bricks - 1).
//
// Forward (H5): one thread per (sample, level), thread i = m*L + l, so the
// 16 threads of a sample write its 32 output values contiguously. It
// computes pos = x*scale + 0.5 (no FMA: the file is built with
// --fmad=false and uses __fmul_rn / __fadd_rn, since a one-ulp flip of
// floor(pos) at a stride-3 face moves a sample to another brick's copy of
// the face vertex), p0, f, the row and the per-axis weights (1-f, f), or
// (1-f)+f on one slot where l1 == l0 at the top face, as the JAX one-hot
// sum gives; then it reads only the 8 corner slots of the row (one float2
// each) and folds them in registers, corner weight wx*(wy*wz) as `_w64`
// builds it. The TPU code and the probes gather the whole 512-byte row
// per (sample, level), (16, M, 128) f32 through device memory, and fold it
// with a matmul; only 8 of its 64 slots have a non-zero weight, so this
// kernel reads 64 of the 512 bytes and writes just the (M, 32) features,
// in f32 or rounded once to bf16.
//
// Bound of the forward on the H100: memory latency. Each (sample, level)
// reads 8 random 8-byte values (in 1-4 32-byte sectors of one 512-byte
// row) from a 67 MB table, larger than the 50 MB L2, with about 40 f32
// operations between. The design keeps each access to the slots that are
// needed and keeps many independent (sample, level) pairs in flight (256
// threads a block, M*16 threads) to hide the latency.
//
// Backward (H6): the table gradient, g[f] * w_c of the 8 corner slots x 2
// features added into a zeroed (L, n_bricks, 128) f32 table
// (grad_scatter.cuh; the cotangent arrives in f32 or bf16 and is read as
// it is). The JAX version scatter-adds the whole weighted 128-value row,
// mostly zeros; a term of (+-0, +-0) (a corner of weight 0 on the merged
// top face, a sample whose cotangent pair is 0) changes no entry of a
// table that starts at +0.0 and is skipped, so the sums agree up to the
// order of the additions, which the reductions leave to the hardware.
// What bounds it: the bytes (x and g read once, the 67 MB table zeroed
// and written once: ~0.03 ms at 3.35 TB/s) and, above them, the L2's
// reductions: one a distinct (cell, corner) of a warp's samples, about 16
// M float2 at the bench batch before the merge. Why each choice: (1) a
// warp holds one level of 32 consecutive samples, not the 2 samples x 16
// levels of a thread per (sample, level), so its reductions go to one
// level's table and its lanes walk along one or two rays; (2) the
// x and g of the tile are staged in shared memory with 16-byte loads,
// since a level-major warp would read them with a stride of 2L values;
// (3) a corner's two features go as one float2 reduction (sm_90's
// atomicAdd(float2*, float2) on global memory), half the requests of two
// scalar ones; (4) the samples of a ray that fall in one cell, common at the
// coarse levels (level 0 is 216 bricks), are summed in registers first
// and reach the L2 as one reduction a corner; (5) the reductions of a
// pass are 4 cells x 8 corners, so a warp instruction touches 4 rows (1-4
// sectors each) where a lane-per-sample pass would touch 32.
#include "grad_scatter.cuh"

namespace {

constexpr int F = 2;     // features per level: a slot is one float2
constexpr unsigned P1 = 2654435761u, P2 = 805459861u;   // tcnn primes

// Geometry of one (sample, level), in the operation order of the JAX
// `_brick_geometry` / `_w64` (see the file note): the 8 corner slots and
// weights, the offset of the brick's row in the (L, n_bricks, 128) table,
// and the cell's key, its clipped base vertex p0 (which fixes the row and
// the slots).
__device__ __forceinline__ long long corners(const float* __restrict__ x,
                                             const int* __restrict__ levels,
                                             int m, int l, int n_bricks,
                                             int slot[8], float w[8],
                                             int key[3]) {
  const int4 lv = reinterpret_cast<const int4*>(levels)[l];
  const float scale = __int_as_float(lv.x);
  const int res = lv.y, nb = lv.z, dense = lv.w;
  int b[3], s0[3], s1[3];
  float w0[3], w1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float pos = __fadd_rn(__fmul_rn(x[3 * m + a], scale), 0.5f);
    float p0f = floorf(pos);
    float f = __fsub_rn(pos, p0f);
    int p0 = min(max(static_cast<int>(p0f), 0), res - 1);
    key[a] = p0;
    b[a] = p0 / 3;
    s0[a] = p0 - 3 * b[a];
    s1[a] = min(p0 + 1, res - 1) - 3 * b[a];
    float omf = __fsub_rn(1.0f, f);
    if (s1[a] == s0[a]) {     // top face: one slot takes both weights
      w0[a] = __fadd_rn(omf, f);
      w1[a] = 0.0f;
    } else {
      w0[a] = omf;
      w1[a] = f;
    }
  }
  long long row;
  if (dense) {
    row = (static_cast<long long>(b[0]) * nb + b[1]) * nb + b[2];
  } else {
    unsigned h = static_cast<unsigned>(b[0]) ^
                 (static_cast<unsigned>(b[1]) * P1) ^
                 (static_cast<unsigned>(b[2]) * P2);
    row = static_cast<long long>(h & static_cast<unsigned>(n_bricks - 1));
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    slot[c] = (cx ? s1[0] : s0[0]) * 16 + (cy ? s1[1] : s0[1]) * 4 +
              (cz ? s1[2] : s0[2]);
    w[c] = __fmul_rn(cx ? w1[0] : w0[0],
                     __fmul_rn(cy ? w1[1] : w0[1], cz ? w1[2] : w0[2]));
  }
  return (static_cast<long long>(l) * n_bricks + row) * (64 * F);
}

__global__ void brick_fwd_kernel(const float* __restrict__ table,
                                 const float* __restrict__ x,
                                 const int* __restrict__ levels,
                                 void* __restrict__ out, int M, int L,
                                 int n_bricks, int out_bf16) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(M) * L) return;
  const int m = static_cast<int>(i / L), l = static_cast<int>(i % L);
  int slot[8], key[3];
  float w[8];
  const float2* row = reinterpret_cast<const float2*>(
      table + corners(x, levels, m, l, n_bricks, slot, w, key));
  float2 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(row + slot[c]);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a0 = __fadd_rn(a0, __fmul_rn(w[c], v[c].x));
    a1 = __fadd_rn(a1, __fmul_rn(w[c], v[c].y));
  }
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat162*>(out)[i] =
        __floats2bfloat162_rn(a0, a1);
  } else {
    reinterpret_cast<float2*>(out)[i] = make_float2(a0, a1);
  }
}

// H6's geometry for grad_scatter.cuh: the corners' f32 offsets in the
// table (below 2^31: the wrapper checks the table's size).
struct BrickGeom {
  const int* levels;
  int n_bricks;
  __device__ __forceinline__ void operator()(const float* x3, int l,
                                             int key[3], int idx[8],
                                             float w[8]) const {
    int slot[8];
    const long long row = corners(x3, levels, 0, l, n_bricks, slot, w, key);
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] = static_cast<int>(row + slot[c] * F);
  }
};

}  // namespace

extern "C" int brick_fwd(const void* table, const void* x, const void* levels,
                         void* out, int M, int L, int n_bricks, int out_bf16,
                         cudaStream_t stream) {
  const int threads = 256;
  brick_fwd_kernel<<<ncn_blocks(static_cast<long long>(M) * L, threads),
                     threads, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int*>(levels), out, M, L, n_bricks, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brick_bwd(const void* g, const void* x, const void* levels,
                         void* d_table, int M, int L, int n_bricks,
                         int g_bf16, cudaStream_t stream) {
  return grad_scatter::launch(
      g, x, d_table, M, L, g_bf16,
      BrickGeom{static_cast<const int*>(levels), n_bricks}, stream);
}
