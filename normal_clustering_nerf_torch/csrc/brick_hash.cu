// H5 / H6: brick-hash multiresolution encode, forward and table gradient;
// H13: its position gradient, from a Jacobian H5 writes and a launch of
// its own contracts.
//
// Replaces the JAX package's `brick_encode_vjp`
// (normal_clustering_nerf_tpu/models/brick_hash.py:198-243: forward
// `_brick_encode_impl` :178-195, backward `_brick_vjp_bwd` :208-240; its
// need_dx branch, :225-239, is H13), and with it the Pallas row-gather
// probes that measured
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
// Forward (H5). It replaces the JAX forward `_brick_encode_impl`
// (models/brick_hash.py:178) and the Pallas probe P4 `pallas16`
// (experiments/pallas_gather2.py:77). Per level, pos = x*scale + 0.5 (no
// FMA: the file is built with --fmad=false and uses __fmul_rn /
// __fadd_rn, since a one-ulp flip of floor(pos) at a stride-3 face moves a
// sample to another brick's copy of the face vertex), p0, f, the row and
// the per-axis weights (1-f, f), or (1-f)+f on one slot where l1 == l0 at
// the top face, as the JAX one-hot sum gives; the 8 corner slots of the
// row are read and folded in registers, corner weight wx*(wy*wz) as `_w64`
// builds it, the 8 products added in corner order. The TPU code and the
// probes gather the whole 512-byte row per (sample, level), (16, M, 128)
// f32 through device memory, and fold it with a matmul; only 8 of its 64
// slots have a non-zero weight, so this kernel reads 64 of the 512 bytes
// and writes just the (M, 32) features.
//
// What bounds it on the H100: the distinct 32-byte sectors each warp's
// loads touch (counts that `chip_smoke.py`'s `warp_load_counts` models
// from each mapping of lanes to loads; no hardware counter), not the
// bytes: a (sample, level)
// needs 8 float2 slots in 4 sectors of one 512-byte row of a 67 MB table.
// The layout puts a corner's z pair (lz0, lz1) in one sector, since
// (lx*16 + ly*4)*8 bytes is a multiple of 32: the pair is one aligned
// float4 when lz0 is even, two float2 of one sector when lz0 = 1, one
// float2 on the top face. The first design ran a thread per (sample,
// level), i = m*L + l, so each of a warp's 8 float2 loads touched 32 rows
// of 16 level tables, and a ray's consecutive samples never shared a load.
// Here a block takes TILE = 32 samples (x staged once in shared memory,
// where the thread read it 16 times); a warp takes a level at a time
// (two in turn), lane = sample, so a ray's samples that fall in one brick
// row at a coarse level share its sectors in one load; each (x, y) corner
// reads its z pair as the float4 of the first slot's aligned pair, then,
// in the lanes where lz0 = 1, a float2 of the second slot from the same
// sector (`ncn_load_pairs`, shared with H7): 4 float4 and at most 4
// float2 loads a level (reading the sector as two float4 would take 8,
// each touching every lane's sector). What is left is the layout's own:
// 4 distinct sectors a (sample, level), shared between lanes only at the
// coarse levels. On the bench batch the tile's loads touch 73.9 sectors a
// sample against the thread's 120.1 counted load by load, but 51.3
// against 58.6 counted across each warp's loads, and the time followed
// the second count (~100 G sectors a second in both designs: the L1
// serves a warp's repeated sectors), so the tile gains ~8%. The products
// and sums are the first design's, in its order, so the output is bit
// for bit its own and `encode_plain`'s; the tile's 32 x 2L outputs are
// staged in shared memory and written as 16-byte words, in f32 or
// rounded once to bf16. The wrapper refuses a table that is not 16-byte
// aligned.
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
//
// Position gradient (H13, used when camera extrinsics are optimised; the
// need_dx branch of `_brick_vjp_bwd`). The first design, `brick_dx`,
// gathered the 8 corner slots of every (sample, level) a
// second time in the backward, on H5's tile and loads: at ~51 sectors a
// sample that gather cost what H5 costs (0.0636 ms against H5's 0.0667 on
// one H100 80GB HBM3, 700.00 W). Here H5, which holds the slots in
// registers, also writes the encode's Jacobian when x needs a gradient
// (`brick_fwd_jac`): J[l][f][a] = (sum in corner order of v_c[f] *
// dw_c,a) * scale, dw_c,a = d_a * (w_o1 * w_o2), the derivative of
// corner c's weight wx * (wy * wz) along a (o1 < o2 the other axes; d_a =
// +1 for the upper slot, -1 for the lower, 0 on the top face, where JAX's
// dw4 = oh1 - oh0 vanishes; the product with d_a is exact, so this is
// `brick_dx`'s factor bit for bit), 96 f32 a sample in tcnn's layout (M,
// L, 2, 3), staged in shared memory on an odd row stride and written as
// 16-byte streaming stores (J is read once, in the backward). The
// contraction is H14's body (contract.cuh, `brick_contract`): dx[a] = the
// sum over (l, f) in order of g[l][f] * J[l][f][a], a thread a dx, no
// atomics. `encode_jacobian_plain` and `contract_plain` repeat the chains,
// so J and dx are bit for bit the plain versions' (JAX dots each slot
// with the cotangent first: within 1e-5 of its largest |dx|). What bounds
// the position gradient now: J's bytes, written once and read once (50.3
// MB at the ext path's 131,040 samples, ~0.03 ms at 3.35 TB/s).
// Measured on that input (one H100 80GB HBM3, 700.00 W; bf16
// cotangent): the position gradient's cost 0.0438-0.0452 ms against
// `brick_dx`'s 0.0599-0.0609 in the same run; H5 with J 0.0791 against
// 0.0663 without, the contraction 0.0288. The contraction is a launch of
// its own, as H14's: fused into H8's scatter (the same grad_scatter.cuh
// H6 runs) it measured slower (hash_grid.cu's note), so H6 is unchanged.
// H5 without a gradient of x is compiled as before (a template flag).
#include "contract.cuh"
#include "grad_scatter.cuh"

namespace {

constexpr int F = 2;     // features per level: a slot is one float2
constexpr unsigned P1 = 2654435761u, P2 = 805459861u;   // tcnn primes

// Geometry of one (sample, level), in the operation order of the JAX
// `_brick_geometry` / `_w64` (see the file note): the 8 corner slots and
// weights, the offset of the brick's row in the (L, n_bricks, 128) table,
// and the cell's key, its clipped base vertex p0 (which fixes the row and
// the slots). With `aw`, also each axis' lower and upper weights and the
// derivative of the upper one along the axis (1, or 0 on the top face,
// where dw4 = oh1 - oh0 vanishes): aw[3a + 0, 1, 2].
__device__ __forceinline__ long long corners(const float* __restrict__ x,
                                             const int* __restrict__ levels,
                                             int m, int l, int n_bricks,
                                             int slot[8], float w[8],
                                             int key[3],
                                             float* aw = nullptr) {
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
    if (aw) {
      aw[3 * a] = w0[a];
      aw[3 * a + 1] = w1[a];
      aw[3 * a + 2] = s1[a] == s0[a] ? 0.0f : 1.0f;
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

// H5: a block takes TILE consecutive samples (x staged once in shared
// memory), warp w levels w, w + warps, ...; lane = sample. The tile's
// outputs are staged in shared memory and written as 16-byte words.
// 8 warps of 2 levels each: twice the blocks an SM of 16 warps of one
// level, so more blocks' staging barriers overlap; 16 warps of one level,
// 4 warps of 4 levels, two levels' loads issued together, x read without
// staging, 8 float2 loads a level, or a sector read as two float4 lost
// to it on the card. With JAC it also writes the Jacobian (the file
// note), its rows staged on an odd stride.
constexpr int TILE = 32;
constexpr int FWD_WARPS = 8;

template <bool BF16, bool JAC>
__global__ void __launch_bounds__(TILE * FWD_WARPS)
    brick_fwd_kernel(const float* __restrict__ table,
                     const float* __restrict__ x,
                     const int* __restrict__ levels, void* __restrict__ out,
                     float* __restrict__ jac, int M, int L, int n_bricks) {
  extern __shared__ float4 smem[];
  const int width = F * L, ostride = width + 2;   // float2 stores: no
  float* xs = reinterpret_cast<float*>(smem);     // bank conflicts
  float* os = xs + TILE * 3;
  const int jwidth = 3 * width, jstride = jwidth + 1;   // JAC: odd stride
  float* js = os + TILE * ostride;
  const int lane = threadIdx.x, warps = blockDim.y;
  const int tid = threadIdx.y * TILE + lane, nt = warps * TILE;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  __syncthreads();
  const float* x3 = xs + 3 * min(lane, rows - 1);
  for (int l = threadIdx.y; l < L; l += warps) {
    int slot[8], key[3];
    float w[8], aw[9];
    const float* row = table + corners(x3, levels, 0, l, n_bricks, slot, w,
                                       key, JAC ? aw : nullptr);
    float2 v[8];
    ncn_load_pairs<1>(row, slot, v);   // z pairs: slots 2k, 2k + 1
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      a0 = __fadd_rn(a0, __fmul_rn(w[c], v[c].x));
      a1 = __fadd_rn(a1, __fmul_rn(w[c], v[c].y));
    }
    *reinterpret_cast<float2*>(os + lane * ostride + F * l) =
        make_float2(a0, a1);
    if constexpr (JAC) {
      // w_o1 * w_o2 of a corner's slots on the other axes o1 < o2 of a,
      // by its bits there; d_a (0 or 1) times the sign of its bit on a
      // then scales it exactly
      float pw[3][4];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int o1 = a == 0 ? 1 : 0, o2 = a == 2 ? 1 : 2;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          pw[a][b] = __fmul_rn(aw[3 * o1 + (b >> 1)], aw[3 * o2 + (b & 1)]);
      }
      float j0[3] = {0.0f, 0.0f, 0.0f}, j1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cs[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int o1 = a == 0 ? 1 : 0, o2 = a == 2 ? 1 : 2;
          const float d = cs[a] ? aw[3 * a + 2] : -aw[3 * a + 2];
          const float dw = __fmul_rn(d, pw[a][2 * cs[o1] + cs[o2]]);
          j0[a] = __fadd_rn(j0[a], __fmul_rn(v[c].x, dw));
          j1[a] = __fadd_rn(j1[a], __fmul_rn(v[c].y, dw));
        }
      }
      const float scale = __int_as_float(levels[4 * l]);
      float* jr = js + lane * jstride + 3 * F * l;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        jr[a] = __fmul_rn(j0[a], scale);
        jr[3 + a] = __fmul_rn(j1[a], scale);
      }
    }
  }
  __syncthreads();
  ncn_unstage<BF16>(os, rows * width, width, ostride,
                    static_cast<char*>(out) + (BF16 ? 2LL : 4LL) * width * m0,
                    tid, nt);
  if constexpr (JAC)
    ncn_unstage<false, true>(js, rows * jwidth, jwidth, jstride,
                             jac + static_cast<long long>(jwidth) * m0, tid,
                             nt);
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

template <bool JAC>
int launch_fwd(const void* table, const void* x, const void* levels,
               void* out, void* jac, int M, int L, int n_bricks,
               int out_bf16, cudaStream_t stream) {
  const int warps = L < FWD_WARPS ? L : FWD_WARPS;
  const size_t bytes =
      sizeof(float) * TILE * (3 + F * L + 2 + (JAC ? 3 * F * L + 1 : 0));
  auto kernel = out_bf16 ? brick_fwd_kernel<true, JAC>
                         : brick_fwd_kernel<false, JAC>;
  if (bytes > 48 * 1024) {   // the opt-in holds per device: set it each time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, warps), bytes, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int*>(levels), out, static_cast<float*>(jac), M, L,
      n_bricks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brick_fwd(const void* table, const void* x, const void* levels,
                         void* out, int M, int L, int n_bricks, int out_bf16,
                         cudaStream_t stream) {
  return launch_fwd<false>(table, x, levels, out, nullptr, M, L, n_bricks,
                           out_bf16, stream);
}

// H5 with the Jacobian: jac (M, L, 2, 3) f32, 16-byte aligned.
extern "C" int brick_fwd_jac(const void* table, const void* x,
                             const void* levels, void* out, void* jac, int M,
                             int L, int n_bricks, int out_bf16,
                             cudaStream_t stream) {
  return launch_fwd<true>(table, x, levels, out, jac, M, L, n_bricks,
                          out_bf16, stream);
}

extern "C" int brick_bwd(const void* g, const void* x, const void* levels,
                         void* d_table, int M, int L, int n_bricks,
                         int g_bf16, cudaStream_t stream) {
  return grad_scatter::launch(
      g, x, d_table, M, L, g_bf16,
      BrickGeom{static_cast<const int*>(levels), n_bricks}, stream);
}

// H13's contraction of H5's Jacobian jac (M, L, 2, 3) f32 with the
// cotangent g (M, 2L) into dx (M, 3) f32: H14's body (contract.cuh).
extern "C" int brick_contract(const void* g, const void* jac, void* dx, int M,
                              int L, int g_bf16, cudaStream_t stream) {
  return contract::launch(g, jac, dx, M, L, g_bf16, stream);
}
