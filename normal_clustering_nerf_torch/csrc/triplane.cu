// H2: triplane + coarse-grid encode, forward and backward; H12: its
// position gradient.
//
// Replaces the JAX package's `triplane_encode_vjp`
// (normal_clustering_nerf_tpu/models/triplane.py:196-253: `_encode_impl`
// forward, `_tp_bwd` backward; its need_dx branch, :229-250, is H12). No
// Pallas kernel: the
// repo's Pallas probes (experiments/pallas_gather*.py) measured the brick
// encode's gather and belong to H5.
//
// Layout (feature-major "v2" rows, triplane.py:41-46): each of the three
// planes (xy, xz, yz) is a table of nb2^2 rows of 128 values, row = one
// 4x4-vertex brick, lane f*16 + s for feature f < 8 and slot s = lu*4 + lv;
// the coarse grid is nb3^3 rows of 256 values, lane f*64 + s with
// s = lx*16 + ly*4 + lz. A position needs 4 slots of one row per plane
// (bilinear) and 8 slots of one grid row (trilinear): 4*8*3 + 8*4 = 128
// values a sample. The geometry is the JAX one (clip(x*(R-1), 0,
// R-2+1e-6), floor, 1-f / f, products in the same order), shared by both
// kernels (`cell_of`). With bf16 rows (bf16 compute), each table value and
// weight is rounded to bf16 and their product rounded to bf16 before the
// f32 sum, as the JAX fold does after casting the table; the f32 master
// tables are read directly, so no bf16 copy of the tables is made.
//
// Both kernels share one tile: a block takes TILE = 32 consecutive
// samples and stages their x in shared memory (`ncn_stage`); warp t takes
// table t (planes xy, xz, yz, then grid3d) and lane = sample finds the
// sample's cell (the offset of its lowest corner of feature 0) and its
// corner weights. A cell is then 32 terms of one row: 8 features x 4
// corners of a plane row (512 bytes), 4 x 8 of a grid3d row (1 KB).
//
// Forward. What bounds it on the H100 (counts that `chip_smoke.py`'s
// `warp_load_counts` models from each design's mapping of lanes to
// loads, on the bench batch of 131,040 samples; no hardware counter): the
// distinct 32-byte sectors that each warp load touches: the time follows
// them, at ~150 G sectors a second in both designs, and not the 128-byte
// lines. A thread per sample made
// 128 scalar loads a sample, each warp load sending its 32 lanes to ~32
// unrelated rows: 121.7 sectors (116.6 lines) a sample, and a second
// launch cast the f32 output to bf16. Here lane = term: one warp load
// reads one (sample, table)'s 32 values from one row, a feature's 4 (8)
// corners in 1-2 (3-4) sectors: 42.7 sectors (17.3 lines) a sample. A
// feature's terms are summed into its first lane by shuffles in corner
// order, from 0, as the thread did (`fold_cells`), so the f32 sums are
// bit for bit the thread's; 8 samples' loads go out before their sums.
// The tile's 32 x 28 outputs are staged in shared memory and written as
// 16-byte words in the compute dtype (f32, or rounded once to bf16: no
// cast launch).
//
// Backward: the table gradients, g[f] * w_c added into zeroed f32 tables
// (the JAX version scatter-adds in bf16 under bf16 compute; fp32 is exact
// up to summation order). The cotangent arrives in f32 or bf16 (the
// compute dtype) and is read as it is: no cast launch. Its floor is the
// bytes (x and g read once, 56 MB zeroed and written once: ~0.02 ms);
// above it, the L2's reductions. A thread per sample made 128 scalar
// reductions a sample and sent each warp instruction's 32 to 32 random
// rows. The design is the hash-grid scatter's (grad_scatter.cuh), with a
// table in place of a level: the tile also stages the cotangent; a sample
// whose cotangent slice is all zero is skipped; a live lane whose cell is
// the live lane before's joins its run (a ray's samples are consecutive,
// and a line enters a cell once); then a cell a warp instruction, lane =
// term: each lane sums its term over the run from shared memory (the
// merge), and corners c, c+1 (adjacent slots) go as one float2 reduction
// when the cell's lowest slot is even (8-byte aligned), else as two
// scalar ones; a term of +-0 is skipped (it changes no entry of a table
// that starts at +0.0). Past the staging it does not reuse
// grad_scatter.cuh: there a lane keeps one (sample, level)'s 8 float2
// terms and runs are merged by segmented shuffles; here a (sample, table)
// has 32 terms, so the terms live one a lane and a run is summed in that
// layout, which needs neither shuffles nor 32 values a lane.
//
// Position gradient (H12, the need_dx branch of `_tp_bwd`, used when
// camera extrinsics are optimised): dx[a] of each sample, the dot of each
// corner's f32 table row with the cotangent times the derivative of the
// corner's weight along a (+-the other axis' weight), times R - 1; the
// clip of the position gets no derivative, as in JAX. It reads what the
// forward reads (the f32 rows: 128 values a sample) and the cotangent,
// and writes 3 values a sample: its floor is the bytes, ~0.04 ms at the
// bench batch. The design is the forward's tile (a warp a table, lane =
// term, one warp load a (sample, table)), and the sums are chains in a
// fixed order, feature then corner then table, which `encode_dx_plain`
// repeats, so the result is bit for bit the plain version's (no FMA
// either side) and each dx is written by one thread: no atomics.
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

// The tiles of both kernels (see the file note): TILE samples x 4 tables,
// a warp a table. A sample's cotangent (or output) row is GW values; the
// backward stages its cotangent as f32 in rows padded to an odd stride (no
// bank conflicts between lanes).
constexpr int TILE = 32;
constexpr int TABLES = 4;                 // 3 planes, then grid3d
constexpr int GW = 3 * FP + FG;           // 28
constexpr int GSTRIDE = GW + 1;
constexpr int WSTRIDE = 9;                // 8 corner weights, 1 pad

struct Geo {
  int plane_res, nb2, grid_res, nb3, plane_rows;
  float plane_hi, grid_hi;
};

// The cell of a sample (p: its 3 coordinates) in table t: the offset of the
// lowest corner of feature 0 in the planes' (t < 3) or grid3d's array,
// which fixes the cell, and its 4 (8) corner weights into w, in the
// order of the JAX geometry; with `aw`, also the axes' lower and upper
// weights (u0, u1, v0, v1 of a plane; x0, x1, y0, y1, z0, z1 of grid3d).
__device__ __forceinline__ int cell_of(int t, const float* p, const Geo& g,
                                       float* w, float* aw = nullptr) {
  if (t < 3) {
    // plane t spans axes (0, 1), (0, 2), (1, 2)
    const Axis u = axis_of(t == 2 ? p[1] : p[0], g.plane_res, g.plane_hi);
    const Axis v = axis_of(t == 0 ? p[1] : p[2], g.plane_res, g.plane_hi);
    if (aw) {
      aw[0] = u.w0; aw[1] = u.w1; aw[2] = v.w0; aw[3] = v.w1;
    }
    w[0] = __fmul_rn(u.w0, v.w0);
    w[1] = __fmul_rn(u.w0, v.w1);
    w[2] = __fmul_rn(u.w1, v.w0);
    w[3] = __fmul_rn(u.w1, v.w1);
    return (t * g.plane_rows + u.brick * g.nb2 + v.brick) * 128 +
           u.slot * 4 + v.slot;
  }
  const Axis ax = axis_of(p[0], g.grid_res, g.grid_hi);
  const Axis ay = axis_of(p[1], g.grid_res, g.grid_hi);
  const Axis az = axis_of(p[2], g.grid_res, g.grid_hi);
  if (aw) {
    aw[0] = ax.w0; aw[1] = ax.w1; aw[2] = ay.w0; aw[3] = ay.w1;
    aw[4] = az.w0; aw[5] = az.w1;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    w[c] = __fmul_rn(__fmul_rn((c >> 2) & 1 ? ax.w1 : ax.w0,
                               (c >> 1) & 1 ? ay.w1 : ay.w0),
                     c & 1 ? az.w1 : az.w0);
  return ((ax.brick * g.nb3 + ay.brick) * g.nb3 + az.brick) * 256 +
         ax.slot * 16 + ay.slot * 4 + az.slot;
}

// Lane = term (feature f, corner c) of a cell with C corners: its offset
// from the cell's key (corners c, c + 1 are adjacent slots).
template <int C>
__device__ __forceinline__ int term_offset(int lane) {
  const int f = lane / C, c = lane % C;
  return C == 4 ? f * 16 + (c >> 1) * 4 + (c & 1)
                : f * 64 + (c >> 2) * 16 + ((c >> 1) & 1) * 4 + (c & 1);
}

// The forward's pass over the tile for one table (C = 4: a plane, 8:
// grid3d): sample i's cell is one warp load of its 32 terms; a feature's C
// terms are summed into its first lane by shuffles in corner order, from
// 0 as the reference folds them, and written to the tile's output row.
// UNROLL samples' loads go out before their sums.
constexpr int UNROLL = 8;

template <int C, bool BF16>
__device__ __forceinline__ void fold_cells(const float* __restrict__ table,
                                           int key, const float* w, int rows,
                                           float* orow) {
  const int lane = threadIdx.x, c = lane % C, off = term_offset<C>(lane);
  for (int i0 = 0; i0 < rows; i0 += UNROLL) {   // warp-uniform
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = min(i0 + u, rows - 1);
      v[u] = __ldg(table + __shfl_sync(FULL, key, i) + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = min(i0 + u, rows - 1);
      const float term = fold_term(v[u], w[i * WSTRIDE + c], BF16);
      float s = __fadd_rn(0.0f, term);
#pragma unroll
      for (int j = 1; j < C; ++j)
        s = __fadd_rn(s, __shfl_down_sync(FULL, term, j));
      if (c == 0 && i0 + u < rows) orow[(i0 + u) * GW + lane / C] = s;
    }
  }
}

// H2 forward: a block takes TILE samples (x staged once), warp t table t.
// Lane = sample finds its cell and weights; then lane = term
// (`fold_cells`); the tile's GW-value output rows are written from shared
// memory as 16-byte words, in f32 or rounded once to bf16.
template <bool BF16ROWS, bool BF16OUT>
__global__ void __launch_bounds__(TILE * TABLES) triplane_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ planes,
    const float* __restrict__ grid, void* __restrict__ out, int M, Geo geo) {
  __shared__ float xs[TILE * 3];
  __shared__ float ws[TABLES][TILE * WSTRIDE];
  __shared__ float os[TILE * GW];
  const int lane = threadIdx.x, t = threadIdx.y;
  const int tid = t * TILE + lane, nt = TILE * TABLES;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  __syncthreads();
  const int key = cell_of(t, xs + 3 * min(lane, rows - 1), geo,
                          ws[t] + lane * WSTRIDE);
  __syncwarp();   // the weights are read across lanes below
  if (t < 3)
    fold_cells<4, BF16ROWS>(planes, key, ws[t], rows, os + t * FP);
  else
    fold_cells<8, BF16ROWS>(grid, key, ws[t], rows, os + 3 * FP);
  __syncthreads();
  char* dst = static_cast<char*>(out) + (BF16OUT ? 2LL : 4LL) * GW * m0;
  ncn_unstage<BF16OUT>(os, rows * GW, GW, GW, dst, tid, nt);
}

template <bool BF16>
__global__ void __launch_bounds__(TILE * TABLES) triplane_bwd_kernel(
    const float* __restrict__ x, const void* __restrict__ g,
    float* __restrict__ d_planes, float* __restrict__ d_grid, int M,
    Geo geo) {
  __shared__ float xs[TILE * 3];
  __shared__ float gs[TILE * GSTRIDE];
  __shared__ float ws[TABLES][TILE * WSTRIDE];
  const int lane = threadIdx.x, t = threadIdx.y;
  const int tid = t * TILE + lane, nt = TILE * TABLES;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  ncn_stage<BF16>(static_cast<const char*>(g) + (BF16 ? 2LL : 4LL) * GW * m0,
                  rows * GW, GW, GSTRIDE, gs, tid, nt);
  __syncthreads();

  // 1. lane = sample: its cell in table t (`cell_of`), its corner weights,
  //    and whether its cotangent slice has a non-zero value
  const bool plane = t < 3;
  const int C = plane ? 4 : 8;             // corners a cell
  const int col = plane ? t * FP : 3 * FP; // the slice's first column
  int key = -1;
  bool live = false;
  if (lane < rows) {
    key = cell_of(t, xs + 3 * lane, geo, ws[t] + lane * WSTRIDE);
    const float* gr = gs + lane * GSTRIDE + col;
    for (int f = 0; f < (plane ? FP : FG); ++f) live |= gr[f] != 0.0f;
  }
  // 2. runs: a live lane whose cell is the live lane before's joins its
  //    run (a ray's samples are consecutive lanes and a line enters a
  //    cell once); the first lane of each run is its head
  const int prev_key = __shfl_up_sync(FULL, key, 1);
  const bool prev_live = __shfl_up_sync(FULL, static_cast<int>(live), 1);
  const bool joins = lane > 0 && live && prev_live && prev_key == key;
  const unsigned J = __ballot_sync(FULL, joins);
  unsigned heads = __ballot_sync(FULL, live && !joins);
  __syncwarp();   // the weights are read across lanes below

  // 3. a cell a pass: lane = term (feature f, corner c), its sum over the
  //    run, added at key + f*(feature stride) + corner offset; corners c
  //    and c + 1 are adjacent, so for an even key they go as one float2
  const int f = lane / C, c = lane % C;
  const int off = plane ? term_offset<4>(lane) : term_offset<8>(lane);
  float* table = plane ? d_planes : d_grid;
  const float* gcol = gs + col + f;
  while (heads) {   // warp-uniform
    const int h = __ffs(heads) - 1;
    heads &= heads - 1;
    const unsigned rest = h == 31 ? 0u : ~J & (FULL << (h + 1));
    const int end = rest ? __ffs(rest) - 1 : 32;
    float s = 0.0f;
    for (int i = h; i < end; ++i)
      s = __fadd_rn(s, __fmul_rn(gcol[i * GSTRIDE], ws[t][i * WSTRIDE + c]));
    const int k = __shfl_sync(FULL, key, h);
    const float s_next = __shfl_down_sync(FULL, s, 1);
    float* dst = table + k + off;
    if ((k & 1) == 0) {
      // skip a (+-0, +-0) pair: it changes no entry of a +0.0 table
      if ((c & 1) == 0 && (s != 0.0f || s_next != 0.0f))
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(s, s_next));
    } else if (s != 0.0f) {
      atomicAdd(dst, s);
    }
  }
}

// H12: the position gradient. Lane = sample finds its cell (`cell_of`)
// and its axes' weights; then, a sample at a time, lane = term (feature f,
// corner c) reads the term's f32 table value, as the forward does, and
// multiplies it by the sample's cotangent g[f]; the corner's dot gd_c =
// sum_f value * g[f] is chained through the lanes c, c + C, ... in feature
// order into lane c, which multiplies it by the corner's weight
// derivatives along the table's 2 (3) axes; each axis' C terms are chained
// into lane 0 in corner order, and the sum times (R - 1) goes to shared
// memory. A thread per (sample, axis) then adds the tables' terms in the
// JAX order and writes dx: every value is one thread's, no atomics.
constexpr int AWS = 7;   // a sample's 6 axis weights, 1 pad
constexpr int DXS = 4;   // a table's 2 (3) axis terms a sample, 1 pad

template <int C>
__device__ __forceinline__ void dx_cells(const float* __restrict__ table,
                                         int key, const float* aw,
                                         const float* gcol, int rows,
                                         float scale, float* dxs) {
  constexpr int NA = C == 4 ? 2 : 3;    // axes of the table
  const int lane = threadIdx.x, c = lane % C, off = term_offset<C>(lane);
  const int f = lane / C;
  for (int i = 0; i < rows; ++i) {      // warp-uniform
    const float v = __ldg(table + __shfl_sync(FULL, key, i) + off);
    const float prod = __fmul_rn(v, gcol[i * GSTRIDE + f]);
    float gd = __fadd_rn(0.0f, prod);
#pragma unroll
    for (int j = 1; j < 32 / C; ++j)
      gd = __fadd_rn(gd, __shfl_down_sync(FULL, prod, j * C));
    // lane c < C: the derivatives of corner c's weight along each axis
    const float* a = aw + i * AWS;
    float term[NA];
    if constexpr (C == 4) {
      const int cu = c >> 1, cv = c & 1;
      const float wu = cu ? a[1] : a[0], wv = cv ? a[3] : a[2];
      term[0] = __fmul_rn(gd, cu ? wv : -wv);
      term[1] = __fmul_rn(gd, cv ? wu : -wu);
    } else {
      const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      const float wx = cx ? a[1] : a[0], wy = cy ? a[3] : a[2];
      const float wz = cz ? a[5] : a[4];
      const float yz = __fmul_rn(wy, wz), xz = __fmul_rn(wx, wz);
      const float xy = __fmul_rn(wx, wy);
      term[0] = __fmul_rn(gd, cx ? yz : -yz);
      term[1] = __fmul_rn(gd, cy ? xz : -xz);
      term[2] = __fmul_rn(gd, cz ? xy : -xy);
    }
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      float s = __fadd_rn(0.0f, term[k]);
#pragma unroll
      for (int j = 1; j < C; ++j)
        s = __fadd_rn(s, __shfl_down_sync(FULL, term[k], j));
      if (lane == 0) dxs[i * DXS + k] = __fmul_rn(s, scale);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(TILE * TABLES) triplane_dx_kernel(
    const float* __restrict__ x, const float* __restrict__ planes,
    const float* __restrict__ grid, const void* __restrict__ g,
    float* __restrict__ dx, int M, Geo geo) {
  __shared__ float xs[TILE * 3];
  __shared__ float gs[TILE * GSTRIDE];
  __shared__ float ws[TABLES][TILE * WSTRIDE];
  __shared__ float aws[TABLES][TILE * AWS];
  __shared__ float dxs[TABLES][TILE * DXS];
  const int lane = threadIdx.x, t = threadIdx.y;
  const int tid = t * TILE + lane, nt = TILE * TABLES;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  ncn_stage<BF16>(static_cast<const char*>(g) + (BF16 ? 2LL : 4LL) * GW * m0,
                  rows * GW, GW, GSTRIDE, gs, tid, nt);
  __syncthreads();
  const int key = cell_of(t, xs + 3 * min(lane, rows - 1), geo,
                          ws[t] + lane * WSTRIDE, aws[t] + lane * AWS);
  __syncwarp();   // the axis weights are read across lanes below
  if (t < 3)
    dx_cells<4>(planes, key, aws[t], gs + t * FP, rows,
                static_cast<float>(geo.plane_res - 1), dxs[t]);
  else
    dx_cells<8>(grid, key, aws[t], gs + 3 * FP, rows,
                static_cast<float>(geo.grid_res - 1), dxs[t]);
  __syncthreads();
  // the JAX order (triplane.py:229-250): the planes xy, xz, yz add their
  // u and v terms to their axes, then grid3d its x, y, z terms
  for (int e = tid; e < rows * 3; e += nt) {
    const int i = e / 3, a = e % 3;
    const float* p0 = dxs[0] + i * DXS;
    const float* p1 = dxs[1] + i * DXS;
    const float* p2 = dxs[2] + i * DXS;
    const float first = a == 0 ? p0[0] : a == 1 ? p0[1] : p1[1];
    const float second = a == 0 ? p1[0] : a == 1 ? p2[0] : p2[1];
    dx[3LL * m0 + e] = __fadd_rn(__fadd_rn(first, second),
                                 dxs[3][i * DXS + a]);
  }
}

}  // namespace

extern "C" int triplane_fwd(const void* x, const void* planes,
                            const void* grid, void* out, int M, int plane_res,
                            int nb2, int grid_res, int nb3, int plane_rows,
                            float plane_hi, float grid_hi, int bf16,
                            int out_bf16, cudaStream_t stream) {
  const Geo geo{plane_res, nb2, grid_res, nb3, plane_rows, plane_hi, grid_hi};
  auto kernel = bf16 ? (out_bf16 ? triplane_fwd_kernel<true, true>
                                 : triplane_fwd_kernel<true, false>)
                     : (out_bf16 ? triplane_fwd_kernel<false, true>
                                 : triplane_fwd_kernel<false, false>);
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, TABLES), 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(planes),
      static_cast<const float*>(grid), out, M, geo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int triplane_bwd(const void* x, const void* g, void* d_planes,
                            void* d_grid, int M, int plane_res, int nb2,
                            int grid_res, int nb3, int plane_rows,
                            float plane_hi, float grid_hi, int g_bf16,
                            cudaStream_t stream) {
  const Geo geo{plane_res, nb2, grid_res, nb3, plane_rows, plane_hi, grid_hi};
  auto kernel = g_bf16 ? triplane_bwd_kernel<true> : triplane_bwd_kernel<false>;
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, TABLES), 0, stream>>>(
      static_cast<const float*>(x), g, static_cast<float*>(d_planes),
      static_cast<float*>(d_grid), M, geo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int triplane_dx(const void* x, const void* planes,
                           const void* grid, const void* g, void* dx, int M,
                           int plane_res, int nb2, int grid_res, int nb3,
                           int plane_rows, float plane_hi, float grid_hi,
                           int g_bf16, cudaStream_t stream) {
  const Geo geo{plane_res, nb2, grid_res, nb3, plane_rows, plane_hi, grid_hi};
  auto kernel = g_bf16 ? triplane_dx_kernel<true> : triplane_dx_kernel<false>;
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, TABLES), 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(planes),
      static_cast<const float*>(grid), g, static_cast<float*>(dx), M, geo);
  return static_cast<int>(cudaGetLastError());
}
