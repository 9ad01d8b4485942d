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
// Backward: the table gradients, g[f] * w_c added into zeroed f32 tables
// (the JAX version scatter-adds in bf16 under bf16 compute; fp32 is exact
// up to summation order). The cotangent arrives in f32 or bf16 (the
// compute dtype) and is read as it is: no cast launch.
//
// Bound on the H100: memory latency. The forward makes random 4-byte
// reads into 56 MB of tables (bigger than the 50 MB L2), ~50 32-byte
// sectors a sample with no reuse inside a thread: it keeps each access to
// the slots needed and many samples in flight (one thread each, 256 a
// block). The backward's floor is the bytes (x and g read once, 56 MB
// zeroed and written once: ~0.02 ms); above it, the L2's reductions. A
// thread per sample made 128 scalar reductions a sample and sent each
// warp instruction's 32 to 32 random rows. The design is the hash-grid
// scatter's (grad_scatter.cuh), with a table in place of a level:
//   - a block takes TILE = 32 consecutive samples and stages their x and
//     cotangent in shared memory with 16-byte loads (`ncn_stage`, which
//     the hash-grid scatter shares); warp t takes table t (planes xy, xz,
//     yz, then grid3d);
//   - lane = sample finds its cell and corner weights; a sample whose
//     cotangent slice is all zero is skipped; a live lane whose cell is
//     the live lane before's joins its run (a ray's samples are
//     consecutive, and a line enters a cell once);
//   - then a cell a warp instruction, lane = term: a plane cell is 8
//     features x 4 corners, a grid3d cell 4 x 8, 32 terms in one row
//     (512 bytes or 1 KB); each lane sums its term over the run from
//     shared memory (the merge), and corners c, c+1 (adjacent slots) go
//     as one float2 reduction when the cell's lowest slot is even (8-byte
//     aligned), else as two scalar ones; a term of +-0 is skipped (it
//     changes no entry of a table that starts at +0.0).
// Past the staging it does not reuse grad_scatter.cuh: there a lane keeps
// one (sample, level)'s 8 float2 terms and runs are merged by segmented
// shuffles; here a (sample, table) has 32 terms, so the terms live one a
// lane and a run is summed in that layout, which needs neither shuffles
// nor 32 values a lane, and less code than widening the header's tile.
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

// The backward's tile (see the file note): TILE samples x 4 tables, a
// warp a table. A sample's cotangent row is GW values, staged as f32 in
// rows padded to an odd stride (no bank conflicts between lanes).
constexpr int TILE = 32;
constexpr int TABLES = 4;                 // 3 planes, then grid3d
constexpr int GW = 3 * FP + FG;           // 28
constexpr int GSTRIDE = GW + 1;
constexpr int WSTRIDE = 9;                // 8 corner weights, 1 pad

template <bool BF16>
__global__ void __launch_bounds__(TILE * TABLES) triplane_bwd_kernel(
    const float* __restrict__ x, const void* __restrict__ g,
    float* __restrict__ d_planes, float* __restrict__ d_grid, int M,
    int plane_res, int nb2, int grid_res, int nb3, int plane_rows,
    float plane_hi, float grid_hi) {
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

  // 1. lane = sample: its cell in table t (the offset of the lowest corner
  //    of feature 0, which fixes the cell), its corner weights, and
  //    whether its cotangent slice has a non-zero value
  const bool plane = t < 3;
  const int C = plane ? 4 : 8;             // corners a cell
  const int col = plane ? t * FP : 3 * FP; // the slice's first column
  float* w = ws[t] + lane * WSTRIDE;
  int key = -1;
  bool live = false;
  if (lane < rows) {
    const float* p = xs + 3 * lane;
    const float* gr = gs + lane * GSTRIDE + col;
    if (plane) {
      // plane t spans axes (0, 1), (0, 2), (1, 2)
      const Axis u = axis_of(t == 2 ? p[1] : p[0], plane_res, plane_hi);
      const Axis v = axis_of(t == 0 ? p[1] : p[2], plane_res, plane_hi);
      key = (t * plane_rows + u.brick * nb2 + v.brick) * 128 + u.slot * 4 +
            v.slot;
      w[0] = __fmul_rn(u.w0, v.w0);
      w[1] = __fmul_rn(u.w0, v.w1);
      w[2] = __fmul_rn(u.w1, v.w0);
      w[3] = __fmul_rn(u.w1, v.w1);
#pragma unroll
      for (int f = 0; f < FP; ++f) live |= gr[f] != 0.0f;
    } else {
      const Axis ax = axis_of(p[0], grid_res, grid_hi);
      const Axis ay = axis_of(p[1], grid_res, grid_hi);
      const Axis az = axis_of(p[2], grid_res, grid_hi);
      key = ((ax.brick * nb3 + ay.brick) * nb3 + az.brick) * 256 +
            ax.slot * 16 + ay.slot * 4 + az.slot;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        w[c] = __fmul_rn(__fmul_rn((c >> 2) & 1 ? ax.w1 : ax.w0,
                                   (c >> 1) & 1 ? ay.w1 : ay.w0),
                         c & 1 ? az.w1 : az.w0);
#pragma unroll
      for (int f = 0; f < FG; ++f) live |= gr[f] != 0.0f;
    }
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
  const int off = plane ? f * 16 + (c >> 1) * 4 + (c & 1)
                        : f * 64 + (c >> 2) * 16 + ((c >> 1) & 1) * 4 + (c & 1);
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
                            float plane_hi, float grid_hi, int g_bf16,
                            cudaStream_t stream) {
  auto kernel = g_bf16 ? triplane_bwd_kernel<true> : triplane_bwd_kernel<false>;
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, TABLES), 0, stream>>>(
      static_cast<const float*>(x), g, static_cast<float*>(d_planes),
      static_cast<float*>(d_grid), M, plane_res, nb2, grid_res, nb3,
      plane_rows, plane_hi, grid_hi);
  return static_cast<int>(cudaGetLastError());
}
