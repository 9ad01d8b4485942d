// H7 / H8: multiresolution hash-grid encode (the tcnn layout), forward and
// table gradient; H14: its position gradient.
//
// Replaces the JAX package's `hash_encode_vjp`
// (normal_clustering_nerf_tpu/models/hash_encoding.py:133-248: forward
// `_hash_encode_fwd_impl` :123-130, backward `_hash_vjp_bwd` :199-245 with
// the direct scatter; its need_dx branch, :227-243, is H14). No Pallas
// kernel: the repo's
// Pallas probes (experiments/pallas_gather*.py) measured the brick
// encode's gather and belong to H5.
//
// Layout: one (total_rows, 2) f32 table; level l's rows start at
// level_offsets[l], a multiple of 8. Per level, pos = x*scale + 0.5,
// p0 = floor(pos), w = pos - p0; corner c = p0 + (cx, cy, cz), each axis
// clipped to [0, res-1]; its row is (ix*res + iy)*res + iz when res^3
// fits in the level's table, else the tcnn XOR-prime hash with uint32
// wraparound, & (T-1); its weight (wx*wy)*wz from the unclipped fraction
// (hash_encoding.py:99-120). pos is computed without FMA (--fmad=false,
// __fmul_rn / __fadd_rn) so that floor(pos) and the weights are the
// reference's.
//
// Forward (H7). What bounds it on the H100 (counts that `chip_smoke.py`'s
// `warp_load_counts` models from each design's mapping of lanes to
// loads, on the bench batch of 131,040 samples; no hardware counter): the
// distinct 32-byte sectors that each warp load touches: the time follows
// them (at ~120-140 G sectors a second), not the 128-byte lines.
// Corner rows are random 8-byte rows of a 45.7 MB table (fine levels hash
// the corners to unrelated rows). A thread per (sample, level), i = m*L
// + l, sent each of its 8 float2 loads to 32 rows of 16 levels: 119.7
// sectors a sample. Here a block takes TILE = 32 samples (x staged once
// in shared memory, where the thread read it 16 times); a warp takes a
// level, lane = sample, so a ray's samples that share a coarse cell share
// its sectors in one load; and two corners whose rows lie in one aligned
// row pair go as one float4 load: the z neighbours r, r + 1 at a dense
// level when r is even, the x neighbours at a hashed level when ix is
// even (x's prime is 1, so the rows are h and h ^ 1). 82.5 sectors a
// sample are left: at a hashed level the other neighbours are unrelated
// rows, and a pair that straddles a float4 still costs two loads of one
// sector. The 8 corners' products and sums keep the thread's order, so
// the output is bit for bit the thread's; the tile's 32 x 2L outputs are
// staged in shared memory and written as 16-byte words, in f32 or rounded
// once to bf16. 16 warps a block at 64 registers (the pair loader,
// `ncn_load_pairs`, is shared with H5): capping the registers for more
// blocks an SM spills and loses.
//
// Backward (H8): the table gradient, g[f] * w_c added to the 8 corner
// rows x 2 features of a zeroed (total_rows, 2) f32 table, as tcnn does,
// through the scatter of grad_scatter.cuh (the design of H6, whose note in
// brick_hash.cu gives the reasons; the cotangent arrives in f32 or bf16).
// A term of (+-0, +-0) is skipped, which is exact on a table that starts
// at +0.0; the sums agree with the JAX scatter-add up to the order of the
// additions. What bounds it: the bytes (x and g read once, the 45.7 MB
// table zeroed and written once: ~0.02 ms at 3.35 TB/s) and, above them,
// the L2's reductions, one a distinct (cell, corner) of a warp's samples.
// Here a cell's 8 corners are 8 rows of 8 bytes: at a dense level the z
// neighbours are adjacent (4-8 sectors a cell); at a hashed level ix has
// the prime 1, so an x pair from an even ix differs in the hash's last
// bit and shares a sector. The run-dedupe scatter of the JAX package
// (hash_encoding.py:154-196, off by default) computes the same sum and is
// not ported: the warp's merge of equal cells takes its place.
//
// Position gradient (H14, used when camera extrinsics are optimised; tcnn's
// dL_dinput): per level and axis a, the sum in corner order of the
// corner's row dotted with the level's cotangent pair times
// ((+-1 * w_o1) * w_o2) * scale, the derivative of its weight along a (o1,
// o2 the other axes, the weights from the unclipped fraction: the clip of
// a corner index gets no derivative, as in JAX); the levels added in
// order. It reads what H7 reads and the cotangent and writes 3 values a
// sample: its floor is the bytes. The design is H7's tile and loads; the
// sums are chains in a fixed order, which `encode_dx_plain` repeats, so
// each dx is one thread's (no atomics) and bit for bit the plain
// version's.
#include "grad_scatter.cuh"

namespace {

constexpr int F = 2;     // features per level: a row is one float2
constexpr unsigned P1 = 2654435761u, P2 = 805459861u;   // tcnn primes

// Rows (absolute, in the whole table) and weights of the 8 corners of
// level l of the sample at x (its 3 coordinates), in the operation order
// of `_level_corners`, and the cell's key, its base vertex p0 before the
// clip (which fixes the rows); with `fr`, also each axis' fraction and
// 1 - fraction (fr[2a], fr[2a + 1]).
__device__ __forceinline__ void corners(const float* __restrict__ x,
                                        const int* __restrict__ levels,
                                        int l, int table_size, int row[8],
                                        float w[8], int key[3],
                                        float* fr = nullptr) {
  const int4 lv = reinterpret_cast<const int4*>(levels)[l];
  const float scale = __int_as_float(lv.x);
  const int res = lv.y, dense = lv.z, offset = lv.w;
  int p0[3];
  float f[3], omf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float pos = __fadd_rn(__fmul_rn(x[a], scale), 0.5f);
    float p0f = floorf(pos);
    f[a] = __fsub_rn(pos, p0f);
    omf[a] = __fsub_rn(1.0f, f[a]);
    p0[a] = static_cast<int>(p0f);
    key[a] = p0[a];
    if (fr) {
      fr[2 * a] = f[a];
      fr[2 * a + 1] = omf[a];
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const int ix = min(max(p0[0] + cx, 0), res - 1);
    const int iy = min(max(p0[1] + cy, 0), res - 1);
    const int iz = min(max(p0[2] + cz, 0), res - 1);
    int idx;
    if (dense) {
      idx = (ix * res + iy) * res + iz;
    } else {
      const unsigned h = static_cast<unsigned>(ix) ^
                         (static_cast<unsigned>(iy) * P1) ^
                         (static_cast<unsigned>(iz) * P2);
      idx = static_cast<int>(h & static_cast<unsigned>(table_size - 1));
    }
    row[c] = offset + idx;
    w[c] = __fmul_rn(__fmul_rn(cx ? f[0] : omf[0], cy ? f[1] : omf[1]),
                     cz ? f[2] : omf[2]);
  }
}

// H7: a block takes TILE consecutive samples (x staged once in shared
// memory), warp w levels w, w + warps, ...; lane = sample. The blend is
// the 8 corners in corner order, without FMA; the tile's outputs are
// staged in shared memory and written as 16-byte words.
constexpr int TILE = 32;
constexpr int FWD_WARPS = 16;

template <bool BF16>
__global__ void __launch_bounds__(TILE * FWD_WARPS)
    hash_grid_fwd_kernel(const float* __restrict__ table,
                         const float* __restrict__ x,
                         const int* __restrict__ levels,
                         void* __restrict__ out, int M, int L,
                         int table_size) {
  extern __shared__ float4 smem[];
  const int width = F * L, ostride = width + 2;   // float2 stores: no
  float* xs = reinterpret_cast<float*>(smem);     // bank conflicts
  float* os = xs + TILE * 3;
  const int lane = threadIdx.x, warps = blockDim.y;
  const int tid = threadIdx.y * TILE + lane, nt = warps * TILE;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  __syncthreads();
  const float* x3 = xs + 3 * min(lane, rows - 1);
  for (int l = threadIdx.y; l < L; l += warps) {
    int row[8], key[3];
    float w[8];
    corners(x3, levels, l, table_size, row, w, key);
    float2 v[8];
    if (levels[4 * l + 2])   // dense: warp-uniform
      ncn_load_pairs<1>(table, row, v);
    else
      ncn_load_pairs<4>(table, row, v);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      a0 = __fadd_rn(a0, __fmul_rn(w[c], v[c].x));
      a1 = __fadd_rn(a1, __fmul_rn(w[c], v[c].y));
    }
    *reinterpret_cast<float2*>(os + lane * ostride + F * l) =
        make_float2(a0, a1);
  }
  __syncthreads();
  ncn_unstage<BF16>(os, rows * width, width, ostride,
                    static_cast<char*>(out) + (BF16 ? 2LL : 4LL) * width * m0,
                    tid, nt);
}

// H14: the position gradient. H7's tile (x and the cotangent staged once,
// warp w levels w, w + warps, ...; lane = sample, the corners' rows read
// as H7 reads them); each (sample, level)'s 3 axis sums go to shared
// memory, and a thread per (sample, axis) adds the levels in order and
// writes dx.
constexpr int DX_WARPS = 8;

template <bool BF16>
__global__ void __launch_bounds__(TILE * DX_WARPS)
    hash_grid_dx_kernel(const float* __restrict__ table,
                        const float* __restrict__ x,
                        const int* __restrict__ levels,
                        const void* __restrict__ g, float* __restrict__ dx,
                        int M, int L, int table_size) {
  extern __shared__ float4 smem[];
  const int width = F * L, gstride = width + 1;
  float* xs = reinterpret_cast<float*>(smem);
  float* gs = xs + TILE * 3;
  float* ds = gs + TILE * gstride;   // (L, TILE, 3)
  const int lane = threadIdx.x, warps = blockDim.y;
  const int tid = threadIdx.y * TILE + lane, nt = warps * TILE;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  ncn_stage<BF16>(static_cast<const char*>(g) + (BF16 ? 2LL : 4LL) * width * m0,
                  rows * width, width, gstride, gs, tid, nt);
  __syncthreads();
  const int i = min(lane, rows - 1);
  const float* x3 = xs + 3 * i;
  for (int l = threadIdx.y; l < L; l += warps) {
    int row[8], key[3];
    float w[8], fr[6];
    corners(x3, levels, l, table_size, row, w, key, fr);
    float2 v[8];
    if (levels[4 * l + 2])   // dense: warp-uniform
      ncn_load_pairs<1>(table, row, v);
    else
      ncn_load_pairs<4>(table, row, v);
    const float g0 = gs[i * gstride + F * l], g1 = gs[i * gstride + F * l + 1];
    const float scale = __int_as_float(levels[4 * l]);
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cs[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
      const float gd = __fadd_rn(__fmul_rn(v[c].x, g0), __fmul_rn(v[c].y, g1));
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int o1 = a == 0 ? 1 : 0, o2 = a == 2 ? 1 : 2;
        const float w1 = cs[o1] ? fr[2 * o1] : fr[2 * o1 + 1];
        const float w2 = cs[o2] ? fr[2 * o2] : fr[2 * o2 + 1];
        const float dw = __fmul_rn(__fmul_rn(cs[a] ? w1 : -w1, w2), scale);
        acc[a] = __fadd_rn(acc[a], __fmul_rn(dw, gd));
      }
    }
    if (lane < rows) {
#pragma unroll
      for (int a = 0; a < 3; ++a) ds[(l * TILE + lane) * 3 + a] = acc[a];
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * 3; e += nt) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s = __fadd_rn(s, ds[l * TILE * 3 + e]);
    dx[3LL * m0 + e] = s;
  }
}

// H8's geometry for grad_scatter.cuh: the corners' f32 offsets in the
// table (below 2^31: the wrapper checks the table's size).
struct HashGeom {
  const int* levels;
  int table_size;
  __device__ __forceinline__ void operator()(const float* x3, int l,
                                             int key[3], int idx[8],
                                             float w[8]) const {
    int row[8];
    corners(x3, levels, l, table_size, row, w, key);
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] = row[c] * F;
  }
};

}  // namespace

extern "C" int hash_grid_fwd(const void* table, const void* x,
                             const void* levels, void* out, int M, int L,
                             int table_size, int out_bf16,
                             cudaStream_t stream) {
  const int warps = L < FWD_WARPS ? L : FWD_WARPS;
  const size_t bytes = sizeof(float) * TILE * (3 + F * L + 2);
  auto kernel = out_bf16 ? hash_grid_fwd_kernel<true>
                         : hash_grid_fwd_kernel<false>;
  if (bytes > 48 * 1024) {   // the opt-in holds per device: set it each time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, warps), bytes, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int*>(levels), out, M, L, table_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hash_grid_bwd(const void* g, const void* x, const void* levels,
                             void* d_table, int M, int L, int table_size,
                             int g_bf16, cudaStream_t stream) {
  return grad_scatter::launch(
      g, x, d_table, M, L, g_bf16,
      HashGeom{static_cast<const int*>(levels), table_size}, stream);
}

extern "C" int hash_grid_dx(const void* table, const void* x,
                            const void* levels, const void* g, void* dx,
                            int M, int L, int table_size, int g_bf16,
                            cudaStream_t stream) {
  const int warps = L < DX_WARPS ? L : DX_WARPS;
  const size_t bytes =
      sizeof(float) * TILE * (3 + (F * L + 1) + 3 * L);
  auto kernel = g_bf16 ? hash_grid_dx_kernel<true>
                       : hash_grid_dx_kernel<false>;
  if (bytes > 48 * 1024) {   // the opt-in holds per device: set it each time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, warps), bytes, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int*>(levels), g, static_cast<float*>(dx), M, L,
      table_size);
  return static_cast<int>(cudaGetLastError());
}
