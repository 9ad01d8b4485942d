// H7 / H8: multiresolution hash-grid encode (the tcnn layout), forward and
// table gradient.
//
// Replaces the JAX package's `hash_encode_vjp`
// (normal_clustering_nerf_tpu/models/hash_encoding.py:133-248: forward
// `_hash_encode_fwd_impl` :123-130, backward `_hash_vjp_bwd` :199-245 with
// need_dx=False and the direct scatter).
//
// Layout: one (total_rows, 2) f32 table; level l's rows start at
// level_offsets[l]. Per level, pos = x*scale + 0.5, p0 = floor(pos),
// w = pos - p0; corner c = p0 + (cx, cy, cz), each axis clipped to
// [0, res-1]; its row is (ix*res + iy)*res + iz when res^3 fits in the
// level's table, else the tcnn XOR-prime hash with uint32 wraparound,
// & (T-1); its weight (wx*wy)*wz from the unclipped fraction
// (hash_encoding.py:99-120).
//
// Forward (H7): one thread per (sample, level), thread i = m*L + l, so a
// sample's 16 threads write its 32 outputs contiguously: 8 float2 loads of
// the corners' rows and the blend in registers, in corner order; written
// in f32 or rounded once to bf16. pos is computed without FMA
// (--fmad=false, __fmul_rn / __fadd_rn) so that floor(pos) and the weights
// are the reference's.
//
// Bound of the forward on the H100: memory latency. Each (sample, level)
// reads 8 random 8-byte rows of a 45.7 MB table (fine levels hash corners
// to unrelated rows: 8 sectors, where a brick level needs 1-4), with
// about 50 integer and f32 operations between. The design keeps many
// independent (sample, level) pairs in flight (256 threads a block, M*16
// threads).
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
#include "grad_scatter.cuh"

namespace {

constexpr int F = 2;     // features per level: a row is one float2
constexpr unsigned P1 = 2654435761u, P2 = 805459861u;   // tcnn primes

// Rows (absolute, in the whole table) and weights of the 8 corners of
// one (sample, level), in the operation order of `_level_corners`, and
// the cell's key, its base vertex p0 before the clip (which fixes the
// rows).
__device__ __forceinline__ void corners(const float* __restrict__ x,
                                        const int* __restrict__ levels,
                                        int m, int l, int table_size,
                                        int row[8], float w[8], int key[3]) {
  const int4 lv = reinterpret_cast<const int4*>(levels)[l];
  const float scale = __int_as_float(lv.x);
  const int res = lv.y, dense = lv.z, offset = lv.w;
  int p0[3];
  float f[3], omf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float pos = __fadd_rn(__fmul_rn(x[3 * m + a], scale), 0.5f);
    float p0f = floorf(pos);
    f[a] = __fsub_rn(pos, p0f);
    omf[a] = __fsub_rn(1.0f, f[a]);
    p0[a] = static_cast<int>(p0f);
    key[a] = p0[a];
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

__global__ void hash_grid_fwd_kernel(const float* __restrict__ table,
                                     const float* __restrict__ x,
                                     const int* __restrict__ levels,
                                     void* __restrict__ out, int M, int L,
                                     int table_size, int out_bf16) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(M) * L) return;
  const int m = static_cast<int>(i / L), l = static_cast<int>(i % L);
  int row[8], key[3];
  float w[8];
  corners(x, levels, m, l, table_size, row, w, key);
  const float2* tab = reinterpret_cast<const float2*>(table);
  float2 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(tab + row[c]);
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

// H8's geometry for grad_scatter.cuh: the corners' f32 offsets in the
// table (below 2^31: the wrapper checks the table's size).
struct HashGeom {
  const int* levels;
  int table_size;
  __device__ __forceinline__ void operator()(const float* x3, int l,
                                             int key[3], int idx[8],
                                             float w[8]) const {
    int row[8];
    corners(x3, levels, 0, l, table_size, row, w, key);
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] = row[c] * F;
  }
};

}  // namespace

extern "C" int hash_grid_fwd(const void* table, const void* x,
                             const void* levels, void* out, int M, int L,
                             int table_size, int out_bf16,
                             cudaStream_t stream) {
  const int threads = 256;
  hash_grid_fwd_kernel<<<ncn_blocks(static_cast<long long>(M) * L, threads),
                         threads, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int*>(levels), out, M, L, table_size, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hash_grid_bwd(const void* g, const void* x, const void* levels,
                             void* d_table, int M, int L, int table_size,
                             int g_bf16, cudaStream_t stream) {
  return grad_scatter::launch(
      g, x, d_table, M, L, g_bf16,
      HashGeom{static_cast<const int*>(levels), table_size}, stream);
}
