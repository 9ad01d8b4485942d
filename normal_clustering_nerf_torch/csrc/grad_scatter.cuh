// The table gradient of the two hash-grid encodes: H6 `brick_bwd`
// (brick_hash.cu) and H8 `hash_grid_bwd` (hash_grid.cu). Each file
// supplies its geometry (the 8 corner addresses and weights of one
// (sample, level), and a key of its cell); this header supplies the rest,
// which the two share: the tile staging, the warp's merge of equal cells
// and the float2 reductions. Why each choice was made: brick_hash.cu's
// note.
//
// A block takes TILE = 32 consecutive samples x all L levels. It stages
// the tile's x (32 x 3 f32) and cotangent (32 x 2L, f32 or bf16, read as
// 16-byte words and kept as f32, rows padded to 2L + 2 floats so that the
// warps' float2 reads do not collide in the banks) in shared memory. Warp
// w then takes level w (and w + 16, ... when L > 16), one sample a lane:
//   1. live = the lane's sample exists and its cotangent pair is not
//      (0, 0); the lane computes the cell's 8 corner addresses and its
//      terms v_c = w_c * g (the plain version's products);
//   2. merge: a lane whose cell key equals the lane before's joins that
//      lane's run (samples along a ray are consecutive lanes, and a line
//      enters a cell once, so a cell's samples are one run); a segmented
//      suffix sum by shuffles, log2 of the longest run steps, leaves each
//      run's 16 sums in its first lane, which alone goes on;
//   3. add: the live lanes write their 8 (address, float2) entries to the
//      warp's buffer in shared memory, and the warp then reads them back
//      as 4 cells x 8 corners a pass, so that a pass's 32 reductions go to
//      the 4 cells' rows (brick: 4 sectors of one 512-byte row each). A
//      term equal to (+-0, +-0) is skipped: it changes no entry of a table
//      that starts at +0.0.
#pragma once
#include "common.cuh"

namespace grad_scatter {

constexpr int TILE = 32;        // samples a block takes, one a lane
constexpr int MAX_WARPS = 16;   // warps a block
constexpr int STRIDE = 9;       // buffer entries a cell: 8 corners, 1 pad

inline size_t smem_bytes(int L, int warps) {
  return sizeof(float) * (TILE * 3 + TILE * (2 * L + 2)) +
         static_cast<size_t>(warps) * TILE * STRIDE *
             (sizeof(int) + sizeof(float2));
}

// Steps 2 and 3 of the file note for one level of the warp's samples.
__device__ __forceinline__ void add_terms(bool live, const int key[3],
                                          const int idx[8], float2 v[8],
                                          float* __restrict__ d_table,
                                          int* bidx, float2* bval) {
  const int lane = threadIdx.x;
  const int k0 = __shfl_up_sync(FULL, key[0], 1);
  const int k1 = __shfl_up_sync(FULL, key[1], 1);
  const int k2 = __shfl_up_sync(FULL, key[2], 1);
  const bool prev_live = __shfl_up_sync(FULL, static_cast<int>(live), 1);
  const bool joins = lane > 0 && live && prev_live && k0 == key[0] &&
                     k1 == key[1] && k2 == key[2];
  const unsigned J = __ballot_sync(FULL, joins);
  if (J) {   // warp-uniform
    const unsigned starts = ~J;                 // first lanes of runs
    const unsigned upto = (2u << lane) - 1u;    // lanes 0..lane
    const int run = __popc(starts & upto);
    const unsigned later = starts & ~upto;
    const int len = (later ? __ffs(later) - 1 : 32) - lane;
    const int longest = static_cast<int>(__reduce_max_sync(
        FULL, static_cast<unsigned>((starts >> lane) & 1u ? len : 0)));
    for (int d = 1; d < longest; d <<= 1) {
      const int next = __shfl_down_sync(FULL, run, d);   // every lane
      const bool take = lane + d < 32 && next == run;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float a = __shfl_down_sync(FULL, v[c].x, d);
        const float b = __shfl_down_sync(FULL, v[c].y, d);
        if (take) {
          v[c].x = __fadd_rn(v[c].x, a);
          v[c].y = __fadd_rn(v[c].y, b);
        }
      }
    }
    live = live && !joins;
  }
  const unsigned heads = __ballot_sync(FULL, live);
  if (live) {
    const int e = __popc(heads & ((1u << lane) - 1u)) * STRIDE;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      bidx[e + c] = idx[c];
      bval[e + c] = v[c];
    }
  }
  __syncwarp();
  const int n = __popc(heads) * 8;
  for (int j = lane; j < n; j += 32) {
    const int e = (j >> 3) * STRIDE + (j & 7);
    const float2 s = bval[e];
    if (s.x != 0.0f || s.y != 0.0f)
      atomicAdd(reinterpret_cast<float2*>(d_table + bidx[e]), s);
  }
  __syncwarp();   // the buffer is written again for the warp's next level
}

// Geom: void operator()(const float* x3, int l, int key[3], int idx[8],
// float w[8]) const -> the cell key, the 8 corners' f32 offsets in
// d_table and their weights.
template <bool BF16, class Geom>
__global__ void __launch_bounds__(TILE * MAX_WARPS)
    scatter_kernel(const void* __restrict__ g, const float* __restrict__ x,
                   float* __restrict__ d_table, int M, int L, Geom geom) {
  extern __shared__ float4 smem[];
  const int gstride = 2 * L + 2, warps = blockDim.y, lane = threadIdx.x;
  float* xs = reinterpret_cast<float*>(smem);
  float* gs = xs + TILE * 3;
  int* bidx = reinterpret_cast<int*>(gs + TILE * gstride);
  float2* bval = reinterpret_cast<float2*>(bidx + warps * TILE * STRIDE);
  bidx += threadIdx.y * TILE * STRIDE;
  bval += threadIdx.y * TILE * STRIDE;
  const int m0 = blockIdx.x * TILE, rows = min(TILE, M - m0);
  const int tid = threadIdx.y * TILE + lane, nt = warps * TILE;
  ncn_stage<false>(x + 3LL * m0, rows * 3, 3, 3, xs, tid, nt);
  ncn_stage<BF16>(static_cast<const char*>(g) +
                      (BF16 ? 2LL : 4LL) * 2 * L * m0,
                  rows * 2 * L, 2 * L, gstride, gs, tid, nt);
  __syncthreads();
  const float* x3 = xs + 3 * min(lane, rows - 1);
  for (int l = threadIdx.y; l < L; l += warps) {
    float g0 = 0.0f, g1 = 0.0f;
    if (lane < rows) {
      g0 = gs[lane * gstride + 2 * l];
      g1 = gs[lane * gstride + 2 * l + 1];
    }
    const bool live = g0 != 0.0f || g1 != 0.0f;
    int key[3], idx[8];
    float w[8];
    geom(x3, l, key, idx, w);
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = make_float2(__fmul_rn(w[c], g0), __fmul_rn(w[c], g1));
    add_terms(live, key, idx, v, d_table, bidx, bval);
  }
}

template <bool BF16, class Geom>
int launch_as(const void* g, const void* x, void* d_table, int M, int L,
              Geom geom, cudaStream_t stream) {
  const int warps = L < MAX_WARPS ? L : MAX_WARPS;
  const size_t bytes = smem_bytes(L, warps);
  auto kernel = scatter_kernel<BF16, Geom>;
  if (bytes > 48 * 1024) {   // the opt-in holds per device: set it each time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ncn_blocks(M, TILE), dim3(TILE, warps), bytes, stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(d_table), M, L,
      geom);
  return static_cast<int>(cudaGetLastError());
}

// Launch for a cotangent in f32 (g_bf16 0) or bf16 (1).
template <class Geom>
int launch(const void* g, const void* x, void* d_table, int M, int L,
           int g_bf16, Geom geom, cudaStream_t stream) {
  return g_bf16 ? launch_as<true>(g, x, d_table, M, L, geom, stream)
                : launch_as<false>(g, x, d_table, M, L, geom, stream);
}

}  // namespace grad_scatter
