// K8: the occupancy refresh after the sigma eval, in three launchers.
//
// Replaces the JAX package's refresh (normal_clustering_nerf_tpu/models/
// occupancy.py:179-237 `update`, with :143-176 `sample_update_cells`, :44
// `coarse_occupancy`, :68 `supervoxel_tables` and ops/packbits.py:16
// `packbits`, the reference's CUDA kernel raymarching.cu:122-161), which
// the port ran as chains of torch ops around a `torch.nonzero` that read
// the occupied count on the host, so that the refresh could not join a
// CUDA graph. Nothing here reads the host: the refresh's graph replays it.
//
// `occ_compact`: for each cascade, the cells whose density exceeds the
// threshold, in ascending order, and their count (JAX builds the list by
// cumsum and scatter, :164-168). One launch: a thread takes 16 cells (four
// 16-byte loads) as a bit mask, the block scans its 256 counts, and the
// blocks of a cascade chain their prefixes by decoupled look-back
// (look_back.cuh, H11's scan); a thread then writes its cells' indices.
// The list is int32 in a (C, G^3) buffer (entries past the count are not
// written), the count int32 a cascade. Bound: the grid's read, 8.4 MB at G
// 128, C 1, and the list's writes (4 bytes an occupied cell).
//
// `occ_merge_pack`: grid' = where(grid < 0, grid, max(grid * decay, tmp))
// (torch.maximum's NaN rule), the mean of grid's positive cells, thr =
// min(mean, density_threshold), and the bitfield of grid' > thr, packed
// little-endian (bit i of byte n = cell 8n + i). Two launches and no float
// atomics: the merge writes grid' and its sums, a lane per column of a
// (C G^3 / 65536, 65536) view adding its column's positive cells serially
// (256 blocks of 256 lanes), each block halving its 256 sums pairwise in
// shared memory; the pack's blocks each halve the 256 block sums the same
// way (all get the same mean), and pack 32 cells a thread (eight 16-byte
// loads, one 32-bit word). The plain version repeats the order with
// elementwise adds. Bound: grid and tmp read, grid' written, ~25 MB at G
// 128, C 1 (grid' is read again by the pack: 8 MB more, L2-warm).
//
// `occ_tables`: from cascade 0's bitfield, the supervoxel-run march's 16
// words a supervoxel (`sv_payload`: bit L = (lz 8 + ly) 8 + lx, word L >>
// 5; each (lz, ly) row of 8 cells is one bitfield byte, so a word is four
// bytes), its any-bit mask (`sv_mask`) and the two-level march's mask
// dilated by one supervoxel on each axis, zero past the borders
// (`coarse_occ`). One launch, a block a z-slab of supervoxels: the slab's
// and its two neighbours' masks in shared memory, then the 3 x 3 x 3
// maximum. ~0.5 MB at G 128, under one launch's floor.
//
// Every launcher takes any G that is a multiple of 8 and C >= 1.
#include "look_back.cuh"

namespace {

constexpr int COMPACT_THREADS = 256;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int CELLS = 16;   // a thread's cells in occ_compact
constexpr int TILE = COMPACT_THREADS * CELLS;

constexpr int MERGE_BLOCKS = 256;
constexpr int MERGE_THREADS = 256;
constexpr int COLUMNS = MERGE_BLOCKS * MERGE_THREADS;
constexpr int PACK_THREADS = MERGE_BLOCKS;   // a lane a block sum

constexpr int TABLE_THREADS = 256;

__global__ void __launch_bounds__(COMPACT_THREADS) occ_compact_kernel(
    const float* __restrict__ grid, float thr, int G3, int tiles,
    unsigned long long* __restrict__ work, int* __restrict__ list,
    int* __restrict__ count) {
  __shared__ int s_warp[COMPACT_WARPS];
  __shared__ int s_prefix;
  const scan::Ticket ticket = scan::take_ticket(work);
  const int c = ticket.index / tiles, tile = ticket.index - c * tiles;
  unsigned long long* status = work + 1 + static_cast<size_t>(c) * tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = tile * TILE + tid * CELLS;
  unsigned mask = 0;
  if (first < G3) {   // G3 is a multiple of 512: all 16 cells or none
    const float4* q = reinterpret_cast<const float4*>(
        grid + static_cast<size_t>(c) * G3 + first);
#pragma unroll
    for (int k = 0; k < CELLS / 4; ++k) {
      const float4 v = __ldg(q + k);
      mask |= (static_cast<unsigned>(v.x > thr) |
               static_cast<unsigned>(v.y > thr) << 1 |
               static_cast<unsigned>(v.z > thr) << 2 |
               static_cast<unsigned>(v.w > thr) << 3) << (4 * k);
    }
  }
  const int cnt = __popc(mask);
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < COMPACT_WARPS ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < COMPACT_WARPS; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    const int agg = __shfl_sync(FULL, v, COMPACT_WARPS - 1);
    const int prefix = scan::look_back(status, ticket.tag, tile, agg, lane);
    if (lane < COMPACT_WARPS) s_warp[lane] = v;
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == tiles - 1) count[c] = prefix + agg;
    }
  }
  __syncthreads();
  int pos = s_prefix + (warp ? s_warp[warp - 1] : 0) + x - cnt;
  int* out = list + static_cast<size_t>(c) * G3;
  while (mask) {
    out[pos++] = first + __ffs(mask) - 1;
    mask &= mask - 1;
  }
}

// torch.maximum on the card: a NaN operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// grid', and each block's sum and count of grid''s positive cells
__global__ void __launch_bounds__(MERGE_THREADS) occ_merge_kernel(
    const float* __restrict__ grid, const float* __restrict__ tmp,
    float decay, int n, float* __restrict__ out,
    float* __restrict__ part_sum, int* __restrict__ part_cnt) {
  __shared__ float s_sum[MERGE_THREADS];
  __shared__ int s_cnt[MERGE_THREADS];
  const int tid = threadIdx.x;
  float s = 0.0f;
  int k = 0;
#pragma unroll 4
  for (int i = blockIdx.x * MERGE_THREADS + tid; i < n; i += COLUMNS) {
    const float g = __ldg(grid + i);
    const float m = g < 0.0f ? g : nan_max(__fmul_rn(g, decay), __ldg(tmp + i));
    out[i] = m;
    if (m > 0.0f) {
      s = __fadd_rn(s, m);
      ++k;
    }
  }
  s_sum[tid] = s;
  s_cnt[tid] = k;
  __syncthreads();
  for (int h = MERGE_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s_sum[tid] = __fadd_rn(s_sum[tid], s_sum[tid + h]);
      s_cnt[tid] += s_cnt[tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    part_sum[blockIdx.x] = s_sum[0];
    part_cnt[blockIdx.x] = s_cnt[0];
  }
}

// the mean (every block the same halvings), thr, and the bitfield
__global__ void __launch_bounds__(PACK_THREADS) occ_pack_kernel(
    const float* __restrict__ grid, int n, const float* __restrict__ part_sum,
    const int* __restrict__ part_cnt, float density_threshold,
    unsigned* __restrict__ bits, float* __restrict__ mean_out) {
  __shared__ float s_sum[MERGE_BLOCKS];
  __shared__ int s_cnt[MERGE_BLOCKS];
  __shared__ float s_thr;
  const int tid = threadIdx.x;
  s_sum[tid] = part_sum[tid];
  s_cnt[tid] = part_cnt[tid];
  __syncthreads();
  for (int h = MERGE_BLOCKS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s_sum[tid] = __fadd_rn(s_sum[tid], s_sum[tid + h]);
      s_cnt[tid] += s_cnt[tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float mean =
        __fdiv_rn(s_sum[0], static_cast<float>(max(s_cnt[0], 1)));
    s_thr = mean != mean ? mean : fminf(mean, density_threshold);
    if (blockIdx.x == 0) *mean_out = mean;
  }
  __syncthreads();
  const float thr = s_thr;
  for (int w = blockIdx.x * PACK_THREADS + tid; w < n / 32;
       w += gridDim.x * PACK_THREADS) {
    const float4* q = reinterpret_cast<const float4*>(grid) + 8 * w;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = q[k];
      word |= (static_cast<unsigned>(v.x > thr) |
               static_cast<unsigned>(v.y > thr) << 1 |
               static_cast<unsigned>(v.z > thr) << 2 |
               static_cast<unsigned>(v.w > thr) << 3) << (4 * k);
    }
    bits[w] = word;
  }
}

// a block a z-slab of supervoxels (zc = blockIdx.x)
__global__ void __launch_bounds__(TABLE_THREADS) occ_tables_kernel(
    const uint8_t* __restrict__ bits, int G, uint8_t* __restrict__ coarse,
    uint8_t* __restrict__ sv_mask, int* __restrict__ payload) {
  extern __shared__ uint8_t s_m[];   // the masks of slabs zc - 1..zc + 1
  const int Gc = G / 8, P = Gc * Gc, zc = blockIdx.x;
  for (int q = threadIdx.x; q < 3 * P; q += TABLE_THREADS) {
    const int z = zc + q / P - 1, s = q % P, yc = s / Gc, xc = s % Gc;
    const bool own = q / P == 1;
    unsigned any = 0;
    if (z >= 0 && z < Gc) {
#pragma unroll 4
      for (int w = 0; w < 16; ++w) {
        // rows (lz, ly) = (w / 2, 4 (w % 2) + j), one byte each
        const int lz = w >> 1, ly = (w & 1) * 4;
        const size_t row =
            (static_cast<size_t>(z * 8 + lz) * G + yc * 8 + ly) * Gc + xc;
        unsigned word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= static_cast<unsigned>(__ldg(bits + row + j * Gc)) << (8 * j);
        any |= word;
        if (own) payload[(static_cast<size_t>(zc) * P + s) * 16 + w] =
            static_cast<int>(word);
      }
    }
    s_m[q] = any != 0;
    if (own) sv_mask[static_cast<size_t>(zc) * P + s] = any != 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < P; s += TABLE_THREADS) {
    const int yc = s / Gc, xc = s % Gc;
    uint8_t m = 0;
    for (int dz = 0; dz < 3; ++dz)
      for (int y = max(yc - 1, 0); y <= min(yc + 1, Gc - 1); ++y)
        for (int x = max(xc - 1, 0); x <= min(xc + 1, Gc - 1); ++x)
          m |= s_m[dz * P + y * Gc + x];
    coarse[static_cast<size_t>(zc) * P + s] = m;
  }
}

}  // namespace

// grid (C, G3) f32, G3 a multiple of 512 and the rows 16-byte aligned;
// work: at least 1 + C * ceil(G3 / 4096) 64-bit words, zeroed once (a
// buffer kept for the device, its calls ordered on one stream: see
// look_back.cuh). list (C, G3) int32, count (C,) int32.
extern "C" int occ_compact(const void* grid, float thr, int C, int G3,
                           void* work, void* list, void* count,
                           cudaStream_t stream) {
  if (C < 1 || G3 < 512 || G3 % 512 != 0 ||
      (reinterpret_cast<uintptr_t>(grid) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ncn_blocks(G3, TILE);
  occ_compact_kernel<<<C * tiles, COMPACT_THREADS, 0, stream>>>(
      static_cast<const float*>(grid), thr, G3, tiles,
      static_cast<unsigned long long*>(work), static_cast<int*>(list),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// grid, tmp, grid_out: n f32 (n = C G^3, a multiple of 512; grid_out
// 16-byte aligned); partials: 2 * 256 words (the block sums, then the
// block counts); bitfield: n / 8 bytes, 4-byte aligned; mean_out: one f32.
extern "C" int occ_merge_pack(const void* grid, const void* tmp, float decay,
                              float density_threshold, int n, void* partials,
                              void* grid_out, void* bitfield, void* mean_out,
                              cudaStream_t stream) {
  if (n < 512 || n % 512 != 0 ||
      ((reinterpret_cast<uintptr_t>(grid_out) & 15) |
       (reinterpret_cast<uintptr_t>(bitfield) & 3)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* sums = static_cast<float*>(partials);
  auto* cnts = reinterpret_cast<int*>(sums + MERGE_BLOCKS);
  occ_merge_kernel<<<MERGE_BLOCKS, MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(grid), static_cast<const float*>(tmp), decay,
      n, static_cast<float*>(grid_out), sums, cnts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  occ_pack_kernel<<<ncn_blocks(n / 32, PACK_THREADS), PACK_THREADS, 0,
                    stream>>>(static_cast<const float*>(grid_out), n, sums,
                              cnts, density_threshold,
                              static_cast<unsigned*>(bitfield),
                              static_cast<float*>(mean_out));
  return static_cast<int>(cudaGetLastError());
}

// bitfield: at least G^3 / 8 bytes (cascade 0's are read); coarse and
// sv_mask (G/8)^3 bytes, payload (G/8)^3 x 16 int32.
extern "C" int occ_tables(const void* bitfield, int G, void* coarse,
                          void* sv_mask, void* payload, cudaStream_t stream) {
  if (G < 8 || G % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Gc = G / 8;
  const size_t smem = 3 * static_cast<size_t>(Gc) * Gc;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        occ_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  occ_tables_kernel<<<Gc, TABLE_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(bitfield), G,
      static_cast<uint8_t*>(coarse), static_cast<uint8_t*>(sv_mask),
      static_cast<int*>(payload));
  return static_cast<int>(cudaGetLastError());
}
