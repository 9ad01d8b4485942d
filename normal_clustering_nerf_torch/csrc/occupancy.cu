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
// cumsum and scatter, :164-168). One launch of tiles of 16384 cells (1024
// threads, four float4 loads each, k-major so that a warp's load is 512
// contiguous bytes). The tiles of a cascade chain their prefixes by
// decoupled look-back (look_back.cuh, H11's scan), so large tiles keep
// the chain short: 128 tiles at G 128 (on the trained grid, tiles of
// 8192 cells measured 3% slower at one cascade and 11% at two, of 4096
// 9% and 11%). The thread's four 4-bit masks give four counts, packed two to
// a word (16 bits each: a block's count of one quad position is at most
// 4096), so one warp scan and one scan of the 32 warp sums rank every
// occupied cell of the tile. Warp 0 publishes the aggregate and looks back; meanwhile
// the other warps stage their cells' indices in shared memory at their
// local ranks (64 KB), and warp 0 stages its own after. Once the prefix
// is known the block writes its run [prefix, prefix + agg) contiguously,
// so a warp's store covers whole sectors: the unaligned head and tail
// (0-3 entries) as ints, the rest as 16-byte stores, consecutive threads
// on consecutive quads (each quad two aligned shared-memory quads shifted
// by the head). The list is int32 in a (C, G^3) buffer (entries past the
// count are not written), the count int32 a cascade. Bound: the grid's
// read, 8.4 MB at G 128, C 1, and the list's writes (4 bytes an occupied
// cell).
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
// 5; each (lz, ly) row of 8 cells is one bitfield byte, so word w is the
// bytes of rows 4w..4w+3), its any-bit mask (`sv_mask`) and the two-level
// march's mask dilated by one supervoxel on each axis, zero past the
// borders (`coarse_occ`). One launch, a block a (zc, yc) row of
// supervoxels: Gc^2 blocks, 256 at G 128, more than the card's 132 SMs. A
// row (z, y) of the bitfield is Gc contiguous bytes, one a supervoxel
// along x, so the block loads its 64 rows and, for the mask's halo, the
// 64 rows of each of the 8 neighbouring (zc, yc) rows, as 16-byte vectors
// (bytes where Gc or the bitfield's address allows no vector). The halo
// is recomputed from the bitfield, not exchanged between blocks: the
// bitfield is L2-warm (the pack wrote it; 256 KB at G 128), so 9x its
// reads cost ~2.3 MB of L2 traffic and no barrier, where a cluster would
// exchange masks over distributed shared memory behind cluster barriers
// and hold 16 blocks at most. The ORs over the rows (a warp's xor
// shuffles, then a shared atomicOr) give each x column's any-byte of the
// own row and of the 3 x 3 rows, so sv_mask and the x-dilation of
// coarse_occ are byte tests. The own rows are staged in shared memory; a
// thread builds 4 words of one supervoxel by byte permutes (__byte_perm
// of the 4 rows' words) and writes them as one 16-byte store,
// consecutive threads on consecutive 16 bytes of the block's contiguous
// Gc x 64-byte payload. ~0.5 MB at G 128, under one launch's floor.
//
// Every launcher takes any G that is a multiple of 8 and C >= 1.
#include "look_back.cuh"

namespace {

constexpr int COMPACT_THREADS = 1024;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int QUADS = 4;   // a thread's float4 loads in occ_compact
constexpr int TILE = COMPACT_THREADS * QUADS * 4;   // cells a block
static_assert(QUADS == 4, "occ_compact packs two quad counts a word");
constexpr int COMPACT_SMEM = (TILE / 4 + 1) * 16;

constexpr int MERGE_BLOCKS = 256;
constexpr int MERGE_THREADS = 256;
constexpr int COLUMNS = MERGE_BLOCKS * MERGE_THREADS;
constexpr int PACK_THREADS = MERGE_BLOCKS;   // a lane a block sum

constexpr int SV_ROWS = 64;          // a supervoxel's (lz, ly) rows of 8 cells
constexpr int TABLE_THREADS = 256;   // at most, in occ_tables

// bit i of the result: quad value i above thr
__device__ __forceinline__ unsigned above(float4 v, float thr) {
  return static_cast<unsigned>(v.x > thr) |
         static_cast<unsigned>(v.y > thr) << 1 |
         static_cast<unsigned>(v.z > thr) << 2 |
         static_cast<unsigned>(v.w > thr) << 3;
}

__global__ void __launch_bounds__(COMPACT_THREADS) occ_compact_kernel(
    const float* __restrict__ grid, float thr, int G3, int tiles,
    unsigned long long* __restrict__ work, int* __restrict__ list,
    int* __restrict__ count) {
  // the tile's cells by local rank (COMPACT_SMEM bytes of dynamic shared
  // memory: one quad more for the shifted reads)
  extern __shared__ int4 s_list4[];
  __shared__ unsigned s_warp[2][COMPACT_WARPS];
  __shared__ int s_prefix;
  int* s_list = reinterpret_cast<int*>(s_list4);
  const scan::Ticket ticket = scan::take_ticket(work);
  const int c = ticket.index / tiles, tile = ticket.index - c * tiles;
  unsigned long long* status = work + 1 + static_cast<size_t>(c) * tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* g = grid + static_cast<size_t>(c) * G3;
  // quad k of the thread: cells cell[k]..cell[k] + 3 (G3 is a multiple of
  // 512: a quad lies in the grid whole or not at all)
  int cell[QUADS];
  unsigned m[QUADS];
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    cell[k] = tile * TILE + 4 * (k * COMPACT_THREADS + tid);
    const float4* q = reinterpret_cast<const float4*>(g + cell[k]);
    m[k] = cell[k] < G3 ? above(__ldg(q), thr) : 0u;
  }
  // the counts of quads 0, 1 and of quads 2, 3, 16 bits each
  const unsigned lo = __popc(m[0]) | __popc(m[1]) << 16;
  const unsigned hi = __popc(m[2]) | __popc(m[3]) << 16;
  unsigned xl = lo, xh = hi;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned yl = __shfl_up_sync(FULL, xl, o);
    const unsigned yh = __shfl_up_sync(FULL, xh, o);
    if (lane >= o) {
      xl += yl;
      xh += yh;
    }
  }
  if (lane == 31) {
    s_warp[0][warp] = xl;
    s_warp[1][warp] = xh;
  }
  __syncthreads();
  // every warp scans the warp sums: its own offset and the block's totals
  unsigned wl = lane < COMPACT_WARPS ? s_warp[0][lane] : 0u;
  unsigned wh = lane < COMPACT_WARPS ? s_warp[1][lane] : 0u;
#pragma unroll
  for (int o = 1; o < COMPACT_WARPS; o <<= 1) {
    const unsigned yl = __shfl_up_sync(FULL, wl, o);
    const unsigned yh = __shfl_up_sync(FULL, wh, o);
    if (lane >= o) {
      wl += yl;
      wh += yh;
    }
  }
  const unsigned tl = __shfl_sync(FULL, wl, COMPACT_WARPS - 1);
  const unsigned th = __shfl_sync(FULL, wh, COMPACT_WARPS - 1);
  const unsigned ol = __shfl_sync(FULL, wl, max(warp - 1, 0));
  const unsigned oh = __shfl_sync(FULL, wh, max(warp - 1, 0));
  // the thread's exclusive counts of each quad position
  const unsigned el = (warp ? ol : 0u) + xl - lo;
  const unsigned eh = (warp ? oh : 0u) + xh - hi;
  const int t0 = tl & 0xffff, t1 = tl >> 16, t2 = th & 0xffff, t3 = th >> 16;
  const int agg = t0 + t1 + t2 + t3;
  if (warp == 0) {
    const int prefix = scan::look_back(status, ticket.tag, tile, agg, lane);
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == tiles - 1) count[c] = prefix + agg;
    }
  }
  // local ranks: the quads in order of position k, then of thread
  const int rank[QUADS] = {static_cast<int>(el & 0xffff),
                           t0 + static_cast<int>(el >> 16),
                           t0 + t1 + static_cast<int>(eh & 0xffff),
                           t0 + t1 + t2 + static_cast<int>(eh >> 16)};
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    int pos = rank[k];
    for (unsigned mm = m[k]; mm; mm &= mm - 1)
      s_list[pos++] = cell[k] + __ffs(mm) - 1;
  }
  __syncthreads();
  // the run [prefix, prefix + agg): the head up to a 16-byte boundary and
  // the tail as ints, the quads between as 16-byte stores
  const int prefix = s_prefix;
  int* out = list + static_cast<size_t>(c) * G3 + prefix;
  const int head = min((4 - (prefix & 3)) & 3, agg);
  const int quads = (agg - head) >> 2;
  const int tail = head + 4 * quads;
  if (tid < head) out[tid] = s_list[tid];
  if (tid < agg - tail) out[tail + tid] = s_list[tail + tid];
  int4* out4 = reinterpret_cast<int4*>(out + head);
  for (int q = tid; q < quads; q += COMPACT_THREADS) {
    const int4 a = s_list4[q], b = s_list4[q + 1];
    int4 w;
    switch (head) {
      case 0: w = a; break;
      case 1: w = make_int4(a.y, a.z, a.w, b.x); break;
      case 2: w = make_int4(a.z, a.w, b.x, b.y); break;
      default: w = make_int4(a.w, b.x, b.y, b.z);
    }
    out4[q] = w;
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
      word |= above(q[k], thr) << (4 * k);
    }
    bits[w] = word;
  }
}

// V bytes of the bitfield as 32-bit words (one word holding one byte at V 1)
template <int V>
struct Bytes {
  static constexpr int W = V == 16 ? 4 : 1;
  unsigned w[W];
};

template <int V>
__device__ __forceinline__ Bytes<V> load_bytes(const uint8_t* p) {
  Bytes<V> b;
  if constexpr (V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    b.w[0] = u.x;
    b.w[1] = u.y;
    b.w[2] = u.z;
    b.w[3] = u.w;
  } else {
    b.w[0] = __ldg(p);
  }
  return b;
}

// OR of the lanes' bytes v V.. into the words of `dst` (a row of Gc bytes):
// the lanes of one v first meet by xor shuffles where the NV loads of a
// row are a power of two up to 32 (lane l holds v = l mod NV)
template <int V>
__device__ __forceinline__ void or_row(unsigned* dst, Bytes<V> b, int v,
                                       int NV, int lane) {
  if ((NV & (NV - 1)) == 0 && NV <= 32) {
    for (int o = 16; o >= NV; o >>= 1)
#pragma unroll
      for (int k = 0; k < Bytes<V>::W; ++k)
        b.w[k] |= __shfl_xor_sync(FULL, b.w[k], o);
    if (lane >= NV) return;
  }
  if constexpr (V == 1) {
    if (b.w[0]) atomicOr(dst + (v >> 2), b.w[0] << 8 * (v & 3));
  } else {
#pragma unroll
    for (int k = 0; k < Bytes<V>::W; ++k)
      if (b.w[k]) atomicOr(dst + v * Bytes<V>::W + k, b.w[k]);
  }
}

// a block a (zc, yc) row of supervoxels (blockIdx.x = zc Gc + yc); V bytes
// a load (16 or 1, dividing Gc); blockDim a multiple of 32
template <int V>
__global__ void __launch_bounds__(TABLE_THREADS) occ_tables_kernel(
    const uint8_t* __restrict__ bits, int G, uint8_t* __restrict__ coarse,
    uint8_t* __restrict__ sv_mask, int* __restrict__ payload) {
  // the own 64 rows (row r = 8 lz + ly, RW words each), then the ORs over
  // the rows of the 3 x 3 (zc, yc) rows and of the own row, a byte an xc
  extern __shared__ __align__(16) unsigned s_tab[];
  const int Gc = G / 8, NV = Gc / V, RW = (Gc + 3) / 4;
  unsigned* s_near = s_tab + SV_ROWS * RW;
  unsigned* s_own = s_near + RW;
  const int zc = blockIdx.x / Gc, yc = blockIdx.x - zc * Gc;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 2 * RW; i += blockDim.x) s_near[i] = 0;
  __syncthreads();
  // SV_ROWS NV items, a multiple of 32: a warp's lanes all take one
  for (int i = tid; i < SV_ROWS * NV; i += blockDim.x) {
    const int r = i / NV, v = i - r * NV;
    Bytes<V> own{}, near{};
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int z = zc + dz, y = yc + dy;
        if (z < 0 || z >= Gc || y < 0 || y >= Gc) continue;
        const size_t row =
            static_cast<size_t>(z * 8 + (r >> 3)) * G + y * 8 + (r & 7);
        const Bytes<V> b = load_bytes<V>(bits + row * Gc + v * V);
#pragma unroll
        for (int k = 0; k < Bytes<V>::W; ++k) near.w[k] |= b.w[k];
        if (dz == 0 && dy == 0) own = b;
      }
    }
    if constexpr (V == 16)
      reinterpret_cast<uint4*>(s_tab + r * RW)[v] =
          make_uint4(own.w[0], own.w[1], own.w[2], own.w[3]);
    else
      reinterpret_cast<uint8_t*>(s_tab + r * RW)[v] =
          static_cast<uint8_t>(own.w[0]);
    or_row<V>(s_near, near, v, NV, lane);
    or_row<V>(s_own, own, v, NV, lane);
  }
  __syncthreads();
  // item j = 4 xc + q: words 4q..4q+3 of supervoxel xc, word w the bytes
  // xc of rows 4w..4w+3, one 16-byte store (the block's payload is Gc x 64
  // contiguous bytes)
  int4* out = reinterpret_cast<int4*>(payload) +
              static_cast<size_t>(blockIdx.x) * Gc * 4;
  for (int j = tid; j < 4 * Gc; j += blockDim.x) {
    const int xc = j >> 2, q = j & 3;
    // byte xc & 3 of two words into bytes 0 and 1
    const unsigned sel = (xc & 3) | ((xc & 3) + 4) << 4;
    const unsigned* rows = s_tab + 16 * q * RW + (xc >> 2);
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned* p = rows + 4 * k * RW;
      w[k] = __byte_perm(__byte_perm(p[0], p[RW], sel),
                         __byte_perm(p[2 * RW], p[3 * RW], sel), 0x5410);
    }
    out[j] = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                       static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
  const uint8_t* near = reinterpret_cast<const uint8_t*>(s_near);
  const uint8_t* own = reinterpret_cast<const uint8_t*>(s_own);
  for (int xc = tid; xc < Gc; xc += blockDim.x) {
    const size_t sv = static_cast<size_t>(blockIdx.x) * Gc + xc;
    sv_mask[sv] = own[xc] != 0;
    coarse[sv] = (near[xc] | (xc > 0 ? near[xc - 1] : 0) |
                  (xc + 1 < Gc ? near[xc + 1] : 0)) != 0;
  }
}

template <int V>
cudaError_t launch_tables(const void* bitfield, int G, void* coarse,
                          void* sv_mask, void* payload, cudaStream_t stream) {
  const int Gc = G / 8;   // 10.6 KB of shared memory at G 1288 (G^3 < 2^31)
  const size_t smem = (SV_ROWS + 2) * static_cast<size_t>((Gc + 3) / 4) * 4;
  const int threads = min(TABLE_THREADS, SV_ROWS * (Gc / V));
  occ_tables_kernel<V><<<Gc * Gc, threads, smem, stream>>>(
      static_cast<const uint8_t*>(bitfield), G,
      static_cast<uint8_t*>(coarse), static_cast<uint8_t*>(sv_mask),
      static_cast<int*>(payload));
  return cudaGetLastError();
}

}  // namespace

// grid (C, G3) f32, G3 a multiple of 512 and the rows 16-byte aligned;
// work: at least 1 + C * ceil(G3 / 16384) 64-bit words, zeroed once (a
// buffer kept for the device, its calls ordered on one stream: see
// look_back.cuh). list (C, G3) int32, 16-byte aligned; count (C,) int32.
extern "C" int occ_compact(const void* grid, float thr, int C, int G3,
                           void* work, void* list, void* count,
                           cudaStream_t stream) {
  if (C < 1 || G3 < 512 || G3 % 512 != 0 ||
      ((reinterpret_cast<uintptr_t>(grid) |
        reinterpret_cast<uintptr_t>(list)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      occ_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      COMPACT_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ncn_blocks(G3, TILE);
  occ_compact_kernel<<<C * tiles, COMPACT_THREADS, COMPACT_SMEM, stream>>>(
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

// bitfield: at least G^3 / 8 bytes (cascade 0's are read; 16-byte loads
// where Gc = G / 8 is a multiple of 16 and the bitfield 16-byte aligned,
// else bytes); coarse and sv_mask
// (G/8)^3 bytes, payload (G/8)^3 x 16 int32, 16-byte aligned.
extern "C" int occ_tables(const void* bitfield, int G, void* coarse,
                          void* sv_mask, void* payload, cudaStream_t stream) {
  if (G < 8 || G % 8 != 0 || (reinterpret_cast<uintptr_t>(payload) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Gc = G / 8;
  const bool vec = Gc % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(bitfield) & 15) == 0;
  const cudaError_t e =
      vec ? launch_tables<16>(bitfield, G, coarse, sv_mask, payload, stream)
          : launch_tables<1>(bitfield, G, coarse, sv_mask, payload, stream);
  return static_cast<int>(e);
}
