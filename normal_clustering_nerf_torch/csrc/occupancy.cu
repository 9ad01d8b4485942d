// K8: the occupancy refresh after the sigma eval, in three launchers, and
// the union of several cards' bitfields.
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
// (torch.maximum's NaN rule), the mean of grid''s positive cells, thr =
// min(mean, density_threshold), and the bitfield of grid' > thr, packed
// little-endian (bit i of byte n = cell 8n + i). One launch and no float
// atomics. Bound: grid and tmp read, grid' written (25 MB at G 128, C 1);
// the bitfield is an eighth of a grid. The blocks are as many as the card
// holds at once (two of 512 threads an SM) and walk tiles of 8192 cells,
// a thread four float4 of grid and of tmp, k-major (a warp's load is 512
// contiguous bytes), the next tile's loads issued before this tile's sums.
// A tile's positive sum is taken in a fixed tree (the thread's 16 cells in
// order, xor shuffles 16..1, then a warp the same over the 16 warp sums)
// and stored with its count at the tile's index, so the order of the sums
// is a function of n alone, never of the SM count; the plain version
// repeats it with elementwise adds. A barrier of the whole grid (an epoch
// and an arrival count in one word, zeroed once, as look_back.cuh keeps
// its tickets) follows; then every block adds the tile sums the same way
// (thread t tiles t, t + 512, ..., the same tree) to the same mean. The
// pack reads no grid' back where it fits on the SMs: each block keeps its
// first three tiles (96 KB of shared memory, so up to ~6.5 M cells, three
// cascades at G 128) and re-reads its others; a warp's 32 quads make 4
// words by shifts and xor shuffles, one 16-byte store. On the trained grid
// (one H100, time_k7k8.py) blocks of 1024 threads and tiles of 16384
// cells took as long at one cascade and 6% longer at two; 256 threads
// 2-5% longer at both; storing a block's last tile after its arrival at
// the barrier 14% longer at one; the tile sums as tagged words that every
// block polls, in place of the barrier, 2-6% longer. An earlier design
// ran two launches (the merge by columns of a (n / 65536, 65536) view on
// 256 blocks, then a pack that read grid' back), 2.1x its bound at G 128
// and 3.4x at 2 cascades, whose 50 MB pass L2's 50 MB.
//
// `occ_union`: the OR of several cards' bitfields, all-gathered
// (`merge_across_chips`), a thread a 16-byte column looping over the
// ranks (JAX takes the MAX of the unpacked bits, occupancy.py:295-312).
// Bound: the rows read and the union written.
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

constexpr int MERGE_THREADS = 512;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
static_assert(MERGE_WARPS <= 32 && (MERGE_WARPS & (MERGE_WARPS - 1)) == 0,
              "a warp halves the warp sums");
constexpr int MERGE_QUADS = 4;   // a thread's float4 of a tile
constexpr int TILE_QUADS = MERGE_THREADS * MERGE_QUADS;
constexpr int MERGE_TILE = TILE_QUADS * 4;   // 8192 cells
constexpr int TILE_BYTES = MERGE_TILE * 4;   // a tile of grid': 32 KB
constexpr int MERGE_SLOTS = 3;   // tiles of grid' a block keeps (96 KB)
constexpr int UNION_THREADS = 256;

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

__device__ __forceinline__ float merge1(float g, float t, float decay) {
  return g < 0.0f ? g : nan_max(__fmul_rn(g, decay), t);
}

// s added over the warp's lanes by xor shuffles 16..1: every lane gets the
// halvings' sum (lane i + lane i + h, h = 16..1; an add is commutative)
__device__ __forceinline__ float warp_halvings(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
  return s;
}

// The block's sum of every thread's s, and its count, the same in every
// thread: the lanes' halvings, then the MERGE_WARPS warp sums (in s_sum /
// s_cnt, read after the barrier inside) halved the same way.
__device__ __forceinline__ float block_halvings(float s, int c, float* s_sum,
                                                int* s_cnt, int& count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_halvings(s);
  c = __reduce_add_sync(FULL, c);
  if (lane == 0) {
    s_sum[warp] = s;
    s_cnt[warp] = c;
  }
  __syncthreads();
  // +0.0 past the warps: the halvings over 32 lanes are those over them
  count = __reduce_add_sync(FULL, lane < MERGE_WARPS ? s_cnt[lane] : 0);
  return warp_halvings(lane < MERGE_WARPS ? s_sum[lane] : 0.0f);
}

// A barrier of the whole grid, whose blocks are all resident: word holds
// the epoch (high half) and the arrivals (low half); the last block to
// arrive starts the next epoch with no arrivals, which releases the
// others. The word is zeroed once, when it is made, and comes back to 0
// arrivals after every call, whatever the grid.
__device__ __forceinline__ void grid_barrier(unsigned long long* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long t = atomicAdd(word, 1ull);
    if (static_cast<unsigned>(t) == gridDim.x - 1)
      atomicExch(word, ((t >> 32) + 1) << 32);
    else
      while ((scan::load_status(word) >> 32) == (t >> 32)) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void load_tile(const float4* __restrict__ grid,
                                          const float4* __restrict__ tmp,
                                          int p, int nq, float4* g,
                                          float4* t) {
#pragma unroll
  for (int k = 0; k < MERGE_QUADS; ++k) {
    const int q = p * TILE_QUADS + k * MERGE_THREADS + threadIdx.x;
    if (q < nq) {
      g[k] = __ldg(grid + q);
      t[k] = __ldg(tmp + q);
    }
  }
}

// the thread's quads of a tile into grid' and, where the block keeps the
// tile, into its slot `keep`
__device__ __forceinline__ void store_tile(const float4 (&m)[MERGE_QUADS],
                                           int q0, int nq,
                                           float4* __restrict__ out,
                                           float4* keep) {
#pragma unroll
  for (int k = 0; k < MERGE_QUADS; ++k) {
    const int q = q0 + k * MERGE_THREADS;
    if (q >= nq) continue;
    out[q] = m[k];
    if (keep) keep[k * MERGE_THREADS + threadIdx.x] = m[k];
  }
}

// grid', the mean of its positive cells, thr and the bitfield in one
// launch of resident blocks (see the launcher). Tile p: cells p MERGE_TILE
// and on; quad k of thread t is the tile's quad k MERGE_THREADS + t. A
// block's next tile is loaded while its tile's sums are taken.
__global__ void __launch_bounds__(MERGE_THREADS, 2) occ_merge_pack_kernel(
    const float4* __restrict__ grid, const float4* __restrict__ tmp,
    float decay, float density_threshold, int n, int tiles, int slots,
    unsigned long long* __restrict__ barrier, float* __restrict__ part_sum,
    int* __restrict__ part_cnt, float4* __restrict__ out,
    uint4* __restrict__ bits, float* __restrict__ mean_out) {
  // the block's first `slots` tiles of grid', as the threads hold them
  extern __shared__ float4 s_keep[];
  __shared__ float s_sum[2][MERGE_WARPS];
  __shared__ int s_cnt[2][MERGE_WARPS];
  __shared__ float s_thr;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nq = n / 4;
  float4 g[MERGE_QUADS], t[MERGE_QUADS];
  load_tile(grid, tmp, blockIdx.x, nq, g, t);
  int j = 0;
  for (int p = blockIdx.x; p < tiles; p += gridDim.x, ++j) {
    const int q0 = p * TILE_QUADS + tid;
    // the thread's positive cells added in order, quad by quad
    float4 m[MERGE_QUADS];
    float s = 0.0f;
    int c = 0;
#pragma unroll
    for (int k = 0; k < MERGE_QUADS; ++k) {
      m[k] = make_float4(merge1(g[k].x, t[k].x, decay),
                         merge1(g[k].y, t[k].y, decay),
                         merge1(g[k].z, t[k].z, decay),
                         merge1(g[k].w, t[k].w, decay));
      if (q0 + k * MERGE_THREADS >= nq) continue;
      const float v[4] = {m[k].x, m[k].y, m[k].z, m[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v[e] > 0.0f) {
          s = __fadd_rn(s, v[e]);
          ++c;
        }
    }
    store_tile(m, q0, nq, out, j < slots ? s_keep + j * TILE_QUADS : nullptr);
    if (p + gridDim.x < tiles) load_tile(grid, tmp, p + gridDim.x, nq, g, t);
    // two buffers in turn: the next tile's warp sums never overwrite
    // those warp 0 still reads
    int count;
    const float sum = block_halvings(s, c, s_sum[j & 1], s_cnt[j & 1], count);
    if (tid == 0) {
      part_sum[p] = sum;
      part_cnt[p] = count;
    }
  }
  grid_barrier(barrier);
  // every block the same sum of the tile sums: thread t adds tiles t,
  // t + MERGE_THREADS, ... in order, then the block's halvings
  float s = 0.0f;
  int c = 0;
  for (int p = tid; p < tiles; p += MERGE_THREADS) {
    s = __fadd_rn(s, __ldcg(part_sum + p));
    c += __ldcg(part_cnt + p);
  }
  int count;
  const float sum = block_halvings(s, c, s_sum[0], s_cnt[0], count);
  if (tid == 0) {
    const float mean = __fdiv_rn(sum, static_cast<float>(max(count, 1)));
    s_thr = mean != mean ? mean : fminf(mean, density_threshold);
    if (blockIdx.x == 0) *mean_out = mean;
  }
  __syncthreads();
  const float thr = s_thr;
  // the pack: a warp's 32 quads (128 cells) are 4 words, lanes 8w..8w+7
  // building word w by shifts and xor shuffles, lane 0 storing the 16
  // bytes; the values from shared memory, past `slots` tiles from grid'
  // (this thread's own stores)
  j = 0;
  for (int p = blockIdx.x; p < tiles; p += gridDim.x, ++j) {
#pragma unroll
    for (int k = 0; k < MERGE_QUADS; ++k) {
      const int q = p * TILE_QUADS + k * MERGE_THREADS + tid;
      if (q - lane >= nq) continue;   // nq is a multiple of 32: whole warps
      const float4 v = j < slots
                           ? s_keep[j * TILE_QUADS + k * MERGE_THREADS + tid]
                           : __ldcg(out + q);
      unsigned w = above(v, thr) << 4 * (lane & 7);
      w |= __shfl_xor_sync(FULL, w, 1);
      w |= __shfl_xor_sync(FULL, w, 2);
      w |= __shfl_xor_sync(FULL, w, 4);
      const unsigned w1 = __shfl_sync(FULL, w, 8);
      const unsigned w2 = __shfl_sync(FULL, w, 16);
      const unsigned w3 = __shfl_sync(FULL, w, 24);
      if (lane == 0) bits[q >> 5] = make_uint4(w, w1, w2, w3);
    }
  }
}

// the OR of `world` rows of `cols` 16-byte words, a thread a column
__global__ void __launch_bounds__(UNION_THREADS) occ_union_kernel(
    const uint4* __restrict__ rows, int world, int cols,
    uint4* __restrict__ out) {
  const int i = blockIdx.x * UNION_THREADS + threadIdx.x;
  if (i >= cols) return;
  uint4 a = __ldg(rows + i);
  for (int r = 1; r < world; ++r) {
    const uint4 b = __ldg(rows + static_cast<size_t>(r) * cols + i);
    a.x |= b.x;
    a.y |= b.y;
    a.z |= b.z;
    a.w |= b.w;
  }
  out[i] = a;
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

// grid, tmp, grid_out: n f32 (n = C G^3, a multiple of 512), bitfield n / 8
// bytes, all 16-byte aligned; barrier: one 64-bit word, zeroed once (a
// buffer kept for the device, its calls ordered on one stream); partials:
// 2 ceil(n / 8192) words (the tile sums, then the tile counts); mean_out:
// one f32. One launch of at most as many blocks as the card holds at once
// (the occupancy API's count, taken once a device); an error, and no
// launch, where it holds none or an alignment is not met.
extern "C" int occ_merge_pack(const void* grid, const void* tmp, float decay,
                              float density_threshold, int n, void* barrier,
                              void* partials, void* grid_out, void* bitfield,
                              void* mean_out, cudaStream_t stream) {
  if (n < 512 || n % 512 != 0 ||
      ((reinterpret_cast<uintptr_t>(grid) | reinterpret_cast<uintptr_t>(tmp) |
        reinterpret_cast<uintptr_t>(grid_out) |
        reinterpret_cast<uintptr_t>(bitfield)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];   // blocks the card holds at once, a device
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const int smem = MERGE_SLOTS * TILE_BYTES;
    int per_sm = 0, sms = 0;
    e = cudaFuncSetAttribute(occ_merge_pack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, occ_merge_pack_kernel, MERGE_THREADS, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms < 1)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int tiles = ncn_blocks(n, MERGE_TILE);
  const int blocks = min(tiles, resident[dev]);
  // fewer slots than MERGE_SLOTS hold no fewer blocks at once
  const int slots = min(ncn_blocks(tiles, blocks), MERGE_SLOTS);
  auto* sums = static_cast<float*>(partials);
  occ_merge_pack_kernel<<<blocks, MERGE_THREADS, slots * TILE_BYTES, stream>>>(
      static_cast<const float4*>(grid), static_cast<const float4*>(tmp), decay,
      density_threshold, n, tiles, slots,
      static_cast<unsigned long long*>(barrier), sums,
      reinterpret_cast<int*>(sums + tiles), static_cast<float4*>(grid_out),
      static_cast<uint4*>(bitfield), static_cast<float*>(mean_out));
  return static_cast<int>(cudaGetLastError());
}

// rows: (world, nbytes) bytes, out: nbytes bytes, both 16-byte aligned,
// nbytes a multiple of 16: out = the OR of the rows.
extern "C" int occ_union(const void* rows, int world, int nbytes, void* out,
                         cudaStream_t stream) {
  if (world < 1 || nbytes < 16 || nbytes % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = nbytes / 16;
  occ_union_kernel<<<ncn_blocks(cols, UNION_THREADS), UNION_THREADS, 0,
                     stream>>>(static_cast<const uint4*>(rows), world, cols,
                               static_cast<uint4*>(out));
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
