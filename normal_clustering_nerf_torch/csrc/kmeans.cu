// K7: spherical k-means over the depth normals and the Manhattan cluster
// selection, in one launch of a thread-block cluster.
//
// Replaces the JAX package's `spherical_kmeans` (normal_clustering_nerf_
// tpu/ops/kmeans.py:20-58: a (M, K) matmul and argmax, a segment sum and
// a renormalisation, iterated in a `lax.fori_loop`) and
// `normals_clustering` (:61-120: the biggest cluster, the most mutually
// orthogonal pair by the criteria matrix, the merging of similar clusters
// and the flipping of opposite ones, branch-free). The reference ran FAISS
// on the CPU every step (losses.py:86-93).
//
// Arithmetic, which the plain version (ops/kmeans.py) repeats with torch
// elementwise ops, so that the two agree bit for bit:
//  - a dot product is (a0 b0 + a1 b1) + a2 b2, each product and sum
//    rounded alone (--fmad=false); a row goes to the first cluster of the
//    largest dot product (NaN counts as the largest, as in torch.argmax);
//  - the rows are cut into BLOCKS contiguous ranges of P = ceil(M /
//    BLOCKS) rows (the last ones shorter or empty), block b's from row
//    b P. Block b's partial of cluster k: lane l adds the valid rows
//    b P + l, b P + l + 32, ... of its range assigned to k, in that order,
//    from +0.0; then an xor butterfly over offsets 16, 8, 4, 2, 1, each
//    lane adding the other lane's sum to its own; lane 0's result is the
//    partial. Cluster k's sum is ((0 + p_0) + p_1) + ... + p_{BLOCKS-1}.
//    No float atomics: a CUDA graph's replay equals the eager step bit
//    for bit;
//  - the norm is sqrtf((x x + y y) + z z), the centroid sums / norm (IEEE
//    division) where the norm exceeds 1e-12, else the old centroid.
//
// Bound on the H100: at the bench's shape (M 2730 rows, K 20, 20 rounds)
// the work is ~60 KB and ~7 M f32 operations, ~0.0001 ms; what sets the
// time is the chain of 21 rounds, each the M x K dot products and
// comparisons (~10 instructions a pair with every product and sum
// rounded alone), the sums and their exchange. One block on one SM ran
// them in ~7.4 us a round. Here one launch of a cluster of BLOCKS blocks
// of 1024 threads holds the whole loop, each block on its own SM with
// 1 / BLOCKS of the rows, the blocks joined by distributed shared memory:
//  - block b stages its range once in its shared memory as float4 (x, y,
//    z, valid), with a byte a row for its cluster, when the range and the
//    partials it receives fit in DYN_MAX bytes (~190 k rows a launch at K
//    20); past that the rows are read from global memory every round
//    (they stay in the L2) and the bytes go to a scratch buffer, in the
//    same order;
//  - the assignment gives a row G lanes (2 adjacent lanes of a warp where
//    each keeps at least 8 clusters and a block's rows fit its threads,
//    else 1), lane i scanning the clusters [i C, (i + 1) C), C = ceil(K /
//    G), with a strict > scan; the lanes meet by a shuffle over the total
//    order (value, NaN above every number; then the first cluster), so a
//    row's cluster is the serial scan's whatever G is. At the bench's
//    shape 2 lanes were the fastest of 1, 2, 4 and 8 on the H100. Past
//    THREADS rows a block a thread takes MANY rows at once, their chains
//    interleaved;
//  - warp w sums the clusters w, w + 32, ... over its block's rows into
//    the block's partials (shared memory, two copies by the round's
//    parity); then threads 0..BLOCKS-1 each copy them (one bulk copy,
//    K x 16 bytes) into row b of block t's received partials, completing
//    on block t's barrier of that parity, and every block waits on its own
//    barrier, adds the BLOCKS rows in block order and computes the same
//    new centroids into its own copy. No cluster barrier a round: at 8
//    blocks the floor of a round (8 rows, K 1) was 1.53 us with one and
//    the partials read over distributed shared memory after it, 1.26 us
//    with the copies (time_k7k8.py, H100). Round t + 2 reuses the parity
//    of round t; no block copies round t + 2 before its barrier of round
//    t + 1 has seen every block's copies, each made after that block's
//    reads of round t, and the barrier is armed for round t + 2 (its
//    bytes expected) right after its wait for round t;
//  - after the last assignment each block counts its valid rows a
//    cluster (integers), and every block reads the counts of all blocks
//    and runs the selection (redundantly, identically): cluster j on
//    thread j, the first-index minima by an xor butterfly within a warp
//    and then in warp order when K > 32; each cluster's label (0, +-1,
//    +-2, +-3) is worked out once, in the reference's overwrite order 1,
//    2, 3, -1, -2, -3, and a row of the block takes its cluster's label
//    when it is valid, else 0. K <= MAX_K (a row's cluster is a byte).
// BLOCKS is 16, past the portable 8: the H100 holds 7 such clusters at
// once (`kmeans_cluster_occupancy`; a launch is refused where the card
// holds none), and 16 measured faster than 8 (time_k7k8.py: 0.0584 ms
// against 0.0624 at the bench's shape, 0.614 against 1.011 at rotation
// recovery's). The order of the sums depends on BLOCKS.
#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCKS = 16;     // the cluster's blocks
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 256;
constexpr int DYN_MAX = 212992;   // dynamic shared memory a block: the
                                  // partials received, the rows, a byte
                                  // a row
constexpr int MAX_DEVICES = 64;   // cards a process sets K7 up on
constexpr int MANY = 3;        // rows a thread assigns at once, P > THREADS

struct Row {
  float x, y, z;
  bool valid;
};

// the block's rows, by their index j in its range
template <bool STAGED>
struct Rows {
  const float4* s;          // STAGED: (x, y, z, valid ? 1 : 0) a row
  const float* n;           // else the range's (P, 3) normals
  const uint8_t* v;         // and valid bytes
  __device__ __forceinline__ Row operator[](int j) const {
    if constexpr (STAGED) {
      const float4 q = s[j];
      return {q.x, q.y, q.z, q.w != 0.0f};
    } else {
      return {__ldg(n + 3 * j), __ldg(n + 3 * j + 1), __ldg(n + 3 * j + 2),
              __ldg(v + j) != 0};
    }
  }
};

__device__ __forceinline__ float dot3(float x, float y, float z,
                                      const float4& c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, c.x), __fmul_rn(y, c.y)),
                   __fmul_rn(z, c.z));
}

__device__ __forceinline__ float dot3(const float4& a, const float4& c) {
  return dot3(a.x, a.y, a.z, c);
}

// (v, k) comes before (w, l) in the assignment's order: NaN above every
// number, then the larger value, then the first cluster
__device__ __forceinline__ bool before(float v, int k, float w, int l) {
  const bool vn = v != v, wn = w != w;
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return k < l;
}

// The first index of the smallest v over the live threads of the first
// nw warps (index = threadIdx.x), in every thread of the block: an xor
// butterfly over (v, index) within each warp, then the warps' results in
// warp order. Every thread of the block calls it.
template <class T>
__device__ __forceinline__ int block_first_min(T v, bool live, int nw,
                                               T* s_v, int* s_i, T* out) {
  int idx = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    const bool ol = __shfl_xor_sync(FULL, static_cast<int>(live), o) != 0;
    if (ol && (!live || ov < v || (ov == v && oi < idx))) {
      v = ov;
      idx = oi;
      live = true;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && warp < nw) {
    s_v[warp] = v;
    s_i[warp] = live ? idx : -1;
  }
  __syncthreads();
  T bv = s_v[0];
  int bi = s_i[0];
  for (int w = 1; w < nw; ++w) {
    const T wv = s_v[w];
    const int wi = s_i[w];
    if (wi >= 0 && (bi < 0 || wv < bv)) {
      bv = wv;
      bi = wi;
    }
  }
  __syncthreads();
  *out = bv;
  return bi;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// address a of this block's shared memory in block `rank`'s
__device__ __forceinline__ uint32_t remote(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// arm barrier `bar` (count 1) for `bytes` of copies
__device__ __forceinline__ void expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` from this block's src to dst in another block of the cluster,
// completing on that block's barrier
__device__ __forceinline__ void copy_to(uint32_t dst, uint32_t src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait for the phase of barrier `bar` of this parity to complete; a wait
// that never ends (a fault) stops the kernel with an error instead of
// hanging the card.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
        " p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spin > (1ll << 24)) __trap();
  }
}

// cluster j joins the group of cluster ci
__device__ __forceinline__ bool joins(const float4* c, int ci, int j,
                                      bool merge, float t) {
  return merge ? dot3(c[ci], c[j]) > t : j == ci;
}

// The block's rows' clusters: G lanes a row (1 or 2), ROWS rows a thread
// at once; the clusters into asg (and into orig where it is given).
template <int G, int ROWS, bool STAGED>
__device__ __forceinline__ void assign(const Rows<STAGED>& rows, int n,
                                       const float4* c, int K, uint8_t* asg,
                                       long long* orig) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = (K + G - 1) / G;
  const int k0 = min((lane & (G - 1)) * C, K), k1 = min(k0 + C, K);
  const int tasks = n * G;
  for (int base = warp * 32; base < tasks; base += ROWS * THREADS) {
    Row q[ROWS];
    float bv[ROWS];
    int bi[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = base + i * THREADS + lane;
      q[i] = t < tasks ? rows[t / G] : Row{0.0f, 0.0f, 0.0f, false};
      bv[i] = __int_as_float(0xff800000);   // -inf: an empty run, last
      bi[i] = K;
    }
    if (k0 < K) {
      const float4 c0 = c[k0];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        bv[i] = dot3(q[i].x, q[i].y, q[i].z, c0);
        bi[i] = k0;
      }
    }
    for (int k = k0 + 1; k < k1; ++k) {
      const float4 ck = c[k];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float v = dot3(q[i].x, q[i].y, q[i].z, ck);
        if (v > bv[i] || (v != v && bv[i] == bv[i])) {
          bv[i] = v;
          bi[i] = k;
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float ov = __shfl_xor_sync(FULL, bv[i], o);
        const int oi = __shfl_xor_sync(FULL, bi[i], o);
        if (before(ov, oi, bv[i], bi[i])) {
          bv[i] = ov;
          bi[i] = oi;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = base + i * THREADS + lane;
      if ((lane & (G - 1)) == 0 && t < tasks) {
        asg[t / G] = static_cast<uint8_t>(bi[i]);
        if (orig != nullptr) orig[t / G] = bi[i];
      }
    }
  }
}

template <int G, int ROWS, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) kmeans_cluster_kernel(
    const float* __restrict__ normals, const uint8_t* __restrict__ valid,
    const long long* __restrict__ init_idx, int M, int K, int niter,
    float t_similar, int merge, int opposite, uint8_t* __restrict__ scratch,
    long long* __restrict__ assign_new, long long* __restrict__ assign_orig,
    float* __restrict__ centroids, float* __restrict__ centroids3) {
  extern __shared__ float4 s_dyn[];
  __shared__ float4 s_c[MAX_K];          // the centroids, every block's own
  __shared__ float4 s_part[2][MAX_K];    // the block's partials, by parity
  __shared__ uint64_t s_bar[2];          // the partials received, by parity
  __shared__ int s_size[MAX_K];          // its valid rows a cluster
  __shared__ int s_total[MAX_K];         // every block's
  __shared__ float s_a[MAX_K];           // |c1 . c_j|
  __shared__ int s_arg[MAX_K];           // each criteria column's argmin
  __shared__ int s_label[MAX_K];
  __shared__ float s_minf[WARPS];
  __shared__ int s_mini[WARPS], s_idx[WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = static_cast<int>(cluster.block_rank());
  const int P = (M + BLOCKS - 1) / BLOCKS;
  const int r0 = min(b * P, M), n = min(r0 + P, M) - r0;
  float4* s_recv = s_dyn;   // [parity][block][cluster]
  float4* s_rows = s_dyn + 2 * BLOCKS * K;
  const uint32_t tx = BLOCKS * K * sizeof(float4);
  uint8_t* asg = STAGED ? reinterpret_cast<uint8_t*>(s_rows + P)
                        : scratch + r0;
  if constexpr (STAGED) {
    for (int j = tid; j < n; j += THREADS) {
      const int r = r0 + j;
      s_rows[j] = make_float4(normals[3 * r], normals[3 * r + 1],
                              normals[3 * r + 2], valid[r] ? 1.0f : 0.0f);
    }
  }
  const Rows<STAGED> rows{s_rows, normals + 3 * static_cast<size_t>(r0),
                          valid + r0};
  if (tid < K) {
    const long long i = init_idx[tid];
    s_c[tid] = make_float4(normals[3 * i], normals[3 * i + 1],
                           normals[3 * i + 2], 0.0f);
  }
  if (tid < 2) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(s_bar + tid)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tid < niter) expect(smem_addr(s_bar + tid), tx);
  }
  cluster.sync();

  for (int it = 0;; ++it) {
    assign<G, ROWS, STAGED>(rows, n, s_c, K, asg,
                            it == niter ? assign_orig + r0 : nullptr);
    __syncthreads();
    if (it == niter) break;
    // the block's partials: lane l adds its valid member rows l, l + 32,
    // ... in that order
    float4* part = s_part[it & 1];
    for (int k = warp; k < K; k += WARPS) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        if (asg[j] == k) {
          const Row q = rows[j];
          if (q.valid) {
            sx = __fadd_rn(sx, q.x);
            sy = __fadd_rn(sy, q.y);
            sz = __fadd_rn(sz, q.z);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(FULL, sx, o));
        sy = __fadd_rn(sy, __shfl_xor_sync(FULL, sy, o));
        sz = __fadd_rn(sz, __shfl_xor_sync(FULL, sz, o));
      }
      if (lane == 0) {
        part[k] = make_float4(sx, sy, sz, 0.0f);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
    }
    __syncthreads();
    const int par = it & 1;
    if (tid < BLOCKS) {   // the partials into every block's row b
      copy_to(remote(smem_addr(s_recv + (par * BLOCKS + b) * K), tid),
              smem_addr(part), K * sizeof(float4),
              remote(smem_addr(s_bar + par), tid));
    }
    // every block: the sums in block order, the new centroids
    if (tid < K) {
      wait_parity(smem_addr(s_bar + par), (it >> 1) & 1);
      // round it + 2's bytes cannot come before this block's of it + 1
      if (tid == 0 && it + 2 < niter) expect(smem_addr(s_bar + par), tx);
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
      for (int r = 0; r < BLOCKS; ++r) {
        const float4 q = s_recv[(par * BLOCKS + r) * K + tid];
        sx = __fadd_rn(sx, q.x);
        sy = __fadd_rn(sy, q.y);
        sz = __fadd_rn(sz, q.z);
      }
      const float nrm = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
          __fmul_rn(sz, sz)));
      if (nrm > 1e-12f) {
        const float d = fmaxf(nrm, 1e-12f);
        s_c[tid] = make_float4(__fdiv_rn(sx, d), __fdiv_rn(sy, d),
                               __fdiv_rn(sz, d), 0.0f);
      }
    }
    __syncthreads();
  }

  // the block's valid rows a cluster, then every block's
  for (int k = warp; k < K; k += WARPS) {
    int cnt = 0;
    for (int j = lane; j < n; j += 32) cnt += asg[j] == k && rows[j].valid;
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0) s_size[k] = cnt;
  }
  cluster.sync();
  if (tid < K) {
    int total = 0;
#pragma unroll
    for (int r = 0; r < BLOCKS; ++r)
      total += *cluster.map_shared_rank(s_size + tid, r);
    s_total[tid] = total;
  }
  // no block leaves (or reuses s_size) before every block has read it
  cluster.sync();

  // the selection, thread j = cluster j
  const int nw = (K + 31) / 32;
  const int j = tid, jc = min(j, K - 1);
  const bool live = j < K;
  int neg;
  const int c1 = block_first_min(-s_total[jc], live, nw, s_mini, s_idx,
                                 &neg);
  const float a = fabsf(dot3(s_c[c1], s_c[jc]));
  if (live) s_a[j] = a;
  __syncthreads();
  // column j of the criteria matrix: its smallest entry, the first row i
  float best = 0.0f;
  int arg = 0;
  for (int i = 0; i < K; ++i) {
    const float v = __fadd_rn(__fadd_rn(s_a[i], a),
                              fabsf(dot3(s_c[i], s_c[jc])));
    if (i == 0 || v < best) {
      best = v;
      arg = i;
    }
  }
  if (live) s_arg[j] = arg;
  float bmin;
  const int c2 = block_first_min(best, live, nw, s_minf, s_idx, &bmin);
  const int c3 = s_arg[c2];
  const int cs[3] = {c1, c2, c3};
  int label = 0;
#pragma unroll
  for (int g = 0; g < 3; ++g)
    if (joins(s_c, cs[g], jc, merge, t_similar)) label = g + 1;
  if (opposite) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float s = dot3(s_c[cs[g]], s_c[jc]);
      float so;
      const int o = block_first_min(s, live, nw, s_minf, s_idx, &so);
      if (-so > t_similar && joins(s_c, o, jc, merge, t_similar))
        label = -(g + 1);
    }
  }
  if (live) s_label[j] = label;
  if (b == 0 && j < 9) {
    const float4 c = s_c[j < 3 ? c1 : j < 6 ? c2 : c3];
    centroids3[j] = j % 3 == 0 ? c.x : j % 3 == 1 ? c.y : c.z;
  }
  __syncthreads();
  for (int i = tid; i < n; i += THREADS)
    assign_new[r0 + i] = rows[i].valid ? s_label[asg[i]] : 0;
  if (b == 0 && tid < 3 * K) {
    const float4 c = s_c[tid / 3];
    centroids[tid] = tid % 3 == 0 ? c.x : tid % 3 == 1 ? c.y : c.z;
  }
}

// the launch configuration: one cluster of BLOCKS blocks
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Config(size_t smem, cudaStream_t stream) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = BLOCKS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(BLOCKS);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The kernel's attributes (DYN_MAX bytes of dynamic shared memory, a
// cluster past 8 blocks), then how many of its clusters at DYN_MAX bytes
// the card holds at once.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  Config c(DYN_MAX, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &c.cfg);
}

template <int G, int ROWS, bool STAGED>
cudaError_t launch(size_t smem, cudaStream_t stream,
                   const float* n, const uint8_t* v, const long long* init,
                   int M, int K, int niter, float t_similar, int merge,
                   int opposite, uint8_t* s, long long* an, long long* ao,
                   float* c, float* c3) {
  const auto kernel = kmeans_cluster_kernel<G, ROWS, STAGED>;
  // once a kernel and a device, at its first (eager) launch there: never
  // under a graph capture that follows (0 unset, 1 ready, else 2 + error)
  static std::atomic<int> state[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (state[dev].load() == 0) {
    int clusters = 0;
    e = occupancy(kernel, &clusters);
    if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
    state[dev].store(e == cudaSuccess ? 1 : 2 + static_cast<int>(e));
  }
  if (state[dev].load() != 1)
    return static_cast<cudaError_t>(state[dev].load() - 2);
  Config config(smem, stream);
  return cudaLaunchKernelEx(&config.cfg, kernel, n, v, init, M, K, niter,
                            t_similar, merge, opposite, s, an, ao, c, c3);
}

}  // namespace

// How many of K7's clusters (BLOCKS blocks of THREADS threads, DYN_MAX
// bytes of dynamic shared memory each) the current card holds at once.
extern "C" int kmeans_cluster_occupancy(int* clusters) {
  return static_cast<int>(
      occupancy(kmeans_cluster_kernel<1, 1, true>, clusters));
}

// normals (M, 3) f32, valid (M,) bool, init_idx (K,) int64 row indices;
// merge / opposite: 0 or 1. scratch: M bytes, used (and needed) only when
// a block's range and its received partials do not fit in its shared
// memory. Outputs: assign_new and assign_orig (M,) int64, centroids (K, 3)
// and centroids3 (3, 3) f32.
extern "C" int kmeans_cluster(const void* normals, const void* valid,
                              const void* init_idx, int M, int K, int niter,
                              float t_similar, int merge, int opposite,
                              void* scratch, void* assign_new,
                              void* assign_orig, void* centroids,
                              void* centroids3, cudaStream_t stream) {
  const int P = (M + BLOCKS - 1) / BLOCKS;
  const size_t recv = 2 * BLOCKS * sizeof(float4) * static_cast<size_t>(K);
  const size_t smem = recv + static_cast<size_t>(P) * (sizeof(float4) + 1);
  const bool staged = smem <= DYN_MAX;
  if (M < 1 || K < 1 || K > MAX_K || niter < 0 ||
      (!staged && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* n = static_cast<const float*>(normals);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* init = static_cast<const long long*>(init_idx);
  auto* s = static_cast<uint8_t*>(scratch);
  auto* an = static_cast<long long*>(assign_new);
  auto* ao = static_cast<long long*>(assign_orig);
  auto* c = static_cast<float*>(centroids);
  auto* c3 = static_cast<float*>(centroids3);
  cudaError_t e;
  if (!staged)   // a lane a row, MANY rows a thread, rows from memory
    e = launch<1, MANY, false>(recv, stream, n, v, init, M, K, niter,
                               t_similar, merge, opposite, s, an, ao, c, c3);
  else if (P > THREADS)
    e = launch<1, MANY, true>(smem, stream, n, v, init, M, K, niter,
                              t_similar, merge, opposite, s, an, ao, c, c3);
  else if (K >= 16 && 2 * P <= THREADS)
    e = launch<2, 1, true>(smem, stream, n, v, init, M, K, niter, t_similar,
                           merge, opposite, s, an, ao, c, c3);
  else
    e = launch<1, 1, true>(smem, stream, n, v, init, M, K, niter, t_similar,
                           merge, opposite, s, an, ao, c, c3);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
