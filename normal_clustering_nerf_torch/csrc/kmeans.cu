// K7: spherical k-means over the depth normals and the Manhattan cluster
// selection, in one launch.
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
//    largest (a strict > scan, torch.argmax's first index; NaN counts as
//    the largest, as there);
//  - cluster k's sum: lane l of warp k adds the valid rows l, l + 32, ...
//    assigned to k, in that order, from +0.0; then an xor butterfly over
//    offsets 16, 8, 4, 2, 1, each lane adding the other lane's sum to its
//    own; lane 0's result is the sum. No float atomics: a CUDA graph's
//    replay equals the eager step bit for bit;
//  - the norm is sqrtf((x x + y y) + z z), the centroid sums / norm (IEEE
//    division) where the norm exceeds 1e-12, else the old centroid.
// The selection runs on warp 0, a lane a cluster; each cluster's new label
// (0, +-1, +-2, +-3) is worked out once, in the reference's overwrite
// order 1, 2, 3, -1, -2, -3, and a row takes its cluster's label when it
// is valid, else 0.
//
// Bound on the H100: at the bench's shape (M 2730 rows, K 20, 20 rounds)
// the work is ~60 KB and ~7 M f32 operations, ~0.0001 ms; what sets the
// time is one SM's instructions over 21 rounds of M x K dot products and
// comparisons (~10 a pair with every product and sum rounded alone) and
// the chain of the rounds, each two block barriers. One persistent block
// of 1024 threads holds the whole loop: the rows (x, y, z, valid: 16
// bytes) are staged once in shared memory when M <= STAGE_ROWS, else read
// from global memory each round (they stay in the L2); the centroids live
// in shared memory. A thread takes up to ROWS rows at once (rows 32 j +
// lane of the warp's row groups j), each centroid read once for all of
// them, their comparison chains interleaved. Each row group publishes,
// for each cluster k, the mask of its valid rows in k (`masks[j][k]`,
// from six ballots: the valid rows and the five bits of the cluster
// index); warp k then walks its masks and a lane adds its row where its
// bit is set, so that no warp scans the rows of other clusters. The
// masks (and, for the last round's labels, a byte a row) are in shared
// memory with the rows, else in a buffer the wrapper gives. K <= 32: a
// warp a cluster.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_K = 32;
constexpr int STAGE_ROWS = 10240;   // 16 + 1 + 4 (masks) bytes a row
constexpr int ROWS = 3;   // rows a thread assigns at once

struct Row {
  float x, y, z;
  bool valid;
};

template <bool STAGED>
struct Rows {
  const float4* s;          // STAGED: (x, y, z, valid ? 1 : 0) a row
  const float* n;           // else the (M, 3) normals
  const uint8_t* v;         // and the valid bytes
  __device__ __forceinline__ Row operator[](int r) const {
    if constexpr (STAGED) {
      const float4 q = s[r];
      return {q.x, q.y, q.z, q.w != 0.0f};
    } else {
      return {__ldg(n + 3 * r), __ldg(n + 3 * r + 1), __ldg(n + 3 * r + 2),
              __ldg(v + r) != 0};
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

// the first cluster of the largest dot product with each row
__device__ __forceinline__ void nearest(const Row (&q)[ROWS],
                                        const float4* c, int K,
                                        int (&best)[ROWS]) {
  float bv[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    bv[i] = dot3(q[i].x, q[i].y, q[i].z, c[0]);
    best[i] = 0;
  }
  for (int k = 1; k < K; ++k) {
    const float4 ck = c[k];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float v = dot3(q[i].x, q[i].y, q[i].z, ck);
      if (v > bv[i] || (v != v && bv[i] == bv[i])) {
        bv[i] = v;
        best[i] = k;
      }
    }
  }
}

// The lane < K of the smallest v, the first on a tie, in every lane of
// the warp (an xor butterfly over a total order: v, then the lane).
template <class T>
__device__ __forceinline__ int first_min(T v, int K) {
  int idx = threadIdx.x & 31;
  bool live = idx < K;
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
  return idx;
}

// cluster j (the lane) joins the group of cluster ci
__device__ __forceinline__ bool joins(const float4* c, int ci, int j,
                                      bool merge, float t) {
  return merge ? dot3(c[ci], c[j]) > t : j == ci;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1) kmeans_cluster_kernel(
    const float* __restrict__ normals, const uint8_t* __restrict__ valid,
    const long long* __restrict__ init_idx, int M, int K, int niter,
    float t_similar, int merge, int opposite, uint8_t* __restrict__ scratch,
    long long* __restrict__ assign_new, long long* __restrict__ assign_orig,
    float* __restrict__ centroids, float* __restrict__ centroids3) {
  extern __shared__ float4 s_rows[];
  __shared__ float4 s_c[MAX_K];
  __shared__ int s_label[MAX_K];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = (M + 31) / 32;   // row groups
  // [masks: 32 words a row group, word k cluster k's][a byte a row]
  unsigned* masks = STAGED ? reinterpret_cast<unsigned*>(s_rows + M)
                           : reinterpret_cast<unsigned*>(scratch);
  uint8_t* asg = reinterpret_cast<uint8_t*>(masks + 32 * R);
  if constexpr (STAGED) {
    for (int r = tid; r < M; r += THREADS)
      s_rows[r] = make_float4(normals[3 * r], normals[3 * r + 1],
                              normals[3 * r + 2], valid[r] ? 1.0f : 0.0f);
  }
  const Rows<STAGED> rows{s_rows, normals, valid};
  if (tid < K) {
    const long long i = init_idx[tid];
    s_c[tid] = make_float4(normals[3 * i], normals[3 * i + 1],
                           normals[3 * i + 2], 0.0f);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    // assignment: warp w takes the row groups w, w + 32, ..., ROWS at once
    for (int r0 = warp * 32; r0 < M; r0 += ROWS * THREADS) {
      Row q[ROWS];
      int a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i * THREADS + lane;
        q[i] = r < M ? rows[r] : Row{0.0f, 0.0f, 0.0f, false};
      }
      nearest(q, s_c, K, a);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int g0 = r0 + i * THREADS;   // the group's first row
        if (g0 >= M) break;
        const int r = g0 + lane;
        if (it == niter && r < M) {
          asg[r] = static_cast<uint8_t>(a[i]);
          assign_orig[r] = a[i];
        }
        // lane k: the group's valid rows whose cluster's bits are k's
        unsigned m = __ballot_sync(FULL, q[i].valid);
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          const unsigned bb = __ballot_sync(FULL, (a[i] >> b) & 1);
          m &= (lane >> b) & 1 ? bb : ~bb;
        }
        masks[32 * (g0 / 32) + lane] = m;
      }
    }
    __syncthreads();
    if (it == niter) break;
    // cluster `warp`'s sums and new centroid: lane l adds its valid member
    // rows l, l + 32, ... in that order
    if (warp < K) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll 4
      for (int j = 0; j < R; ++j) {
        if ((masks[32 * j + warp] >> lane) & 1u) {
          const Row q = rows[32 * j + lane];
          sx = __fadd_rn(sx, q.x);
          sy = __fadd_rn(sy, q.y);
          sz = __fadd_rn(sz, q.z);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(FULL, sx, o));
        sy = __fadd_rn(sy, __shfl_xor_sync(FULL, sy, o));
        sz = __fadd_rn(sz, __shfl_xor_sync(FULL, sz, o));
      }
      if (lane == 0) {
        const float nrm = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
            __fmul_rn(sz, sz)));
        if (nrm > 1e-12f) {
          const float d = fmaxf(nrm, 1e-12f);
          s_c[warp] = make_float4(__fdiv_rn(sx, d), __fdiv_rn(sy, d),
                                  __fdiv_rn(sz, d), 0.0f);
        }
      }
    }
    __syncthreads();
  }

  // the selection, lane j = cluster j
  if (warp == 0) {
    const int j = lane, jc = min(j, K - 1);
    int size = 0;   // the valid rows of cluster jc
    for (int i = 0; i < R; ++i) size += __popc(masks[32 * i + jc]);
    const int c1 = first_min(-size, K);
    const float a = fabsf(dot3(s_c[c1], s_c[jc]));
    // column j of the criteria matrix: its smallest entry, the first row i
    float best = 0.0f;
    int arg = 0;
    for (int i = 0; i < K; ++i) {
      const float ai = __shfl_sync(FULL, a, i);
      const float v = __fadd_rn(__fadd_rn(ai, a),
                                fabsf(dot3(s_c[i], s_c[jc])));
      if (i == 0 || v < best) {
        best = v;
        arg = i;
      }
    }
    const int c2 = first_min(best, K);
    const int c3 = __shfl_sync(FULL, arg, c2);
    const int cs[3] = {c1, c2, c3};
    int label = 0;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      if (joins(s_c, cs[g], jc, merge, t_similar)) label = g + 1;
    if (opposite) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float s = dot3(s_c[cs[g]], s_c[jc]);
        const int o = first_min(s, K);
        const float so = __shfl_sync(FULL, s, o);
        if (-so > t_similar && joins(s_c, o, jc, merge, t_similar))
          label = -(g + 1);
      }
    }
    if (j < K) s_label[j] = label;
    if (j < 9) {
      const float4 c = s_c[cs[j / 3]];
      centroids3[j] = j % 3 == 0 ? c.x : j % 3 == 1 ? c.y : c.z;
    }
  }
  __syncthreads();
  for (int r = tid; r < M; r += THREADS)
    assign_new[r] = rows[r].valid ? s_label[asg[r]] : 0;
  if (tid < 3 * K) {
    const float4 c = s_c[tid / 3];
    centroids[tid] = tid % 3 == 0 ? c.x : tid % 3 == 1 ? c.y : c.z;
  }
}

}  // namespace

// normals (M, 3) f32, valid (M,) bool, init_idx (K,) int64 row indices;
// merge / opposite: 0 or 1. scratch: 128 ceil(M / 32) + M bytes, 4-byte
// aligned, used (and needed) only when M > STAGE_ROWS. Outputs:
// assign_new and assign_orig (M,) int64, centroids (K, 3) and centroids3
// (3, 3) f32.
extern "C" int kmeans_cluster(const void* normals, const void* valid,
                              const void* init_idx, int M, int K, int niter,
                              float t_similar, int merge, int opposite,
                              void* scratch, void* assign_new,
                              void* assign_orig, void* centroids,
                              void* centroids3, cudaStream_t stream) {
  if (M < 1 || K < 1 || K > MAX_K || niter < 0 ||
      (M > STAGE_ROWS &&
       (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 3))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* n = static_cast<const float*>(normals);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* init = static_cast<const long long*>(init_idx);
  auto* s = static_cast<uint8_t*>(scratch);
  auto* an = static_cast<long long*>(assign_new);
  auto* ao = static_cast<long long*>(assign_orig);
  auto* c = static_cast<float*>(centroids);
  auto* c3 = static_cast<float*>(centroids3);
  if (M <= STAGE_ROWS) {
    const auto kernel = kmeans_cluster_kernel<true>;
    const size_t smem = static_cast<size_t>(M) * (sizeof(float4) + 1) +
                        128 * static_cast<size_t>((M + 31) / 32);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<1, THREADS, smem, stream>>>(n, v, init, M, K, niter, t_similar,
                                         merge, opposite, s, an, ao, c, c3);
  } else {
    kmeans_cluster_kernel<false><<<1, THREADS, 0, stream>>>(
        n, v, init, M, K, niter, t_similar, merge, opposite, s, an, ao, c,
        c3);
  }
  return static_cast<int>(cudaGetLastError());
}
