// K10: the loss block, the terms of the JAX package's compute_losses that
// the bench configuration runs, with their gradient, in three launches
// besides K7 (csrc/kmeans.cu) and H4 (csrc/distortion.cu):
//
// Replaces the port's torch chain of normal_clustering_nerf_tpu/losses.py:
// 189-364 `compute_losses` (rgb, opacity, distortion, sem) and :94-186
// `_clustering_losses` (ort, centr_dot, centr_L1, the canonical-axis
// snapping, discard_far_members) on the depth normals of
// datasets/normals.py `extract_normals_from_ray_batch`: jnp code that XLA
// fuses into a few programs on the TPU, and that the port ran as several
// hundred elementwise torch launches a step, forward and backward. Nothing
// here reads the host, and no float atomics are used: a CUDA graph's
// replay equals the eager step bit for bit.
//
//  loss_rays      an item a thread: triangle i's depth normal (P = o + d
//                 depth at x1, x2, x3; the cross product of P2 - P1 and
//                 P3 - P1; the double-where normalisation), its valid flag
//                 and its row zeroed where invalid (K7's input); ray i's
//                 squared rgb error, opacity entropy, distortion,
//                 cross-entropy and its valid flag, each summed over the
//                 block in a fixed tree into the block's slot;
//  loss_clusters  one block of 1024 threads, after K7: the slots added in
//                 a fixed order, the flip and the membership (with the
//                 member discard), the member counts and sums, the
//                 centroids c_g = normalize(mean_g), a second sweep for
//                 the dot and L1 sums and the signs of (member - c_g), the
//                 terms with the schedule's weights and window (read here,
//                 on the device), their finite guards, the terms' vector
//                 and total, and what loss_bwd reads (SAVED floats and a
//                 code a row);
//  loss_bwd       an item a thread: each block first derives the scalars
//                 of the terms' gradient (every block the same), then ray
//                 i's d rgb, d opacity, d dl and d sem, and, through the
//                 triangles of its row of the ray -> (triangle, vertex)
//                 table in order (each triangle's forward recomputed bit
//                 for bit), d depth and, when asked, d rays_o and d
//                 rays_d.
//
// Arithmetic (--fmad=false; every product, sum, division and square root
// rounded alone, IEEE), which the plain version (ops/loss_block.py)
// repeats with torch elementwise ops: the normals bit for bit (so K7's
// assignment does not move), the block sums in the trees of `tree_sum`
// and `strided_sum` (xor halvings over a warp's lanes, then over the warp
// sums), the cross-entropy's classes and the snapping's 18 conditions in
// order.
//
// Bound on the H100: bytes, and far under one launch's floor. At the
// bench's 8190 rays and 2730 triangles the block reads ~150 B a ray
// (rgb, target, opacity, dl, three logits, a label, depth, o, d) and
// writes as much in the backward: ~2.5 MB, 0.0007 ms at 3.35 TB/s. The
// design takes the block from several hundred launches to three; a
// simple kernel that is right first (one block for the clusters, the
// triangles' forward recomputed in the backward).
#include "common.cuh"

namespace {

constexpr int RAY_THREADS = 256;
constexpr int RAY_WARPS = RAY_THREADS / 32;
constexpr int CL_THREADS = 1024;
constexpr int NQ = 5;
constexpr int NTERMS = 9;
enum { RGB, OPAC, DIST, ORT, CDOT, CL1, CANDOT, CANL1, SEM };
enum { Q_RGB, Q_ENT, Q_DL, Q_CE, Q_CNT };
enum {
  S_F = 0, S_DEN = 9, S_K = 12, S_C = 15, S_S = 24, S_R = 33, S_SG = 36,
  S_SD = 45, S_COND = 48, S_NCOND = 66, SAVED = 67
};

// ops/loss_block.py builds the same struct with ctypes (_Args)
struct Args {
  const float* rgb;       // (N, 3) rows rgb_stride apart
  const float* trgb;      // (n, 3) rows trgb_stride apart
  const float* op;        // (N,)
  const float* dl;        // (N,) or null
  const float* sem;       // (N, C) rows sem_stride apart, or null
  const void* labels;     // (n,) int32 or int64 (labels64)
  const float* depth;     // (N,)
  const float* rays_o;    // (N, 3)
  const float* rays_d;    // (N, 3)
  const long long* x1;    // (T,) rays of the triangles, from unsup
  const long long* x2;
  const long long* x3;
  const int* table;       // (N - unsup, table_w): 3 t + vertex, -1 past
  const long long* assign;   // K7's assign_new (T,)
  const float* cent3;        // K7's centroids3 (3, 3)
  const float* w_ort;        // the schedule's weights (0-dim f32)
  const float* w_cdot;
  const float* w_cl1;
  const float* w_candot;
  const float* w_canl1;
  const float* in_window;
  float* nm;                 // (T, 3) normals zeroed where invalid
  bool* valid;               // (T,)
  float* slots;              // (blocks, NQ)
  float* terms;              // (terms,)
  float* total;
  float* mse;
  float* saved;              // (SAVED,)
  signed char* member;       // (T,) +-(g + 1), 0 for none
  const float* g_terms;      // cotangents: (terms,) or null
  const float* g_total;      // 0-dim or null
  float* d_rgb;              // (N, 3)   each output null where not asked
  float* d_op;               // (N,)
  float* d_dl;               // (N,)
  float* d_sem;              // (N, C)
  float* d_depth;            // (N,)
  float* d_o;                // (N, 3)
  float* d_d;                // (N, 3)
  int rgb_stride, trgb_stride, sem_stride, labels64;
  int n_sup, n_rays, unsup, n_tri, n_cls, table_w, blocks;
  int discard, snap, clustering;
  int pos[NTERMS];           // each term's place in `terms`, -1 absent
  float w_op, w_dist, w_sem, tres, tres3;
};
static_assert(sizeof(Args) == 416, "ops/loss_block.py's _Args");

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>(x > 0.0f) - static_cast<float>(x < 0.0f);
}
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return V3{fs(a.x, b.x), fs(a.y, b.y), fs(a.z, b.z)};
}
__device__ __forceinline__ V3 neg3(V3 a) { return V3{-a.x, -a.y, -a.z}; }
// (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fa(fa(fm(a.x, b.x), fm(a.y, b.y)), fm(a.z, b.z));
}
// a x b as torch.linalg.cross and jnp.cross write it
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{fs(fm(a.y, b.z), fm(a.z, b.y)), fs(fm(a.z, b.x), fm(a.x, b.z)),
            fs(fm(a.x, b.y), fm(a.y, b.x))};
}
__device__ __forceinline__ float comp(V3 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}

// triangle t of the clustering rays: its edges, the norm of a x b (1 where
// |a x b|^2 <= 1e-12) and the unit normal (0 there)
struct Tri {
  V3 a, b, n;
  float r;
};
__device__ __forceinline__ V3 point(const Args& A, long long i) {
  const float dep = A.depth[i];
  const V3 o = load3(A.rays_o, i), d = load3(A.rays_d, i);
  return V3{fa(o.x, fm(d.x, dep)), fa(o.y, fm(d.y, dep)),
            fa(o.z, fm(d.z, dep))};
}
__device__ Tri triangle(const Args& A, int t) {
  const V3 P1 = point(A, A.unsup + A.x1[t]);
  const V3 P2 = point(A, A.unsup + A.x2[t]);
  const V3 P3 = point(A, A.unsup + A.x3[t]);
  Tri T;
  T.a = sub3(P2, P1);
  T.b = sub3(P3, P1);
  const V3 v = cross3(T.a, T.b);
  const float sq = dot3(v, v);
  const bool ok = sq > 1e-12f;
  T.r = __fsqrt_rn(ok ? sq : 1.0f);
  T.n = ok ? V3{fd(v.x, T.r), fd(v.y, T.r), fd(v.z, T.r)}
           : V3{0.0f, 0.0f, 0.0f};
  return T;
}
__device__ __forceinline__ bool valid_normal(V3 n) {
  return finite(n.x) && finite(n.y) && finite(n.z) &&
         fa(fa(fabsf(n.x), fabsf(n.y)), fabsf(n.z)) != 0.0f;
}

__device__ __forceinline__ int label_of(const Args& A, int i) {
  return A.labels64 ? static_cast<int>(
                          static_cast<const long long*>(A.labels)[i])
                    : static_cast<const int*>(A.labels)[i];
}

// row i's logits: x - max (NaN where any is NaN) and the log of the sum of
// exp(x - max), the classes in order
__device__ __forceinline__ float log_sum(const float* x, int C, float& m) {
  m = x[0];
  for (int c = 1; c < C; ++c)
    if (x[c] > m || x[c] != x[c]) m = x[c];
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s = fa(s, expf(fs(x[c], m)));
  return logf(s);
}

// The sum of every thread's v[k] in the block's tree, into out[k] (read
// after the barrier inside): xor halvings 16..1 over the lanes, lane 0's
// sum at s_red[k][warp], then warp k halves the warp sums the same way.
template <int K, int THREADS>
__device__ __forceinline__ void block_sums(float (&v)[K], float* s_red,
                                           float* out) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = fa(s, __shfl_xor_sync(FULL, s, o));
    if (lane == 0) s_red[k * 32 + warp] = s;
  }
  __syncthreads();
  for (int k = warp; k < K; k += WARPS) {
    float w = lane < WARPS ? s_red[k * 32 + lane] : 0.0f;
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1)
      w = fa(w, __shfl_xor_sync(FULL, w, o));
    if (lane == 0) out[k] = w;
  }
  __syncthreads();
}

// ------------------------------------------------------------ loss_rays
__global__ void __launch_bounds__(RAY_THREADS)
    loss_rays_kernel(const __grid_constant__ Args A) {
  __shared__ float s_red[NQ * 32];
  __shared__ float s_out[NQ];
  const int i = blockIdx.x * RAY_THREADS + threadIdx.x;
  if (i < A.n_tri) {
    const V3 n = triangle(A, i).n;
    const bool ok = valid_normal(n);
    store3(A.nm, i, ok ? n : V3{0.0f, 0.0f, 0.0f});
    A.valid[i] = ok;
  }
  float q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < A.n_sup) {
    const float* r = A.rgb + static_cast<long long>(i) * A.rgb_stride;
    const float* t = A.trgb + static_cast<long long>(i) * A.trgb_stride;
    const V3 e = V3{fs(r[0], t[0]), fs(r[1], t[1]), fs(r[2], t[2])};
    q[Q_RGB] = dot3(e, e);
    if (A.n_cls) {
      const float* x = A.sem + static_cast<long long>(i) * A.sem_stride;
      const int lab = label_of(A, i) - 1;
      const int lc = min(max(lab, 0), A.n_cls - 1);
      float m;
      const float lse = log_sum(x, A.n_cls, m);
      float acc = 0.0f;
      for (int c = 0; c < A.n_cls; ++c)
        acc = fa(acc, fm(c == lc ? 1.0f : 0.0f, fs(fs(x[c], m), lse)));
      q[Q_CE] = lab >= 0 ? -acc : 0.0f;
      q[Q_CNT] = lab >= 0 ? 1.0f : 0.0f;
    }
  }
  if (i < A.n_rays) {
    const float o = fa(A.op[i], 1e-10f);
    q[Q_ENT] = fm(-o, logf(o));
    if (A.dl) q[Q_DL] = A.dl[i];
  }
  block_sums<NQ, RAY_THREADS>(q, s_red, s_out);
  if (threadIdx.x < NQ) A.slots[blockIdx.x * NQ + threadIdx.x] = s_out[threadIdx.x];
}

// ------------------------------------------------------------ loss_clusters
__device__ __forceinline__ V3 flipped(V3 n, int code) {
  return code < 0 ? neg3(n) : n;
}

__global__ void __launch_bounds__(CL_THREADS)
    loss_clusters_kernel(const __grid_constant__ Args A) {
  __shared__ float s_red[15 * 32];
  __shared__ float s_sum[15];
  const int tid = threadIdx.x;
  float sv[SAVED];
  float val[NTERMS], fac[NTERMS];
#pragma unroll
  for (int j = 0; j < NTERMS; ++j) val[j] = fac[j] = 0.0f;
  // the rays' sums
  float q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = tid; b < A.blocks; b += CL_THREADS)
#pragma unroll
    for (int k = 0; k < NQ; ++k) q[k] = fa(q[k], A.slots[b * NQ + k]);
  block_sums<NQ, CL_THREADS>(q, s_red, s_sum);
  float ray[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) ray[k] = s_sum[k];
  if (tid == 0)
    for (int k = 0; k < SAVED; ++k) sv[k] = 0.0f;
  const float den_rgb = static_cast<float>(3 * A.n_sup);
  const float den_n = static_cast<float>(A.n_rays);
  const float den_sem = fmaxf(ray[Q_CNT], 1e-12f);
  const float mse = fd(ray[Q_RGB], den_rgb);
  val[RGB] = mse;
  fac[RGB] = 1.0f;
  val[OPAC] = fm(A.w_op, fd(ray[Q_ENT], den_n));
  fac[OPAC] = A.w_op;
  val[DIST] = fm(A.w_dist, fd(ray[Q_DL], den_n));
  fac[DIST] = A.w_dist;
  val[SEM] = fm(A.w_sem, fd(ray[Q_CE], den_sem));
  fac[SEM] = A.w_sem;
  if (tid == 0) {
    sv[S_DEN] = den_rgb;
    sv[S_DEN + 1] = den_n;
    sv[S_DEN + 2] = den_sem;
  }
  if (A.clustering) {
    // sweep 1: the flip, the membership, counts and member sums
    float v1[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) v1[k] = 0.0f;
    for (int r = tid; r < A.n_tri; r += CL_THREADS) {
      const long long a = A.assign[r];
      const int g = static_cast<int>(a < 0 ? -a : a);
      const V3 nf = flipped(load3(A.nm, r), a < 0 ? -1 : 1);
      bool keep = g >= 1 && g <= 3;
      if (A.discard && keep)
        keep = fs(1.0f, dot3(nf, load3(A.cent3, g - 1))) <= A.tres;
      A.member[r] = static_cast<signed char>(keep ? (a < 0 ? -g : g) : 0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const bool m = keep && g == j + 1;
        v1[4 * j] = fa(v1[4 * j], m ? 1.0f : 0.0f);
        v1[4 * j + 1] = fa(v1[4 * j + 1], m ? nf.x : 0.0f);
        v1[4 * j + 2] = fa(v1[4 * j + 2], m ? nf.y : 0.0f);
        v1[4 * j + 3] = fa(v1[4 * j + 3], m ? nf.z : 0.0f);
      }
    }
    block_sums<12, CL_THREADS>(v1, s_red, s_sum);
    float cnt[3], k[3], r[3];
    V3 S[3], c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cnt[j] = s_sum[4 * j];
      S[j] = V3{s_sum[4 * j + 1], s_sum[4 * j + 2], s_sum[4 * j + 3]};
      k[j] = fmaxf(cnt[j], 1.0f);
      const V3 m = V3{fd(S[j].x, k[j]), fd(S[j].y, k[j]), fd(S[j].z, k[j])};
      const float sq = dot3(m, m);
      const bool ok = sq > 1e-12f;
      const float rr = __fsqrt_rn(ok ? sq : 1.0f);
      c[j] = ok ? V3{fd(m.x, rr), fd(m.y, rr), fd(m.z, rr)}
                : V3{0.0f, 0.0f, 0.0f};
      r[j] = ok ? rr : 0.0f;
    }
    __syncthreads();   // s_sum is read again below
    // sweep 2: dot and L1 sums, signs of (member - c_g)
    float v2[15];
#pragma unroll
    for (int kk = 0; kk < 15; ++kk) v2[kk] = 0.0f;
    for (int row = tid; row < A.n_tri; row += CL_THREADS) {
      const int code = A.member[row];
      const int g = code < 0 ? -code : code;
      const V3 nf = flipped(load3(A.nm, row), code);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const bool m = g == j + 1;
        const V3 d = sub3(nf, c[j]);
        v2[5 * j] = fa(v2[5 * j], m ? dot3(nf, c[j]) : 0.0f);
        v2[5 * j + 1] = fa(v2[5 * j + 1],
                           m ? fa(fa(fabsf(d.x), fabsf(d.y)), fabsf(d.z))
                             : 0.0f);
        v2[5 * j + 2] = fa(v2[5 * j + 2], m ? sgn(d.x) : 0.0f);
        v2[5 * j + 3] = fa(v2[5 * j + 3], m ? sgn(d.y) : 0.0f);
        v2[5 * j + 4] = fa(v2[5 * j + 4], m ? sgn(d.z) : 0.0f);
      }
    }
    block_sums<15, CL_THREADS>(v2, s_red, s_sum);
    const float three = 3.0f;
    const float d12 = dot3(c[0], c[1]), d13 = dot3(c[0], c[2]),
                d23 = dot3(c[1], c[2]);
    const float ort = fd(fa(fa(fabsf(d12), fabsf(d13)), fabsf(d23)), three);
    const float cd =
        fd(fa(fa(fs(1.0f, fd(s_sum[0], k[0])), fs(1.0f, fd(s_sum[5], k[1]))),
              fs(1.0f, fd(s_sum[10], k[2]))),
           three);
    const float cl1 = fd(fa(fa(fd(s_sum[1], k[0]), fd(s_sum[6], k[1])),
                            fd(s_sum[11], k[2])),
                         three);
    const bool ok = cnt[0] > 0.0f && cnt[1] > 0.0f && cnt[2] > 0.0f;
    float raw[NTERMS];
    bool on[NTERMS];
    raw[ORT] = ort;
    raw[CDOT] = cd;
    raw[CL1] = cl1;
    on[ORT] = on[CDOT] = on[CL1] = ok;
    on[CANDOT] = on[CANL1] = false;
    raw[CANDOT] = raw[CANL1] = 0.0f;
    float cond[18];
    float nc = 1.0f;
    if (A.snap) {
      float acc_d = 0.0f, acc_l = 0.0f, acc_n = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int ax = i / 2;
          const float canv = i % 2 == 0 ? 1.0f : -1.0f;
          const float dot = i % 2 == 0 ? comp(c[j], ax) : -comp(c[j], ax);
          const bool cn = fs(1.0f, dot) < A.tres3;
          const float cf = cn ? 1.0f : 0.0f;
          float l1 = 0.0f;
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            const float cx = x == ax ? canv : 0.0f;
            const float t = fabsf(fs(comp(c[j], x), cx));
            l1 = x == 0 ? t : fa(l1, t);
          }
          acc_d = fa(acc_d, fm(dot, cf));
          acc_l = fa(acc_l, fm(l1, cf));
          acc_n = fa(acc_n, cf);
          cond[6 * j + i] = cf;
        }
      nc = fmaxf(acc_n, 1.0f);
      on[CANDOT] = on[CANL1] = ok && acc_n > 0.0f;
      raw[CANDOT] = fs(1.0f, fd(acc_d, nc));
      raw[CANL1] = fd(acc_l, nc);
    }
    const bool win = *A.in_window > 0.0f;
    const float* w[5] = {A.w_ort, A.w_cdot, A.w_cl1, A.w_candot, A.w_canl1};
#pragma unroll
    for (int j = ORT; j <= CANL1; ++j) {
      const float wj = *w[j - ORT];
      const float v = on[j] ? fm(wj, raw[j]) : 0.0f;
      val[j] = win ? v : 0.0f;
      fac[j] = on[j] && win ? wj : 0.0f;
    }
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sv[S_K + j] = k[j];
        sv[S_C + 3 * j] = c[j].x;
        sv[S_C + 3 * j + 1] = c[j].y;
        sv[S_C + 3 * j + 2] = c[j].z;
        sv[S_S + 3 * j] = S[j].x;
        sv[S_S + 3 * j + 1] = S[j].y;
        sv[S_S + 3 * j + 2] = S[j].z;
        sv[S_R + j] = r[j];
        sv[S_SG + 3 * j] = s_sum[5 * j + 2];
        sv[S_SG + 3 * j + 1] = s_sum[5 * j + 3];
        sv[S_SG + 3 * j + 2] = s_sum[5 * j + 4];
      }
      sv[S_SD] = sgn(d12);
      sv[S_SD + 1] = sgn(d13);
      sv[S_SD + 2] = sgn(d23);
      if (A.snap) {
        for (int i = 0; i < 18; ++i) sv[S_COND + i] = cond[i];
        sv[S_NCOND] = nc;
      }
    }
  }
  if (tid != 0) return;
  float total = 0.0f;
  bool first = true;
  for (int j = 0; j < NTERMS; ++j) {
    if (A.pos[j] < 0) continue;
    const bool fin = finite(val[j]);
    const float t = fin ? val[j] : 0.0f;
    sv[S_F + j] = fin ? fac[j] : 0.0f;
    A.terms[A.pos[j]] = t;
    total = first ? t : fa(total, t);
    first = false;
  }
  *A.total = total;
  *A.mse = mse;
  for (int kk = 0; kk < SAVED; ++kk) A.saved[kk] = sv[kk];
}

// ------------------------------------------------------------ loss_bwd
// the scalars of the gradient: the ray terms' (rgb, opacity, dl, sem),
// then a member of cluster g's d nf = A_g + B_g sgn(nf - c_g)
enum { C_RGB, C_OP, C_DL, C_SEM, C_A = 4, C_B = 13, C_C = 16, NCOEF = 25 };

__device__ void coefficients(const Args& A, float* co) {
  const float* sv = A.saved;
  float G[NTERMS];
  for (int j = 0; j < NTERMS; ++j) {
    G[j] = 0.0f;
    if (A.pos[j] < 0) continue;
    float gs = 0.0f;
    if (A.g_terms) gs = fa(gs, A.g_terms[A.pos[j]]);
    if (A.g_total) gs = fa(gs, *A.g_total);
    G[j] = fm(gs, sv[S_F + j]);
  }
  co[C_RGB] = fd(G[RGB], sv[S_DEN]);
  co[C_OP] = fd(G[OPAC], sv[S_DEN + 1]);
  co[C_DL] = fd(G[DIST], sv[S_DEN + 1]);
  co[C_SEM] = fd(G[SEM], sv[S_DEN + 2]);
  for (int k = C_A; k < NCOEF; ++k) co[k] = 0.0f;
  if (!A.clustering) return;
  const float three = 3.0f;
  V3 c[3], S[3], SG[3];
  float k[3], a_cd[3], a_cl[3];
  for (int j = 0; j < 3; ++j) {
    c[j] = load3(sv + S_C, j);
    S[j] = load3(sv + S_S, j);
    SG[j] = load3(sv + S_SG, j);
    k[j] = sv[S_K + j];
    a_cd[j] = fd(fd(G[CDOT], three), k[j]);
    a_cl[j] = fd(fd(G[CL1], three), k[j]);
  }
  const float a_ort = fd(G[ORT], three);
  // the other two clusters of each and the signs of their dot products
  const int others[3][4] = {{1, 0, 2, 1}, {0, 0, 2, 2}, {0, 1, 1, 2}};
  for (int j = 0; j < 3; ++j) {
    const int b1 = others[j][0], s1 = others[j][1], b2 = others[j][2],
              s2 = others[j][3];
    const float sd1 = sv[S_SD + s1], sd2 = sv[S_SD + s2];
    float gc[3];
    for (int x = 0; x < 3; ++x) {
      gc[x] = fm(a_ort, fa(fm(sd1, comp(c[b1], x)), fm(sd2, comp(c[b2], x))));
      gc[x] = fs(gc[x], fm(a_cd[j], comp(S[j], x)));
      gc[x] = fs(gc[x], fm(a_cl[j], comp(SG[j], x)));
    }
    if (A.snap) {
      const float nc = sv[S_NCOND];
      const float a_cand = fd(G[CANDOT], nc), a_canl = fd(G[CANL1], nc);
      for (int i = 0; i < 6; ++i) {
        const float cnd = sv[S_COND + 6 * j + i];
        for (int x = 0; x < 3; ++x) {
          const float canv = x == i / 2 ? (i % 2 == 0 ? 1.0f : -1.0f) : 0.0f;
          gc[x] = fa(gc[x], fm(cnd, fs(fm(a_canl, sgn(fs(comp(c[j], x), canv))),
                                       fm(a_cand, canv))));
        }
      }
    }
    const V3 G3 = V3{gc[0], gc[1], gc[2]};
    const float r = sv[S_R + j];
    const bool ok = r > 0.0f;
    const float safe = ok ? r : 1.0f;
    const float cg = dot3(c[j], G3);
    for (int x = 0; x < 3; ++x) {
      const float dm = ok ? fd(fs(gc[x], fm(comp(c[j], x), cg)), safe) : 0.0f;
      co[C_A + 3 * j + x] = fs(fd(dm, k[j]), fm(a_cd[j], comp(c[j], x)));
      co[C_C + 3 * j + x] = comp(c[j], x);
    }
    co[C_B + j] = a_cl[j];
  }
}

// d of the loss by a member's (unflipped, masked) normal n
__device__ __forceinline__ V3 member_grad(const float* co, V3 n, int code) {
  const int g = (code < 0 ? -code : code) - 1;
  const V3 nf = flipped(n, code);
  const float B = co[C_B + g];
  V3 d;
  d.x = fa(co[C_A + 3 * g], fm(B, sgn(fs(nf.x, co[C_C + 3 * g]))));
  d.y = fa(co[C_A + 3 * g + 1], fm(B, sgn(fs(nf.y, co[C_C + 3 * g + 1]))));
  d.z = fa(co[C_A + 3 * g + 2], fm(B, sgn(fs(nf.z, co[C_C + 3 * g + 2]))));
  return flipped(d, code);
}

// d of the loss by point vertex (0: P1, 1: P2, 2: P3) of member triangle t
__device__ V3 vertex_grad(const Args& A, const float* co, int t, int vertex,
                          int code) {
  const Tri T = triangle(A, t);
  const V3 dn = member_grad(co, T.n, code);
  const float nd = dot3(T.n, dn);
  const V3 dv = V3{fd(fs(dn.x, fm(T.n.x, nd)), T.r),
                   fd(fs(dn.y, fm(T.n.y, nd)), T.r),
                   fd(fs(dn.z, fm(T.n.z, nd)), T.r)};
  if (vertex == 1) return cross3(T.b, dv);
  if (vertex == 2) return cross3(dv, T.a);
  const V3 da = cross3(T.b, dv), db = cross3(dv, T.a);
  return sub3(neg3(da), db);
}

__global__ void __launch_bounds__(RAY_THREADS)
    loss_bwd_kernel(const __grid_constant__ Args A) {
  __shared__ float co[NCOEF];
  if (threadIdx.x == 0) coefficients(A, co);
  __syncthreads();
  const int i = blockIdx.x * RAY_THREADS + threadIdx.x;
  if (i >= A.n_rays) return;
  const bool sup = i < A.n_sup;
  if (A.d_rgb) {
    V3 d = V3{0.0f, 0.0f, 0.0f};
    if (sup) {
      const float* r = A.rgb + static_cast<long long>(i) * A.rgb_stride;
      const float* t = A.trgb + static_cast<long long>(i) * A.trgb_stride;
      const V3 e = V3{fs(r[0], t[0]), fs(r[1], t[1]), fs(r[2], t[2])};
      d = V3{fm(co[C_RGB], fa(e.x, e.x)), fm(co[C_RGB], fa(e.y, e.y)),
             fm(co[C_RGB], fa(e.z, e.z))};
    }
    store3(A.d_rgb, i, d);
  }
  if (A.d_op) {
    const float o = fa(A.op[i], 1e-10f);
    A.d_op[i] = -fm(co[C_OP], fa(logf(o), 1.0f));
  }
  if (A.d_dl) A.d_dl[i] = co[C_DL];
  if (A.d_sem) {
    float* ds = A.d_sem + static_cast<long long>(i) * A.n_cls;
    const int lab = sup ? label_of(A, i) - 1 : -1;
    if (lab < 0) {
      for (int c = 0; c < A.n_cls; ++c) ds[c] = 0.0f;
    } else {
      const float* x = A.sem + static_cast<long long>(i) * A.sem_stride;
      const int lc = min(lab, A.n_cls - 1);
      float m;
      const float lse = log_sum(x, A.n_cls, m);
      for (int c = 0; c < A.n_cls; ++c)
        ds[c] = fm(co[C_SEM],
                   fs(expf(fs(fs(x[c], m), lse)), c == lc ? 1.0f : 0.0f));
    }
  }
  if (A.d_depth || A.d_o || A.d_d) {
    V3 dP = V3{0.0f, 0.0f, 0.0f};
    if (A.clustering && i >= A.unsup) {
      const int* row = A.table + static_cast<long long>(i - A.unsup) * A.table_w;
      for (int w = 0; w < A.table_w; ++w) {
        const int e = row[w];
        if (e < 0) continue;
        const int t = e / 3;
        const int code = A.member[t];
        if (!code) continue;
        const V3 g = vertex_grad(A, co, t, e - 3 * t, code);
        dP = V3{fa(dP.x, g.x), fa(dP.y, g.y), fa(dP.z, g.z)};
      }
    }
    if (A.d_depth) A.d_depth[i] = dot3(dP, load3(A.rays_d, i));
    if (A.d_o) store3(A.d_o, i, dP);
    if (A.d_d) {
      const float dep = A.depth[i];
      store3(A.d_d, i, V3{fm(dP.x, dep), fm(dP.y, dep), fm(dP.z, dep)});
    }
  }
}

// the arguments' own consistency: what each launcher reads is there
bool args_ok(const Args* A) {
  if (A->n_rays < 0 || A->n_sup < 0 || A->n_sup > A->n_rays ||
      A->unsup < 0 || A->unsup > A->n_rays || A->n_tri < 0 || A->n_cls < 0)
    return false;
  const long long items = A->n_rays > A->n_tri ? A->n_rays : A->n_tri;
  if (A->blocks != (items + RAY_THREADS - 1) / RAY_THREADS &&
      !(items == 0 && A->blocks == 1))
    return false;
  for (int j = 0; j < NTERMS; ++j)
    if (A->pos[j] >= NTERMS) return false;
  if (!A->rgb || !A->trgb || !A->op || (A->n_cls && (!A->sem || !A->labels)))
    return false;
  if (A->clustering &&
      (!A->depth || !A->rays_o || !A->rays_d || !A->x1 || !A->x2 || !A->x3 ||
       !A->table || A->table_w < 1))
    return false;
  return true;
}

bool clusters_ok(const Args* A) {
  if (!A->slots || !A->terms || !A->total || !A->mse || !A->saved)
    return false;
  if (!A->clustering) return true;
  return A->nm && A->member && A->assign && A->cent3 && A->w_ort &&
         A->w_cdot && A->w_cl1 && A->w_candot && A->w_canl1 && A->in_window;
}

}  // namespace

// args: the host's Args (copied into each launch); loss_rays writes nm,
// valid and slots.
extern "C" int loss_rays(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!args_ok(A) || !A->slots || (A->n_tri && (!A->nm || !A->valid)))
    return static_cast<int>(cudaErrorInvalidValue);
  loss_rays_kernel<<<A->blocks, RAY_THREADS, 0, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}

// after K7 (assign, cent3): the terms, total, mse, saved and member codes
extern "C" int loss_clusters(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!args_ok(A) || !clusters_ok(A))
    return static_cast<int>(cudaErrorInvalidValue);
  loss_clusters_kernel<<<1, CL_THREADS, 0, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}

// from saved, member and the cotangents: every asked gradient
extern "C" int loss_bwd(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!args_ok(A) || !A->saved || (A->clustering && !A->member))
    return static_cast<int>(cudaErrorInvalidValue);
  // a gradient only of what the asked terms read
  if ((A->d_depth || A->d_o || A->d_d) && !A->clustering)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((A->d_sem && !A->n_cls) || (A->d_dl && !A->dl))
    return static_cast<int>(cudaErrorInvalidValue);
  loss_bwd_kernel<<<A->blocks, RAY_THREADS, 0, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}
