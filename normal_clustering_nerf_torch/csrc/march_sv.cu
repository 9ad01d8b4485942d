// K1: supervoxel-run ("sv") march, for training and for held-out render
// rounds.
//
// Replaces the JAX package's `_sv_scan`
// (normal_clustering_nerf_tpu/ops/ray_march.py:595-770) as called by
// `march_rays_train_dense_sv` (:519) and `march_rays_test_round_sv` (:773):
// one cascade, a uniform step lattice t_k = t0 + k*lo (lo = sqrt(3)/S_max).
//
// What it computes, per ray:
//   A. The ray's interval [t0, t_end) cut at every supervoxel boundary
//      plane (3*(Gc+1) plane crossings, Gc = G/8). Each piece takes the
//      supervoxel of its midpoint; it is "occupied" if it is valid
//      (b1 > b0 + 1e-9), its sv_mask byte is set, and its supervoxel
//      differs from that of the piece just before it (an invalid piece
//      counts as id -1). The first RI occupied pieces are kept; the rest
//      are counted (iv_extra) and the scan horizon is the end of the RI-th.
//   B. For each kept piece, the SI lattice steps from k0 = ceil((b0-t0)/lo)-1
//      that are in range (0 <= k < S, t_k < t_end), whose fine cell lies in
//      the piece's supervoxel ("owned"), and whose bit is set in the
//      supervoxel's 512-bit payload (16 words; bit L = (lz*8+ly)*8+lx).
//   C. Of these m_tot occupied steps, in piece order, the K slots of
//      `rank_targets` (first K, or the stratified tail with tail_k = K).
//
// Launchers (one device function):
//   march_sv_train       t, dt*span, valid, ray_count, and the batch's
//                        rm_samples and truncated-ray count;
//   march_sv_test_round  first K (tail_k = 0) from each alive ray's cursor:
//                        t, dt, valid and the lattice-aligned next cursor.
//
// Design: one thread per ray, no (N, NB) or (N, RI, SI) intermediate. The
// plane crossings of each axis are monotone in the plane index (a correctly
// rounded division by a fixed denominator preserves order), so a 3-way
// merge yields the pieces in the order of JAX's sort. The kept pieces
// (start, supervoxel, occupied-step count) sit in local arrays of
// SV_MAX_RI entries. Pass 1 counts m_tot; pass 2 walks again, skipping
// whole pieces below the next target rank, and emits the targets.
//
// Exactness: every t, position and cell is computed with the operations and
// order of the JAX reference (__fmul_rn/__fadd_rn/__fdiv_rn, built with
// --fmad=false), so the sample set and the cursor are identical.
//
// Bound on the H100: latency. The work per ray is a few dozen mask probes
// and RI*SI (24*67 at the bench) step tests against a 64-byte payload row
// that stays in L1; with 8190 rays there are fewer than 2 warps per SM
// scheduler, so the time is one thread's serial walk, twice. Splitting a
// ray's pieces over a warp is the next step if it shows in a profile.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int SV_MAX_RI = 64;

struct SvRay {
  float o[3], d[3];
  float t0, t_end;
  bool hit;
};

struct Geo {
  int G, Gc, S, RI, SI;
  float lo, mb, sv;
};

__device__ __forceinline__ int cell_of(float x, float mb, int G) {
  // clip(0.5 * (x / mb + 1) * G, 0, G - 1) truncated to int
  float v = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(x, mb), 1.0f)),
                      static_cast<float>(G));
  v = fminf(fmaxf(v, 0.0f), static_cast<float>(G - 1));
  return static_cast<int>(v);
}

// The plane crossings of one axis in ascending t, restricted to
// (t0, t_end): ((j*sv - mb) - o) / denom, j ascending for denom > 0 and
// descending otherwise.
struct Axis {
  float o, den;
  int j, step, left;   // next plane index, its increment, planes left
  float v;             // the current crossing, +inf when exhausted
};

__device__ __forceinline__ float crossing(const Axis& a, const Geo& g) {
  return __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(static_cast<float>(a.j), g.sv),
                                       g.mb), a.o), a.den);
}

__device__ __forceinline__ void axis_next(Axis& a, const Geo& g, float t0,
                                          float t_end) {
  while (a.left > 0) {
    float v = crossing(a, g);
    a.j += a.step;
    --a.left;
    if (!(v > t0)) continue;            // before the interval
    if (v < t_end) { a.v = v; return; }
    break;                              // at or past its end: no more
  }
  a.left = 0;
  a.v = CUDART_INF_F;
}

__device__ __forceinline__ void axis_init(Axis& a, float o, float d,
                                          const Geo& g, float t0, float t_end) {
  a.o = o;
  a.den = fabsf(d) < 1e-9f ? 1e-9f : d;
  a.step = a.den > 0.0f ? 1 : -1;
  a.j = a.den > 0.0f ? 0 : g.Gc;
  a.left = g.Gc + 1;
  axis_next(a, g, t0, t_end);
}

// Phase A. Fills the kept pieces' start b0 and supervoxel id; returns their
// number (<= RI) and sets the occupied pieces beyond RI and the horizon.
__device__ int sv_pieces(const SvRay& r, const Geo& g,
                         const uint8_t* __restrict__ sv_mask,
                         float* __restrict__ p_b0, int* __restrict__ p_id,
                         int* iv_extra, float* scan_end) {
  *iv_extra = 0;
  *scan_end = r.t_end;
  if (!r.hit) return 0;
  int n = 0, prev = -1;
  bool first = true;
  // the sorted finite bounds: [t0, crossings..., t_end] when t0 < t_end,
  // else [t_end, t0] (JAX sorts t0, t_end and the in-range crossings)
  Axis ax[3];
  float b0, b1;
  bool last;
  if (r.t0 < r.t_end) {
    for (int a = 0; a < 3; ++a) axis_init(ax[a], r.o[a], r.d[a], g, r.t0, r.t_end);
    b0 = r.t0;
  } else {
    ax[0].v = ax[1].v = ax[2].v = CUDART_INF_F;
    b0 = r.t_end;
  }
  do {
    int m = 0;
    if (ax[1].v < ax[m].v) m = 1;
    if (ax[2].v < ax[m].v) m = 2;
    if (ax[m].v < CUDART_INF_F) {
      b1 = ax[m].v;
      axis_next(ax[m], g, r.t0, r.t_end);
      last = false;
    } else {
      b1 = r.t0 < r.t_end ? r.t_end : r.t0;
      last = true;
    }
    const bool valid = isfinite(b1) && b1 > __fadd_rn(b0, 1e-9f);
    int cmp = -1;
    if (valid) {
      const float tm = __fmul_rn(0.5f, __fadd_rn(b0, b1));
      int c[3];
      for (int a = 0; a < 3; ++a) {
        float p = __fadd_rn(r.o[a], __fmul_rn(tm, r.d[a]));
        float s = floorf(__fdiv_rn(__fadd_rn(p, g.mb), g.sv));
        c[a] = static_cast<int>(fminf(fmaxf(s, 0.0f),
                                      static_cast<float>(g.Gc - 1)));
      }
      cmp = (c[2] * g.Gc + c[1]) * g.Gc + c[0];
      if ((first || cmp != prev) && sv_mask[cmp]) {
        if (n < g.RI) {
          p_b0[n] = b0;
          p_id[n] = cmp;
          if (++n == g.RI) *scan_end = b1;
        } else {
          ++*iv_extra;
        }
      }
    }
    prev = cmp;
    first = false;
    b0 = b1;
  } while (!last);
  return n;
}

// Phase B for one piece: calls f(t) for each of its occupied lattice steps,
// in order; f returns false to stop. Returns the steps it accepted.
template <typename F>
__device__ __forceinline__ int sv_piece_steps(const SvRay& r, const Geo& g,
                                              const int* __restrict__ payload,
                                              float b0, int id, F f) {
  const int sx = id % g.Gc, sy = (id / g.Gc) % g.Gc, sz = id / (g.Gc * g.Gc);
  const int* row = payload + static_cast<size_t>(id) * 16;
  const int k0 = static_cast<int>(ceilf(__fdiv_rn(__fsub_rn(b0, r.t0), g.lo))) - 1;
  int n = 0;
  for (int j = 0; j < g.SI; ++j) {
    const int kk = k0 + j;
    if (kk < 0) continue;
    if (kk >= g.S) break;
    const float tt = __fadd_rn(r.t0, __fmul_rn(static_cast<float>(kk), g.lo));
    if (!(tt < r.t_end)) break;
    const int cx = cell_of(__fadd_rn(r.o[0], __fmul_rn(tt, r.d[0])), g.mb, g.G);
    const int cy = cell_of(__fadd_rn(r.o[1], __fmul_rn(tt, r.d[1])), g.mb, g.G);
    const int cz = cell_of(__fadd_rn(r.o[2], __fmul_rn(tt, r.d[2])), g.mb, g.G);
    if ((cx >> 3) != sx || (cy >> 3) != sy || (cz >> 3) != sz) continue;
    const int L = (((cz - 8 * sz) * 8) + (cy - 8 * sy)) * 8 + (cx - 8 * sx);
    const unsigned w = static_cast<unsigned>(row[L >> 5]);
    if (!((w >> (L & 31)) & 1u)) continue;
    ++n;
    if (!f(tt)) break;
  }
  return n;
}

// rank_targets (ray_march.py:341-373): 1-based occupied rank of slot i and
// its represented span.
__device__ __forceinline__ int target_rank(int i, int K1, int K2, int E,
                                           bool tail, int* span) {
  *span = 1;
  if (!tail || i < K1) return i + 1;
  int j = i - K1 + 1;
  if (E <= K2) return K1 + j;
  int cur = (j * E) / K2;
  int prev = ((j - 1) * E) / K2;
  *span = max(cur - prev, 1);
  return K1 + cur;
}

// Phases A-C for one ray: writes its K slots; returns the valid slots and
// the largest sample t through *t_last (-inf when none).
__device__ int sv_scan_ray(const SvRay& r, const Geo& g, int K, int tail_k,
                           const uint8_t* __restrict__ sv_mask,
                           const int* __restrict__ payload, size_t base,
                           float* __restrict__ t_out, float* __restrict__ dt_out,
                           uint8_t* __restrict__ valid_out, int* iv_extra,
                           float* scan_end, float* t_last) {
  float p_b0[SV_MAX_RI];
  int p_id[SV_MAX_RI], p_n[SV_MAX_RI];
  const int n_iv = sv_pieces(r, g, sv_mask, p_b0, p_id, iv_extra, scan_end);

  // pass 1: occupied steps per piece
  int m_tot = 0;
  for (int i = 0; i < n_iv; ++i) {
    p_n[i] = sv_piece_steps(r, g, payload, p_b0[i], p_id[i],
                            [](float) { return true; });
    m_tot += p_n[i];
  }

  const bool tail = tail_k > 0;
  const int K1 = tail ? max(K - tail_k, 0) : K;
  const int K2 = tail_k;
  const int E = max(m_tot - K1, 0);
  int n_valid = 0, span;
  while (n_valid < K && target_rank(n_valid, K1, K2, E, tail, &span) <= m_tot)
    ++n_valid;

  // pass 2: emit the target ranks in order
  int slot = 0, rank = 0;
  int tgt = n_valid > 0 ? target_rank(0, K1, K2, E, tail, &span) : 0;
  float tmax = -CUDART_INF_F;
  for (int i = 0; i < n_iv && slot < n_valid; ++i) {
    if (rank + p_n[i] < tgt) {       // no target in this piece
      rank += p_n[i];
      continue;
    }
    sv_piece_steps(r, g, payload, p_b0[i], p_id[i], [&](float tt) {
      if (++rank != tgt) return true;
      t_out[base + slot] = tt;
      dt_out[base + slot] = tail ? __fmul_rn(g.lo, static_cast<float>(span))
                                 : g.lo;
      valid_out[base + slot] = 1;
      tmax = fmaxf(tmax, tt);
      if (++slot < n_valid) tgt = target_rank(slot, K1, K2, E, tail, &span);
      return slot < n_valid;
    });
  }
  for (; slot < K; ++slot) {
    t_out[base + slot] = 0.0f;
    dt_out[base + slot] = 0.0f;
    valid_out[base + slot] = 0;
  }
  *t_last = tmax;
  return n_valid;
}

__device__ __forceinline__ void load_ray(SvRay& r, const float* __restrict__ o,
                                         const float* __restrict__ d, int n) {
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[3 * n + a];
    r.d[a] = d[3 * n + a];
  }
}

__global__ void march_sv_train_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ hits_t, const uint8_t* __restrict__ sv_mask,
    const int* __restrict__ payload, const float* __restrict__ noise, int N,
    int K, int tail_k, Geo g, float S_lo, float* __restrict__ t_out,
    float* __restrict__ dt_out, uint8_t* __restrict__ valid_out,
    int* __restrict__ count_out, int* __restrict__ sums) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  int rm = 0, cut = 0;
  if (n < N) {
    SvRay r;
    load_ray(r, rays_o, rays_d, n);
    const float t1 = hits_t[2 * n], t2 = hits_t[2 * n + 1];
    r.hit = t1 >= 0.0f;
    r.t0 = __fadd_rn(t1, __fmul_rn(g.lo, noise[n]));
    r.t_end = r.hit ? fminf(t2, __fadd_rn(r.t0, S_lo)) : -CUDART_INF_F;
    int iv_extra;
    float scan_end, t_last;
    rm = sv_scan_ray(r, g, K, tail_k, sv_mask, payload,
                     static_cast<size_t>(n) * K, t_out, dt_out, valid_out,
                     &iv_extra, &scan_end, &t_last);
    count_out[n] = rm;
    // a skipped occupied run biases the stratified set; under first-K only
    // an under-filled ray lost samples (ray_march.py:580-588)
    cut = r.hit && iv_extra > 0 && (tail_k > 0 || rm < K);
  }
  for (int off = 16; off > 0; off >>= 1) {
    rm += __shfl_down_sync(0xffffffffu, rm, off);
    cut += __shfl_down_sync(0xffffffffu, cut, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (rm) atomicAdd(sums, rm);
    if (cut) atomicAdd(sums + 1, cut);
  }
}

__global__ void march_sv_test_round_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ cursor, const float* __restrict__ t_far,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ sv_mask,
    const int* __restrict__ payload, int N, int K, Geo g,
    float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, float* __restrict__ cursor_out) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  SvRay r;
  load_ray(r, rays_o, rays_d, n);
  const float cur = cursor[n];
  r.hit = alive[n] && cur >= 0.0f;
  r.t0 = cur;
  r.t_end = r.hit ? t_far[n] : -CUDART_INF_F;
  int iv_extra;
  float scan_end, t_last;
  const int found = sv_scan_ray(r, g, K, 0, sv_mask, payload,
                                static_cast<size_t>(n) * K, t_out, dt_out,
                                valid_out, &iv_extra, &scan_end, &t_last);
  if (!r.hit) {
    cursor_out[n] = cur;
    return;
  }
  if (found >= K) {   // one lattice step past the last sample (round half even)
    const float k_last = rintf(__fdiv_rn(__fsub_rn(t_last, r.t0), g.lo));
    cursor_out[n] = __fadd_rn(r.t0, __fmul_rn(__fadd_rn(k_last, 1.0f), g.lo));
  } else {            // the first lattice point at or after the horizon
    const float k = ceilf(__fdiv_rn(fmaxf(__fsub_rn(scan_end, r.t0), 0.0f), g.lo));
    cursor_out[n] = __fadd_rn(r.t0, __fmul_rn(k, g.lo));
  }
}

}  // namespace

extern "C" int march_sv_train(const void* rays_o, const void* rays_d,
                              const void* hits_t, const void* sv_mask,
                              const void* sv_payload, const void* noise, int N,
                              int S, int K, int tail_k, int RI, int SI, int G,
                              float lo, float S_lo, float mb, float sv,
                              void* t_out, void* dt_out, void* valid_out,
                              void* count_out, void* sums, cudaStream_t stream) {
  if (RI > SV_MAX_RI || RI < 1 || G % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{G, G / 8, S, RI, SI, lo, mb, sv};
  const int threads = 64;
  march_sv_train_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(hits_t), static_cast<const uint8_t*>(sv_mask),
      static_cast<const int*>(sv_payload), static_cast<const float*>(noise), N,
      K, tail_k, g, S_lo, static_cast<float*>(t_out),
      static_cast<float*>(dt_out), static_cast<uint8_t*>(valid_out),
      static_cast<int*>(count_out), static_cast<int*>(sums));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int march_sv_test_round(const void* rays_o, const void* rays_d,
                                   const void* cursor, const void* t_far,
                                   const void* alive, const void* sv_mask,
                                   const void* sv_payload, int N, int S, int K,
                                   int RI, int SI, int G, float lo, float mb,
                                   float sv, void* t_out, void* dt_out,
                                   void* valid_out, void* cursor_out,
                                   cudaStream_t stream) {
  if (RI > SV_MAX_RI || RI < 1 || G % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{G, G / 8, S, RI, SI, lo, mb, sv};
  const int threads = 64;
  march_sv_test_round_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(cursor), static_cast<const float*>(t_far),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(sv_mask),
      static_cast<const int*>(sv_payload), N, K, g,
      static_cast<float*>(t_out), static_cast<float*>(dt_out),
      static_cast<uint8_t*>(valid_out), static_cast<float*>(cursor_out));
  return static_cast<int>(cudaGetLastError());
}
