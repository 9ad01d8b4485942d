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
// Design: one warp per ray, 8 rays a block, as H9 (march_fine.cu).
//   A. Each lane computes its share of the crossings into shared memory,
//      per axis in ascending t: an axis's crossings are monotone in the
//      plane index (a correctly rounded division by a fixed denominator
//      preserves order), so the in-range ones are a contiguous run,
//      found by binary search. A crossing's place in the sorted bounds
//      is its index within its axis plus the count of the other axes'
//      in-range crossings below it (binary searches), ties going to the
//      lower axis: no serial merge. Equal crossings make a piece with
//      b1 = b0, invalid in any order, so the pieces (b0, b1) are JAX's
//      sorted sequence whatever the tie order. Then a lane per piece:
//      midpoint supervoxel, mask probe, the piece before by a shuffle,
//      occupied ranks by ballots; kept piece r lands on lane r % 32 (slot
//      r / 32: RI <= 64) as its k0 and supervoxel, iv_extra and the
//      horizon follow from the ballots.
//   B. The (piece, j < SI) steps of the kept pieces, flattened piece-major
//      onto the lanes, 32 a round. The range tests become masks (each is
//      monotone in k, so the reference's `break`s and masks agree), a
//      step is owned when its fine cell's supervoxel is the piece's, and
//      its bit comes from the piece's 64-byte payload row (L1-resident).
//      Each round's ballot and the count before it go to shared memory:
//      one probe pass gives m_tot.
//   C. A lane per slot: its target rank (`rank_targets`), the round that
//      holds it by binary search over the stored counts, the step by the
//      rank-th set bit of that round's ballot. There is no second probe
//      pass, which the stratified tail (whose last target is m_tot) would
//      make a full second walk; the selection reads ~2 words a slot.
//
// Exactness: every t, position and cell is computed with the operations and
// order of the JAX reference (__fmul_rn/__fadd_rn/__fdiv_rn, built with
// --fmad=false; t from k, never accumulated), so the sample set and the
// cursor are identical. A step's x / mb is a multiply by 1 / mb when mb
// is a power of two (the bench's 0.5): the same correctly rounded value.
//
// Bound on the H100: issue rate of the step tests. The work per ray is
// 3*(Gc+1) crossings, a mask probe per piece and RI*SI (24*67 at the
// bench) step tests of ~30 f32 operations against a 64-byte payload row;
// 8190 warps fill the 132 SMs (the thread-per-ray design left fewer than 2
// warps per scheduler and walked the steps serially, twice).
#include <math_constants.h>

#include "march_common.cuh"

namespace {

constexpr int WARPS = 8;       // warps (rays) per block
constexpr int SV_MAX_RI = 64;  // kept pieces: two slots a lane

struct SvRay {
  float o[3], d[3];
  float t0, t_end;
  bool hit;
};

struct Geo {
  int G, Gc, S, RI, SI;
  float lo, mb, sv;
  float inv_mb;   // 1 / mb for a power-of-two mb (the bench's 0.5), else 0
};

// Shared memory of one warp, in 4-byte words: phase A's crossings and
// sorted bounds, then phase B's ballots and counts, in the same space.
__host__ __device__ inline int warp_words(int Gc, int RI, int SI) {
  const int a = 3 * (Gc + 1) + 3 * (Gc + 1) + 2;
  const int b = 2 * ((RI * SI + 31) / 32);
  return a > b ? a : b;
}

// entries of a[0..n) (ascending) below v, or at or below v
__device__ __forceinline__ int count_below(const float* a, int n, float v,
                                           bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (or_equal ? a[mid] <= v : a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The kept pieces: piece r on lane r & 31, slot r >> 5.
struct Kept {
  int k0[2], id[2];
};

// piece P's (k0, supervoxel) from the lane that keeps it (every lane calls)
__device__ __forceinline__ int2 kept_piece(const Kept& kp, int P, bool two) {
  const int src = P & 31;
  int k0 = __shfl_sync(FULL, kp.k0[0], src);
  int id = __shfl_sync(FULL, kp.id[0], src);
  if (two) {   // warp-uniform
    const int k1 = __shfl_sync(FULL, kp.k0[1], src);
    const int i1 = __shfl_sync(FULL, kp.id[1], src);
    if (P >= 32) k0 = k1, id = i1;
  }
  return make_int2(k0, id);
}

// Phase A. Returns the kept pieces' count; sets iv_extra and the horizon.
__device__ int sv_pieces(const SvRay& r, const Geo& g,
                         const uint8_t* __restrict__ sv_mask, float* sm,
                         Kept& kp, int* iv_extra, float* scan_end) {
  const int lane = threadIdx.x & 31, n1 = g.Gc + 1;
  *iv_extra = 0;
  *scan_end = r.t_end;
  if (!r.hit) return 0;
  float* A = sm;            // crossings, 3 x (Gc+1), ascending per axis
  float* B = sm + 3 * n1;   // the sorted finite bounds
  // [t0, crossings..., t_end] when t0 < t_end, else [t_end, t0] (JAX
  // sorts t0, t_end and the crossings in (t0, t_end))
  int n_in = 0;
  if (r.t0 < r.t_end) {
    for (int e = lane; e < 3 * n1; e += 32) {
      const int a = e / n1, i = e - a * n1;
      // (selects, not r.o[a]: a runtime index would put the ray in local
      // memory)
      const float o = a == 0 ? r.o[0] : a == 1 ? r.o[1] : r.o[2];
      const float d = a == 0 ? r.d[0] : a == 1 ? r.d[1] : r.d[2];
      const float den = fabsf(d) < 1e-9f ? 1e-9f : d;
      const int j = den > 0.0f ? i : g.Gc - i;
      A[e] = __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(static_cast<float>(j),
                                                     g.sv), g.mb), o),
                       den);
    }
    __syncwarp();
    int first[3], last[3];   // the in-range run of each axis
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      first[a] = count_below(A + a * n1, n1, r.t0, true);
      last[a] = count_below(A + a * n1, n1, r.t_end, false);
      n_in += last[a] - first[a];
    }
    for (int e = lane; e < 3 * n1; e += 32) {
      const int a = e / n1, i = e - a * n1;
      const int fa = a == 0 ? first[0] : a == 1 ? first[1] : first[2];
      const int la = a == 0 ? last[0] : a == 1 ? last[1] : last[2];
      if (i < fa || i >= la) continue;
      const float v = A[e];
      int place = 1 + i - fa;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (b != a)
          place += count_below(A + b * n1, n1, v, b < a) - first[b];
      B[place] = v;
    }
    if (lane == 0) {
      B[0] = r.t0;
      B[n_in + 1] = r.t_end;
    }
  } else if (lane == 0) {
    B[0] = r.t_end;
    B[1] = r.t0;
  }
  __syncwarp();

  const int n_pieces = n_in + 1;
  int occ_before = 0, prev_id = -1;
  float end = r.t_end;
  for (int p0 = 0; p0 < n_pieces; p0 += 32) {
    const int p = p0 + lane;
    bool valid = false;
    int id = -1, k0 = 0;
    float b1 = 0.0f;
    if (p < n_pieces) {
      const float b0 = B[p];
      b1 = B[p + 1];
      valid = isfinite(b1) && b1 > __fadd_rn(b0, 1e-9f);
      if (valid) {
        const float tm = __fmul_rn(0.5f, __fadd_rn(b0, b1));
        int c[3];
        for (int a = 0; a < 3; ++a) {
          const float x = __fadd_rn(r.o[a], __fmul_rn(tm, r.d[a]));
          const float s = floorf(__fdiv_rn(__fadd_rn(x, g.mb), g.sv));
          c[a] = static_cast<int>(fminf(fmaxf(s, 0.0f),
                                        static_cast<float>(g.Gc - 1)));
        }
        id = (c[2] * g.Gc + c[1]) * g.Gc + c[0];
        k0 = static_cast<int>(ceilf(__fdiv_rn(__fsub_rn(b0, r.t0), g.lo))) - 1;
      }
    }
    int before = __shfl_up_sync(FULL, id, 1);
    if (lane == 0) before = prev_id;
    prev_id = __shfl_sync(FULL, id, 31);
    const bool occ = valid && (p == 0 || id != before) && sv_mask[id];
    const unsigned m = __ballot_sync(FULL, occ);
    const int rank = occ_before + __popc(m & lanes_below());
    const unsigned at_ri = __ballot_sync(FULL, occ && rank == g.RI - 1);
    if (at_ri) end = __shfl_sync(FULL, b1, __ffs(at_ri) - 1);
    // kept piece of rank occ_before + offs goes to lane (occ_before + offs)
    // & 31: this lane takes offs = (lane - occ_before) & 31
    const int offs = (lane - occ_before) & 31;
    const bool take = offs < __popc(m) && occ_before + offs < g.RI;
    const int src = take ? nth_bit(m, offs + 1) : lane;
    const int k0_in = __shfl_sync(FULL, k0, src);
    const int id_in = __shfl_sync(FULL, id, src);
    if (take) {
      if (occ_before + offs < 32) {
        kp.k0[0] = k0_in;
        kp.id[0] = id_in;
      } else {
        kp.k0[1] = k0_in;
        kp.id[1] = id_in;
      }
    }
    occ_before += __popc(m);
  }
  *iv_extra = max(occ_before - g.RI, 0);
  *scan_end = end;
  __syncwarp();   // phase B reuses the shared memory
  return min(occ_before, g.RI);
}

// Phases A-C for one ray: writes its K slots; returns the valid slots and
// the largest sample t through *t_last (-inf when none).
__device__ int sv_scan_ray(const SvRay& r, const Geo& g, int K, int tail_k,
                           const uint8_t* __restrict__ sv_mask,
                           const int* __restrict__ payload, float* sm,
                           size_t base, float* __restrict__ t_out,
                           float* __restrict__ dt_out,
                           uint8_t* __restrict__ valid_out, int* iv_extra,
                           float* scan_end, float* t_last) {
  const int lane = threadIdx.x & 31;
  Kept kp = {{0, 0}, {0, 0}};
  const int n_kept = sv_pieces(r, g, sv_mask, sm, kp, iv_extra, scan_end);
  const bool two = n_kept > 32;

  // phase B: one ballot a round of 32 (piece, j) steps, and the count
  // before it
  const int total = n_kept * g.SI;
  const int rounds = (total + 31) / 32;
  unsigned* ballot = reinterpret_cast<unsigned*>(sm);
  int* before = reinterpret_cast<int*>(sm) + rounds;
  int m_tot = 0;
  int piece = lane / g.SI, step = lane - piece * g.SI;   // lane's q
  for (int w = 0; w < rounds; ++w) {
    const int q = 32 * w + lane;
    const int2 pc = kept_piece(kp, min(piece, n_kept - 1), two);
    const int kk = pc.x + step;
    bool inc = false;
    if (q < total && kk >= 0 && kk < g.S) {
      const float tt = step_t(r.t0, kk, g.lo);
      if (tt < r.t_end) {
        const int cx = cell_of(__fadd_rn(r.o[0], __fmul_rn(tt, r.d[0])), g.mb,
                               g.G, g.inv_mb);
        const int cy = cell_of(__fadd_rn(r.o[1], __fmul_rn(tt, r.d[1])), g.mb,
                               g.G, g.inv_mb);
        const int cz = cell_of(__fadd_rn(r.o[2], __fmul_rn(tt, r.d[2])), g.mb,
                               g.G, g.inv_mb);
        // owned: the fine cell's supervoxel is the piece's
        if ((((cz >> 3) * g.Gc + (cy >> 3)) * g.Gc + (cx >> 3)) == pc.y) {
          const int L = (((cz & 7) * 8) + (cy & 7)) * 8 + (cx & 7);
          const unsigned word = static_cast<unsigned>(
              __ldg(payload + static_cast<size_t>(pc.y) * 16 + (L >> 5)));
          inc = (word >> (L & 31)) & 1u;
        }
      }
    }
    const unsigned m = __ballot_sync(FULL, inc);
    if (lane == 0) {
      ballot[w] = m;
      before[w] = m_tot;
    }
    m_tot += __popc(m);
    for (step += 32; step >= g.SI; step -= g.SI) ++piece;   // q += 32
  }
  __syncwarp();

  // phase C: a lane per slot finds the step of its target rank
  const bool tail = tail_k > 0;
  const int K1 = tail ? max(K - tail_k, 0) : K;
  const int K2 = tail_k;
  const int E = max(m_tot - K1, 0);
  int n_valid = 0;
  float tmax = -CUDART_INF_F;
  for (int i0 = 0; i0 < K; i0 += 32) {
    const int i = i0 + lane;
    int span = 1;
    const int rank = i < K ? target_rank(i, K1, K2, E, tail, &span) : 0;
    const bool v = i < K && rank <= m_tot;
    int P = 0, j = 0;
    if (v) {
      int lo = 0, hi = rounds;   // the last round whose count before < rank
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (before[mid] < rank) lo = mid;
        else hi = mid;
      }
      const int q = 32 * lo + nth_bit(ballot[lo], rank - before[lo]);
      P = q / g.SI;
      j = q - P * g.SI;
    }
    const int2 pc = kept_piece(kp, P, two);
    if (i < K) {
      const size_t o = base + i;
      if (v) {
        const float tt = step_t(r.t0, pc.x + j, g.lo);
        t_out[o] = tt;
        dt_out[o] = __fmul_rn(g.lo, static_cast<float>(span));
        valid_out[o] = 1;
        tmax = fmaxf(tmax, tt);
      } else {
        t_out[o] = 0.0f;
        dt_out[o] = 0.0f;
        valid_out[o] = 0;
      }
    }
    n_valid += __popc(__ballot_sync(FULL, v));
  }
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
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

__global__ void __launch_bounds__(WARPS * 32) march_sv_train_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ hits_t, const uint8_t* __restrict__ sv_mask,
    const int* __restrict__ payload, const float* __restrict__ noise, int N,
    int K, int tail_k, Geo g, float S_lo, float* __restrict__ t_out,
    float* __restrict__ dt_out, uint8_t* __restrict__ valid_out,
    int* __restrict__ count_out, int* __restrict__ sums) {
  extern __shared__ float smem[];
  __shared__ int block_sums[2];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + wib;
  if (threadIdx.x == 0) block_sums[0] = block_sums[1] = 0;
  __syncthreads();
  if (n < N) {   // warp-uniform
    SvRay r;
    load_ray(r, rays_o, rays_d, n);
    const float t1 = hits_t[2 * n], t2 = hits_t[2 * n + 1];
    r.hit = t1 >= 0.0f;
    r.t0 = __fadd_rn(t1, __fmul_rn(g.lo, noise[n]));
    r.t_end = r.hit ? fminf(t2, __fadd_rn(r.t0, S_lo)) : -CUDART_INF_F;
    int iv_extra;
    float scan_end, t_last;
    const int rm = sv_scan_ray(
        r, g, K, tail_k, sv_mask, payload,
        smem + wib * warp_words(g.Gc, g.RI, g.SI),
        static_cast<size_t>(n) * K, t_out, dt_out, valid_out, &iv_extra,
        &scan_end, &t_last);
    if (lane == 0) {
      count_out[n] = rm;
      if (rm) atomicAdd(block_sums, rm);
      // a skipped occupied run biases the stratified set; under first-K
      // only an under-filled ray lost samples (ray_march.py:580-588)
      if (r.hit && iv_extra > 0 && (tail_k > 0 || rm < K))
        atomicAdd(block_sums + 1, 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_sums[0]) atomicAdd(sums, block_sums[0]);
    if (block_sums[1]) atomicAdd(sums + 1, block_sums[1]);
  }
}

__global__ void __launch_bounds__(WARPS * 32) march_sv_test_round_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ cursor, const float* __restrict__ t_far,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ sv_mask,
    const int* __restrict__ payload, int N, int K, Geo g,
    float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, float* __restrict__ cursor_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + wib;
  if (n >= N) return;   // the whole warp leaves together
  SvRay r;
  load_ray(r, rays_o, rays_d, n);
  const float cur = cursor[n];
  r.hit = alive[n] && cur >= 0.0f;
  r.t0 = cur;
  r.t_end = r.hit ? t_far[n] : -CUDART_INF_F;
  int iv_extra;
  float scan_end, t_last;
  const int found = sv_scan_ray(
      r, g, K, 0, sv_mask, payload, smem + wib * warp_words(g.Gc, g.RI, g.SI),
      static_cast<size_t>(n) * K, t_out, dt_out, valid_out, &iv_extra,
      &scan_end, &t_last);
  if (lane != 0) return;
  if (!r.hit) {
    cursor_out[n] = cur;
  } else if (found >= K) {   // one lattice step past the last sample
    // (round half even)
    const float k_last = rintf(__fdiv_rn(__fsub_rn(t_last, r.t0), g.lo));
    cursor_out[n] = __fadd_rn(r.t0, __fmul_rn(__fadd_rn(k_last, 1.0f), g.lo));
  } else {                   // the first lattice point at or after the horizon
    const float k = ceilf(__fdiv_rn(fmaxf(__fsub_rn(scan_end, r.t0), 0.0f), g.lo));
    cursor_out[n] = __fadd_rn(r.t0, __fmul_rn(k, g.lo));
  }
}

// The warps' shared memory in bytes, with the opt-in above 48 KB set on
// every launch (it holds per device); 0 if the geometry is refused.
template <class Kern>
size_t shared_bytes(Kern kernel, const Geo& g, int* err) {
  *err = 0;
  if (g.RI > SV_MAX_RI || g.RI < 1 || g.G % 8 || g.SI < 1) {
    *err = static_cast<int>(cudaErrorInvalidValue);
    return 0;
  }
  const size_t bytes = sizeof(float) * WARPS * warp_words(g.Gc, g.RI, g.SI);
  if (bytes > 48 * 1024)
    *err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
  return bytes;
}

}  // namespace

extern "C" int march_sv_train(const void* rays_o, const void* rays_d,
                              const void* hits_t, const void* sv_mask,
                              const void* sv_payload, const void* noise, int N,
                              int S, int K, int tail_k, int RI, int SI, int G,
                              float lo, float S_lo, float mb, float sv,
                              void* t_out, void* dt_out, void* valid_out,
                              void* count_out, void* sums, cudaStream_t stream) {
  const Geo g{G, G / 8, S, RI, SI, lo, mb, sv, pow2_inverse(mb)};
  int err;
  const size_t bytes = shared_bytes(march_sv_train_kernel, g, &err);
  if (err) return err;
  march_sv_train_kernel<<<ncn_blocks(N, WARPS), WARPS * 32, bytes, stream>>>(
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
  const Geo g{G, G / 8, S, RI, SI, lo, mb, sv, pow2_inverse(mb)};
  int err;
  const size_t bytes = shared_bytes(march_sv_test_round_kernel, g, &err);
  if (err) return err;
  march_sv_test_round_kernel<<<ncn_blocks(N, WARPS), WARPS * 32, bytes,
                               stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(cursor), static_cast<const float*>(t_far),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(sv_mask),
      static_cast<const int*>(sv_payload), N, K, g,
      static_cast<float*>(t_out), static_cast<float*>(dt_out),
      static_cast<uint8_t*>(valid_out), static_cast<float*>(cursor_out));
  return static_cast<int>(cudaGetLastError());
}
