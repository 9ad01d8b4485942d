// H1, H9, H10, H11: the bitfield march with one warp per ray (the
// bootstrap march among them), and the flat ray-major compaction.
//
// Replaces the Pallas bit probe P2 (experiments/pallas_gather_probe.py:84
// `pallas_bit`, the occupancy test (w[c >> 5] >> (c & 31)) & 1 over an
// (8192, 1024) block of (ray, step) cells of a 128^3 bitfield) together
// with the JAX functions of its path (normal_clustering_nerf_tpu/ops/
// ray_march.py): `march_rays_train_dense` at S = march_block steps, with
// and without the two-level coarse mask (:402-516, H9);
// `march_rays_test_round_dense` (:820-856) and the bucket renderer's
// non-sv round (models/rendering.py:332-353), H10; `compact_samples`
// (:157-192), H11.
//
// H9 `march_fine_train`, per ray: the steps t_k = t0 + k*lo (t0 = t1 +
// lo*noise; on the general grid below, t_k of t_step_grid from t0 = t1 +
// calc_dt(t1)*noise) inside [t1, t2) whose occupancy bit is set; of those m_tot
// occupied steps the K slots that `stratified_budget` + `select_first_k`
// keep. Lane l probes steps k = 32j + l; the bitfield is read as 32-bit
// words in P2's form (the uint8 buffer is little-endian: bit i of byte n
// is cell 8n+i, so word c >> 5 holds cell c at bit c & 31). Pass 1 counts
// m_tot with __ballot_sync/__popc; pass 2 gives each occupied step its
// 1-based rank (popc of the lower lanes' ballot bits) and the lane whose
// rank is selected writes its slot directly, from the inverse of
// `rank_targets` (the closed form of stratified_budget, ray_march.py:
// 320-338). Nothing of size (N, S) exists. With the coarse mask
// (`coarse_lookup`, :376-391, its own cell formula at G/8), a pass 0
// probes each 4-step block's first step, keeps the candidate-block bits in
// shared memory and finds the KB-th candidate; the fine passes then probe
// only candidate blocks up to it (a chunk of 8 blocks without a candidate
// is skipped whole) and `trunc_rays` counts the rays whose candidates went
// past KB (:500-512).
//
// H1 `march_bootstrap`, the bootstrap march of the first 512 training
// steps (`march_rays_train_dense` with coarse_occ=None, :402: S = 128
// steps of sqrt(3)/128, K = 16), is a launcher of H9's body without pass
// 0 and with every selected sample kept. At S <= 128 the uniform body
// keeps pass 1's (at most 4) ballot words in registers, and pass 2
// recomputes only its lane's t from them: no step's cell or bit is probed
// twice (the general grid's body keeps them in shared memory, below).
//
// H10 `march_fine_test_round`, the same warp probe from each ray's
// cursor over a window of S steps: K == 0 writes the whole (N, S) window
// (t, dt = lo or calc_dt(t), valid) and the cursor S steps on for alive
// rays (the grid restarts from each cursor, as JAX's t_step_grid); K > 0
// writes the first K occupied steps and the cursor just past the K-th, or
// past the window when fewer were found. Its writes bound the first-K
// mode at 0.0121 ms (9 bytes a slot at 65,536 rays, K 64); it runs at
// ~3x that, bound by its probes' instructions (~45 a lane a chunk on the
// uniform grid, up to four chunks a ray). A chunk loop that stops at the
// chunk of the K-th step, the probing lane writing its rank's slot,
// measured no slower than H9's kept-ballot body (the chunks' probes
// issued together or by pairs, the K-th step from the counts, a slot a
// lane from shared memory), and faster on the general grid (PERF.md §6):
// the loop stays, its `Uniform` probe multiplies where it divided
// (below), and its `Uniform` blocks take 32 registers, 8 blocks an SM.
//
// H11 `compact_samples`: (N, S) t, dt and valid into B ray-major slots in
// one launch, a thread a ray: each counts its row's valid steps (16-byte
// loads of the rows where they are 16-byte aligned), the block scans its
// 64 counts, and the blocks chain their prefixes by a single-pass scan
// with decoupled look-back (each publishes its aggregate, then its
// inclusive prefix, in one status word a block; a ticket gives the blocks
// their order, so a block waits only on blocks that already run). The
// valid samples then go to the slots from each ray's start, dropping
// those at or past B, with the ray's start and kept count: for rows of at
// most 32 steps (the training march's) the row is a bit mask and its t
// and dt, loaded before the scan, go in slot order into shared memory, from
// which a warp writes its 32 rays' slots a slot a lane (coalesced); longer
// rows (test rounds' windows) a ray at a time by its warp, 32 steps a lane. The blocks after the ray
// blocks wait for the last ray block's prefix, the total, and pad the
// slots after the last sample (ray N-1, t = dt = 0, invalid). The ticket
// and the status words live in a buffer kept for the device, zeroed once:
// each call is an epoch, counted in the ticket's word and written into its
// status words, so that a former call's words read as unpublished and the
// next call, or a CUDA graph's next replay, needs no memset.
//
// Scenes past scale 0.5 (several cascades, exp_step_factor 1/256): each
// kernel body is a template on its step grid. `Uniform` is the grid of
// one cascade and steps of lo, the code the bench runs. `Cascades` is the
// reference's general form: t_k of `t_step_grid`'s closed form (:99-143;
// steps of lo to A = lo/f, geometric with ratio 1 + f to B = hi/f, then
// steps of hi) from per-ray phase bounds kA, tA, jB, tB that each lane
// reads, dt = calc_dt(t_k) (:46-51), and the cell of `occupancy_lookup`'s
// multi-cascade branch (:88-96): mip the larger of the position's and
// the step's frexp exponents, x times the rounded reciprocal of
// min(2^(mip-1), scale), the bit at mip * G^3 + cell. A probe of it costs
// a few operations more than a uniform one, none of them a libm call:
// (1 + f)^j is read from a table of the launch (`pow_tab`, j = 0..S and
// more, built on the card by torch.pow, the plain version's own
// expression: ops/ray_march.py:pow_table), the reciprocal is the exact
// 2^(1-mip) wherever 2^(mip-1) <= scale and else 1/scale, which each
// thread divides once, and the frexp exponents are read from the floats'
// bits. The per-ray phase bounds keep CUDA's logf, as PyTorch's log on
// the card (no fast-math flag), and read tB's power from the table too
// unless jB lies past it (then CUDA's powf, as PyTorch's pow). Both grids
// grow with k, so a chunk whose first step is past t2 still ends a ray's
// walk. The `Cascades` train body (without the coarse mask) keeps each
// chunk's ballot of pass 1 and the occupied count before it in shared
// memory (2 * ceil(S / 32) words a warp), so that pass 2 probes nothing
// again and takes a lane a slot, as K1's phase C: each lane finds the
// chunk of its slot's target rank by a binary search of the counts and
// the step by the ballot's bits, and writes t, dt and valid coalesced.
// The `Uniform` bodies, the bench's code, keep their re-probing pass 2
// past 128 steps: their probe is a few operations.
//
// Exactness: t, xyz and the cells are the reference's operations in its
// order (t_step_grid :120, occupancy_lookup :83-86, coarse_lookup
// :387-390) with __fmul_rn/__fadd_rn/__fdiv_rn and --fmad=false, so
// samples at cell boundaries select the reference's cells. x / mip_bound
// is a division, or where mip_bound is a power of two (the bench's 0.5)
// the product with its exact reciprocal: the same float (`cell_of`). The
// cell, lattice-step and rank helpers are K1's too (march_common.cuh).
//
// Bound on the H100: latency and the 256 KB bitfield's cache traffic.
// P2's work at its shape is N*S probes; the outputs are 9 bytes per slot
// (H9: per kept sample; H10 full window: per step, 75 MB at 8192 x 1024).
// The design answers a one-thread-per-ray serial walk (2*S probes per
// thread, fewer than 2 warps per scheduler at 8190 rays) with 8190 warps
// that fill the 132 SMs, each step's probe on its own lane and the
// selection by ballots instead of a serial rank walk; a block adds its
// rays' rm (and trunc) to the batch totals with one atomic, not 8.
#include "look_back.cuh"
#include "march_common.cuh"

namespace {

constexpr int WARPS = 8;              // warps (rays) per block
constexpr int MAX_BLOCK_WORDS = 32;   // coarse candidate bits per warp

struct Ray {
  float ox, oy, oz, dx, dy, dz, t0, t2;
  bool hit;
};

// linear x-fastest cell of the point at t on a G^3 grid (inv_mb: 1 / mb
// where mb is a power of two, else 0: `cell_of`)
__device__ __forceinline__ int cell_at(const Ray& r, float t, float mb, int G,
                                       float inv_mb) {
  int cx = cell_of(__fadd_rn(r.ox, __fmul_rn(t, r.dx)), mb, G, inv_mb);
  int cy = cell_of(__fadd_rn(r.oy, __fmul_rn(t, r.dy)), mb, G, inv_mb);
  int cz = cell_of(__fadd_rn(r.oz, __fmul_rn(t, r.dz)), mb, G, inv_mb);
  return (cz * G + cy) * G + cx;
}

// P2's probe
__device__ __forceinline__ bool bit_at(const uint32_t* __restrict__ w, int c) {
  return (__ldg(w + (c >> 5)) >> (c & 31)) & 1u;
}

// The constants of the general grid past one cascade and a uniform step:
// cascades, and t_step_grid's and calc_dt's f (0 for a uniform grid: the
// host passes 0 where lo >= hi, as calc_dt is lo either way), hi, A =
// lo/f, B = hi/f, 1 + f, log(1 + f), scale, and the table of (1 + f)^j
// with its length (null and 0 where f is 0); and inv_mb, 1 / mb where the
// mip bound mb = min(0.5, scale) is a power of two, else 0, which only
// the `Uniform` grid reads (a kernel parameter, so that its probe's
// choice of product or division is uniform: computed on the card, it
// cost the uniform H10 ~11%). The kernels take it as their last
// parameter and build their grid from lo, mb and it.
struct GridArgs {
  int cascades;
  float f, hi, A, B, ratio, log_ratio, scale;
  const float* pow_tab;
  int pow_len;
  float inv_mb;
};

// The uniform step grid of one cascade (exp_step_factor 0): t_k = t0 +
// k*lo, dt = lo, the cell of `occupancy_lookup`'s one-cascade branch, x /
// mb taken as x * inv_mb where mb is a power of two.
struct Uniform {
  static constexpr bool KEEP_BALLOTS = false;
  static constexpr int TEST_BLOCKS = 8;   // H10's blocks an SM at least
  float lo, mb, inv_mb;
  struct Line { float t0; };
  __device__ static Uniform make(float lo, float mb, const GridArgs& g) {
    return {lo, mb, g.inv_mb};
  }
  __device__ float inv() const { return inv_mb; }
  __device__ Line line(float t0) const { return {t0}; }
  __device__ float t(const Line& l, int k) const { return step_t(l.t0, k, lo); }
  __device__ float dt(float) const { return lo; }
  __device__ bool bit(const uint32_t* __restrict__ w, const Ray& r, float t,
                      float, int G) const {
    return bit_at(w, cell_at(r, t, mb, G, inv_mb));
  }
};

// frexpf's exponent of a finite v >= 0: 0 at v == 0, as frexpf; a
// subnormal v reads as -126 where frexpf gives less, which the mip's
// clamp to [0, cascades - 1] takes to 0 either way
__device__ __forceinline__ int frexp_exponent(float v) {
  return v == 0.0f ? 0 : static_cast<int>(__float_as_uint(v) >> 23) - 126;
}

// The general grid: geometric steps when f != 0, `cascades` cascades.
struct Cascades {
  static constexpr bool KEEP_BALLOTS = true;
  static constexpr int TEST_BLOCKS = 6;   // H10's: 40 registers, no spill
  float lo, mb, inv_scale;
  GridArgs g;
  // t0 (t0s = max(t0, 0) on the geometric grid) and the phase bounds
  struct Line { float t0, kA, tA, jB, tB; };
  __device__ static Cascades make(float lo, float mb, const GridArgs& g) {
    return {lo, mb, __fdiv_rn(1.0f, g.scale), g};
  }
  __device__ float inv() const { return 0.0f; }   // x / mb divides
  __device__ Line line(float t0) const {
    Line l{t0, 0.0f, 0.0f, 0.0f, 0.0f};
    if (g.f == 0.0f) return l;
    l.t0 = fmaxf(t0, 0.0f);
    if (l.t0 <= g.A)
      l.kA = __fadd_rn(floorf(__fdiv_rn(__fsub_rn(g.A, l.t0), lo)), 1.0f);
    l.tA = __fadd_rn(l.t0, __fmul_rn(l.kA, lo));
    if (l.tA <= g.B) {
      const float q = logf(__fdiv_rn(g.B, fmaxf(l.tA, 1e-30f)));
      l.jB = __fadd_rn(floorf(__fdiv_rn(q, g.log_ratio)), 1.0f);
    }
    // jB may exceed the table: then the ray's one powf
    l.tB = __fmul_rn(l.tA, l.jB < static_cast<float>(g.pow_len)
                               ? __ldg(g.pow_tab + static_cast<int>(l.jB))
                               : powf(g.ratio, l.jB));
    return l;
  }
  // k <= 32 * ceil(S / 32), so the geometric phase's j < the table's length
  __device__ float t(const Line& l, int k) const {
    if (g.f == 0.0f) return step_t(l.t0, k, lo);
    const float kf = static_cast<float>(k);
    if (kf <= l.kA) return __fadd_rn(l.t0, __fmul_rn(kf, lo));
    const float j = __fsub_rn(kf, l.kA);
    if (j <= l.jB)
      return __fmul_rn(l.tA, __ldg(g.pow_tab + static_cast<int>(j)));
    return __fadd_rn(l.tB, __fmul_rn(__fsub_rn(j, l.jB), g.hi));
  }
  // calc_dt (CUDA clamp: lo wins when lo > hi)
  __device__ float dt(float t) const {
    return fmaxf(lo, fminf(__fmul_rn(t, g.f), g.hi));
  }
  __device__ bool bit(const uint32_t* __restrict__ w, const Ray& r, float t,
                      float dt, int G) const {
    const int C = g.cascades;
    if (C == 1) return bit_at(w, cell_at(r, t, mb, G, 0.0f));
    const float x = __fadd_rn(r.ox, __fmul_rn(t, r.dx));
    const float y = __fadd_rn(r.oy, __fmul_rn(t, r.dy));
    const float z = __fadd_rn(r.oz, __fmul_rn(t, r.dz));
    const int e_pos = frexp_exponent(fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z))));
    const int e_dt = frexp_exponent(__fmul_rn(dt, static_cast<float>(G)));
    const int mip = max(min(max(e_pos + 1, 0), C - 1),
                        min(max(e_dt, 0), C - 1));
    // min(2^(mip-1), scale) and its reciprocal: 2^(1-mip) exactly while
    // the power of two is the smaller, else 1/scale rounded once
    const float p = __int_as_float((126 + mip) << 23);
    const float inv = p <= g.scale ? __int_as_float((128 - mip) << 23)
                                   : inv_scale;
    const float bound = fminf(p, g.scale);
    const int cell = (cell_of(z, bound, G, inv) * G + cell_of(y, bound, G, inv))
                         * G + cell_of(x, bound, G, inv);
    return bit_at(w, mip * G * G * G + cell);
  }
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int n) {
  Ray r;
  r.ox = o[3 * n]; r.oy = o[3 * n + 1]; r.oz = o[3 * n + 2];
  r.dx = d[3 * n]; r.dy = d[3 * n + 1]; r.dz = d[3 * n + 2];
  return r;
}

// H9's body (and H1's: no COARSE; SHORT, S <= 128, on the uniform grid).
// The block's rm and trunc counts are summed in shared memory and added to
// `sums` by one atomic each, not one per ray. KEEP (the general grid
// without the coarse mask): the dynamic shared memory holds a warp's
// ceil(S / 32) ballots, then as many counts before them.
template <bool COARSE, class Steps>
__host__ __device__ constexpr bool keeps_ballots() {
  return !COARSE && Steps::KEEP_BALLOTS;
}

template <bool COARSE, bool SHORT, class Steps>
__global__ void __launch_bounds__(WARPS * 32) march_fine_train_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ hits_t, const uint32_t* __restrict__ bits,
    const float* __restrict__ noise, const uint8_t* __restrict__ coarse,
    int N, int S, int K, int Kout, int tail_k, int G, int KB, float lo,
    float mb, float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, int* __restrict__ count_out,
    int* __restrict__ sums, const GridArgs ga) {
  constexpr bool KEEP = keeps_ballots<COARSE, Steps>();
  const Steps st = Steps::make(lo, mb, ga);
  __shared__ unsigned cand_s[COARSE ? WARPS : 1][COARSE ? MAX_BLOCK_WORDS : 1];
  extern __shared__ unsigned kept_s[];
  __shared__ int warp_rm[WARPS], warp_cut[WARPS];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + wib;
  int rm = 0;
  bool cut = false;
  if (n < N) {   // the whole warp takes this branch or not
    Ray r = load_ray(rays_o, rays_d, n);
    const float t1 = hits_t[2 * n];
    r.t2 = hits_t[2 * n + 1];
    r.hit = t1 >= 0.0f;
    r.t0 = __fadd_rn(t1, __fmul_rn(st.dt(t1), noise[n]));
    const typename Steps::Line line = st.line(r.t0);
    unsigned* cand = cand_s[COARSE ? wib : 0];

    // pass 0 (two-level march): the candidate blocks, and the KB-th of them
    int k_end = S;          // fine steps probed: k < k_end
    bool extra = false;     // a candidate block past the KB-th exists
    if constexpr (COARSE) {
      const int n_blocks = S / 4;
      int found = 0, kb_block = -1;
      for (int jw = 0; jw * 32 < n_blocks; ++jw) {
        if (!r.hit || !(st.t(line, 4 * 32 * jw) < r.t2)) break;
        const int b = jw * 32 + lane;
        bool c = false;
        if (b < n_blocks) {
          float tb = st.t(line, 4 * b);
          c = tb < r.t2 &&
              coarse[cell_at(r, tb, st.mb, G / 8, st.inv())] > 0;
        }
        const unsigned m = __ballot_sync(FULL, c);
        if (lane == 0) cand[jw] = m;
        const int pc = __popc(m);
        if (kb_block >= 0) {          // only whether more candidates exist
          extra = pc > 0;
          if (extra) break;
          continue;
        }
        if (found + pc >= KB) {
          const int need = KB - found;
          kb_block = jw * 32 + nth_bit(m, need);
          extra = pc > need;
          if (extra) break;
        }
        found += pc;
      }
      // fewer than KB candidates: every block may hold kept steps (the
      // words never scanned lie past t2, where no chunk is probed)
      if (kb_block >= 0) k_end = 4 * (kb_block + 1);
      __syncwarp();
    }

    // one chunk of 32 steps: the occupied-and-kept ballot of steps 32j + lane
    auto probe = [&](int j) -> unsigned {
      const int k = 32 * j + lane;
      const float t = st.t(line, k);
      bool inc = k < k_end && t < r.t2;
      if (COARSE && inc) {
        const int blk = k >> 2;
        inc = (cand[blk >> 5] >> (blk & 31)) & 1u;
      }
      if (inc) inc = st.bit(bits, r, t, st.dt(t), G);
      return __ballot_sync(FULL, inc);
    };
    // a chunk is skipped whole when its first step is past t2 (t grows with
    // k) or, in the two-level march, when its 8 blocks hold no candidate
    auto chunk_live = [&](int j) -> bool {
      if (!r.hit || 32 * j >= k_end || !(st.t(line, 32 * j) < r.t2))
        return false;
      if (COARSE) return ((cand[j >> 2] >> ((8 * j) & 31)) & 0xffu) != 0u;
      return true;
    };

    // pass 1: occupied count; with KEEP the live chunks' ballots and the
    // counts before them go to shared memory, at S <= 128 the (at most 4)
    // ballots to registers, so that pass 2 probes nothing again
    int m_tot = 0;
    const int n_chunks = (k_end + 31) / 32;
    unsigned word[4] = {0u, 0u, 0u, 0u};
    unsigned* ballot = kept_s + (KEEP ? 2 * wib * n_chunks : 0);
    int* before = reinterpret_cast<int*>(ballot + n_chunks);
    int n_live = 0;
    if constexpr (KEEP) {
      // the chunk's own in-range ballot is its guard (t grows with k): no
      // step is computed twice
      for (int j = 0; r.hit && j < n_chunks; ++j) {
        const int k = 32 * j + lane;
        const float t = st.t(line, k);
        bool inc = k < k_end && t < r.t2;
        if (!__any_sync(FULL, inc)) break;
        if (inc) inc = st.bit(bits, r, t, st.dt(t), G);
        const unsigned m = __ballot_sync(FULL, inc);
        if (lane == 0) {
          ballot[j] = m;
          before[j] = m_tot;
        }
        m_tot += __popc(m);
        n_live = j + 1;
      }
      __syncwarp();
    } else if constexpr (SHORT) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (chunk_live(j)) {
          word[j] = probe(j);
          m_tot += __popc(word[j]);
        }
    } else {
      for (int j = 0; j < n_chunks; ++j) {
        if (!r.hit || !(st.t(line, 32 * j) < r.t2)) break;
        if (chunk_live(j)) m_tot += __popc(probe(j));
      }
    }

    const bool tail = tail_k > 0;
    const int K1 = tail ? max(K - tail_k, 0) : K;
    const int K2 = tail_k;
    const int E = max(m_tot - K1, 0);
    // rm: the samples stratified_budget selects; the first Kout are kept
    rm = tail ? min(m_tot, K1) + min(E, K2) : min(m_tot, K);
    const int n_valid = min(rm, Kout);
    const size_t base = static_cast<size_t>(n) * Kout;

    // pass 2, KEEP: a lane a slot, the step of its target rank from the
    // chunk whose count before it is the last below the rank
    if constexpr (KEEP) {
      for (int i = lane; i < n_valid; i += 32) {
        int span;
        const int rank = target_rank(i, K1, K2, E, tail, &span);
        int lo_c = 0, hi_c = n_live;
        while (hi_c - lo_c > 1) {
          const int mid = (lo_c + hi_c) >> 1;
          if (before[mid] < rank) lo_c = mid;
          else hi_c = mid;
        }
        const float t =
            st.t(line, 32 * lo_c + nth_bit(ballot[lo_c], rank - before[lo_c]));
        t_out[base + i] = t;
        dt_out[base + i] = __fmul_rn(st.dt(t), static_cast<float>(span));
        valid_out[base + i] = 1;
      }
    }
    // pass 2, otherwise: each kept rank writes its slot
    if (!KEEP && n_valid > 0) {
      const int last = target_rank(n_valid - 1, K1, K2, E, tail);
      int seen = 0;
      auto emit = [&](int j, unsigned m) {
        if ((m >> lane) & 1u) {
          int span;
          const int slot = slot_of_rank(seen + __popc(m & lanes_below()) + 1,
                                        K1, K2, E, tail, &span);
          if (slot >= 0 && slot < n_valid) {
            const float t = st.t(line, 32 * j + lane);
            t_out[base + slot] = t;
            dt_out[base + slot] = __fmul_rn(st.dt(t), static_cast<float>(span));
            valid_out[base + slot] = 1;
          }
        }
        seen += __popc(m);
      };
      if constexpr (SHORT) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (seen < last) emit(j, word[j]);
      } else {
        for (int j = 0; j < n_chunks && seen < last; ++j)
          if (chunk_live(j)) emit(j, probe(j));
      }
    }
    for (int slot = n_valid + lane; slot < Kout; slot += 32) {
      t_out[base + slot] = 0.0f;
      dt_out[base + slot] = 0.0f;
      valid_out[base + slot] = 0;
    }
    if (lane == 0) count_out[n] = n_valid;
    // first-K: only under-filled rays lost samples; a stratified tail is
    // biased by any skipped candidate block
    cut = extra && (tail || n_valid < K);
  }
  if (lane == 0) {
    warp_rm[wib] = rm;
    warp_cut[wib] = cut;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += warp_rm[w];
      c += warp_cut[w];
    }
    if (a) atomicAdd(sums, a);
    if (COARSE && c) atomicAdd(sums + 1, c);
  }
}

// H10: a warp a ray, chunk by chunk from its cursor (the file note). At
// least Steps::TEST_BLOCKS blocks an SM: 8 on the `Uniform` grid (32
// registers a thread), 6 on the general one (its probe spills at 32
// registers, and takes 50 when the bound leaves it free).
template <class Steps>
__global__ void __launch_bounds__(WARPS * 32, Steps::TEST_BLOCKS)
    march_fine_test_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ cursor, const float* __restrict__ t_far,
    const uint8_t* __restrict__ alive, const uint32_t* __restrict__ bits,
    int N, int S, int K, int G, float lo, float mb, float* __restrict__ t_out,
    float* __restrict__ dt_out, uint8_t* __restrict__ valid_out,
    float* __restrict__ cursor_out, const GridArgs ga) {
  const Steps st = Steps::make(lo, mb, ga);
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  Ray r = load_ray(rays_o, rays_d, n);
  const float cur = cursor[n];
  const bool al = alive[n];
  r.t0 = cur;
  r.t2 = t_far[n];
  r.hit = al && cur >= 0.0f;
  const typename Steps::Line line = st.line(cur);
  const int n_chunks = (S + 31) / 32;

  if (K == 0) {   // full window: every step written, masked by valid
    const size_t base = static_cast<size_t>(n) * S;
    for (int j = 0; j < n_chunks; ++j) {
      const int k = 32 * j + lane;
      if (k >= S) break;
      const float t = st.t(line, k);
      const float dt = st.dt(t);
      bool v = r.hit && t < r.t2;
      if (v) v = st.bit(bits, r, t, dt, G);
      t_out[base + k] = t;
      dt_out[base + k] = dt;
      valid_out[base + k] = v;
    }
    if (lane == 0) cursor_out[n] = al ? st.t(line, S) : cur;
    return;
  }

  // first K occupied steps of the window
  const size_t base = static_cast<size_t>(n) * K;
  int found = 0, last_k = -1;
  for (int j = 0; j < n_chunks && found < K; ++j) {
    if (!r.hit || !(st.t(line, 32 * j) < r.t2)) break;
    const int k = 32 * j + lane;
    const float t = st.t(line, k);
    const float dt = st.dt(t);
    bool v = k < S && t < r.t2;
    if (v) v = st.bit(bits, r, t, dt, G);
    const unsigned m = __ballot_sync(FULL, v);
    const int rank = found + __popc(m & lanes_below());
    if (v && rank < K) {
      t_out[base + rank] = t;
      dt_out[base + rank] = dt;
      valid_out[base + rank] = 1;
    }
    const int pc = __popc(m);
    if (found + pc >= K) last_k = 32 * j + nth_bit(m, K - found);
    found += pc;
  }
  for (int slot = min(found, K) + lane; slot < K; slot += 32) {
    t_out[base + slot] = 0.0f;
    dt_out[base + slot] = 0.0f;
    valid_out[base + slot] = 0;
  }
  if (lane == 0)
    cursor_out[n] = st.t(line, found >= K ? last_k + 1 : S);
}

// H11: a ray a thread, COMPACT_THREADS rays a block
constexpr int COMPACT_THREADS = 64;
constexpr int COMPACT_WARPS = COMPACT_THREADS / 32;
constexpr int NARROW_S = 32;   // rows of at most this many steps: a mask a ray
// the slots a padding thread writes
constexpr int PAD_PER_THREAD = 8;
// steps [c, c + 16) of a row of `include` as 4 words, a byte a step;
// bytes at or past S read as 0. VEC: one 16-byte load (S % 16 == 0, the
// rows 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void row_chunk(const uint8_t* __restrict__ row,
                                          int c, int S, unsigned (&w)[4]) {
  if constexpr (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = c + 4 * q + b;
        if (s < S) v |= static_cast<unsigned>(__ldg(row + s)) << (8 * b);
      }
      w[q] = v;
    }
  }
}

// bit i set where step c + i of the chunk is included (16 bits)
__device__ __forceinline__ unsigned chunk_mask(const unsigned (&w)[4]) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned x = __vcmpne4(w[q], 0u) & 0x80808080u;   // a byte's top bit
    m |= ((x >> 7 | x >> 14 | x >> 21 | x >> 28) & 15u) << (4 * q);
  }
  return m;
}

// steps [c, c + 16) of a row of t or dt, issued together (VEC: four
// 16-byte loads); values at or past S read as 0
template <bool VEC>
__device__ __forceinline__ void value_chunk(const float* __restrict__ row,
                                            int c, int S, float* v) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row + c) + q);
      v[4 * q] = u.x; v[4 * q + 1] = u.y; v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = c + i < S ? __ldg(row + c + i) : 0.0f;
  }
}

// Padding block p (of n_pad after the ray blocks): the slots from the
// total, the last ray block's inclusive prefix, to B.
__device__ __forceinline__ void pad_slots(
    const unsigned long long* status, unsigned long long tag, int n_tiles,
    int p, int n_pad, int N, int B, int* __restrict__ ray_id,
    float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out) {
  __shared__ int s_total;
  if (threadIdx.x == 0) s_total = scan::wait_prefix(status, tag, n_tiles - 1);
  __syncthreads();
  for (int b = min(s_total, B) + p * COMPACT_THREADS + threadIdx.x; b < B;
       b += n_pad * COMPACT_THREADS) {
    ray_id[b] = N - 1;
    t_out[b] = 0.0f;
    dt_out[b] = 0.0f;
    valid_out[b] = 0;
  }
}

// Ray block `tile`: the counts, the scan, and the samples' slots. WIDE:
// rows of more than NARROW_S steps; each warp writes its rays' samples a ray
// at a time (coalesced along the ray). Else each ray's row is a 32-bit mask
// with its t and dt in registers; each lane puts its ray's samples in their
// order into the warp's stretch of shared memory, and the warp copies the
// stretch to its slots a slot a lane: coalesced stores.
template <bool VEC, bool WIDE>
__device__ __forceinline__ void compact_rays(
    const float* __restrict__ tg, const float* __restrict__ dtg,
    const uint8_t* __restrict__ include, int N, int S, int B, int n_tiles,
    int tile, unsigned long long* status, unsigned long long tag,
    int* __restrict__ ray_id, float* __restrict__ t_out,
    float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, int* __restrict__ ray_start,
    int* __restrict__ ray_count, int* __restrict__ rm_out) {
  __shared__ int s_prefix, s_warp[COMPACT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tile * COMPACT_THREADS + tid;
  const size_t base = static_cast<size_t>(n) * S;
  const uint8_t* row = include + base;
  // the count, and (narrow rows) the row's t and dt, all loads issued
  // together before the scan so that their latency overlaps it
  int cnt = 0;
  unsigned mask = 0;
  float tv[WIDE ? 1 : NARROW_S], dtv[WIDE ? 1 : NARROW_S];
  if (n < N) {
    if constexpr (!WIDE) {
#pragma unroll
      for (int c = 0; c < NARROW_S; c += 16) {   // constant c: registers
        if (c < S) {
          value_chunk<VEC>(tg + base, c, S, tv + c);
          value_chunk<VEC>(dtg + base, c, S, dtv + c);
        }
      }
    }
    for (int c = 0; c < S; c += 16) {
      unsigned w[4];
      row_chunk<VEC>(row, c, S, w);
      const unsigned m = chunk_mask(w);
      if constexpr (WIDE)
        cnt += __popc(m);
      else
        mask |= m << c;
    }
    if constexpr (!WIDE) cnt = __popc(mask);
  }
  // the block's exclusive scan of the counts
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
    const int prefix = scan::look_back(status, tag, tile, agg, lane);
    if (lane < COMPACT_WARPS) s_warp[lane] = v;
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == n_tiles - 1) *rm_out = prefix + agg;
    }
  }
  __syncthreads();
  const int st = s_prefix + (warp ? s_warp[warp - 1] : 0) + x - cnt;
  if (n < N) {
    ray_start[n] = min(st, B);
    ray_count[n] = max(min(B - st, cnt), 0);
  }

  if constexpr (WIDE) {
    // the warp takes its 32 rays in turn, 32 steps a lane at a time: each
    // step's rank by a ballot, the stores coalesced along the ray
    const int ray0 = tile * COMPACT_THREADS + warp * 32;
    for (int r = 0; r < 32 && ray0 + r < N; ++r) {
      const int r_st = __shfl_sync(FULL, st, r);
      const int r_end = min(r_st + __shfl_sync(FULL, cnt, r), B);
      const size_t r_base = static_cast<size_t>(ray0 + r) * S;
      int pos = r_st;
#pragma unroll 2
      for (int s0 = 0; s0 < S && pos < r_end; s0 += 32) {
        const int s = s0 + lane;
        const bool in = s < S;
        const bool v = in && include[r_base + s];
        const float t = in ? tg[r_base + s] : 0.0f;
        const float dt = in ? dtg[r_base + s] : 0.0f;
        const unsigned m = __ballot_sync(FULL, v);
        const int q = pos + __popc(m & lanes_below());
        if (v && q < r_end) {
          ray_id[q] = ray0 + r;
          t_out[q] = t;
          dt_out[q] = dt;
          valid_out[q] = 1;
        }
        pos += __popc(m);
      }
    }
  } else {
    // the warp's samples in slot order in shared memory (each lane its own
    // ray's, from registers), then copied out a slot a lane
    constexpr int WARP_SLOTS = 32 * NARROW_S;
    __shared__ float s_t[COMPACT_WARPS][WARP_SLOTS];
    __shared__ float s_dt[COMPACT_WARPS][WARP_SLOTS];
    __shared__ uint8_t s_lane[COMPACT_WARPS][WARP_SLOTS];
    const int first = __shfl_sync(FULL, st, 0);
    const int total = __shfl_sync(FULL, st + cnt, 31) - first;
    int pos = st - first;
#pragma unroll
    for (int s = 0; s < NARROW_S; ++s) {   // constant s: registers
      if ((mask >> s) & 1u) {
        s_t[warp][pos] = tv[s];
        s_dt[warp][pos] = dtv[s];
        s_lane[warp][pos] = static_cast<uint8_t>(lane);
        ++pos;
      }
    }
    __syncwarp();
    const int ray0 = tile * COMPACT_THREADS + warp * 32;
    const int count = min(total, B - first);
#pragma unroll 4
    for (int i = lane; i < count; i += 32) {
      const int q = first + i;
      ray_id[q] = ray0 + s_lane[warp][i];
      t_out[q] = s_t[warp][i];
      dt_out[q] = s_dt[warp][i];
      valid_out[q] = 1;
    }
  }
}

// The ray blocks, then the padding blocks, in the order of their tickets.
// work: [the epoch (high half) and the ticket (low half), a status word a
// ray block]. The block that takes the call's last ticket starts the next
// epoch at ticket 0.
template <bool VEC, bool WIDE>
__global__ void __launch_bounds__(COMPACT_THREADS) compact_kernel(
    const float* __restrict__ tg, const float* __restrict__ dtg,
    const uint8_t* __restrict__ include, int N, int S, int B, int n_tiles,
    unsigned long long* __restrict__ work, int* __restrict__ ray_id,
    float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, int* __restrict__ ray_start,
    int* __restrict__ ray_count, int* __restrict__ rm_out) {
  unsigned long long* status = work + 1;
  const scan::Ticket ticket = scan::take_ticket(work);
  const int tile = ticket.index;
  const unsigned long long tag = ticket.tag;
  if (tile >= n_tiles)
    pad_slots(status, tag, n_tiles, tile - n_tiles, gridDim.x - n_tiles, N,
              B, ray_id, t_out, dt_out, valid_out);
  else
    compact_rays<VEC, WIDE>(tg, dtg, include, N, S, B, n_tiles, tile, status,
                            tag, ray_id, t_out, dt_out, valid_out, ray_start,
                            ray_count, rm_out);
}

template <bool COARSE, bool SHORT, class Steps>
int launch_train(const void* rays_o, const void* rays_d, const void* hits_t,
                 const void* bitfield, const void* noise, const void* coarse,
                 int N, int S, int K, int Kout, int tail_k, int G, int KB,
                 float lo, float mip_bound, const GridArgs& ga, void* t_out,
                 void* dt_out, void* valid_out, void* count_out, void* sums,
                 cudaStream_t stream) {
  const auto kernel = march_fine_train_kernel<COARSE, SHORT, Steps>;
  size_t smem = 0;
  if constexpr (keeps_ballots<COARSE, Steps>()) {
    smem = sizeof(unsigned) * 2 * WARPS * ((S + 31) / 32);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  kernel<<<ncn_blocks(N, WARPS), WARPS * 32, smem, stream>>>(
          static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
          static_cast<const float*>(hits_t),
          static_cast<const uint32_t*>(bitfield),
          static_cast<const float*>(noise), static_cast<const uint8_t*>(coarse),
          N, S, K, Kout, tail_k, G, KB, lo, mip_bound,
          static_cast<float*>(t_out), static_cast<float*>(dt_out),
          static_cast<uint8_t*>(valid_out), static_cast<int*>(count_out),
          static_cast<int*>(sums), ga);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H1, H9 and H10 take, after lo and mip_bound = min(0.5, scale), the
// `GridArgs` values as arguments: cascades, f, hi, A, B, ratio, log_ratio,
// scale (ops/ray_march.py:step_args rounds them as JAX does), pow_tab,
// (1 + f)^j for j < pow_len (f32), and pow_len, at least 32 * ceil(S / 32)
// + 1 (null and 0 where f is 0). One cascade and f = 0 run the `Uniform`
// bodies, the rest the `Cascades` ones.
//
// coarse may be null (no two-level march: KB must then be 0). sums: [rm,
// trunc], zeroed by the caller (trunc is written only when KB > 0).
extern "C" int march_fine_train(const void* rays_o, const void* rays_d,
                                const void* hits_t, const void* bitfield,
                                const void* noise, const void* coarse, int N,
                                int S, int K, int Kout, int tail_k, int G,
                                int KB, float lo, float mip_bound,
                                int cascades, float f, float hi, float A,
                                float B, float ratio, float log_ratio,
                                float scale, const void* pow_tab,
                                int pow_len, void* t_out, void* dt_out,
                                void* valid_out, void* count_out, void* sums,
                                cudaStream_t stream) {
  if ((KB > 0 && (coarse == nullptr || S / 4 > 32 * MAX_BLOCK_WORDS)) ||
      cascades < 1 ||
      (f != 0.0f && (pow_tab == nullptr || pow_len <= 32 * ((S + 31) / 32))))
    return static_cast<int>(cudaErrorInvalidValue);
  const GridArgs ga{cascades, f, hi, A, B, ratio, log_ratio, scale,
                    static_cast<const float*>(pow_tab), pow_len,
                    pow2_inverse(mip_bound)};
  const bool uniform = cascades == 1 && f == 0.0f;
  auto launch =
      KB > 0 ? (uniform ? launch_train<true, false, Uniform>
                        : launch_train<true, false, Cascades>)
      : !uniform ? launch_train<false, false, Cascades>
      : S <= 128 ? launch_train<false, true, Uniform>
                 : launch_train<false, false, Uniform>;
  return launch(rays_o, rays_d, hits_t, bitfield, noise, coarse, N, S, K,
                Kout, tail_k, G, KB, lo, mip_bound, ga, t_out, dt_out,
                valid_out, count_out, sums, stream);
}

// H1: the bootstrap march, H9 without the coarse mask and with every
// selected sample kept (Kout = K); rm_out: one int, zeroed by the caller.
extern "C" int march_bootstrap(const void* rays_o, const void* rays_d,
                               const void* hits_t, const void* bitfield,
                               const void* noise, int N, int S, int K,
                               int tail_k, int G, float lo, float mip_bound,
                               int cascades, float f, float hi, float A,
                               float B, float ratio, float log_ratio,
                               float scale, const void* pow_tab, int pow_len,
                               void* t_out, void* dt_out, void* valid_out,
                               void* count_out, void* rm_out,
                               cudaStream_t stream) {
  return march_fine_train(rays_o, rays_d, hits_t, bitfield, noise, nullptr, N,
                          S, K, K, tail_k, G, 0, lo, mip_bound, cascades, f,
                          hi, A, B, ratio, log_ratio, scale, pow_tab, pow_len,
                          t_out, dt_out, valid_out, count_out, rm_out,
                          stream);
}

// K == 0: full-window mode, (N, S) outputs; K > 0: first-K mode, (N, K).
extern "C" int march_fine_test_round(const void* rays_o, const void* rays_d,
                                     const void* cursor, const void* t_far,
                                     const void* alive, const void* bitfield,
                                     int N, int S, int K, int G, float lo,
                                     float mip_bound, int cascades, float f,
                                     float hi, float A, float B, float ratio,
                                     float log_ratio, float scale,
                                     const void* pow_tab, int pow_len,
                                     void* t_out, void* dt_out,
                                     void* valid_out, void* cursor_out,
                                     cudaStream_t stream) {
  if (K < 0 || K > S || cascades < 1 ||
      (f != 0.0f && (pow_tab == nullptr || pow_len <= 32 * ((S + 31) / 32))))
    return static_cast<int>(cudaErrorInvalidValue);
  const GridArgs ga{cascades, f, hi, A, B, ratio, log_ratio, scale,
                    static_cast<const float*>(pow_tab), pow_len,
                    pow2_inverse(mip_bound)};
  auto kernel = cascades == 1 && f == 0.0f ? march_fine_test_kernel<Uniform>
                                           : march_fine_test_kernel<Cascades>;
  kernel<<<ncn_blocks(N, WARPS), WARPS * 32, 0, stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(cursor), static_cast<const float*>(t_far),
      static_cast<const uint8_t*>(alive),
      static_cast<const uint32_t*>(bitfield), N, S, K, G, lo, mip_bound,
      static_cast<float*>(t_out),
      static_cast<float*>(dt_out), static_cast<uint8_t*>(valid_out),
      static_cast<float*>(cursor_out), ga);
  return static_cast<int>(cudaGetLastError());
}

// work: at least 1 + ceil(N / COMPACT_THREADS) 64-bit words (the epoch and
// ticket, a status word a ray block), zeroed once: a buffer kept for the
// device, whose calls must be ordered on one stream. The rm_out int is the
// included samples before the budget cut.
extern "C" int compact_samples(const void* tg, const void* dtg,
                               const void* include, int N, int S, int B,
                               void* work, void* ray_id, void* t_out,
                               void* dt_out, void* valid_out, void* ray_start,
                               void* ray_count, void* rm_out,
                               cudaStream_t stream) {
  if (N < 1 || S < 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = ncn_blocks(N, COMPACT_THREADS);
  const int n_pad = ncn_blocks(B, COMPACT_THREADS * PAD_PER_THREAD);
  const bool vec = S % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(include) |
                     reinterpret_cast<uintptr_t>(tg) |
                     reinterpret_cast<uintptr_t>(dtg)) & 15) == 0;
  auto kernel = S > NARROW_S ? (vec ? compact_kernel<true, true>
                                     : compact_kernel<false, true>)
                             : (vec ? compact_kernel<true, false>
                                    : compact_kernel<false, false>);
  kernel<<<n_tiles + n_pad, COMPACT_THREADS, 0, stream>>>(
      static_cast<const float*>(tg), static_cast<const float*>(dtg),
      static_cast<const uint8_t*>(include), N, S, B, n_tiles,
      static_cast<unsigned long long*>(work), static_cast<int*>(ray_id),
      static_cast<float*>(t_out), static_cast<float*>(dt_out),
      static_cast<uint8_t*>(valid_out), static_cast<int*>(ray_start),
      static_cast<int*>(ray_count), static_cast<int*>(rm_out));
  return static_cast<int>(cudaGetLastError());
}
