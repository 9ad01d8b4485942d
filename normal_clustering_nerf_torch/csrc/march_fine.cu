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
// 0 and with every selected sample kept. At S <= 128 the body keeps pass
// 1's (at most 4) ballot words in registers, and pass 2 recomputes only
// its lane's t from them: no step's cell or bit is probed twice.
//
// H10 `march_fine_test_round`, the same warp probe from each ray's
// cursor over a window of S steps: K == 0 writes the whole (N, S) window
// (t, dt = lo or calc_dt(t), valid) and the cursor S steps on for alive
// rays (the grid restarts from each cursor, as JAX's t_step_grid); K > 0
// writes the first K occupied steps and the cursor just past the K-th, or
// past the window when fewer were found.
//
// H11 `compact_samples`: given (N, S) t, dt and valid, each ray's count
// and the exclusive scan of the counts (torch.sum / torch.cumsum in the
// wrapper), a warp per ray writes its valid samples ray-major from its
// start, dropping those at or past the budget B, and the grid pads the
// slots after the last sample (ray N-1, t = dt = 0, invalid).
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
// min(2^(mip-1), scale), the bit at mip * G^3 + cell. Its logf and powf
// are CUDA's, as PyTorch's log and pow on the card (no fast-math flag).
// Both grids grow with k, so a chunk whose first step is past t2 still
// ends a ray's walk.
//
// Exactness: t, xyz and the cells are the reference's operations in its
// order (t_step_grid :120, occupancy_lookup :83-86, coarse_lookup
// :387-390) with __fmul_rn/__fadd_rn/__fdiv_rn and --fmad=false (x /
// mip_bound stays a division), so samples at cell boundaries select the
// reference's cells. The cell, lattice-step and rank helpers are K1's too
// (march_common.cuh).
//
// Bound on the H100: latency and the 256 KB bitfield's cache traffic.
// P2's work at its shape is N*S probes; the outputs are 9 bytes per slot
// (H9: per kept sample; H10 full window: per step, 75 MB at 8192 x 1024).
// The design answers a one-thread-per-ray serial walk (2*S probes per
// thread, fewer than 2 warps per scheduler at 8190 rays) with 8190 warps
// that fill the 132 SMs, each step's probe on its own lane and the
// selection by ballots instead of a serial rank walk; a block adds its
// rays' rm (and trunc) to the batch totals with one atomic, not 8.
#include "march_common.cuh"

namespace {

constexpr int WARPS = 8;              // warps (rays) per block
constexpr int MAX_BLOCK_WORDS = 32;   // coarse candidate bits per warp

struct Ray {
  float ox, oy, oz, dx, dy, dz, t0, t2;
  bool hit;
};

// linear x-fastest cell of the point at t on a G^3 grid
__device__ __forceinline__ int cell_at(const Ray& r, float t, float mb, int G) {
  int cx = cell_of(__fadd_rn(r.ox, __fmul_rn(t, r.dx)), mb, G);
  int cy = cell_of(__fadd_rn(r.oy, __fmul_rn(t, r.dy)), mb, G);
  int cz = cell_of(__fadd_rn(r.oz, __fmul_rn(t, r.dz)), mb, G);
  return (cz * G + cy) * G + cx;
}

// P2's probe
__device__ __forceinline__ bool bit_at(const uint32_t* __restrict__ w, int c) {
  return (__ldg(w + (c >> 5)) >> (c & 31)) & 1u;
}

// The constants of the general grid past one cascade and a uniform step:
// cascades, and t_step_grid's and calc_dt's f (0 for a uniform grid: the
// host passes 0 where lo >= hi, as calc_dt is lo either way), hi, A =
// lo/f, B = hi/f, 1 + f, log(1 + f), and scale. The kernels take it as
// their last parameter and build their grid from lo, mb and it, so that
// the `Uniform` bodies see the parameters they saw before it existed.
struct GridArgs {
  int cascades;
  float f, hi, A, B, ratio, log_ratio, scale;
};

// The uniform step grid of one cascade (exp_step_factor 0): t_k = t0 +
// k*lo, dt = lo, the cell of `occupancy_lookup`'s one-cascade branch.
struct Uniform {
  float lo, mb;
  struct Line { float t0; };
  __device__ static Uniform make(float lo, float mb, const GridArgs&) {
    return {lo, mb};
  }
  __device__ Line line(float t0) const { return {t0}; }
  __device__ float t(const Line& l, int k) const { return step_t(l.t0, k, lo); }
  __device__ float dt(float) const { return lo; }
  __device__ bool bit(const uint32_t* __restrict__ w, const Ray& r, float t,
                      float, int G) const {
    return bit_at(w, cell_at(r, t, mb, G));
  }
};

// The general grid: geometric steps when f != 0, `cascades` cascades.
struct Cascades {
  float lo, mb;
  GridArgs g;
  // t0 (t0s = max(t0, 0) on the geometric grid) and the phase bounds
  struct Line { float t0, kA, tA, jB, tB; };
  __device__ static Cascades make(float lo, float mb, const GridArgs& g) {
    return {lo, mb, g};
  }
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
    l.tB = __fmul_rn(l.tA, powf(g.ratio, l.jB));
    return l;
  }
  __device__ float t(const Line& l, int k) const {
    if (g.f == 0.0f) return step_t(l.t0, k, lo);
    const float kf = static_cast<float>(k);
    if (kf <= l.kA) return __fadd_rn(l.t0, __fmul_rn(kf, lo));
    const float j = __fsub_rn(kf, l.kA);
    if (j <= l.jB) return __fmul_rn(l.tA, powf(g.ratio, j));
    return __fadd_rn(l.tB, __fmul_rn(__fsub_rn(j, l.jB), g.hi));
  }
  // calc_dt (CUDA clamp: lo wins when lo > hi)
  __device__ float dt(float t) const {
    return fmaxf(lo, fminf(__fmul_rn(t, g.f), g.hi));
  }
  __device__ bool bit(const uint32_t* __restrict__ w, const Ray& r, float t,
                      float dt, int G) const {
    const int C = g.cascades;
    if (C == 1) return bit_at(w, cell_at(r, t, mb, G));
    const float x = __fadd_rn(r.ox, __fmul_rn(t, r.dx));
    const float y = __fadd_rn(r.oy, __fmul_rn(t, r.dy));
    const float z = __fadd_rn(r.oz, __fmul_rn(t, r.dz));
    int e_pos, e_dt;
    frexpf(fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z))), &e_pos);
    frexpf(__fmul_rn(dt, static_cast<float>(G)), &e_dt);
    const int mip = max(min(max(e_pos + 1, 0), C - 1),
                        min(max(e_dt, 0), C - 1));
    const float bound = fminf(ldexpf(1.0f, mip - 1), g.scale);
    const float inv = __fdiv_rn(1.0f, bound);
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

// H9's body (and H1's, with neither COARSE nor more than 128 steps). The
// block's rm and trunc counts are summed in shared memory and added to
// `sums` by one atomic each, not one per ray.
template <bool COARSE, bool SHORT, class Steps>
__global__ void __launch_bounds__(WARPS * 32) march_fine_train_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ hits_t, const uint32_t* __restrict__ bits,
    const float* __restrict__ noise, const uint8_t* __restrict__ coarse,
    int N, int S, int K, int Kout, int tail_k, int G, int KB, float lo,
    float mb, float* __restrict__ t_out, float* __restrict__ dt_out,
    uint8_t* __restrict__ valid_out, int* __restrict__ count_out,
    int* __restrict__ sums, const GridArgs ga) {
  const Steps st = Steps::make(lo, mb, ga);
  __shared__ unsigned cand_s[COARSE ? WARPS : 1][COARSE ? MAX_BLOCK_WORDS : 1];
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
          c = tb < r.t2 && coarse[cell_at(r, tb, st.mb, G / 8)] > 0;
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

    // pass 1: occupied count; at S <= 128 the (at most 4) ballots are kept
    // in registers, so pass 2 probes nothing again
    int m_tot = 0;
    const int n_chunks = (k_end + 31) / 32;
    unsigned word[4] = {0u, 0u, 0u, 0u};
    if constexpr (SHORT) {
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

    // pass 2: each kept rank writes its slot
    if (n_valid > 0) {
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

template <class Steps>
__global__ void __launch_bounds__(WARPS * 32) march_fine_test_kernel(
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

__global__ void __launch_bounds__(WARPS * 32) compact_kernel(
    const float* __restrict__ tg, const float* __restrict__ dtg,
    const uint8_t* __restrict__ include, const int* __restrict__ count,
    const int* __restrict__ start, int N, int S, int B,
    int* __restrict__ ray_id, float* __restrict__ t_out,
    float* __restrict__ dt_out, uint8_t* __restrict__ valid_out,
    int* __restrict__ ray_start, int* __restrict__ ray_count) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n < N) {
    const int st = start[n], cnt = count[n];
    if (lane == 0) {
      ray_start[n] = min(st, B);
      ray_count[n] = max(min(B - st, cnt), 0);
    }
    const size_t row = static_cast<size_t>(n) * S;
    int seen = 0;
    for (int j = 0; 32 * j < S && seen < cnt && st + seen < B; ++j) {
      const int s = 32 * j + lane;
      const bool v = s < S && include[row + s];
      const unsigned m = __ballot_sync(FULL, v);
      const int pos = st + seen + __popc(m & lanes_below());
      if (v && pos < B) {
        ray_id[pos] = n;
        t_out[pos] = tg[row + s];
        dt_out[pos] = dtg[row + s];
        valid_out[pos] = 1;
      }
      seen += __popc(m);
    }
  }
  // padding after the last kept sample
  const long long total = static_cast<long long>(start[N - 1]) + count[N - 1];
  const int first_pad = static_cast<int>(min(total, static_cast<long long>(B)));
  const int stride = gridDim.x * blockDim.x;
  for (int b = first_pad + blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += stride) {
    ray_id[b] = N - 1;
    t_out[b] = 0.0f;
    dt_out[b] = 0.0f;
    valid_out[b] = 0;
  }
}

template <bool COARSE, bool SHORT, class Steps>
int launch_train(const void* rays_o, const void* rays_d, const void* hits_t,
                 const void* bitfield, const void* noise, const void* coarse,
                 int N, int S, int K, int Kout, int tail_k, int G, int KB,
                 float lo, float mip_bound, const GridArgs& ga, void* t_out,
                 void* dt_out, void* valid_out, void* count_out, void* sums,
                 cudaStream_t stream) {
  march_fine_train_kernel<COARSE, SHORT, Steps>
      <<<ncn_blocks(N, WARPS), WARPS * 32, 0, stream>>>(
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
// scale (ops/ray_march.py:step_args rounds them as JAX does). One cascade
// and f = 0 run the `Uniform` bodies, the rest the `Cascades` ones.
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
                                float scale, void* t_out, void* dt_out,
                                void* valid_out, void* count_out, void* sums,
                                cudaStream_t stream) {
  if ((KB > 0 && (coarse == nullptr || S / 4 > 32 * MAX_BLOCK_WORDS)) ||
      cascades < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridArgs ga{cascades, f, hi, A, B, ratio, log_ratio, scale};
  const bool uniform = cascades == 1 && f == 0.0f;
  auto launch =
      KB > 0 ? (uniform ? launch_train<true, false, Uniform>
                        : launch_train<true, false, Cascades>)
      : S <= 128 ? (uniform ? launch_train<false, true, Uniform>
                            : launch_train<false, true, Cascades>)
                 : (uniform ? launch_train<false, false, Uniform>
                            : launch_train<false, false, Cascades>);
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
                               float scale, void* t_out, void* dt_out,
                               void* valid_out, void* count_out, void* rm_out,
                               cudaStream_t stream) {
  return march_fine_train(rays_o, rays_d, hits_t, bitfield, noise, nullptr, N,
                          S, K, K, tail_k, G, 0, lo, mip_bound, cascades, f,
                          hi, A, B, ratio, log_ratio, scale, t_out, dt_out,
                          valid_out, count_out, rm_out, stream);
}

// K == 0: full-window mode, (N, S) outputs; K > 0: first-K mode, (N, K).
extern "C" int march_fine_test_round(const void* rays_o, const void* rays_d,
                                     const void* cursor, const void* t_far,
                                     const void* alive, const void* bitfield,
                                     int N, int S, int K, int G, float lo,
                                     float mip_bound, int cascades, float f,
                                     float hi, float A, float B, float ratio,
                                     float log_ratio, float scale,
                                     void* t_out, void* dt_out,
                                     void* valid_out, void* cursor_out,
                                     cudaStream_t stream) {
  if (K < 0 || K > S || cascades < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridArgs ga{cascades, f, hi, A, B, ratio, log_ratio, scale};
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

extern "C" int compact_samples(const void* tg, const void* dtg,
                               const void* include, const void* count,
                               const void* start, int N, int S, int B,
                               void* ray_id, void* t_out, void* dt_out,
                               void* valid_out, void* ray_start,
                               void* ray_count, cudaStream_t stream) {
  compact_kernel<<<ncn_blocks(N, WARPS), WARPS * 32, 0, stream>>>(
      static_cast<const float*>(tg), static_cast<const float*>(dtg),
      static_cast<const uint8_t*>(include), static_cast<const int*>(count),
      static_cast<const int*>(start), N, S, B, static_cast<int*>(ray_id),
      static_cast<float*>(t_out), static_cast<float*>(dt_out),
      static_cast<uint8_t*>(valid_out), static_cast<int*>(ray_start),
      static_cast<int*>(ray_count));
  return static_cast<int>(cudaGetLastError());
}
