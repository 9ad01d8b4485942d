// H3: front-to-back compositing of dense (N, K) samples with C channels,
// forward and backward.
//
// Replaces the JAX package's `composite_rays`
// (normal_clustering_nerf_tpu/ops/composite.py:34-83), whose backward JAX
// derives by autodiff; here the backward is written out (the reference's
// volumerendering.cu:298-364 in the dense layout). The forward takes the
// optional per-ray T_start of inference rounds (composite.py:60-61); the
// backward, which only training calls, does not.
//
// Forward, per ray: x_s = clip(valid ? sigma*delta : 0, 0, 80),
// T_s = exp(-(sum_{k<=s} x_k - x_s)) [* T_start], alpha_s = 1 - exp(-x_s),
// include_s = valid_s & T_s > T_threshold, w_s = include_s ? alpha_s*T_s : 0;
// opacity = sum w, depth = sum w*t, rend_c = sum w*raw_c, and the sample
// counter skips the sample that crosses the threshold (composite.py:64-75).
// Backward, per ray, for upstream gradients on opacity, depth, rend AND ws
// (ws feeds the distortion loss): with G_s = g_op + g_depth*t_s +
// sum_c g_rend_c*raw_sc + g_ws_s over included samples,
//   dL/dx_j = G_j*T_j*exp(-x_j) - sum_{s>j} G_s*w_s,
//   dL/dsigma_j = delta_j * dL/dx_j inside the clip, dL/draw_jc = g_rend_c*w_j.
//
// Forward design. It replaces `composite_rays` (normal_clustering_nerf_tpu/
// ops/composite.py:34) and, with T_start, its inference rounds. What
// bounds it on the H100: latency and the memory transactions, not the
// bytes (~7.3 MB read and written at the bench batch, N 8190, K 16, C 9:
// ~0.0022 ms at 3.35 TB/s). The first design ran one thread per ray in
// blocks of 64 (128 blocks of two warps on 132 SMs): each thread walked
// its K samples with dependent loads, lanes read `raws` K*C floats apart
// and wrote `ws` K floats apart (32 lines a warp instruction), and the
// channel sums lived in a runtime-indexed acc[16], in a stack frame. Here
// it takes the backward's mapping: a group of gw lanes takes one ray,
// lane = sample, in chunks of gw samples; sigma, delta, t, valid and ws
// are lane-contiguous, and the chunk's raws are staged in shared memory
// (`ncn_stage`, 16-byte loads where aligned). Bits kept: the prefix
// csum_s is the shuffle-up chain in the serial order (a chunk starts
// from the last csum of the one before), so T, the mask and w_s are the
// first design's; w_s and t_s go to shared memory, and the group's lanes
// take the C + 2 sums round-robin (rend_c as sum c, opacity C, depth
// C + 1), each over the included samples in the serial order (the next
// sample's operand loaded before the add), a lane's sum carried across
// chunks in a register. The sample counter is the popc of the inclusion
// ballots, less one if an included sample has T*(1 - alpha) <=
// T_threshold. Nothing is kept in a runtime-indexed array. A warp's time
// is its chains and sum loops, whatever its width, so gw is as narrow as
// the sums allow: the power of two at or above min(row bound, C + 2) (16
// at C = 9), so that a row of several chunks leaves each lane one sum.
// The segment launcher takes that width with no bound on the segment
// lengths (and no host sync to find one).
//
// Backward design. It replaces the autodiff backward of `composite_rays`
// (normal_clustering_nerf_tpu/ops/composite.py:34). What bounds it on the
// H100: latency and the memory transactions, not the bytes (~12.6 MB read
// and written at the bench batch, N 8190, K 16, C 9: ~0.004 ms at 3.35
// TB/s). The first design ran one thread per ray: 8190 rays made 256
// warps on 132 SMs, each thread walked its K samples twice with dependent
// loads, lanes read `raws` and wrote `d_raws` K*C floats apart (32 lines
// a warp instruction), and G, w and T*exp(-x) lived in runtime-indexed
// arrays, in local memory. Here a group of gw lanes (the power of two at
// or above the row length: 16 at K = 16, two rays a warp, ~4,100 warps)
// takes one ray, lane = sample: sigma, delta, t, valid and the ws
// cotangent are lane-contiguous loads; the ray's K*C raws are staged in
// shared memory with 16-byte loads where aligned (`ncn_stage`), and its
// d_raws = g_rend_c * w_s written from there as contiguous 16-byte words;
// nothing per sample is kept in an array. Bits kept: the prefix
// csum_s = x_0 + ... + x_s is walked in the forward's serial order by a
// chain of __shfl_up_sync steps (a parallel scan would round differently,
// and at the threshold could include a sample the forward left out), so
// T, the mask T > T_threshold and w_s are the forward's bit for bit, and
// d_raws equals g_rend (x) the forward's ws exactly; G_s is added in the
// first design's order, and the suffix sum_{s>j} G_s*w_s is taken back
// to front in its serial order by a chain of __shfl_down_sync steps, so
// d_sigmas keeps the first design's bits.
//
// Any channel count C >= 1 (C = 3 + 3 pred_norm_nn + n_sem_cls: 46 for
// NYU40's classes). Past gw sums (C + 2 > gw) the forward is
// `composite_fwd_wide_kernel`, which takes the C + 2 sums in passes of
// gw, a sum a lane, each pass walking the row's chunks anew and staging
// only its channels' raws; past BWD_TILE channels the backward stages
// the raws BWD_TILE channels at a time and carries G_s through the tiles
// in one register, in channel order. Shared memory is at most gw *
// min(gw, C) + 2 gw floats a group in the forward and gw * BWD_TILE + gw
// + BWD_TILE in the backward, whatever C. Below those counts both run
// the designs above, compiled as before.
//
// The segment launchers (`composite_seg_fwd` / `composite_seg_bwd`)
// replace the flat layout's `composite_rays_compact` (ops/composite.py:
// 86-144) with the same bodies over ray-major segments instead of dense
// rows (a segment of 0..32 samples in the backward, any length in the
// forward, the lanes past it masked); they keep JAX's per-ray math and
// not its global cumsum minus segment base.
#include "common.cuh"

namespace {

constexpr int MAXK = 32;
constexpr float SIGDT_MAX = 80.0f;

// The rows a launcher reads: dense (N, K) rows, or the flat layout's
// ray-major segments [ray_start[n], ray_start[n] + ray_count[n]) of the
// budget. The loop bodies below are shared, so a segment gives the same
// bits as the dense row of the same samples.
struct DenseRows {
  int K;
  __device__ size_t base(int n) const { return static_cast<size_t>(n) * K; }
  __device__ int len(int) const { return K; }
};
struct SegmentRows {
  const int* start;
  const int* count;
  __device__ size_t base(int n) const { return static_cast<size_t>(start[n]); }
  __device__ int len(int n) const { return count[n]; }
};

__device__ __forceinline__ float clipped(float sigma, float delta, bool valid) {
  float x = valid ? __fmul_rn(sigma, delta) : 0.0f;
  return fminf(fmaxf(x, 0.0f), SIGDT_MAX);
}

// The C + 2 sums of a ray: rend_c (i < C), opacity (C), depth (C + 1).
__device__ __forceinline__ void store_sum(int i, float v, int n, int C,
                                          float* __restrict__ opacity,
                                          float* __restrict__ depth,
                                          float* __restrict__ rend) {
  if (i < C)
    rend[static_cast<size_t>(n) * C + i] = v;
  else if (i == C)
    opacity[n] = v;
  else
    depth[n] = v;
}

// `rows` rows of tc contiguous values of src, each row `stride` floats
// after the one before, into shared memory as rows of tc, by the group's
// lanes tid < nt: one tile of channels of a row's samples.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           int rows, int tc, int stride,
                                           float* dst, int tid, int nt) {
  for (int e = tid; e < rows * tc; e += nt) {
    const int j = e / tc;
    dst[e] = __ldg(src + static_cast<size_t>(j) * stride + (e - j * tc));
  }
}

// H3 forward: group grp of gw lanes takes ray blockIdx.x * (blockDim.x /
// gw) + grp, lane s = sample c0 + s of each chunk [c0, c0 + gw). The
// chunk loop and its chain run the warp's longest row (warp-uniform),
// masked past each group's own row or past N. Every lane owns the sums
// s, s + gw, ...; the launchers take gw >= C + 2 wherever a row may take
// several chunks, so a lane then owns one sum, carried across them in
// `acc`; past gw sums they launch `composite_fwd_wide_kernel`.
constexpr int FWD_THREADS = 256;

template <class Rows>
__global__ void __launch_bounds__(FWD_THREADS) composite_fwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ T_start,
    Rows rows, int N, int C, int gw, float thr, float* __restrict__ opacity,
    float* __restrict__ depth, float* __restrict__ rend,
    float* __restrict__ ws, int* __restrict__ vr) {
  extern __shared__ float sm[];
  const int s = threadIdx.x & (gw - 1), grp = threadIdx.x / gw;
  const int n = blockIdx.x * (blockDim.x / gw) + grp;
  float* rs = sm + grp * (gw * C + 2 * gw);   // the chunk's raws, gw x C
  float* wsh = rs + gw * C;                   // its w_s
  float* tsh = wsh + gw;                      // its t_s
  const bool live = n < N;
  const size_t b = live ? rows.base(n) : 0;
  const int len = live ? rows.len(n) : 0;
  const float t_start = live && T_start ? T_start[n] : 1.0f;
  const int wlen = __reduce_max_sync(FULL, len);
  // the group's bits of a warp ballot
  const int base = (threadIdx.x & 31) & ~(gw - 1);
  const unsigned low = gw == 32 ? FULL : (1u << gw) - 1u;
  const int n_sums = C + 2;
  float carry = 0.0f;   // csum of the samples before the chunk
  float acc = 0.0f;     // sum s
  int n_inc = 0;
  bool early = false;
  // at least one chunk, so that an empty row still writes its sums
  const int n_chunks = max((wlen + gw - 1) / gw, 1);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * gw;
    const int clen = max(min(gw, len - c0), 0);   // the group's samples
    const int steps = min(gw, wlen - c0);         // the chain's, uniform
    const size_t bs = b + c0 + s;
    if (clen > 0) ncn_stage<false>(raws + (b + c0) * C, clen * C, C, C, rs, s, gw);
    const bool in = s < clen;
    bool v = false;
    float sig = 0.0f, del = 0.0f, t = 0.0f;
    if (in) {
      v = valid[bs];
      sig = sigmas[bs];
      del = deltas[bs];
      t = ts[bs];
    }
    const float x = clipped(sig, del, v);
    float csum = __fadd_rn(carry, x);   // carry + x_c0 + ... + x_s, in order
    for (int k = 1; k < steps; ++k) {
      const float prev = __shfl_up_sync(FULL, csum, 1, gw);
      if (s == k) csum = __fadd_rn(prev, x);
    }
    carry = __shfl_sync(FULL, csum, gw - 1, gw);
    float T = expf(-__fsub_rn(csum, x));
    if (T_start) T = __fmul_rn(T, t_start);
    const float alpha = -expm1f(-x);
    const bool inc = v && T > thr;
    const float w = inc ? __fmul_rn(alpha, T) : 0.0f;
    if (in) ws[bs] = w;
    const unsigned incm = (__ballot_sync(FULL, inc) >> base) & low;
    const unsigned endm =
        (__ballot_sync(FULL, inc && __fmul_rn(T, __fsub_rn(1.0f, alpha)) <= thr)
         >> base) & low;
    n_inc += __popc(incm);
    early |= endm != 0u;
    wsh[s] = w;
    tsh[s] = t;
    __syncwarp();   // the group's raws, w and t are staged
    for (int i = s; i < n_sums; i += gw) {
      auto operand = [&](unsigned m) {   // the term of m's lowest sample
        const int j = __ffs(m) - 1;
        const float wj = wsh[j];
        return i < C    ? __fmul_rn(wj, rs[j * C + i])
               : i == C ? wj
                        : __fmul_rn(wj, tsh[j]);
      };
      float a = i == s ? acc : 0.0f;
      if (incm) {
        float p = operand(incm);
        for (unsigned m = incm & (incm - 1u); m; m &= m - 1u) {
          const float q = operand(m);
          a = __fadd_rn(a, p);
          p = q;
        }
        a = __fadd_rn(a, p);
      }
      if (i == s)
        acc = a;
      else if (live)   // a single chunk: the sum is complete
        store_sum(i, a, n, C, opacity, depth, rend);
    }
    __syncwarp();   // the staging is read before the next chunk
  }
  if (!live) return;
  if (s < n_sums) store_sum(s, acc, n, C, opacity, depth, rend);
  if (s == 0) vr[n] = n_inc - (early ? 1 : 0);
}

// H3 forward past gw sums (C + 2 > gw), the same mapping as
// `composite_fwd_kernel`, with the C + 2 sums taken in passes of gw: in
// pass [i0, i0 + gw) lane s owns sum i0 + s, carried across the chunks in
// `acc`, and the chunks' raws of that pass's channels are staged (at most
// gw of them, so that shared memory does not grow with C). A pass walks
// the row's chunks anew (the chain, T and w are recomputed with the same
// bits); the first writes ws and the sample counter. A kernel apart:
// compiled into `composite_fwd_kernel` (one pass a constant), the pass
// loop took 37-40 registers in place of 32, six blocks an SM in place of
// eight, and a test round's composite at C 9 ~10% longer.
template <class Rows>
__global__ void __launch_bounds__(FWD_THREADS) composite_fwd_wide_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ T_start,
    Rows rows, int N, int C, int gw, float thr, float* __restrict__ opacity,
    float* __restrict__ depth, float* __restrict__ rend,
    float* __restrict__ ws, int* __restrict__ vr) {
  extern __shared__ float sm[];
  const int s = threadIdx.x & (gw - 1), grp = threadIdx.x / gw;
  const int n = blockIdx.x * (blockDim.x / gw) + grp;
  const int tw = min(gw, C);                  // the most channels a pass stages
  float* rs = sm + grp * (gw * tw + 2 * gw);  // the chunk's raws, gw x tc
  float* wsh = rs + gw * tw;                  // its w_s
  float* tsh = wsh + gw;                      // its t_s
  const bool live = n < N;
  const size_t b = live ? rows.base(n) : 0;
  const int len = live ? rows.len(n) : 0;
  const float t_start = live && T_start ? T_start[n] : 1.0f;
  const int wlen = __reduce_max_sync(FULL, len);
  // the group's bits of a warp ballot
  const int base = (threadIdx.x & 31) & ~(gw - 1);
  const unsigned low = gw == 32 ? FULL : (1u << gw) - 1u;
  const int n_sums = C + 2;
  // at least one chunk, so that an empty row still writes its sums
  const int n_chunks = max((wlen + gw - 1) / gw, 1);
  for (int i0 = 0; i0 < n_sums; i0 += gw) {
    const int i = i0 + s;                    // the lane's sum
    const int tc = max(min(gw, C - i0), 0);  // the pass's channels [i0, i0 + tc)
    float carry = 0.0f;   // csum of the samples before the chunk
    float acc = 0.0f;     // sum i
    int n_inc = 0;
    bool early = false;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * gw;
      const int clen = max(min(gw, len - c0), 0);   // the group's samples
      const int steps = min(gw, wlen - c0);         // the chain's, uniform
      const size_t bs = b + c0 + s;
      if (clen > 0 && tc == C)
        ncn_stage<false>(raws + (b + c0) * C, clen * C, C, C, rs, s, gw);
      else if (clen > 0 && tc > 0)
        stage_tile(raws + (b + c0) * C + i0, clen, tc, C, rs, s, gw);
      const bool in = s < clen;
      bool v = false;
      float sig = 0.0f, del = 0.0f, t = 0.0f;
      if (in) {
        v = valid[bs];
        sig = sigmas[bs];
        del = deltas[bs];
        t = ts[bs];
      }
      const float x = clipped(sig, del, v);
      float csum = __fadd_rn(carry, x);   // carry + x_c0 + ... + x_s, in order
      for (int k = 1; k < steps; ++k) {
        const float prev = __shfl_up_sync(FULL, csum, 1, gw);
        if (s == k) csum = __fadd_rn(prev, x);
      }
      carry = __shfl_sync(FULL, csum, gw - 1, gw);
      float T = expf(-__fsub_rn(csum, x));
      if (T_start) T = __fmul_rn(T, t_start);
      const float alpha = -expm1f(-x);
      const bool inc = v && T > thr;
      const float w = inc ? __fmul_rn(alpha, T) : 0.0f;
      if (in && i0 == 0) ws[bs] = w;
      const unsigned incm = (__ballot_sync(FULL, inc) >> base) & low;
      const unsigned endm =
          (__ballot_sync(FULL, inc && __fmul_rn(T, __fsub_rn(1.0f, alpha)) <= thr)
           >> base) & low;
      n_inc += __popc(incm);
      early |= endm != 0u;
      wsh[s] = w;
      tsh[s] = t;
      __syncwarp();   // the group's raws, w and t are staged
      if (i < n_sums && incm) {
        auto operand = [&](unsigned m) {   // the term of m's lowest sample
          const int j = __ffs(m) - 1;
          const float wj = wsh[j];
          return i < C    ? __fmul_rn(wj, rs[j * tc + (i - i0)])
                 : i == C ? wj
                          : __fmul_rn(wj, tsh[j]);
        };
        float a = acc;
        float p = operand(incm);
        for (unsigned m = incm & (incm - 1u); m; m &= m - 1u) {
          const float q = operand(m);
          a = __fadd_rn(a, p);
          p = q;
        }
        acc = __fadd_rn(a, p);
      }
      __syncwarp();   // the staging is read before the next chunk
    }
    if (live && i < n_sums) store_sum(i, acc, n, C, opacity, depth, rend);
    if (live && i0 == 0 && s == 0) vr[n] = n_inc - (early ? 1 : 0);
  }
}

// H3 backward: group grp of gw lanes takes ray blockIdx.x * (blockDim.x /
// gw) + grp, lane s = sample s. Every lane runs the chains' max_len - 1
// steps (warp-uniform), masked past its ray's length or past N. With
// WIDE (C > BWD_TILE) the ray's raws are staged BWD_TILE channels at a
// time, so that shared memory does not grow with C, and G_s runs on
// through the tiles in one register, in channel order; without it all C
// at once, compiled as the design before channel tiles.
constexpr int BWD_THREADS = 256;
constexpr int BWD_TILE = 16;

// d_raws of one ray, g_rend_c * w_s for its n_vals = len*C values, written
// contiguously by the gw lanes of its group, w from shared memory and
// g_rend from shared memory or, past one tile, device memory: 16-byte
// stores where dst is 16-byte aligned.
__device__ __forceinline__ void store_d_raws(float* __restrict__ dst,
                                             int n_vals, int C,
                                             const float* gr, const float* w,
                                             int s, int gw) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int words = n_vals / 4;
    for (int i = s; i < words; i += gw) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * i + k;
        v[k] = __fmul_rn(gr[e % C], w[e / C]);
      }
      reinterpret_cast<float4*>(dst)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    done = words * 4;
  }
  for (int e = done + s; e < n_vals; e += gw)
    dst[e] = __fmul_rn(gr[e % C], w[e / C]);
}

template <class Rows, bool WIDE>
__global__ void __launch_bounds__(BWD_THREADS) composite_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ g_op,
    const float* __restrict__ g_depth, const float* __restrict__ g_rend,
    const float* __restrict__ g_ws, Rows rows, int N, int C, int max_len,
    int gw, float thr, float* __restrict__ d_sigmas,
    float* __restrict__ d_raws) {
  extern __shared__ float sm[];
  const int s = threadIdx.x & (gw - 1), grp = threadIdx.x / gw;
  const int n = blockIdx.x * (blockDim.x / gw) + grp;
  const int tw = WIDE ? BWD_TILE : C;
  float* rs = sm + grp * (gw * tw + gw + tw);   // a tile of the raws, len x tc
  float* wsh = rs + gw * tw;                    // the ray's w_s
  float* gr = wsh + gw;                         // the tile's g_rend
  const bool live = n < N;
  const size_t b = live ? rows.base(n) : 0;
  // the launchers refuse rows longer than max_len <= gw; the clamp keeps
  // the lanes in bounds whatever the counts hold
  const int len = live ? min(rows.len(n), max_len) : 0;
  const float* g_row = g_rend + static_cast<size_t>(n) * C;
  auto stage = [&](int c0) {   // channels [c0, c0 + tc) of the ray
    const int tc = min(tw, C - c0);
    if (!WIDE)
      ncn_stage<false>(raws + b * C, len * C, C, C, rs, s, gw);
    else
      stage_tile(raws + b * C + c0, len, tc, C, rs, s, gw);
    for (int c = s; c < tc; c += gw) gr[c] = g_row[c0 + c];
  };
  if (live) stage(0);
  const bool in = s < len;
  bool v = false;
  float sig = 0.0f, del = 0.0f;
  if (in) {
    v = valid[b + s];
    sig = sigmas[b + s];
    del = deltas[b + s];
  }
  const float x = clipped(sig, del, v);
  float csum = __fadd_rn(0.0f, x);   // x_0 + ... + x_s, the forward's order
  for (int k = 1; k < max_len; ++k) {
    const float prev = __shfl_up_sync(FULL, csum, 1, gw);
    if (s == k) csum = __fadd_rn(prev, x);
  }
  const float T = expf(-__fsub_rn(csum, x));
  const bool inc = v && T > thr;
  const float w = inc ? __fmul_rn(-expm1f(-x), T) : 0.0f;
  __syncwarp();   // the group's first tile of raws and g_rend is staged
  float G = 0.0f, TE = 0.0f;   // G_s and T_s*exp(-x_s) where included
  if (inc) {
    G = __fadd_rn(__fadd_rn(g_op[n], __fmul_rn(g_depth[n], ts[b + s])),
                  g_ws[b + s]);
    TE = __fmul_rn(T, expf(-x));
  }
  for (int c0 = 0;;) {
    const int tc = min(tw, C - c0);
    if (inc) {
      const float* r = rs + s * tc;
      for (int c = 0; c < tc; ++c) G = __fadd_rn(G, __fmul_rn(gr[c], r[c]));
    }
    c0 += tw;
    if (!WIDE || c0 >= C) break;
    __syncwarp();   // the tile is read
    if (live) stage(c0);
    __syncwarp();   // the next tile is staged
  }
  const float gw_s = __fmul_rn(G, w);
  float suffix = __fadd_rn(0.0f, gw_s);   // sum_{s'>=s} G w, back to front
  for (int k = max_len - 2; k >= 0; --k) {
    const float next = __shfl_down_sync(FULL, suffix, 1, gw);
    if (s == k) suffix = __fadd_rn(next, gw_s);
  }
  float after = __shfl_down_sync(FULL, suffix, 1, gw);   // sum_{s'>s}
  if (s + 1 >= len) after = 0.0f;
  if (in) {
    const float dx = __fsub_rn(__fmul_rn(G, TE), after);
    const float raw_x = __fmul_rn(sig, del);
    const bool pass = v && raw_x > 0.0f && raw_x < SIGDT_MAX;
    d_sigmas[b + s] = pass ? __fmul_rn(dx, del) : 0.0f;
    wsh[s] = w;
  }
  __syncwarp();
  if (live)
    store_d_raws(d_raws + b * C, len * C, C, WIDE ? g_row : gr, wsh, s, gw);
}

// gw: the power of two at or above the row bound max_len, at most 32
inline int group_width(int max_len) {
  int gw = 1;
  while (gw < max_len && gw < 32) gw <<= 1;
  return gw;
}

template <class Rows>
int launch_fwd(const void* sigmas, const void* raws, const void* deltas,
               const void* ts, const void* valid, const void* T_start,
               Rows rows, int N, int max_len, int C, float thr, void* opacity,
               void* depth, void* rend, void* ws, void* vr,
               cudaStream_t stream) {
  // as narrow as a row of several chunks allows in one pass (a sum a
  // lane: gw >= C + 2), and no wider than the row bound
  const int gw = group_width(min(max_len, C + 2));
  const int per_block = FWD_THREADS / gw;
  const size_t bytes = sizeof(float) * per_block * (gw * min(gw, C) + 2 * gw);
  auto kernel = C + 2 > gw ? composite_fwd_wide_kernel<Rows>
                           : composite_fwd_kernel<Rows>;
  kernel<<<ncn_blocks(N, per_block), FWD_THREADS, bytes, stream>>>(
      static_cast<const float*>(sigmas), static_cast<const float*>(raws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(T_start),
      rows, N, C, gw, thr,
      static_cast<float*>(opacity), static_cast<float*>(depth),
      static_cast<float*>(rend), static_cast<float*>(ws),
      static_cast<int*>(vr));
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch_bwd(const void* sigmas, const void* raws, const void* deltas,
               const void* ts, const void* valid, const void* g_op,
               const void* g_depth, const void* g_rend, const void* g_ws,
               Rows rows, int N, int max_len, int C, float thr,
               void* d_sigmas, void* d_raws, cudaStream_t stream) {
  if (max_len > MAXK) return static_cast<int>(cudaErrorInvalidValue);
  const int gw = group_width(max_len);
  const int per_block = BWD_THREADS / gw;
  const int tw = min(C, BWD_TILE);
  const size_t bytes = sizeof(float) * per_block * (gw * tw + gw + tw);
  auto kernel = C > BWD_TILE ? composite_bwd_kernel<Rows, true>
                             : composite_bwd_kernel<Rows, false>;
  kernel<<<ncn_blocks(N, per_block), BWD_THREADS, bytes, stream>>>(
      static_cast<const float*>(sigmas), static_cast<const float*>(raws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(g_op),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_rend),
      static_cast<const float*>(g_ws), rows, N, C, max_len, gw, thr,
      static_cast<float*>(d_sigmas), static_cast<float*>(d_raws));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T_start may be null (training); the forward takes rows of more than 32
// samples in chunks, so it takes any K (inference rounds use up to 64).
extern "C" int composite_fwd(const void* sigmas, const void* raws,
                             const void* deltas, const void* ts,
                             const void* valid, const void* T_start, int N,
                             int K, int C, float thr, void* opacity,
                             void* depth, void* rend, void* ws, void* vr,
                             cudaStream_t stream) {
  return launch_fwd(sigmas, raws, deltas, ts, valid, T_start, DenseRows{K},
                    N, K, C, thr, opacity, depth, rend, ws, vr, stream);
}

extern "C" int composite_bwd(const void* sigmas, const void* raws,
                             const void* deltas, const void* ts,
                             const void* valid, const void* g_op,
                             const void* g_depth, const void* g_rend,
                             const void* g_ws, int N, int K, int C, float thr,
                             void* d_sigmas, void* d_raws,
                             cudaStream_t stream) {
  return launch_bwd(sigmas, raws, deltas, ts, valid, g_op, g_depth, g_rend,
                    g_ws, DenseRows{K}, N, K, C, thr, d_sigmas, d_raws,
                    stream);
}

// The flat layout (composite_rays_compact): ray n's samples are the budget
// slots [ray_start[n], ray_start[n] + ray_count[n]); slots outside every
// segment are not touched (the caller zeroes ws, d_sigmas and d_raws).
// The forward takes segments of any length (in chunks).
extern "C" int composite_seg_fwd(const void* sigmas, const void* raws,
                                 const void* deltas, const void* ts,
                                 const void* valid, const void* T_start,
                                 const void* ray_start, const void* ray_count,
                                 int N, int C, float thr, void* opacity,
                                 void* depth, void* rend, void* ws, void* vr,
                                 cudaStream_t stream) {
  SegmentRows rows{static_cast<const int*>(ray_start),
                   static_cast<const int*>(ray_count)};
  return launch_fwd(sigmas, raws, deltas, ts, valid, T_start, rows, N,
                    C + 2, C, thr, opacity, depth, rend, ws, vr, stream);
}

// max_len: the longest segment, which the caller has checked (<= 32).
extern "C" int composite_seg_bwd(const void* sigmas, const void* raws,
                                 const void* deltas, const void* ts,
                                 const void* valid, const void* g_op,
                                 const void* g_depth, const void* g_rend,
                                 const void* g_ws, const void* ray_start,
                                 const void* ray_count, int N, int max_len,
                                 int C, float thr, void* d_sigmas,
                                 void* d_raws, cudaStream_t stream) {
  SegmentRows rows{static_cast<const int*>(ray_start),
                   static_cast<const int*>(ray_count)};
  return launch_bwd(sigmas, raws, deltas, ts, valid, g_op, g_depth, g_rend,
                    g_ws, rows, N, max_len, C, thr, d_sigmas, d_raws, stream);
}
