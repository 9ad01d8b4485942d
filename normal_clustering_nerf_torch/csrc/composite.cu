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
// `composite_fwd_wide_kernel`. It replaces the same `composite_rays` at
// the 40-class path's shapes (N 8190, K 16, C 46: ~26 MB read and
// written, ~0.0083 ms at 3.35 TB/s; its test rounds' rows of up to 64
// samples with T_start). The first design took the C + 2 sums in
// passes of gw, a sum a lane: each pass walked the row's chunks anew (the
// loads of sigma, delta, t and valid, the 15-step shuffle chain, expf and
// expm1f, both ballots), staged its 16 channels a float at a time with a
// division each, and read them from group regions 0 modulo 32 floats
// apart (the two groups of a warp on the same banks); 0.0257 ms at C 46,
// 3.1x its bound. Here a lane owns Q = ceil((C + 2) / gw) <= FWD_QMAX sums
// in registers (the kernel a template on Q: 3 at the bench's rows of 16,
// 2 at a test round's 64 and on segments), so that the row is walked
// once; each chunk's raws are copied once by cp.async, as one contiguous
// block, and arrive while the chain runs; the Q chains are interleaved.
// On a 40-class step's own arguments it takes 0.0124-0.0126 ms against
// the first design's 0.0262 (one H100 80GB HBM3, 700.00 W, in turns),
// 1.5x its bound, at 46-59 registers, 4 blocks of 8 warps an SM.
// Below that count it runs the design above, compiled as before.
//
// The backward past BWD_NARROW = 16 channels (WIDE). It replaces the same
// autodiff at the 40-class path's shape (N 8190, K 16, C 46: ~48 MB of
// raws read and d_raws written, ~0.0157 ms at 3.35 TB/s). The first
// design staged 16 channels at a time and took 0.0406 ms (one H100 80GB
// HBM3, 700.00 W): G's loop read row s of a tile at s * 16 floats, so the
// 32 lanes of a warp (two groups 288 floats apart, 0 modulo 32) fell on
// two of the 32 banks, 16-way, for each of 46 channels; each d_raws value
// took a division and a modulo by the runtime C and read g_rend from
// device memory; and the tiles were staged a float at a time, a division
// each. Here a tile is as wide as C up to BWD_TILE = 48, so C 46 is one
// tile: the ray's K*C raws, one contiguous 16-byte-aligned block, are
// staged with 16-byte loads (UNROLL in flight a lane) into rows of an odd
// stride (tw | 1), and the groups of a warp start gw * stride floats
// apart modulo 32 (`wide_region`), so G's loop reads each channel of the
// warp's 32 rows from 32 banks. The staging and the d_raws stores find
// each value's (sample, channel) by counters (`RowCol`), one division a
// lane and not one a value; w and g_rend are read from shared memory, and
// a tile's d_raws are written as soon as its g_rend is staged (w is known
// before G), as 16-byte stores where the block is aligned. The sample's
// sigma, delta, t and ws cotangent are loaded before the staging waits.
// Past BWD_TILE, tiles of BWD_TILE channels (shared memory bounded
// whatever C), G_s carried through them in channel order. A block keeps
// BWD_THREADS threads and takes the shared-memory opt-in past 48 KB: at
// C 46 and gw 16, 16 groups of 3,264 B (52.2 KB) at 64 registers a
// thread: 4 blocks and 32 warps an SM, 512 blocks in one wave. Measured
// in turns on one H100 80GB HBM3, 700.00 W (C 46; K 16 / K 64): this
// design 0.0233 / 0.0863 ms; blocks of 4 warps within 48 KB (8 blocks,
// the same 32 warps an SM) 0.0234 / 0.0860; UNROLL 4 0.0235 / 0.0891
// (8: 0.0290 at K 16). On a 40-class step's own arguments it takes
// 0.0235 ms against the first design's 0.0443, at 1.5x its bound.
// The chains (the prefix, G's terms in channel order, the suffix) are
// the narrow body's, so d_sigmas is bit for bit `composite_grad_serial`
// and d_raws is g_rend (x) w exactly.
//
// Rows of any length. The backward's lane groups take rows of at most
// LANE_ROWS = 32 samples (the main path's K 16). A longer row (K 64 a
// rank when four cards split the bench's batch under the global budget,
// as JAX's bench sets it; the flat layout's longer segments) goes to
// `composite_bwd_long_kernel`: a warp a ray, in chunks of 32 samples, two
// passes. Front to back, the prefix csum is carried across chunks as the
// forward's `carry` is, so T, w and G are the lane kernel's; a chunk's
// d_raws are written at once, G*T*exp(-x) goes to d_sigmas and G*w to a
// scratch row the wrapper allocates (two values a sample: the walk back
// reads both). Back to front, the suffix of G*w is chained through each
// chunk starting from the sum carried in from the chunk after, so every
// addition is the serial order's. Shared memory holds one chunk, so it
// does not grow with K; device memory holds the two values a sample,
// which one lane writes and reads again, so no fence is needed. At N
// 8190, K 64, C 9 it takes 0.0323 ms against 0.0147 of bytes (~49 MB
// moved; one H100 80GB HBM3, 700.00 W): a warp's two chains a chunk, and
// its walk back, are dependent latencies, as the lane kernel's are.
//
// The segment launchers (`composite_seg_fwd` / `composite_seg_bwd`)
// replace the flat layout's `composite_rays_compact` (ops/composite.py:
// 86-144) with the same bodies over ray-major segments instead of dense
// rows (segments of any length, the lanes past one masked); they keep
// JAX's per-ray math and not its global cumsum minus segment base.
#include "common.cuh"

namespace {

constexpr int LANE_ROWS = 32;   // the longest row of the lane-group backward
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

// The (row j, column c) of a flat index e into rows of `width`
// values, stepped by a fixed `step` with no division a value (one for the
// start, one for the step).
struct RowCol {
  int j, c, dj, dc, width;
  __device__ __forceinline__ RowCol(int e, int step, int w)
      : j(e / w), c(e - (e / w) * w), dj(step / w), dc(step - (step / w) * w),
        width(w) {}
  __device__ __forceinline__ void next() {   // e += step
    j += dj;
    c += dc;
    if (c >= width) {
      c -= width;
      ++j;
    }
  }
  __device__ __forceinline__ void inc() {   // e += 1
    if (++c == width) {
      c = 0;
      ++j;
    }
  }
};

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

// H3 forward past gw sums (C + 2 > gw): the mapping of
// `composite_fwd_kernel`, with lane s owning the Q sums i0 + s + q * gw
// (q < Q, a compile-time count: the sums live in registers) of one walk
// of the row's chunks; the launcher takes Q = ceil((C + 2) / gw) <=
// FWD_QMAX, so that every row is walked once up to FWD_QMAX * 32 sums
// (past them, walks of that many sums, each recomputing the chain with
// the same bits). Each chunk's raws are staged once, a contiguous block
// copied by cp.async at its own offset in its 16 bytes (no register holds
// them, and the chain runs while they arrive), into rows of C floats: the
// lanes of a group read one row's consecutive floats, and the groups of
// a warp start gw floats apart modulo the 32 banks (`fwd_region`). A
// lane's Q chains take the included samples in the serial order, each
// with the next sample's operand loaded before its add, interleaved so
// that their adds overlap; opacity's operand is w * 1 (= w exactly) and
// depth's w * t, so one expression serves every sum. A kernel apart from
// `composite_fwd_kernel`, which it would cost registers (a pass loop
// compiled into it took 37-40 registers in place of 32).
constexpr int FWD_QMAX = 4;   // the most sums a lane of the wide forward owns

// The wide forward's floats of one group: a chunk's w_s and t_s, then its
// raws (rows of tw floats, after up to 3 floats of lead: the block's
// offset in its 16 bytes), rounded so that the regions start 16-byte
// aligned (gw >= 4) and, below 32 lanes, gw floats apart modulo the 32
// banks: when the groups of a warp read their rows' same columns, their
// lanes fall on distinct banks.
__host__ __device__ __forceinline__ int fwd_region(int gw, int tw) {
  const int need = 2 * gw + 3 + gw * tw;
  return gw >= 32 ? (need + 3) / 4 * 4 : (need - gw + 31) / 32 * 32 + gw;
}

__device__ __forceinline__ unsigned smem_address(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `rows` rows of tc floats of a ray's raws (src: row 0, rows C floats
// apart) into shared memory as rows of tc floats, by lanes s < gw with
// cp.async (`ncn_async_wait` waits for them). The whole block (tc == C:
// one contiguous run) lands at src's offset in its 16 bytes from `dst`
// (16-byte aligned, 3 floats of room), as 16-byte copies (marked to leave
// the L2 first: read once) between 4-byte ones at its ends; a tile of a
// wider ray float by float from `dst`. Returns where row 0 lies.
__device__ __forceinline__ const float* stage_rows_async(
    const float* __restrict__ src, int rows, int tc, int C, float* dst, int s,
    int gw) {
  if (tc == C) {
    const int n = rows * C;
    const int lead =
        static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* out = dst + lead;
    const int head = min((4 - lead) & 3, n);
    const int words = (n - head) / 4;
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    for (int i = s; i < words; i += gw)
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
          ::"r"(smem_address(out + head + 4 * i)), "l"(src + head + 4 * i),
          "l"(policy) : "memory");
    auto copy4 = [&](int e) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   ::"r"(smem_address(out + e)), "l"(src + e) : "memory");
    };
    for (int e = s; e < head; e += gw) copy4(e);
    for (int e = head + 4 * words + s; e < n; e += gw) copy4(e);
    return out;
  }
  RowCol p(s, gw, tc);
  for (int e = s; e < rows * tc; e += gw, p.next())
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(smem_address(dst + e)),
                 "l"(src + static_cast<size_t>(p.j) * C + p.c) : "memory");
  return dst;
}

template <class Rows, int Q>
__global__ void __launch_bounds__(FWD_THREADS) composite_fwd_wide_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ T_start,
    Rows rows, int N, int C, int gw, float thr, float* __restrict__ opacity,
    float* __restrict__ depth, float* __restrict__ rend,
    float* __restrict__ ws, int* __restrict__ vr) {
  extern __shared__ float4 sm_wide[];
  const int s = threadIdx.x & (gw - 1), grp = threadIdx.x / gw;
  const int n = blockIdx.x * (blockDim.x / gw) + grp;
  const int n_sums = C + 2, span = Q * gw;   // the sums of one walk
  const int tw = min(span, C);               // the most channels a walk stages
  float* wsh = reinterpret_cast<float*>(sm_wide) + grp * fwd_region(gw, tw);
  float* tsh = wsh + gw;                     // the chunk's t_s
  float* stage = tsh + gw;                   // its raws, 16-byte aligned
  const bool live = n < N;
  const size_t b = live ? rows.base(n) : 0;
  const int len = live ? rows.len(n) : 0;
  const float t_start = live && T_start ? T_start[n] : 1.0f;
  const int wlen = __reduce_max_sync(FULL, len);
  // the group's bits of a warp ballot
  const int base = (threadIdx.x & 31) & ~(gw - 1);
  const unsigned low = gw == 32 ? FULL : (1u << gw) - 1u;
  // at least one chunk, so that an empty row still writes its sums
  const int n_chunks = max((wlen + gw - 1) / gw, 1);
  for (int i0 = 0; i0 < n_sums; i0 += span) {   // one walk up to span sums
    const int tc = max(min(span, C - i0), 0);   // the walk's channels
    // column of sum i0 + s + q * gw in a staged row (clamped: a sum past
    // the channels reads a channel and takes 1 or t in its place)
    int col[Q];
    bool raw[Q], opq[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = i0 + s + q * gw;
      col[q] = max(min(s + q * gw, tc - 1), 0);
      raw[q] = i < C;
      opq[q] = i == C;
    }
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
    float carry = 0.0f;   // csum of the samples before the chunk
    int n_inc = 0;
    bool early = false;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * gw;
      const int clen = max(min(gw, len - c0), 0);   // the group's samples
      const int steps = min(gw, wlen - c0);         // the chain's, uniform
      const size_t bs = b + c0 + s;
      const float* rs = stage;
      if (clen > 0 && tc > 0)
        rs = stage_rows_async(raws + (b + c0) * C + i0, clen, tc, C, stage, s,
                              gw);
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
      ncn_async_wait();
      __syncwarp();   // the group's raws, w and t are staged
      if (incm) {
        // the Q operands of sample j: w_j * (raw, 1 or t)
        auto terms = [&](int j, float (&o)[Q]) {
          const float wj = wsh[j], tj = tsh[j];
          const float* row = rs + j * tc;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const float r = row[col[q]];
            o[q] = __fmul_rn(wj, raw[q] ? r : opq[q] ? 1.0f : tj);
          }
        };
        float p[Q];
        terms(__ffs(incm) - 1, p);
        for (unsigned m = incm & (incm - 1u); m; m &= m - 1u) {
          float nx[Q];
          terms(__ffs(m) - 1, nx);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            acc[q] = __fadd_rn(acc[q], p[q]);
            p[q] = nx[q];
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
      }
      __syncwarp();   // the staging is read before the next chunk
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = i0 + s + q * gw;
        if (i < n_sums) store_sum(i, acc[q], n, C, opacity, depth, rend);
      }
      if (i0 == 0 && s == 0) vr[n] = n_inc - (early ? 1 : 0);
    }
  }
}

// H3 backward: group grp of gw lanes takes ray blockIdx.x * (blockDim.x /
// gw) + grp, lane s = sample s. Every lane runs the chains' max_len - 1
// steps (warp-uniform), masked past its ray's length or past N. Without
// WIDE (C <= BWD_NARROW) the ray's raws are staged all at once, compiled
// as the design before channel tiles. With WIDE they are staged in tiles
// of up to BWD_TILE channels on an odd row stride (the file note), and G_s
// runs on through the tiles in one register, in channel order.
constexpr int BWD_THREADS = 256;
constexpr int BWD_NARROW = 16;   // the most channels of the narrow body
constexpr int BWD_TILE = 48;     // WIDE: the most channels a tile stages

// d_raws of one ray, g_rend_c * w_s for its n_vals = len*C values, written
// contiguously by the gw lanes of its group, w and g_rend from shared
// memory: 16-byte stores where dst is 16-byte aligned (the narrow body).
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

// WIDE: floats a group's shared memory takes: gw rows of the tile on an
// odd stride, then w_s and the tile's g_rend rounded up to 32 floats, so
// that the groups of a warp start gw * stride floats apart modulo the 32
// banks and G's loop reads each channel of the warp's 32 rows from 32
// banks.
__host__ __device__ __forceinline__ int wide_region(int gw, int tw) {
  return gw * (tw | 1) + (gw + tw + 31) / 32 * 32;
}

// WIDE: `rows` samples x tc channels of a ray's raws (src: row 0, column
// c0, rows C floats apart) into shared-memory rows `stride` floats apart.
// The ray's whole block (tc == C) goes as 16-byte loads where it is
// aligned, UNROLL words a lane in flight at a time; a tile of a wider ray
// value by value.
constexpr int UNROLL = 2;

__device__ __forceinline__ void stage_wide(const float* __restrict__ src,
                                           int rows, int tc, int C,
                                           int stride, float* dst, int s,
                                           int gw) {
  const int n = rows * tc;
  int done = 0;
  if (tc == C && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int words = n / 4;
    RowCol p(4 * s, 4 * gw, tc);
    for (int i0 = s; i0 < words; i0 += UNROLL * gw) {
      float4 q[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i0 + u * gw < words)
          q[u] = __ldg(reinterpret_cast<const float4*>(src) + i0 + u * gw);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i0 + u * gw >= words) break;
        RowCol e = p;
        dst[e.j * stride + e.c] = q[u].x;
        e.inc();
        dst[e.j * stride + e.c] = q[u].y;
        e.inc();
        dst[e.j * stride + e.c] = q[u].z;
        e.inc();
        dst[e.j * stride + e.c] = q[u].w;
        p.next();
      }
    }
    done = 4 * words;
  }
  RowCol p(done + s, gw, tc);
  for (int e = done + s; e < n; e += gw, p.next())
    dst[p.j * stride + p.c] = __ldg(src + static_cast<size_t>(p.j) * C + p.c);
}

// WIDE: d_raws of `rows` samples x tc channels, g_rend_c * w_s with the
// tile's g_rend and w from shared memory, to dst (row 0, column c0, rows
// C floats apart): the ray's whole block (tc == C) as 16-byte stores
// where it is aligned, a tile of a wider ray value by value.
__device__ __forceinline__ void store_wide(float* __restrict__ dst, int rows,
                                           int tc, int C, const float* gr,
                                           const float* w, int s, int gw) {
  const int n = rows * tc;
  int done = 0;
  if (tc == C && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int words = n / 4;
    RowCol p(4 * s, 4 * gw, tc);
    for (int i = s; i < words; i += gw, p.next()) {
      RowCol e = p;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = __fmul_rn(gr[e.c], w[e.j]);
        e.inc();
      }
      reinterpret_cast<float4*>(dst)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    done = 4 * words;
  }
  RowCol p(done + s, gw, tc);
  for (int e = done + s; e < n; e += gw, p.next())
    dst[static_cast<size_t>(p.j) * C + p.c] = __fmul_rn(gr[p.c], w[p.j]);
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
  const int tw = WIDE ? min(C, BWD_TILE) : C;
  const int stride = WIDE ? (tw | 1) : tw;
  float* rs = sm + grp * (WIDE ? wide_region(gw, tw)
                               : gw * tw + gw + tw);   // a tile of the raws
  float* wsh = rs + gw * stride;                       // the ray's w_s
  float* gr = wsh + gw;                                // the tile's g_rend
  const bool live = n < N;
  const size_t b = live ? rows.base(n) : 0;
  // the launchers send rows longer than LANE_ROWS to the long kernel, so
  // max_len <= gw; the clamp keeps the lanes in bounds whatever the
  // counts hold
  const int len = live ? min(rows.len(n), max_len) : 0;
  const float* g_row = g_rend + static_cast<size_t>(n) * C;
  auto stage = [&](int c0) {   // channels [c0, c0 + tc) of the ray
    const int tc = min(tw, C - c0);
    if constexpr (!WIDE)
      ncn_stage<false>(raws + b * C, len * C, C, C, rs, s, gw);
    else
      stage_wide(raws + b * C + c0, len, tc, C, stride, rs, s, gw);
    for (int c = s; c < tc; c += gw) gr[c] = g_row[c0 + c];
  };
  const bool in = s < len;
  bool v = false;
  float sig = 0.0f, del = 0.0f, t = 0.0f, gws = 0.0f;
  auto load = [&] {   // the lane's sample
    if (in) {
      v = valid[b + s];
      sig = sigmas[b + s];
      del = deltas[b + s];
      if (WIDE) {   // ahead of the staging's wait
        t = ts[b + s];
        gws = g_ws[b + s];
      }
    }
  };
  if (WIDE) load();
  if (live) stage(0);
  if (!WIDE) load();
  const float x = clipped(sig, del, v);
  float csum = __fadd_rn(0.0f, x);   // x_0 + ... + x_s, the forward's order
  for (int k = 1; k < max_len; ++k) {
    const float prev = __shfl_up_sync(FULL, csum, 1, gw);
    if (s == k) csum = __fadd_rn(prev, x);
  }
  const float T = expf(-__fsub_rn(csum, x));
  const bool inc = v && T > thr;
  const float w = inc ? __fmul_rn(-expm1f(-x), T) : 0.0f;
  if (WIDE && in) wsh[s] = w;   // each tile's d_raws read it
  __syncwarp();   // the group's first tile of raws and g_rend is staged
  float G = 0.0f, TE = 0.0f;   // G_s and T_s*exp(-x_s) where included
  if (inc) {
    if (!WIDE) {
      t = ts[b + s];
      gws = g_ws[b + s];
    }
    G = __fadd_rn(__fadd_rn(g_op[n], __fmul_rn(g_depth[n], t)), gws);
    TE = __fmul_rn(T, expf(-x));
  }
  for (int c0 = 0;;) {
    const int tc = min(tw, C - c0);
    if (inc) {
      const float* r = rs + s * stride;
      for (int c = 0; c < tc; ++c) G = __fadd_rn(G, __fmul_rn(gr[c], r[c]));
    }
    if (WIDE && live)
      store_wide(d_raws + b * C + c0, len, tc, C, gr, wsh, s, gw);
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
    if (!WIDE) wsh[s] = w;
  }
  if constexpr (!WIDE) {
    __syncwarp();
    if (live) store_d_raws(d_raws + b * C, len * C, C, gr, wsh, s, gw);
  }
}

// H3 backward past LANE_ROWS samples (the file note): a warp a ray, lane
// s = sample c0 + s of each chunk [c0, c0 + 32). Pass 1 carries the
// prefix csum across the chunks, writes each chunk's d_raws and keeps
// G*T*exp(-x) in d_sigmas and G*w in `gwb`; pass 2 walks the chunks back
// to front with the suffix of G*w carried in from the chunk after. The
// channels are staged as in `composite_bwd_kernel`: all C at once, or
// with WIDE in tiles of up to BWD_TILE on an odd stride, each tile's
// d_raws written while its g_rend is staged.
template <class Rows, bool WIDE>
__global__ void __launch_bounds__(BWD_THREADS) composite_bwd_long_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ g_op,
    const float* __restrict__ g_depth, const float* __restrict__ g_rend,
    const float* __restrict__ g_ws, Rows rows, int N, int C, int max_len,
    float thr, float* __restrict__ d_sigmas, float* __restrict__ d_raws,
    float* __restrict__ gwb) {
  extern __shared__ float sm[];
  const int s = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + grp;
  if (n >= N) return;   // the whole warp: it is one ray
  const int tw = WIDE ? min(C, BWD_TILE) : C;
  const int stride = WIDE ? (tw | 1) : tw;
  float* rs = sm + grp * (WIDE ? wide_region(32, tw)
                               : 32 * tw + 32 + tw);   // a tile of a chunk
  float* wsh = rs + 32 * stride;                       // the chunk's w_s
  float* gr = wsh + 32;                                // the tile's g_rend
  const size_t b = rows.base(n);
  const int len = min(rows.len(n), max_len);
  const float* g_row = g_rend + static_cast<size_t>(n) * C;
  const float gop = g_op[n], gdep = g_depth[n];
  if (!WIDE)   // all C channels, read before the first chunk's sums
    for (int c = s; c < C; c += 32) gr[c] = g_row[c];
  const int n_chunks = (len + 31) / 32;
  float carry = 0.0f;   // csum of the samples before the chunk
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * 32, clen = min(32, len - c0);
    const float* rows_c = raws + (b + c0) * C;
    auto stage = [&](int k0) {   // channels [k0, k0 + tc) of the chunk
      if (!WIDE) {
        ncn_stage<false>(rows_c, clen * C, C, C, rs, s, 32);
      } else {
        const int tc = min(tw, C - k0);
        stage_wide(rows_c + k0, clen, tc, C, stride, rs, s, 32);
        for (int c = s; c < tc; c += 32) gr[c] = g_row[k0 + c];
      }
    };
    stage(0);
    const size_t bs = b + c0 + s;
    const bool in = s < clen;
    bool v = false;
    float sig = 0.0f, del = 0.0f;
    if (in) {
      v = valid[bs];
      sig = sigmas[bs];
      del = deltas[bs];
    }
    const float x = clipped(sig, del, v);
    float csum = __fadd_rn(carry, x);   // carry + x_c0 + ... + x_s, in order
    for (int k = 1; k < clen; ++k) {
      const float prev = __shfl_up_sync(FULL, csum, 1);
      if (s == k) csum = __fadd_rn(prev, x);
    }
    carry = __shfl_sync(FULL, csum, clen - 1);
    const float T = expf(-__fsub_rn(csum, x));
    const bool inc = v && T > thr;
    const float w = inc ? __fmul_rn(-expm1f(-x), T) : 0.0f;
    if (WIDE && in) wsh[s] = w;   // each tile's d_raws read it
    __syncwarp();   // the chunk's first tile of raws and g_rend is staged
    float G = 0.0f, TE = 0.0f;
    if (inc) {
      G = __fadd_rn(__fadd_rn(gop, __fmul_rn(gdep, ts[bs])), g_ws[bs]);
      TE = __fmul_rn(T, expf(-x));
    }
    for (int k0 = 0;;) {
      const int tc = min(tw, C - k0);
      if (inc) {
        const float* r = rs + s * stride;
        for (int c = 0; c < tc; ++c) G = __fadd_rn(G, __fmul_rn(gr[c], r[c]));
      }
      if (WIDE)
        store_wide(d_raws + (b + c0) * C + k0, clen, tc, C, gr, wsh, s, 32);
      k0 += tw;
      if (!WIDE || k0 >= C) break;
      __syncwarp();   // the tile is read
      stage(k0);
      __syncwarp();   // the next tile is staged
    }
    if (in) {
      d_sigmas[bs] = __fmul_rn(G, TE);
      gwb[bs] = __fmul_rn(G, w);
      if (!WIDE) wsh[s] = w;
    }
    if constexpr (!WIDE) {
      __syncwarp();
      store_d_raws(d_raws + (b + c0) * C, clen * C, C, gr, wsh, s, 32);
    }
    __syncwarp();   // w and the raws are read before the next chunk
  }
  float later = 0.0f;   // sum of G*w over the samples after the chunk
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int c0 = ch * 32, clen = min(32, len - c0);
    const size_t bs = b + c0 + s;
    const bool in = s < clen;
    bool v = false;
    float sig = 0.0f, del = 0.0f, gte = 0.0f, gw_s = 0.0f;
    if (in) {
      v = valid[bs];
      sig = sigmas[bs];
      del = deltas[bs];
      gte = d_sigmas[bs];
      gw_s = gwb[bs];
    }
    float suffix = __fadd_rn(later, gw_s);   // sum_{s'>=s} G w, back to front
    for (int k = clen - 2; k >= 0; --k) {
      const float next = __shfl_down_sync(FULL, suffix, 1);
      if (s == k) suffix = __fadd_rn(next, gw_s);
    }
    float after = __shfl_down_sync(FULL, suffix, 1);   // sum_{s'>s}
    if (s == clen - 1) after = later;
    later = __shfl_sync(FULL, suffix, 0);
    if (in) {
      const float dx = __fsub_rn(gte, after);
      const float raw_x = __fmul_rn(sig, del);
      const bool pass = v && raw_x > 0.0f && raw_x < SIGDT_MAX;
      d_sigmas[bs] = pass ? __fmul_rn(dx, del) : 0.0f;
    }
  }
}

// gw: the power of two at or above the row bound max_len, at most 32
inline int group_width(int max_len) {
  int gw = 1;
  while (gw < max_len && gw < 32) gw <<= 1;
  return gw;
}

// A block's shared memory past 48 KB takes the opt-in (it holds
// per device: set it at each launch)
template <class Kernel>
int wide_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <class Rows, int Q>
int launch_fwd_wide(const void* sigmas, const void* raws, const void* deltas,
                    const void* ts, const void* valid, const void* T_start,
                    Rows rows, int N, int C, int gw, float thr, void* opacity,
                    void* depth, void* rend, void* ws, void* vr,
                    cudaStream_t stream) {
  const int per_block = FWD_THREADS / gw;
  const size_t bytes =
      sizeof(float) * per_block * fwd_region(gw, min(Q * gw, C));
  const auto kernel = composite_fwd_wide_kernel<Rows, Q>;
  if (const int e = wide_smem(kernel, bytes)) return e;
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
int launch_fwd(const void* sigmas, const void* raws, const void* deltas,
               const void* ts, const void* valid, const void* T_start,
               Rows rows, int N, int max_len, int C, float thr, void* opacity,
               void* depth, void* rend, void* ws, void* vr,
               cudaStream_t stream) {
  // as narrow as a row of several chunks allows in one pass (a sum a
  // lane: gw >= C + 2), and no wider than the row bound
  int gw = group_width(min(max_len, C + 2));
  // past gw sums: at most FWD_QMAX sums a lane, and groups of 4 lanes or
  // more (16-byte aligned regions)
  if (C + 2 > gw)
    gw = max(max(gw, group_width((C + 2 + FWD_QMAX - 1) / FWD_QMAX)), 4);
  if (C + 2 > gw) {
    auto launch = (C + 2 + gw - 1) / gw == 2   ? launch_fwd_wide<Rows, 2>
                  : (C + 2 + gw - 1) / gw == 3 ? launch_fwd_wide<Rows, 3>
                                               : launch_fwd_wide<Rows, 4>;
    return launch(sigmas, raws, deltas, ts, valid, T_start, rows, N, C, gw,
                  thr, opacity, depth, rend, ws, vr, stream);
  }
  const int per_block = FWD_THREADS / gw;
  const size_t bytes = sizeof(float) * per_block * (gw * C + 2 * gw);
  composite_fwd_kernel<Rows><<<ncn_blocks(N, per_block), FWD_THREADS, bytes,
                               stream>>>(
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
               void* d_sigmas, void* d_raws, void* scratch,
               cudaStream_t stream) {
  const bool wide = C > BWD_NARROW;
  const int tw = min(C, BWD_TILE);
  if (max_len > LANE_ROWS) {   // a warp a ray, chunks of 32 samples
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int per_block = BWD_THREADS / 32;
    const size_t bytes = sizeof(float) * per_block *
                         (wide ? wide_region(32, tw) : 32 * tw + 32 + tw);
    auto kernel = wide ? composite_bwd_long_kernel<Rows, true>
                       : composite_bwd_long_kernel<Rows, false>;
    if (const int e = wide_smem(kernel, bytes)) return e;
    kernel<<<ncn_blocks(N, per_block), BWD_THREADS, bytes, stream>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(raws),
        static_cast<const float*>(deltas), static_cast<const float*>(ts),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(g_op),
        static_cast<const float*>(g_depth),
        static_cast<const float*>(g_rend), static_cast<const float*>(g_ws),
        rows, N, C, max_len, thr, static_cast<float*>(d_sigmas),
        static_cast<float*>(d_raws), static_cast<float*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  const int gw = group_width(max_len);
  const int per_block = BWD_THREADS / gw;
  const size_t bytes = sizeof(float) * per_block *
                       (wide ? wide_region(gw, tw) : gw * tw + gw + tw);
  auto kernel = wide ? composite_bwd_kernel<Rows, true>
                     : composite_bwd_kernel<Rows, false>;
  if (const int e = wide_smem(kernel, bytes)) return e;
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

// scratch: N*K floats when K > 32 (the long kernel's G*w), else unused
extern "C" int composite_bwd(const void* sigmas, const void* raws,
                             const void* deltas, const void* ts,
                             const void* valid, const void* g_op,
                             const void* g_depth, const void* g_rend,
                             const void* g_ws, int N, int K, int C, float thr,
                             void* d_sigmas, void* d_raws, void* scratch,
                             cudaStream_t stream) {
  return launch_bwd(sigmas, raws, deltas, ts, valid, g_op, g_depth, g_rend,
                    g_ws, DenseRows{K}, N, K, C, thr, d_sigmas, d_raws,
                    scratch, stream);
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

// max_len: a bound on the segments, which the caller knows; scratch: one
// float a slot when max_len > 32 (the long kernel's G*w), else unused.
extern "C" int composite_seg_bwd(const void* sigmas, const void* raws,
                                 const void* deltas, const void* ts,
                                 const void* valid, const void* g_op,
                                 const void* g_depth, const void* g_rend,
                                 const void* g_ws, const void* ray_start,
                                 const void* ray_count, int N, int max_len,
                                 int C, float thr, void* d_sigmas,
                                 void* d_raws, void* scratch,
                                 cudaStream_t stream) {
  SegmentRows rows{static_cast<const int*>(ray_start),
                   static_cast<const int*>(ray_count)};
  return launch_bwd(sigmas, raws, deltas, ts, valid, g_op, g_depth, g_rend,
                    g_ws, rows, N, max_len, C, thr, d_sigmas, d_raws,
                    scratch, stream);
}
