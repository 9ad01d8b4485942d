// K9: the optimizer's update, optax's clip_by_global_norm followed by AdamW
// (or plain Adam) over every named parameter, in two launches.
//
// Replaces the JAX package's optimizer chain (normal_clustering_nerf_tpu/
// training/state.py:43-79 `build_optimizer`: optax.chain(
// clip_by_global_norm(grad_clip), multi_transform({model: adamw(sched,
// eps, wd, mask), ext: adam(1e-6), dR_glob: adam(lr_dR_norm_glob), theta:
// adam(sched)}))), which the port ran as ~22 elementwise torch launches a
// parameter tensor (the reference's apex FusedAdam, train_nerf.py:40, was
// one CUDA kernel). Nothing here reads the host, and no float atomics are
// used: a CUDA graph's replay equals the eager step bit for bit.
//
// Arithmetic (--fmad=false; every product, sum, division and square root
// rounded alone, IEEE), which the plain version (ops/adamw.py) repeats
// with torch elementwise ops, so that the two agree bit for bit:
//  - g_norm = sqrt of the sum of every g^2, in a fixed order: each tensor
//    is cut into tiles of TILE values (a tensor's first tile starts at its
//    first value); thread t of a tile adds, from +0.0, the squares of its
//    QUADS quads k THREADS + t (k = 0..QUADS-1, each quad's 4 values in
//    order); the lanes' sums meet in xor halvings 16..1, then the WARPS
//    warp sums in halvings WARPS/2..1 (`block_sum`); the tile sums, in
//    the tensors' order and each tensor's tiles in order, are added the
//    same way (thread t the tiles t, t + THREADS, ... in order, then
//    `block_sum`). The order depends on the tensors' sizes alone, never
//    on the card;
//  - keep = g_norm < grad_clip (false for a NaN norm); where not kept, g
//    becomes (g / g_norm) * grad_clip (a division, then a product: optax's
//    clip_fn, not a product with grad_clip / g_norm);
//  - mu = (1 - b1) g + b1 mu, nu = (1 - b2) (g g) + b2 nu, the factors the
//    f32 values of the host's doubles;
//  - u = (mu / bc1) / (sqrt(nu / bc2) + eps), u = u + wd p where the
//    tensor decays, p = p + u (-lr): lr the step table's (negated here) or
//    a constant one's tensor, which holds -lr already.
//
// Bound on the H100: bytes. The update reads g, p, mu, nu and writes p,
// mu, nu: 28 bytes a value, 0.117 ms for the triplane field's 13,973,376
// values at 3.35 TB/s; the norm reads g once more (32 bytes a value in
// all). ~15 f32 operations a value are far under the card's rate. The
// design: a tile plan built on the host each call (a struct passed by
// value, so a captured graph keeps the pointers of its capture), tiles of
// 4096 values a block of 256 threads, a thread's four quads loaded at once
// (16-byte loads where the tensor's start is 16-byte aligned, else four
// scalar loads; gradients can be views into one flat buffer at any 4-byte
// offset, `training/distributed.py:mean_over_axis`).
//
// `adamw_norm`: the tile sums at the tile's slot; the block that takes a
// call's last ticket (an epoch and an arrival count in one 64-bit word,
// zeroed once, reset by that block: look_back.cuh's pattern) adds the
// slots, writes g_norm and advances the optimizer's int64 count.
// `adamw_step`: every value's clip, moments, update and parameter step,
// reading g_norm once a block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUADS = 4;                      // a thread's quads of a tile
constexpr int TILE = THREADS * QUADS * 4;     // values a tile: 4096
constexpr int MAX_TENSORS = 32;
constexpr int DECAY = 1;        // flags: weight decay on this tensor
constexpr int NEGATE_LR = 2;    // lr holds +lr (the step table's); else -lr

struct Entry {
  const float* g;
  float* p;
  float* mu;
  float* nu;
  const float* lr;   // 0-dim f32
  long long n;       // values
  int first_tile;    // the tensor's first tile in the plan
  int flags;
};

// ops/adamw.py builds the same struct with ctypes
struct Plan {
  Entry e[MAX_TENSORS];
  int tensors;
  int tiles;
};
static_assert(sizeof(Entry) == 56, "ops/adamw.py's _Entry");
static_assert(sizeof(Plan) == 1800, "ops/adamw.py's _Plan");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the plan's tensor of tile `tile` (uniform over the block)
__device__ __forceinline__ int entry_of(const Plan& plan, int tile) {
  int i = 0;
  while (i + 1 < plan.tensors && plan.e[i + 1].first_tile <= tile) ++i;
  return i;
}

// values q..q+3 of a (n values from a), 0 past n: one 16-byte load where
// a is 16-byte aligned and the quad whole
__device__ __forceinline__ float4 load4(const float* a, long long q,
                                        long long n, bool vec) {
  if (vec && q + 4 <= n) return *reinterpret_cast<const float4*>(a + q);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q < n) v.x = a[q];
  if (q + 1 < n) v.y = a[q + 1];
  if (q + 2 < n) v.z = a[q + 2];
  if (q + 3 < n) v.w = a[q + 3];
  return v;
}

__device__ __forceinline__ void store4(float* a, long long q, long long n,
                                       bool vec, float4 v) {
  if (vec && q + 4 <= n) {
    *reinterpret_cast<float4*>(a + q) = v;
    return;
  }
  if (q < n) a[q] = v.x;
  if (q + 1 < n) a[q + 1] = v.y;
  if (q + 2 < n) a[q + 2] = v.z;
  if (q + 3 < n) a[q + 3] = v.w;
}

__device__ __forceinline__ float add_squares(float s, float4 v) {
  s = __fadd_rn(s, __fmul_rn(v.x, v.x));
  s = __fadd_rn(s, __fmul_rn(v.y, v.y));
  s = __fadd_rn(s, __fmul_rn(v.z, v.z));
  return __fadd_rn(s, __fmul_rn(v.w, v.w));
}

// The block's sum of every thread's s in K9's tree, in lane 0 of every
// warp: xor halvings 16..1 over the lanes, then over the WARPS warp sums
// (s_warp; a barrier inside).
__device__ __forceinline__ float block_sum(float s, float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
  if (lane == 0) s_warp[warp] = s;
  __syncthreads();
  float w = lane < WARPS ? s_warp[lane] : 0.0f;
#pragma unroll
  for (int o = WARPS / 2; o > 0; o >>= 1)
    w = __fadd_rn(w, __shfl_xor_sync(FULL, w, o));
  return w;
}

// one tile a block: the tile's sum of squares at slots[tile]; the last
// block to arrive adds the slots into g_norm and advances count
__global__ void __launch_bounds__(THREADS) adamw_norm_kernel(
    const __grid_constant__ Plan plan, unsigned long long* __restrict__ work,
    float* __restrict__ slots, float* __restrict__ g_norm,
    long long* __restrict__ count) {
  __shared__ float s_warp[WARPS];
  __shared__ bool s_last;
  const int tile = blockIdx.x, tid = threadIdx.x;
  const Entry& e = plan.e[entry_of(plan, tile)];
  const long long base = static_cast<long long>(tile - e.first_tile) * TILE;
  const float* g = e.g + base;
  const long long n = e.n - base;
  const bool vec = aligned16(e.g);
  float4 v[QUADS];
#pragma unroll
  for (int k = 0; k < QUADS; ++k)
    v[k] = load4(g, 4ll * (k * THREADS + tid), n, vec);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < QUADS; ++k) s = add_squares(s, v[k]);
  const float sum = block_sum(s, s_warp);
  if (tid == 0) {
    slots[tile] = sum;
    __threadfence();
    const unsigned long long t = atomicAdd(work, 1ull);
    const bool last = static_cast<unsigned>(t) == gridDim.x - 1;
    if (last) atomicExch(work, ((t >> 32) + 1) << 32);
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float a = 0.0f;
  for (int i = tid; i < plan.tiles; i += THREADS)
    a = __fadd_rn(a, __ldcg(slots + i));
  const float total = block_sum(a, s_warp);
  if (tid == 0) {
    *g_norm = __fsqrt_rn(total);
    *count += 1;
  }
}

struct Hyper {
  float b1, one_b1, b2, one_b2, eps, wd, clip;
};

__device__ __forceinline__ void adam1(float& p, float& mu, float& nu,
                                      float g, bool keep, float gn,
                                      float bc1, float bc2, float step,
                                      bool decay, const Hyper& h) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, gn), h.clip);
  mu = __fadd_rn(__fmul_rn(h.one_b1, g), __fmul_rn(h.b1, mu));
  nu = __fadd_rn(__fmul_rn(h.one_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, nu));
  float u = __fdiv_rn(__fdiv_rn(mu, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(u, step));
}

// one tile a block: the clip, the moments and the step of its values
__global__ void __launch_bounds__(THREADS) adamw_step_kernel(
    const __grid_constant__ Plan plan, const float* __restrict__ g_norm,
    const float* __restrict__ bc1_p, const float* __restrict__ bc2_p,
    Hyper h) {
  __shared__ float s_gn;
  const int tile = blockIdx.x, tid = threadIdx.x;
  const Entry& e = plan.e[entry_of(plan, tile)];
  if (tid == 0) s_gn = __ldg(g_norm);
  const long long base = static_cast<long long>(tile - e.first_tile) * TILE;
  const long long n = e.n - base;
  const float* g = e.g + base;
  float* p = e.p + base;
  float* mu = e.mu + base;
  float* nu = e.nu + base;
  const bool vg = aligned16(e.g);
  const bool vs = aligned16(e.p) && aligned16(e.mu) && aligned16(e.nu);
  float4 G[QUADS], P[QUADS], M[QUADS], V[QUADS];
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    const long long q = 4ll * (k * THREADS + tid);
    G[k] = load4(g, q, n, vg);
    P[k] = load4(p, q, n, vs);
    M[k] = load4(mu, q, n, vs);
    V[k] = load4(nu, q, n, vs);
  }
  const float bc1 = __ldg(bc1_p), bc2 = __ldg(bc2_p), lr = __ldg(e.lr);
  const float step = (e.flags & NEGATE_LR) ? -lr : lr;
  const bool decay = (e.flags & DECAY) != 0;
  __syncthreads();
  const float gn = s_gn;
  const bool keep = gn < h.clip;
#pragma unroll
  for (int k = 0; k < QUADS; ++k) {
    const long long q = 4ll * (k * THREADS + tid);
    if (q >= n) continue;
    adam1(P[k].x, M[k].x, V[k].x, G[k].x, keep, gn, bc1, bc2, step, decay, h);
    adam1(P[k].y, M[k].y, V[k].y, G[k].y, keep, gn, bc1, bc2, step, decay, h);
    adam1(P[k].z, M[k].z, V[k].z, G[k].z, keep, gn, bc1, bc2, step, decay, h);
    adam1(P[k].w, M[k].w, V[k].w, G[k].w, keep, gn, bc1, bc2, step, decay, h);
    store4(p, q, n, vs, P[k]);
    store4(mu, q, n, vs, M[k]);
    store4(nu, q, n, vs, V[k]);
  }
}

// the plan's own consistency: 1..MAX_TENSORS tensors, each's tiles
// ceil(n / TILE) after the one before, and every tile some tensor's
bool plan_ok(const Plan* plan) {
  if (plan->tensors < 1 || plan->tensors > MAX_TENSORS || plan->tiles < 1)
    return false;
  long long next = 0;
  for (int i = 0; i < plan->tensors; ++i) {
    const Entry& e = plan->e[i];
    if (e.n < 0 || e.first_tile != next || !e.g || !e.p || !e.mu || !e.nu ||
        !e.lr)
      return false;
    next += (e.n + TILE - 1) / TILE;
  }
  return next == plan->tiles;
}

}  // namespace

// plan: the host's Plan (copied into the launch); work: one 64-bit word,
// zeroed once (a buffer kept for the device, its calls ordered on one
// stream); slots: plan->tiles f32; g_norm: one f32; count: one int64.
extern "C" int adamw_norm(const void* plan, void* work, void* slots,
                          void* g_norm, void* count, cudaStream_t stream) {
  const Plan* pl = static_cast<const Plan*>(plan);
  if (!plan_ok(pl) || !work || !slots || !g_norm || !count)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_norm_kernel<<<pl->tiles, THREADS, 0, stream>>>(
      *pl, static_cast<unsigned long long*>(work), static_cast<float*>(slots),
      static_cast<float*>(g_norm), static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// plan as adamw_norm's; g_norm, bc1, bc2: one f32 each on the card; the
// factors as the f32 values of the host's doubles.
extern "C" int adamw_step(const void* plan, const void* g_norm,
                          const void* bc1, const void* bc2, float b1,
                          float one_b1, float b2, float one_b2, float eps,
                          float wd, float clip, cudaStream_t stream) {
  const Plan* pl = static_cast<const Plan*>(plan);
  if (!plan_ok(pl) || !g_norm || !bc1 || !bc2)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_step_kernel<<<pl->tiles, THREADS, 0, stream>>>(
      *pl, static_cast<const float*>(g_norm), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2),
      Hyper{b1, one_b1, b2, one_b2, eps, wd, clip});
  return static_cast<int>(cudaGetLastError());
}
