// H3: front-to-back compositing of dense (N, K) samples with C channels,
// forward and backward.
//
// Replaces the JAX package's `composite_rays`
// (normal_clustering_nerf_tpu/ops/composite.py:34-83, without T_start),
// whose backward JAX derives by autodiff; here the backward is written out
// (the reference's volumerendering.cu:298-364 in the dense layout).
//
// Forward, per ray: x_s = clip(valid ? sigma*delta : 0, 0, 80),
// T_s = exp(-(sum_{k<=s} x_k - x_s)), alpha_s = 1 - exp(-x_s),
// include_s = valid_s & T_s > T_threshold, w_s = include_s ? alpha_s*T_s : 0;
// opacity = sum w, depth = sum w*t, rend_c = sum w*raw_c, and the sample
// counter skips the sample that crosses the threshold (composite.py:64-75).
// Backward, per ray, for upstream gradients on opacity, depth, rend AND ws
// (ws feeds the distortion loss): with G_s = g_op + g_depth*t_s +
// sum_c g_rend_c*raw_sc + g_ws_s over included samples,
//   dL/dx_j = G_j*T_j*exp(-x_j) - sum_{s>j} G_s*w_s,
//   dL/dsigma_j = delta_j * dL/dx_j inside the clip, dL/draw_jc = g_rend_c*w_j.
//
// Design: one thread per ray; the forward is one pass with running sums,
// the backward recomputes T/alpha/w into registers (K <= 32) and walks the
// samples back to front with a running suffix sum. Nothing per-sample is
// saved by the forward beyond its outputs.
//
// Bound on the H100: memory. Per ray it reads K*(C+4) values and writes
// K (+ K*C in the backward) values once, with a handful of flops each; the
// launch of one thread per ray (8190 rays) fills few warps, so at this size
// latency matters as much as bandwidth. Consecutive threads read rows K*C
// floats apart, which L1 absorbs (each ray's row is read once, in order).
#include "common.cuh"

namespace {

constexpr int MAXK = 32;
constexpr float SIGDT_MAX = 80.0f;

__device__ __forceinline__ float clipped(float sigma, float delta, bool valid) {
  float x = valid ? __fmul_rn(sigma, delta) : 0.0f;
  return fminf(fmaxf(x, 0.0f), SIGDT_MAX);
}

__global__ void composite_fwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, int N, int K, int C, float thr,
    float* __restrict__ opacity, float* __restrict__ depth,
    float* __restrict__ rend, float* __restrict__ ws, int* __restrict__ vr) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t b = static_cast<size_t>(n) * K;
  float csum = 0.0f, op = 0.0f, dp = 0.0f;
  float acc[16];
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int n_inc = 0;
  bool early = false;
  for (int s = 0; s < K; ++s) {
    bool v = valid[b + s];
    float x = clipped(sigmas[b + s], deltas[b + s], v);
    csum = __fadd_rn(csum, x);
    float T = expf(-__fsub_rn(csum, x));
    float alpha = -expm1f(-x);
    bool inc = v && T > thr;
    float w = inc ? __fmul_rn(alpha, T) : 0.0f;
    ws[b + s] = w;
    if (!inc) continue;
    op = __fadd_rn(op, w);
    dp = __fadd_rn(dp, __fmul_rn(w, ts[b + s]));
    const float* r = raws + (b + s) * C;
    for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, r[c]));
    ++n_inc;
    early |= __fmul_rn(T, __fsub_rn(1.0f, alpha)) <= thr;
  }
  opacity[n] = op;
  depth[n] = dp;
  for (int c = 0; c < C; ++c) rend[static_cast<size_t>(n) * C + c] = acc[c];
  vr[n] = n_inc - (early ? 1 : 0);
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ raws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ g_op,
    const float* __restrict__ g_depth, const float* __restrict__ g_rend,
    const float* __restrict__ g_ws, int N, int K, int C, float thr,
    float* __restrict__ d_sigmas, float* __restrict__ d_raws) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t b = static_cast<size_t>(n) * K;
  float gr[16];
  for (int c = 0; c < C; ++c) gr[c] = g_rend[static_cast<size_t>(n) * C + c];
  const float go = g_op[n], gd = g_depth[n];
  float G[MAXK], W[MAXK], TE[MAXK];   // G_s, w_s, T_s*exp(-x_s)
  float csum = 0.0f;
  for (int s = 0; s < K; ++s) {
    bool v = valid[b + s];
    float x = clipped(sigmas[b + s], deltas[b + s], v);
    csum = __fadd_rn(csum, x);
    float T = expf(-__fsub_rn(csum, x));
    bool inc = v && T > thr;
    float w = inc ? __fmul_rn(-expm1f(-x), T) : 0.0f;
    const float* r = raws + (b + s) * C;
    float g = __fadd_rn(__fadd_rn(go, __fmul_rn(gd, ts[b + s])), g_ws[b + s]);
    for (int c = 0; c < C; ++c) g = __fadd_rn(g, __fmul_rn(gr[c], r[c]));
    G[s] = inc ? g : 0.0f;
    W[s] = w;
    TE[s] = inc ? __fmul_rn(T, expf(-x)) : 0.0f;
    float* dr = d_raws + (b + s) * C;
    for (int c = 0; c < C; ++c) dr[c] = __fmul_rn(gr[c], w);
  }
  float suffix = 0.0f;   // sum_{s>j} G_s * w_s
  for (int j = K - 1; j >= 0; --j) {
    float dx = __fsub_rn(__fmul_rn(G[j], TE[j]), suffix);
    suffix = __fadd_rn(suffix, __fmul_rn(G[j], W[j]));
    float raw_x = __fmul_rn(sigmas[b + j], deltas[b + j]);
    bool pass = valid[b + j] && raw_x > 0.0f && raw_x < SIGDT_MAX;
    d_sigmas[b + j] = pass ? __fmul_rn(dx, deltas[b + j]) : 0.0f;
  }
}

}  // namespace

extern "C" int composite_fwd(const void* sigmas, const void* raws,
                             const void* deltas, const void* ts,
                             const void* valid, int N, int K, int C, float thr,
                             void* opacity, void* depth, void* rend, void* ws,
                             void* vr, cudaStream_t stream) {
  if (K > MAXK || C > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  composite_fwd_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(sigmas), static_cast<const float*>(raws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), N, K, C, thr,
      static_cast<float*>(opacity), static_cast<float*>(depth),
      static_cast<float*>(rend), static_cast<float*>(ws),
      static_cast<int*>(vr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_bwd(const void* sigmas, const void* raws,
                             const void* deltas, const void* ts,
                             const void* valid, const void* g_op,
                             const void* g_depth, const void* g_rend,
                             const void* g_ws, int N, int K, int C, float thr,
                             void* d_sigmas, void* d_raws,
                             cudaStream_t stream) {
  if (K > MAXK || C > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  composite_bwd_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(sigmas), static_cast<const float*>(raws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(g_op),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_rend),
      static_cast<const float*>(g_ws), N, K, C, thr,
      static_cast<float*>(d_sigmas), static_cast<float*>(d_raws));
  return static_cast<int>(cudaGetLastError());
}
