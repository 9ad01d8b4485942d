// H4: Mip-NeRF-360 distortion loss on dense (N, K) rows, forward and
// backward.
//
// Replaces the JAX package's `distortion_loss_dense`
// (normal_clustering_nerf_tpu/ops/distortion.py:36-52), whose gradient JAX
// takes by autodiff; the backward here is the closed form of
// `distortion_reference_grad` (:55-74, the reference's losses.cu:110-140)
// restricted to dense rows.
//
// Per ray, with w = valid ? ws : 0 and inclusive prefix sums W_s, A_s of w
// and w*t: loss = sum_valid 2*(A_s*(W_s - w_s) - W_s*(A_s - w_s*t_s))
//                 + w_s^2*delta_s/3,
// dL/dw_j = g * (2*(t_j*W_{j-1} - A_{j-1} + A_K - A_j - t_j*(W_K - W_j))
//                + 2/3*w_j*delta_j).
//
// Design: one thread per ray; the forward is one pass of running sums, the
// backward two (totals, then the per-sample closed form). Bound on the
// H100: memory (reads 3 f32 + 1 byte per sample, writes one value per ray
// or per sample, ~10 flops each); at 8190 rays it is latency-bound, few
// warps in flight. Fusing it into H3's backward is left to ROADMAP K5.
// The segment launchers (`distortion_seg_fwd` / `distortion_seg_bwd`)
// replace the flat layout's `distortion_loss` (:19-33) and its gradient
// (`distortion_reference_grad`, :55-74) with the same loops over ray-major
// segments; they keep the per-ray sums, not JAX's global cumsum.
#include "common.cuh"

namespace {

// Dense (N, K) rows or flat ray-major segments, as in composite.cu: the
// loop bodies are shared, so both give the same bits on the same samples.
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

template <class Rows>
__global__ void distortion_fwd_kernel(
    const float* __restrict__ ws, const float* __restrict__ deltas,
    const float* __restrict__ ts, const uint8_t* __restrict__ valid, Rows rows,
    int N, float* __restrict__ loss) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t b = rows.base(n);
  const int K = rows.len(n);
  float W = 0.0f, A = 0.0f, out = 0.0f;
  for (int s = 0; s < K; ++s) {
    bool v = valid[b + s];
    float w = v ? ws[b + s] : 0.0f;
    float wt = __fmul_rn(w, ts[b + s]);
    W = __fadd_rn(W, w);
    A = __fadd_rn(A, wt);
    float per = __fadd_rn(
        __fmul_rn(2.0f, __fsub_rn(__fmul_rn(A, __fsub_rn(W, w)),
                                  __fmul_rn(W, __fsub_rn(A, wt)))),
        __fmul_rn(__fmul_rn(__fmul_rn(1.0f / 3.0f, w), w), deltas[b + s]));
    if (v) out = __fadd_rn(out, per);
  }
  loss[n] = out;
}

template <class Rows>
__global__ void distortion_bwd_kernel(
    const float* __restrict__ g_loss, const float* __restrict__ ws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, Rows rows, int N,
    float* __restrict__ d_ws) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t b = rows.base(n);
  const int K = rows.len(n);
  float Wk = 0.0f, Ak = 0.0f;
  for (int s = 0; s < K; ++s) {
    float w = valid[b + s] ? ws[b + s] : 0.0f;
    Wk = __fadd_rn(Wk, w);
    Ak = __fadd_rn(Ak, __fmul_rn(w, ts[b + s]));
  }
  const float g = g_loss[n];
  float W = 0.0f, A = 0.0f;
  for (int j = 0; j < K; ++j) {
    bool v = valid[b + j];
    float w = v ? ws[b + j] : 0.0f;
    float t = ts[b + j];
    float wt = __fmul_rn(w, t);
    float head = __fsub_rn(__fmul_rn(t, W), A);          // uses W_{j-1}, A_{j-1}
    W = __fadd_rn(W, w);
    A = __fadd_rn(A, wt);
    float tail = __fsub_rn(__fsub_rn(Ak, A), __fmul_rn(t, __fsub_rn(Wk, W)));
    float d = __fmul_rn(__fmul_rn(g, 2.0f), __fadd_rn(head, tail));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(__fmul_rn(g, 2.0f / 3.0f), w),
                               deltas[b + j]));
    d_ws[b + j] = v ? d : 0.0f;
  }
}

template <class Rows>
int launch_fwd(const void* ws, const void* deltas, const void* ts,
               const void* valid, Rows rows, int N, void* loss,
               cudaStream_t stream) {
  const int threads = 64;
  distortion_fwd_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(deltas),
      static_cast<const float*>(ts), static_cast<const uint8_t*>(valid), rows,
      N, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch_bwd(const void* g_loss, const void* ws, const void* deltas,
               const void* ts, const void* valid, Rows rows, int N,
               void* d_ws, cudaStream_t stream) {
  const int threads = 64;
  distortion_bwd_kernel<<<ncn_blocks(N, threads), threads, 0, stream>>>(
      static_cast<const float*>(g_loss), static_cast<const float*>(ws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), rows, N, static_cast<float*>(d_ws));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int distortion_fwd(const void* ws, const void* deltas,
                              const void* ts, const void* valid, int N, int K,
                              void* loss, cudaStream_t stream) {
  return launch_fwd(ws, deltas, ts, valid, DenseRows{K}, N, loss, stream);
}

extern "C" int distortion_bwd(const void* g_loss, const void* ws,
                              const void* deltas, const void* ts,
                              const void* valid, int N, int K, void* d_ws,
                              cudaStream_t stream) {
  return launch_bwd(g_loss, ws, deltas, ts, valid, DenseRows{K}, N, d_ws,
                    stream);
}

// The flat layout (distortion_loss): ray n's samples are the budget slots
// [ray_start[n], ray_start[n] + ray_count[n]); the caller zeroes d_ws.
extern "C" int distortion_seg_fwd(const void* ws, const void* deltas,
                                  const void* ts, const void* valid,
                                  const void* ray_start, const void* ray_count,
                                  int N, void* loss, cudaStream_t stream) {
  SegmentRows rows{static_cast<const int*>(ray_start),
                   static_cast<const int*>(ray_count)};
  return launch_fwd(ws, deltas, ts, valid, rows, N, loss, stream);
}

extern "C" int distortion_seg_bwd(const void* g_loss, const void* ws,
                                  const void* deltas, const void* ts,
                                  const void* valid, const void* ray_start,
                                  const void* ray_count, int N, void* d_ws,
                                  cudaStream_t stream) {
  SegmentRows rows{static_cast<const int*>(ray_start),
                   static_cast<const int*>(ray_count)};
  return launch_bwd(g_loss, ws, deltas, ts, valid, rows, N, d_ws, stream);
}
