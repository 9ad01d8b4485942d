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
// What bounds it on the H100: latency and the number of memory
// transactions, not the bytes (~1.7 MB moved by the forward, ~2.3 MB by
// the backward at the bench batch, N 8190, K 16: ~0.0005-0.0007 ms at
// 3.35 TB/s). The design this replaces ran one thread per ray in blocks
// of 64 (128 blocks of two warps on 132 SMs): each thread walked its K samples
// with dependent loads, lanes read ws, deltas, ts and valid K*4 bytes
// apart and wrote d_ws as far apart (32 sectors a warp load), and the
// backward read every row twice.
//
// Design: a group of GW = 4 lanes takes one ray, each lane a run of V = 4
// consecutive samples, in chunks of 16 samples (8 rays a warp, ~1,000
// warps at N 8190, K 16); a lane's run is read (and d_ws written) as
// 16-byte words where the row is aligned, so the group's loads and stores
// are contiguous, else one by one. Both launchers take that width: the
// segment launcher needs no bound on the segment lengths and no host sync
// (it stays capturable in a CUDA graph). The chunk loop runs the warp's
// longest row (`__reduce_max_sync`), the lanes past each group's row
// masked. Lane = sample (16 lanes a ray, each lane adding every earlier
// sample, broadcast by a shuffle) was tried on the card: 16 steps for a
// warp of two rays, so the warp's instructions, not the memory, set its
// time, and its forward was slower than the thread a ray's. Bits kept,
// those of the thread-a-ray loop under --fmad=false:
//  - W_s and A_s: a chain through the group's lanes in the serial order;
//    lane k starts from lane k-1's last sums (a shuffle-up; lane 0 from
//    the carries of the chunks before) and adds its samples one after the
//    other; the sums before a sample are the serial loop's W_{j-1},
//    A_{j-1} (the previous sample's, or the lane's start), not W_j - w_j;
//  - the forward's term keeps the serial expression, W - w and A - wt
//    from the inclusive sums, and `out` adds the valid samples' terms in
//    order by the same chain (the invalid ones skipped, never added as 0);
//  - the backward's totals W_K, A_K are the row's last sums; a row of more
//    than one chunk takes them in a first sweep over its chunks (the same
//    sums, so the same bits) before the closed form.
// Nothing is kept in a runtime-indexed array. The dense backward writes
// every slot of its rows (0 for an invalid sample); the segment launchers
// (`distortion_seg_fwd` / `distortion_seg_bwd`) replace the flat layout's
// `distortion_loss` (:19-33) and its gradient (`distortion_reference_grad`,
// :55-74) with the same bodies over ray-major segments and keep the
// per-ray sums, not JAX's global cumsum. Fusing H4 into H3 is listed in
// ROADMAP, queue B.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GW = 4;   // lanes a ray
constexpr int V = 4;    // consecutive samples a lane
constexpr int CH = GW * V;
static_assert(V == 4, "a run is read as one 16-byte word");

// Dense (N, K) rows or flat ray-major segments, as in composite.cu: the
// bodies are shared, so both give the same bits on the same samples.
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

// Where lane s of a group stands in the warp-uniform loop over the chunks
// of CH samples of its ray; the lane takes samples s*V .. s*V + V - 1 of
// each chunk.
struct Group {
  int s;        // the lane in its group
  bool live;    // the group has a ray (n < N)
  size_t b;     // the ray's first slot
  int len;      // its samples
  int wlen;     // the warp's longest row: the chunk loop's bound

  template <class Rows>
  __device__ Group(Rows rows, int N, int& n) {
    s = threadIdx.x & (GW - 1);
    n = blockIdx.x * (THREADS / GW) + threadIdx.x / GW;
    live = n < N;
    b = live ? rows.base(n) : 0;
    len = live ? rows.len(n) : 0;
    wlen = __reduce_max_sync(FULL, len);
  }
  // the row's samples from the lane's first in the chunk at c0 on: the
  // lane holds min(rem, V) of them (none if rem <= 0). Kept unclamped:
  // with the clamped count n, ptxas (CUDA 12.9, sm_90a) turned `n == V`
  // into the predicate output of a VIMNMX.RELU, and on the card a run of
  // one sample at an aligned slot took the 16-byte path
  __device__ int rem(int c0) const { return len - c0 - s * V; }
  // the lanes the chunk's chains run through (warp-uniform)
  __device__ int lanes(int c0) const {
    return (min(CH, wlen - c0) + V - 1) / V;
  }
};

// A lane's run: its samples i < rem from slot i0 (w = valid ? ws : 0), as
// 16-byte words where `vec` (all V in the row, 16-byte aligned), else one
// by one; deltas may be null (not read).
struct Run {
  float w[V], t[V], del[V];
  bool v[V];

  __device__ Run(const float* __restrict__ ws, const float* __restrict__ ts,
                 const float* __restrict__ deltas,
                 const uint8_t* __restrict__ valid, size_t i0, int rem,
                 bool vec) {
    float raw[V];
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(ws + i0));
      const float4 c = __ldg(reinterpret_cast<const float4*>(ts + i0));
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(valid + i0));
      raw[0] = a.x, raw[1] = a.y, raw[2] = a.z, raw[3] = a.w;
      t[0] = c.x, t[1] = c.y, t[2] = c.z, t[3] = c.w;
      v[0] = m.x, v[1] = m.y, v[2] = m.z, v[3] = m.w;
      if (deltas) {
        const float4 d = __ldg(reinterpret_cast<const float4*>(deltas + i0));
        del[0] = d.x, del[1] = d.y, del[2] = d.z, del[3] = d.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool in = i < rem;
        raw[i] = in ? ws[i0 + i] : 0.0f;
        t[i] = in ? ts[i0 + i] : 0.0f;
        v[i] = in && valid[i0 + i];
        del[i] = in && deltas ? deltas[i0 + i] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) w[i] = v[i] ? raw[i] : 0.0f;
  }
};

// The serial sums of w and wt over a chunk, a chain through the lanes:
// lane k starts from lane k-1's last sums (lane 0 from the carries W, A)
// and adds its samples (i < rem) one after the other. Wb, Ab: the sums
// before the lane's first sample; Wi, Ai: after each of its samples (kept
// past the row). W and A become the sums after the group's last sample in
// the chunk, the next chunk's carries.
__device__ __forceinline__ void prefix(const Run& r, const float (&wt)[V],
                                      int s, int rem, int lanes, float& W,
                                      float& A, float& Wb, float& Ab,
                                      float (&Wi)[V], float (&Ai)[V]) {
  float lw = W, la = A;   // the lane's last sums
  Wb = W, Ab = A;
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    if (k >= lanes) break;
    const float pw = __shfl_up_sync(FULL, lw, 1, GW);
    const float pa = __shfl_up_sync(FULL, la, 1, GW);
    if (s == k) {
      if (k > 0) Wb = pw, Ab = pa;
      float x = Wb, y = Ab;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i < rem) {
          x = __fadd_rn(x, r.w[i]);
          y = __fadd_rn(y, wt[i]);
        }
        Wi[i] = x;
        Ai[i] = y;
      }
      lw = x, la = y;
    }
  }
  W = __shfl_sync(FULL, lw, lanes - 1, GW);
  A = __shfl_sync(FULL, la, lanes - 1, GW);
}

// Whether a lane's run is read and written as 16-byte words.
__device__ __forceinline__ bool vector_run(bool aligned, size_t i0, int rem) {
  return aligned && rem >= V && (i0 & 3) == 0;
}

template <class Rows>
__global__ void __launch_bounds__(THREADS) distortion_fwd_kernel(
    const float* __restrict__ ws, const float* __restrict__ deltas,
    const float* __restrict__ ts, const uint8_t* __restrict__ valid, Rows rows,
    int N, bool aligned, float* __restrict__ loss) {
  int n;
  const Group gr(rows, N, n);
  float W = 0.0f, A = 0.0f, out = 0.0f;
  for (int c0 = 0; c0 < gr.wlen; c0 += CH) {
    const int rem = gr.rem(c0), lanes = gr.lanes(c0);
    const size_t i0 = gr.b + c0 + gr.s * V;
    const Run r(ws, ts, deltas, valid, i0, rem, vector_run(aligned, i0, rem));
    float wt[V], Wi[V], Ai[V], Wb, Ab, per[V];
#pragma unroll
    for (int i = 0; i < V; ++i) wt[i] = __fmul_rn(r.w[i], r.t[i]);
    prefix(r, wt, gr.s, rem, lanes, W, A, Wb, Ab, Wi, Ai);
#pragma unroll
    for (int i = 0; i < V; ++i)
      per[i] = __fadd_rn(
          __fmul_rn(2.0f,
                    __fsub_rn(__fmul_rn(Ai[i], __fsub_rn(Wi[i], r.w[i])),
                              __fmul_rn(Wi[i], __fsub_rn(Ai[i], wt[i])))),
          __fmul_rn(__fmul_rn(__fmul_rn(1.0f / 3.0f, r.w[i]), r.w[i]),
                    r.del[i]));
    // the valid samples' terms, in order: a chain through the lanes
    float lout = out;
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      if (k >= lanes) break;
      const float po = __shfl_up_sync(FULL, lout, 1, GW);
      if (gr.s == k) {
        float o = k > 0 ? po : out;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (r.v[i]) o = __fadd_rn(o, per[i]);
        lout = o;
      }
    }
    out = __shfl_sync(FULL, lout, lanes - 1, GW);
  }
  if (gr.live && gr.s == 0) loss[n] = out;
}

template <class Rows>
__global__ void __launch_bounds__(THREADS) distortion_bwd_kernel(
    const float* __restrict__ g_loss, const float* __restrict__ ws,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const uint8_t* __restrict__ valid, Rows rows, int N, bool aligned,
    float* __restrict__ d_ws) {
  int n;
  const Group gr(rows, N, n);
  const float g = gr.live ? g_loss[n] : 0.0f;
  const bool one_chunk = gr.wlen <= CH;   // warp-uniform
  float Wk = 0.0f, Ak = 0.0f;             // the row's totals
  // sweep 0, rows of several chunks only: the totals; sweep 1: d_ws
  for (int sweep = one_chunk ? 1 : 0; sweep < 2; ++sweep) {
    float W = 0.0f, A = 0.0f;
    for (int c0 = 0; c0 < gr.wlen; c0 += CH) {
      const int rem = gr.rem(c0), lanes = gr.lanes(c0);
      const size_t i0 = gr.b + c0 + gr.s * V;
      const bool vec = vector_run(aligned, i0, rem);
      const Run r(ws, ts, sweep ? deltas : nullptr, valid, i0, rem, vec);
      float wt[V], Wi[V], Ai[V], Wb, Ab, d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) wt[i] = __fmul_rn(r.w[i], r.t[i]);
      prefix(r, wt, gr.s, rem, lanes, W, A, Wb, Ab, Wi, Ai);
      if (sweep == 0) continue;
      if (one_chunk) {   // the chunk's sums are the row's totals
        Wk = W;
        Ak = A;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        // W_{j-1}, A_{j-1}: the sums before sample i
        const float We = i > 0 ? Wi[i - 1] : Wb, Ae = i > 0 ? Ai[i - 1] : Ab;
        const float t = r.t[i];
        const float head = __fsub_rn(__fmul_rn(t, We), Ae);
        const float tail = __fsub_rn(__fsub_rn(Ak, Ai[i]),
                                     __fmul_rn(t, __fsub_rn(Wk, Wi[i])));
        float e = __fmul_rn(__fmul_rn(g, 2.0f), __fadd_rn(head, tail));
        e = __fadd_rn(e, __fmul_rn(__fmul_rn(__fmul_rn(g, 2.0f / 3.0f),
                                             r.w[i]), r.del[i]));
        d[i] = r.v[i] ? e : 0.0f;
      }
      if (vec) {
        *reinterpret_cast<float4*>(d_ws + i0) =
            make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (i < rem) d_ws[i0 + i] = d[i];
      }
    }
    if (sweep == 0) {   // the carries after the last chunk
      Wk = W;
      Ak = A;
    }
  }
}

// The kernels read (and write) 16-byte words only where every array is
// aligned for them: the floats to 16 bytes, the valid bytes to 4.
inline bool words_aligned(const void* ws, const void* deltas, const void* ts,
                          const void* valid, const void* d_ws = nullptr) {
  const uintptr_t f = reinterpret_cast<uintptr_t>(ws)
                      | reinterpret_cast<uintptr_t>(deltas)
                      | reinterpret_cast<uintptr_t>(ts)
                      | reinterpret_cast<uintptr_t>(d_ws);
  return (f & 15) == 0 && (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
}

template <class Rows>
int launch_fwd(const void* ws, const void* deltas, const void* ts,
               const void* valid, Rows rows, int N, void* loss,
               cudaStream_t stream) {
  distortion_fwd_kernel<<<ncn_blocks(N, THREADS / GW), THREADS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(deltas),
      static_cast<const float*>(ts), static_cast<const uint8_t*>(valid), rows,
      N, words_aligned(ws, deltas, ts, valid), static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch_bwd(const void* g_loss, const void* ws, const void* deltas,
               const void* ts, const void* valid, Rows rows, int N,
               void* d_ws, cudaStream_t stream) {
  distortion_bwd_kernel<<<ncn_blocks(N, THREADS / GW), THREADS, 0, stream>>>(
      static_cast<const float*>(g_loss), static_cast<const float*>(ws),
      static_cast<const float*>(deltas), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(valid), rows, N,
      words_aligned(ws, deltas, ts, valid, d_ws), static_cast<float*>(d_ws));
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
// [ray_start[n], ray_start[n] + ray_count[n]), of any length; the caller
// zeroes d_ws.
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
