// K6: the field's four MLPs in bf16 (sigma, rgb, normal and semantic
// heads; bias-free, hidden width 64, h of 16), forward and backward, in
// three launches.
//
// Replaces the nets of normal_clustering_nerf_tpu/models/ngp_mt.py:51
// `_apply_mlp` as `NGPMT.density` (:138) and `NGPMT.__call__` (:172) chain
// them: jnp.dot products that XLA fuses on the TPU, and that the port ran
// as 11 cuBLAS products forward and 22 backward a step, with ~60 launches
// of glue around them (the weights' casts, ReLUs, trunc_exp, the
// direction's normalisation, the cat of [d, h], trunc_sigmoid, the f32
// casts and the raws' cat), every 131,040 x 64 activation a round trip
// through device memory. The paper's code ran them as tiny-cuda-nn
// FullyFusedMLP kernels.
//
//  mlp_fwd        a warp a slab of 16 rows, every layer on the tensor
//                 cores (mma.sync m16n8k16, bf16 in, f32 sums) with the
//                 activations kept in registers (a product's f32
//                 fragment, rounded to bf16, is the next product's A
//                 fragment): sigma = exp(h[:, 0]), the unit direction,
//                 rgb with trunc_sigmoid (none under exposure), the normal
//                 and the semantic heads; writes sigmas (M,) and the raws
//                 (M, C) in the order rgb, norm, sem. The density mode
//                 stops after sigma. Nothing is saved for the backward.
//  mlp_bwd        persistent blocks, a tile of 128 rows at a time (a warp
//                 16 rows): each head's forward recomputed from h, its
//                 gradient taken back layer by layer (A from the
//                 gradient's registers, B = W^T from the same shared
//                 weights by ldmatrix.trans), h's gradient added in
//                 autograd's order (norm + sem, + rgb, + the sigma
//                 slice), then the sigma net's; each weight's gradient of
//                 the tile, X^T dY over its 128 rows, from X and dY staged
//                 in shared memory, added to the block's f32 sums (a
//                 fixed warp a fragment); the encoding's gradient (bf16)
//                 and, when asked, the directions' (through d / |d|).
//                 Each block writes its sums to its row of `partial`.
//  mlp_dw_reduce  each weight gradient: the blocks' partials added in
//                 block order, rounded once to bf16, stored as f32.
// No float atomics: the order of every sum is fixed by the grid.
//
// Rounding (--fmad=false; the plain version, ops/mlp.py, is the parent's
// bf16 chain): every product is an f32 sum over its inputs rounded once
// to bf16; trunc_sigmoid's forward 1 / (1 + exp(-z)) and the three
// elementwise ops of its backward each rounded to bf16; the unit
// direction d / sqrt((d0 d0 + d1 d1) + d2 d2), each operation rounded
// alone, then cast to bf16; each add of h's gradient rounded to bf16;
// ReLU's backward passes the gradient where the output is not <= 0. Only
// the order of the f32 sums inside a product differs from cuBLAS's.
//
// Bound on the H100: operations and bytes about even. A row takes 18,944
// multiply-adds forward (at three classes) and three times that in the
// backward (the recompute, dX and dW); at M 131,040 that is 5.0 GFLOP
// forward, 0.005 ms at the 989 TFLOP/s dense bf16 rate, and ~15 GFLOP
// backward, 0.015 ms; the bytes (the encoding and directions in, sigmas
// and raws out; the gradients) are ~14 MB and ~22 MB, 0.004 and 0.007 ms.
// This first body takes mma.sync with the weights (~58 KB bf16, converted
// from the f32 parameters as each block loads them) in shared memory and
// no HBM round trip between layers; wgmma / TMA is a later redesign.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;    // a tile of the backward
constexpr int NMAT = 12;
constexpr int XS = 72;              // the staging rows' stride (64 + 8)
constexpr int NW_MAX = 32 * 64 + 64 * 16 + 19 * 64 + 64 * 64 + 64 * 3 +
                       2 * (16 * 64 + 64 * 64) + 64 * 3 + 64 * 42;

// the matrices: sigma w0, w1; rgb w0's direction rows (0-2) and its h
// rows (3-18); rgb w1, w2; norm w0-w2; sem w0-w2
enum { S0, S1, RD, RH, R1, R2, N0, N1, N2, E0, E1, E2 };

// in shared memory each matrix is W^T: fan_out rows (padded to 16) of
// fan_in values (padded to 16), 8 more for the banks
__host__ __device__ constexpr int wrows(int m) {
  return (m == S1 || m == R2 || m == N2) ? 16 : m == E2 ? 48 : 64;
}
__host__ __device__ constexpr int wstride(int m) {
  return m == S0 ? 40 : (m == RD || m == RH || m == N0 || m == E0) ? 24
                                                                    : 72;
}
__host__ __device__ constexpr int woff(int m) {
  int o = 0;
  for (int k = 0; k < m; ++k) o += wrows(k) * wstride(k);
  return o;
}
constexpr int WELEMS = woff(E2) + wrows(E2) * wstride(E2);
constexpr int FWD_SMEM = WELEMS * 2;
constexpr int BWD_SMEM = WELEMS * 2 + NW_MAX * 4 + 2 * ROWS * XS * 2;
static_assert(FWD_SMEM % 16 == 0 && (NW_MAX * 4) % 16 == 0, "alignment");
static_assert(BWD_SMEM <= 232448, "K6's backward shared memory");

struct Mat {
  const float* w;   // (fan_in, fan_out) f32, row-major
  int fan_in;
  int fan_out;
  int dw;           // its gradient's offset in dw and in a partial's row
};

// ops/mlp.py builds the same struct with ctypes
struct Args {
  Mat m[NMAT];
  const unsigned short* enc;   // (M, din) bf16
  const float* dirs;           // (M, 3)
  float* sigma;                // (M,)
  float* raws;                 // (M, C)
  const float* g_sigma;        // (M,)
  const float* g_raws;         // (M, C)
  unsigned short* d_enc;       // (M, din) bf16
  float* d_dirs;               // (M, 3), or null
  float* partial;              // (blocks, nw)
  float* dw;                   // (nw,)
  int M, din, C, n_cls, has_norm, use_dir, exposure, density, blocks, nw;
};
static_assert(sizeof(Mat) == 24, "ops/mlp.py's _Mat");
static_assert(sizeof(Args) == 12 * 24 + 10 * 8 + 10 * 4, "ops/mlp.py's _Args");

typedef uint32_t Frag[2];   // a packed n8 block: rows g and g + 8

// matrix M's W^T in the shared weights
template <int M>
__device__ __forceinline__ const unsigned short* wp(const unsigned short* W) {
  constexpr int off = woff(M);
  return W + off;
}

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// torch.relu and torch.clamp keep a NaN
__device__ __forceinline__ float relu(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float clampf(float x, float a, float b) {
  return x < a ? a : (x > b ? b : x);
}
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const unsigned short* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const unsigned short* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p))
      : "memory");
}
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
}

// c (+)= X W: X the packed activations (2 KB n8 blocks: KB k-blocks of
// 16), W^T at W (NB n8 blocks of fan_out, stride S). A fragment of
// k-block kk is {x[2kk][0], x[2kk][1], x[2kk+1][0], x[2kk+1][1]}: a
// product's fragment (rows g, g + 8; columns 2t, 2t + 1 of each n8 block)
// is the next one's A fragment.
template <int KB, int NB, int S>
__device__ __forceinline__ void fwd_layer(float (&c)[NB][4],
                                          const Frag (&x)[2 * KB],
                                          const unsigned short* W,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, W + (j * 8 + (lane & 7)) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma(c[j], x[2 * kk][0], x[2 * kk][1], x[2 * kk + 1][0],
          x[2 * kk + 1][1], b0, b1);
    }
}

// c (+)= dY W^T: dY packed (2 KB n8 blocks of fan_out), W^T at W (fan_out
// rows, stride S) read transposed; NB n8 blocks of fan_in
template <int KB, int NB, int S>
__device__ __forceinline__ void bwd_layer(float (&c)[NB][4],
                                          const Frag (&dy)[2 * KB],
                                          const unsigned short* W,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t b0, b1;
      ldsm_x2_t(b0, b1, W + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S
                            + j * 8);
      mma(c[j], dy[2 * kk][0], dy[2 * kk][1], dy[2 * kk + 1][0],
          dy[2 * kk + 1][1], b0, b1);
    }
}

// rounded to bf16 and packed, through ReLU when `act`
template <int NB>
__device__ __forceinline__ void pack(Frag (&p)[NB], const float (&c)[NB][4],
                                     bool act) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = act ? relu(c[j][k]) : c[j][k];
    p[j][0] = ncn_pack_bf16(v[0], v[1]);
    p[j][1] = ncn_pack_bf16(v[2], v[3]);
  }
}

// ReLU's backward in place: the activation out becomes the gradient
// bf16(da) where out is not <= 0, else 0 (threshold_backward)
template <int NB>
__device__ __forceinline__ void relu_bwd(Frag (&out)[NB],
                                         const float (&da)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t o = out[j][h];
      out[j][h] = ncn_pack_bf16(lo(o) <= 0.0f ? 0.0f : da[j][2 * h],
                                hi(o) <= 0.0f ? 0.0f : da[j][2 * h + 1]);
    }
}

// the encoding's 32 columns as 4 n8 blocks (zeros past din or M); din is
// even (ops/mlp.py checks), so a column pair is one aligned load
__device__ __forceinline__ void load_enc(Frag (&p)[4], const Args& a,
                                         const long long (&r)[2], int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * j + 2 * t;
      p[j][h] = (r[h] < a.M && c < a.din)
                    ? *reinterpret_cast<const uint32_t*>(a.enc + r[h] * a.din + c)
                    : 0u;
    }
}

// row r's unit direction (times 0 without use_dir) and its norm; 0 and 1
// past M
__device__ __forceinline__ void unit_dir(const Args& a, long long r,
                                         float (&dn)[3], float& n) {
  if (r >= a.M) {
    dn[0] = dn[1] = dn[2] = 0.0f;
    n = 1.0f;
    return;
  }
  const float x = a.dirs[3 * r], y = a.dirs[3 * r + 1], z = a.dirs[3 * r + 2];
  n = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z)));
  dn[0] = __fdiv_rn(x, n);
  dn[1] = __fdiv_rn(y, n);
  dn[2] = __fdiv_rn(z, n);
  if (!a.use_dir)
#pragma unroll
    for (int k = 0; k < 3; ++k) dn[k] = __fmul_rn(dn[k], 0.0f);
}

// the rgb net's first 16 inputs: the unit direction in columns 0-2
__device__ __forceinline__ void dir_block(Frag (&p)[2], const Args& a,
                                          const long long (&r)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float dn[3], n;
    unit_dir(a, r[h], dn, n);
    p[0][h] = t == 0 ? ncn_pack_bf16(dn[0], dn[1])
              : t == 1 ? ncn_pack_bf16(dn[2], 0.0f) : 0u;
    p[1][h] = 0u;
  }
}

// the sigma net: a1 (the hidden layer) and h
__device__ __forceinline__ void sigma_net(Frag (&a1)[8], Frag (&h)[2],
                                          const Frag (&e)[4],
                                          const unsigned short* W, int lane) {
  float c[8][4], c2[2][4];
  zero(c);
  fwd_layer<2, 8, wstride(S0)>(c, e, wp<S0>(W), lane);
  pack(a1, c, true);
  zero(c2);
  fwd_layer<4, 2, wstride(S1)>(c2, a1, wp<S1>(W), lane);
  pack(h, c2, false);
}

// a head's two hidden layers on h (its matrices M0, M0 + 1)
template <int M0>
__device__ __forceinline__ void head_hidden(Frag (&a1)[8], Frag (&a2)[8],
                                            const Frag (&h)[2],
                                            const unsigned short* W,
                                            int lane) {
  float c[8][4];
  zero(c);
  fwd_layer<1, 8, wstride(M0)>(c, h, wp<M0>(W), lane);
  pack(a1, c, true);
  zero(c);
  fwd_layer<4, 8, wstride(M0 + 1)>(c, a1, wp<M0 + 1>(W), lane);
  pack(a2, c, true);
}

// the rgb net's hidden layers on [d, h]
__device__ __forceinline__ void rgb_hidden(Frag (&a1)[8], Frag (&a2)[8],
                                           const Frag (&d)[2],
                                           const Frag (&h)[2],
                                           const unsigned short* W, int lane) {
  float c[8][4];
  zero(c);
  fwd_layer<1, 8, wstride(RD)>(c, d, wp<RD>(W), lane);
  fwd_layer<1, 8, wstride(RH)>(c, h, wp<RH>(W), lane);
  pack(a1, c, true);
  zero(c);
  fwd_layer<4, 8, wstride(R1)>(c, a1, wp<R1>(W), lane);
  pack(a2, c, true);
}

// f32 (fan_in, fan_out) weights -> W^T in bf16 at each matrix's place,
// zeros in the padding and for an absent head
__device__ void load_weights(unsigned short* W, const Args& a) {
  const int last = a.density ? S1 : E2;
  for (int m = 0; m <= last; ++m) {
    const Mat mt = a.m[m];
    const int S = wstride(m), n = wrows(m) * S;
    unsigned short* dst = W + woff(m);
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const int o = e / S, i = e - o * S;
      float v = 0.0f;
      if (mt.w && o < mt.fan_out && i < mt.fan_in)
        v = __ldg(mt.w + static_cast<long long>(i) * mt.fan_out + o);
      const __nv_bfloat16 b = __float2bfloat16_rn(v);
      dst[e] = *reinterpret_cast<const unsigned short*>(&b);
    }
  }
}

// a head's output (NB n8 blocks) at columns col0 .. col0 + width of raws
template <int NB>
__device__ __forceinline__ void write_out(const float (&c)[NB][4],
                                          const Args& a,
                                          const long long (&r)[2], int t,
                                          int col0, int width, bool sig) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = 8 * j + 2 * t + k;
        if (col < width && r[h] < a.M) {
          const float z = bf(c[j][2 * h + k]);
          a.raws[r[h] * a.C + col0 + col] = sig ? bf(sigmoid(z)) : z;
        }
      }
}

__global__ void __launch_bounds__(THREADS, 2) mlp_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned short W[];
  load_weights(W, a);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slabs = (a.M + 15) / 16;
  for (int s = blockIdx.x * WARPS + warp; s < slabs; s += gridDim.x * WARPS) {
    const long long r[2] = {16LL * s + g, 16LL * s + g + 8};
    Frag e[4], x[8], y[8], h[2];
    load_enc(e, a, r, t);
    sigma_net(x, h, e, W, lane);
    if (t == 0)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (r[k] < a.M) a.sigma[r[k]] = expf(lo(h[0][k]));
    if (a.density) continue;
    Frag d[2];
    dir_block(d, a, r, t);
    rgb_hidden(x, y, d, h, W, lane);
    float c1[1][4];
    zero(c1);
    fwd_layer<4, 1, 72>(c1, y, wp<R2>(W), lane);
    write_out(c1, a, r, t, 0, 3, !a.exposure);
    if (a.has_norm) {
      head_hidden<N0>(x, y, h, W, lane);
      zero(c1);
      fwd_layer<4, 1, 72>(c1, y, wp<N2>(W), lane);
      write_out(c1, a, r, t, 3, 3, false);
    }
    if (a.n_cls) {
      head_hidden<E0>(x, y, h, W, lane);
      float c6[6][4];
      zero(c6);
      fwd_layer<4, 6, 72>(c6, y, wp<E2>(W), lane);
      write_out(c6, a, r, t, 3 + 3 * a.has_norm, a.n_cls, false);
    }
  }
}

// ------------------------------------------------------------- backward
struct Stage {
  unsigned short* xs;   // (ROWS, XS) bf16: X of the tile's rows
  unsigned short* ys;   // (ROWS, XS) bf16: dY
  float* sums;          // the block's f32 weight-gradient sums
};

// matrix m's gradient over the tile: every warp stages its rows' X (NBX
// n8 blocks) and dY (NBY), then the fragments of dW = X^T dY (16 fan_in
// rows by 8 fan_out columns each, warp f % WARPS owns fragment f) are
// summed over the ROWS rows on the tensor cores and added to the block's
// sums
template <int NBX, int NBY>
__device__ void stage_dw(const Stage& st, const Frag (&x)[NBX],
                         const Frag (&dy)[NBY], const Mat& m, int warp,
                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();   // the last matrix's fragments are read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < NBX; ++j)
      *reinterpret_cast<uint32_t*>(st.xs + row * XS + 8 * j + 2 * t) = x[j][h];
#pragma unroll
    for (int j = 0; j < NBY; ++j)
      *reinterpret_cast<uint32_t*>(st.ys + row * XS + 8 * j + 2 * t) = dy[j][h];
  }
  __syncthreads();
  const int n_mi = (m.fan_in + 15) / 16, n_ni = (m.fan_out + 7) / 8;
  for (int f = warp; f < n_mi * n_ni; f += WARPS) {
    const int mi = f / n_ni, ni = f - mi * n_ni;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks) {
      uint32_t av[4], b0, b1;
      ldsm_x4_t(av, st.xs + (ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * XS
                        + mi * 16 + ((lane >> 3) & 1) * 8);
      ldsm_x2_t(b0, b1, st.ys + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                * XS + ni * 8);
      mma(c, av[0], av[1], av[2], av[3], b0, b1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = mi * 16 + g + 8 * (k >> 1), o = ni * 8 + 2 * t + (k & 1);
      if (i < m.fan_in && o < m.fan_out)
        st.sums[m.dw + i * m.fan_out + o] += c[k];
    }
  }
}

// dh = bf16(dh + bf16(c)) (the f32 sums c rounded as the product is)
__device__ __forceinline__ void add_dh(float (&dh)[2][4],
                                       const float (&c)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) dh[j][k] = bf(dh[j][k] + bf(c[j][k]));
}

// the output's gradient from raws' columns col0 .. col0 + width, rounded
// to bf16, as NB n8 blocks (zeros past width and M)
template <int NB>
__device__ __forceinline__ void out_grad(Frag (&p)[NB], float (&v)[NB][4],
                                         const Args& a,
                                         const long long (&r)[2], int t,
                                         int col0, int width) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = 8 * j + 2 * t + k;
        v[j][2 * h + k] = (col < width && r[h] < a.M)
                              ? bf(a.g_raws[r[h] * a.C + col0 + col])
                              : 0.0f;
      }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    p[j][0] = ncn_pack_bf16(v[j][0], v[j][1]);
    p[j][1] = ncn_pack_bf16(v[j][2], v[j][3]);
  }
}

// a head (NB n8 blocks out; matrices M0, M0 + 1, M0 + 2) taken back from
// its output's gradient: its weights' sums, and h's gradient added to dh
template <int NB, int M0>
__device__ void head_bwd(float (&dh)[2][4], const Frag (&h)[2],
                         const unsigned short* W, const Args& a,
                         const Stage& st, const long long (&r)[2], int col0,
                         int width, int warp, int lane) {
  constexpr int KB = (NB + 1) / 2;
  const int t = lane & 3;
  Frag a1[8], a2[8], gz[2 * KB];
  float v[2 * KB][4], c[8][4];
  head_hidden<M0>(a1, a2, h, W, lane);
  out_grad(gz, v, a, r, t, col0, width);
  stage_dw(st, a2, gz, a.m[M0 + 2], warp, lane);
  zero(c);
  bwd_layer<KB, 8, wstride(M0 + 2)>(c, gz, wp<M0 + 2>(W), lane);
  relu_bwd(a2, c);
  stage_dw(st, a1, a2, a.m[M0 + 1], warp, lane);
  zero(c);
  bwd_layer<4, 8, wstride(M0 + 1)>(c, a2, wp<M0 + 1>(W), lane);
  relu_bwd(a1, c);
  stage_dw(st, h, a1, a.m[M0], warp, lane);
  float c2[2][4];
  zero(c2);
  bwd_layer<4, 2, wstride(M0)>(c2, a1, wp<M0>(W), lane);
  add_dh(dh, c2);
}

__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned short W[];
  Stage st;
  st.sums = reinterpret_cast<float*>(W + WELEMS);
  st.xs = reinterpret_cast<unsigned short*>(st.sums + NW_MAX);
  st.ys = st.xs + ROWS * XS;
  load_weights(W, a);
  for (int e = threadIdx.x; e < a.nw; e += THREADS) st.sums[e] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (a.M + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = static_cast<long long>(tile) * ROWS + warp * 16;
    const long long r[2] = {base + g, base + g + 8};
    Frag e[4], x[8], y[8], h[2];
    load_enc(e, a, r, t);
    sigma_net(x, h, e, W, lane);
    float dh[2][4];
    zero(dh);
    // h's gradient in autograd's order: norm, sem, rgb, the sigma slice
    if (a.has_norm)
      head_bwd<1, N0>(dh, h, W, a, st, r, 3, 3, warp, lane);
    if (a.n_cls)
      head_bwd<6, E0>(dh, h, W, a, st, r, 3 + 3 * a.has_norm, a.n_cls,
                      warp, lane);
    // rgb
    Frag d[2];
    dir_block(d, a, r, t);
    rgb_hidden(x, y, d, h, W, lane);
    float c1[1][4];
    zero(c1);
    fwd_layer<4, 1, 72>(c1, y, wp<R2>(W), lane);
    Frag gz[2];
    float v[2][4];
    out_grad(gz, v, a, r, t, 0, 3);
    if (!a.exposure) {
      // trunc_sigmoid's backward: s = sigmoid(clamp(z, -10, 10)), then
      // (g s) (1 - s), each op rounded to bf16
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float z = bf(c1[0][k]);
        const float s = bf(sigmoid(clampf(z, -10.0f, 10.0f)));
        v[0][k] = bf(bf(v[0][k] * s) * bf(1.0f - s));
      }
      gz[0][0] = ncn_pack_bf16(v[0][0], v[0][1]);
      gz[0][1] = ncn_pack_bf16(v[0][2], v[0][3]);
    }
    stage_dw(st, y, gz, a.m[R2], warp, lane);
    float c[8][4];
    zero(c);
    bwd_layer<1, 8, 72>(c, gz, wp<R2>(W), lane);
    relu_bwd(y, c);
    stage_dw(st, x, y, a.m[R1], warp, lane);
    zero(c);
    bwd_layer<4, 8, 72>(c, y, wp<R1>(W), lane);
    relu_bwd(x, c);
    stage_dw(st, h, x, a.m[RH], warp, lane);
    stage_dw(st, d, x, a.m[RD], warp, lane);
    float c2[2][4];
    zero(c2);
    bwd_layer<4, 2, wstride(RH)>(c2, x, wp<RH>(W), lane);
    add_dh(dh, c2);
    float gd[1][4];
    zero(gd);
    if (a.d_dirs) bwd_layer<4, 1, wstride(RD)>(gd, x, wp<RD>(W), lane);
    // the sigma slice: bf16(g_sigma exp(clamp(h0, -15, 15))) at column 0
    // (added to every column, as torch adds the slice's zeros)
    float g0[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (t == 0 && r[k] < a.M)
        g0[k] = bf(a.g_sigma[r[k]] *
                   expf(clampf(lo(h[0][k]), -15.0f, 15.0f)));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dh[j][q] = bf(dh[j][q] + ((j == 0 && !(q & 1)) ? g0[q >> 1] : 0.0f));
    Frag gh[2];
    pack(gh, dh, false);
    // the sigma net: a1 again, then its two products back
    {
      float cs[8][4];
      zero(cs);
      fwd_layer<2, 8, wstride(S0)>(cs, e, wp<S0>(W), lane);
      pack(x, cs, true);
    }
    stage_dw(st, x, gh, a.m[S1], warp, lane);
    zero(c);
    bwd_layer<1, 8, wstride(S1)>(c, gh, wp<S1>(W), lane);
    relu_bwd(x, c);
    stage_dw(st, e, x, a.m[S0], warp, lane);
    float ce[4][4];
    zero(ce);
    bwd_layer<4, 4, wstride(S0)>(ce, x, wp<S0>(W), lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = 8 * j + 2 * t;
        if (r[k] < a.M && col < a.din)
          *reinterpret_cast<uint32_t*>(a.d_enc + r[k] * a.din + col) =
              ncn_pack_bf16(ce[j][2 * k], ce[j][2 * k + 1]);
      }
    if (a.d_dirs) {
      // through d / |d|: (gd - dn (gd . dn)) / |d|, gd the bf16 gradient
      // of the direction's columns (times 0 without use_dir); lane t = 1
      // holds column 2
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float g2 = __shfl_down_sync(FULL, bf(gd[0][2 * k]), 1);
        if (t == 0 && r[k] < a.M) {
          float gv[3] = {bf(gd[0][2 * k]), bf(gd[0][2 * k + 1]), g2};
          float dn[3], n;
          unit_dir(a, r[k], dn, n);
          if (!a.use_dir)
            for (int q = 0; q < 3; ++q) gv[q] = __fmul_rn(gv[q], 0.0f);
          const float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(gv[0], dn[0]), __fmul_rn(gv[1], dn[1])),
              __fmul_rn(gv[2], dn[2]));
          for (int q = 0; q < 3; ++q)
            a.d_dirs[3 * r[k] + q] =
                __fdiv_rn(__fsub_rn(gv[q], __fmul_rn(dn[q], dot)), n);
        }
      }
    }
  }
  __syncthreads();
  for (int e2 = threadIdx.x; e2 < a.nw; e2 += THREADS)
    a.partial[static_cast<long long>(blockIdx.x) * a.nw + e2] = st.sums[e2];
}

__global__ void mlp_dw_reduce_kernel(const Args a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.nw;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < a.blocks; ++b)
      s = __fadd_rn(s, a.partial[static_cast<long long>(b) * a.nw + i]);
    a.dw[i] = bf(s);
  }
}

bool args_ok(const Args* A) {
  return A && A->enc && A->M >= 0 && A->din > 0 && A->din <= 32 &&
         A->din % 2 == 0 && A->blocks > 0 && A->m[S0].w && A->m[S1].w;
}

bool full_ok(const Args* A) {
  return A->dirs && A->C <= 48 && A->n_cls <= 42 && A->m[RD].w &&
         A->m[RH].w && A->m[R1].w && A->m[R2].w &&
         (!A->has_norm || (A->m[N0].w && A->m[N1].w && A->m[N2].w)) &&
         (!A->n_cls || (A->m[E0].w && A->m[E1].w && A->m[E2].w));
}

// once a process: shared memory past 48 KB
template <typename K>
int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

bool fwd_smem_set = false, bwd_smem_set = false;

}  // namespace

// sigmas, and the raws unless in the density mode
extern "C" int mlp_fwd(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!args_ok(A) || !A->sigma || (!A->density && (!full_ok(A) || !A->raws)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = allow_smem(mlp_fwd_kernel, FWD_SMEM, fwd_smem_set))
    return e;
  mlp_fwd_kernel<<<A->blocks, THREADS, FWD_SMEM, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}

// the encoding's (and the directions') gradient and each block's partial
// weight gradients
extern "C" int mlp_bwd(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!args_ok(A) || A->density || !full_ok(A) || !A->g_sigma ||
      !A->g_raws || !A->d_enc || !A->partial || A->nw > NW_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = allow_smem(mlp_bwd_kernel, BWD_SMEM, bwd_smem_set))
    return e;
  mlp_bwd_kernel<<<A->blocks, THREADS, BWD_SMEM, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}

// the weight gradients from the partials
extern "C" int mlp_dw_reduce(const void* args, cudaStream_t stream) {
  const Args* A = static_cast<const Args*>(args);
  if (!A || !A->partial || !A->dw || A->nw <= 0 || A->blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  mlp_dw_reduce_kernel<<<(A->nw + 255) / 256, 256, 0, stream>>>(*A);
  return static_cast<int>(cudaGetLastError());
}
