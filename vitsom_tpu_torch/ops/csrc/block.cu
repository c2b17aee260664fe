// Fused pre-norm transformer block, forward and backward, for NVIDIA Hopper
// (sm_90a), float32.
//
// block_fwd_kernel replaces the TPU kernel
// vitsom_tpu/ops/block_pallas.py:_fwd_kernel (launched by make_fused_block's
// _call_fwd). For one batch row it computes, with D = H * hd and M the MLP
// width, the whole block
//   h1 = LN1(x);  qkv = h1 Wqkv + bqkv;  o = per-head softmax(q k^T hd^-0.5) v
//   r = x + o Wp + bp;  y = r + gelu(LN2(r) W1 + b1) W2 + b2
// with LayerNorm eps 1e-6 (biased variance) and exact-erf GELU (erff; the TPU
// kernel carries a polynomial erf only because Mosaic has no erf lowering).
// block_bwd_kernel replaces _bwd_kernel: it recomputes that forward and forms
// dx and the 12 weight gradients of the closed form at block_pallas.py:249-283
// (MLP, LN2, projection, attention, QKV and LN1 backward). The TPU kernel sums
// the weight gradients across batch tiles by read-modify-write on its output
// refs, which is safe only on the TPU's sequential grid; here each CTA writes
// its own partial gradients to a [B, W] workspace and sum_partials_kernel adds
// them over B in a fixed order. No atomics anywhere: two runs give
// bitwise-equal outputs.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s)
// at the flagship's block shapes (B, N, D, H, M), counting each input and
// output byte once:
//   (128, 197, 16, 2, 64), the encoder: forward 2*B*N*(4D^2 + 2DM) +
//     4*B*H*N^2*hd = 473 MFLOP (7.06 us) against 3.2 MB (0.97 us); backward
//     the forward + 4*B*N*(4D^2 + 2DM) + 8*B*H*N^2*hd = 1.42 GFLOP (21.2 us):
//     bound by operations. The second q k^T that recomputes p from lse and
//     the [B, W] partials are this design's, not the function's, and are
//     not counted.
//   (128, 197, 4, 2, 16), the decoder: 89 MFLOP (1.33 us) forward, 0.27 GFLOP
//     (4.0 us) backward, also operations; at hd 2 the B*H*N^2 exponentials
//     (three per score in the backward) and the shared-memory loads outweigh
//     the FMAs.
//
// Design (a first version that is right and simple; wgmma tiles, several
// samples per CTA and a weight-streaming variant for wide blocks are later
// work):
// - The TPU kernel runs a batch tile per sequential grid step and loops over
//   its samples with a fori_loop. Here the loop is the grid: one CTA per
//   batch row, so B needs no tile that divides it. The CTA stages all weights
//   (3,280 floats at D 16, M 64) and the sample's qkv [N, 3D] and attention
//   output [N, D] in dynamic shared memory, raised above 48 KB with
//   cudaFuncSetAttribute; the backward adds five [N, D] buffers, an [N,
//   max(M, 3D)] one and the row statistics (190 KB at the flagship encoder).
//   Rows are padded to a multiple of 4 floats that is an odd multiple of 4,
//   so a warp's 16-byte row accesses (one row per thread) hit every bank
//   once. The wrapper refuses shapes that do not fit in 227 KB.
// - Row phases (LayerNorm, the projections, the MLP) give each thread one row;
//   the row, its LayerNorm output and the output accumulator live in
//   registers, weights are read from shared memory as float4 broadcasts, and
//   the MLP streams its hidden units four at a time, so the [M] hidden row is
//   never held whole.
// - Attention runs per (head, query row) with an online softmax over 8-key
//   chunks of the staged K and V, never an [N, N] tile. Its backward
//   recomputes p from the row log-sum-exp, as attention.cu does, with one item
//   per (head, key row) for dk, dv and one per (head, query row) for dq.
// - Weight gradients are column phases: a thread owns output elements and
//   sums their N per-row products in row order, reading both operands from
//   shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kKeyChunk = 8;
constexpr int kNumWeights = 12;
constexpr int kBadShape = -1;
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// the order of WEIGHT_NAMES in block_fused.py
enum WeightId {
  LN1_S, LN1_B, QKV_W, QKV_B, PROJ_W, PROJ_B, LN2_S, LN2_B, FC1_W, FC1_B, FC2_W, FC2_B
};

// Each weight as a [rows, cols] float view: element (r, c) at ptr + r * s0 +
// c * s1 (strides in floats; a vector has one row), so transposed views of
// nn.Linear weights are read as they are.
struct Weights {
  const float* ptr[kNumWeights];
  long long s0[kNumWeights];
  long long s1[kNumWeights];
};

__host__ __device__ constexpr int wrows(int k, int D, int M) {
  return (k == QKV_W || k == PROJ_W || k == FC1_W) ? D : (k == FC2_W ? M : 1);
}

__host__ __device__ constexpr int wcols(int k, int D, int M) {
  return (k == QKV_W || k == QKV_B) ? 3 * D : ((k == FC1_W || k == FC1_B) ? M : D);
}

// offset of weight k in the packed layout (WEIGHT_NAMES order, each [in, out]
// row-major): shared memory, the [B, W] partials and the summed gradients
__host__ __device__ constexpr int woff(int k, int D, int M) {
  return k == 0 ? 0 : woff(k - 1, D, M) + wrows(k - 1, D, M) * wcols(k - 1, D, M);
}

// a row stride: c rounded up to a multiple of 4 floats that is an odd multiple
// of 4, so rows 16-byte aligned and a quarter-warp's 16-byte accesses to
// consecutive rows fall in distinct banks
__host__ __device__ constexpr int pad(int c) { return (((c + 3) / 4) | 1) * 4; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

template <int C>
__device__ __forceinline__ void ld_row(const float* p, float (&r)[C]) {
  static_assert(C % 4 == 0, "rows are float4 multiples");
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 v = ld4(p + 4 * i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

template <int C>
__device__ __forceinline__ void st_row(float* p, const float (&r)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i)
    st4(p + 4 * i, make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]));
}

// one head's HD floats of a shared-memory row, as 16- or 8-byte loads
template <int HD>
__device__ __forceinline__ void ld_head(const float* s, float (&r)[HD]) {
  if constexpr (HD % 4 == 0) {
    ld_row<HD>(s, r);
  } else {
    static_assert(HD == 2, "head dims are multiples of 4, or 2");
    const float2 v = *reinterpret_cast<const float2*>(s);
    r[0] = v.x;
    r[1] = v.y;
  }
}

template <int C>
__device__ __forceinline__ float dot(const float (&a)[C], const float (&b)[C]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * kInvSqrt2)) + x * kInvSqrt2Pi * expf(-0.5f * x * x);
}

// xhat = (x - mean) * rstd, rstd = 1 / sqrt(biased variance + eps)
template <int D>
__device__ __forceinline__ void layer_norm(const float (&x)[D], float (&xhat)[D], float& rstd) {
  float mu = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) mu += x[d];
  mu /= D;
  float var = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) var = fmaf(x[d] - mu, x[d] - mu, var);
  rstd = rsqrtf(var / D + kLnEps);
#pragma unroll
  for (int d = 0; d < D; ++d) xhat[d] = (x[d] - mu) * rstd;
}

// the LayerNorm backward: dxhat = dout * scale,
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), added into acc
template <int D>
__device__ __forceinline__ void layer_norm_bwd(const float (&dout)[D], const float (&xhat)[D],
                                               float rstd, const float* scale, float (&acc)[D]) {
  float dxhat[D];
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dxhat[d] = dout[d] * scale[d];
    m1 += dxhat[d];
    m2 = fmaf(dxhat[d], xhat[d], m2);
  }
  m1 /= D;
  m2 /= D;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] += rstd * (dxhat[d] - m1 - xhat[d] * m2);
}

template <int D>
__device__ __forceinline__ void affine(const float (&xhat)[D], const float* g, const float* b,
                                       float (&h)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) h[d] = fmaf(xhat[d], g[d], b[d]);
}

// bias[c0..c0+3] + in W[:, c0..c0+3], W an [R, C] row-major matrix in shared memory
template <int R, int C>
__device__ __forceinline__ float4 vec_mat4(const float (&in)[R], const float* W, const float* bias,
                                           int c0) {
  float4 acc = ld4(bias + c0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 w = ld4(W + r * C + c0);
    acc.x = fmaf(in[r], w.x, acc.x);
    acc.y = fmaf(in[r], w.y, acc.y);
    acc.z = fmaf(in[r], w.z, acc.z);
    acc.w = fmaf(in[r], w.w, acc.w);
  }
  return acc;
}

// out[r] += in4 . W[r, c0..c0+3] for every row r: the columns c0..c0+3 of
// in W^T, W an [R, C] row-major matrix in shared memory
template <int R, int C>
__device__ __forceinline__ void mat_t4(float4 in4, const float* W, int c0, float (&out)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 w = ld4(W + r * C + c0);
    out[r] = fmaf(in4.x, w.x, fmaf(in4.y, w.y, fmaf(in4.z, w.z, fmaf(in4.w, w.w, out[r]))));
  }
}

template <int D, int M>
__device__ void stage_weights(float* ws, const Weights& w) {
#pragma unroll
  for (int k = 0; k < kNumWeights; ++k) {
    const int cols = wcols(k, D, M);
    const int n = wrows(k, D, M) * cols;
    float* dst = ws + woff(k, D, M);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / cols;
      dst[e] = w.ptr[k][r * w.s0[k] + (e - r * cols) * w.s1[k]];
    }
  }
}

// LN1 and the QKV product, a row per thread: qkv[i] = LN1(x_i) Wqkv + bqkv
template <int D, int M>
__device__ void qkv_rows(const float* ws, const float* __restrict__ xb, float* qkv, int N) {
  constexpr int LQ = pad(3 * D);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float xr[D], xhat[D], h[D], rstd;
    ld_row<D>(xb + (long long)i * D, xr);
    layer_norm<D>(xr, xhat, rstd);
    affine<D>(xhat, ws + woff(LN1_S, D, M), ws + woff(LN1_B, D, M), h);
#pragma unroll 1
    for (int c0 = 0; c0 < 3 * D; c0 += 4)
      st4(qkv + i * LQ + c0, vec_mat4<D, 3 * D>(h, ws + woff(QKV_W, D, M), ws + woff(QKV_B, D, M), c0));
  }
}

// one row after attention, shared by the forward and the backward's recompute:
// r = x_i + o_i Wp + bp, its LN2 statistics xhat and rstd, and h2 = LN2(r)
template <int D, int M>
__device__ __forceinline__ void proj_ln2_row(const float* ws, const float* xrow, const float* orow_s,
                                             float (&r)[D], float (&xhat)[D], float& rstd,
                                             float (&h2)[D]) {
  float xr[D], orow[D];
  ld_row<D>(xrow, xr);
  ld_row<D>(orow_s, orow);
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 4) {
    const float4 a = vec_mat4<D, D>(orow, ws + woff(PROJ_W, D, M), ws + woff(PROJ_B, D, M), c0);
    r[c0] = xr[c0] + a.x;
    r[c0 + 1] = xr[c0 + 1] + a.y;
    r[c0 + 2] = xr[c0 + 2] + a.z;
    r[c0 + 3] = xr[c0 + 3] + a.w;
  }
  layer_norm<D>(r, xhat, rstd);
  affine<D>(xhat, ws + woff(LN2_S, D, M), ws + woff(LN2_B, D, M), h2);
}

// o[i, head h] = softmax_j(q_i k_j * scale) v_j, an item per (h, i); lse[h][i]
// the row log-sum-exp when lse is given
template <int D, int HD>
__device__ void attention_fwd(const float* qkv, float* o, float* lse, int N, float scale) {
  constexpr int H = D / HD, LQ = pad(3 * D), LD = pad(D);
  for (int item = threadIdx.x; item < H * N; item += blockDim.x) {
    const int h = item / N;
    const int i = item - h * N;
    const float* kb = qkv + D + h * HD;
    const float* vb = qkv + 2 * D + h * HD;
    float q[HD], acc[HD];
    ld_head<HD>(qkv + i * LQ + h * HD, q);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < N; j0 += kKeyChunk) {
      float s[kKeyChunk];
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        float kr[HD];
        ld_head<HD>(kb + min(j0 + c, N - 1) * LQ, kr);
        s[c] = j0 + c < N ? dot<HD>(q, kr) * scale : -INFINITY;
      }
      float cm = s[0];
#pragma unroll
      for (int c = 1; c < kKeyChunk; ++c) cm = fmaxf(cm, s[c]);
      const float m_new = fmaxf(m, cm);
      const float corr = expf(m - m_new);  // 0 on the first chunk, 1 if the max held
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        float vr[HD];
        ld_head<HD>(vb + min(j0 + c, N - 1) * LQ, vr);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
      m = m_new;
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) o[i * LD + h * HD + d] = acc[d] / l;
    if (lse != nullptr) lse[h * N + i] = m + logf(l);
  }
}

// dq, dk, dv into dqkv [N][LB] (columns as in qkv) from p = exp(s - lse):
//   dv_j = sum_i p_ij do_i,  ds_ij = p_ij (do_i . v_j - delta_i) scale,
//   dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
// items [0, H N) own a key row (dk, dv), items [H N, 2 H N) a query row (dq)
template <int D, int HD, int LB>
__device__ void attention_bwd(const float* qkv, const float* dout, const float* lse,
                              const float* delta, float* dqkv, int N, float scale) {
  constexpr int H = D / HD, LQ = pad(3 * D), LD = pad(D);
  for (int item = threadIdx.x; item < 2 * H * N; item += blockDim.x) {
    const bool key_row = item < H * N;
    const int hr = key_row ? item : item - H * N;
    const int h = hr / N;
    const int r = hr - h * N;
    const float* lse_h = lse + h * N;
    const float* delta_h = delta + h * N;
    if (key_row) {
      float kr[HD], vr[HD], dk[HD], dv[HD];
      ld_head<HD>(qkv + r * LQ + D + h * HD, kr);
      ld_head<HD>(qkv + r * LQ + 2 * D + h * HD, vr);
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;
#pragma unroll 2
      for (int i = 0; i < N; ++i) {
        float qi[HD], doi[HD];
        ld_head<HD>(qkv + i * LQ + h * HD, qi);
        ld_head<HD>(dout + i * LD + h * HD, doi);
        const float p = expf(dot<HD>(qi, kr) * scale - lse_h[i]);
        const float ds = p * (dot<HD>(doi, vr) - delta_h[i]) * scale;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] = fmaf(p, doi[d], dv[d]);
          dk[d] = fmaf(ds, qi[d], dk[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dqkv[r * LB + D + h * HD + d] = dk[d];
        dqkv[r * LB + 2 * D + h * HD + d] = dv[d];
      }
    } else {
      float qi[HD], doi[HD], dq[HD];
      ld_head<HD>(qkv + r * LQ + h * HD, qi);
      ld_head<HD>(dout + r * LD + h * HD, doi);
      const float lse_i = lse_h[r], delta_i = delta_h[r];
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[d] = 0.f;
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        float kj[HD], vj[HD];
        ld_head<HD>(qkv + j * LQ + D + h * HD, kj);
        ld_head<HD>(qkv + j * LQ + 2 * D + h * HD, vj);
        const float p = expf(dot<HD>(qi, kj) * scale - lse_i);
        const float ds = p * (dot<HD>(doi, vj) - delta_i) * scale;
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) dqkv[r * LB + h * HD + d] = dq[d];
    }
  }
}

// out[a * C + c] = sum_i (L[i][a] sa[a] + sb[a]) R[i][c], rows summed in order;
// without sa the left operand is L itself
template <int A, int C>
__device__ void col_gemm(const float* L, int ldl, const float* R, int ldr, const float* sa,
                         const float* sb, int N, float* __restrict__ out) {
  for (int e = threadIdx.x; e < A * C; e += blockDim.x) {
    const int a = e / C;
    const int c = e - a * C;
    const float ga = sa != nullptr ? sa[a] : 1.f;
    const float ba = sa != nullptr ? sb[a] : 0.f;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < N; ++i) acc = fmaf(fmaf(L[i * ldl + a], ga, ba), R[i * ldr + c], acc);
    out[e] = acc;
  }
}

// out[c] = sum_i P[i][c] (Q[i][c] when Q is given), rows summed in order
template <int C>
__device__ void col_sum(const float* P, const float* Q, int ld, int N, float* __restrict__ out) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < N; ++i) acc = Q != nullptr ? fmaf(P[i * ld + c], Q[i * ld + c], acc)
                                                   : acc + P[i * ld + c];
    out[c] = acc;
  }
}

template <int D, int M>
__host__ __device__ constexpr int weight_floats() {
  return woff(kNumWeights, D, M);
}

template <int D, int HD, int M>
__global__ void __launch_bounds__(kMaxThreads)
block_fwd_kernel(const float* __restrict__ x, Weights w, float* __restrict__ y, int N,
                 float scale) {
  constexpr int LQ = pad(3 * D), LD = pad(D);
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* qkv = ws + weight_floats<D, M>();  // [N][LQ]
  float* o = qkv + N * LQ;                  // [N][LD]
  const long long row0 = (long long)blockIdx.x * N;
  const float* xb = x + row0 * D;

  stage_weights<D, M>(ws, w);
  __syncthreads();
  qkv_rows<D, M>(ws, xb, qkv, N);
  __syncthreads();
  attention_fwd<D, HD>(qkv, o, nullptr, N, scale);
  __syncthreads();

  const float* W1 = ws + woff(FC1_W, D, M);
  const float* W2 = ws + woff(FC2_W, D, M);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    // this loop stores nothing to shared memory, so without a barrier the
    // compiler hoists all D^2 projection weights out of it into registers
    // and spills them (1 KB a thread at D 16); a thread runs it once or twice
    asm volatile("" ::: "memory");
    float r[D], xhat[D], h2[D], out[D], rstd;
    proj_ln2_row<D, M>(ws, xb + (long long)i * D, o + i * LD, r, xhat, rstd, h2);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = r[d] + ws[woff(FC2_B, D, M) + d];
    // the MLP, four hidden units at a time
#pragma unroll 1
    for (int k0 = 0; k0 < M; k0 += 4) {
      const float4 m = vec_mat4<D, M>(h2, W1, ws + woff(FC1_B, D, M), k0);
      const float g[4] = {gelu(m.x), gelu(m.y), gelu(m.z), gelu(m.w)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w2[D];
        ld_row<D>(W2 + (k0 + u) * D, w2);
#pragma unroll
        for (int d = 0; d < D; ++d) out[d] = fmaf(g[u], w2[d], out[d]);
      }
    }
    st_row<D>(y + (row0 + i) * D, out);
  }
}

template <int D, int HD, int M>
__global__ void __launch_bounds__(kMaxThreads)
block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy, Weights w,
                 float* __restrict__ dx, float* __restrict__ part, int N, float scale) {
  constexpr int H = D / HD, LQ = pad(3 * D), LD = pad(D), LB = pad(M > 3 * D ? M : 3 * D);
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* qkv = ws + weight_floats<D, M>();  // [N][LQ]
  float* o = qkv + N * LQ;                  // [N][LD] attention output
  float* dr = o + N * LD;                   // [N][LD] dy, then d(residual r)
  float* dout = dr + N * LD;                // [N][LD] d(attention output)
  float* xh = dout + N * LD;                // [N][LD] xhat2, then xhat1
  float* dh = xh + N * LD;                  // [N][LD] d(h2), then d(h1)
  float* big = dh + N * LD;                 // [N][LB] gelu(m1), then d(m1), then d(qkv)
  float* rstd2 = big + N * LB;              // [N]
  float* lse = rstd2 + N;                   // [H][N]
  float* delta = lse + H * N;               // [H][N]
  const long long row0 = (long long)blockIdx.x * N;
  const float* xb = x + row0 * D;
  float* pb = part + (long long)blockIdx.x * weight_floats<D, M>();
  const float* W1 = ws + woff(FC1_W, D, M);
  const float* W2 = ws + woff(FC2_W, D, M);
  const float* Wp = ws + woff(PROJ_W, D, M);

  stage_weights<D, M>(ws, w);
  for (int e = threadIdx.x; e < N * D; e += blockDim.x) {
    const int i = e / D;
    dr[i * LD + e - i * D] = dy[row0 * D + e];
  }
  __syncthreads();

  // the forward, recomputed: qkv, o, lse, then per row xhat2, rstd2, gelu(m1)
  qkv_rows<D, M>(ws, xb, qkv, N);
  __syncthreads();
  attention_fwd<D, HD>(qkv, o, lse, N, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float r[D], xhat[D], h2[D], rs;
    proj_ln2_row<D, M>(ws, xb + (long long)i * D, o + i * LD, r, xhat, rs, h2);
    st_row<D>(xh + i * LD, xhat);
    rstd2[i] = rs;
#pragma unroll 1
    for (int k0 = 0; k0 < M; k0 += 4) {
      const float4 m = vec_mat4<D, M>(h2, W1, ws + woff(FC1_B, D, M), k0);
      st4(big + i * LB + k0, make_float4(gelu(m.x), gelu(m.y), gelu(m.z), gelu(m.w)));
    }
  }
  __syncthreads();

  // fc2: dW2 = gelu(m1)^T dy, dc2 = colsum dy
  col_gemm<M, D>(big, LB, dr, LD, nullptr, nullptr, N, pb + woff(FC2_W, D, M));
  col_sum<D>(dr, nullptr, LD, N, pb + woff(FC2_B, D, M));
  __syncthreads();

  // per row: d(m1) -> big, d(h2) -> dh, LN2 backward, dr = dy + dLN2, do = dr Wp^T,
  // delta = do . o per head
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float h2[D], dyr[D], dh2[D];
    {
      float xhat[D];
      ld_row<D>(xh + i * LD, xhat);
      affine<D>(xhat, ws + woff(LN2_S, D, M), ws + woff(LN2_B, D, M), h2);
    }
    ld_row<D>(dr + i * LD, dyr);
#pragma unroll
    for (int d = 0; d < D; ++d) dh2[d] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < M; k0 += 4) {
      const float4 m = vec_mat4<D, M>(h2, W1, ws + woff(FC1_B, D, M), k0);
      const float mk[4] = {m.x, m.y, m.z, m.w};
      float dm[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w2[D];
        ld_row<D>(W2 + (k0 + u) * D, w2);
        dm[u] = dot<D>(dyr, w2) * gelu_grad(mk[u]);
      }
      const float4 dm4 = make_float4(dm[0], dm[1], dm[2], dm[3]);
      st4(big + i * LB + k0, dm4);
      mat_t4<D, M>(dm4, W1, k0, dh2);
    }
    st_row<D>(dh + i * LD, dh2);
    float xhat[D], dor[D], orow[D];
    ld_row<D>(xh + i * LD, xhat);  // reloaded: not held in registers over the MLP loop
    layer_norm_bwd<D>(dh2, xhat, rstd2[i], ws + woff(LN2_S, D, M), dyr);
    st_row<D>(dr + i * LD, dyr);
#pragma unroll
    for (int d = 0; d < D; ++d) dor[d] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 4)
      mat_t4<D, D>(make_float4(dyr[c0], dyr[c0 + 1], dyr[c0 + 2], dyr[c0 + 3]), Wp, c0, dor);
    st_row<D>(dout + i * LD, dor);
    ld_row<D>(o + i * LD, orow);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = 0.f;
#pragma unroll
      for (int d = h * HD; d < (h + 1) * HD; ++d) s = fmaf(dor[d], orow[d], s);
      delta[h * N + i] = s;
    }
  }
  __syncthreads();

  // proj, fc1 and LN2 grads
  col_gemm<D, D>(o, LD, dr, LD, nullptr, nullptr, N, pb + woff(PROJ_W, D, M));
  col_sum<D>(dr, nullptr, LD, N, pb + woff(PROJ_B, D, M));
  col_gemm<D, M>(xh, LD, big, LB, ws + woff(LN2_S, D, M), ws + woff(LN2_B, D, M), N,
                 pb + woff(FC1_W, D, M));
  col_sum<M>(big, nullptr, LB, N, pb + woff(FC1_B, D, M));
  col_sum<D>(dh, xh, LD, N, pb + woff(LN2_S, D, M));
  col_sum<D>(dh, nullptr, LD, N, pb + woff(LN2_B, D, M));
  __syncthreads();

  attention_bwd<D, HD, LB>(qkv, dout, lse, delta, big, N, scale);
  __syncthreads();

  // per row: d(h1) = dqkv Wqkv^T, LN1 backward, dx = dr + dLN1
  const float* Wqkv = ws + woff(QKV_W, D, M);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float xr[D], xhat[D], dh1[D], dxr[D], rs;
#pragma unroll
    for (int d = 0; d < D; ++d) dh1[d] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < 3 * D; c0 += 4) mat_t4<D, 3 * D>(ld4(big + i * LB + c0), Wqkv, c0, dh1);
    ld_row<D>(xb + (long long)i * D, xr);
    layer_norm<D>(xr, xhat, rs);
    st_row<D>(xh + i * LD, xhat);
    st_row<D>(dh + i * LD, dh1);
    ld_row<D>(dr + i * LD, dxr);
    layer_norm_bwd<D>(dh1, xhat, rs, ws + woff(LN1_S, D, M), dxr);
    st_row<D>(dx + (row0 + i) * D, dxr);
  }
  __syncthreads();

  // qkv and LN1 grads
  col_gemm<D, 3 * D>(xh, LD, big, LB, ws + woff(LN1_S, D, M), ws + woff(LN1_B, D, M), N,
                     pb + woff(QKV_W, D, M));
  col_sum<3 * D>(big, nullptr, LB, N, pb + woff(QKV_B, D, M));
  col_sum<D>(dh, xh, LD, N, pb + woff(LN1_S, D, M));
  col_sum<D>(dh, nullptr, LD, N, pb + woff(LN1_B, D, M));
}

// out[w] = sum_b part[b][w], b in order
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int B,
                                    int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(long long)b * W + w];
  out[w] = s;
}

// threads per CTA: the fewest passes over the H*N attention items, at most
// kMaxThreads a pass, spread evenly and rounded up to warps
int threads_for(int items) {
  const int passes = (items + kMaxThreads - 1) / kMaxThreads;
  const int per_pass = (items + passes - 1) / passes;
  return (per_pass + 31) / 32 * 32;
}

template <int D, int M>
size_t fwd_smem(int N) {
  return sizeof(float) * (weight_floats<D, M>() + (size_t)N * (pad(3 * D) + pad(D)));
}

template <int D, int HD, int M>
size_t bwd_smem(int N) {
  constexpr int LB = pad(M > 3 * D ? M : 3 * D);
  return sizeof(float) * (weight_floats<D, M>() +
                          (size_t)N * (pad(3 * D) + 5 * pad(D) + LB + 1 + 2 * (D / HD)));
}

// raises a kernel's dynamic shared memory limit once it is needed above 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int D, int HD, int M>
int launch_fwd(const float* x, const Weights& w, float* y, int B, int N, float scale,
               cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = fwd_smem<D, M>(N);
  const cudaError_t err = allow_smem(block_fwd_kernel<D, HD, M>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_fwd_kernel<D, HD, M><<<B, threads_for((D / HD) * N), smem, s>>>(x, w, y, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int HD, int M>
int launch_bwd(const float* x, const float* dy, const Weights& w, float* dx, float* part,
               float* dw, int B, int N, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = bwd_smem<D, HD, M>(N);
  const cudaError_t err = allow_smem(block_bwd_kernel<D, HD, M>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_bwd_kernel<D, HD, M><<<B, threads_for((D / HD) * N), smem, s>>>(x, dy, w, dx, part, N,
                                                                        scale);
  cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);
  constexpr int W = weight_floats<D, M>();
  sum_partials_kernel<<<(W + 255) / 256, 256, 0, s>>>(part, dw, B, W);
  return static_cast<int>(cudaGetLastError());
}

Weights make_weights(const void* const* ptrs, const long long* strides) {
  Weights w;
  for (int k = 0; k < kNumWeights; ++k) {
    w.ptr[k] = static_cast<const float*>(ptrs[k]);
    w.s0[k] = strides[2 * k];
    w.s1[k] = strides[2 * k + 1];
  }
  return w;
}

}  // namespace

// The (D, hd, M) the kernels are built for: the flagship's encoder (16, 8, 64)
// and decoder (4, 2, 16) blocks and the JAX tests' (24, 8, 96) and (16, 8, 32).
#define BLOCK_SHAPES(X) X(16, 8, 64) X(16, 8, 32) X(24, 8, 96) X(4, 2, 16)

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), or -1 for a (D, hd, M) that is
// not built. x, dy, y, dx are contiguous [B, N, D], 16-byte aligned. The 12
// weights come as pointers `wptr` in WEIGHT_NAMES order, each with its two
// strides (rows, columns; in floats) in `wstride`. The backward writes each
// CTA's partial weight gradients to `part` [B, W] and their sum over B to `dw`
// [W], both packed in WEIGHT_NAMES order with each weight [in, out] row-major.
extern "C" int block_forward(const float* x, const void* const* wptr, const long long* wstride,
                             float* y, int B, int N, int D, int hd, int M, float scale,
                             void* stream) {
  const Weights w = make_weights(wptr, wstride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_FWD_CASE(D_, HD_, M_) \
  if (D == D_ && hd == HD_ && M == M_) return launch_fwd<D_, HD_, M_>(x, w, y, B, N, scale, s);
  BLOCK_SHAPES(BLOCK_FWD_CASE)
#undef BLOCK_FWD_CASE
  return kBadShape;
}

extern "C" int block_backward(const float* x, const float* dy, const void* const* wptr,
                              const long long* wstride, float* dx, float* part, float* dw, int B,
                              int N, int D, int hd, int M, float scale, void* stream) {
  const Weights w = make_weights(wptr, wstride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_BWD_CASE(D_, HD_, M_)                                                      \
  if (D == D_ && hd == HD_ && M == M_)                                                   \
    return launch_bwd<D_, HD_, M_>(x, dy, w, dx, part, dw, B, N, scale, s);
  BLOCK_SHAPES(BLOCK_BWD_CASE)
#undef BLOCK_BWD_CASE
  return kBadShape;
}
