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
// Bound on an H100 SXM at the flagship's block shapes (B, N, D, H, M),
// counting each input and output byte once and each product as three TF32
// products at 495 TFLOP/s (the kernels' float32-accurate 3xTF32 form), the
// B*H*N^2 exponentials at 16 a clock an SM (1.98 GHz):
//   (128, 197, 16, 2, 64), the encoder: forward 2*B*N*(4D^2 + 2DM) +
//     4*B*H*N^2*hd = 473 MFLOP (2.87 us as 3xTF32; 7.06 us on the FP32
//     cores), 9.94 M exponentials (2.38 us), 3.2 MB (0.97 us); backward the
//     forward + 4*B*N*(4D^2 + 2DM) + 8*B*H*N^2*hd = 1.42 GFLOP (8.6 us as
//     3xTF32): bound by operations. The second q k^T and exponential that
//     recompute p from lse and the [B, W] partials are this design's, not
//     the function's, and are not counted.
//   (128, 197, 4, 2, 16), the decoder: 89 MFLOP forward, 0.27 GFLOP backward;
//     bound by the exponentials (2.38 us).
//
// Design. One CTA a batch row (the TPU kernel's per-sample fori_loop is the
// grid), all weights and the sample's intermediates in dynamic shared memory
// (96 KB forward, 215 KB backward at the encoder). This resident design
// runs the (D, hd, M) of BLOCK_SHAPES where that fits in 227 KB (the
// backward, a warp a 16-row tile, to N 256); every other shape runs the
// streamed design in block_streamed.cu (ops/block_fused.py: block_plan).
// Measured on the card (PERF.md), the earlier
// one-row-a-thread kernels spent their time handing each thread whole weight
// and K/V rows from shared memory. Here:
// - Every product with a contraction of 8 or more runs on the tensor cores as
//   3xTF32 mma.sync m16n8k8 (tf32_mma.cuh: big and small TF32 parts, the
//   three products summed from zero, one rounding add a step), so a warp
//   reads each operand element once, not once a lane. A warp owns 16-row
//   tiles of the sample (13 at N 197, zero past N); its accumulator tiles
//   pass from one product to the next in registers (the C fragment read as
//   the next A fragment with the summed index permuted), LayerNorm and GELU
//   run on the fragments, each row's statistics summed over its quad of
//   lanes. Weights are staged padded to row strides of 4 mod 8 floats, so a
//   B fragment's reads hit 32 banks.
// - Attention (hd 8) keeps q, k, v in shared memory as fragments, k and v
//   pre-split into TF32 parts; a warp runs a (head, row tile) with an online
//   softmax in base 2 over 64-key blocks, the scores staying in registers
//   between q k^T and p v. At hd 2 (the decoder) an 8-deep step would waste
//   3/4 of its work: attention, forward and backward, runs on the FP32
//   cores, a group of 4 lanes holding 2 rows and splitting the other side's
//   rows between its lanes, merged by shuffles in a fixed order. The forward
//   runs two warps a row tile for attention, one for the row phases.
// - The backward recomputes the forward (o, the rows' log2-sum-exp2) from x
//   and the weights, then per row tile the MLP, LN2 and projection
//   backward, then attention in two passes: a (head, key tile) accumulates
//   dk, dv over the query tiles, a (head, query tile) dq over the key tiles
//   (at hd 2: a pair of key rows, then of query rows, on the FP32 cores), p
//   recomputed from the log2-sum-exp2 in each, then dx through LN1. Weight
//   gradients are products over rows (L'^T R, the LayerNorm affine applied
//   as L is loaded), each 16 x 8 tile split into kSlices ranges of rows over
//   the warps and the partials added in order; bias and LayerNorm gradients
//   are column sums in a fixed order. Buffers of finished phases are reused
//   (BwdLayout).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxThreads = 512;  // the backward: a warp a 16-row tile, 128 registers a thread
constexpr int kTile = 16;     // rows of a warp's tile: the m of mma.sync m16n8k8
constexpr int kKeyBlock = 8;  // 8-key tiles of an online-softmax step
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFrag = 128;    // floats of one fragment block: 32 lanes x 4
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
// row-major): the [B, W] partials and the summed gradients
__host__ __device__ constexpr int woff(int k, int D, int M) {
  int off = 0;
  for (int j = 0; j < k; ++j) off += wrows(j, D, M) * wcols(j, D, M);
  return off;
}

template <int D, int M>
__host__ __device__ constexpr int weight_floats() {
  return woff(kNumWeights, D, M);
}

__host__ __device__ constexpr int r8(int c) { return (c + 7) / 8 * 8; }

// a shared-memory row stride: c rounded up to 8 floats, plus 4. A stride of 4
// mod 8 floats puts a B fragment's reads of rows 2t and 2t + 1 at column g
// (offsets 2t * stride + g) in 32 distinct banks.
__host__ __device__ constexpr int wpad(int c) { return r8(c) + 4; }

// weight k in shared memory: [r8(rows)][wpad(cols)] (a vector: one row), zero
// past its rows and columns, so the products' zero-padded k-steps and tiles
// read zeros
__host__ __device__ constexpr int srows(int k, int D, int M) {
  return wrows(k, D, M) == 1 ? 1 : r8(wrows(k, D, M));
}

__host__ __device__ constexpr int soff(int k, int D, int M) {
  int off = 0;
  for (int j = 0; j < k; ++j) off += srows(j, D, M) * wpad(wcols(j, D, M));
  return off;
}

template <int D, int M>
__host__ __device__ constexpr int staged_floats() {
  return soff(kNumWeights, D, M);
}

// element e of weight K as staged: [srows][wpad(cols)], zero padded
template <int D, int M, int K>
__device__ __forceinline__ float staged_elem(const Weights& w, int e) {
  constexpr int ld = wpad(wcols(K, D, M));
  const int r = e / ld, c = e - r * ld;
  return r < wrows(K, D, M) && c < wcols(K, D, M) ? __ldg(w.ptr[K] + r * w.s0[K] + c * w.s1[K])
                                                  : 0.f;
}

// element e of the staged weights (WEIGHT_NAMES order, soff offsets)
template <int D, int M, int K = 0>
__device__ __forceinline__ float staged_value(const Weights& w, int e) {
  constexpr int lo = soff(K, D, M);
  if constexpr (K + 1 < kNumWeights) {
    constexpr int hi = soff(K + 1, D, M);
    if (e < hi) return staged_elem<D, M, K>(w, e - lo);
    return staged_value<D, M, K + 1>(w, e);
  } else {
    return staged_elem<D, M, K>(w, e - lo);
  }
}

// the 12 weights into shared memory, kStageBatch loads in flight a thread
// (the CTAs of a launch all read the same weights from L2 at once)
constexpr int kStageBatch = 8;

template <int D, int M>
__device__ void stage_weights(float* ws, const Weights& w) {
  constexpr int total = staged_floats<D, M>();
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < total ? staged_value<D, M>(w, e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (e0 + u * blockDim.x < total) ws[e0 + u * blockDim.x] = v[u];
  }
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * kInvSqrt2)) + x * kInvSqrt2Pi * expf(-0.5f * x * x);
}

// ---------------------------------------------------------------------------
// A warp's 16-row tile in the C fragment layout: c[n][e] is row g + 8 (e / 2),
// column 8 n + 2 t + (e & 1), for lane = 4 g + t. Every product below reads
// such a tile as its A operand with the summed index permuted
// (tf32_mma.cuh), so a tile passes from one product to the next in registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// rows i0.. of a row-major [N][C] array (C even, 8-byte aligned rows), zero
// past row N and column C
template <int C>
__device__ __forceinline__ void load_tile(const float* src, int ld, int i0, int N,
                                          float (&c)[r8(C) / 8][4]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < r8(C) / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + g + 8 * r, col = 8 * n + 2 * t;
      const float2 v = row < N && col < C ? *reinterpret_cast<const float2*>(src + (long long)row * ld + col)
                                          : make_float2(0.f, 0.f);
      c[n][2 * r] = v.x;
      c[n][2 * r + 1] = v.y;
    }
}

template <int C>
__device__ __forceinline__ void store_tile(float* dst, int ld, int i0, int N,
                                           const float (&c)[r8(C) / 8][4]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < r8(C) / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + g + 8 * r, col = 8 * n + 2 * t;
      if (row < N && col < C)
        *reinterpret_cast<float2*>(dst + (long long)row * ld + col) =
            make_float2(c[n][2 * r], c[n][2 * r + 1]);
    }
}

// c[n][e] = v[column]: a bias (zero past its columns) in every row
template <int NT>
__device__ __forceinline__ void fill_cols(float (&c)[NT][4], const float* v) {
  const int t = lane_t();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(v + 8 * n + 2 * t);
    c[n][0] = c[n][2] = b.x;
    c[n][1] = c[n][3] = b.y;
  }
}

// xhat = (x - mean) * rstd over each row's D columns (biased variance), 0 past
// them; the row's statistics are summed over its quad of lanes
template <int D>
__device__ __forceinline__ void ln_tile(const float (&x)[r8(D) / 8][4], float (&xh)[r8(D) / 8][4],
                                        float (&rstd)[2]) {
  constexpr int ND = r8(D) / 8;
  const int t = lane_t();
  float mu[2] = {0.f, 0.f}, var[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mu[e / 2] += x[n][e];  // zero past D
#pragma unroll
  for (int r = 0; r < 2; ++r) mu[r] = quad_sum(mu[r]) / D;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = 8 * n + 2 * t + (e & 1) < D ? x[n][e] - mu[e / 2] : 0.f;
      var[e / 2] = fmaf(d, d, var[e / 2]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) rstd[r] = rsqrtf(quad_sum(var[r]) / D + kLnEps);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xh[n][e] = 8 * n + 2 * t + (e & 1) < D ? (x[n][e] - mu[e / 2]) * rstd[e / 2] : 0.f;
}

// h = xhat * scale + bias, the LayerNorm parameters zero past D
template <int D>
__device__ __forceinline__ void affine_tile(const float (&xh)[r8(D) / 8][4], const float* s,
                                            const float* b, float (&h)[r8(D) / 8][4]) {
  const int t = lane_t();
#pragma unroll
  for (int n = 0; n < r8(D) / 8; ++n) {
    const float2 sv = *reinterpret_cast<const float2*>(s + 8 * n + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(b + 8 * n + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      h[n][2 * r] = fmaf(xh[n][2 * r], sv.x, bv.x);
      h[n][2 * r + 1] = fmaf(xh[n][2 * r + 1], sv.y, bv.y);
    }
  }
}

__device__ __forceinline__ Frag tile_frag(const float (&c)[4]) { return split_a(c[0], c[2], c[1], c[3]); }

// acc += a W: a [16][8 KT] a tile, W [8 KT][8 NT] in shared memory, row stride
// ld; column tiles from nt_end on are left alone
template <int KT, int NT>
__device__ __forceinline__ void tile_mm(float (&acc)[NT][4], const float (&a)[KT][4], const float* W,
                                        int ld, int nt_end = NT) {
  const float* w0 = W + 2 * lane_t() * ld + lane_g();
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const Frag f = tile_frag(a[kk]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nt_end) mma3(acc[n], f, w0[8 * kk * ld + 8 * n], w0[(8 * kk + 1) * ld + 8 * n]);
  }
}

// acc += a W^T: W [8 NT][8 KT] in shared memory, row stride ld
template <int KT, int NT>
__device__ __forceinline__ void tile_mm_t(float (&acc)[NT][4], const float (&a)[KT][4], const float* W,
                                          int ld) {
  const float* w0 = W + lane_g() * ld + 2 * lane_t();
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const Frag f = tile_frag(a[kk]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(w0 + 8 * n * ld + 8 * kk);
      mma3(acc[n], f, b.x, b.y);
    }
  }
}

// ---------------------------------------------------------------------------
// Attention operands as fragments in shared memory, one block of kFrag floats
// (a float4 a lane) for each 16 x 8 A tile or 8 x 8 B tile, zero past N and
// hd:
//   qa [H][T][KS]: q as A (rows: queries; summed index: hd);
//   kb [H][2T][KS]: k as the B of s = q k^T (b0, b1 = k[g][2t, 2t + 1]),
//     split into TF32 parts (big, big, small, small);
//   vv [H][2T][KS]: v as the B of o = p v (b0, b1 = v[2t, 2t + 1][g]), split.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void put_split(float* dst, float v) {
  const uint32_t big = tf32_rna(v);
  dst[0] = __uint_as_float(big);
  dst[2] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
}

// Where element (row g + 8 half of row tile `tile`, column hd of head h) of
// q, k, v or do goes in each fragment buffer (H heads, T row tiles):
// the A layout [H][T][KS] (unsplit), kb's B of s = q k^T [H][2T][KS] and vv's
// B of o = p v [H][2T][KS] (both split: big at [0], small at [2]), and the
// unsplit B of a product over rows [H][2T][KS] (blocks of 64 floats, a
// float2 a lane: b0, b1 = rows 2t, 2t + 1, column g).
template <int HD>
__device__ __forceinline__ float* a_slot(float* buf, int T, int h, int tile, int hd, int half) {
  const int hin = hd & 7;
  return buf + ((h * T + tile) * (r8(HD) / 8) + (hd >> 3)) * kFrag +
         (4 * lane_g() + (hin >> 1)) * 4 + half + 2 * (hin & 1);
}

template <int HD>
__device__ __forceinline__ float* kb_slot(float* buf, int T, int h, int tile, int hd, int half) {
  const int hin = hd & 7;
  return buf + ((h * 2 * T + 2 * tile + half) * (r8(HD) / 8) + (hd >> 3)) * kFrag +
         (4 * lane_g() + (hin >> 1)) * 4 + (hin & 1);
}

template <int HD>
__device__ __forceinline__ float* vv_slot(float* buf, int T, int h, int tile, int hd, int half) {
  const int g = lane_g();
  return buf + ((h * 2 * T + 2 * tile + half) * (r8(HD) / 8) + (hd >> 3)) * kFrag +
         (4 * (hd & 7) + (g >> 1)) * 4 + (g & 1);
}

template <int HD>
__device__ __forceinline__ float* v_slot(float* buf, int T, int h, int tile, int hd, int half) {
  const int g = lane_g();
  return buf + ((h * 2 * T + 2 * tile + half) * (r8(HD) / 8) + (hd >> 3)) * (kFrag / 2) +
         (4 * (hd & 7) + (g >> 1)) * 2 + (g & 1);
}

// f(which, h, hd, half, value) for each element of a C-layout tile holding
// column tiles n0.. of a C-column array whose columns are which = column / D,
// then head h and hd within it
template <int D, int HD, int C, int NT, typename F>
__device__ __forceinline__ void for_heads(const float (&c)[NT][4], int n0, F f) {
  const int t = lane_t();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * (n0 + n) + 2 * t + (e & 1);
      if (col < C) {
        const int which = col / D, within = col - which * D, h = within / HD;
        f(which, h, within - h * HD, e >> 1, c[n][e]);
      }
    }
}

// a warp's qkv tile (column tiles n0..) into the forward's fragments qa, kb, vv
template <int D, int HD, int NT>
__device__ __forceinline__ void scatter_qkv(const float (&qkv)[NT][4], int n0, int tile, int T,
                                            float* qa, float* kb, float* vv) {
  for_heads<D, HD, 3 * D>(qkv, n0, [&](int which, int h, int hd, int half, float v) {
    if (which == 0)
      *a_slot<HD>(qa, T, h, tile, hd, half) = v;
    else if (which == 1)
      put_split(kb_slot<HD>(kb, T, h, tile, hd, half), v);
    else
      put_split(vv_slot<HD>(vv, T, h, tile, hd, half), v);
  });
}

// 2^x (ex2.approx.ftz: relative error ~2^-22; 0 below 2^-126 and at -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma3_frag(float (&d)[4], const Frag& a, float4 b) {
  mma3_split(d, a, __float_as_uint(b.x), __float_as_uint(b.y), __float_as_uint(b.z),
             __float_as_uint(b.w));
}

// a += b: three TF32 products summed into a, which must hold zero (the sum
// from zero of mma3_split, without its rounding add)
__device__ __forceinline__ void mma3_frag_zero(float (&a)[4], const Frag& f, float4 b) {
  const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
  mma_tf32(a, f.small, bb0, bb1);
  mma_tf32(a, f.big, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(a, f.big, bb0, bb1);
}

// one (head, query tile) of the forward: acc = sum_j 2^(s_ij scale2 - m_i)
// v_j for the tile's rows g and g + 8, with s = q k^T and scale2 = hd^-0.5
// log2(e) (so 2^(s scale2) is the softmax's exp), m the rows' running max of
// s scale2 and l this thread's part of their sums, online over blocks of
// kKeyBlock 8-key tiles; keys past N are masked in the last block only
template <int KS>
__device__ __forceinline__ void attend(const float4* qa, const float4* kb, const float4* vv, int N,
                                       float scale2, float (&acc)[KS][4], float (&m)[2],
                                       float (&l)[2]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  Frag q[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float4 v = qa[kk * 32 + lane];
    q[kk] = split_a(v.x, v.y, v.z, v.w);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float mr[2] = {-INFINITY, -INFINITY};  // the running max of s itself
  l[0] = l[1] = 0.f;
  const int n_tiles = (N + 7) / 8;
  for (int j0 = 0; j0 < n_tiles; j0 += kKeyBlock) {
    float s[kKeyBlock][4];
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if (j0 + j < n_tiles) {
        if constexpr (KS == 1) {
          mma3_frag_zero(s[j], q[0], kb[(j0 + j) * 32 + lane]);
        } else {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) mma3_frag(s[j], q[kk], kb[((j0 + j) * KS + kk) * 32 + lane]);
        }
      }
    }
    if ((j0 + kKeyBlock) * 8 > N) {
#pragma unroll
      for (int j = 0; j < kKeyBlock; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((j0 + j) * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) bm[e / 2] = fmaxf(bm[e / 2], s[j][e]);
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(mr[r], quad_max(bm[r]));
      const float corr = exp2_approx((mr[r] - m_new) * scale2);  // 0 on the first block
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
      mr[r] = m_new;
      ms[r] = m_new * scale2;
    }
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j) {
      if (j0 + j < n_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], scale2, -ms[e / 2]));
          l[e / 2] += s[j][e];
        }
        // o += p v: key tile j is a k-step, column t <-> key 2t, t + 4 <-> 2t + 1
        const Frag a = tile_frag(s[j]);
#pragma unroll
        for (int n = 0; n < KS; ++n) mma3_frag(acc[n], a, vv[((j0 + j) * KS + n) * 32 + lane]);
      }
    }
  }
  m[0] = mr[0] * scale2;
  m[1] = mr[1] * scale2;
}

// ---------------------------------------------------------------------------
// hd < 8 (the decoder's hd 2): attention on the FP32 cores, where an 8-deep
// tensor-core step would waste 3/4 of its work. qs [H][NP][HD] holds q, kvs
// [H][NP][2 HD] each key's k then v. A group of kRowLanes lanes holds two
// query rows of one head and splits the keys between its lanes (key j to lane
// j % kRowLanes), so each K/V row read from shared memory serves both rows;
// the lanes' online-softmax states merge by shuffles in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kRowLanes = 4;
constexpr int kRowChunk = 4;  // keys a lane takes per online-softmax step

// a row's two HD-float halves (k then v, or q then do)
template <int HD>
__device__ __forceinline__ void ld_kv(const float* p, float (&k)[HD], float (&v)[HD]) {
  static_assert(HD == 2, "the FP32 attention path is built for hd 2");
  const float4 a = *reinterpret_cast<const float4*>(p);
  k[0] = a.x;
  k[1] = a.y;
  v[0] = a.z;
  v[1] = a.w;
}

// o (and with lse, the rows' log2-sum-exp2) for every (head, row pair), all
// threads of the CTA; s = q k^T * scale * log2(e)
template <int D, int HD>
__device__ void attend_rows(const float* qs, const float* kvs, int N, int NP, float scale2,
                            float* os, int ldo, float* lse) {
  constexpr int H = D / HD;
  // rows past N: o = 0 and lse = 0, so what reads them stays finite
  for (int e = threadIdx.x; e < (NP - N) * D; e += blockDim.x) {
    const int i = N + e / D, c = e % D;
    os[i * ldo + c] = 0.f;
    if (lse != nullptr && c % HD == 0) lse[(c / HD) * NP + i] = 0.f;
  }
  const int pairs = (N + 1) / 2, items = H * pairs * kRowLanes;
  for (int base = 0; base < items; base += blockDim.x) {
    const int item = base + threadIdx.x;  // whole warps run the loop: the shuffles need them
    const bool valid = item < items;
    const int c = item % kRowLanes, hp = valid ? item / kRowLanes : 0;
    const int h = hp / pairs, i0 = 2 * (hp - h * pairs);
    const int rows[2] = {i0, min(i0 + 1, N - 1)};
    const float* kv = kvs + h * NP * 2 * HD;
    float q[2][HD], acc[2][HD], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        q[r][d] = qs[(h * NP + rows[r]) * HD + d];
        acc[r][d] = 0.f;
      }
    for (int j0 = c; j0 < N; j0 += kRowLanes * kRowChunk) {
      float kr[kRowChunk][HD], vr[kRowChunk][HD], s[2][kRowChunk];
#pragma unroll
      for (int u = 0; u < kRowChunk; ++u) {
        const int j = j0 + kRowLanes * u;
        ld_kv<HD>(kv + min(j, N - 1) * 2 * HD, kr[u], vr[u]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[r][d], kr[u][d], dot);
          s[r][u] = j < N ? dot * scale2 : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float bm = s[r][0];
#pragma unroll
        for (int u = 1; u < kRowChunk; ++u) bm = fmaxf(bm, s[r][u]);
        const float m_new = fmaxf(m[r], bm);
        const float corr = exp2_approx(m[r] - m_new);  // 0 on the first step
        l[r] *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[r][d] *= corr;
        m[r] = m_new;
#pragma unroll
        for (int u = 0; u < kRowChunk; ++u) {
          const float p = exp2_approx(s[r][u] - m_new);
          l[r] += p;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[r][d] = fmaf(p, vr[u][d], acc[r][d]);
        }
      }
    }
    // merge the group's lanes: partners compute the same commutative sums
#pragma unroll
    for (int off = 1; off < kRowLanes; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mn = fmaxf(m[r], mo);
        const float a = mn == -INFINITY ? 0.f : exp2_approx(m[r] - mn);
        const float b = mn == -INFINITY ? 0.f : exp2_approx(mo - mn);
        l[r] = l[r] * a + lo * b;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][d], off);
          acc[r][d] = acc[r][d] * a + ao * b;
        }
        m[r] = mn;
      }
    if (valid && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && i0 + 1 >= N) break;
#pragma unroll
        for (int d = 0; d < HD; ++d) os[(i0 + r) * ldo + h * HD + d] = acc[r][d] / l[r];
        if (lse != nullptr) lse[h * NP + i0 + r] = m[r] + log2f(l[r]);
      }
    }
  }
}

// a warp's qkv tile into qs and kvs (the FP32 attention's layout)
template <int D, int HD, int NT>
__device__ __forceinline__ void scatter_rows(const float (&qkv)[NT][4], int n0, int i0, int NP,
                                             float* qs, float* kvs) {
  const int g = lane_g();
  for_heads<D, HD, 3 * D>(qkv, n0, [&](int which, int h, int hd, int half, float v) {
    const int row = i0 + g + 8 * half;
    if (which == 0)
      qs[(h * NP + row) * HD + hd] = v;
    else
      kvs[(h * NP + row) * 2 * HD + (which - 1) * HD + hd] = v;
  });
}

// The FP32 attention backward at hd < 8, all threads of the CTA: qd [H][NP]
// [2 HD] holds each row's q then do, kvs its k then v, lse the rows'
// log2-sum-exp2, delta their rowsum(do o); p = 2^(s scale2 - lse), ds = p
// (do . v - delta) scale. A group of kRowLanes lanes holds two rows of one
// head and splits the other side's rows between its lanes (row j to lane
// j % kRowLanes); the lanes' sums merge by shuffles in a fixed order. Keys
// (pass A: dk, dv) then queries (pass B: dq), into dqkv [NP][ldq] at the
// columns of q, k, v.
template <int HD>
__device__ __forceinline__ float dot_hd(const float (&a)[HD], const float (&b)[HD]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// sums over the group's lanes, partners adding the same values in the same order
template <int C>
__device__ __forceinline__ void group_sum(float (&v)[C]) {
#pragma unroll
  for (int off = 1; off < kRowLanes; off <<= 1)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float o = __shfl_xor_sync(0xffffffffu, v[c], off);
      v[c] = (threadIdx.x & off) ? o + v[c] : v[c] + o;
    }
}

template <int D, int HD>
__device__ void attend_rows_bwd(const float* qd, const float* kvs, const float* lse,
                                const float* delta, int N, int NP, float scale2, float scale,
                                float* dqkv, int ldq) {
  constexpr int H = D / HD;
  const int pairs = (N + 1) / 2, items = H * pairs * kRowLanes;
  for (int pass = 0; pass < 2; ++pass) {  // 0: own keys (dk, dv), 1: own queries (dq)
    for (int base = 0; base < items; base += blockDim.x) {
      const int item = base + threadIdx.x;  // whole warps: the shuffles need them
      const bool valid = item < items;
      const int c = item % kRowLanes, hp = valid ? item / kRowLanes : 0;
      const int h = hp / pairs, i0 = 2 * (hp - h * pairs);
      const int rows[2] = {i0, min(i0 + 1, N - 1)};
      const float* qdh = qd + h * NP * 2 * HD;
      const float* kvh = kvs + h * NP * 2 * HD;
      const float* lh = lse + h * NP;
      const float* dh = delta + h * NP;
      // own rows: (k, v) in pass 0, (q, do) in pass 1
      float a[2][HD], b[2][HD], acc[2][2 * HD];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ld_kv<HD>((pass == 0 ? kvh : qdh) + rows[r] * 2 * HD, a[r], b[r]);
#pragma unroll
        for (int d = 0; d < 2 * HD; ++d) acc[r][d] = 0.f;
      }
      const float l_own[2] = {lh[rows[0]], lh[rows[1]]}, d_own[2] = {dh[rows[0]], dh[rows[1]]};
      for (int j = c; j < N; j += kRowLanes) {
        float x[HD], y[HD];  // the other side's row: (q, do) or (k, v)
        ld_kv<HD>((pass == 0 ? qdh : kvh) + j * 2 * HD, x, y);
        const float lj = lh[j], dj = dh[j];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (pass == 0) {  // a = k, b = v of key r; x = q, y = do of query j
            const float p = exp2_approx(fmaf(dot_hd<HD>(x, a[r]), scale2, -lj));
            const float ds = p * (dot_hd<HD>(y, b[r]) - dj) * scale;
#pragma unroll
            for (int d = 0; d < HD; ++d) {
              acc[r][d] = fmaf(ds, x[d], acc[r][d]);           // dk
              acc[r][HD + d] = fmaf(p, y[d], acc[r][HD + d]);  // dv
            }
          } else {  // a = q, b = do of query r; x = k, y = v of key j
            const float p = exp2_approx(fmaf(dot_hd<HD>(a[r], x), scale2, -l_own[r]));
            const float ds = p * (dot_hd<HD>(b[r], y) - d_own[r]) * scale;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[r][d] = fmaf(ds, x[d], acc[r][d]);  // dq
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) group_sum<2 * HD>(acc[r]);
      if (valid && c == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r == 1 && i0 + 1 >= N) break;
          float* row = dqkv + (i0 + r) * ldq + h * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            if (pass == 0) {
              row[D + d] = acc[r][d];
              row[2 * D + d] = acc[r][HD + d];
            } else {
              row[d] = acc[r][d];
            }
          }
        }
      }
    }
  }
}

// qkv = LN1(x) Wqkv + bqkv on rows i0.. (xh, rstd: LN1's xhat and 1 / std)
template <int D, int M>
__device__ __forceinline__ void qkv_tile(const float* ws, const float* xb, int i0, int N,
                                         float (&qkv)[r8(3 * D) / 8][4], float (&xh)[r8(D) / 8][4],
                                         float (&rs)[2]) {
  constexpr int ND = r8(D) / 8;
  float xt[ND][4], h1[ND][4];
  load_tile<D>(xb, D, i0, N, xt);
  ln_tile<D>(xt, xh, rs);
  affine_tile<D>(xh, ws + soff(LN1_S, D, M), ws + soff(LN1_B, D, M), h1);
  fill_cols(qkv, ws + soff(QKV_B, D, M));
  tile_mm<ND, r8(3 * D) / 8>(qkv, h1, ws + soff(QKV_W, D, M), wpad(3 * D));
}

// attention of head h on row tile `tile`: o into os [16 T][ldo]; with lse,
// each row's log2-sum-exp2 of its scaled scores into lse [H][16 T]
template <int D, int HD>
__device__ __forceinline__ void attend_head(const float* qa, const float* kb, const float* vv,
                                            int T, int tile, int h, int N, float scale2, float* os,
                                            int ldo, float* lse) {
  constexpr int KS = r8(HD) / 8;
  const int g = lane_g(), t = lane_t(), i0 = tile * kTile;
  {
    float acc[KS][4], m[2], l[2];
    attend<KS>(reinterpret_cast<const float4*>(qa + (h * T + tile) * KS * kFrag),
               reinterpret_cast<const float4*>(kb + h * 2 * T * KS * kFrag),
               reinterpret_cast<const float4*>(vv + h * 2 * T * KS * kFrag), N, scale2, acc, m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = quad_sum(l[r]);
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int hd = 8 * n + 2 * t + u;
          if (hd < HD) os[(i0 + g + 8 * r) * ldo + h * HD + hd] = acc[n][2 * r + u] / lsum;
        }
      if (lse != nullptr && t == 0) lse[h * T * kTile + i0 + g + 8 * r] = m[r] + log2f(lsum);
    }
  }
}

// r = x + o Wp + bp on rows i0.. (o from os)
template <int D, int M>
__device__ __forceinline__ void proj_tile(const float* ws, const float* xb, const float* os, int i0,
                                          int N, int NP, float (&o)[r8(D) / 8][4],
                                          float (&r)[r8(D) / 8][4]) {
  constexpr int ND = r8(D) / 8;
  float xt[ND][4];
  load_tile<D>(os, wpad(D), i0, NP, o);
  fill_cols(r, ws + soff(PROJ_B, D, M));
  tile_mm<ND, ND>(r, o, ws + soff(PROJ_W, D, M), wpad(D));
  load_tile<D>(xb, D, i0, N, xt);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[n][e] += xt[n][e];
}

// The forward runs two warps a row tile (at most kFwdThreads a CTA, so 72
// registers a thread; the flagship's N 197 has 13 tiles, 26 warps): the
// attention's (head, row tile) jobs fill them; the row phases take one.
constexpr int kFwdThreads = 832;

// Shared memory of the forward, in floats: the staged weights, qa, kb, vv
// (hd < 8: qs, kvs) and the attention output [16 T][wpad(D)]
template <int D, int HD, int M>
__host__ __device__ constexpr int fwd_floats(int N) {
  const int T = (N + kTile - 1) / kTile;
  return staged_floats<D, M>() + 5 * (D / HD) * T * (r8(HD) / 8) * kFrag + T * kTile * wpad(D);
}

template <int D, int HD, int M>
__global__ void __launch_bounds__(kFwdThreads)
block_fwd_kernel(const float* __restrict__ x, Weights w, float* __restrict__ y, int N,
                 float scale) {
  constexpr int H = D / HD, KS = r8(HD) / 8, ND = r8(D) / 8, NM = r8(M) / 8;
  constexpr int NQ = r8(3 * D) / 8, NMH = NM / 2, LO = wpad(D);
  static_assert(NM % 2 == 0, "the MLP's hidden tiles split in two halves");
  extern __shared__ __align__(16) float smem[];
  const int T = (N + kTile - 1) / kTile, NP = T * kTile;
  float* ws = smem;
  float* qa = ws + staged_floats<D, M>();
  float* kb = qa + H * T * KS * kFrag;
  float* vv = kb + 2 * H * T * KS * kFrag;
  float* os = qa + 5 * H * T * KS * kFrag;  // [NP][LO]
  const float* xb = x + (long long)blockIdx.x * N * D;
  float* yb = y + (long long)blockIdx.x * N * D;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  float* qs = qa;  // hd < 8: the FP32 attention's q, k, v
  float* kvs = qs + H * NP * HD;
  stage_weights<D, M>(ws, w);
  __syncthreads();

  // LN1 and the QKV product, a warp a row tile, into the fragments
  for (int tile = warp; tile < T; tile += warps) {
    float qkv[NQ][4], xh[ND][4], rs[2];
    qkv_tile<D, M>(ws, xb, tile * kTile, N, qkv, xh, rs);
    if constexpr (HD % 8 == 0)
      scatter_qkv<D, HD>(qkv, 0, tile, T, qa, kb, vv);
    else
      scatter_rows<D, HD>(qkv, 0, tile * kTile, NP, qs, kvs);
  }
  __syncthreads();

  // attention: a warp a (head, row tile) on the tensor cores, or the FP32 path
  if constexpr (HD % 8 == 0) {
    for (int job = warp; job < H * T; job += warps)
      attend_head<D, HD>(qa, kb, vv, T, job % T, job / T, N, scale * kLog2e, os, LO, nullptr);
  } else {
    attend_rows<D, HD>(qs, kvs, N, NP, scale * kLog2e, os, LO, nullptr);
  }
  __syncthreads();

  // a warp a row tile: r = x + o Wp + bp and y = r + gelu(LN2(r) W1 + b1) W2
  // + b2, the hidden units in two halves (registers)
  for (int tile = warp; tile < T; tile += warps) {
    const int i0 = tile * kTile;
    float o[ND][4], r[ND][4], xh[ND][4], h2[ND][4], rs[2], out[ND][4];
    proj_tile<D, M>(ws, xb, os, i0, N, NP, o, r);
    ln_tile<D>(r, xh, rs);
    affine_tile<D>(xh, ws + soff(LN2_S, D, M), ws + soff(LN2_B, D, M), h2);
    fill_cols(out, ws + soff(FC2_B, D, M));
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float m1[NMH][4];
      fill_cols(m1, ws + soff(FC1_B, D, M) + 8 * NMH * half);
      tile_mm<ND, NMH>(m1, h2, ws + soff(FC1_W, D, M) + 8 * NMH * half, wpad(M));
#pragma unroll
      for (int n = 0; n < NMH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) m1[n][e] = gelu(m1[n][e]);
      tile_mm<NMH, ND>(out, m1, ws + soff(FC2_W, D, M) + 8 * NMH * half * wpad(D), wpad(D));
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] += r[n][e];
    store_tile<D>(yb, D, i0, N, out);
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// acc += rstd (dxh - mean(dxh) - xh mean(dxh xh)) over each row's D columns,
// dxh = d * scale: the LayerNorm backward added into acc
template <int D>
__device__ __forceinline__ void ln_bwd_tile(const float (&d)[r8(D) / 8][4], const float (&xh)[r8(D) / 8][4],
                                            const float (&rstd)[2], const float* scale,
                                            float (&acc)[r8(D) / 8][4]) {
  constexpr int ND = r8(D) / 8;
  const int t = lane_t();
  float dxh[ND][4], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float2 sv = *reinterpret_cast<const float2*>(scale + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dxh[n][e] = d[n][e] * ((e & 1) ? sv.y : sv.x);
      m1[e / 2] += dxh[n][e];
      m2[e / 2] = fmaf(dxh[n][e], xh[n][e], m2[e / 2]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m1[r] = quad_sum(m1[r]) / D;
    m2[r] = quad_sum(m2[r]) / D;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * n + 2 * t + (e & 1) < D)
        acc[n][e] += rstd[e / 2] * (dxh[n][e] - m1[e / 2] - xh[n][e] * m2[e / 2]);
}

// Weight gradients dW = L'^T R over the N rows: each 16 x 8 tile of an [A][C]
// gradient is kSlices jobs over consecutive ranges of 8-row steps, each
// writing its partial tile (the C fragment, a float4 a lane) to scratch;
// wgrad_combine adds the partials in slice order. L' = L * ls[a] + lb[a] (the
// LayerNorm affine, applied as the fragment is loaded) when ls is given; L
// and R are row-major with strides ldl, ldr. Each step is a 3xTF32 product,
// the even and the odd steps of a slice summed apart and then added: a fixed
// order, so repeats are bitwise equal.
constexpr int kSlices = 3;

template <int A, int C>
__device__ void wgrad_part(const float* Lm, int ldl, const float* ls, const float* lb,
                           const float* R, int ldr, int N, int a0, int c0, int slice,
                           float4* __restrict__ part) {
  const int g = lane_g(), t = lane_t();
  const int fa = a0 + g, fb = fa + 8, c = c0 + g;
  const bool va = fa < A, vb = fb < A, vc = c < C;
  const float sa = ls != nullptr && va ? ls[fa] : 1.f, ba = ls != nullptr && va ? lb[fa] : 0.f;
  const float sb = ls != nullptr && vb ? ls[fb] : 1.f, bb = ls != nullptr && vb ? lb[fb] : 0.f;
  const int steps = (N + 7) / 8, per = (steps + kSlices - 1) / kSlices;
  const int s0 = slice * per, s1 = min(steps, s0 + per);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int st = s0; st < s1; st += 2) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r0 = 8 * (st + k) + 2 * t, r1 = r0 + 1;
      const bool v0 = st + k < s1 && r0 < N, v1 = st + k < s1 && r1 < N;
      const Frag f = split_a(v0 && va ? fmaf(Lm[r0 * ldl + fa], sa, ba) : 0.f,
                             v0 && vb ? fmaf(Lm[r0 * ldl + fb], sb, bb) : 0.f,
                             v1 && va ? fmaf(Lm[r1 * ldl + fa], sa, ba) : 0.f,
                             v1 && vb ? fmaf(Lm[r1 * ldl + fb], sb, bb) : 0.f);
      mma3(acc[k], f, v0 && vc ? R[r0 * ldr + c] : 0.f, v1 && vc ? R[r1 * ldr + c] : 0.f);
    }
  }
  part[threadIdx.x & 31] = make_float4(acc[0][0] + acc[1][0], acc[0][1] + acc[1][1],
                                       acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
}

// the 16 x 8 tiles of an [A][C] weight gradient
template <int A, int C>
__host__ __device__ constexpr int wgrad_jobs() {
  return (A + 15) / 16 * ((C + 7) / 8);
}

// job j of an [A][C] gradient: tile j / kSlices, slice j % kSlices, into
// scratch block j
template <int A, int C>
__device__ __forceinline__ void wgrad_job(int j, const float* Lm, int ldl, const float* ls,
                                          const float* lb, const float* R, int ldr, int N,
                                          float* scratch) {
  constexpr int CT = (C + 7) / 8;
  const int tile = j / kSlices;
  wgrad_part<A, C>(Lm, ldl, ls, lb, R, ldr, N, 16 * (tile / CT), 8 * (tile % CT), j % kSlices,
                   reinterpret_cast<float4*>(scratch) + j * 32);
}

// tile `tile` of an [A][C] gradient: its slices' partials summed in order,
// into out [A][C] row-major
template <int A, int C>
__device__ __forceinline__ void wgrad_combine(int tile, const float* scratch, float* __restrict__ out) {
  constexpr int CT = (C + 7) / 8;
  const int g = lane_g(), t = lane_t(), a0 = 16 * (tile / CT), c0 = 8 * (tile % CT);
  const float4* part = reinterpret_cast<const float4*>(scratch) + tile * kSlices * 32;
  float4 v = part[threadIdx.x & 31];
#pragma unroll
  for (int k = 1; k < kSlices; ++k) {
    const float4 u = part[k * 32 + (threadIdx.x & 31)];
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const float acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int a = a0 + g + 8 * r, col = c0 + 2 * t + u;
      if (a < A && col < C) out[a * C + col] = acc[2 * r + u];
    }
}

// *out = sum over rows i < N of P[i][c] (times Q[i][c] when Q is given), a
// warp: lane l sums rows l, l + 32, ... in order, then the lanes' sums in a
// fixed butterfly
__device__ void col_sum_warp(const float* P, const float* Q, int ld, int N, int c,
                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < N; i += 32)
    s = Q != nullptr ? fmaf(P[i * ld + c], Q[i * ld + c], s) : s + P[i * ld + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) *out = s;
}

// delta[h][i] = sum over head h's columns of do * o, rows i0 + g, i0 + g + 8
template <int D, int HD>
__device__ __forceinline__ void delta_tile(const float (&dot)[r8(D) / 8][4],
                                           const float (&o)[r8(D) / 8][4], float* delta, int NP,
                                           int i0) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int h = 0; h < D / HD; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.f;
#pragma unroll
      for (int n = 0; n < r8(D) / 8; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * n + 2 * t + u;
          if (col >= h * HD && col < (h + 1) * HD) s = fmaf(dot[n][2 * r + u], o[n][2 * r + u], s);
        }
      s = quad_sum(s);
      if (t == 0) delta[h * NP + i0 + g + 8 * r] = s;
    }
}

// The attention backward over fragments of q, k, v, do (A layout: qa, ka, va,
// doa; unsplit row-product B: qv, kv, dov), p = 2^(s2 - lse) recomputed from
// the forward's log2-sum-exp2, ds = p (dp - delta) scale.
// Pass A, a (head, 16-key tile): dv = p^T do, dk = ds^T q over every query
// tile in order, into dqkv columns D + h hd.. and 2 D + h hd..
template <int D, int HD>
__device__ void attn_bwd_keys(const float* qa, const float* ka, const float* va, const float* qv,
                              const float* doa, const float* dov, const float* lse,
                              const float* delta, int T, int N, int h, int kt, float scale2,
                              float scale, float* dqkv, int ldq) {
  constexpr int KS = r8(HD) / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4* qa4 = reinterpret_cast<const float4*>(qa) + h * T * KS * 32;
  const float4* doa4 = reinterpret_cast<const float4*>(doa) + h * T * KS * 32;
  const float2* qv2 = reinterpret_cast<const float2*>(qv) + h * 2 * T * KS * 32;
  const float2* dov2 = reinterpret_cast<const float2*>(dov) + h * 2 * T * KS * 32;
  const float* lse_h = lse + h * T * kTile;
  const float* delta_h = delta + h * T * kTile;
  Frag fk[KS], fv[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float4 a = reinterpret_cast<const float4*>(ka)[((h * T + kt) * KS + kk) * 32 + lane];
    const float4 b = reinterpret_cast<const float4*>(va)[((h * T + kt) * KS + kk) * 32 + lane];
    fk[kk] = split_a(a.x, a.y, a.z, a.w);
    fv[kk] = split_a(b.x, b.y, b.z, b.w);
  }
  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[m][e] = dv[m][e] = 0.f;
  for (int qt = 0; qt < T; ++qt) {
    // s^T = k q^T and dp^T = v do^T: rows this tile's keys, columns queries
    // 16 qt + 8 n..; an A-layout block is the B of queries 0-7 as (x, z),
    // of 8-15 as (y, w)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 q4 = qa4[(qt * KS + kk) * 32 + lane], d4 = doa4[(qt * KS + kk) * 32 + lane];
      mma3(s[0], fk[kk], q4.x, q4.z);
      mma3(s[1], fk[kk], q4.y, q4.w);
      mma3(dp[0], fv[kk], d4.x, d4.z);
      mma3(dp[1], fv[kk], d4.y, d4.w);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int q = qt * kTile + 8 * n + 2 * t;
      const float2 lq = *reinterpret_cast<const float2*>(lse_h + q);
      const float2 dq = *reinterpret_cast<const float2*>(delta_h + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rows and keys past N give p = 0
        const int key = kt * kTile + g + 8 * (e >> 1);
        const bool in = key < N && q + (e & 1) < N;
        const float p = in ? exp2_approx(s[n][e] * scale2 - ((e & 1) ? lq.y : lq.x)) : 0.f;
        dp[n][e] = p * (dp[n][e] - ((e & 1) ? dq.y : dq.x)) * scale;
        s[n][e] = p;
      }
    }
    // dv += p^T do, dk += ds^T q: query half n is a k-step
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const Frag fp = tile_frag(s[n]), fs = tile_frag(dp[n]);
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        const float2 bd = dov2[((2 * qt + n) * KS + m) * 32 + lane];
        const float2 bq = qv2[((2 * qt + n) * KS + m) * 32 + lane];
        mma3(dv[m], fp, bd.x, bd.y);
        mma3(dk[m], fs, bq.x, bq.y);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int hd = 8 * m + 2 * t + u, key = kt * kTile + g + 8 * r;
        if (hd < HD) {
          dqkv[key * ldq + D + h * HD + hd] = dk[m][2 * r + u];
          dqkv[key * ldq + 2 * D + h * HD + hd] = dv[m][2 * r + u];
        }
      }
}

// Pass B, a (head, 16-query tile): dq = ds k over every key tile in order,
// into dqkv columns h hd..
template <int D, int HD>
__device__ void attn_bwd_queries(const float* qa, const float* ka, const float* va, const float* kv,
                                 const float* doa, const float* lse, const float* delta, int T,
                                 int N, int h, int qt, float scale2, float scale, float* dqkv,
                                 int ldq) {
  constexpr int KS = r8(HD) / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4* ka4 = reinterpret_cast<const float4*>(ka) + h * T * KS * 32;
  const float4* va4 = reinterpret_cast<const float4*>(va) + h * T * KS * 32;
  const float2* kv2 = reinterpret_cast<const float2*>(kv) + h * 2 * T * KS * 32;
  const int i0 = qt * kTile;
  const float l[2] = {lse[h * T * kTile + i0 + g], lse[h * T * kTile + i0 + g + 8]};
  const float dl[2] = {delta[h * T * kTile + i0 + g], delta[h * T * kTile + i0 + g + 8]};
  Frag fq[KS], fd[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float4 a = reinterpret_cast<const float4*>(qa)[((h * T + qt) * KS + kk) * 32 + lane];
    const float4 b = reinterpret_cast<const float4*>(doa)[((h * T + qt) * KS + kk) * 32 + lane];
    fq[kk] = split_a(a.x, a.y, a.z, a.w);
    fd[kk] = split_a(b.x, b.y, b.z, b.w);
  }
  float dq[KS][4];
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[m][e] = 0.f;
  for (int kt = 0; kt < T; ++kt) {
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 k4 = ka4[(kt * KS + kk) * 32 + lane], v4 = va4[(kt * KS + kk) * 32 + lane];
      mma3(s[0], fq[kk], k4.x, k4.z);
      mma3(s[1], fq[kk], k4.y, k4.w);
      mma3(dp[0], fd[kk], v4.x, v4.z);
      mma3(dp[1], fd[kk], v4.y, v4.w);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kTile + 8 * n + 2 * t + (e & 1);
        const bool in = key < N && i0 + g + 8 * (e >> 1) < N;
        const float p = in ? exp2_approx(s[n][e] * scale2 - l[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
      }
      // dq += ds k: key half n is a k-step
      const Frag fs = tile_frag(dp[n]);
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        const float2 b = kv2[((2 * kt + n) * KS + m) * 32 + lane];
        mma3(dq[m], fs, b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int hd = 8 * m + 2 * t + u;
        if (hd < HD) dqkv[(i0 + g + 8 * r) * ldq + h * HD + hd] = dq[m][2 * r + u];
      }
}

// the weight gradients' scratch: the most tiles of one phase, kSlices
// partial tiles each
template <int D, int M>
__host__ __device__ constexpr int wgrad_scratch() {
  constexpr int b = wgrad_jobs<M, D>() + wgrad_jobs<D, D>(), c = wgrad_jobs<D, M>();
  constexpr int q = wgrad_jobs<D, 3 * D>();
  return (b > c ? (b > q ? b : q) : (c > q ? c : q)) * kSlices * kFrag;
}

// Shared memory of the backward, in floats, for N rows (T row tiles, NP = 16
// T): the staged weights, lse and delta [H][NP], d(residual) dr [NP][wpad(D)],
// do as fragments (doa, dov), then a region that three phases reuse:
//   forward recompute: o [NP][wpad(D)], qa, kb, vv;
//   MLP backward: o, xhat2 and d(h2) [NP][wpad(D)], gelu(m1) then d(m1)
//     [NP][wpad(M)], dy [NP][wpad(D)];
//   attention backward: qa, ka, va, qv, kv, xhat1 and d(h1) [NP][wpad(D)], d(qkv) [NP][wpad(3D)];
// then the weight gradients' scratch.
template <int D, int HD, int M>
struct BwdLayout {
  int T, NP, U, lse, delta, dr, doa, dov, y, scratch, total;
  __host__ __device__ explicit BwdLayout(int N) {
    T = (N + kTile - 1) / kTile;
    NP = T * kTile;
    U = (D / HD) * T * (r8(HD) / 8) * kFrag;
    lse = staged_floats<D, M>();
    delta = lse + (D / HD) * NP;
    dr = delta + (D / HD) * NP;
    doa = dr + NP * wpad(D);
    dov = doa + U;
    y = dov + U;
    const int mlp = 3 * NP * wpad(D) + NP * wpad(M);
    const int fwd_mlp = NP * wpad(D) + (5 * U > mlp ? 5 * U : mlp);
    const int attn = 5 * U + 2 * NP * wpad(D) + NP * wpad(3 * D);
    scratch = y + (fwd_mlp > attn ? fwd_mlp : attn);
    total = scratch + wgrad_scratch<D, M>();
  }
};

// One CTA a batch row, a warp a 16-row tile (the launch gives T warps).
template <int D, int HD, int M>
__global__ void __launch_bounds__(kMaxThreads)
block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy, Weights w,
                 float* __restrict__ dx, float* __restrict__ part, int N, float scale) {
  constexpr int H = D / HD, ND = r8(D) / 8, NM = r8(M) / 8, NQ = r8(3 * D) / 8;
  constexpr int LDD = wpad(D), LM = wpad(M), LQ = wpad(3 * D);
  extern __shared__ __align__(16) float smem[];
  const BwdLayout<D, HD, M> L(N);
  const int T = L.T, NP = L.NP, U = L.U;
  float* ws = smem;
  float* lse = smem + L.lse;
  float* delta = smem + L.delta;
  float* drs = smem + L.dr;
  float* doa = smem + L.doa;
  float* dov = smem + L.dov;
  float* os = smem + L.y;  // forward recompute and MLP backward
  float* qa = os + NP * LDD;
  float* kb = qa + U;
  float* vv = kb + 2 * U;
  float* xh2 = os + NP * LDD;
  float* dh2 = xh2 + NP * LDD;
  float* gbuf = dh2 + NP * LDD;
  float* dys = gbuf + NP * LM;
  float* QA = smem + L.y;  // attention backward
  float* KA = QA + U;
  float* VA = KA + U;
  float* QV = VA + U;
  float* KV = QV + U;
  float* xh1 = KV + U;
  float* dh1 = xh1 + NP * LDD;
  float* dqkv = dh1 + NP * LDD;
  float* scratch = smem + L.scratch;
  const long long row0 = (long long)blockIdx.x * N;
  const float* xb = x + row0 * D;
  const float* dyb = dy + row0 * D;
  float* pb = part + (long long)blockIdx.x * weight_floats<D, M>();
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int tile = warp, i0 = tile * kTile;
  const bool owner = tile < T;  // the launch gives T warps: a warp owns one tile
  const float scale2 = scale * kLog2e;

  float* qs = qa;  // hd < 8: the FP32 attention's q, k, v
  float* kvs = qs + H * NP * HD;
  float* qd = doa;  // hd < 8: each row's q and do for the attention backward
  float* kvb = QA;  // and its k and v
  stage_weights<D, M>(ws, w);
  __syncthreads();

  // the forward, recomputed: qkv, o and lse
  if (owner) {
    float qkv[NQ][4], xh[ND][4], rs[2];
    qkv_tile<D, M>(ws, xb, i0, N, qkv, xh, rs);
    if constexpr (HD % 8 == 0)
      scatter_qkv<D, HD>(qkv, 0, tile, T, qa, kb, vv);
    else
      scatter_rows<D, HD>(qkv, 0, i0, NP, qs, kvs);
  }
  __syncthreads();
  if constexpr (HD % 8 == 0) {
    if (owner) {
#pragma unroll 1
      for (int h = 0; h < H; ++h) attend_head<D, HD>(qa, kb, vv, T, tile, h, N, scale2, os, LDD, lse);
    }
  } else {
    attend_rows<D, HD>(qs, kvs, N, NP, scale2, os, LDD, lse);
  }
  __syncthreads();

  // per row tile: the MLP forward and backward, LN2 backward, dr = dy + dLN2,
  // do = dr Wp^T as fragments and delta = rowsum(do o) per head. gelu(m1),
  // xhat2, d(h2) and dr go to shared memory for the weight gradients; d(m1)
  // waits in registers until gelu(m1) has been read.
  float dm1[NM][4];
  if (owner) {
    float o[ND][4], r[ND][4], xh[ND][4], h2[ND][4], rs[2];
    proj_tile<D, M>(ws, xb, os, i0, N, NP, o, r);
    ln_tile<D>(r, xh, rs);
    store_tile<D>(xh2, LDD, i0, NP, xh);
    affine_tile<D>(xh, ws + soff(LN2_S, D, M), ws + soff(LN2_B, D, M), h2);
    fill_cols(dm1, ws + soff(FC1_B, D, M));
    tile_mm<ND, NM>(dm1, h2, ws + soff(FC1_W, D, M), LM);  // m1
    float dyt[ND][4], dg[NM][4];
    {
      float gm[NM][4];
#pragma unroll
      for (int n = 0; n < NM; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gm[n][e] = gelu(dm1[n][e]);
          dg[n][e] = 0.f;
        }
      store_tile<M>(gbuf, LM, i0, NP, gm);
    }
    load_tile<D>(dyb, D, i0, N, dyt);
    store_tile<D>(dys, LDD, i0, NP, dyt);
    tile_mm_t<ND, NM>(dg, dyt, ws + soff(FC2_W, D, M), LDD);  // dy W2^T
#pragma unroll
    for (int n = 0; n < NM; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dm1[n][e] = dg[n][e] * gelu_grad(dm1[n][e]);
    float dh[ND][4], dot[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[n][e] = dot[n][e] = 0.f;
    tile_mm_t<NM, ND>(dh, dm1, ws + soff(FC1_W, D, M), LM);  // d(h2) = d(m1) W1^T
    store_tile<D>(dh2, LDD, i0, NP, dh);
    ln_bwd_tile<D>(dh, xh, rs, ws + soff(LN2_S, D, M), dyt);  // dyt: now dr
    store_tile<D>(drs, LDD, i0, NP, dyt);
    tile_mm_t<ND, ND>(dot, dyt, ws + soff(PROJ_W, D, M), LDD);  // do = dr Wp^T
    delta_tile<D, HD>(dot, o, delta, NP, i0);
    for_heads<D, HD, D>(dot, 0, [&](int, int h, int hd, int half, float v) {
      if constexpr (HD % 8 == 0) {
        *a_slot<HD>(doa, T, h, tile, hd, half) = v;
        *v_slot<HD>(dov, T, h, tile, hd, half) = v;
      } else {
        qd[(h * NP + i0 + lane_g() + 8 * half) * 2 * HD + HD + hd] = v;
      }
    });
  }
  __syncthreads();

  // fc2, proj and LN2 gradients: dW2 = gelu(m1)^T dy, dWp = o^T dr, the
  // column sums of dy, dr, d(h2) xhat2 and d(h2)
  constexpr int J2 = wgrad_jobs<M, D>(), JP = wgrad_jobs<D, D>();
  for (int j = warp; j < (J2 + JP) * kSlices + 4 * D; j += warps) {
    if (j < J2 * kSlices) {
      wgrad_job<M, D>(j, gbuf, LM, nullptr, nullptr, dys, LDD, N, scratch);
    } else if (j < (J2 + JP) * kSlices) {
      wgrad_job<D, D>(j - J2 * kSlices, os, LDD, nullptr, nullptr, drs, LDD, N,
                      scratch + J2 * kSlices * kFrag);
    } else {
      const int k = (j - (J2 + JP) * kSlices) / D, c = (j - (J2 + JP) * kSlices) % D;
      if (k == 0) col_sum_warp(dys, nullptr, LDD, N, c, pb + woff(FC2_B, D, M) + c);
      if (k == 1) col_sum_warp(drs, nullptr, LDD, N, c, pb + woff(PROJ_B, D, M) + c);
      if (k == 2) col_sum_warp(dh2, xh2, LDD, N, c, pb + woff(LN2_S, D, M) + c);
      if (k == 3) col_sum_warp(dh2, nullptr, LDD, N, c, pb + woff(LN2_B, D, M) + c);
    }
  }
  __syncthreads();
  for (int j = warp; j < J2 + JP; j += warps) {
    if (j < J2)
      wgrad_combine<M, D>(j, scratch, pb + woff(FC2_W, D, M));
    else
      wgrad_combine<D, D>(j - J2, scratch + J2 * kSlices * kFrag, pb + woff(PROJ_W, D, M));
  }
  if (owner) store_tile<M>(gbuf, LM, i0, NP, dm1);
  __syncthreads();

  // fc1 gradients: dW1 = LN2(r)^T d(m1), the column sums of d(m1)
  constexpr int J1 = wgrad_jobs<D, M>();
  for (int j = warp; j < J1 * kSlices + M; j += warps) {
    if (j < J1 * kSlices)
      wgrad_job<D, M>(j, xh2, LDD, ws + soff(LN2_S, D, M), ws + soff(LN2_B, D, M), gbuf, LM, N,
                      scratch);
    else
      col_sum_warp(gbuf, nullptr, LM, N, j - J1 * kSlices, pb + woff(FC1_B, D, M) + j - J1 * kSlices);
  }
  __syncthreads();
  for (int j = warp; j < J1; j += warps) wgrad_combine<D, M>(j, scratch, pb + woff(FC1_W, D, M));

  // q, k, v again, as the attention backward's fragments; xhat1
  if (owner) {
    float qkv[NQ][4], xh[ND][4], rs[2];
    qkv_tile<D, M>(ws, xb, i0, N, qkv, xh, rs);
    store_tile<D>(xh1, LDD, i0, NP, xh);
    for_heads<D, HD, 3 * D>(qkv, 0, [&](int which, int h, int hd, int half, float v) {
      if constexpr (HD % 8 == 0) {
        float* a = which == 0 ? QA : (which == 1 ? KA : VA);
        *a_slot<HD>(a, T, h, tile, hd, half) = v;
        if (which < 2) *v_slot<HD>(which == 0 ? QV : KV, T, h, tile, hd, half) = v;
      } else {
        const int row = h * NP + i0 + lane_g() + 8 * half;
        if (which == 0)
          qd[row * 2 * HD + hd] = v;
        else
          kvb[row * 2 * HD + (which - 1) * HD + hd] = v;
      }
    });
  }
  __syncthreads();

  // per row tile: dk, dv of its keys and dq of its queries (the warp's own
  // rows of d(qkv)), then d(h1) = d(qkv) Wqkv^T and dx = dr + dLN1
  if constexpr (HD % 8 != 0) {
    attend_rows_bwd<D, HD>(qd, kvb, lse, delta, N, NP, scale2, scale, dqkv, LQ);
    __syncthreads();
  }
  if (owner) {
    if constexpr (HD % 8 == 0) {
#pragma unroll 1
      for (int h = 0; h < H; ++h)
        attn_bwd_keys<D, HD>(QA, KA, VA, QV, doa, dov, lse, delta, T, N, h, tile, scale2, scale,
                             dqkv, LQ);
#pragma unroll 1
      for (int h = 0; h < H; ++h)
        attn_bwd_queries<D, HD>(QA, KA, VA, KV, doa, lse, delta, T, N, h, tile, scale2, scale,
                                dqkv, LQ);
      __syncwarp();
    }
    float dq_t[NQ][4], dh[ND][4], xh[ND][4], xt[ND][4], dxt[ND][4], rs[2];
    load_tile<3 * D>(dqkv, LQ, i0, NP, dq_t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[n][e] = 0.f;
    tile_mm_t<NQ, ND>(dh, dq_t, ws + soff(QKV_W, D, M), LQ);
    store_tile<D>(dh1, LDD, i0, NP, dh);
    load_tile<D>(xb, D, i0, N, xt);
    ln_tile<D>(xt, xh, rs);
    load_tile<D>(drs, LDD, i0, NP, dxt);
    ln_bwd_tile<D>(dh, xh, rs, ws + soff(LN1_S, D, M), dxt);
    store_tile<D>(dx + row0 * D, D, i0, N, dxt);
  }
  __syncthreads();

  // qkv and LN1 gradients: dWqkv = LN1(x)^T d(qkv), the column sums of
  // d(qkv), d(h1) xhat1 and d(h1)
  constexpr int JQ = wgrad_jobs<D, 3 * D>();
  for (int j = warp; j < JQ * kSlices + 5 * D; j += warps) {
    if (j < JQ * kSlices) {
      wgrad_job<D, 3 * D>(j, xh1, LDD, ws + soff(LN1_S, D, M), ws + soff(LN1_B, D, M), dqkv, LQ,
                          N, scratch);
    } else if (j < JQ * kSlices + 3 * D) {
      const int c = j - JQ * kSlices;
      col_sum_warp(dqkv, nullptr, LQ, N, c, pb + woff(QKV_B, D, M) + c);
    } else {
      const int c = (j - JQ * kSlices - 3 * D) % D;
      if (j - JQ * kSlices - 3 * D < D)
        col_sum_warp(dh1, xh1, LDD, N, c, pb + woff(LN1_S, D, M) + c);
      else
        col_sum_warp(dh1, nullptr, LDD, N, c, pb + woff(LN1_B, D, M) + c);
    }
  }
  __syncthreads();
  for (int j = warp; j < JQ; j += warps) wgrad_combine<D, 3 * D>(j, scratch, pb + woff(QKV_W, D, M));
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

template <int D, int HD, int M>
size_t fwd_smem(int N) {
  return sizeof(float) * fwd_floats<D, HD, M>(N);
}

template <int D, int HD, int M>
size_t bwd_smem(int N) {
  return sizeof(float) * BwdLayout<D, HD, M>(N).total;
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

// the forward's threads: two warps a 16-row tile, at most kFwdThreads
int fwd_threads(int N) {
  const int warps = 2 * ((N + kTile - 1) / kTile);
  return 32 * (warps < kFwdThreads / 32 ? warps : kFwdThreads / 32);
}

template <int D, int HD, int M>
int launch_fwd(const float* x, const Weights& w, float* y, int B, int N, float scale,
               cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = fwd_smem<D, HD, M>(N);
  const cudaError_t err = allow_smem(block_fwd_kernel<D, HD, M>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_fwd_kernel<D, HD, M><<<B, fwd_threads(N), smem, s>>>(x, w, y, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int HD, int M>
int launch_bwd(const float* x, const float* dy, const Weights& w, float* dx, float* part,
               float* dw, int B, int N, float scale, cudaStream_t s) {
  const int tiles = (N + kTile - 1) / kTile;
  if (tiles > kMaxThreads / 32) return kBadShape;  // a warp owns one row tile
  static size_t allowed = 48 * 1024;
  const size_t smem = bwd_smem<D, HD, M>(N);
  const cudaError_t err = allow_smem(block_bwd_kernel<D, HD, M>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_bwd_kernel<D, HD, M><<<B, 32 * tiles, smem, s>>>(x, dy, w, dx, part, N, scale);
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
