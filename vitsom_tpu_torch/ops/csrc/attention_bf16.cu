// Fused multi-head attention, forward and backward, for NVIDIA Hopper
// (sm_90a), bf16 inputs and outputs with float32 accumulation.
//
// The bf16 branch of the TPU kernels vitsom_tpu/ops/attention_pallas.py:
// _attn_fwd_kernel and _attn_bwd_kernel (their float32 branch is
// attention.cu). Per (batch row b, head h), at the JAX kernels' rounding
// points:
//   forward   s = (q k^T) * scale in float32 (bf16 products are exact in
//             float32), m = max s, l = sum exp(s - m),
//             attn = bf16(exp(s - m) / l), o = bf16(attn v),
//             lse = m + log l (float32);
//   backward  p = exp(s - lse), dv = bf16(bf16(p)^T do), dp = do v^T,
//             delta = rowsum(do * o) over the stored o, ds =
//             bf16(p * (dp - delta) * scale), dq = bf16(ds k),
//             dk = bf16(ds^T q). o and do are bf16 (the forward kernel's
//             output), or both float32 (hybrid_attention's eager forward
//             and its cotangent), which the products take unrounded.
// An online softmax rescales o after the product with v, so it cannot
// round attn where JAX does: the forward kernels make three passes over the
// keys, the max, the sum, then attn v. There are no atomics and every sum
// has a fixed order, so two runs give bitwise-equal outputs.
//
// Two designs, chosen by head dim, as in attention.cu:
//
// 1. hd <= 16 (the flagship's 8 and 2): attn_fwd_row_bf16 and
//    attn_bwd_row_bf16 on the FP32 cores, one thread a row. A CTA takes a
//    chunk of at most kRowThreads rows of one (b, h) (attention_fused.py:
//    bf16_row_plan) and stages the other side's rows as float32 in shared
//    memory, where every thread of a warp reads the same row (a broadcast).
//    A float32 o or do is read a float at a time.
//    The backward is one launch of pass-A CTAs (key rows: dk, dv) and
//    pass-B CTAs (query rows: dq); both form p, delta and ds with the same
//    expressions in the same order, so they agree bit for bit. Rows are
//    copied 16, 8, 4 or 2 bytes at a time, the widest that every bf16
//    view's pointer and strides allow (attention_fused.py:row_copy_width).
//
// 2. hd >= 32 (the emb-192 configs' 64 and 32): attn_fwd_mma_bf16 and
//    attn_bwd_mma_bf16 with mma.sync m16n8k16 bf16 products and float32
//    accumulators. A score tile's accumulator fragment (rows g, g + 8,
//    columns 2t, 2t + 1 of lane 4g + t) is the A fragment of the next
//    product for two adjacent 8-column tiles, so bf16(attn), bf16(p) and
//    bf16(ds) are packed straight from registers: JAX's rounding points
//    come for free. Operands are staged as rows of hd + 8 bf16 (a stride
//    of 8 mod 16 spreads a warp's 32-bit pair reads and ldmatrix's rows
//    over 32 banks), each thread issuing 8 loads before it stores; a B
//    operand whose summed index is the rows' (v in the forward; do, q and
//    k in the backward) is read with ldmatrix's transposing load.
//    - Forward: C chunks of W warps per (b, h) (attention_fused.py:
//      mma_plan), warp w owning 16 query rows. A CTA stages all of its
//      (b, h)'s k and v, zero past N.
//    - Backward: the same plan over key tiles, warp w owning 16 keys. The
//      CTA stages its keys' k and v rows; query tiles of 16 rows (q and do)
//      are staged in turn; every warp forms p and ds of its keys, dk and dv
//      accumulate in registers, ds goes to a [16, keys] tile in shared
//      memory and the warps form dq of the tile over the CTA's keys, one
//      16-column tile each. With C > 1 the chunks write float32 dq
//      partials that dq_sum_bf16 adds in chunk order and rounds once. The
//      warp reads its k and v A fragments from the staged rows at each
//      query tile: held in registers through the loop they took 170 a
//      thread at hd 64, one CTA an SM, and the backward at (512, 257, 3,
//      64) took 2.83 ms against 1.66 (in turns, one call, NVIDIA H100 80GB
//      HBM3, 700.00 W; chip_smoke.py K1 times the kernels).
//      A float32 do is staged as three bf16 tiles, hi = bf16(do),
//      mid = bf16(do - hi), lo = bf16(do - hi - mid), whose sum is do
//      exactly (both residuals are exact in float32, and the second has at
//      most 8 significant bits, which lo holds), and dp and dv take a product
//      with each: the bf16 products are exact in float32, as JAX's float32
//      products with the unrounded do are.
//
// This is the first, simple design: no cp.async ring, no wgmma, no TMA. The
// times and bounds are in PERF.md (chip_smoke.py phase K1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBadHeadDim = -1;
constexpr int kBadCopyWidth = -2;
constexpr int kRowThreads = 128;  // rows (threads) of a row-kernel CTA at most
constexpr int kRowTile = 16;      // rows of a warp's tile: the mma's M
constexpr int kMaxWarps = 8;      // warp tiles of a tensor-core CTA
constexpr int kPad = 8;           // bf16 after each staged row

// A [B, N, *] view with unit column stride: row r of batch b starts at
// ptr + b * sb + r * sr (strides in elements).
template <typename T>
struct View {
  const T* ptr;
  long long sb;
  long long sr;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const View<T>& x, int b, int r, int col) {
  return x.ptr + (long long)b * x.sb + (long long)r * x.sr + col;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// float32 rounded to the nearest bf16 (ties to even), as float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// ---------------------------------------------------------------------------
// hd <= 16: one thread a row, on the FP32 cores
// ---------------------------------------------------------------------------

// VW consecutive bf16 (8, 4, 2 or 1: 16, 8, 4 or 2 bytes) -> floats
template <int VW>
__device__ __forceinline__ void ldg_bf16(const bf16* g, float* r) {
  if constexpr (VW == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(g));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[2 * i] = bf16_lo(w[i]);
      r[2 * i + 1] = bf16_hi(w[i]);
    }
  } else if constexpr (VW == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(g));
    r[0] = bf16_lo(x.x);
    r[1] = bf16_hi(x.x);
    r[2] = bf16_lo(x.y);
    r[3] = bf16_hi(x.y);
  } else if constexpr (VW == 2) {
    const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(g));
    r[0] = bf16_lo(x);
    r[1] = bf16_hi(x);
  } else {
    r[0] = __bfloat162float(g[0]);
  }
}

// VW consecutive elements as floats: bf16 in one copy, float32 a float at
// a time
template <int VW, typename T>
__device__ __forceinline__ void ldg_vec(const T* g, float* r) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < VW; ++i) r[i] = __ldg(g + i);
  } else {
    ldg_bf16<VW>(g, r);
  }
}

// one head's HD elements of row r of a view as floats
template <int HD, int VW, typename T>
__device__ __forceinline__ void ldg_row(const View<T>& x, int b, int r, int col0, float (&out)[HD]) {
  const T* g = row_ptr(x, b, r, col0);
#pragma unroll
  for (int i = 0; i < HD / VW; ++i) ldg_vec<VW>(g + VW * i, out + VW * i);
}

template <int HD>
__device__ __forceinline__ void lds_row(const float* s, float (&r)[HD]) {
#pragma unroll
  for (int i = 0; i < HD; ++i) r[i] = s[i];
}

template <int HD>
__device__ __forceinline__ float dot(const float (&a)[HD], const float (&b)[HD]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HD; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// rows [0, N) of one head's HD columns of two views -> dense float
// [N][HD] tiles in shared memory
template <int HD, int VW, typename TB>
__device__ __forceinline__ void stage2(float* sa, float* sb, const View<bf16>& a,
                                       const View<TB>& b, int bi, int col0, int N) {
  constexpr int kPerRow = HD / VW;
  for (int e = threadIdx.x; e < N * kPerRow; e += blockDim.x) {
    const int r = e / kPerRow, c = VW * (e % kPerRow);
    ldg_bf16<VW>(row_ptr(a, bi, r, col0 + c), sa + r * HD + c);
    ldg_vec<VW>(row_ptr(b, bi, r, col0 + c), sb + r * HD + c);
  }
}

template <int HD>
__device__ __forceinline__ void store_row(bf16* dst, const float (&x)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = __float2bfloat16_rn(x[d]);
}

// Forward. C chunks of `rows` query rows a (b, h), blockIdx.x = (b H + h) C
// + c, a thread a row. Three passes over the keys staged in shared memory:
// the max, the sum of exponentials, then bf16(p / l) v.
template <int HD, int VW>
__global__ void __launch_bounds__(kRowThreads)
attn_fwd_row_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                  float* __restrict__ lse, int N, int H, int chunks, int rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + N * HD;
  const int bh = blockIdx.x / chunks, c = blockIdx.x - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * HD;
  const int i = c * rows + threadIdx.x;
  const bool active = threadIdx.x < rows && i < N;
  float qi[HD];
  ldg_row<HD, VW>(q, b, min(i, N - 1), col0, qi);
  stage2<HD, VW>(ks, vs, k, v, b, col0, N);
  __syncthreads();
  if (!active) return;

  float m = -INFINITY;
  for (int j = 0; j < N; ++j) {
    float kj[HD];
    lds_row<HD>(ks + j * HD, kj);
    m = fmaxf(m, dot<HD>(qi, kj) * scale);
  }
  // a compensated sum: bf16 products are exact, so a plain running sum's
  // error, growing with N, would dominate lse's (N 197: 2.3x that of the
  // plain version's pairwise sum against float64)
  float l = 0.f, lc = 0.f;
  for (int j = 0; j < N; ++j) {
    float kj[HD];
    lds_row<HD>(ks + j * HD, kj);
    const float y = expf(dot<HD>(qi, kj) * scale - m) - lc;
    const float t = l + y;
    lc = (t - l) - y;
    l = t;
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int j = 0; j < N; ++j) {
    float kj[HD], vj[HD];
    lds_row<HD>(ks + j * HD, kj);
    lds_row<HD>(vs + j * HD, vj);
    const float a = round_bf16(expf(dot<HD>(qi, kj) * scale - m) / l);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(a, vj[d], acc[d]);
  }
  const long long D = (long long)H * HD;
  store_row<HD>(o + ((long long)b * N + i) * D + col0, acc);
  lse[(long long)bh * N + i] = m + logf(l);
}

// Backward, o and do of type TO, one launch of 2 B H C CTAs: the first B H
// C are pass-A CTAs (key rows of chunk c: dk, dv), the rest pass-B CTAs
// (query rows: dq). A pass-A CTA stages q, do, lse and every row's delta;
// a pass-B CTA stages k and v and forms its own rows' deltas with the same
// expression.
template <int HD, int VW, typename TO>
__global__ void __launch_bounds__(kRowThreads)
attn_bwd_row_bf16(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o,
                  const float* __restrict__ lse, View<TO> dout, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, int chunks,
                  int rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int per_pass = gridDim.x / 2;
  const bool pass_a = blockIdx.x < per_pass;
  const int idx = pass_a ? blockIdx.x : blockIdx.x - per_pass;
  const int bh = idx / chunks, c = idx - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * HD;
  const int r = c * rows + threadIdx.x;  // a key row in pass A, a query row in pass B
  const bool active = threadIdx.x < rows && r < N;
  const float* lse_bh = lse + (long long)bh * N;
  const long long D = (long long)H * HD;

  if (pass_a) {
    float* qs = smem;  // [N][HD]
    float* dos = smem + N * HD;
    float* lse_s = smem + 2 * N * HD;
    float* delta_s = lse_s + N;
    float kr[HD], vr[HD];
    ldg_row<HD, VW>(k, b, min(r, N - 1), col0, kr);
    ldg_row<HD, VW>(v, b, min(r, N - 1), col0, vr);
    stage2<HD, VW>(qs, dos, q, dout, b, col0, N);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float orow[HD], drow[HD];
      ldg_row<HD, VW>(o, b, i, col0, orow);
      ldg_row<HD, VW>(dout, b, i, col0, drow);
      lse_s[i] = lse_bh[i];
      delta_s[i] = dot<HD>(drow, orow);
    }
    __syncthreads();
    if (!active) return;
    float dkr[HD], dvr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) dkr[d] = dvr[d] = 0.f;
    for (int i = 0; i < N; ++i) {
      float qi[HD], doi[HD];
      lds_row<HD>(qs + i * HD, qi);
      lds_row<HD>(dos + i * HD, doi);
      const float p = expf(dot<HD>(qi, kr) * scale - lse_s[i]);
      const float pc = round_bf16(p);
      const float dp = dot<HD>(doi, vr);
      const float ds = round_bf16(p * (dp - delta_s[i]) * scale);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dvr[d] = fmaf(pc, doi[d], dvr[d]);
        dkr[d] = fmaf(ds, qi[d], dkr[d]);
      }
    }
    const long long out = ((long long)b * N + r) * D + col0;
    store_row<HD>(dk + out, dkr);
    store_row<HD>(dv + out, dvr);
  } else {
    float* ks = smem;  // [N][HD]
    float* vs = smem + N * HD;
    const int i = min(r, N - 1);
    float qi[HD], doi[HD], oi[HD];
    ldg_row<HD, VW>(q, b, i, col0, qi);
    ldg_row<HD, VW>(dout, b, i, col0, doi);
    ldg_row<HD, VW>(o, b, i, col0, oi);
    const float lse_i = lse_bh[i], delta_i = dot<HD>(doi, oi);
    stage2<HD, VW>(ks, vs, k, v, b, col0, N);
    __syncthreads();
    if (!active) return;
    float dqr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) dqr[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      float kj[HD], vj[HD];
      lds_row<HD>(ks + j * HD, kj);
      lds_row<HD>(vs + j * HD, vj);
      const float p = expf(dot<HD>(qi, kj) * scale - lse_i);
      const float dp = dot<HD>(doi, vj);
      const float ds = round_bf16(p * (dp - delta_i) * scale);
#pragma unroll
      for (int d = 0; d < HD; ++d) dqr[d] = fmaf(ds, kj[d], dqr[d]);
    }
    store_row<HD>(dq + ((long long)b * N + r) * D + col0, dqr);
  }
}

// ---------------------------------------------------------------------------
// hd >= 32: bf16 products on the tensor cores
// ---------------------------------------------------------------------------

// c += a b, a 16 x 16 (rows), b 16 x 8 (columns), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the A fragments of a 16-row tile of a bf16 view (rows r0.., clamped to
// N - 1) over HD columns, 16 at a k-step, straight from device memory
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&f)[HD / 16][4], const View<bf16>& x, int b,
                                       int r0, int col0, int N) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const bf16* ra = row_ptr(x, b, min(r0 + g, N - 1), col0 + 2 * t);
  const bf16* rb = row_ptr(x, b, min(r0 + g + 8, N - 1), col0 + 2 * t);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    f[kk][0] = ldg32(ra + 16 * kk);
    f[kk][1] = ldg32(rb + 16 * kk);
    f[kk][2] = ldg32(ra + 16 * kk + 8);
    f[kk][3] = ldg32(rb + 16 * kk + 8);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the B fragments of two adjacent 8-column tiles (columns n0.., n0 + 8..)
// of a 16-row product step from 16 staged rows (row i at rows + i * LD):
// ldmatrix's transposing load; r[0], r[1] for the first tile, r[2], r[3]
// for the second
template <int LD>
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* rows, int n0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = rows + (lane & 15) * LD + n0 + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// rows [r0, r0 + rows) of one head's HD columns of a bf16 view -> shared
// memory rows of HD + kPad elements, zero past row N; each thread issues
// kStageLoads 4-byte loads before it stores any of them
constexpr int kStageLoads = 8;

template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const View<bf16>& x, int b, int col0, int r0,
                                           int rows, int N) {
  constexpr int LD = HD + kPad, kPairs = HD / 2;
  const int total = rows * kPairs;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageLoads * blockDim.x) {
    uint32_t w[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / kPairs, c = 2 * (e - r * kPairs);
      w[u] = e < total && r0 + r < N ? ldg32(row_ptr(x, b, r0 + r, col0 + c)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / kPairs, c = 2 * (e - r * kPairs);
      if (e < total) *reinterpret_cast<uint32_t*>(dst + r * LD + c) = w[u];
    }
  }
}

// rows [r0, r0 + rows) of one head's HD columns of a float32 view -> three
// bf16 tiles of rows of HD + kPad elements, dst[0] = hi, dst[1] = mid,
// dst[2] = lo (hi + mid + lo = x), zero past row N; a float at a time
template <int HD>
__device__ __forceinline__ void stage_split(bf16* dst, const View<float>& x, int b, int col0,
                                            int r0, int rows, int N) {
  constexpr int LD = HD + kPad;
  for (int e = threadIdx.x; e < rows * HD; e += blockDim.x) {
    const int r = e / HD, c = e - r * HD;
    const float a = r0 + r < N ? __ldg(row_ptr(x, b, r0 + r, col0 + c)) : 0.f;
    const bf16 hi = __float2bfloat16_rn(a);
    const float rest = a - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16_rn(rest);
    dst[r * LD + c] = hi;
    dst[(kRowTile + r) * LD + c] = mid;
    dst[(2 * kRowTile + r) * LD + c] = __float2bfloat16_rn(rest - __bfloat162float(mid));
  }
}

// scores of 8 keys (a tile: staged rows n0..n0 + 7 of ks) for a warp's 16
// query rows: s[e] at row g + 8 (e / 2), key n0 + 2t + (e & 1)
template <int HD>
__device__ __forceinline__ void score_tile(float (&s)[4], const uint32_t (&qf)[HD / 16][4],
                                           const bf16* ks, int n0) {
  constexpr int LD = HD + kPad;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* kr = ks + (n0 + g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) mma_bf16(s, qf[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
}

// C query chunks of W warps per (b, h); warp w of chunk c owns query rows
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c. Shared memory: k and v
// as rows [NK][HD + kPad], NK = N rounded up to 16.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_fwd_mma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                  float* __restrict__ lse, int N, int H, int chunks, float scale) {
  constexpr int LD = HD + kPad;
  extern __shared__ __align__(16) bf16 smem_h[];
  const int NK = (N + 15) / 16 * 16;
  bf16* ks = smem_h;
  bf16* vs = ks + NK * LD;
  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / H, h = bh % H, col0 = h * HD;
  stage_rows<HD>(ks, k, b, col0, 0, NK, N);
  stage_rows<HD>(vs, v, b, col0, 0, NK, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = (c * (blockDim.x / 32) + warp) * kRowTile;
  uint32_t qf[HD / 16][4];
  load_a<HD>(qf, q, b, i0, col0, N);
  __syncthreads();
  if (i0 >= N) return;

  const int n_tiles = (N + 7) / 8;
  float m[2] = {-INFINITY, -INFINITY};
  for (int nt = 0; nt < n_tiles; ++nt) {
    float s[4];
    score_tile<HD>(s, qf, ks, 8 * nt);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * nt + 2 * t + (e & 1) < N) m[e / 2] = fmaxf(m[e / 2], s[e] * scale);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  float l[2] = {0.f, 0.f};
  for (int nt = 0; nt < n_tiles; ++nt) {
    float s[4];
    score_tile<HD>(s, qf, ks, 8 * nt);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * nt + 2 * t + (e & 1) < N) l[e / 2] += expf(s[e] * scale - m[e / 2]);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = 0; kt < NK / 16; ++kt) {
    // attn of keys 16 kt.. as the A fragment of attn v: columns 2t, 2t + 1
    // from the first 8-key tile, 2t + 8, 2t + 9 from the second
    float a[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = 16 * kt + 8 * half;
      score_tile<HD>(a[half], qf, ks, n0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[half][e] = n0 + 2 * t + (e & 1) < N ? expf(a[half][e] * scale - m[e / 2]) / l[e / 2]
                                              : 0.f;
    }
    const uint32_t af[4] = {pack_bf16(a[0][0], a[0][1]), pack_bf16(a[0][2], a[0][3]),
                            pack_bf16(a[1][0], a[1][1]), pack_bf16(a[1][2], a[1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t bv[4];
      ldsm_b<LD>(bv, vs + 16 * kt * LD, 8 * n);
      mma_bf16(acc[n], af, bv[0], bv[1]);
      mma_bf16(acc[n + 1], af, bv[2], bv[3]);
    }
  }
  const long long D = (long long)H * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i < N) {
      bf16* orow = o + ((long long)b * N + i) * D + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
    }
  }
}

// C key chunks of W warps per (b, h); warp w of chunk c owns keys
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c. With C > 1, dq goes
// to dq_part[c] ([C, B, N, D] float32) for dq_sum_bf16.
template <int HD, typename TO>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_bwd_mma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o,
                  const float* __restrict__ lse, View<TO> dout, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_part,
                  int N, int H, int chunks, float scale) {
  constexpr int LD = HD + kPad;       // staged rows: the chunk's keys, a q and a do tile
  constexpr int DL = (HD + 31) / 32;  // elements of a row a lane holds in the delta prologue
  constexpr int DP = std::is_same<TO, float>::value ? 3 : 1;  // bf16 parts of do
  extern __shared__ __align__(16) float smem_f[];
  const int warps = blockDim.x / 32;
  const int NQ = (N + kRowTile - 1) / kRowTile * kRowTile;
  const int KC = warps * kRowTile;  // keys of a CTA
  const int LDK = KC + kPad;        // the ds tile's row stride
  float* lse_s = smem_f;
  float* delta_s = lse_s + NQ;
  bf16* ks = reinterpret_cast<bf16*>(delta_s + NQ);  // [KC][LD]
  bf16* vsm = ks + KC * LD;                          // [KC][LD]
  bf16* qs = vsm + KC * LD;                          // [16][LD]
  bf16* dos = qs + kRowTile * LD;                    // [DP][16][LD]
  bf16* dsb = dos + DP * kRowTile * LD;              // [16][LDK]

  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / H, h = bh % H, col0 = h * HD;
  const int key0 = c * KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  stage_rows<HD>(ks, k, b, col0, key0, KC, N);
  stage_rows<HD>(vsm, v, b, col0, key0, KC, N);
  // padded query rows get lse = inf, hence p = 0
  for (int i = threadIdx.x; i < NQ; i += blockDim.x)
    lse_s[i] = i < N ? lse[(long long)bh * N + i] : INFINITY;
  // delta_i = rowsum(do_i * o_i), a warp per row in a fixed order
  for (int r = warp; r < NQ; r += warps) {
    float x = 0.f;
#pragma unroll
    for (int u = 0; u < DL; ++u) {
      const int d = lane + 32 * u;
      if (r < N && d < HD)
        x = fmaf(static_cast<float>(*row_ptr(dout, b, r, col0 + d)),
                 static_cast<float>(*row_ptr(o, b, r, col0 + d)), x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) delta_s[r] = x;
  }

  const int kw = key0 + warp * kRowTile;  // this warp's first key
  const bf16* kra = ks + (warp * kRowTile + g) * LD + 2 * t;
  const bf16* vra = vsm + (warp * kRowTile + g) * LD + 2 * t;
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const long long D = (long long)H * HD;
  const int B = gridDim.x / chunks / H;
  for (int i0 = 0; i0 < NQ; i0 += kRowTile) {
    __syncthreads();  // every warp is done with the last tile's q, do and ds
    stage_rows<HD>(qs, q, b, col0, i0, kRowTile, N);
    if constexpr (DP == 1) stage_rows<HD>(dos, dout, b, col0, i0, kRowTile, N);
    else stage_split<HD>(dos, dout, b, col0, i0, kRowTile, N);
    __syncthreads();
    // s^T = k q^T and dp^T = v do^T: rows are this warp's keys, columns the
    // tile's queries, two 8-query tiles
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const bf16* qr = qs + (8 * n + g) * LD + 2 * t;
      const bf16* dr = dos + (8 * n + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t kf[4] = {ld32(kra + 16 * kk), ld32(kra + 8 * LD + 16 * kk),
                                ld32(kra + 16 * kk + 8), ld32(kra + 8 * LD + 16 * kk + 8)};
        const uint32_t vf[4] = {ld32(vra + 16 * kk), ld32(vra + 8 * LD + 16 * kk),
                                ld32(vra + 16 * kk + 8), ld32(vra + 8 * LD + 16 * kk + 8)};
        mma_bf16(s[n], kf, ld32(qr + 16 * kk), ld32(qr + 16 * kk + 8));
#pragma unroll
        for (int part = 0; part < DP; ++part) {
          const bf16* dpr = dr + part * kRowTile * LD;
          mma_bf16(dp[n], vf, ld32(dpr + 16 * kk), ld32(dpr + 16 * kk + 8));
        }
      }
    }
    // p and ds; bf16(p) in s, bf16(ds) in dp, ds also to the shared tile
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);  // query within the tile
        const int key = g + 8 * (e / 2);         // key within the warp's tile
        const float p = kw + key < N ? expf(s[n][e] * scale - lse_s[i0 + qi]) : 0.f;
        const float ds = round_bf16(p * (dp[n][e] - delta_s[i0 + qi]) * scale);
        s[n][e] = p;
        dp[n][e] = ds;
        dsb[qi * LDK + warp * kRowTile + key] = __float2bfloat16_rn(ds);
      }
    // dv += bf16(p)^T do, dk += ds^T q over the tile's 16 queries
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    const uint32_t sf[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                            pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t bd[4], bq[4];
#pragma unroll
      for (int part = 0; part < DP; ++part) {
        ldsm_b<LD>(bd, dos + part * kRowTile * LD, 8 * n);
        mma_bf16(dva[n], pf, bd[0], bd[1]);
        mma_bf16(dva[n + 1], pf, bd[2], bd[3]);
      }
      ldsm_b<LD>(bq, qs, 8 * n);
      mma_bf16(dka[n], sf, bq[0], bq[1]);
      mma_bf16(dka[n + 1], sf, bq[2], bq[3]);
    }
    __syncthreads();
    // dq of the tile's rows over this CTA's keys: ds [16, KC] k [KC, HD];
    // warp w owns the 16-column tiles w, w + W, ...
    for (int n = 2 * warp; n < HD / 8; n += 2 * warps) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < KC; k0 += 16) {
        const uint32_t af[4] = {ld32(dsb + g * LDK + k0 + 2 * t),
                                ld32(dsb + (g + 8) * LDK + k0 + 2 * t),
                                ld32(dsb + g * LDK + k0 + 2 * t + 8),
                                ld32(dsb + (g + 8) * LDK + k0 + 2 * t + 8)};
        uint32_t bk[4];
        ldsm_b<LD>(bk, ks + k0 * LD, 8 * n);
        mma_bf16(acc[0], af, bk[0], bk[1]);
        mma_bf16(acc[1], af, bk[2], bk[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + g + 8 * r;
          if (i >= N) continue;
          const long long off = ((long long)b * N + i) * D + col0 + 8 * (n + j) + 2 * t;
          if (chunks == 1)
            *reinterpret_cast<uint32_t*>(dq + off) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
          else
            *reinterpret_cast<float2*>(dq_part + (long long)c * B * N * D + off) =
                make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kw + g + 8 * r;
    if (j >= N) continue;
    const long long off = ((long long)b * N + j) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// dq = bf16(sum over c of dq_part[c]), in chunk order; n elements a chunk
__global__ void dq_sum_bf16(const float* __restrict__ part, bf16* __restrict__ dq, long long n,
                            int chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float a = part[e];
    for (int c = 1; c < chunks; ++c) a += part[c * n + e];
    dq[e] = __float2bfloat16_rn(a);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the row kernels' chunks of a (b, h): at most kRowThreads rows a CTA,
// spread evenly, the CTA rounded up to warps (attention_fused.py:
// bf16_row_plan)
void row_plan(int N, int* chunks, int* rows, int* threads) {
  *chunks = (N + kRowThreads - 1) / kRowThreads;
  *rows = (N + *chunks - 1) / *chunks;
  *threads = (*rows + 31) / 32 * 32;
}

size_t row_smem(int N, int HD, bool backward) {
  return sizeof(float) * (2 * (size_t)N * HD + (backward ? 2 * (size_t)N : 0));
}

// chunks C and warps W of a (b, h) (attention_fused.py:mma_plan)
void mma_plan(int N, int* chunks, int* warps) {
  const int tiles = (N + kRowTile - 1) / kRowTile;
  *chunks = (tiles + kMaxWarps - 1) / kMaxWarps;
  *warps = (tiles + *chunks - 1) / *chunks;
}

size_t fwd_mma_smem(int N, int HD) {
  const size_t nk = (N + 15) / 16 * 16;
  return sizeof(bf16) * 2 * nk * (HD + kPad);
}

// do_parts: 1 for a bf16 do, 3 for a float32 do (its bf16 parts)
size_t bwd_mma_smem(int N, int HD, int warps, int do_parts) {
  const size_t nq = (N + kRowTile - 1) / kRowTile * kRowTile, kc = warps * kRowTile;
  return sizeof(float) * 2 * nq + sizeof(bf16) * ((2 * kc + (1 + do_parts) * kRowTile) *
                                                      (HD + kPad) + kRowTile * (kc + kPad));
}

// whether a bf16 view's pointer and strides take VW-element copies
bool takes_width(const View<bf16>& x, int vw) {
  return reinterpret_cast<uintptr_t>(x.ptr) % (sizeof(bf16) * vw) == 0 && x.sb % vw == 0 &&
         x.sr % vw == 0;
}

template <typename TO>
bool any_takes_width(const View<TO>& x, int vw) {
  if constexpr (std::is_same<TO, float>::value) return true;  // read a float at a time
  else return takes_width(x, vw);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int HD, int VW>
int fwd_rows(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
             float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  if (!takes_width(q, VW) || !takes_width(k, VW) || !takes_width(v, VW)) return kBadCopyWidth;
  int chunks, rows, threads;
  row_plan(N, &chunks, &rows, &threads);
  const size_t smem = row_smem(N, HD, false);
  cudaError_t err = allow_smem(attn_fwd_row_bf16<HD, VW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_row_bf16<HD, VW><<<B * H * chunks, threads, smem, s>>>(q, k, v, o, lse, N, H, chunks,
                                                                  rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int VW, typename TO>
int bwd_rows(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
             View<TO> dout, bf16* dq, bf16* dk, bf16* dv, int B, int N, int H, float scale,
             cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  if (!takes_width(q, VW) || !takes_width(k, VW) || !takes_width(v, VW) ||
      !any_takes_width(dout, VW) || !any_takes_width(o, VW))
    return kBadCopyWidth;
  int chunks, rows, threads;
  row_plan(N, &chunks, &rows, &threads);
  const size_t smem = row_smem(N, HD, true);
  cudaError_t err = allow_smem(attn_bwd_row_bf16<HD, VW, TO>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_row_bf16<HD, VW, TO><<<2 * B * H * chunks, threads, smem, s>>>(
      q, k, v, o, lse, dout, dq, dk, dv, N, H, chunks, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// the row copy width in bytes (16, 8, 4, 2) -> bf16 elements a copy, 0 if
// it does not divide HD
template <int HD>
constexpr int elems(int width) {
  return (width == 16 || width == 8 || width == 4 || width == 2) && HD % (width / 2) == 0
             ? width / 2
             : 0;
}

template <int HD>
int launch_fwd(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
               float scale, int width, cudaStream_t s) {
  if constexpr (HD >= 32) {
    static size_t allowed = 48 * 1024;
    int chunks, warps;
    mma_plan(N, &chunks, &warps);
    const size_t smem = fwd_mma_smem(N, HD);
    cudaError_t err = allow_smem(attn_fwd_mma_bf16<HD>, smem, &allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_fwd_mma_bf16<HD><<<B * H * chunks, 32 * warps, smem, s>>>(q, k, v, o, lse, N, H, chunks,
                                                                   scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    switch (elems<HD>(width)) {
      case 8:
        if constexpr (HD % 8 == 0) return fwd_rows<HD, 8>(q, k, v, o, lse, B, N, H, scale, s);
        return kBadCopyWidth;
      case 4:
        if constexpr (HD % 4 == 0) return fwd_rows<HD, 4>(q, k, v, o, lse, B, N, H, scale, s);
        return kBadCopyWidth;
      case 2:
        return fwd_rows<HD, 2>(q, k, v, o, lse, B, N, H, scale, s);
      case 1:
        return fwd_rows<HD, 1>(q, k, v, o, lse, B, N, H, scale, s);
      default:
        return kBadCopyWidth;
    }
  }
}

template <int HD, typename TO>
int launch_bwd(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
               View<TO> dout, bf16* dq, bf16* dk, bf16* dv, float* dq_part, int B, int N, int H,
               float scale, int width, cudaStream_t s) {
  if constexpr (HD >= 32) {
    static size_t allowed = 48 * 1024;
    int chunks, warps;
    mma_plan(N, &chunks, &warps);
    const size_t smem = bwd_mma_smem(N, HD, warps, std::is_same<TO, float>::value ? 3 : 1);
    cudaError_t err = allow_smem(attn_bwd_mma_bf16<HD, TO>, smem, &allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_mma_bf16<HD, TO><<<B * H * chunks, 32 * warps, smem, s>>>(
        q, k, v, o, lse, dout, dq, dk, dv, dq_part, N, H, chunks, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
    const long long n = (long long)B * N * H * HD;
    const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
    dq_sum_bf16<<<blocks, 256, 0, s>>>(dq_part, dq, n, chunks);
    return static_cast<int>(cudaGetLastError());
  } else {
    switch (elems<HD>(width)) {
      case 8:
        if constexpr (HD % 8 == 0)
          return bwd_rows<HD, 8, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, scale, s);
        return kBadCopyWidth;
      case 4:
        if constexpr (HD % 4 == 0)
          return bwd_rows<HD, 4, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, scale, s);
        return kBadCopyWidth;
      case 2:
        return bwd_rows<HD, 2, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, scale, s);
      case 1:
        return bwd_rows<HD, 1, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, scale, s);
      default:
        return kBadCopyWidth;
    }
  }
}

}  // namespace

// The head dims the kernels are built for: every head_dim of a shipped ViT
// config (2, 8, 32, 64) and 16, 48 of the JAX tests; from 32 up the
// tensor-core kernels.
#define ATTN_BF16_HEAD_DIMS(X) X(2) X(8) X(16) X(32) X(48) X(64)

// The kernels' constants (kRowThreads, kRowTile, kMaxWarps, kPad):
// ops/attention_fused.py plans grids, shared memory and the dq workspace
// with them and refuses a library whose constants differ.
extern "C" void attention_bf16_tiles(int* out) {
  out[0] = kRowThreads;
  out[1] = kRowTile;
  out[2] = kMaxWarps;
  out[3] = kPad;
}

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), -1 for a head dim that is
// not built, or -2 for a row copy width that a view contradicts. q, k, v
// and do are bf16 [B, N, H*hd] views with unit column stride, batch stride
// *_sb and row stride *_sr in elements; at hd >= 32 their pointers and
// strides are 4-byte aligned. At hd <= 16 the row kernels copy rows
// row_copy_bytes (16, 8, 4 or 2) at a time, which every bf16 view's pointer
// and strides, and hd * 2, must be multiples of. o and do are bf16, or both
// float32 when o_do_f32 is set (hybrid_attention's eager forward and its
// cotangent), read a float at a time. The outputs o, lse
// [B, H, N] (float32), dq, dk, dv are contiguous. dq_part is the
// backward's float32 [C, B, N, D] workspace, read only where C > 1.
extern "C" int attention_bf16_forward(const void* q, long long q_sb, long long q_sr,
                                      const void* k, long long k_sb, long long k_sr,
                                      const void* v, long long v_sb, long long v_sr, void* o,
                                      float* lse, int B, int N, int H, int hd, float scale,
                                      int row_copy_bytes, void* stream) {
  const View<bf16> qv{static_cast<const bf16*>(q), q_sb, q_sr},
      kv{static_cast<const bf16*>(k), k_sb, k_sr}, vv{static_cast<const bf16*>(v), v_sb, v_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_FWD_CASE(HD) \
  case HD:                \
    return launch_fwd<HD>(qv, kv, vv, static_cast<bf16*>(o), lse, B, N, H, scale, row_copy_bytes, s);
    ATTN_BF16_HEAD_DIMS(ATTN_FWD_CASE)
#undef ATTN_FWD_CASE
    default:
      return kBadHeadDim;
  }
}

extern "C" int attention_bf16_backward(const void* q, long long q_sb, long long q_sr,
                                       const void* k, long long k_sb, long long k_sr,
                                       const void* v, long long v_sb, long long v_sr,
                                       const void* o, long long o_sb, long long o_sr, int o_do_f32,
                                       const float* lse, const void* dout, long long do_sb,
                                       long long do_sr, void* dq, void* dk, void* dv,
                                       float* dq_part, int B, int N, int H, int hd, float scale,
                                       int row_copy_bytes, void* stream) {
  const View<bf16> qv{static_cast<const bf16*>(q), q_sb, q_sr},
      kv{static_cast<const bf16*>(k), k_sb, k_sr}, vv{static_cast<const bf16*>(v), v_sb, v_sr};
  const View<bf16> ob{static_cast<const bf16*>(o), o_sb, o_sr},
      dob{static_cast<const bf16*>(dout), do_sb, do_sr};
  const View<float> of{static_cast<const float*>(o), o_sb, o_sr},
      dof{static_cast<const float*>(dout), do_sb, do_sr};
  bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_BWD_CASE(HD)                                                                    \
  case HD:                                                                                   \
    return o_do_f32 ? launch_bwd<HD, float>(qv, kv, vv, of, lse, dof, dqb, dkb, dvb, dq_part, \
                                            B, N, H, scale, row_copy_bytes, s)               \
                    : launch_bwd<HD, bf16>(qv, kv, vv, ob, lse, dob, dqb, dkb, dvb, dq_part,  \
                                           B, N, H, scale, row_copy_bytes, s);
    ATTN_BF16_HEAD_DIMS(ATTN_BWD_CASE)
#undef ATTN_BWD_CASE
    default:
      return kBadHeadDim;
  }
}
