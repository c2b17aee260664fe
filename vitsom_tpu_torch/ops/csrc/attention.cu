// Fused multi-head attention, forward and backward, for NVIDIA Hopper
// (sm_90a), float32.
//
// The forward kernels replace the TPU kernel
// vitsom_tpu/ops/attention_pallas.py:_attn_fwd_kernel (launched by
// _fused_attention_fwd_impl). Per (batch row b, head h) they compute
//   o   = softmax(q k^T * hd^-0.5) v      [N, hd] columns h*hd.. of o [B, N, D]
//   lse = m + log(sum exp(s - m))          [N]     row (b, h) of lse [B, H, N]
// The backward kernels replace _attn_bwd_kernel (launched by
// _fused_attention_bwd_impl; also the backward of attention.hybrid_attention).
// From q, k, v, o, do and lse they recompute p = exp(s - lse) on chip and form
//   dv = p^T do,  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta) * scale,  dq = ds k,  dk = ds^T q.
// No N x N tensor reaches device memory, there are no atomics and every sum
// has a fixed order, so two runs give bitwise-equal outputs.
//
// Two designs, chosen by head dim:
//
// 1. hd <= 16 (the flagship's 8 and 2): attn_fwd_kernel / attn_bwd_kernel,
//    a row per thread on the FP32 cores. One CTA per (b, h) stages K and V
//    (the backward: q and do, then k and v, in two passes) in shared memory;
//    keys go in chunks of 8 with an online softmax. A TF32 product is 8 deep,
//    so at hd 2 it would waste three quarters of every product: the tensor
//    cores do not pay here. Bound at (128, 197, 2, 8) by FP32 operations at
//    67 TFLOP/s (forward 4.75 us, backward 11.9 us); at hd 2 by the 9.9 M
//    exponentials of a forward (twice that in the two-pass backward).
//
// 2. hd >= 32 (the emb-192 configs' 64 and 32; 48 of the JAX tests):
//    attn_fwd_mma_kernel / attn_bwd_mma_kernel, 3xTF32 products on the
//    tensor cores with mma.sync m16n8k8.
//    - Why mma.sync and not wgmma: the shipped N are 64k + 1 (65, 197, 257,
//      the CLS token). A warp's 16-row tile wastes 15 of 80 rows at N 65 and
//      11 of 208 at N 197; a 64-row wgmma tile would waste 63 of 128 at N 65.
//      The scores also stay in registers between the two products of a pass
//      (S -> p -> p v; S, dp -> ds -> ds^T q), which mma.sync's fragments
//      allow by a permutation of the summed index alone (below), where wgmma
//      would take them through shared memory.
//    - Float32 accuracy: every operand a is split into TF32 big = rna(a) and
//      small = rna(a - big); a product is small*big + big*small + big*big.
//      The tensor cores truncate what they add into their accumulator, so
//      the three products of each 8-deep step start from zero and reach the
//      FP32 accumulator through an add that rounds to nearest.
//    - Fragments: thread (g = lane / 4, t = lane % 4) holds the score tile's
//      rows g, g + 8 at columns 2t, 2t + 1. Fed back as the A operand of the
//      next product (p v, p^T do, ds^T q), column t of a k-step is taken to
//      be summed index 2t and column t + 4 index 2t + 1; the B operand's
//      rows follow the same order, so the score registers are the A fragment
//      as they are.
//    - Staging: 16-byte cp.async from the strided views (rows 16-byte
//      aligned, checked by the wrapper), zero-filled past N, into rows of
//      hd + kPad floats; that stride makes every fragment load of the
//      kernels, by rows (4g + t) or by summed index (8t + g), hit 32 banks.
//    - Grid: a (b, h) is cut into C chunks of W warp tiles of kRowTile rows,
//      C = ceil(tiles / kMaxWarps), W = ceil(tiles / C) (ops/attention_fused.
//      py:mma_plan). The forward's chunks are query tiles: each CTA streams
//      K and V in 32-key blocks through a two-stage cp.async ring, the next
//      block copied while the warps work on this one, and a warp runs an
//      online softmax over the blocks for its 16 query rows, q read straight
//      into registers. (Staging all of K and V instead left one CTA an SM
//      at (512, 257, 3, 64): 1.678 ms there against the ring's 1.018; it
//      was 1-6 % faster at N 197 and at N 257, hd 32, level at N 65; timed
//      in one call on an NVIDIA H100 80GB HBM3, 700.00 W.)
//      The backward's chunks are key tiles: each CTA stages its K and V
//      rows, computes delta = rowsum(do * o) of every query row in a
//      prologue, and streams the 16-row tiles of q and do through a
//      two-stage cp.async ring, the next tile copied while the warps work on
//      this one; a warp keeps dk and dv of its 16 keys in registers while it
//      walks the query tiles, and p, dp and ds are computed once per (query,
//      key) pair. Per query tile the warps write ds to a [16, keys] tile in
//      shared memory, one barrier, then form dq of those 16 rows over the
//      CTA's keys, each warp a set of 8-column tiles. With C > 1 the chunks
//      write dq partials to a [C, B, N, D] workspace that dq_sum_kernel adds
//      in chunk order.
//    - Registers: both kernels are capped at 128 a thread (kMinBlocks 2
//      CTAs of 8 warps an SM), which registers, not shared memory, limited.
//      At (128, 65, 3, 64) the cap took the forward from 0.0507 to 0.0347 ms
//      and the backward from 0.1010 to 0.0748 (NVIDIA H100 80GB HBM3,
//      700.00 W, each pair timed in one call; PERF.md).
//
// Per shipped shape (B, N, H, hd), C x W, CTAs (B*H*C) and dynamic shared
// memory per CTA (ops/attention_fused.py:smem_bytes gives the same):
//   smem N 65, hd 64: 1 x 5, 384 CTAs; forward 34816 B, backward 68224 B
//   smem N 65, hd 32: 1 x 5, 384 CTAs; forward 18432 B, backward 39552 B
//   smem N 197, hd 64: 2 x 7, 768 CTAs; forward 34816 B, backward 88704 B
//   smem N 197, hd 32: 2 x 7, 768 CTAs; forward 18432 B, backward 51840 B
//   smem N 257, hd 64: 3 x 6, 4608 CTAs at B 512; forward 34816 B, backward 78464 B
//   smem N 257, hd 32: 3 x 6, 4608 CTAs at B 512; forward 18432 B, backward 45696 B
//
// Bound on an H100 SXM, each input and output byte counted once, operations
// 4 B H N^2 hd (forward) and 10 B H N^2 hd (backward: s, dv, dp, dq, dk), as
// three TF32 products at 495 TFLOP/s, beside FP32 at 67 TFLOP/s:
//   (128, 65, 3, 64):  fwd 25.7 MB 7.66 us | 3xTF32 2.52 us (FP32 6.20): bytes
//                      bwd 51.2 MB 15.29 us | 6.29 us (15.50): bytes
//   (128, 65, 3, 32):  fwd 3.84 us bytes | 1.26 us; bwd 7.66 us | 3.15 us: bytes
//   (128, 197, 3, 64): fwd 23.21 us bytes | 23.12 us; bwd 46.34 us | 57.80 us: ops
//   (128, 197, 3, 32): fwd 11.65 us | 11.56 us; bwd 23.21 us | 28.90 us: ops
//   (512, 257, 3, 64): fwd 121.14 us | 157.40 us; bwd 241.80 | 393.51 us: ops
//   (512, 257, 3, 32): fwd 60.80 us | 78.70 us; bwd 121.14 | 196.75 us: ops
// ptxas (sm_90a), registers / spill stores: attn_fwd_mma_kernel hd 64
// 128 / 172 B, hd 48 127 / 0, hd 32 122 / 0; attn_bwd_mma_kernel hd 64
// 128 / 172 B, hd 48 128 / 136 B, hd 32 128 / 0; the row kernels at most
// 120 / 0 (chip_smoke.py phase 2 prints them for every build).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kKeyChunk = 8;
constexpr int kBadHeadDim = -1;
constexpr int kRowTile = 16;   // rows of a warp's tile: the mma's M
constexpr int kMaxWarps = 8;   // warp tiles of a CTA
constexpr int kPad = 4;        // floats after each staged row
constexpr int kKeyBlock = 4;   // 8-key n-tiles per online-softmax step of the forward
// CTAs an SM the tensor-core kernels' registers are capped for (128 a thread)
constexpr int kMinBlocks = 2;

// A [B, N, *] float view with unit column stride: row r of batch b starts at
// ptr + b * sb + r * sr (strides in floats).
struct View {
  const float* ptr;
  long long sb;
  long long sr;
};

__device__ __forceinline__ const float* row_ptr(const View& x, int b, int r, int col) {
  return x.ptr + (long long)b * x.sb + (long long)r * x.sr + col;
}

// ---------------------------------------------------------------------------
// hd <= 16: a row per thread on the FP32 cores
// ---------------------------------------------------------------------------

// W floats from shared memory, as 16- or 8-byte loads where the width allows
template <int W>
__device__ __forceinline__ void lds(const float* s, float (&r)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(s)[i];
      r[4 * i] = x.x;
      r[4 * i + 1] = x.y;
      r[4 * i + 2] = x.z;
      r[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(s)[i];
      r[2 * i] = x.x;
      r[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = s[i];
  }
}

// W floats from device memory (strided views: no alignment assumed)
template <int W>
__device__ __forceinline__ void ldg(const float* __restrict__ g, float (&r)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = g[i];
}

template <int W>
__device__ __forceinline__ float dot(const float (&a)[W], const float (&b)[W]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// rows [0, N) of one head's HD columns of a strided view -> dense [N][HD]
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long sr,
                                      int N) {
  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {
    const int r = e / HD;
    dst[e] = src[(long long)r * sr + (e - r * HD)];
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attn_fwd_kernel(View q, View k, View v, float* __restrict__ o, float* __restrict__ lse, int N,
                int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + N * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int col0 = h * HD;
  stage<HD>(ks, row_ptr(k, b, 0, col0), k.sr, N);
  stage<HD>(vs, row_ptr(v, b, 0, col0), v.sr, N);
  __syncthreads();

  const long long D = (long long)H * HD;
  for (int r0 = 0; r0 < N; r0 += blockDim.x) {
    const int i = r0 + threadIdx.x;
    const int ii = min(i, N - 1);
    float qr[HD], acc[HD];
    ldg<HD>(row_ptr(q, b, ii, col0), qr);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < N; j0 += kKeyChunk) {
      float s[kKeyChunk];
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        float kr[HD];
        lds<HD>(ks + min(j0 + c, N - 1) * HD, kr);
        s[c] = dot<HD>(qr, kr) * scale;
        if (j0 + c >= N) s[c] = -INFINITY;
      }
      float cm = s[0];
#pragma unroll
      for (int c = 1; c < kKeyChunk; ++c) cm = fmaxf(cm, s[c]);
      const float m_new = fmaxf(m, cm);
      const float corr = expf(m - m_new);  // 0 on the first chunk, 1 if the max held
      // the chunk's sums first, then one add each into the running sums:
      // those see N / 8 adds, not N
      float lc = 0.f, pv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) pv[d] = 0.f;
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        const float p = expf(s[c] - m_new);
        lc += p;
        float vr[HD];
        lds<HD>(vs + min(j0 + c, N - 1) * HD, vr);
#pragma unroll
        for (int d = 0; d < HD; ++d) pv[d] = fmaf(p, vr[d], pv[d]);
      }
      l = fmaf(l, corr, lc);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(acc[d], corr, pv[d]);
      m = m_new;
    }
    if (i < N) {
      float* orow = o + ((long long)b * N + i) * D + col0;
#pragma unroll
      for (int d = 0; d < HD; ++d) orow[d] = acc[d] / l;
      lse[((long long)b * H + h) * N + i] = m + logf(l);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
attn_bwd_kernel(View q, View k, View v, View o, const float* __restrict__ lse, View dout,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int N,
                int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;            // q in pass A, k in pass B: [N][HD]
  float* bs = smem + N * HD;   // do in pass A, v in pass B
  float* lse_s = smem + 2 * N * HD;
  float* delta_s = lse_s + N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int col0 = h * HD;
  const long long D = (long long)H * HD;

  stage<HD>(as, row_ptr(q, b, 0, col0), q.sr, N);
  stage<HD>(bs, row_ptr(dout, b, 0, col0), dout.sr, N);
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) lse_s[i] = lse_bh[i];
  // delta_i = rowsum(do_i * o_i) over this head, once per row
  for (int r0 = 0; r0 < N; r0 += blockDim.x) {
    const int i = r0 + threadIdx.x;
    const int ii = min(i, N - 1);
    float orow[HD], drow[HD];
    ldg<HD>(row_ptr(o, b, ii, col0), orow);
    ldg<HD>(row_ptr(dout, b, ii, col0), drow);
    const float delta = dot<HD>(orow, drow);
    if (i < N) delta_s[i] = delta;
  }
  __syncthreads();

  // pass A: a thread owns key row j; dv_j = sum_i p_ij do_i, dk_j = sum_i ds_ij q_i
  for (int r0 = 0; r0 < N; r0 += blockDim.x) {
    const int j = r0 + threadIdx.x;
    const int jj = min(j, N - 1);
    float kr[HD], vr[HD], dkr[HD], dvr[HD];
    ldg<HD>(row_ptr(k, b, jj, col0), kr);
    ldg<HD>(row_ptr(v, b, jj, col0), vr);
#pragma unroll
    for (int d = 0; d < HD; ++d) dkr[d] = dvr[d] = 0.f;
#pragma unroll 2
    for (int i = 0; i < N; ++i) {
      float qi[HD], doi[HD];
      lds<HD>(as + i * HD, qi);
      lds<HD>(bs + i * HD, doi);
      const float p = expf(dot<HD>(qi, kr) * scale - lse_s[i]);
      const float dp = dot<HD>(doi, vr);
      const float ds = p * (dp - delta_s[i]) * scale;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dvr[d] = fmaf(p, doi[d], dvr[d]);
        dkr[d] = fmaf(ds, qi[d], dkr[d]);
      }
    }
    if (j < N) {
      const long long off = ((long long)b * N + j) * D + col0;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[off + d] = dkr[d];
        dv[off + d] = dvr[d];
      }
    }
  }
  __syncthreads();
  stage<HD>(as, row_ptr(k, b, 0, col0), k.sr, N);
  stage<HD>(bs, row_ptr(v, b, 0, col0), v.sr, N);
  __syncthreads();

  // pass B: a thread owns query row i; dq_i = sum_j ds_ij k_j
  for (int r0 = 0; r0 < N; r0 += blockDim.x) {
    const int i = r0 + threadIdx.x;
    const int ii = min(i, N - 1);
    float qi[HD], doi[HD], dqr[HD];
    ldg<HD>(row_ptr(q, b, ii, col0), qi);
    ldg<HD>(row_ptr(dout, b, ii, col0), doi);
    const float lse_i = lse_s[ii];
    const float delta_i = delta_s[ii];
#pragma unroll
    for (int d = 0; d < HD; ++d) dqr[d] = 0.f;
#pragma unroll 2
    for (int j = 0; j < N; ++j) {
      float kj[HD], vj[HD];
      lds<HD>(as + j * HD, kj);
      lds<HD>(bs + j * HD, vj);
      const float p = expf(dot<HD>(qi, kj) * scale - lse_i);
      const float dp = dot<HD>(doi, vj);
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int d = 0; d < HD; ++d) dqr[d] = fmaf(ds, kj[d], dqr[d]);
    }
    if (i < N) {
      float* out = dq + ((long long)b * N + i) * D + col0;
#pragma unroll
      for (int d = 0; d < HD; ++d) out[d] = dqr[d];
    }
  }
}

// ---------------------------------------------------------------------------
// hd >= 32: 3xTF32 products on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* gmem, bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this thread committed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + rows) of one head's HD columns of a strided view -> smem rows
// of HD + kPad floats, zero past row N
template <int HD>
__device__ __forceinline__ void stage_async(float* dst, const View& x, int b, int col0, int r0,
                                            int rows, int N) {
  constexpr int LD = HD + kPad, V4 = HD / 4;
  for (int e = threadIdx.x; e < rows * V4; e += blockDim.x) {
    const int r = e / V4, c = e - (e / V4) * V4;
    const int gr = r0 + r;
    cp_async16(smem_u32(dst + r * LD + 4 * c), row_ptr(x, b, min(gr, N - 1), col0 + 4 * c),
               gr < N);
  }
}

// round to nearest TF32, ties away from zero: cvt.rna.tf32.f32 for finite a
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// an A fragment as two TF32 parts, a = big + small to float32 accuracy
struct Frag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ Frag split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.big[i] = tf32_rna(a[i]);
    f.small[i] = tf32_rna(a[i] - __uint_as_float(f.big[i]));
  }
  return f;
}

// d += a b on one m16n8k8 tile, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to float32 accuracy, b = (b0, b1) this thread's B fragment: three
// TF32 products summed from zero, then one rounding add
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  const uint32_t bb0 = tf32_rna(b0), bb1 = tf32_rna(b1);
  const uint32_t bs0 = tf32_rna(b0 - __uint_as_float(bb0));
  const uint32_t bs1 = tf32_rna(b1 - __uint_as_float(bb1));
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s, a.small, bb0, bb1);
  mma_tf32(s, a.big, bs0, bs1);
  mma_tf32(s, a.big, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// C query chunks of W warps per (b, h); warp w of chunk c owns query rows
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
attn_fwd_mma_kernel(View q, View k, View v, float* __restrict__ o, float* __restrict__ lse, int N,
                    int H, int chunks, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int KS = HD / 8;  // 8-deep k-steps of q k^T, and 8-wide column tiles of o
  constexpr int BK = kKeyBlock * 8;  // keys of a ring stage
  extern __shared__ __align__(16) float smem[];  // [2 stages][K, V][BK][LD]
  const int n_tiles = (N + 7) / 8;  // 8-key tiles

  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / H, h = bh % H, col0 = h * HD;
  stage_async<HD>(smem, k, b, col0, 0, BK, N);
  stage_async<HD>(smem + BK * LD, v, b, col0, 0, BK, N);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = (c * (blockDim.x / 32) + warp) * kRowTile;
  const bool active = i0 < N;

  // this warp's q rows i0 + g and i0 + g + 8 as A fragments, straight from device memory
  float qf[KS][4];
  {
    const float* qa = row_ptr(q, b, min(i0 + g, N - 1), col0 + t);
    const float* qb = row_ptr(q, b, min(i0 + g + 8, N - 1), col0 + t);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = __ldg(qa + 8 * kk);
      qf[kk][1] = __ldg(qb + 8 * kk);
      qf[kk][2] = __ldg(qa + 8 * kk + 4);
      qf[kk][3] = __ldg(qb + 8 * kk + 4);
    }
  }
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max and this thread's part of the running sum, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int nb = 0; nb < n_tiles; nb += kKeyBlock) {
    // this block's keys have landed and every warp is done with the last
    // block's stage; the next block is copied meanwhile
    cp_async_wait_all();
    __syncthreads();
    if (nb + kKeyBlock < n_tiles) {
      float* next = smem + ((nb / kKeyBlock + 1) & 1) * 2 * BK * LD;
      stage_async<HD>(next, k, b, col0, (nb + kKeyBlock) * 8, BK, N);
      stage_async<HD>(next + BK * LD, v, b, col0, (nb + kKeyBlock) * 8, BK, N);
    }
    cp_async_commit();
    if (!active) continue;
    const float* ks = smem + ((nb / kKeyBlock) & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;
    float s[kKeyBlock][4];
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const Frag a = split_a(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
#pragma unroll
      for (int j = 0; j < kKeyBlock; ++j) {
        if (nb + j < n_tiles) {
          const float* kr = ks + (j * 8 + g) * LD + 8 * kk + t;
          mma3(s[j], a, kr[0], kr[4]);
        }
      }
    }
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j) {
      if (nb + j < n_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (nb + j) * 8 + 2 * t + (e & 1);
          s[j][e] = key < N ? s[j][e] * scale : -INFINITY;
          bm[e / 2] = fmaxf(bm[e / 2], s[j][e]);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(bm[r]));
      corr[r] = expf(m[r] - m_new);  // 0 on the first block, 1 if the max held
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];
#pragma unroll
    for (int j = 0; j < kKeyBlock; ++j) {
      if (nb + j < n_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e / 2]);
          l[e / 2] += s[j][e];
        }
        // o += p v: key tile j is a k-step, column t <-> key 2t, t + 4 <-> 2t + 1
        const Frag a = split_a(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* vr = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < KS; ++n) mma3(acc[n], a, vr[8 * n], vr[8 * n + LD]);
      }
    }
  }

  if (!active) return;
  const long long D = (long long)H * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const float lsum = quad_sum(l[r]);
    if (i < N) {
      float* orow = o + ((long long)b * N + i) * D + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * r] / lsum, acc[n][2 * r + 1] / lsum);
      if (t == 0) lse[(long long)bh * N + i] = m[r] + logf(lsum);
    }
  }
}

// C key chunks of W warps per (b, h); warp w of chunk c owns keys
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c. With C > 1, dq goes to
// dq_part[c] ([C, B, N, D]) for dq_sum_kernel.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
attn_bwd_mma_kernel(View q, View k, View v, View o, const float* __restrict__ lse, View dout,
                    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dq_part, int N, int H, int chunks, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int KS = HD / 8;
  constexpr int DL = (HD + 31) / 32;  // floats of a row a lane holds in the delta prologue
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int NQ = (N + kRowTile - 1) / kRowTile * kRowTile;
  const int KC = warps * kRowTile;      // keys of a CTA
  const int LDS = KC + ((8 - KC) & 31);  // ds row stride, 8 mod 32: conflict-free float2 reads
  float* kst = smem;
  float* vst = kst + KC * LD;
  float* ring = vst + KC * LD;  // [2 stages][q, do][kRowTile][LD]: the query tiles
  float* lse_s = ring + 4 * kRowTile * LD;
  float* delta_s = lse_s + NQ;
  float* dsb = delta_s + NQ;  // [kRowTile][LDS]

  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / H, h = bh % H, col0 = h * HD;
  const int key0 = c * KC;
  stage_async<HD>(kst, k, b, col0, key0, KC, N);
  stage_async<HD>(vst, v, b, col0, key0, KC, N);
  stage_async<HD>(ring, q, b, col0, 0, kRowTile, N);
  stage_async<HD>(ring + kRowTile * LD, dout, b, col0, 0, kRowTile, N);
  cp_async_commit();
  // padded query rows get lse = inf, hence p = 0
  for (int i = threadIdx.x; i < NQ; i += blockDim.x)
    lse_s[i] = i < N ? lse[(long long)bh * N + i] : INFINITY;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // delta_i = rowsum(do_i * o_i), a warp per row in a fixed order; the
  // loads of 8 rows are issued before any of their sums
  for (int r0 = 8 * warp; r0 < NQ; r0 += 8 * warps) {
    float ov[8][DL], dv_[8][DL];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < DL; ++u) {
        const int d = lane + 32 * u;
        const bool ok = r0 + r < N && d < HD;
        ov[r][u] = ok ? __ldg(row_ptr(o, b, r0 + r, col0 + d)) : 0.f;
        dv_[r][u] = ok ? __ldg(row_ptr(dout, b, r0 + r, col0 + d)) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float x = 0.f;
#pragma unroll
      for (int u = 0; u < DL; ++u) x = fmaf(dv_[r][u], ov[r][u], x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) delta_s[r0 + r] = x;
    }
  }

  const int kw = key0 + warp * kRowTile;  // this warp's first key
  const bool active = kw < N;
  const float* kr = kst + warp * kRowTile * LD;
  const float* vr = vst + warp * kRowTile * LD;
  const int dq_steps = (min(KC, N - key0) + 7) / 8;  // 8-key k-steps of dq
  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const long long D = (long long)H * HD;
  float* dq_out = chunks == 1 ? dq : dq_part + (long long)c * (gridDim.x / chunks / H) * N * D;
  const int n_tiles = NQ / kRowTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int i0 = qt * kRowTile;
    // query tile qt has landed and every warp is done with tile qt - 1
    // (its ring stage and the ds tile); tile qt + 1 is copied meanwhile
    cp_async_wait_all();
    __syncthreads();
    if (qt + 1 < n_tiles) {
      float* next = ring + ((qt + 1) & 1) * 2 * kRowTile * LD;
      stage_async<HD>(next, q, b, col0, i0 + kRowTile, kRowTile, N);
      stage_async<HD>(next + kRowTile * LD, dout, b, col0, i0 + kRowTile, kRowTile, N);
    }
    cp_async_commit();
    const float* qs = ring + (qt & 1) * 2 * kRowTile * LD;
    const float* dos = qs + kRowTile * LD;
    if (active) {
      // s^T = k q^T and dp^T = v do^T: rows are this warp's keys, columns queries i0..
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int d0 = 8 * kk + t;
        const Frag fk = split_a(kr[g * LD + d0], kr[(g + 8) * LD + d0], kr[g * LD + d0 + 4],
                                kr[(g + 8) * LD + d0 + 4]);
        const Frag fv = split_a(vr[g * LD + d0], vr[(g + 8) * LD + d0], vr[g * LD + d0 + 4],
                                vr[(g + 8) * LD + d0 + 4]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int row = (8 * n + g) * LD + d0;
          mma3(s[n], fk, qs[row], qs[row + 4]);
          mma3(dp[n], fv, dos[row], dos[row + 4]);
        }
      }
      // p and ds in place of s and dp; ds also to the shared tile for dq
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1);  // query within the tile
          const int key = g + 8 * (e / 2);         // key within the warp's tile
          const float p = kw + key < N ? expf(s[n][e] * scale - lse_s[i0 + qi]) : 0.f;
          const float ds = p * (dp[n][e] - delta_s[i0 + qi]) * scale;
          s[n][e] = p;
          dp[n][e] = ds;
          dsb[qi * LDS + warp * kRowTile + key] = ds;
        }
      // dv += p^T do, dk += ds^T q: score tile n is a k-step, column t <->
      // query 2t, t + 4 <-> 2t + 1
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const Frag fp = split_a(s[n][0], s[n][2], s[n][1], s[n][3]);
        const Frag fs = split_a(dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
        const int row = (8 * n + 2 * t) * LD + g;
#pragma unroll
        for (int m = 0; m < KS; ++m) {
          mma3(dva[m], fp, dos[row + 8 * m], dos[row + LD + 8 * m]);
          mma3(dka[m], fs, qs[row + 8 * m], qs[row + LD + 8 * m]);
        }
      }
    }
    __syncthreads();
    // dq of rows i0.. over this CTA's keys: ds [16, keys] k [keys, HD]; warp
    // w owns column tiles w, w + W, ...; column t <-> key 2t, t + 4 <-> 2t + 1
    for (int m = warp; m < KS; m += warps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int st = 0; st < dq_steps; ++st) {
        const float2 x0 = *reinterpret_cast<const float2*>(dsb + g * LDS + 8 * st + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(dsb + (g + 8) * LDS + 8 * st + 2 * t);
        const Frag f = split_a(x0.x, x1.x, x0.y, x1.y);
        const float* kb = kst + (8 * st + 2 * t) * LD + 8 * m + g;
        mma3(acc, f, kb[0], kb[LD]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < N)
          *reinterpret_cast<float2*>(dq_out + ((long long)b * N + i) * D + col0 + 8 * m + 2 * t) =
              make_float2(acc[2 * r], acc[2 * r + 1]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kw + g + 8 * r;
      if (j < N) {
        const long long off = ((long long)b * N + j) * D + col0 + 2 * t;
#pragma unroll
        for (int m = 0; m < KS; ++m) {
          *reinterpret_cast<float2*>(dk + off + 8 * m) = make_float2(dka[m][2 * r], dka[m][2 * r + 1]);
          *reinterpret_cast<float2*>(dv + off + 8 * m) = make_float2(dva[m][2 * r], dva[m][2 * r + 1]);
        }
      }
    }
  }
}

// dq = sum over c of dq_part[c], in chunk order; n4 float4s per chunk
__global__ void dq_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dq,
                              long long n4, int chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n4;
       e += (long long)gridDim.x * blockDim.x) {
    float4 a = part[e];
    for (int c = 1; c < chunks; ++c) {
      const float4 x = part[c * n4 + e];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    dq[e] = a;
  }
}

// threads per CTA: the fewest passes over the N rows, at most kMaxThreads
// rows a pass, spread evenly and rounded up to warps
int threads_for(int N) {
  const int passes = (N + kMaxThreads - 1) / kMaxThreads;
  const int per_pass = (N + passes - 1) / passes;
  return (per_pass + 31) / 32 * 32;
}

// chunks C and warps W of a (b, h) at sequence length N (see the header)
void mma_plan(int N, int* chunks, int* warps) {
  const int tiles = (N + kRowTile - 1) / kRowTile;
  *chunks = (tiles + kMaxWarps - 1) / kMaxWarps;
  *warps = (tiles + *chunks - 1) / *chunks;
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

template <int HD>
int launch_fwd(View q, View k, View v, float* o, float* lse, int B, int N, int H, float scale,
               cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * 2 * (size_t)N * HD;
  cudaError_t err = allow_smem(attn_fwd_kernel<HD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kernel<HD><<<B * H, threads_for(N), smem, s>>>(q, k, v, o, lse, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(View q, View k, View v, View o, const float* lse, View dout, float* dq, float* dk,
               float* dv, float*, int B, int N, int H, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * (2 * (size_t)N * HD + 2 * (size_t)N);
  cudaError_t err = allow_smem(attn_bwd_kernel<HD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kernel<HD><<<B * H, threads_for(N), smem, s>>>(q, k, v, o, lse, dout, dq, dk, dv, N,
                                                          H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fwd_mma(View q, View k, View v, float* o, float* lse, int B, int N, int H, float scale,
                   cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  int chunks, warps;
  mma_plan(N, &chunks, &warps);
  const size_t smem = sizeof(float) * 4 * kKeyBlock * 8 * (HD + kPad);
  cudaError_t err = allow_smem(attn_fwd_mma_kernel<HD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_mma_kernel<HD><<<B * H * chunks, 32 * warps, smem, s>>>(q, k, v, o, lse, N, H, chunks,
                                                                   scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd_mma(View q, View k, View v, View o, const float* lse, View dout, float* dq,
                   float* dk, float* dv, float* dq_part, int B, int N, int H, float scale,
                   cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  int chunks, warps;
  mma_plan(N, &chunks, &warps);
  const size_t nq = (N + kRowTile - 1) / kRowTile * kRowTile, kc = warps * kRowTile;
  const size_t lds = kc + ((8 - kc) & 31);
  const size_t smem = sizeof(float) * ((2 * kc + 4 * kRowTile) * (HD + kPad) + 2 * nq +
                                       kRowTile * lds);
  cudaError_t err = allow_smem(attn_bwd_mma_kernel<HD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_mma_kernel<HD><<<B * H * chunks, 32 * warps, smem, s>>>(
      q, k, v, o, lse, dout, dq, dk, dv, dq_part, N, H, chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const long long n4 = (long long)B * N * H * HD / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
  dq_sum_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(dq_part),
                                       reinterpret_cast<float4*>(dq), n4, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head dims the kernels are built for, with their launchers: every
// head_dim of a shipped ViT config (2, 8, 32, 64) and 16, 48 of the JAX tests.
#define ATTN_HEAD_DIMS(X)                                                                  \
  X(2, launch_fwd, launch_bwd) X(8, launch_fwd, launch_bwd) X(16, launch_fwd, launch_bwd)    \
  X(32, launch_fwd_mma, launch_bwd_mma) X(48, launch_fwd_mma, launch_bwd_mma)                \
  X(64, launch_fwd_mma, launch_bwd_mma)

// The tensor-core kernels' tile constants (kRowTile, kMaxWarps, kPad,
// kKeyBlock): ops/attention_fused.py plans the grid, shared memory and the
// dq workspace with them and refuses to load a library whose constants
// differ.
extern "C" void attention_tiles(int* out) {
  out[0] = kRowTile;
  out[1] = kMaxWarps;
  out[2] = kPad;
  out[3] = kKeyBlock;
}

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), or -1 for a head dim that is
// not built. q, k, v, o and do are [B, N, H*hd] views with unit column
// stride, batch stride *_sb and row stride *_sr in floats (the model hands
// over q, k, v sliced out of its fused qkv buffer, rows 3*D apart); at
// hd >= 32 they and their strides are 16-byte aligned. The outputs o,
// lse [B, H, N], dq, dk, dv are contiguous. dq_part is the backward's
// [C, B, N, D] workspace, read only where the plan has C > 1.
extern "C" int attention_forward(const float* q, long long q_sb, long long q_sr, const float* k,
                                 long long k_sb, long long k_sr, const float* v, long long v_sb,
                                 long long v_sr, float* o, float* lse, int B, int N, int H,
                                 int hd, float scale, void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_FWD_CASE(HD, FWD, BWD) \
  case HD:                          \
    return FWD<HD>(qv, kv, vv, o, lse, B, N, H, scale, s);
    ATTN_HEAD_DIMS(ATTN_FWD_CASE)
#undef ATTN_FWD_CASE
    default:
      return kBadHeadDim;
  }
}

extern "C" int attention_backward(const float* q, long long q_sb, long long q_sr, const float* k,
                                  long long k_sb, long long k_sr, const float* v, long long v_sb,
                                  long long v_sr, const float* o, long long o_sb, long long o_sr,
                                  const float* lse, const float* dout, long long do_sb,
                                  long long do_sr, float* dq, float* dk, float* dv,
                                  float* dq_part, int B, int N, int H, int hd, float scale,
                                  void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr}, ov{o, o_sb, o_sr},
      dov{dout, do_sb, do_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_BWD_CASE(HD, FWD, BWD) \
  case HD:                          \
    return BWD<HD>(qv, kv, vv, ov, lse, dov, dq, dk, dv, dq_part, B, N, H, scale, s);
    ATTN_HEAD_DIMS(ATTN_BWD_CASE)
#undef ATTN_BWD_CASE
    default:
      return kBadHeadDim;
  }
}
