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
// Two designs, chosen by head dim. The JAX kernel takes any head dim, and
// so do these: every hd from 1 to 192 runs at a tier, the first at least
// as wide (ATTN_ROW_TIERS, ATTN_MMA_TIERS below; ops/attention_fused.py:
// head_tier), instantiated once. A head at its tier copies rows as before;
// one below it runs the tier's kernel with a runtime hd, on 4-byte copies
// zero past hd (PAD in the row kernels, `pad` in the tensor-core ones),
// which leaves every score and sum as it is: zero columns of q and k add
// nothing to a score, zero columns of v and do give output columns that
// are not stored.
//
// 1. hd <= 24 (the flagship's 8 and 2; 16 of the JAX tests): attn_fwd_kernel
//    / attn_bwd_kernel on the FP32 cores. A TF32 product is 8 deep, so at
//    hd 2 it would waste three quarters of every product: the tensor cores
//    do not pay here.
//    - Rows: a group of kRowLanes (2) consecutive lanes holds kRowRows (2)
//      rows. Its lanes split the other side's rows (keys in the forward and
//      in pass B, queries in pass A), lane l taking those = l (mod 2), and
//      each key or query row read from shared memory serves both rows.
//      That read, 64 bytes a (row, key) pair at hd 8 without the reuse,
//      bounds these kernels: shared memory hands 128 B a clock an SM to
//      registers however few distinct addresses a warp reads, 19 us of
//      reads at (128, 197, 2, 8), in the first design (one thread a row,
//      one CTA of 7 warps per (b, h), 1.9 an SM) as in a design of 4 lanes
//      a row at 32 warps an SM, which was no faster than it. Three rows a
//      thread or more cost more in registers (128-167) than they save.
//    - Grid: a (b, h)'s N rows are spread evenly over C chunks of at most
//      kRowThreads / kRowLanes * kRowRows rows, a CTA each
//      (ops/attention_fused.py:row_plan). Every CTA stages its (b, h)'s K
//      and V in shared memory (the backward's pass-A CTAs q, do, lse and
//      delta); the other CTAs of that (b, h) read them again from L2.
//    - Forward: a lane walks its keys in online-softmax steps of kKeyChunk
//      keys, then 4, 2 and 1 (no padded key slots), with the score
//      arithmetic of the first design: an in-order fmaf chain over d, then
//      * scale. The two lanes' partials (m, l, acc) of a row merge by an
//      xor shuffle, the lower lane's always first, so both hold the same
//      bits.
//    - Backward: one launch of pass-A CTAs (key chunks: dk, dv) and pass-B
//      CTAs (query chunks: dq) side by side; partials sum by xor shuffles.
//      Each CTA forms the deltas it needs. p = exp(s * scale - lse), dp and
//      ds are the two-pass design's expressions, so every exponential is
//      computed twice, once in each pass: the cost that remains (a one-pass
//      backward would sum dq over lanes that hold other key rows).
//    - Copies: the wrapper picks the widest row copy, 16, 8 or 4 bytes, that
//      every view's pointer and strides allow (attention_fused.py:
//      row_copy_width). The kernels are instantiated per width, so their
//      copy loops carry no branch, and the launcher refuses a width that a
//      view contradicts.
//    - Tiers 2, 4, 8, 16 and 24: hd 1 runs at 2, 3 at 4, 5-7 at 8, 9-15 at
//      16 and 17-23 at 24, PAD (a float a copy, zero past hd; stores of the
//      columns below hd alone). The flagship at vit.heads 4 runs hd 4 (its
//      own tier) in its encoder and hd 1 in its decoder. Tier 24 is here,
//      not on the tensor cores: a 3xTF32 product keeps 22 of an operand's
//      24 significant bits (two 11-bit parts), which over short sums (a
//      head of 17-23 columns, few keys) shows past the float64 rule below:
//      at (54, 9, 2, 17) the 3xTF32 tier 24 put dk 1.81e-6 from float64,
//      the plain version 6.38e-7 (chip_smoke.py phase Q's hold, NVIDIA H100
//      80GB HBM3, 700.00 W). Its staged K and V limit N to 1162 (backward).
//    - Tier 32 (hd 25-32) runs here too up to N kRowWideMaxN = 880, where
//      its staged [N, 32] operands fit, a row a group (kRowRows rows would
//      hold 2 x 4 x 32 floats of k, v, dk, dv a thread): the 3xTF32 tier 32
//      broke the same rule on some seeds at short N (dq 2.845x the plain
//      version's float64 error at hd 32, N 65; ROADMAP Queue 3). Past N 880
//      tier 32 stays on the tensor cores.
//    - Bound at (128, 197, 2, 8): FP32 operations at 67 TFLOP/s (forward
//      4.75 us, backward 11.9 us). At hd 2 the forward's 9.9 M exponentials
//      at 16 a clock an SM (the SFU rate) take 2.38 us, above its FP32
//      operations' 1.19 us; the backward needs the same exponentials and is
//      bound by its operations (2.97 us). At (128, 197, 2, 8) the kernels
//      take 0.0268 / 0.0577 ms against the first design's 0.0363 / 0.0774
//      (in turns on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//    Per row shape: chunks (the backward's C_A + C_B), threads a CTA, CTAs,
//    dynamic shared memory a CTA (ops/attention_fused.py:row_plan and
//    smem_bytes give the same) and resident CTAs an SM (cudaOccupancyMax-
//    ActiveBlocksPerMultiprocessor on an H100, chip_smoke.py phase 9):
//     rows fwd N 197, hd 8: 2 x 128 threads, 512 CTAs at B 128, H 2; 12608 B; 5 an SM
//     rows bwd N 197, hd 8: 2 + 2 x 128 threads, 1024 CTAs at B 128, H 2; 14184 B; 4 an SM
//     rows fwd N 197, hd 2: 2 x 128 threads, 512 CTAs at B 128, H 2; 3152 B; 9 an SM
//     rows bwd N 197, hd 2: 2 + 2 x 128 threads, 1024 CTAs at B 128, H 2; 4728 B; 10 an SM
//     rows fwd N 65, hd 8: 1 x 96 threads, 256 CTAs at B 128, H 2; 4160 B; 6 an SM
//     rows bwd N 65, hd 8: 1 + 1 x 96 threads, 512 CTAs at B 128, H 2; 4680 B; 5 an SM
//     rows fwd N 65, hd 2: 1 x 96 threads, 256 CTAs at B 128, H 2; 1040 B; 12 an SM
//     rows bwd N 65, hd 2: 1 + 1 x 96 threads, 512 CTAs at B 128, H 2; 1560 B; 13 an SM
//     rows fwd N 257, hd 8: 3 x 96 threads, 768 CTAs at B 128, H 2; 16448 B; 6 an SM
//     rows bwd N 257, hd 8: 3 + 3 x 96 threads, 1536 CTAs at B 128, H 2; 18504 B; 5 an SM
//     rows fwd N 257, hd 2: 3 x 96 threads, 768 CTAs at B 128, H 2; 4112 B; 12 an SM
//     rows bwd N 257, hd 2: 3 + 3 x 96 threads, 1536 CTAs at B 128, H 2; 6168 B; 13 an SM
//     rows fwd N 33, hd 16: 1 x 64 threads, 4 CTAs at B 2, H 2; 4224 B; 8 an SM
//     rows bwd N 33, hd 16: 1 + 1 x 64 threads, 8 CTAs at B 2, H 2; 4488 B; 4 an SM
//     rows fwd N 9, hd 8: 1 x 32 threads, 1 CTAs at B 1, H 1; 576 B; 20 an SM
//     rows bwd N 9, hd 8: 1 + 1 x 32 threads, 2 CTAs at B 1, H 1; 648 B; 16 an SM
//

// 2. 25 <= hd <= 192 (the emb-192 configs' 64 and 32; 48 of the JAX tests):
//    attn_fwd_mma_kernel / attn_bwd_mma_kernel, 3xTF32 products on the
//    tensor cores with mma.sync m16n8k8, at tiers that are multiples of
//    the product's 8-deep k-step: 32, 40, 48, 56, 64, 80, 96, 112, 128 and
//    192.
//    - Past 64 the tier is cut into ceil(tier / 64) slices of output
//      columns (80: 2 x 40, 96: 2 x 48, 112: 2 x 56, 128: 2 x 64, 192:
//      3 x 64), a CTA each (blockIdx.y). A slice's CTA forms the scores
//      over the whole head, then o (forward), or dq, dk and dv (backward),
//      of its columns alone: the accumulators a warp holds stay those of
//      at most 64 columns (dk and dv 2 x 32 floats a lane at hd 64), so
//      registers do not grow with hd, at the cost of the scores formed
//      once a slice. These tiers run one CTA of 8 warps an SM (launch
//      bounds of 255 registers: q's TF32 fragments are hd / 2 floats a
//      lane in the forward). The backward stages its chunk's K and V rows
//      of the whole head, hd + kPad floats each: at tier 192 a CTA holds 4
//      warp tiles (64 keys, 150 KB), below it 8 (tier 128: 135 KB).
//    - Below the tier (hd % 8 != 0, or a head between two tiers), and for
//      views whose rows are not 16-byte aligned, the staging copies are
//      4-byte cp.async, zero past hd; q's fragments are zero past hd; the
//      stores are a float at a time at odd hd (float2 at even hd).
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
//    - Staging: 16-byte cp.async from the strided views (where hd is the
//      tier and their rows start on 16-byte boundaries; else the 4-byte
//      copies above), zero-filled past N, into rows of
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
//   smem N 197, hd 64: 2 x 7, 768 CTAs; forward 34816 B, backward 88704 B
//   smem N 257, hd 64: 3 x 6, 4608 CTAs at B 512; forward 34816 B, backward 78464 B
// (the shipped hd 32, the emb-192 decoders', runs the row kernels at these N)
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
// 128 / 176 B, hd 48 128 / 0, hd 32 124 / 0; attn_bwd_mma_kernel hd 64
// 128 / 180 B, hd 48 128 / 120 B, hd 32 128 / 8 B; past 64 (255 a
// thread) the forward 183-255 registers (200 B spilled at tier 192), the
// backward 254-255 (124-312 B at 96, 112, 192); the row kernels forward /
// backward hd 2 56 / 48, hd 4 72 / 64, hd 8 96 / 118, hd 16 128 / 200, hd
// 24 165 / 248-255 (4 B spilled, PAD) (chip_smoke.py phase 2 prints them
// for every build).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32_mma.cuh"

namespace {

constexpr int kKeyChunk = 8;    // keys of a row kernel's online-softmax step
constexpr int kBadHeadDim = -1;
constexpr int kBadCopyWidth = -2;
// the row kernels (hd <= 24): threads of a CTA at most, lanes of a row
// group (a power of two that divides 32) and rows a group
constexpr int kRowThreads = 128;
constexpr int kRowLanes = 2;
constexpr int kRowRows = 2;
// hd 25-32 at N up to kRowWideMaxN (the staged [N, 32] q and do, lse and
// delta of the backward's pass A fill 232320 of a CTA's 232448 bytes there)
// run the row kernels at tier kRowWideTier, a row a group: two rows' k, v,
// dk, dv at 32 columns would pass 255 registers
constexpr int kRowWideTier = 32;
constexpr int kRowWideMaxN = 880;
// rows a row group holds at tier HD
__host__ __device__ constexpr int row_rows(int HD) { return HD > 24 ? 1 : kRowRows; }
// at most two lanes, so a row group's first lane always holds a key and the
// forward's merge never meets two lanes without one
static_assert(kRowLanes == 1 || kRowLanes == 2, "row groups of one or two lanes");
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
// hd <= 24: row groups of kRowLanes lanes and kRowRows rows, on the FP32 cores
// ---------------------------------------------------------------------------

// VW consecutive floats, device memory -> registers -> shared memory. VW is
// the row copy width in floats (4, 2 or 1) that the launcher has checked
// every pointer and stride against.
template <int VW>
__device__ __forceinline__ void ldg_vec(const float* __restrict__ g, float* r) {
  if constexpr (VW == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(g));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(g));
    r[0] = x.x;
    r[1] = x.y;
  } else {
    r[0] = __ldg(g);
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* s, const float* r) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(s) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(s) = make_float2(r[0], r[1]);
  } else {
    s[0] = r[0];
  }
}

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

// one head's HD floats of row r of a strided view, in VW-float copies;
// PAD (a padded tier: the head's hd columns fewer than HD) a float a copy,
// zero past column hd
template <int HD, int VW, bool PAD>
__device__ __forceinline__ void ldg_row(const View& x, int b, int r, int col0, int hd,
                                        float (&out)[HD]) {
  const float* g = row_ptr(x, b, r, col0);
  if constexpr (PAD) {
#pragma unroll
    for (int i = 0; i < HD; ++i) out[i] = i < hd ? __ldg(g + i) : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < HD / VW; ++i) ldg_vec<VW>(g + VW * i, out + VW * i);
  }
}

template <int W>
__device__ __forceinline__ float dot(const float (&a)[W], const float (&b)[W]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// rows [0, N) of one head's HD columns of two strided views -> dense [N][HD]
// tiles in shared memory, VW floats a copy (HD / VW copies a row: a shift,
// not a division); PAD a float a copy, zero past column hd
template <int HD, int VW, bool PAD>
__device__ __forceinline__ void stage2(float* sa, float* sb, const View& a, const View& b, int bi,
                                       int col0, int N, int hd) {
  constexpr unsigned kPerRow = HD / VW;
  const float* ga = row_ptr(a, bi, 0, col0);
  const float* gb = row_ptr(b, bi, 0, col0);
  if constexpr (PAD) {
    for (unsigned e = threadIdx.x; e < N * HD; e += blockDim.x) {
      const unsigned r = e / HD, c = e % HD;
      const bool in = (int)c < hd;
      sa[e] = in ? __ldg(ga + r * a.sr + c) : 0.f;
      sb[e] = in ? __ldg(gb + r * b.sr + c) : 0.f;
    }
    return;
  }
  for (unsigned e = threadIdx.x; e < N * kPerRow; e += blockDim.x) {
    const unsigned r = e / kPerRow, c = VW * (e % kPerRow);
    float x[VW], y[VW];
    ldg_vec<VW>(ga + r * a.sr + c, x);
    ldg_vec<VW>(gb + r * b.sr + c, y);
    st_vec<VW>(sa + r * HD + c, x);
    st_vec<VW>(sb + r * HD + c, y);
  }
}

// the lanes of this thread's row group (L consecutive lanes of a warp)
template <int L>
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << L) - 1u) << ((threadIdx.x % 32) & ~(L - 1));
}

// x summed over the L lanes of a row group by xor shuffles: a + b == b + a
// in float, so every lane of the group ends with the same bits
template <int L, int W>
__device__ __forceinline__ void group_sum(float (&x)[W]) {
  const unsigned mask = group_mask<L>();
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
#pragma unroll
    for (int d = 0; d < W; ++d) x[d] += __shfl_xor_sync(mask, x[d], off);
}

// lane `lane` of a row group stores its HD / L columns of a row in vector
// stores; PAD a float a store, the columns below hd alone
template <int HD, int L, bool PAD>
__device__ __forceinline__ void store_cols(float* row, const float (&x)[HD], int lane, int hd) {
  constexpr int W = HD / L;                                 // columns a lane stores
  constexpr int S = W % 4 == 0 ? 4 : (W % 2 == 0 ? 2 : 1);  // floats a store
#pragma unroll
  for (int g = 0; g < HD / W; ++g)
    if (lane == g) {
      if constexpr (PAD) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (g * W + w < hd) row[g * W + w] = x[g * W + w];
      } else {
#pragma unroll
        for (int w = 0; w < W; w += S) st_vec<S>(row + g * W + w, x + g * W + w);
      }
    }
}

// one online-softmax step over K keys j0, j0 + L, ..., all < N, for a
// thread's R rows: each key and value row is read from shared memory once
// for all R. Per row a running max, and the step's sums formed first and
// added once into the running sums.
template <int K, int HD, int L, int R>
__device__ __forceinline__ void softmax_step(const float (&qr)[R][HD], const float* ks,
                                             const float* vs, int j0, float scale,
                                             float (&m)[R], float (&l)[R],
                                             float (&acc)[R][HD]) {
  float s[R][K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float kr[HD];
    lds<HD>(ks + (j0 + t * L) * HD, kr);
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][t] = dot<HD>(qr[r], kr) * scale;
  }
  float m_new[R], corr[R], lc[R], pv[R][HD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float cm = s[r][0];
#pragma unroll
    for (int t = 1; t < K; ++t) cm = fmaxf(cm, s[r][t]);
    m_new[r] = fmaxf(m[r], cm);
    corr[r] = expf(m[r] - m_new[r]);  // 0 on the first step, 1 if the max held
    lc[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) pv[r][d] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float vr[HD];
    lds<HD>(vs + (j0 + t * L) * HD, vr);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = expf(s[r][t] - m_new[r]);
      lc[r] += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) pv[r][d] = fmaf(p, vr[d], pv[r][d]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = fmaf(l[r], corr[r], lc[r]);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[r][d] = fmaf(acc[r][d], corr[r], pv[r][d]);
    m[r] = m_new[r];
  }
}

// Forward. C query chunks of `rows` rows a (b, h), blockIdx.x = (b H + h) C
// + c. Each CTA stages its (b, h)'s K and V. Rows go R at a time to a group
// of L consecutive threads, lane l of the group taking keys j = l (mod L) in
// online-softmax steps of kKeyChunk keys, then 4, 2, 1. The lanes' partials
// (m, l, acc) of a row merge by xor shuffles, the lower lane of each pair
// always first, so every lane of the group holds the same bits. HD is the
// tier (hd itself, or with PAD the tier hd is padded to: the staged rows and
// q zero past hd, which leaves every score and sum as it is).
template <int HD, int VW, bool PAD>
__global__ void __launch_bounds__(kRowThreads)
attn_fwd_kernel(View q, View k, View v, float* __restrict__ o, float* __restrict__ lse, int N,
                int H, int hd_arg, int chunks, int rows, float scale) {
  constexpr int L = kRowLanes, R = row_rows(HD);
  const int hd = PAD ? hd_arg : HD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + N * HD;

  const int bh = blockIdx.x / chunks, c = blockIdx.x - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const int end = min(c * rows + rows, N);  // past this chunk's last row
  const int i0 = c * rows + g * R;          // this group's first row
  float qr[R][HD];
#pragma unroll
  for (int r = 0; r < R; ++r) ldg_row<HD, VW, PAD>(q, b, min(i0 + r, N - 1), col0, hd, qr[r]);
  stage2<HD, VW, PAD>(ks, vs, k, v, b, col0, N, hd);
  __syncthreads();
  if (i0 >= end) return;  // whole groups: every shuffle below has its lanes

  float acc[R][HD], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;  // what a lane without keys (lane >= N) keeps
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[r][d] = 0.f;
  }
  int j0 = lane;
  for (; j0 + (kKeyChunk - 1) * L < N; j0 += kKeyChunk * L)
    softmax_step<kKeyChunk, HD, L, R>(qr, ks, vs, j0, scale, m, l, acc);
  if (j0 + 3 * L < N) {
    softmax_step<4, HD, L, R>(qr, ks, vs, j0, scale, m, l, acc);
    j0 += 4 * L;
  }
  if (j0 + L < N) {
    softmax_step<2, HD, L, R>(qr, ks, vs, j0, scale, m, l, acc);
    j0 += 2 * L;
  }
  if (j0 < N) softmax_step<1, HD, L, R>(qr, ks, vs, j0, scale, m, l, acc);

  const unsigned mask = group_mask<L>();
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const bool low = (lane & off) == 0;
      const float m2 = __shfl_xor_sync(mask, m[r], off);
      const float l2 = __shfl_xor_sync(mask, l[r], off);
      const float m_lo = low ? m[r] : m2, m_hi = low ? m2 : m[r];
      const float mx = fmaxf(m_lo, m_hi);  // finite: lane 0 holds key 0
      const float c_lo = expf(m_lo - mx), c_hi = expf(m_hi - mx);
      l[r] = fmaf(low ? l2 : l[r], c_hi, (low ? l[r] : l2) * c_lo);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float a2 = __shfl_xor_sync(mask, acc[r][d], off);
        acc[r][d] = fmaf(low ? a2 : acc[r][d], c_hi, (low ? acc[r][d] : a2) * c_lo);
      }
      m[r] = mx;
    }
    const int i = i0 + r;
    if (i < end) {
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[r][d] = acc[r][d] / l[r];
      store_cols<HD, L, PAD>(o + ((long long)b * N + i) * H * hd + col0, acc[r], lane, hd);
      if (lane == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
    }
  }
}

// Backward, one launch of 2 B H C CTAs: the first B H C are pass-A CTAs (key
// chunk c of (b, h) = blockIdx.x / C: dk, dv), the rest pass-B CTAs (query
// chunk c: dq). Both recompute p = exp(s * scale - lse) and ds = p (dp -
// delta) scale with the two-pass design's expressions. A pass-A CTA stages
// q, do, lse and every row's delta = rowsum(do o); a pass-B CTA stages k and
// v and forms its own rows' deltas. Rows go R at a time to a group of L
// lanes, which split the other side's rows (lane l takes those = l mod L),
// read each of them from shared memory once for all R, and sum their
// partials by xor shuffles. HD and PAD as in the forward.
template <int HD, int VW, bool PAD>
__global__ void __launch_bounds__(kRowThreads)
attn_bwd_kernel(View q, View k, View v, View o, const float* __restrict__ lse, View dout,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int N,
                int H, int hd_arg, int chunks, int rows, float scale) {
  constexpr int L = kRowLanes, R = row_rows(HD);
  const int hd = PAD ? hd_arg : HD;
  extern __shared__ __align__(16) float smem[];
  const int per_pass = gridDim.x / 2;
  const bool pass_a = blockIdx.x < per_pass;
  const int idx = pass_a ? blockIdx.x : blockIdx.x - per_pass;
  const int bh = idx / chunks, c = idx - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const int end = min(c * rows + rows, N);
  const int r0 = c * rows + g * R;  // this group's first row: keys in pass A, queries in B
  const float* lse_bh = lse + (long long)bh * N;
  const long long D = (long long)H * hd;

  if (pass_a) {
    float* qs = smem;  // [N][HD]
    float* dos = smem + N * HD;
    float* lse_s = smem + 2 * N * HD;
    float* delta_s = lse_s + N;
    float kr[R][HD], vr[R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ldg_row<HD, VW, PAD>(k, b, min(r0 + r, N - 1), col0, hd, kr[r]);
      ldg_row<HD, VW, PAD>(v, b, min(r0 + r, N - 1), col0, hd, vr[r]);
    }
    stage2<HD, VW, PAD>(qs, dos, q, dout, b, col0, N, hd);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float orow[HD], drow[HD];
      ldg_row<HD, VW, PAD>(o, b, i, col0, hd, orow);
      ldg_row<HD, VW, PAD>(dout, b, i, col0, hd, drow);
      lse_s[i] = lse_bh[i];
      delta_s[i] = dot<HD>(orow, drow);
    }
    __syncthreads();
    if (r0 >= end) return;
    // dv_j = sum_i p_ij do_i, dk_j = sum_i ds_ij q_i
    float dkr[R][HD], dvr[R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < HD; ++d) dkr[r][d] = dvr[r][d] = 0.f;
#pragma unroll 2
    for (int i = lane; i < N; i += L) {
      float qi[HD], doi[HD];
      lds<HD>(qs + i * HD, qi);
      lds<HD>(dos + i * HD, doi);
      const float lse_i = lse_s[i], delta_i = delta_s[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = expf(dot<HD>(qi, kr[r]) * scale - lse_i);
        const float dp = dot<HD>(doi, vr[r]);
        const float ds = p * (dp - delta_i) * scale;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dvr[r][d] = fmaf(p, doi[d], dvr[r][d]);
          dkr[r][d] = fmaf(ds, qi[d], dkr[r][d]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      group_sum<L>(dkr[r]);
      group_sum<L>(dvr[r]);
      if (r0 + r < end) {
        const long long out = ((long long)b * N + r0 + r) * D + col0;
        store_cols<HD, L, PAD>(dk + out, dkr[r], lane, hd);
        store_cols<HD, L, PAD>(dv + out, dvr[r], lane, hd);
      }
    }
  } else {
    float* ks = smem;  // [N][HD]
    float* vs = smem + N * HD;
    float qi[R][HD], doi[R][HD], lse_i[R], delta_i[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = min(r0 + r, N - 1);
      float oi[HD];
      ldg_row<HD, VW, PAD>(q, b, i, col0, hd, qi[r]);
      ldg_row<HD, VW, PAD>(dout, b, i, col0, hd, doi[r]);
      ldg_row<HD, VW, PAD>(o, b, i, col0, hd, oi);
      lse_i[r] = lse_bh[i];
      delta_i[r] = dot<HD>(oi, doi[r]);
    }
    stage2<HD, VW, PAD>(ks, vs, k, v, b, col0, N, hd);
    __syncthreads();
    if (r0 >= end) return;
    // dq_i = sum_j ds_ij k_j
    float dqr[R][HD];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < HD; ++d) dqr[r][d] = 0.f;
#pragma unroll 2
    for (int j = lane; j < N; j += L) {
      float kj[HD], vj[HD];
      lds<HD>(ks + j * HD, kj);
      lds<HD>(vs + j * HD, vj);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = expf(dot<HD>(qi[r], kj) * scale - lse_i[r]);
        const float dp = dot<HD>(doi[r], vj);
        const float ds = p * (dp - delta_i[r]) * scale;
#pragma unroll
        for (int d = 0; d < HD; ++d) dqr[r][d] = fmaf(ds, kj[d], dqr[r][d]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      group_sum<L>(dqr[r]);
      if (r0 + r < end)
        store_cols<HD, L, PAD>(dq + ((long long)b * N + r0 + r) * D + col0, dqr[r], lane, hd);
    }
  }
}


// ---------------------------------------------------------------------------
// 17 <= hd <= 192: 3xTF32 products on the tensor cores
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this thread committed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + rows) of W columns of a strided view from column `col` ->
// smem rows of W + kPad floats, zero past row N. 16-byte copies, or with
// `pad` (a head of fewer than W columns, or a view whose rows are not
// 16-byte aligned) 4-byte ones, zero past the `cols` columns that exist
template <int W>
__device__ __forceinline__ void stage_async(float* dst, const View& x, int b, int col, int r0,
                                            int rows, int N, int cols, bool pad) {
  constexpr int LD = W + kPad, V4 = W / 4;
  if (!pad) {
    for (int e = threadIdx.x; e < rows * V4; e += blockDim.x) {
      const int r = e / V4, c = e - (e / V4) * V4;
      const int gr = r0 + r;
      cp_async16(smem_u32(dst + r * LD + 4 * c), row_ptr(x, b, min(gr, N - 1), col + 4 * c),
                 gr < N);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
    const int r = e / W, c = e - (e / W) * W;
    const int gr = r0 + r;
    cp_async4(smem_u32(dst + r * LD + c), row_ptr(x, b, min(gr, N - 1), col + min(c, cols - 1)),
              gr < N && c < cols);
  }
}

// a pair of adjacent output columns (col, col + 1) of a contiguous float32
// row: one 8-byte store where hd is even (then col + 1 < hd with col), else
// the columns below hd a float at a time
__device__ __forceinline__ void store_pair(float* row, int col, int hd, float a, float b) {
  if (!(hd & 1)) {
    if (col < hd) *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < hd) row[col] = a;
    if (col + 1 < hd) row[col + 1] = b;
  }
}

// the warps a tensor-core CTA holds at most at tier HD: the backward's K
// and V rows of 16 W keys, hd + kPad floats each, fit in shared memory
__host__ __device__ constexpr int mma_max_warps(int HD) {
  return HD <= 128 ? kMaxWarps : kMaxWarps / 2;
}

// C query chunks of W warps per (b, h); warp w of chunk c owns query rows
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c; blockIdx.y is the
// slice of SW output columns (from SW * blockIdx.y) this CTA forms: the
// scores take all HD columns of q and k, o only its slice of v. HD is the
// tier (hd padded to a multiple of 8; q, k and v zero past hd), SW = HD up
// to 64 (one slice), else HD / ceil(HD / 64).
template <int HD, int SW>
__global__ void __launch_bounds__(kMaxWarps * 32, HD <= 64 ? kMinBlocks : 1)
attn_fwd_mma_kernel(View q, View k, View v, float* __restrict__ o, float* __restrict__ lse, int N,
                    int H, int hd, int chunks, int pad, float scale) {
  constexpr int LD = HD + kPad, LDV = SW + kPad;
  constexpr int KS = HD / 8;  // 8-deep k-steps of q k^T
  constexpr int MS = SW / 8;  // 8-wide column tiles of o
  constexpr int BK = kKeyBlock * 8;  // keys of a ring stage
  extern __shared__ __align__(16) float smem[];  // [2 stages][K [BK][LD], V [BK][LDV]]
  constexpr int kStage = BK * (LD + LDV);
  const int n_tiles = (N + 7) / 8;  // 8-key tiles

  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / H, h = bh % H, col0 = h * hd;
  const int sc = SW == HD ? 0 : SW * blockIdx.y;  // the slice's first column in the head
  const int vcols = min(SW, hd - sc);          // its columns that exist
  stage_async<HD>(smem, k, b, col0, 0, BK, N, hd, pad);
  stage_async<SW>(smem + BK * LD, v, b, col0 + sc, 0, BK, N, vcols, pad);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = (c * (blockDim.x / 32) + warp) * kRowTile;
  const bool active = i0 < N;

  // this warp's q rows i0 + g and i0 + g + 8 as A fragments, straight from
  // device memory, zero past hd
  float qf[KS][4];
  {
    const float* qa = row_ptr(q, b, min(i0 + g, N - 1), col0);
    const float* qb = row_ptr(q, b, min(i0 + g + 8, N - 1), col0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d0 = 8 * kk + t, d1 = d0 + 4;
      qf[kk][0] = d0 < hd ? __ldg(qa + d0) : 0.f;
      qf[kk][1] = d0 < hd ? __ldg(qb + d0) : 0.f;
      qf[kk][2] = d1 < hd ? __ldg(qa + d1) : 0.f;
      qf[kk][3] = d1 < hd ? __ldg(qb + d1) : 0.f;
    }
  }
  float acc[MS][4];
#pragma unroll
  for (int n = 0; n < MS; ++n)
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
      float* next = smem + ((nb / kKeyBlock + 1) & 1) * kStage;
      stage_async<HD>(next, k, b, col0, (nb + kKeyBlock) * 8, BK, N, hd, pad);
      stage_async<SW>(next + BK * LD, v, b, col0 + sc, (nb + kKeyBlock) * 8, BK, N, vcols, pad);
    }
    cp_async_commit();
    if (!active) continue;
    const float* ks = smem + ((nb / kKeyBlock) & 1) * kStage;
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
    for (int n = 0; n < MS; ++n)
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
        const float* vr = vs + (j * 8 + 2 * t) * LDV + g;
#pragma unroll
        for (int n = 0; n < MS; ++n) mma3(acc[n], a, vr[8 * n], vr[8 * n + LDV]);
      }
    }
  }

  if (!active) return;
  const long long D = (long long)H * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const float lsum = quad_sum(l[r]);
    if (i < N) {
      float* orow = o + ((long long)b * N + i) * D + col0;
#pragma unroll
      for (int n = 0; n < MS; ++n)
        store_pair(orow, sc + 8 * n + 2 * t, hd, acc[n][2 * r] / lsum, acc[n][2 * r + 1] / lsum);
      if (t == 0 && sc == 0) lse[(long long)bh * N + i] = m[r] + logf(lsum);
    }
  }
}

// C key chunks of W warps per (b, h); warp w of chunk c owns keys
// 16 (c W + w) .. + 16. blockIdx.x = (b H + h) C + c; blockIdx.y is the
// slice of SW columns of dq, dk and dv this CTA forms (s and dp take all
// HD columns of q, k, v and do). With C > 1, dq goes to dq_part[c] ([C, B,
// N, D]) for dq_sum_kernel. HD, SW and pad as in the forward.
template <int HD, int SW>
__global__ void __launch_bounds__(kMaxWarps * 32, HD <= 64 ? kMinBlocks : 1)
attn_bwd_mma_kernel(View q, View k, View v, View o, const float* __restrict__ lse, View dout,
                    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dq_part, int N, int H, int hd, int chunks, int pad,
                    float scale) {
  constexpr int LD = HD + kPad;
  constexpr int KS = HD / 8;
  constexpr int MS = SW / 8;
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
  const int b = bh / H, h = bh % H, col0 = h * hd;
  const int sc = SW == HD ? 0 : SW * blockIdx.y;  // the slice's first column in the head
  const int key0 = c * KC;
  stage_async<HD>(kst, k, b, col0, key0, KC, N, hd, pad);
  stage_async<HD>(vst, v, b, col0, key0, KC, N, hd, pad);
  stage_async<HD>(ring, q, b, col0, 0, kRowTile, N, hd, pad);
  stage_async<HD>(ring + kRowTile * LD, dout, b, col0, 0, kRowTile, N, hd, pad);
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
        const bool ok = r0 + r < N && d < hd;
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
  float dka[MS][4], dva[MS][4];
#pragma unroll
  for (int n = 0; n < MS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const long long D = (long long)H * hd;
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
      stage_async<HD>(next, q, b, col0, i0 + kRowTile, kRowTile, N, hd, pad);
      stage_async<HD>(next + kRowTile * LD, dout, b, col0, i0 + kRowTile, kRowTile, N, hd, pad);
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
      // dv += p^T do, dk += ds^T q over the slice's columns: score tile n
      // is a k-step, column t <-> query 2t, t + 4 <-> 2t + 1
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const Frag fp = split_a(s[n][0], s[n][2], s[n][1], s[n][3]);
        const Frag fs = split_a(dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
        const int row = (8 * n + 2 * t) * LD + sc + g;
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          mma3(dva[m], fp, dos[row + 8 * m], dos[row + LD + 8 * m]);
          mma3(dka[m], fs, qs[row + 8 * m], qs[row + LD + 8 * m]);
        }
      }
    }
    __syncthreads();
    // dq of rows i0.. over this CTA's keys and the slice's columns: ds [16,
    // keys] k [keys, SW]; warp w owns column tiles w, w + W, ...; column t
    // <-> key 2t, t + 4 <-> 2t + 1
    for (int m = warp; m < MS; m += warps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int st = 0; st < dq_steps; ++st) {
        const float2 x0 = *reinterpret_cast<const float2*>(dsb + g * LDS + 8 * st + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(dsb + (g + 8) * LDS + 8 * st + 2 * t);
        const Frag f = split_a(x0.x, x1.x, x0.y, x1.y);
        const float* kb = kst + (8 * st + 2 * t) * LD + sc + 8 * m + g;
        mma3(acc, f, kb[0], kb[LD]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < N)
          store_pair(dq_out + ((long long)b * N + i) * D + col0, sc + 8 * m + 2 * t, hd,
                     acc[2 * r], acc[2 * r + 1]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kw + g + 8 * r;
      if (j < N) {
        const long long off = ((long long)b * N + j) * D + col0;
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          store_pair(dk + off, sc + 8 * m + 2 * t, hd, dka[m][2 * r], dka[m][2 * r + 1]);
          store_pair(dv + off, sc + 8 * m + 2 * t, hd, dva[m][2 * r], dva[m][2 * r + 1]);
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

// the same a float at a time, where B N D is not a multiple of 4 (odd hd)
__global__ void dq_sum1_kernel(const float* __restrict__ part, float* __restrict__ dq,
                               long long n, int chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float a = part[e];
    for (int c = 1; c < chunks; ++c) a += part[c * n + e];
    dq[e] = a;
  }
}

// the row kernels' chunks C of a (b, h) at sequence length N: at most
// kRowThreads / kRowLanes * row_rows(HD) rows a CTA, spread evenly over the
// chunks, the CTA rounded up to warps (ops/attention_fused.py:row_plan)
void row_plan(int N, int HD, int* chunks, int* rows, int* threads) {
  const int R = row_rows(HD), most = kRowThreads / kRowLanes * R;
  *chunks = (N + most - 1) / most;
  *rows = (N + *chunks - 1) / *chunks;
  *threads = ((*rows + R - 1) / R * kRowLanes + 31) / 32 * 32;
}

size_t row_smem(int N, int HD, bool backward) {
  return sizeof(float) * (2 * (size_t)N * HD + (backward ? 2 * (size_t)N : 0));
}

// whether a view's pointer and strides take VW-float copies
bool takes_width(const View& x, int vw) {
  return reinterpret_cast<uintptr_t>(x.ptr) % (sizeof(float) * vw) == 0 && x.sb % vw == 0 &&
         x.sr % vw == 0;
}

// chunks C and warps W of a (b, h) at sequence length N and tier HD (see
// the header)
void mma_plan(int N, int HD, int* chunks, int* warps) {
  const int tiles = (N + kRowTile - 1) / kRowTile, most = mma_max_warps(HD);
  *chunks = (tiles + most - 1) / most;
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

template <int HD, int VW, bool PAD>
int launch_fwd_rows(View q, View k, View v, float* o, float* lse, int B, int N, int H, int hd,
                    float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  if (!PAD && (HD % VW || !takes_width(q, VW) || !takes_width(k, VW) || !takes_width(v, VW)))
    return kBadCopyWidth;
  int chunks, rows, threads;
  row_plan(N, HD, &chunks, &rows, &threads);
  const size_t smem = row_smem(N, HD, false);
  cudaError_t err = allow_smem(attn_fwd_kernel<HD, VW, PAD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kernel<HD, VW, PAD><<<B * H * chunks, threads, smem, s>>>(q, k, v, o, lse, N, H, hd,
                                                                     chunks, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int VW, bool PAD>
int launch_bwd_rows(View q, View k, View v, View o, const float* lse, View dout, float* dq,
                    float* dk, float* dv, int B, int N, int H, int hd, float scale,
                    cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  if (!PAD && (HD % VW || !takes_width(q, VW) || !takes_width(k, VW) || !takes_width(v, VW) ||
               !takes_width(o, VW) || !takes_width(dout, VW)))
    return kBadCopyWidth;
  int chunks, rows, threads;
  row_plan(N, HD, &chunks, &rows, &threads);
  const size_t smem = row_smem(N, HD, true);
  cudaError_t err = allow_smem(attn_bwd_kernel<HD, VW, PAD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kernel<HD, VW, PAD><<<2 * B * H * chunks, threads, smem, s>>>(
      q, k, v, o, lse, dout, dq, dk, dv, N, H, hd, chunks, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// the row launchers at tier HD: hd below the tier runs the padded kernel
// (4-byte copies, whatever the width); hd at the tier the copy width the
// wrapper chose (bytes: 16, 8, 4)
template <int HD>
int launch_fwd(View q, View k, View v, float* o, float* lse, int B, int N, int H, int hd,
               float scale, int width, cudaStream_t s) {
  if (hd != HD) return launch_fwd_rows<HD, 1, true>(q, k, v, o, lse, B, N, H, hd, scale, s);
  switch (width) {
    case 16:
      if constexpr (HD % 4 == 0)
        return launch_fwd_rows<HD, 4, false>(q, k, v, o, lse, B, N, H, hd, scale, s);
      return kBadCopyWidth;
    case 8:
      return launch_fwd_rows<HD, 2, false>(q, k, v, o, lse, B, N, H, hd, scale, s);
    case 4:
      return launch_fwd_rows<HD, 1, false>(q, k, v, o, lse, B, N, H, hd, scale, s);
    default:
      return kBadCopyWidth;
  }
}

template <int HD>
int launch_bwd(View q, View k, View v, View o, const float* lse, View dout, float* dq, float* dk,
               float* dv, float*, int B, int N, int H, int hd, float scale, int width,
               cudaStream_t s) {
  if (hd != HD)
    return launch_bwd_rows<HD, 1, true>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale, s);
  switch (width) {
    case 16:
      if constexpr (HD % 4 == 0)
        return launch_bwd_rows<HD, 4, false>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd,
                                             scale, s);
      return kBadCopyWidth;
    case 8:
      return launch_bwd_rows<HD, 2, false>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale,
                                           s);
    case 4:
      return launch_bwd_rows<HD, 1, false>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale,
                                           s);
    default:
      return kBadCopyWidth;
  }
}

// the output slices of tier HD: one up to 64 columns, else ceil(HD / 64)
__host__ __device__ constexpr int mma_slices(int HD) { return HD <= 64 ? 1 : (HD + 63) / 64; }

// whether the tensor-core kernels take 4-byte copies at this call: hd below
// its tier, or a view whose pointer or strides are not 16-byte multiples
bool mma_pad(int HD, int hd, std::initializer_list<View> views) {
  if (hd != HD) return true;
  for (const View& x : views)
    if (!takes_width(x, 4)) return true;
  return false;
}

size_t fwd_mma_smem(int HD) {
  constexpr int BK = kKeyBlock * 8;
  const int SW = HD / mma_slices(HD);
  return sizeof(float) * 2 * BK * (HD + SW + 2 * kPad);
}

size_t bwd_mma_smem(int N, int HD, int warps) {
  const size_t nq = (N + kRowTile - 1) / kRowTile * kRowTile, kc = warps * kRowTile;
  const size_t lds = kc + ((8 - kc) & 31);
  return sizeof(float) * ((2 * kc + 4 * kRowTile) * (HD + kPad) + 2 * nq + kRowTile * lds);
}

template <int HD>
int launch_fwd_mma(View q, View k, View v, float* o, float* lse, int B, int N, int H, int hd,
                   float scale, int, cudaStream_t s) {
  constexpr int SW = HD / mma_slices(HD);
  static size_t allowed = 48 * 1024;
  int chunks, warps;
  mma_plan(N, HD, &chunks, &warps);
  const size_t smem = fwd_mma_smem(HD);
  cudaError_t err = allow_smem(attn_fwd_mma_kernel<HD, SW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pad = mma_pad(HD, hd, {q, k, v});
  attn_fwd_mma_kernel<HD, SW><<<dim3(B * H * chunks, mma_slices(HD)), 32 * warps, smem, s>>>(
      q, k, v, o, lse, N, H, hd, chunks, pad, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd_mma(View q, View k, View v, View o, const float* lse, View dout, float* dq,
                   float* dk, float* dv, float* dq_part, int B, int N, int H, int hd, float scale,
                   int, cudaStream_t s) {
  constexpr int SW = HD / mma_slices(HD);
  static size_t allowed = 48 * 1024;
  int chunks, warps;
  mma_plan(N, HD, &chunks, &warps);
  const size_t smem = bwd_mma_smem(N, HD, warps);
  cudaError_t err = allow_smem(attn_bwd_mma_kernel<HD, SW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pad = mma_pad(HD, hd, {q, k, v, o, dout});
  attn_bwd_mma_kernel<HD, SW><<<dim3(B * H * chunks, mma_slices(HD)), 32 * warps, smem, s>>>(
      q, k, v, o, lse, dout, dq, dk, dv, dq_part, N, H, hd, chunks, pad, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const long long n = (long long)B * N * H * hd, n4 = n / 4;
  if (n % 4 == 0) {
    const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
    dq_sum_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(dq_part),
                                         reinterpret_cast<float4*>(dq), n4, chunks);
  } else {
    const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
    dq_sum1_kernel<<<blocks, 256, 0, s>>>(dq_part, dq, n, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// {CTAs, threads, dynamic shared memory bytes, resident CTAs an SM} of a
// row kernel's launch (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename Kernel>
int row_info(Kernel kernel, int ctas_per_chunk, int N, int HD, bool backward, int* out) {
  int chunks, rows, threads;
  row_plan(N, HD, &chunks, &rows, &threads);
  const size_t smem = row_smem(N, HD, backward);
  // raise the kernel's dynamic shared memory limit, never lower it: the
  // launchers remember the largest they set (allow_smem) and launch a
  // larger N later without setting it again
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && (int)smem > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kernel, threads, smem);
  out[0] = ctas_per_chunk * chunks;
  out[1] = threads;
  out[2] = (int)smem;
  return static_cast<int>(err);
}

template <int HD, int VW, bool PAD>
int row_info_at(int B, int N, int H, int backward, int* out) {
  return backward ? row_info(attn_bwd_kernel<HD, VW, PAD>, 2 * B * H, N, HD, true, out)
                  : row_info(attn_fwd_kernel<HD, VW, PAD>, B * H, N, HD, false, out);
}

template <int HD>
int row_info_width(int B, int N, int H, int hd, int backward, int width, int* out) {
  if (hd != HD) return row_info_at<HD, 1, true>(B, N, H, backward, out);
  switch (width) {
    case 16:
      if constexpr (HD % 4 == 0) return row_info_at<HD, 4, false>(B, N, H, backward, out);
      return kBadCopyWidth;
    case 8:
      return row_info_at<HD, 2, false>(B, N, H, backward, out);
    case 4:
      return row_info_at<HD, 1, false>(B, N, H, backward, out);
    default:
      return kBadCopyWidth;
  }
}

}  // namespace

// The tiers a head dim is padded to, with their launchers: hd runs at the
// first tier at least as wide. The row kernels (FP32 cores) up to 24; the
// 3xTF32 tensor-core kernels from 25, their tiers multiples of 8, past 64
// cut into ceil(tier / 64) output slices of a multiple of 8 columns (80:
// 2 x 40, 96: 2 x 48, 112: 2 x 56, 128: 2 x 64, 192: 3 x 64). A head dim
// at its tier (the shipped 2, 8, 32, 64; 4, 16, 48, ...) copies rows as
// the wrapper's width allows (row kernels) or 16 bytes a copy (tensor
// cores, where the views allow it); one below its tier runs the same
// kernels on 4-byte copies, zero past hd.
#define ATTN_ROW_TIERS(X) X(2) X(4) X(8) X(16) X(24)
#define ATTN_MMA_TIERS(X) X(32) X(40) X(48) X(56) X(64) X(80) X(96) X(112) X(128) X(192)

// The kernels' tile constants (kRowTile, kMaxWarps, kPad, kKeyBlock of the
// tensor-core kernels; kRowThreads, kRowLanes, kRowRows, kRowWideTier,
// kRowWideMaxN of the row kernels): ops/attention_fused.py plans the grids, shared memory and the
// dq workspace with them and refuses to load a library whose constants
// differ.
extern "C" void attention_tiles(int* out) {
  out[0] = kRowTile;
  out[1] = kMaxWarps;
  out[2] = kPad;
  out[3] = kKeyBlock;
  out[4] = kRowThreads;
  out[5] = kRowLanes;
  out[6] = kRowRows;
  out[7] = kRowWideTier;
  out[8] = kRowWideMaxN;
}

// The tiers, row kernels' first, each list ended by a 0 (at most 32
// entries in all): ops/attention_fused.py checks them against its own.
extern "C" void attention_head_tiers(int* out) {
  int i = 0;
#define ATTN_TIER_OUT(T) out[i++] = T;
  ATTN_ROW_TIERS(ATTN_TIER_OUT)
  out[i++] = 0;
  ATTN_MMA_TIERS(ATTN_TIER_OUT)
  out[i++] = 0;
#undef ATTN_TIER_OUT
}

// A row kernel's launch (hd 1 to 24, and 25 to 32 up to N kRowWideMaxN;
// forward, or backward when `backward`)
// at the copy width `row_copy_bytes`: out = {CTAs, threads, dynamic shared
// memory bytes, resident CTAs an SM}. Returns 0, or an error code.
extern "C" int attention_row_launch(int B, int N, int H, int hd, int backward,
                                    int row_copy_bytes, int* out) {
  if (hd < 1) return kBadHeadDim;
  if (hd > 24 && hd <= kRowWideTier && N <= kRowWideMaxN)
    return row_info_width<kRowWideTier>(B, N, H, hd, backward, row_copy_bytes, out);
#define ATTN_ROW_INFO(T) \
  if (hd <= T) return row_info_width<T>(B, N, H, hd, backward, row_copy_bytes, out);
  ATTN_ROW_TIERS(ATTN_ROW_INFO)
#undef ATTN_ROW_INFO
  return kBadHeadDim;
}

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), -1 for a head dim past the
// last tier, or -2 for a row copy width that a view contradicts. q, k, v,
// o and do are [B, N, H*hd] views with unit column stride, batch stride
// *_sb and row stride *_sr in floats (the model hands over q, k, v sliced
// out of its fused qkv buffer, rows 3*D apart). At hd <= 24 the row
// kernels at hd's tier copy rows row_copy_bytes (16, 8 or 4) at a time,
// which every view's pointer and strides, and hd * 4, must be multiples
// of; below the tier, and from hd 25 on, it is ignored. The outputs o, lse
// [B, H, N], dq, dk, dv are contiguous. dq_part is the backward's [C, B,
// N, D] workspace, read only where the plan has C > 1.
extern "C" int attention_forward(const float* q, long long q_sb, long long q_sr, const float* k,
                                 long long k_sb, long long k_sr, const float* v, long long v_sb,
                                 long long v_sr, float* o, float* lse, int B, int N, int H,
                                 int hd, float scale, int row_copy_bytes, void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1) return kBadHeadDim;
  if (hd > 24 && hd <= kRowWideTier && N <= kRowWideMaxN)
    return launch_fwd<kRowWideTier>(qv, kv, vv, o, lse, B, N, H, hd, scale, row_copy_bytes, s);
#define ATTN_FWD_CASE(T) \
  if (hd <= T) return LAUNCH<T>(qv, kv, vv, o, lse, B, N, H, hd, scale, row_copy_bytes, s);
#define LAUNCH launch_fwd
  ATTN_ROW_TIERS(ATTN_FWD_CASE)
#undef LAUNCH
#define LAUNCH launch_fwd_mma
  ATTN_MMA_TIERS(ATTN_FWD_CASE)
#undef LAUNCH
#undef ATTN_FWD_CASE
  return kBadHeadDim;
}

extern "C" int attention_backward(const float* q, long long q_sb, long long q_sr, const float* k,
                                  long long k_sb, long long k_sr, const float* v, long long v_sb,
                                  long long v_sr, const float* o, long long o_sb, long long o_sr,
                                  const float* lse, const float* dout, long long do_sb,
                                  long long do_sr, float* dq, float* dk, float* dv,
                                  float* dq_part, int B, int N, int H, int hd, float scale,
                                  int row_copy_bytes, void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr}, ov{o, o_sb, o_sr},
      dov{dout, do_sb, do_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1) return kBadHeadDim;
  if (hd > 24 && hd <= kRowWideTier && N <= kRowWideMaxN)
    return launch_bwd<kRowWideTier>(qv, kv, vv, ov, lse, dov, dq, dk, dv, dq_part, B, N, H, hd,
                                    scale, row_copy_bytes, s);
#define ATTN_BWD_CASE(T)                                                                       \
  if (hd <= T)                                                                                 \
    return LAUNCH<T>(qv, kv, vv, ov, lse, dov, dq, dk, dv, dq_part, B, N, H, hd, scale,        \
                     row_copy_bytes, s);
#define LAUNCH launch_bwd
  ATTN_ROW_TIERS(ATTN_BWD_CASE)
#undef LAUNCH
#define LAUNCH launch_bwd_mma
  ATTN_MMA_TIERS(ATTN_BWD_CASE)
#undef LAUNCH
#undef ATTN_BWD_CASE
  return kBadHeadDim;
}
