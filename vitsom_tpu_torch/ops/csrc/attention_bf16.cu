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
//             and its cotangent), which the products take unrounded: a
//             float32 do is split into three bf16 parts, hi = bf16(do),
//             mid = bf16(do - hi), lo = bf16(do - hi - mid), whose sum is
//             do exactly (both residuals are exact in float32, the second
//             has at most 8 significant bits), and dp and dv take a product
//             with each, exact in float32 as JAX's float32 products with
//             the unrounded do are.
// An online softmax rescales o after the product with v, so it cannot
// round attn where JAX does: the forward kernels find a row's max and sum
// before they form attn, from scores held in registers up to N 72 (hd <=
// 16) or 320 (hd 17-64, rows that take 16-byte copies) and by a first pass
// over the keys past it (two passes: the max and l, rescaled as the max
// moves, then attn v). Only shared memory bounds N. There are no atomics
// and every sum has a fixed order, so two runs give bitwise-equal outputs.
//
// Two designs, by head dim (up to hd 16 the caller passes the plan:
// attention_fused.py: bf16_hmma_plan, bf16_hmma_score_tiles). The JAX
// kernel takes any head dim, and so do these: every hd from 1 to 192 runs
// at a tier, the first at least as wide (ATTN_BF16_TIERS below;
// attention_fused.py: bf16_tier), 2 (hd 1, 2), 8 (3-8) and 16 (9-16) in
// design 1, 64 (17-64), 128 (65-128) and 192 (129-192) in design 2. A head
// narrower than its tier is zero past hd in the staged tiles and the
// fragments, which leaves every score and sum as it is; its rows are then
// copied 2 bytes at a time (design 1: the kernels built for views off
// 16-byte copies, with a runtime hd; design 2: `narrow`, below), and its
// outputs stored a pair of columns at a time at even hd, one at odd hd.
//
// 1. hd 2, 8 and 16 (every ViT-SOM encoder and decoder below emb 192,
//    the JAX tests' 16), at any N that shared memory holds, on bf16 or
//    float32 o and do: attn_fwd_hmma_bf16 (N <= kHmmaMaxKeys = 72),
//    attn_fwd_hmma2_bf16 (past it) and attn_bwd_hmma_bf16, the bf16
//    products on the tensor cores with mma.sync (m16n8k8 at hd 2 and
//    8, m16n8k16 at hd 16 for the products over hd, m16n8k16 for those
//    over keys or queries; float32 accumulators; exact, as bf16 products
//    are in float32). hd 2 is padded to 8 with zeros in the A and B
//    fragments; its staged rows are one 32-bit word. A warp takes a
//    16-row tile, a CTA at most kHmmaWarps = 8 of a (b, h)'s tiles, spread
//    evenly (attention_fused.py: bf16_hmma_plan). The CTA stages the other
//    side's rows of the (b, h) as bf16 in shared memory by cp.async, 16
//    bytes a copy (hd 2: 4), all in flight at once, where every view takes
//    such copies (the model's q, k, v slices of its qkv buffer do), else by
//    2-byte loads (kernels instantiated for such views, the one-pass
//    forward at its largest tier); a warp reads them as B fragments, 32-bit
//    loads along hd and ldmatrix.trans for the products over rows (hd 2:
//    two 8-byte loads). An accumulator tile is the
//    A fragment of the next product, so bf16(attn), bf16(p) and bf16(ds)
//    pack straight from registers.
//    - Forward up to N 72: a tile's scores against every key stay in
//      registers, 4 floats a lane for each 8-key tile (s = q k^T, one mma
//      a tile; tiers of 2, 5, 9 tiles, which N 9, 33, 65 fill exactly;
//      keys past N score -inf), so each is formed and exponentiated once:
//      the exact row max, l = sum exp(s - m) (four partial maxima and sums
//      a row in a fixed order, then the quad's), attn = bf16(exp(s - m) /
//      l), the quotient rounded once, packed into o += attn v 16 keys at a
//      time.
//    - Forward past N 72 (two passes): the same grid and staging; a warp
//      walks the keys 64 at a time, first for the exact max and l (the
//      lane's partial sums rescaled by exp(m_old - m) as the max moves),
//      then forms the scores again for attn = bf16(exp(s - m) / l) and o +=
//      attn v. The scores are formed and exponentiated twice; l's rescaled
//      sums round differently from the one-pass form's, within the bf16
//      bound of the plain version. The split at N 72 is measured
//      (ops/attention_bf16_turns.py --shapes, both forms at N 33-197, hd 8
//      and 2, one call, L2 flushed, NVIDIA H100 80GB HBM3, 700.00 W): the
//      one-pass form is 5-9 % faster up to N 72; at N 81-136 the two are
//      within 10 % either way (the one-pass 2-10 % faster at hd 8, 18 %
//      slower at hd 2 from N 129); from N 161 the two-pass form is 12-17 %
//      faster (0.02119 against 0.02403 ms at (128, 197, 2, 8), 0.03097
//      against 0.03730 at N 257, 0.03842 against 0.07165 at N 320): the
//      one-pass form's register tiers for 17-40 tiles (127-160 registers,
//      one or two CTAs an SM) hid less latency than the two-pass form's 66
//      registers at more CTAs an SM.
//    - Backward: key-role warps (their keys' k and v as A fragments; q,
//      do, lse and delta = rowsum(do o), formed once a row, staged) and
//      query-role warps (q and do as A fragments, their rows' lse and
//      delta; k and v staged) in one launch, as in design 2, over 16 x 16
//      blocks: s^T = k q^T, dp^T = v do^T, dv += bf16(p^T) do, dk += ds^T
//      q; s = q k^T, dp = do v^T, dq += ds k. Both roles form delta, p and
//      ds with the same expressions in the same order. No atomics, no
//      float32 partials; no row of scores in registers, so any N. A float32
//      o and do (hybrid) are read a float at a time and do is split in the
//      kernel: three staged bf16 tiles in the key role, three A fragments
//      in the query role, three products for dp and for dv; the key role
//      then reads lse from global memory (L1) and stages only delta, so
//      q, do's parts and delta fit at every N the float32 kernels take.
//    Shared memory holds every N the float32 kernels (attention.cu) take
//    at the same hd: NP = 16 ceil(N / 16) rows of 4 hd bytes (forward),
//    4 hd + 8 (backward) or 8 hd + 4 (float32 do).
//    Exponentials are ex2.approx of x log2(e) (fast_exp, __expf's
//    arithmetic), subnormal results kept. ex2.approx.ftz was 11 % faster
//    (forward 0.02155 against 0.02410 ms, backward 0.02403 against 0.02678
//    at (128, 197, 2, 8); ops/attention_bf16_turns.py, one call) and
//    bitwise equal at the model-layout K1 inputs, but flushes p below
//    2^-126 to zero, where the plain version keeps them: with a quarter of
//    the keys 79-110 below the rest in scaled score (chip_smoke.py K1's
//    "far" keys; 11 % of p in float32's subnormals) it put 7.9 % of dq's
//    elements, 6.2 % of dk's and 6.1 % of dv's past 1 bf16 ulp of plain
//    (those that sum such p alone), the non-flushing form 1.4e-04,
//    2.1e-04, 1.9e-04.
//    What bounds them on the H100: the exponentials (16 a clock an SM:
//    0.00238 ms at (128, 197, 2, 8)) and the FP32 work beside each (about
//    8 instructions: the scale, max, subtraction, sum and the corrected
//    quotient), then the latency of each 16-row tile's serial phases at 16
//    warps an SM. A clock64 profile of the first version (staged by plain
//    loads, 149 registers, 4 warps a CTA) read staging 28 %, scores 3 %,
//    max 16 %, exponentials and sum 37 %, attn v 13 % of a warp's cycles;
//    cp.async staging, 8 warps a CTA at two CTAs an SM, the mask applied
//    once and ex2.ftz took the forward from 0.03136 to 0.02162 ms. Not
//    kept: two warps a tile, each with half the keys (half the registers,
//    a shared-memory exchange of m, l and o): 0.02312 ms against 0.02189;
//    two accumulators for attn v: no gain. Measured (ops/
//    attention_bf16_turns.py, one call, L2 flushed, NVIDIA H100 80GB
//    HBM3, 700.00 W; the FP32-core row kernels these replaced, one thread
//    a row with three passes over the keys, and SDPA on the same bf16
//    tensors in brackets): the one-pass forward (then the route up to N
//    320) 0.02401 ms at (128, 197, 2, 8)
//    (0.05870; 0.02293), 0.00918 at (128, 65, 2, 8) (0.01807; 0.01346),
//    0.03721 at (128, 257, 2, 8) (0.08953; 0.03765), 0.02408 at (128, 197,
//    2, 2) (0.03693; 0.04423), 0.00890 at (128, 65, 2, 2) (0.01354;
//    0.03016); backward 0.02623 (0.07100; 0.05159), 0.00966 (0.01691;
//    0.02586), 0.03845 (0.09978; 0.07802), 0.02668 (0.03526; 0.08354),
//    0.00953 (0.01064; 0.05250).
//    Past N 320 and on float32 o and do (chip_smoke.py K1, L2 flushed,
//    NVIDIA H100 80GB HBM3, 700.00 W; the FP32-core row kernels these
//    replaced, from ops/attention_bf16_turns.py against the parent tree in
//    one call, and SDPA in brackets): the two-pass forward 0.05610 ms at
//    (128, 400, 2, 8) (0.19986; 0.05781), 0.17440 at (128, 785, 2, 8)
//    (0.68136; 0.14798), 0.18518 at (128, 785, 2, 2) (0.36630; 0.18050);
//    the backward 0.06776 (0.23917; 0.12394), 0.22248 (0.80493; 0.33699),
//    0.24310 (0.35910; 0.45870); on hybrid's float32 o and do 0.03370 at
//    (128, 197, 2, 8) (0.07570), 0.03085 at (128, 197, 2, 2) (0.03534),
//    0.31522 at (128, 785, 2, 8) (0.83566). dp on the FP32 cores from the
//    float32 do (dv from the three parts), timed in the same turns: 0.05349
//    against 0.03338 ms at (128, 197, 2, 8), 0.03075 against 0.03061 at
//    hd 2: the three products kept. ptxas: the two-pass forward 61-66
//    registers, the backward 55-80 (8 bytes spilled at hd 16 on a float32
//    do), no other spills.
//
// 2. hd 17-192 (the emb-192 configs' 64 and 32, the JAX tests' 48):
//    attn_fwd_mma_bf16 (hd <= 64, N <= kMaxKeyBlocks * 64 = 320) and
//    attn_fwd_mma2_bf16 (past it, from hd 65 at every N, and for narrow
//    heads) replace _attn_fwd_kernel's bf16 branch
//    (attention_pallas.py:100), attn_bwd_mma_bf16 with its pre-pass
//    attn_delta_bf16 replaces _attn_bwd_kernel's (:163), on Hopper's
//    warpgroup products (wgmma: bf16 in, float32 accumulators; a CTA is one
//    warpgroup). Every operand is a [64][64] bf16 tile in shared memory,
//    hd padded to 64 with zeros so a row is 128 bytes, under the 128-byte
//    swizzle wgmma's descriptors name (chunk c of row r at c ^ (r mod 8)),
//    read K-major (hd contiguous) or MN-major (hd as the output's columns).
//    Tiles come in by cp.async, 16 bytes a copy, zero past N and past hd,
//    each group behind an mbarrier that its copies arrive on; a proxy fence
//    then hands them to wgmma. Where hd is not a multiple of 8 or a view's
//    rows do not start on 16-byte boundaries (`narrow`; the model's q, k,
//    v slices of its qkv buffer do at every hd that is), each thread loads
//    and stores 2-byte elements into the swizzled tiles, fences them to the
//    async proxy and arrives on the mbarrier with a plain (releasing)
//    arrive. An accumulator's fragment is the A fragment of the
//    next product (its rows, 16 columns a k-step), so bf16(attn), bf16(p)
//    and bf16(ds) are packed straight from registers into register-A
//    products: JAX's rounding points come for free.
//    - Head dims 65-192: the head is HC = 2 or 3 column tiles of 64 (kHdp
//      stays the tile's width), side by side a row block; the products over
//      hd take 4 HC k-steps, the tile of k-step kk at kk / 4. Every kernel
//      runs HC slices of 64 output columns, a CTA each (blockIdx.y), which
//      form the scores over the whole head and o (or dq, dk, dv) of their
//      columns alone: the accumulators stay 32 floats a thread, as at hd
//      64, at the cost of the scores formed HC times. The forward takes the
//      two-pass form at every N: one pass would hold 5 key blocks of k of
//      the whole head beside v (27 tiles at HC 3), and its 10 more
//      instantiations took attention_bf16.cu's nvcc from 90.8 to 109.6 s
//      (two builds on the H100 machine). The backward's key role holds k
//      and v of the whole
//      head and S ring stages of q and do's parts; at HC 3 on hybrid's
//      float32 do (three parts) two stages would take 1024 + 30 tiles of 8
//      KB, past the 232448 B a CTA may take, so it runs one stage
//      (key_stages).
//    - Head dims 17-31 run here too, padded to 64: the only design built
//      for them. At (128, 197, 8, 24) the forward takes 0.07710 ms and the
//      backward 0.25426, against the mma.sync row kernels' 0.06744 and
//      0.10600 at hd 16 on the same (B, N, H) (chip_smoke.py phase Q, L2
//      flushed, NVIDIA H100 80GB HBM3, 700.00 W): a row kernel of two
//      16-deep k-steps (hd 32) is the untried alternative.
//    - A float32 do's parts enter dp smallest first (lo, mid, hi): the
//      tensor cores truncate what they add into their accumulator, so the
//      small parts, added last into a sum as large as hi's, lost a share
//      of their bits on each add. Added last (hi first), hybrid's backward
//      at (2, 1025, 2, 192) put 1.40e-3 of dq's and dk's elements past 1
//      bf16 ulp of bwd_rounded64, and 5.8e-4 and 5.3e-4 added first
//      (chip_smoke.py phase Q's holds, NVIDIA H100 80GB HBM3, two calls;
//      the plain version's own share there is 3.6e-4).
//    - Forward up to N 320: one CTA a (b, h) reads its k and v once (NKB
//      key blocks of 64, the copies behind the first q tile so they
//      overlap its products); 64-row q tiles follow through a two-stage
//      ring. A tile's scores against every key stay in registers (s = q
//      k^T, wgmma from shared memory; the last block 8, 16, 32 or 64 keys
//      wide, as N needs: 8 at N 65, 197, 257), so each is formed and
//      exponentiated once (ex2.approx.ftz): the exact row max, l = sum
//      exp(s - m), then attn = exp(s - m) / l, the quotient rounded once
//      (p times 1 / l, corrected by its residual), packed to bf16 block by
//      block and multiplied into o = attn v as each block is ready. Warps
//      whose rows all lie past N skip the softmax; o is stored through
//      shared memory in 16-byte pieces. Two passes over the key blocks
//      measured 0.25787 ms against 0.17128 at (512, 257, 3, 64) and
//      0.01616 against 0.01381 at (128, 65, 3, 64) (one call, L2 flushed),
//      so the scores stay in registers there.
//    - Forward past N 320 (two passes): past 5 key blocks neither a tile's
//      scores fit in registers nor k and v in shared memory (17 blocks of
//      each at N 1025: 272 KB). A CTA takes one 64-row query tile (NB CTAs
//      a (b, h)); its q tile comes in once and the key blocks stream
//      through a two-stage ring, k alone in pass 1 (s = q k^T, the exact
//      max, l rescaled as the max moves) and k and v in pass 2 (the scores
//      again, attn packed into the A fragments of o += attn v); a last
//      block of at most 8 keys runs 8 wide.
//    - Backward: a pre-pass forms delta = rowsum(do o) once, in a fixed
//      order, into a float32 [B, H, N] buffer, from o and do as stored (a
//      float32 do is also split into its three bf16 parts, three arrays).
//      Then one launch of 2 ceil(N / 64) CTAs a (b, h): key-role CTAs (64
//      keys: k and v as A tiles, s^T = k q^T, dp^T = v do^T, dv +=
//      bf16(p^T) do, dk += ds^T q, dk and dv in registers) and query-role
//      CTAs (64 queries: q and do as A tiles, s = q k^T, dp = do v^T, dq +=
//      ds k); each recomputes p and ds from lse and delta, so dq needs no
//      float32 partials, no second launch and no atomics, and any N. The
//      streamed tiles pass through a two-stage ring (a tile's copies land
//      while the tile before it is worked on); a last tile of at most 8
//      rows runs 8 wide. Elements are computed without a branch of their
//      own (a ragged tile masks by selects): a branch per element
//      serialised the exponentials' chains. Its exponentials keep
//      subnormal p (fast_exp), as design 1's do. Launch bounds of three
//      CTAs an SM (168 registers).
//    What bounds them on the H100: at (512, 257, 3, 64) the work's bound is
//    its bytes (0.06080 / 0.12114 ms at 3.35 TB/s); the kernels reach 35 %
//    / 19 % of it. A 64-row tile pads N 257 to 320 rows and N 65 to 128; one
//    warpgroup a CTA and two (forward) or three (backward) CTAs an SM leave
//    the FP32 work (exponentials, the quotient, ds) and each product's
//    latency exposed. At (128, N, 3, 64) N 65's second tile (one row of 64)
//    costs 11 % in the forward (0.01382 ms against 0.01245 at N 64) and 35 %
//    in the backward (0.03840 against 0.02845). At (512, 1025, 3, 64) the
//    bound is the operations (0.418 ms at 989 TFLOP/s); the two passes'
//    exponentials alone take 0.773 ms at 16 a clock an SM.
//    Measured (one call, L2 flushed, NVIDIA H100 80GB HBM3, 700.00 W; the
//    mma.sync design these kernels replaced (three passes over the keys,
//    float32 dq partials) and SDPA on the same bf16 tensors in brackets):
//    forward 0.17211 ms at (512, 257, 3, 64) (0.69600; 0.17573), 0.16850 at (512,
//    257, 3, 32) (0.33864; 0.17517), 0.01382 at (128, 65, 3, 64) (0.02123;
//    0.01606), 0.01242 at (128, 65, 3, 32) (0.01734; 0.01552); backward
//    0.64917 (1.67715; 0.51307), 0.56707 (1.45989; 0.43149), 0.03840
//    (0.04173; 0.04043), 0.03184 (0.03384; 0.03550). The hybrid backward
//    (float32 o and do) takes 2.06896 at (512, 257, 3, 64) (2.11254) but
//    0.08741 at (128, 65, 3, 64) (0.04763): the split pass and three
//    products a part weigh most at small shapes. ptxas: the forward 214
//    registers at N 257 (5 key blocks, the last 8 wide), the backward 168,
//    no spills.
//    Past N 320 (the same K1 call): the two-pass forward 3.19387 ms at
//    (512, 1025, 3, 64) (SDPA 1.31448; its bound 0.41772 ms, the
//    operations), the backward 5.20715 (3.38722); ptxas: the two-pass
//    forward 112 registers, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBadHeadDim = -1;

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

// exp(x) as __expf forms it: ex2.approx of x log2(e), the product rounded
// to float32. Results below 2^-126 stay subnormal, as the plain version's
// do: ex2.approx.ftz (__expf), 10 % faster, flushes them to zero, which
// moves every output whose terms are all such p (the header's design 1)
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// float32 rounded to the nearest bf16 (ties to even), as float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

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


// ---------------------------------------------------------------------------
// hd >= 17: bf16 products on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWg = 128;           // threads of a tensor-core CTA: one warpgroup
constexpr int kTile = 64;          // rows of a tile: wgmma's M, and the keys of a block
constexpr int kHdp = 64;           // head dims padded to 64 bf16: rows of 128 bytes
constexpr int kMaxKeyBlocks = 5;   // the one-pass forward holds the scores of 5 * 64 keys at most
constexpr int kTileBytes = kTile * kHdp * 2;
constexpr int kSmemAlign = 1024;   // the 128-byte swizzle's period (8 rows)
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may take (ops/_build.py)
constexpr unsigned long long kWaitNs = 4000000000ull;  // a copy that never lands traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared memory from the first 1024-byte boundary of the dynamic window
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + (kSmemAlign - smem_u32(raw) % kSmemAlign) % kSmemAlign;
}

// byte offset of 16-byte chunk c of row r in a [64][64] bf16 tile under the
// 128-byte swizzle (chunk c of row r at c ^ (r mod 8)): the layout wgmma's
// descriptors below name, K-major (hd contiguous) or MN-major alike
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// the wgmma descriptor of a swizzled tile at shared address a: 128-byte
// swizzle, 1024 bytes between groups of 8 rows, leading offset unused
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the phase of `parity` to complete; trap after kWaitNs
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(a, parity))
    if (global_ns() - t0 > kWaitNs) __trap();
}

// 16 bytes from global to shared memory, zero past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// the barrier's phase completes once every thread's earlier copies have
// landed (it counts kWg arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// what the copies wrote (generic proxy) becomes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving accesses of wgmma's registers (the first
// M of d) across it
template <int M = 32, int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// an A fragment complete before the wgmma.fence that precedes its product
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= a b, 64 x 64 x 16: a [64][16] and b [64][16] K-major tiles in
// shared memory (a's rows are d's rows, b's rows d's columns)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b, 64 x 64 x 16: a from registers (the accumulator layout of a
// 64 x 16 slice, packed), b a [16][64] MN-major tile (rows are the summed
// index)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a b, 64 x W x 16 (W = 8, 16 or 32: d's first W / 2 values), as
// wgmma_ss: the forward's narrow last key block
template <int W>
__device__ __forceinline__ void wgmma_ss_narrow(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  static_assert(W == 8 || W == 16 || W == 32, "narrow widths");
  if constexpr (W == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
        "0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (W == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (+)= a b, 64 x W x 16, W = 8, 16, 32 or 64 (d's first W / 2 values)
template <int W>
__device__ __forceinline__ void wgmma_ss_w(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (W == 64) wgmma_ss(d, a, b, accumulate);
  else wgmma_ss_narrow<W>(d, a, b, accumulate);
}

#undef WG_D32
#undef WG_OUT32

// accumulator columns 16 kk .. 16 kk + 15 (chunks 2 kk, 2 kk + 1) as the A
// fragment of the next product, each value rounded to bf16; chunks from
// `chunks` on (past a narrow block) as zeros
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[32], int kk,
                                       int chunks = 8) {
  const int c0 = 8 * kk, c1 = 8 * kk + 4;
  a[0] = pack_bf16(d[c0], d[c0 + 1]);
  a[1] = pack_bf16(d[c0 + 2], d[c0 + 3]);
  a[2] = 2 * kk + 1 < chunks ? pack_bf16(d[c1], d[c1 + 1]) : 0u;
  a[3] = 2 * kk + 1 < chunks ? pack_bf16(d[c1 + 2], d[c1 + 3]) : 0u;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a bf16 element's bits, by a 2-byte load: the copies of a view whose rows
// are not 16-byte aligned (`narrow` below; WIDE false in the hd <= 16
// kernels)
__device__ __forceinline__ uint32_t ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void sts_u16(uint32_t addr, uint16_t x) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(x) : "memory");
}

// columns (col, col + 1) of a contiguous bf16 row whose head is hd wide:
// one 4-byte store where hd is even (col + 1 < hd with col, and the row's
// head starts on a 4-byte boundary), else the columns below hd one at a
// time; ANY false: hd is known to be a multiple of 8
template <bool ANY = true>
__device__ __forceinline__ void store_bf16_pair(bf16* row, int col, int hd, float a, float b) {
  if (!ANY || !(hd & 1)) {
    if (col < hd) *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(a, b);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(a);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(b);
  }
}

// a 64-row accumulator tile (rows r0 ..) as bf16 rows of out (row i at out
// + i * D, the first `cols` columns, rows below N), through shared memory:
// each warp writes its 16 rows to its part of the swizzled tile at `tile`,
// then stores them 16 bytes a lane, a row's 8 lanes side by side, or
// (`narrow`: rows that do not start on 16-byte boundaries) 2 bytes a lane
template <bool NARROW>
__device__ __forceinline__ void store_rows(uint8_t* tile, const float (&acc)[32], bf16* out,
                                           long long D, int r0, int N, int cols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  uint8_t* ow = tile + warp * 16 * 128;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint32_t*>(ow + swz(g + 8 * r, c) + 4 * t4) =
          pack_bf16(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  __syncwarp();
  if constexpr (!NARROW) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = lane + 32 * u, r = e >> 3, c = e & 7, i = r0 + 16 * warp + r;
      if (i < N && 8 * c < cols)
        *reinterpret_cast<uint4*>(out + i * D + 8 * c) = *reinterpret_cast<const uint4*>(ow + swz(r, c));
    }
    return;
  }
#pragma unroll 4
  for (int u = 0; u < 32; ++u) {
    const int e = lane + 32 * u, r = e >> 6, cc = e & 63, i = r0 + 16 * warp + r;
    if (i < N && cc < cols)
      out[i * D + cc] = *reinterpret_cast<const bf16*>(ow + swz(r, cc >> 3) + 2 * (cc & 7));
  }
}

// rows [r0, r0 + 64) of the 64 columns from `col` of a bf16 view -> a
// swizzled tile at shared address dst, zero past row N and past the `cols`
// columns that exist (the head's hd); 16 bytes a copy by cp.async, 4 a
// thread, 8 threads a row, or (`narrow`: a head whose width or rows are off
// 16-byte boundaries) a 2-byte load and store an element, 32 a thread
template <bool NARROW>
__device__ __forceinline__ void load_tile(uint32_t dst, const View<bf16>& x, int b, int col,
                                          int r0, int N, int cols) {
  if constexpr (!NARROW) {
#pragma unroll
    for (int u = 0; u < kTile * 8 / kWg; ++u) {
      const int e = threadIdx.x + kWg * u, r = e >> 3, c = e & 7;
      const bool in = r0 + r < N && 8 * c < cols;
      cp_async16(dst + swz(r, c), in ? row_ptr(x, b, r0 + r, col + 8 * c) : x.ptr, in ? 16 : 0);
    }
    return;
  }
#pragma unroll 8
  for (int u = 0; u < kTile * kHdp / kWg; ++u) {
    const int e = threadIdx.x + kWg * u, r = e >> 6, cc = e & 63;
    const bool in = r0 + r < N && cc < cols;
    sts_u16(dst + swz(r, cc >> 3) + 2 * (cc & 7), in ? ldg_u16(row_ptr(x, b, r0 + r, col + cc)) : 0);
  }
}

// this thread's arrival on `bar` once its copies of the phase have landed:
// cp.async's arrive, or (`narrow`: plain loads and stores) a proxy fence
// that hands the stores to wgmma and an arrive that releases them
template <bool NARROW>
__device__ __forceinline__ void tile_arrive(uint64_t* bar) {
  if constexpr (!NARROW) {
    cp_async_arrive(bar);
    return;
  }
  fence_async_smem();
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the byte offset of k-step kk (16 columns) of a row block held as HC
// column tiles side by side (each [64][64], hd padded to 64 HC)
__device__ __forceinline__ uint32_t kstep(int kk) { return (kk >> 2) * kTileBytes + 32 * (kk & 3); }

// o (bf16) and lse of one (b, h) at hd 17-64: a CTA of one warpgroup. k and
// v of every key come in once (cp.async into swizzled tiles, one mbarrier
// each) behind the first query tile; query tiles of 64 rows follow through
// a two-stage ring. A tile's scores against all keys stay in registers
// (wgmma: s = q k^T; NKB blocks, the last TW keys wide), so each is formed
// and exponentiated once: the exact row max, l = sum exp(s - m), attn =
// bf16(exp(s - m) / l) packed straight into the A fragments of o = attn v
// (wgmma, v MN-major). Heads whose rows take 16-byte copies alone (a
// narrow head runs the two-pass form).
template <int NKB, int TW>
__global__ void __launch_bounds__(kWg)
attn_fwd_mma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                  float* __restrict__ lse, int N, int H, int hd, float scale) {
  constexpr int kLastChunks = TW / 8;  // 8-key chunks of the last block
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  // k blocks, v blocks, two q tiles, then four mbarriers and the o tile
  const uint32_t ks = smem_u32(sm), vs = ks + NKB * kTileBytes, qs = vs + NKB * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + (2 * NKB + 2) * kTileBytes);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, col0 = h * hd;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(bars + i, kWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // query tile t into ring stage st (k, v and q: bars 0, 1 and 2 + st)
  auto load_q = [&](int st, int t) {
    load_tile<false>(qs + st * kTileBytes, q, b, col0, kTile * t, N, hd);
    tile_arrive<false>(bars + 2 + st);
  };
  load_q(0, 0);
#pragma unroll
  for (int j = 0; j < NKB; ++j)
    load_tile<false>(ks + j * kTileBytes, k, b, col0, kTile * j, N, hd);
  tile_arrive<false>(bars);
#pragma unroll
  for (int j = 0; j < NKB; ++j)
    load_tile<false>(vs + j * kTileBytes, v, b, col0, kTile * j, N, hd);
  tile_arrive<false>(bars + 1);
  if (NKB > 1) load_q(1, 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const long long D = (long long)H * hd;
  for (int t = 0; t < NKB; ++t) {  // query tiles: as many as key blocks
    const int st = t & 1;
    const uint32_t qt = qs + st * kTileBytes;
    mbar_wait(bars + 2 + st, (t >> 1) & 1);
    if (t == 0) mbar_wait(bars, 0);
    fence_async_smem();
    float s[NKB][32];  // the last block's first TW / 2 values
    wg_fence();
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int kk = 0; kk < kHdp / 16; ++kk) {
        const uint64_t a = desc(qt + 32 * kk), bk = desc(ks + j * kTileBytes + 32 * kk);
        if (j < NKB - 1) wgmma_ss(s[j], a, bk, kk);
        else wgmma_ss_w<TW>(s[j], a, bk, kk);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < NKB - 1; ++j) fence_regs(s[j]);
    fence_regs<TW / 2>(s[NKB - 1]);
    __syncthreads();  // every warp's products are done with the q tile
    if (t + 2 < NKB) load_q(st, t + 2);

    // s[j][4c + e]: row g + 8 (e / 2) of this warp's 16, key 64 j + 8 c +
    // 2 t4 + (e & 1). Only the last block has keys past N: it alone is
    // masked, by selects, so no element sits behind a branch of its own
    // (which would serialise each exponential's chain). Four partial
    // maxima and sums a row shorten the dependent chains. A warp whose rows
    // all lie past N (the last tile) skips the softmax: its rows are not
    // stored.
    const bool live = kTile * t + 16 * warp < N;  // warp-uniform
    float m[2] = {0.f, 0.f}, l[2] = {1.f, 1.f};
    if (live) {
      float mp[2][4], lp[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) mp[r][u] = -INFINITY, lp[r][u] = 0.f;
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (j == NKB - 1 && c >= kLastChunks) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(s[j][4 * c + e], scale);
            s[j][4 * c + e] = x;
            if (j == NKB - 1 && kTile * j + 8 * c + 2 * t4 + (e & 1) >= N) x = -INFINITY;
            mp[e / 2][c & 3] = fmaxf(mp[e / 2][c & 3], x);
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])));
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (j == NKB - 1 && c >= kLastChunks) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = __expf(s[j][4 * c + e] - m[e / 2]);
            if (j == NKB - 1 && kTile * j + 8 * c + 2 * t4 + (e & 1) >= N) p = 0.f;
            s[j][4 * c + e] = p;
            lp[e / 2][c & 3] += p;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = quad_sum((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
    }

    // attn = p / l rounded once (q0 = p (1 / l), corrected by its
    // residual), packed to bf16 as the A fragments of o = attn v; each
    // block's products are issued as soon as it is packed, so the next
    // block's division overlaps them
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    if (t == 0) {
      mbar_wait(bars + 1, 0);
      fence_async_smem();
    }
    float acc[32];
    uint32_t af[NKB][4][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
      const int chunks = j < NKB - 1 ? 8 : kLastChunks, steps = (chunks + 1) / 2;
      if (live) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c >= chunks) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = s[j][4 * c + e], q0 = p * rl[e / 2];
            s[j][4 * c + e] = fmaf(fmaf(-q0, l[e / 2], p), rl[e / 2], q0);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= steps) continue;
        pack_a(af[j][kk], s[j], kk, chunks);
        fence_regs(af[j][kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps && kTile * j + 16 * kk < N)
          wgmma_rs(acc, af[j][kk], desc(vs + j * kTileBytes + 2048 * kk), j + kk);
    }
    wg_commit();
    wg_wait();
    fence_regs(acc);

    store_rows<false>(reinterpret_cast<uint8_t*>(bars) + 128, acc, o + (long long)b * N * D + col0,
                      D, kTile * t, N, hd);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = kTile * t + 16 * warp + g + 8 * r;
      if (i < N && t4 == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
    }
  }
}

// The two-pass forward's row statistics over one key block of W keys
// (keys k0 ..): s scaled in place, the running row max m (exact, as the
// one-pass form's) and the lane's partial l, rescaled by exp(m_old - m) as
// the max moves, plus the block's exp(s - m) in four partial sums a row.
// kMask (the block holds keys past N): those score -inf.
template <bool kMask, int W>
__device__ __forceinline__ void block_stats(float (&s)[32], float (&m)[2], float (&l)[2], int k0,
                                            int N, float scale) {
  const int t4 = threadIdx.x % 4;
  float mp[2][4], lp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mp[r][u] = -INFINITY, lp[r][u] = 0.f;
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[4 * c + e], scale);
      if (kMask && k0 + 8 * c + 2 * t4 + (e & 1) >= N) x = -INFINITY;
      s[4 * c + e] = x;
      mp[e / 2][c & 3] = fmaxf(mp[e / 2][c & 3], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn =
        fmaxf(m[r], quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]))));
    alpha[r] = __expf(m[r] - mn);  // 0 at the first block (m -inf)
    m[r] = mn;
  }
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) lp[e / 2][c & 3] += __expf(s[4 * c + e] - m[e / 2]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], alpha[r], (lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
}

// The two-pass forward's attn = exp(s scale - m) / l over one key block,
// in place of s, the quotient rounded once as the one-pass form rounds it;
// kMask: keys past N give 0, by selects
template <bool kMask, int W>
__device__ __forceinline__ void block_attn(float (&s)[32], const float (&m)[2], const float (&l)[2],
                                           const float (&rl)[2], int k0, int N, float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = __expf(__fmul_rn(s[4 * c + e], scale) - m[e / 2]);
      if (kMask && k0 + 8 * c + 2 * t4 + (e & 1) >= N) p = 0.f;
      const float q0 = p * rl[e / 2];
      s[4 * c + e] = fmaf(fmaf(-q0, l[e / 2], p), rl[e / 2], q0);
    }
}

// o (bf16) and lse past kMaxKeyBlocks * 64 keys, where a tile's scores
// against every key no longer fit in registers (nor k and v in shared
// memory), and at every N from hd 65 on (the head in HC column tiles, each
// slice's CTAs forming the scores again): a
// CTA of one warpgroup a 64-row query tile and a 64-column slice of o,
// blockIdx.x = (b H + h) NB + t (NB = ceil(N / 64)), blockIdx.y the slice.
// The q tile comes in once; the key blocks stream through a two-stage
// ring, k alone in pass 1, k and the slice's v in pass 2. Pass 1 forms s =
// q k^T block by block (wgmma from shared memory), the exact row max m and
// l = sum exp(s - m), rescaled as the max moves. Pass 2 forms the scores
// again, attn = bf16(exp(s - m) / l) packed straight into the A fragments
// of o += attn v (wgmma, v MN-major), so attn is rounded where JAX rounds
// it: a one-pass online softmax would round exp(s - m_running) and rescale
// the sum of products afterwards. The last block runs 8 keys wide where N
// leaves at most 8 in it.
template <int HC, bool NARROW>
__global__ void __launch_bounds__(kWg, 4)
attn_fwd_mma2_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                   float* __restrict__ lse, int N, int H, int hd, float scale) {
  constexpr int kStage = HC + 1;  // tiles of a ring stage: k's HC, the slice's v
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  // q, the ring's two stages of (k, v), the o tile, then three mbarriers
  const uint32_t qs = smem_u32(sm), ring = qs + HC * kTileBytes;
  uint8_t* ot = sm + (HC + 2 * kStage) * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ot + kTileBytes);  // q, stage 0, stage 1
  const int nb = (N + kTile - 1) / kTile;
  const int bh = blockIdx.x / nb, t = blockIdx.x - bh * nb;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int sc = HC == 1 ? 0 : kHdp * blockIdx.y;  // the slice's first column in the head
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, kWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // ring item u: key block u of pass 1 (k), then block u - nb of pass 2 (k, v)
  auto fill = [&](int u) {
    const int st = u & 1, j = u < nb ? u : u - nb;
    const uint32_t base = ring + st * kStage * kTileBytes;
#pragma unroll
    for (int c = 0; c < HC; ++c)
      load_tile<NARROW>(base + c * kTileBytes, k, b, col0 + kHdp * c, kTile * j, N,
                        hd - kHdp * c);
    if (u >= nb)
      load_tile<NARROW>(base + HC * kTileBytes, v, b, col0 + sc, kTile * j, N, hd - sc);
    tile_arrive<NARROW>(bars + 1 + st);
  };
#pragma unroll
  for (int c = 0; c < HC; ++c)
    load_tile<NARROW>(qs + c * kTileBytes, q, b, col0 + kHdp * c, kTile * t, N, hd - kHdp * c);
  tile_arrive<NARROW>(bars);
  fill(0);
  fill(1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // a warp whose rows all lie past N (the last tile) skips the softmax:
  // its rows are not stored
  const bool live = kTile * t + 16 * warp < N;  // warp-uniform
  // s = q k^T of ring item u, W keys wide (s's first W / 2 values)
  auto scores = [&](auto width, int u, float(&s)[32]) {
    constexpr int W = decltype(width)::value;
    const int st = u & 1;
    mbar_wait(bars + 1 + st, (u >> 1) & 1);
    if (u == 0) mbar_wait(bars, 0);
    fence_async_smem();
    const uint32_t kt = ring + st * kStage * kTileBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HC; ++kk)
      wgmma_ss_w<W>(s, desc(qs + kstep(kk)), desc(kt + kstep(kk)), kk);
    wg_commit();
    wg_wait();
    fence_regs<W / 2>(s);
  };
  // every warp's products are done with item u's stage: refill it
  auto release = [&](int u) {
    __syncthreads();
    if (u + 2 < 2 * nb) fill(u + 2);
  };
  const bool narrow_last = N - kTile * (nb - 1) <= 8;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto pass1 = [&](auto width, int j) {
    constexpr int W = decltype(width)::value;
    float s[32];
    scores(width, j, s);
    release(j);
    if (!live) return;
    if (kTile * (j + 1) <= N) block_stats<false, W>(s, m, l, kTile * j, N, scale);
    else block_stats<true, W>(s, m, l, kTile * j, N, scale);
  };
  for (int j = 0; j < nb - 1; ++j) pass1(std::integral_constant<int, kTile>(), j);
  if (narrow_last) pass1(std::integral_constant<int, 8>(), nb - 1);
  else pass1(std::integral_constant<int, kTile>(), nb - 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = live ? quad_sum(l[r]) : 1.f;
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  float acc[32];
  auto pass2 = [&](auto width, int j) {
    constexpr int W = decltype(width)::value, kSteps = (W / 8 + 1) / 2;
    const int u = nb + j;
    float s[32];
    scores(width, u, s);
    if (live) {
      if (kTile * (j + 1) <= N) block_attn<false, W>(s, m, l, rl, kTile * j, N, scale);
      else block_attn<true, W>(s, m, l, rl, kTile * j, N, scale);
    }
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      pack_a(af[kk], s, kk, W / 8);
      fence_regs(af[kk]);
    }
    const uint32_t vt = ring + ((u & 1) * kStage + HC) * kTileBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      if (kTile * j + 16 * kk < N) wgmma_rs(acc, af[kk], desc(vt + 2048 * kk), j + kk);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    release(u);
  };
  for (int j = 0; j < nb - 1; ++j) pass2(std::integral_constant<int, kTile>(), j);
  if (narrow_last) pass2(std::integral_constant<int, 8>(), nb - 1);
  else pass2(std::integral_constant<int, kTile>(), nb - 1);

  const long long D = (long long)H * hd;
  store_rows<NARROW>(ot, acc, o + (long long)b * N * D + col0 + sc, D, kTile * t, N, hd - sc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = kTile * t + 16 * warp + g + 8 * r;
    if (i < N && t4 == 0 && sc == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
  }
}

// delta = rowsum(do * o) of each (b, i, h), a thread each, summed over the
// head's columns in order (16-byte loads, or with `narrow` an element at a
// time: the same sum). A float32 do (hybrid) is also split into three bf16
// parts, hi = bf16(do), mid = bf16(do - hi), lo = bf16(do - hi - mid), whose
// sum is do exactly (both residuals are exact in float32, the second has at
// most 8 significant bits): split[p] is a contiguous [B, N, H * hd] bf16
// array.
template <typename TO>
__global__ void attn_delta_bf16(View<TO> o, View<TO> dout, float* __restrict__ delta,
                                bf16* __restrict__ split, int B, int N, int H, int hd,
                                int narrow) {
  constexpr int VW = 16 / sizeof(TO);
  constexpr bool kF32 = std::is_same<TO, float>::value;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)B * N * H) return;
  const int h = (int)(e % H);
  const long long bi = e / H;
  const int i = (int)(bi % N), b = (int)(bi / N), col0 = h * hd;
  const long long D = (long long)H * hd, n_all = (long long)B * N * D;
  float x = 0.f;
  if (narrow) {
    for (int d = 0; d < hd; ++d) {
      float a, c;
      if constexpr (kF32) {
        a = __ldg(row_ptr(o, b, i, col0 + d));
        c = __ldg(row_ptr(dout, b, i, col0 + d));
        const float hi = round_bf16(c), rest = c - hi, mid = round_bf16(rest);
        const long long off = bi * D + col0 + d;
        split[off] = __float2bfloat16_rn(hi);
        split[n_all + off] = __float2bfloat16_rn(mid);
        split[2 * n_all + off] = __float2bfloat16_rn(round_bf16(rest - mid));
      } else {
        a = __bfloat162float(*row_ptr(o, b, i, col0 + d));
        c = __bfloat162float(*row_ptr(dout, b, i, col0 + d));
      }
      x = fmaf(c, a, x);
    }
    delta[((long long)b * H + h) * N + i] = x;
    return;
  }
  for (int d0 = 0; d0 < hd; d0 += VW) {
    float a[VW], c[VW];
    if constexpr (kF32) {
      const float4 oa = __ldg(reinterpret_cast<const float4*>(row_ptr(o, b, i, col0 + d0)));
      const float4 ca = __ldg(reinterpret_cast<const float4*>(row_ptr(dout, b, i, col0 + d0)));
      a[0] = oa.x; a[1] = oa.y; a[2] = oa.z; a[3] = oa.w;
      c[0] = ca.x; c[1] = ca.y; c[2] = ca.z; c[3] = ca.w;
      uint32_t w[3][2];
#pragma unroll
      for (int u = 0; u < VW; u += 2) {
        float hi[2], mid[2], lo[2];
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          hi[z] = round_bf16(c[u + z]);
          const float rest = c[u + z] - hi[z];
          mid[z] = round_bf16(rest);
          lo[z] = round_bf16(rest - mid[z]);
        }
        w[0][u / 2] = pack_bf16(hi[0], hi[1]);
        w[1][u / 2] = pack_bf16(mid[0], mid[1]);
        w[2][u / 2] = pack_bf16(lo[0], lo[1]);
      }
      const long long off = bi * D + col0 + d0;
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(split + p * n_all + off) = make_uint2(w[p][0], w[p][1]);
    } else {
      ldg_bf16<8>(row_ptr(o, b, i, col0 + d0), a);
      ldg_bf16<8>(row_ptr(dout, b, i, col0 + d0), c);
    }
#pragma unroll
    for (int u = 0; u < VW; ++u) x = fmaf(c[u], a[u], x);
  }
  delta[((long long)b * H + h) * N + i] = x;
}

// The key role's p^T = exp(s^T scale - lse) and ds^T = p^T (dp^T - delta)
// scale in place of s^T and dp^T: s[4c + e] is key `key` + 8 (e / 2),
// query q0 + 8 c + 2 t4 + (e & 1) (tile column 8 c + 2 t4 + (e & 1) of the
// staged lse and delta), c below W / 8 (a tile of W queries). With kMask
// (a ragged tile) keys and queries past N give 0, by selects: no element
// sits behind a branch of its own.
template <bool kMask, int W>
__device__ __forceinline__ void key_elems(float (&s)[32], float (&dp)[32], const float* lse_t,
                                          const float* del_t, int key, int q0, int N,
                                          float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int col = 8 * c + 2 * t4 + z;
      const float ls = lse_t[col], dl = del_t[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + z;
        const float p = fast_exp(__fmul_rn(s[4 * c + e], scale) - ls);
        const float ds = p * (dp[4 * c + e] - dl) * scale;
        const bool in = !kMask || (key + 8 * r < N && q0 + col < N);
        s[4 * c + e] = in ? p : 0.f;
        dp[4 * c + e] = in ? ds : 0.f;
      }
    }
}

// The query role's ds = p (dp - delta) scale in place of dp: s[4c + e] is
// query `row` + 8 (e / 2) (lse_r, del_r), key k0 + 8 c + 2 t4 + (e & 1),
// c below W / 8; masked as key_elems.
template <bool kMask, int W>
__device__ __forceinline__ void query_elems(const float (&s)[32], float (&dp)[32],
                                            const float (&lse_r)[2], const float (&del_r)[2],
                                            int row, int k0, int N, float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      const float p = fast_exp(__fmul_rn(s[4 * c + e], scale) - lse_r[r]);
      const float ds = p * (dp[4 * c + e] - del_r[r]) * scale;
      const bool in = !kMask || (row + 8 * r < N && k0 + 8 * c + 2 * t4 + (e & 1) < N);
      dp[4 * c + e] = in ? ds : 0.f;
    }
}

// do as DP bf16 views: do itself (DP = 1), or its three parts (DP = 3)
struct DoParts {
  View<bf16> p[3];
};

// the key role's ring stages: two where a second stage of q and do's parts
// fits in shared memory beside k and v, else one (hd 129-192 on hybrid's
// float32 do: its three parts)
__host__ __device__ constexpr int key_stages(int HC, int DP) {
  return kSmemAlign + (2 * HC + 2 * HC * (1 + DP)) * kTileBytes + 2 * 2 * kTile * 4 + 3 * 8 <=
                 kSmemLimit
             ? 2
             : 1;
}

// Backward, key role: dk and dv of keys 64 kt .. 64 kt + 63 of (b, h), the
// 64 columns of the slice (blockIdx.y). k and v are wgmma A tiles (all HC
// column tiles); the query tiles (q, do's parts, lse and delta) stream
// through a ring of S stages. s^T = k q^T and dp^T = v do^T (SS, over the
// whole head), p^T = exp(s^T scale - lse), ds^T = bf16(p^T (dp^T - delta)
// scale); then dv += bf16(p^T) do and dk += ds^T q over the slice's
// columns with A from registers (RS, do and q MN-major).
template <int DP, int HC, bool NARROW>
__device__ __forceinline__ void bwd_keys(uint8_t* sm, const View<bf16>& q, const View<bf16>& k,
                                         const View<bf16>& v, const DoParts& dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, int b, int h, int kt, int N,
                                         int H, int hd, float scale) {
  constexpr int S = key_stages(HC, DP);
  constexpr int kStage = HC * (1 + DP);  // tiles of a ring stage: q, do's parts
  constexpr int kTiles = 2 * HC + S * kStage;
  const uint32_t s0 = smem_u32(sm);
  float* ring_f = reinterpret_cast<float*>(sm + kTiles * kTileBytes);  // [S][lse 64, delta 64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_f + S * 2 * kTile);  // k and v, S stages
  const int bh = b * H + h, col0 = h * hd, nt = (N + kTile - 1) / kTile;
  const int sl = HC == 1 ? 0 : blockIdx.y, sc = kHdp * sl;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + S; ++i) mbar_init(bars + i, kWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int st, int it) {
    const uint32_t base = s0 + (2 * HC + st * kStage) * kTileBytes;
#pragma unroll
    for (int c = 0; c < HC; ++c)
      load_tile<NARROW>(base + c * kTileBytes, q, b, col0 + kHdp * c, kTile * it, N,
                        hd - kHdp * c);
#pragma unroll
    for (int p = 0; p < DP; ++p)
#pragma unroll
      for (int c = 0; c < HC; ++c)
        load_tile<NARROW>(base + (HC * (1 + p) + c) * kTileBytes, dout.p[p], b,
                          col0 + kHdp * c, kTile * it, N, hd - kHdp * c);
    const int i = kTile * it + threadIdx.x % kTile;
    const float* src = (threadIdx.x < kTile ? lse : delta) + (long long)bh * N + min(i, N - 1);
    if constexpr (NARROW) ring_f[st * 2 * kTile + threadIdx.x] = i < N ? *src : 0.f;
    else cp_async4(smem_u32(ring_f + st * 2 * kTile + threadIdx.x), src, i < N ? 4 : 0);
    tile_arrive<NARROW>(bars + 1 + st);
  };
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    load_tile<NARROW>(s0 + c * kTileBytes, k, b, col0 + kHdp * c, kTile * kt, N, hd - kHdp * c);
    load_tile<NARROW>(s0 + (HC + c) * kTileBytes, v, b, col0 + kHdp * c, kTile * kt, N,
                      hd - kHdp * c);
  }
  tile_arrive<NARROW>(bars);
  fill(0, 0);
  if (S > 1 && nt > 1) fill(1, 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int kw = kTile * kt + 16 * warp;  // this warp's first key
  float dka[32], dva[32];
  // one query tile, W queries wide: 64, or 8 for a last tile of at most 8
  // queries (N 65, 197, 257), whose products and elements shrink to match
  auto step = [&](auto width, int it) {
    constexpr int W = decltype(width)::value, kSteps = (W / 8 + 1) / 2;
    const int st = static_cast<unsigned>(it) % S;
    const uint32_t qt = s0 + (2 * HC + st * kStage) * kTileBytes;
    mbar_wait(bars + 1 + st, (static_cast<unsigned>(it) / S) & 1);
    if (it == 0) mbar_wait(bars, 0);
    fence_async_smem();
    float s[32], dp[32];  // the first W / 2 of each
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HC; ++kk)
      wgmma_ss_w<W>(s, desc(s0 + kstep(kk)), desc(qt + kstep(kk)), kk);
    // do's parts smallest first: each lands while the sum is still as
    // small as it, so the tensor cores' truncating adds lose less of it
#pragma unroll
    for (int p = DP - 1; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < 4 * HC; ++kk)
        wgmma_ss_w<W>(dp, desc(s0 + HC * kTileBytes + kstep(kk)),
                      desc(qt + HC * (1 + p) * kTileBytes + kstep(kk)), DP - 1 - p + kk);
    wg_commit();
    wg_wait();
    fence_regs<W / 2>(s);
    fence_regs<W / 2>(dp);

    // a warp whose keys all lie past N skips: row j of dk and dv takes row
    // j of p^T and ds^T alone, and those rows are not stored
    const float* lse_t = ring_f + st * 2 * kTile;
    if (kw < N) {
      if (kTile * (kt + 1) <= N && kTile * it + W <= N)  // CTA-uniform
        key_elems<false, W>(s, dp, lse_t, lse_t + kTile, kw + g, kTile * it, N, scale);
      else
        key_elems<true, W>(s, dp, lse_t, lse_t + kTile, kw + g, kTile * it, N, scale);
    }
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      pack_a(pf[kk], s, kk, W / 8);
      pack_a(sf[kk], dp, kk, W / 8);
      fence_regs(pf[kk]);
      fence_regs(sf[kk]);
    }
    wg_fence();
#pragma unroll
    for (int p = 0; p < DP; ++p)
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        if (kTile * it + 16 * kk < N)
          wgmma_rs(dva, pf[kk], desc(qt + (HC * (1 + p) + sl) * kTileBytes + 2048 * kk),
                   it + p + kk);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      if (kTile * it + 16 * kk < N)
        wgmma_rs(dka, sf[kk], desc(qt + sl * kTileBytes + 2048 * kk), it + kk);
    wg_commit();
    wg_wait();
    fence_regs(dka);
    fence_regs(dva);
    __syncthreads();  // every warp's products are done with the stage
    if (it + S < nt) fill(st, it + S);
  };
  for (int it = 0; it < nt - 1; ++it) step(std::integral_constant<int, kTile>(), it);
  if (N - kTile * (nt - 1) <= 8) step(std::integral_constant<int, 8>(), nt - 1);
  else step(std::integral_constant<int, kTile>(), nt - 1);

  const long long D = (long long)H * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kw + g + 8 * r;
    if (j >= N) continue;
    const long long off = ((long long)b * N + j) * D + col0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      store_bf16_pair<NARROW>(dk + off, sc + 8 * c + 2 * t4, hd, dka[4 * c + 2 * r],
                              dka[4 * c + 2 * r + 1]);
      store_bf16_pair<NARROW>(dv + off, sc + 8 * c + 2 * t4, hd, dva[4 * c + 2 * r],
                              dva[4 * c + 2 * r + 1]);
    }
  }
}

// Backward, query role: dq of queries 64 qt .. 64 qt + 63 of (b, h), the 64
// columns of the slice. q and do's parts are wgmma A tiles (all HC column
// tiles); the key tiles (k, v) stream through a two-stage ring. s = q k^T,
// dp = do v^T (SS), p and ds as the key role forms them (from the query's
// side), dq += ds k over the slice's columns (RS, k MN-major).
template <int DP, int HC, bool NARROW>
__device__ __forceinline__ void bwd_queries(uint8_t* sm, const View<bf16>& q, const View<bf16>& k,
                                            const View<bf16>& v, const DoParts& dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            bf16* __restrict__ dq, int b, int h, int qt, int N,
                                            int H, int hd, float scale) {
  constexpr int kOwn = HC * (1 + DP);  // q and do's parts; then the ring's k, v tiles
  constexpr int kStage = 2 * HC;
  const uint32_t s0 = smem_u32(sm);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + (kOwn + 2 * kStage) * kTileBytes);
  const int bh = b * H + h, col0 = h * hd, nt = (N + kTile - 1) / kTile;
  const int sl = HC == 1 ? 0 : blockIdx.y, sc = kHdp * sl;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, kWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int st, int jt) {
    const uint32_t base = s0 + (kOwn + st * kStage) * kTileBytes;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      load_tile<NARROW>(base + c * kTileBytes, k, b, col0 + kHdp * c, kTile * jt, N,
                        hd - kHdp * c);
      load_tile<NARROW>(base + (HC + c) * kTileBytes, v, b, col0 + kHdp * c, kTile * jt, N,
                        hd - kHdp * c);
    }
    tile_arrive<NARROW>(bars + 1 + st);
  };
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    load_tile<NARROW>(s0 + c * kTileBytes, q, b, col0 + kHdp * c, kTile * qt, N, hd - kHdp * c);
#pragma unroll
    for (int p = 0; p < DP; ++p)
      load_tile<NARROW>(s0 + (HC * (1 + p) + c) * kTileBytes, dout.p[p], b, col0 + kHdp * c,
                        kTile * qt, N, hd - kHdp * c);
  }
  tile_arrive<NARROW>(bars);
  fill(0, 0);
  if (nt > 1) fill(1, 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int qw = kTile * qt + 16 * warp;  // this warp's first query
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = min(qw + g + 8 * r, N - 1);
    lse_r[r] = lse[(long long)bh * N + i];
    del_r[r] = delta[(long long)bh * N + i];
  }
  float dqa[32];
  // one key tile, W keys wide (as the key role's step)
  auto step = [&](auto width, int jt) {
    constexpr int W = decltype(width)::value, kSteps = (W / 8 + 1) / 2;
    const int st = jt & 1;
    const uint32_t kt_s = s0 + (kOwn + st * kStage) * kTileBytes, vt_s = kt_s + HC * kTileBytes;
    mbar_wait(bars + 1 + st, (jt >> 1) & 1);
    if (jt == 0) mbar_wait(bars, 0);
    fence_async_smem();
    float s[32], dp[32];  // the first W / 2 of each
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HC; ++kk)
      wgmma_ss_w<W>(s, desc(s0 + kstep(kk)), desc(kt_s + kstep(kk)), kk);
#pragma unroll
    for (int p = DP - 1; p >= 0; --p)  // smallest first, as the key role's
#pragma unroll
      for (int kk = 0; kk < 4 * HC; ++kk)
        wgmma_ss_w<W>(dp, desc(s0 + HC * (1 + p) * kTileBytes + kstep(kk)), desc(vt_s + kstep(kk)),
                      DP - 1 - p + kk);
    wg_commit();
    wg_wait();
    fence_regs<W / 2>(s);
    fence_regs<W / 2>(dp);

    if (qw < N) {  // else as the key role's skip: its rows are not stored
      if (kTile * (qt + 1) <= N && kTile * jt + W <= N)  // CTA-uniform
        query_elems<false, W>(s, dp, lse_r, del_r, qw + g, kTile * jt, N, scale);
      else
        query_elems<true, W>(s, dp, lse_r, del_r, qw + g, kTile * jt, N, scale);
    }
    uint32_t sf[4][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      pack_a(sf[kk], dp, kk, W / 8);
      fence_regs(sf[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      if (kTile * jt + 16 * kk < N)
        wgmma_rs(dqa, sf[kk], desc(kt_s + sl * kTileBytes + 2048 * kk), jt + kk);
    wg_commit();
    wg_wait();
    fence_regs(dqa);
    __syncthreads();  // every warp's products are done with the stage
    if (jt + 2 < nt) fill(st, jt + 2);
  };
  for (int jt = 0; jt < nt - 1; ++jt) step(std::integral_constant<int, kTile>(), jt);
  if (N - kTile * (nt - 1) <= 8) step(std::integral_constant<int, 8>(), nt - 1);
  else step(std::integral_constant<int, kTile>(), nt - 1);

  const long long D = (long long)H * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + g + 8 * r;
    if (i >= N) continue;
    bf16* row = dq + ((long long)b * N + i) * D + col0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      store_bf16_pair<NARROW>(row, sc + 8 * c + 2 * t4, hd, dqa[4 * c + 2 * r],
                              dqa[4 * c + 2 * r + 1]);
  }
}

// 2 ceil(N / 64) CTAs a (b, h) and slice: blockIdx.x = (b H + h) 2 T + r,
// the key role for r < T (key tile r), the query role after (query tile
// r - T); blockIdx.y the slice of 64 output columns
template <int DP, int HC, bool NARROW>
__global__ void __launch_bounds__(kWg, 3)
attn_bwd_mma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, DoParts dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                  int H, int hd, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const int nt = (N + kTile - 1) / kTile;
  const int bh = blockIdx.x / (2 * nt), r = blockIdx.x - bh * 2 * nt;
  const int b = bh / H, h = bh - b * H;
  if (r < nt)
    bwd_keys<DP, HC, NARROW>(sm, q, k, v, dout, lse, delta, dk, dv, b, h, r, N, H, hd, scale);
  else
    bwd_queries<DP, HC, NARROW>(sm, q, k, v, dout, lse, delta, dq, b, h, r - nt, N, H, hd, scale);
}


// ---------------------------------------------------------------------------
// hd <= 16: bf16 products on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kHmmaWarps = 8;      // warps of an hd <= 16 tensor-core CTA at most
constexpr int kHmmaMaxKeys = 72;  // the one-pass forward's N at most: a row's scores in registers
constexpr int kBadPlan = -4;

// the forward's register tiers: 8-key tiles of scores a warp holds, 4
// floats a lane each (attention_fused.py: BF16_HMMA_SCORE_TILES, which
// the wrapper checks against attention_bf16_tiles)
#define HMMA_SCORE_TILES(X) X(2) X(5) X(9)
static_assert(kHmmaMaxKeys == 8 * 9, "the largest tier holds kHmmaMaxKeys keys");

// the products' depth: hd, hd 2 padded to 8 with zeros (a staged row is hd
// bf16 wide, hd 2 one 32-bit word)
__host__ __device__ constexpr int hd_pad(int hd) { return hd < 8 ? 8 : hd; }

// d += a b, 16 x 8 x HD (HD 8: m16n8k8, 16: m16n8k16), bf16 in, float32
// accumulators: a a [16][HD] A fragment (HD / 4 registers), b an [HD][8]
// B fragment (HD / 8)
template <int HD>
__device__ __forceinline__ void hmma(float (&d)[4], const uint32_t (&a)[HD / 4],
                                     const uint32_t (&b)[HD / 8]) {
  static_assert(HD == 8 || HD == 16, "mma.sync depths");
  if constexpr (HD == 8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// rows r0 .. r0 + 15 of one head's hd columns (hd <= HD, the tier) of a
// bf16 view, each clamped to row N - 1, as the A fragment of a 16 x 8 x
// hd_pad(HD) product (zero past column hd): a 4-byte load a pair of
// columns, or unless `wide` (hd == HD, rows 16-byte aligned) a 2-byte load
// a column
template <int HD>
__device__ __forceinline__ void ldg_a(uint32_t (&a)[hd_pad(HD) / 4], const View<bf16>& x, int b,
                                      int r0, int col0, int N, bool wide, int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int u = 0; u < hd_pad(HD) / 4; ++u) {
    const int col = 2 * t4 + 8 * (u >> 1);
    const bf16* p = row_ptr(x, b, min(r0 + g + 8 * (u & 1), N - 1), col0 + col);
    a[u] = col >= hd ? 0u
           : wide    ? __ldg(reinterpret_cast<const unsigned int*>(p))
                     : ldg_u16(p) | (col + 1 < hd ? ldg_u16(p + 1) << 16 : 0u);
  }
}

// row r of a dense [NP][HD] bf16 tile in shared memory (as 32-bit words)
// as the B fragment of a 16 x 8 x hd_pad(HD) product: the tile's rows are
// the product's columns (hd 2: zero past the row's one word)
template <int HD>
__device__ __forceinline__ void lds_b(uint32_t (&bf)[hd_pad(HD) / 8], const uint32_t* tile, int r) {
  const int t4 = threadIdx.x % 4;
  if constexpr (HD == 2) {
    bf[0] = t4 == 0 ? tile[r] : 0u;
  } else {
#pragma unroll
    for (int u = 0; u < HD / 8; ++u) bf[u] = tile[r * (HD / 2) + t4 + 4 * u];
  }
}

// rows r0 .. r0 + 15 of a dense [NP][HD] bf16 tile at shared address
// `tile` as the B fragments of a 16-deep product over those rows (ldmatrix,
// transposed): b[2n], b[2n + 1] give the product's columns 8n .. 8n + 7.
// hd 2 (rows of one word): lane (g, t4) reads rows r0 + 2 t4, + 1 and + 8,
// + 9 and takes column g & 1 of each; the product's columns from 2 on
// repeat columns 0 and 1 and are never stored.
template <int HD>
__device__ __forceinline__ void ldsm_rows(uint32_t (&b)[hd_pad(HD) / 4], uint32_t tile, int r0) {
  const int lane = threadIdx.x % 32;
  if constexpr (HD == 2) {
    uint32_t w[4];
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "r"(tile + 4 * (r0 + 2 * (lane % 4)))
                 : "memory");
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[2]), "=r"(w[3])
                 : "r"(tile + 4 * (r0 + 2 * (lane % 4) + 8))
                 : "memory");
    const unsigned sel = (lane / 4) & 1 ? 0x7632u : 0x5410u;
    b[0] = __byte_perm(w[0], w[1], sel);
    b[1] = __byte_perm(w[2], w[3], sel);
  } else if constexpr (HD == 8) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0]), "=r"(b[1])
                 : "r"(tile + (r0 + (lane & 15)) * 16)
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(tile + (r0 + (lane & 15)) * 32 + 16 * (lane >> 4))
                 : "memory");
  }
}

// d += a b over 16 rows of a staged tile: a [16][16] A fragment (packed
// from accumulators), b from ldsm_rows, d one accumulator per 8 columns
template <int HD>
__device__ __forceinline__ void hmma_rows(float (&d)[HD / 8][4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[HD / 4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const uint32_t bn[2] = {b[2 * n], b[2 * n + 1]};
    hmma<16>(d[n], a, bn);
  }
}

// rows [0, NP) of one head's hd columns of a bf16 view -> a dense
// [NP][HD] bf16 tile in shared memory (HD the tier) by cp.async, 16 bytes a
// copy (hd 2: its 4-byte row), zero past row N (a zero row times a zero
// weight adds nothing; garbage could be NaN). The copies are all in flight
// at once: wait_copies() then a CTA barrier before the tile is read.
// Unless `wide` (hd == HD and rows 16-byte aligned; hd 2: 4-byte), 2-byte
// loads and stores, an element at a time, zero past column hd.
template <int HD>
__device__ __forceinline__ void stage_tile(uint4* dst, const View<bf16>& x, int b, int col0, int N,
                                           int NP, bool wide, int hd) {
  const uint32_t base = smem_u32(dst);
  if (!wide) {
    unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
    for (int e = threadIdx.x; e < NP * HD; e += blockDim.x) {
      const int r = e / HD, c = e - r * HD;
      d16[e] = r < N && c < hd ? ldg_u16(row_ptr(x, b, r, col0 + c)) : 0;
    }
  } else if constexpr (HD >= 8) {
    constexpr int kPer = HD / 8;
    for (int e = threadIdx.x; e < NP * kPer; e += blockDim.x) {
      const int r = e / kPer, c = e - r * kPer;
      const bool in = r < N;
      cp_async16(base + 16 * e, in ? row_ptr(x, b, r, col0 + 8 * c) : x.ptr, in ? 16 : 0);
    }
  } else {
    for (int r = threadIdx.x; r < NP; r += blockDim.x) {  // hd 2: a 4-byte word a row
      const bool in = r < N;
      cp_async4(base + 4 * r, in ? row_ptr(x, b, r, col0) : x.ptr, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// delta = rowsum(do * o) of row i over its hd columns, in column order:
// both backward roles form it with this expression, so they agree bit for
// bit. A float32 o and do (hybrid) are read a float at a time.
template <int HD, typename TO>
__device__ __forceinline__ float row_delta(const View<TO>& o, const View<TO>& dout, int b, int i,
                                           int col0, bool wide, int hd) {
  constexpr int VW = HD < 8 ? HD : 8;
  float x = 0.f;
  if constexpr (std::is_same<TO, float>::value) {
#pragma unroll
    for (int c = 0; c < HD; ++c)
      if (c < hd)
        x = fmaf(__ldg(row_ptr(dout, b, i, col0 + c)), __ldg(row_ptr(o, b, i, col0 + c)), x);
  } else if (!wide) {  // an element a copy, the same order
#pragma unroll
    for (int c = 0; c < HD; ++c)
      if (c < hd)
        x = fmaf(__bfloat162float(*row_ptr(dout, b, i, col0 + c)),
                 __bfloat162float(*row_ptr(o, b, i, col0 + c)), x);
  } else {
#pragma unroll
    for (int c = 0; c < HD / VW; ++c) {
      float a[VW], d[VW];
      ldg_bf16<VW>(row_ptr(o, b, i, col0 + VW * c), a);
      ldg_bf16<VW>(row_ptr(dout, b, i, col0 + VW * c), d);
#pragma unroll
      for (int u = 0; u < VW; ++u) x = fmaf(d[u], a[u], x);
    }
  }
  return x;
}

// a float32 x as three bf16 parts whose sum is x exactly: hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid) (both residuals are exact in
// float32, the second has at most 8 significant bits)
__device__ __forceinline__ void split3(float x, float (&part)[3]) {
  part[0] = round_bf16(x);
  const float rest = x - part[0];
  part[1] = round_bf16(rest);
  part[2] = round_bf16(rest - part[1]);
}

// ldg_a of a float32 view (hybrid's do), each pair of columns read a float
// at a time and split (split3) into the A fragments of its three parts
template <int HD>
__device__ __forceinline__ void ldg_a_split(uint32_t (&a)[3][hd_pad(HD) / 4], const View<float>& x,
                                            int b, int r0, int col0, int N, int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int u = 0; u < hd_pad(HD) / 4; ++u) {
    const int col = 2 * t4 + 8 * (u >> 1);
    float x0[3] = {0.f, 0.f, 0.f}, x1[3] = {0.f, 0.f, 0.f};
    if (col < hd) {
      const float* p = row_ptr(x, b, min(r0 + g + 8 * (u & 1), N - 1), col0 + col);
      split3(__ldg(p), x0);
      if (col + 1 < hd) split3(__ldg(p + 1), x1);
    }
#pragma unroll
    for (int z = 0; z < 3; ++z) a[z][u] = pack_bf16(x0[z], x1[z]);
  }
}

// stage_tile of a float32 view (hybrid's do) as the three [NP][HD] bf16
// tiles of its parts (split3), `words` 32-bit words apart; plain loads and
// stores, a pair of columns a thread, zero past row N and past column hd.
// The caller's CTA barrier makes them visible.
template <int HD>
__device__ __forceinline__ void stage_split(uint32_t* dst, int words, const View<float>& x, int b,
                                            int col0, int N, int NP, int hd) {
  constexpr int kPairs = HD / 2;
  for (int e = threadIdx.x; e < NP * kPairs; e += blockDim.x) {
    const int r = e / kPairs, c = 2 * (e - r * kPairs);
    float x0[3] = {0.f, 0.f, 0.f}, x1[3] = {0.f, 0.f, 0.f};
    if (r < N && c < hd) {
      const float* p = row_ptr(x, b, r, col0 + c);
      split3(__ldg(p), x0);
      if (c + 1 < hd) split3(__ldg(p + 1), x1);
    }
#pragma unroll
    for (int z = 0; z < 3; ++z) dst[z * words + e] = pack_bf16(x0[z], x1[z]);
  }
}

// four 8-column accumulators' values (two 16 x 8 tiles side by side) as
// the bf16 A fragment of the next 16-deep product
__device__ __forceinline__ void pack_a16(uint32_t (&a)[4], const float (&x)[4],
                                         const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// Forward, hd <= 16: `chunks` CTAs a (b, h), blockIdx.x = (b H + h)
// chunks + c; warp w takes the 16 query rows of tile c + chunks w. The CTA
// stages k and v once as bf16; a warp's scores against every key stay in
// registers (s = q k^T, one mma a tile of 8 keys), so each is formed and
// exponentiated once: the exact row max, l = sum exp(s - m), then attn =
// bf16(exp(s - m) / l) packed straight from the accumulators into the A
// fragments of o += attn v (m16n8k16, v read by ldmatrix). NT is the
// register array's 8-key tiles, at least ceil(N / 8). HD is the tier (2, 8
// or 16) and hd the head's width, at most HD: q, k and v zero past it.
// WIDE: hd == HD and every view takes 16-byte copies (hd 2: 4-byte), else
// 2-byte loads.
template <int HD, int NT, bool WIDE>
__global__ void __launch_bounds__(kHmmaWarps * 32, 2)
attn_fwd_hmma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                   float* __restrict__ lse, int N, int H, int hd_arg, int chunks, float scale) {
  constexpr int HP = hd_pad(HD);
  const int hd = WIDE ? HD : hd_arg;
  extern __shared__ __align__(16) uint4 smem_hm[];
  const int tiles = (N + 15) / 16, nt = (N + 7) / 8, NP = 16 * tiles;
  uint4* ks = smem_hm;
  uint4* vs = smem_hm + NP * HD / 8;
  const int bh = blockIdx.x / chunks, c = blockIdx.x - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (c + chunks * warp);
  uint32_t qa[HP / 4];
  ldg_a<HD>(qa, q, b, r0, col0, N, WIDE, hd);
  stage_tile<HD>(ks, k, b, col0, N, NP, WIDE, hd);
  stage_tile<HD>(vs, v, b, col0, N, NP, WIDE, hd);
  wait_copies();
  __syncthreads();
  if (r0 >= N) return;  // a tile past the last (the chunks' uneven split)

  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ks);
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (j < nt) {
      uint32_t kb[HP / 8];
      lds_b<HD>(kb, k32, 8 * j + g);
      hmma<HP>(s[j], qa, kb);
      // keys past N (the last tile) score -inf, by selects: their
      // exponentials are 0
      const bool last = j == nt - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = last && 8 * j + 2 * t4 + (e & 1) >= N ? -INFINITY : s[j][e];
    }
  }

  // s[j][e]: row r0 + g + 8 (e / 2), key 8 j + 2 t4 + (e & 1); four
  // partial maxima and sums a row, in a fixed order, then the quad's
  float mp[2][4], lp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mp[r][u] = -INFINITY, lp[r][u] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmul_rn(s[j][e], scale);
      s[j][e] = x;
      mp[e / 2][j & 3] = fmaxf(mp[e / 2][j & 3], x);
    }
  }
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    m[r] = quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp(s[j][e] - m[e / 2]);
      s[j][e] = p;
      lp[e / 2][j & 3] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));

  // attn = p / l rounded once (q0 = p (1 / l), corrected by its residual),
  // packed to bf16 16 keys at a time as the A fragment of o += attn v
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const uint32_t vt = smem_u32(vs);
  float acc[HP / 8][4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
    if (2 * kk >= nt) continue;
    float a[2][4];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int j = min(2 * kk + z, NT - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e], q0 = p * rl[e / 2];
        a[z][e] = 2 * kk + z < nt ? fmaf(fmaf(-q0, l[e / 2], p), rl[e / 2], q0) : 0.f;
      }
    }
    uint32_t af[4], vb[HP / 4];
    pack_a16(af, a[0], a[1]);
    ldsm_rows<HD>(vb, vt, 16 * kk);
    hmma_rows<HP>(acc, af, vb);
  }

  const long long D = (long long)H * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= N) continue;
    bf16* row = o + ((long long)b * N + i) * D + col0;
#pragma unroll
    for (int n = 0; n < HP / 8; ++n)
      store_bf16_pair(row, 8 * n + 2 * t4, hd, acc[n][2 * r], acc[n][2 * r + 1]);
    if (t4 == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
  }
}

// The two-pass hd <= 16 forward's pass 1 over 64 keys (8-key tiles j0 ..
// j0 + 7, nt of them in all): s = q k^T scaled, the running row max m
// (exact) and the lane's partial l, rescaled by exp(m_old - m) as the max
// moves, plus the chunk's exp(s - m) in four partial sums a row. kMask (the
// chunk holds keys past N): those score -inf and tiles from nt on are not
// read.
template <int HD, bool kMask, int HP = hd_pad(HD)>
__device__ __forceinline__ void hmma_stats(const uint32_t (&qa)[HP / 4], const uint32_t* k32,
                                           int j0, int nt, int N, float scale, float (&m)[2],
                                           float (&l)[2]) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  float s[8][4], mp[2][4], lp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mp[r][u] = -INFINITY, lp[r][u] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + jj;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
    if (!kMask || j < nt) {
      uint32_t kb[HP / 8];
      lds_b<HD>(kb, k32, 8 * j + g);
      hmma<HP>(s[jj], qa, kb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[jj][e], scale);
      if (kMask && 8 * j + 2 * t4 + (e & 1) >= N) x = -INFINITY;
      s[jj][e] = x;
      mp[e / 2][jj & 3] = fmaxf(mp[e / 2][jj & 3], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn =
        fmaxf(m[r], quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]))));
    alpha[r] = fast_exp(m[r] - mn);  // 0 at the first chunk (m -inf)
    m[r] = mn;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) lp[e / 2][jj & 3] += fast_exp(s[jj][e] - m[e / 2]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = fmaf(l[r], alpha[r], (lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
}

// The two-pass forward's pass 2 over 64 keys (16-key steps kk0 .. kk0 +
// 3): the scores again, attn = bf16(exp(s - m) / l), the quotient rounded
// once as the one-pass form rounds it, packed into the A fragment of o +=
// attn v (v by ldmatrix from the tile at shared address vt). kMask: keys
// past N give 0 and tiles from nt on are not read.
template <int HD, bool kMask, int HP = hd_pad(HD)>
__device__ __forceinline__ void hmma_attn_v(const uint32_t (&qa)[HP / 4], const uint32_t* k32,
                                            uint32_t vt, int kk0, int nt, int N, float scale,
                                            const float (&m)[2], const float (&l)[2],
                                            const float (&rl)[2], float (&acc)[HP / 8][4]) {
  const int g = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
#pragma unroll
  for (int z4 = 0; z4 < 4; ++z4) {
    const int kk = kk0 + z4;
    if (kMask && 2 * kk >= nt) continue;
    float a[2][4];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int j = 2 * kk + z;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (!kMask || j < nt) {
        uint32_t kb[HP / 8];
        lds_b<HD>(kb, k32, 8 * j + g);
        hmma<HP>(s, qa, kb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp(__fmul_rn(s[e], scale) - m[e / 2]);
        if (kMask && 8 * j + 2 * t4 + (e & 1) >= N) p = 0.f;
        const float q0 = p * rl[e / 2];
        a[z][e] = fmaf(fmaf(-q0, l[e / 2], p), rl[e / 2], q0);
      }
    }
    uint32_t af[4], vb[HP / 4];
    pack_a16(af, a[0], a[1]);
    ldsm_rows<HD>(vb, vt, 16 * kk);
    hmma_rows<HP>(acc, af, vb);
  }
}

// Forward, hd <= 16, past kHmmaMaxKeys keys, where a row's scores no longer
// fit in registers: the one-pass form's grid and staging (k and v of the
// (b, h) as bf16 in shared memory, a warp a 16-row query tile), but each
// warp walks the keys twice, 64 at a time. Pass 1: s = q k^T (one mma an
// 8-key tile), the exact row max m and l = sum exp(s - m), rescaled as
// the max moves. Pass 2: the scores again, attn = bf16(exp(s - m) / l)
// packed into the A fragments of o += attn v (m16n8k16, v by ldmatrix).
// attn is rounded where JAX rounds it: a one-pass online softmax would
// round exp(s - m_running) and rescale the sum of products afterwards.
// HD, hd and WIDE as in the one-pass form.
template <int HD, bool WIDE>
__global__ void __launch_bounds__(kHmmaWarps * 32, 2)
attn_fwd_hmma2_bf16(View<bf16> q, View<bf16> k, View<bf16> v, bf16* __restrict__ o,
                    float* __restrict__ lse, int N, int H, int hd_arg, int chunks, float scale) {
  constexpr int HP = hd_pad(HD);
  const int hd = WIDE ? HD : hd_arg;
  extern __shared__ __align__(16) uint4 smem_h2[];
  const int tiles = (N + 15) / 16, nt = (N + 7) / 8, NP = 16 * tiles;
  uint4* ks = smem_h2;
  uint4* vs = smem_h2 + NP * HD / 8;
  const int bh = blockIdx.x / chunks, c = blockIdx.x - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (c + chunks * warp);
  uint32_t qa[HP / 4];
  ldg_a<HD>(qa, q, b, r0, col0, N, WIDE, hd);
  stage_tile<HD>(ks, k, b, col0, N, NP, WIDE, hd);
  stage_tile<HD>(vs, v, b, col0, N, NP, WIDE, hd);
  wait_copies();
  __syncthreads();
  if (r0 >= N) return;  // a tile past the last (the chunks' uneven split)

  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ks);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < nt; j0 += 8) {
    if (8 * (j0 + 8) <= N) hmma_stats<HD, false>(qa, k32, j0, nt, N, scale, m, l);
    else hmma_stats<HD, true>(qa, k32, j0, nt, N, scale, m, l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  const uint32_t vt = smem_u32(vs);
  float acc[HP / 8][4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kk0 = 0; 2 * kk0 < nt; kk0 += 4) {
    if (16 * (kk0 + 4) <= N) hmma_attn_v<HD, false>(qa, k32, vt, kk0, nt, N, scale, m, l, rl, acc);
    else hmma_attn_v<HD, true>(qa, k32, vt, kk0, nt, N, scale, m, l, rl, acc);
  }

  const long long D = (long long)H * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= N) continue;
    bf16* row = o + ((long long)b * N + i) * D + col0;
#pragma unroll
    for (int n = 0; n < HP / 8; ++n)
      store_bf16_pair(row, 8 * n + 2 * t4, hd, acc[n][2 * r], acc[n][2 * r + 1]);
    if (t4 == 0) lse[(long long)bh * N + i] = m[r] + logf(l[r]);
  }
}

// exp(x) for the backward's p: fast_exp, or with kExact the float64 exp
// rounded once to float32, the plain version's (attention_fused._exp). The
// padded tier-2 kernel (hd 1, and hd 2 views off 4-byte copies) takes the
// exact form: at hd 1 a score is one product, and ex2.approx's last bits
// flipped enough bf16(p) roundings to put 1.71e-3 of dv's elements past
// 1 ulp of chip_smoke.bwd_rounded64 at (2, 1025, 2, 1) (seed 2 of 5), the
// exact exponential 4.9e-4 at most over the five seeds (ops/
// attention_bf16_turns.py --shares 5, NVIDIA H100 80GB HBM3, 700.00 W).
// The shipped hd 2 and 8 kernels keep fast_exp.
template <bool kExact>
__device__ __forceinline__ float bwd_exp(float x) {
  if constexpr (kExact) return (float)exp((double)x);
  return fast_exp(x);
}

// The key role's p^T and ds^T in place of s^T and dp^T over one 16 x 16
// block: s[nq][e] is key `key` + 8 (e / 2), query q0 + 8 nq + 2 t4 + (e & 1)
// (the index of lse, staged or global, and of the staged delta). kMask (a
// ragged block): keys and queries past N give 0, by selects (lse read at
// N - 1 for them). kExact: bwd_exp's exact form.
template <bool kMask, bool kExact>
__device__ __forceinline__ void key_elems16(float (&s)[2][4], float (&dp)[2][4], const float* lse_s,
                                            const float* del_s, int key, int q0, int N,
                                            float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int nq = 0; nq < 2; ++nq)
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int col = q0 + 8 * nq + 2 * t4 + z;
      const float ls = lse_s[kMask ? min(col, N - 1) : col], dl = del_s[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 2 * r + z;
        const float p = bwd_exp<kExact>(__fmul_rn(s[nq][e], scale) - ls);
        const float ds = p * (dp[nq][e] - dl) * scale;
        const bool in = !kMask || (key + 8 * r < N && col < N);
        s[nq][e] = in ? p : 0.f;
        dp[nq][e] = in ? ds : 0.f;
      }
    }
}

// The query role's ds in place of dp over one 16 x 16 block: s[nk][e] is
// query `row` + 8 (e / 2) (lse_r, del_r), key k0 + 8 nk + 2 t4 + (e & 1);
// masked as key_elems16, with the same expressions.
template <bool kMask, bool kExact>
__device__ __forceinline__ void query_elems16(const float (&s)[2][4], float (&dp)[2][4],
                                              const float (&lse_r)[2], const float (&del_r)[2],
                                              int row, int k0, int N, float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int nk = 0; nk < 2; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      const float p = bwd_exp<kExact>(__fmul_rn(s[nk][e], scale) - lse_r[r]);
      const float ds = p * (dp[nk][e] - del_r[r]) * scale;
      const bool in = !kMask || (row + 8 * r < N && k0 + 8 * nk + 2 * t4 + (e & 1) < N);
      dp[nk][e] = in ? ds : 0.f;
    }
}

// Backward, hd <= 16, at any N: one launch of 2 B H chunks CTAs, the
// first B H chunks key-role CTAs (blockIdx.x = (b H + h) chunks + c), the
// rest query-role ones; warp w takes the 16 rows of tile c + chunks w. A
// key-role warp holds its keys' k and v as A fragments and walks the query
// tiles staged in shared memory (q, do, lse, and delta formed once a row;
// on a float32 do, lse is read from global memory, which leaves room for
// do's three parts at every N the float32 kernels take):
// s^T = k q^T and dp^T = v do^T (m16n8k8 / k16), p^T and ds^T, then dv +=
// bf16(p^T) do and dk += ds^T q (m16n8k16, A from registers, B by
// ldmatrix). A query-role warp holds its queries' q and do, forms its rows'
// lse and delta, and walks the staged k and v: s = q k^T, dp = do v^T, dq
// += ds k. No atomics, no float32 partials. o and do are bf16 (TO bf16:
// DP = 1), or float32 (hybrid; TO float: DP = 3), do then split into its
// three bf16 parts (split3: staged as three tiles by the key role, three A
// fragments in the query role) and each product with do taken as the sum
// of the parts' products, exact as JAX's float32 products with the
// unrounded do are. HD, hd and WIDE as in the forward, over q, k, v (and a
// bf16 o and do); a float32 o and do are read a float at a time.
template <int HD, bool WIDE, typename TO>
__global__ void __launch_bounds__(kHmmaWarps * 32)
attn_bwd_hmma_bf16(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o,
                   const float* __restrict__ lse, View<TO> dout, bf16* __restrict__ dq,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, int hd_arg,
                   int chunks, float scale) {
  constexpr int HP = hd_pad(HD);
  const int hd = WIDE ? HD : hd_arg;
  constexpr int DP = std::is_same<TO, float>::value ? 3 : 1;  // do's bf16 parts
  constexpr bool kExactExp = HD == 2 && !WIDE;  // the padded tier 2 (bwd_exp)
  extern __shared__ __align__(16) uint4 smem_hb[];
  const int tiles = (N + 15) / 16, NP = 16 * tiles, tile_u4 = NP * HD / 8;
  const int per_role = gridDim.x / 2;
  const bool key_role = blockIdx.x < per_role;
  const int idx = key_role ? blockIdx.x : blockIdx.x - per_role;
  const int bh = idx / chunks, c = idx - bh * chunks;
  const int b = bh / H, h = bh - b * H, col0 = h * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (c + chunks * warp);  // this warp's first key (query) row
  const float* lse_bh = lse + (long long)bh * N;
  const long long D = (long long)H * hd;
  uint4* t0 = smem_hb;            // q (key role) or k (query role)
  uint4* t1 = smem_hb + tile_u4;  // do's DP parts (key role) or v
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(t0);
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(t1);

  if (key_role) {
    float* del_s = reinterpret_cast<float*>(t1 + DP * tile_u4);
    float* lse_s = del_s + NP;  // a bf16 do's only
    const float* lse_k = DP == 3 ? lse_bh : lse_s;
    uint32_t ka[HP / 4], va[HP / 4];
    ldg_a<HD>(ka, k, b, r0, col0, N, WIDE, hd);
    ldg_a<HD>(va, v, b, r0, col0, N, WIDE, hd);
    stage_tile<HD>(t0, q, b, col0, N, NP, WIDE, hd);
    if constexpr (DP == 3)
      stage_split<HD>(reinterpret_cast<uint32_t*>(t1), 4 * tile_u4, dout, b, col0, N, NP, hd);
    else
      stage_tile<HD>(t1, dout, b, col0, N, NP, WIDE, hd);
    for (int i = threadIdx.x; i < NP; i += blockDim.x) {
      if constexpr (DP == 1) lse_s[i] = i < N ? lse_bh[i] : 0.f;
      del_s[i] = i < N ? row_delta<HD>(o, dout, b, i, col0, WIDE, hd) : 0.f;
    }
    wait_copies();
    __syncthreads();
    if (r0 >= N) return;
    float dka[HP / 8][4], dva[HP / 8][4];
#pragma unroll
    for (int n = 0; n < HP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    const bool keys_full = r0 + 16 <= N;
    for (int it = 0; it < tiles; ++it) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nq][e] = dp[nq][e] = 0.f;
        uint32_t bq[HP / 8], bd[DP][HP / 8];
        lds_b<HD>(bq, w0, 16 * it + 8 * nq + g);
#pragma unroll
        for (int p = 0; p < DP; ++p) lds_b<HD>(bd[p], w1 + 4 * p * tile_u4, 16 * it + 8 * nq + g);
        hmma<HP>(s[nq], ka, bq);
#pragma unroll
        for (int p = 0; p < DP; ++p) hmma<HP>(dp[nq], va, bd[p]);
      }
      if (keys_full && 16 * (it + 1) <= N)  // warp-uniform
        key_elems16<false, kExactExp>(s, dp, lse_k, del_s, r0 + g, 16 * it, N, scale);
      else
        key_elems16<true, kExactExp>(s, dp, lse_k, del_s, r0 + g, 16 * it, N, scale);
      uint32_t pf[4], sf[4], bo[DP][HP / 4], bq[HP / 4];
      pack_a16(pf, s[0], s[1]);
      pack_a16(sf, dp[0], dp[1]);
#pragma unroll
      for (int p = 0; p < DP; ++p) ldsm_rows<HD>(bo[p], smem_u32(t1 + p * tile_u4), 16 * it);
      ldsm_rows<HD>(bq, smem_u32(t0), 16 * it);
#pragma unroll
      for (int p = 0; p < DP; ++p) hmma_rows<HP>(dva, pf, bo[p]);
      hmma_rows<HP>(dka, sf, bq);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r0 + g + 8 * r;
      if (j >= N) continue;
      const long long off = ((long long)b * N + j) * D + col0;
#pragma unroll
      for (int n = 0; n < HP / 8; ++n) {
        store_bf16_pair(dk + off, 8 * n + 2 * t4, hd, dka[n][2 * r], dka[n][2 * r + 1]);
        store_bf16_pair(dv + off, 8 * n + 2 * t4, hd, dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  } else {
    uint32_t qa[HP / 4], da[DP][HP / 4];
    ldg_a<HD>(qa, q, b, r0, col0, N, WIDE, hd);
    if constexpr (DP == 3) ldg_a_split<HD>(da, dout, b, r0, col0, N, hd);
    else ldg_a<HD>(da[0], dout, b, r0, col0, N, WIDE, hd);
    float lse_r[2], del_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = min(r0 + g + 8 * r, N - 1);
      lse_r[r] = lse_bh[i];
      del_r[r] = row_delta<HD>(o, dout, b, i, col0, WIDE, hd);
    }
    stage_tile<HD>(t0, k, b, col0, N, NP, WIDE, hd);
    stage_tile<HD>(t1, v, b, col0, N, NP, WIDE, hd);
    wait_copies();
    __syncthreads();
    if (r0 >= N) return;
    float dqa[HP / 8][4];
#pragma unroll
    for (int n = 0; n < HP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
    const bool rows_full = r0 + 16 <= N;
    for (int jt = 0; jt < tiles; ++jt) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nk = 0; nk < 2; ++nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nk][e] = dp[nk][e] = 0.f;
        uint32_t bk[HP / 8], bv[HP / 8];
        lds_b<HD>(bk, w0, 16 * jt + 8 * nk + g);
        lds_b<HD>(bv, w1, 16 * jt + 8 * nk + g);
        hmma<HP>(s[nk], qa, bk);
#pragma unroll
        for (int p = 0; p < DP; ++p) hmma<HP>(dp[nk], da[p], bv);
      }
      if (rows_full && 16 * (jt + 1) <= N)  // warp-uniform
        query_elems16<false, kExactExp>(s, dp, lse_r, del_r, r0 + g, 16 * jt, N, scale);
      else
        query_elems16<true, kExactExp>(s, dp, lse_r, del_r, r0 + g, 16 * jt, N, scale);
      uint32_t sf[4], bk[HP / 4];
      pack_a16(sf, dp[0], dp[1]);
      ldsm_rows<HD>(bk, smem_u32(t0), 16 * jt);
      hmma_rows<HP>(dqa, sf, bk);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= N) continue;
      bf16* row = dq + ((long long)b * N + i) * D + col0;
#pragma unroll
      for (int n = 0; n < HP / 8; ++n)
        store_bf16_pair(row, 8 * n + 2 * t4, hd, dqa[n][2 * r], dqa[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the tensor-core kernels' dynamic shared memory (attention_fused.py:
// bf16_smem_bytes) with the head in HC column tiles: the alignment slack,
// then the one-pass forward's (HC 1) k and v blocks, its two q tiles, four
// mbarriers and the o tile (the two-pass forward's q tiles, two ring
// stages of k and the slice's v, the o tile and three mbarriers); the
// backward's larger role: the key role's
// k and v, S ring stages (key_stages) of q and do's parts, lse and delta,
// and 1 + S mbarriers, or the query role's q and do's parts, two ring
// stages of k and v and three mbarriers
size_t fwd_mma_smem(int N) {
  return kSmemAlign + (2 * (size_t)((N + kTile - 1) / kTile) + 3) * kTileBytes + 128;
}

size_t fwd_mma2_smem(int HC) {
  return kSmemAlign + (3 * (size_t)HC + 3) * kTileBytes + 3 * sizeof(uint64_t);
}

size_t bwd_mma_smem(int do_parts, int HC) {
  const int S = key_stages(HC, do_parts);
  const size_t keys = kSmemAlign + (2 * HC + (size_t)S * HC * (1 + do_parts)) * kTileBytes +
                      S * 2 * kTile * sizeof(float) + (1 + S) * sizeof(uint64_t);
  const size_t queries =
      kSmemAlign + ((size_t)HC * (1 + do_parts) + 4 * HC) * kTileBytes + 3 * sizeof(uint64_t);
  return keys > queries ? keys : queries;
}

// whether a bf16 view's pointer and strides take VW-element copies
bool takes_width(const View<bf16>& x, int vw) {
  return reinterpret_cast<uintptr_t>(x.ptr) % (sizeof(bf16) * vw) == 0 && x.sb % vw == 0 &&
         x.sr % vw == 0;
}

// whether a float32 view's pointer and strides are multiples of 16 bytes
bool takes_16_bytes(const View<float>& x) {
  return reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 && x.sb % 4 == 0 && x.sr % 4 == 0;
}

// the wgmma kernels' staging: 16-byte copies where hd is a multiple of 8
// and every view's rows start on 16-byte boundaries, else (`narrow`) 2-byte
// loads
bool mma_narrow(int hd, std::initializer_list<View<bf16>> views) {
  if (hd % 8) return true;
  for (const View<bf16>& x : views)
    if (!takes_width(x, 8)) return true;
  return false;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int NKB, int TW>
int fwd_mma_blocks(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N,
                   int H, int hd, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = fwd_mma_smem(N);
  cudaError_t err = allow_smem(attn_fwd_mma_bf16<NKB, TW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_mma_bf16<NKB, TW><<<B * H, kWg, smem, s>>>(q, k, v, o, lse, N, H, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// NKB key blocks, the last one's width (keys past 64 (NKB - 1)) rounded up
// to 8, 16, 32 or 64
template <int NKB>
int fwd_mma_tail(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N,
                 int H, int hd, float scale, cudaStream_t s) {
  const int rest = N - kTile * (NKB - 1);
  if (rest <= 8) return fwd_mma_blocks<NKB, 8>(q, k, v, o, lse, B, N, H, hd, scale, s);
  if (rest <= 16) return fwd_mma_blocks<NKB, 16>(q, k, v, o, lse, B, N, H, hd, scale, s);
  if (rest <= 32) return fwd_mma_blocks<NKB, 32>(q, k, v, o, lse, B, N, H, hd, scale, s);
  return fwd_mma_blocks<NKB, 64>(q, k, v, o, lse, B, N, H, hd, scale, s);
}

// the two-pass form: a CTA a 64-row query tile and 64-column slice
template <int HC, bool NARROW>
int fwd_mma2_launch(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N,
                    int H, int hd, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = fwd_mma2_smem(HC);
  cudaError_t err = allow_smem(attn_fwd_mma2_bf16<HC, NARROW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (N + kTile - 1) / kTile;
  attn_fwd_mma2_bf16<HC, NARROW><<<dim3(B * H * nb, HC), kWg, smem, s>>>(q, k, v, o, lse, N, H,
                                                                        hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HC>
int fwd_mma2(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
             int hd, float scale, cudaStream_t s) {
  return mma_narrow(hd, {q, k, v})
             ? fwd_mma2_launch<HC, true>(q, k, v, o, lse, B, N, H, hd, scale, s)
             : fwd_mma2_launch<HC, false>(q, k, v, o, lse, B, N, H, hd, scale, s);
}

// at hd 17-64 the one-pass form up to kMaxKeyBlocks key blocks, the
// two-pass past them and for narrow heads (`mma_narrow`); from hd 65 the
// two-pass form at every N
template <int HC>
int fwd_mma(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
            int hd, float scale, cudaStream_t s) {
  if (HC > 1 || mma_narrow(hd, {q, k, v}))
    return fwd_mma2<HC>(q, k, v, o, lse, B, N, H, hd, scale, s);
  switch ((N + kTile - 1) / kTile) {
    case 1: return fwd_mma_tail<1>(q, k, v, o, lse, B, N, H, hd, scale, s);
    case 2: return fwd_mma_tail<2>(q, k, v, o, lse, B, N, H, hd, scale, s);
    case 3: return fwd_mma_tail<3>(q, k, v, o, lse, B, N, H, hd, scale, s);
    case 4: return fwd_mma_tail<4>(q, k, v, o, lse, B, N, H, hd, scale, s);
    case 5: return fwd_mma_tail<5>(q, k, v, o, lse, B, N, H, hd, scale, s);
    default: return fwd_mma2<1>(q, k, v, o, lse, B, N, H, hd, scale, s);
  }
}

template <int DP, int HC, bool NARROW>
int bwd_mma_launch(dim3 grid, View<bf16> q, View<bf16> k, View<bf16> v, const DoParts& parts,
                   const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv, int N,
                   int H, int hd, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = bwd_mma_smem(DP, HC);
  cudaError_t err = allow_smem(attn_bwd_mma_bf16<DP, HC, NARROW>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_mma_bf16<DP, HC, NARROW><<<grid, kWg, smem, s>>>(q, k, v, parts, lse, delta, dq, dk,
                                                            dv, N, H, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// the delta pre-pass (and, for a float32 do, its split), then one launch
// of both roles over the HC slices
template <typename TO, int HC>
int bwd_mma(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
            View<TO> dout, bf16* dq, bf16* dk, bf16* dv, float* delta, bf16* split, int B, int N,
            int H, int hd, float scale, cudaStream_t s) {
  constexpr int DP = std::is_same<TO, float>::value ? 3 : 1;
  const long long rows = (long long)B * N * H;
  bool delta_narrow = hd % 8 != 0;
  if constexpr (DP == 3) delta_narrow = delta_narrow || !takes_16_bytes(o) || !takes_16_bytes(dout);
  else delta_narrow = delta_narrow || !takes_width(o, 8) || !takes_width(dout, 8);
  attn_delta_bf16<TO><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(o, dout, delta, split, B, N,
                                                                      H, hd, delta_narrow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  DoParts parts;
  const long long D = (long long)H * hd;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if constexpr (DP == 3) parts.p[p] = View<bf16>{split + p * (long long)B * N * D, N * D, D};
    else parts.p[p] = dout;
  }
  const dim3 grid(2 * B * H * ((N + kTile - 1) / kTile), HC);
  if (mma_narrow(hd, {q, k, v, parts.p[0]}))
    return bwd_mma_launch<DP, HC, true>(grid, q, k, v, parts, lse, delta, dq, dk, dv, N, H, hd,
                                        scale, s);
  return bwd_mma_launch<DP, HC, false>(grid, q, k, v, parts, lse, delta, dq, dk, dv, N, H, hd,
                                       scale, s);
}

// the hd <= 16 tensor-core kernels' dynamic shared memory
// (attention_fused.py: bf16_smem_bytes): N padded to NP = 16 ceil(N / 16)
// rows, [NP][HD] bf16 tiles (HD the tier): the forward's k and v; the
// backward's larger role, the key role: q, do's parts (one, or three of a
// float32 do), the delta row and, beside a bf16 do, the lse row
size_t hmma_smem(int N, int HD, bool backward, int do_parts = 1) {
  const size_t np = 16 * (size_t)((N + 15) / 16), tile = np * HD * sizeof(bf16);
  return backward ? (1 + do_parts) * tile + (do_parts == 3 ? 1 : 2) * np * sizeof(float)
                  : 2 * tile;
}

// whether a plan of `chunks` CTAs a (b, h), `warps` 16-row tiles a CTA,
// covers N (the caller's, attention_fused.py: bf16_hmma_plan)
bool hmma_plan_ok(int N, int chunks, int warps) {
  return chunks >= 1 && warps >= 1 && warps <= kHmmaWarps && 16 * chunks * warps >= N;
}

// whether every view takes the tensor-core row kernels' 16-byte copies
// (hd 2: its whole 4-byte row) at hd == HD
template <int HD>
bool wide_views(int hd, std::initializer_list<View<bf16>> views) {
  if (hd != HD) return false;
  for (const View<bf16>& x : views)
    if (!takes_width(x, HD < 8 ? HD : 8)) return false;
  return true;
}

template <int HD, int NT, bool WIDE>
int fwd_hmma_tiles(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N,
                   int H, int hd, float scale, int chunks, int warps, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = hmma_smem(N, HD, false);
  cudaError_t err = allow_smem(attn_fwd_hmma_bf16<HD, NT, WIDE>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_hmma_bf16<HD, NT, WIDE><<<B * H * chunks, 32 * warps, smem, s>>>(q, k, v, o, lse, N, H,
                                                                            hd, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool WIDE>
int fwd_hmma2(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
              int hd, float scale, int chunks, int warps, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = hmma_smem(N, HD, false);
  cudaError_t err = allow_smem(attn_fwd_hmma2_bf16<HD, WIDE>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_hmma2_bf16<HD, WIDE><<<B * H * chunks, 32 * warps, smem, s>>>(q, k, v, o, lse, N, H,
                                                                         hd, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

// `tiles`, the one-pass form's register tier (attention_fused.py:
// bf16_hmma_score_tiles), one of HMMA_SCORE_TILES and at least ceil(N / 8),
// or 0: the two-pass form (N past kHmmaMaxKeys). Views that do not all take
// 16-byte copies, and head dims below their tier, run the one-pass form's
// largest tier, built for them alone (off the shipped models' paths: their
// q, k, v take them).
template <int HD>
int fwd_hmma(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
             int hd, float scale, int tiles, int chunks, int warps, cudaStream_t s) {
  if (!hmma_plan_ok(N, chunks, warps)) return kBadPlan;
  const bool wide = wide_views<HD>(hd, {q, k, v});
  if (tiles == 0)
    return wide ? fwd_hmma2<HD, true>(q, k, v, o, lse, B, N, H, hd, scale, chunks, warps, s)
                : fwd_hmma2<HD, false>(q, k, v, o, lse, B, N, H, hd, scale, chunks, warps, s);
  if (N > kHmmaMaxKeys || 8 * tiles < N) return kBadPlan;
  if (!wide)
    return fwd_hmma_tiles<HD, kHmmaMaxKeys / 8, false>(q, k, v, o, lse, B, N, H, hd, scale, chunks,
                                                        warps, s);
  switch (tiles) {
#define HMMA_TIER_CASE(NT) \
  case NT:                 \
    return fwd_hmma_tiles<HD, NT, true>(q, k, v, o, lse, B, N, H, hd, scale, chunks, warps, s);
    HMMA_SCORE_TILES(HMMA_TIER_CASE)
#undef HMMA_TIER_CASE
    default:
      return kBadPlan;
  }
}

template <int HD, bool WIDE, typename TO>
int bwd_hmma_launch(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
                    View<TO> dout, bf16* dq, bf16* dk, bf16* dv, int B, int N, int H, int hd,
                    float scale, int chunks, int warps, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = hmma_smem(N, HD, true, std::is_same<TO, float>::value ? 3 : 1);
  cudaError_t err = allow_smem(attn_bwd_hmma_bf16<HD, WIDE, TO>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_hmma_bf16<HD, WIDE, TO><<<2 * B * H * chunks, 32 * warps, smem, s>>>(
      q, k, v, o, lse, dout, dq, dk, dv, N, H, hd, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

// WIDE where hd is the tier and q, k, v (and a bf16 o and do) all take
// 16-byte copies
template <int HD, typename TO>
int bwd_hmma(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
             View<TO> dout, bf16* dq, bf16* dk, bf16* dv, int B, int N, int H, int hd, float scale,
             int chunks, int warps, cudaStream_t s) {
  if (!hmma_plan_ok(N, chunks, warps)) return kBadPlan;
  bool wide = wide_views<HD>(hd, {q, k, v});
  if constexpr (std::is_same<TO, bf16>::value) wide = wide && wide_views<HD>(hd, {o, dout});
  if (wide)
    return bwd_hmma_launch<HD, true, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale,
                                         chunks, warps, s);
  return bwd_hmma_launch<HD, false, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale,
                                        chunks, warps, s);
}

// a head dim's tier: the tensor-core row kernels (mma.sync) at 2, 8 and 16
// with the caller's plan (attention_fused.py: bf16_hmma_plan,
// bf16_hmma_score_tiles); the wgmma kernels from 17 on, the head in 1, 2
// or 3 column tiles of 64 (tiers 64, 128, 192)
template <int T>
int launch_fwd(View<bf16> q, View<bf16> k, View<bf16> v, bf16* o, float* lse, int B, int N, int H,
               int hd, float scale, int tiles, int chunks, int warps, cudaStream_t s) {
  if constexpr (T >= 64) return fwd_mma<T / 64>(q, k, v, o, lse, B, N, H, hd, scale, s);
  else return fwd_hmma<T>(q, k, v, o, lse, B, N, H, hd, scale, tiles, chunks, warps, s);
}

template <int T, typename TO>
int launch_bwd(View<bf16> q, View<bf16> k, View<bf16> v, View<TO> o, const float* lse,
               View<TO> dout, bf16* dq, bf16* dk, bf16* dv, float* delta, bf16* split, int B,
               int N, int H, int hd, float scale, int chunks, int warps, cudaStream_t s) {
  if constexpr (T >= 64)
    return bwd_mma<TO, T / 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, split, B, N, H, hd,
                               scale, s);
  else
    return bwd_hmma<T, TO>(q, k, v, o, lse, dout, dq, dk, dv, B, N, H, hd, scale, chunks, warps,
                           s);
}

}  // namespace

// The tiers a head dim runs at, the first at least as wide: the
// tensor-core row kernels at 2 (hd 1, 2), 8 (3-8) and 16 (9-16), the
// wgmma kernels at 64 (17-64), 128 (65-128) and 192 (129-192). A head
// narrower than its tier is zero past hd in the staged tiles and
// fragments.
#define ATTN_BF16_TIERS(X) X(2) X(8) X(16) X(64) X(128) X(192)

// The kernels' constants (kTile, kHdp, kMaxKeyBlocks, kHmmaWarps,
// kHmmaMaxKeys, then the 3 HMMA_SCORE_TILES): ops/attention_fused.py plans
// grids and shared memory with them and refuses a library whose constants
// differ.
extern "C" void attention_bf16_tiles(int* out) {
  out[0] = kTile;
  out[1] = kHdp;
  out[2] = kMaxKeyBlocks;
  out[3] = kHmmaWarps;
  out[4] = kHmmaMaxKeys;
  int i = 5;
#define HMMA_TIER_OUT(NT) out[i++] = NT;
  HMMA_SCORE_TILES(HMMA_TIER_OUT)
#undef HMMA_TIER_OUT
}

// The head-dim tiers (ATTN_BF16_TIERS), ended by a 0 (at most 16 entries):
// ops/attention_fused.py checks them against its own.
extern "C" void attention_bf16_head_tiers(int* out) {
  int i = 0;
#define TIER_OUT(T) out[i++] = T;
  ATTN_BF16_TIERS(TIER_OUT)
#undef TIER_OUT
  out[i] = 0;
}

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), -1 for a head dim past the
// last tier, or -4 for a tensor-core row plan (hd <= 16) that does not
// cover N or whose tier is not built. q, k, v and do are [B, N, H*hd]
// views with unit column stride, batch stride *_sb and row stride *_sr in
// elements, any alignment (rows off 16-byte boundaries take narrower
// copies). At hd <= 16 the caller passes the tensor-core row kernels'
// plan: hmma_chunks CTAs a (b, h), hmma_warps warps a CTA and the
// forward's register tier hmma_tiles (0: the two-pass form, N past
// kHmmaMaxKeys). o and do are bf16, or both float32 when o_do_f32 is set
// (hybrid_attention's eager forward and its cotangent). The outputs o,
// lse [B, H, N] (float32), dq, dk, dv are contiguous. From hd 17 on the
// backward writes delta, a float32 [B, H, N] workspace, and for a float32
// do its three bf16 parts to do_split, a contiguous [3, B, N, H*hd] bf16
// workspace (unused otherwise).
extern "C" int attention_bf16_forward(const void* q, long long q_sb, long long q_sr,
                                      const void* k, long long k_sb, long long k_sr,
                                      const void* v, long long v_sb, long long v_sr, void* o,
                                      float* lse, int B, int N, int H, int hd, float scale,
                                      int hmma_tiles, int hmma_chunks, int hmma_warps,
                                      void* stream) {
  const View<bf16> qv{static_cast<const bf16*>(q), q_sb, q_sr},
      kv{static_cast<const bf16*>(k), k_sb, k_sr}, vv{static_cast<const bf16*>(v), v_sb, v_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1) return kBadHeadDim;
#define ATTN_FWD_CASE(T)                                                                       \
  if (hd <= T)                                                                                 \
    return launch_fwd<T>(qv, kv, vv, static_cast<bf16*>(o), lse, B, N, H, hd, scale,           \
                         hmma_tiles, hmma_chunks, hmma_warps, s);
  ATTN_BF16_TIERS(ATTN_FWD_CASE)
#undef ATTN_FWD_CASE
  return kBadHeadDim;
}

extern "C" int attention_bf16_backward(const void* q, long long q_sb, long long q_sr,
                                       const void* k, long long k_sb, long long k_sr,
                                       const void* v, long long v_sb, long long v_sr,
                                       const void* o, long long o_sb, long long o_sr, int o_do_f32,
                                       const float* lse, const void* dout, long long do_sb,
                                       long long do_sr, void* dq, void* dk, void* dv,
                                       float* delta, void* do_split, int B, int N, int H, int hd,
                                       float scale, int hmma_chunks, int hmma_warps,
                                       void* stream) {
  const View<bf16> qv{static_cast<const bf16*>(q), q_sb, q_sr},
      kv{static_cast<const bf16*>(k), k_sb, k_sr}, vv{static_cast<const bf16*>(v), v_sb, v_sr};
  const View<bf16> ob{static_cast<const bf16*>(o), o_sb, o_sr},
      dob{static_cast<const bf16*>(dout), do_sb, do_sr};
  const View<float> of{static_cast<const float*>(o), o_sb, o_sr},
      dof{static_cast<const float*>(dout), do_sb, do_sr};
  bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
  bf16* split = static_cast<bf16*>(do_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1) return kBadHeadDim;
#define ATTN_BWD_CASE(T)                                                                        \
  if (hd <= T)                                                                                  \
    return o_do_f32 ? launch_bwd<T, float>(qv, kv, vv, of, lse, dof, dqb, dkb, dvb, delta,      \
                                           split, B, N, H, hd, scale, hmma_chunks, hmma_warps, \
                                           s)                                                   \
                    : launch_bwd<T, bf16>(qv, kv, vv, ob, lse, dob, dqb, dkb, dvb, delta,       \
                                          split, B, N, H, hd, scale, hmma_chunks, hmma_warps,  \
                                          s);
  ATTN_BF16_TIERS(ATTN_BWD_CASE)
#undef ATTN_BWD_CASE
  return kBadHeadDim;
}
