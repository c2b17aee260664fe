// Fused pre-norm transformer block at any shape, forward and backward, for
// NVIDIA Hopper (sm_90a), float32: the streamed design.
//
// block_fwd_streamed replaces the TPU kernel
// vitsom_tpu/ops/block_pallas.py:_fwd_kernel (launched by make_fused_block's
// _call_fwd) and block_bwd_streamed replaces _bwd_kernel (_call_bwd) at
// every (D, heads, M, N) outside block.cu's resident shapes
// (ops/block_fused.py: block_plan). They compute what block.cu's kernels
// compute, with D = H * hd and M the MLP width:
//   h1 = LN1(x);  qkv = h1 Wqkv + bqkv;  o = per-head softmax(q k^T hd^-0.5) v
//   r = x + o Wp + bp;  y = r + gelu(LN2(r) W1 + b1) W2 + b2
// (LayerNorm eps 1e-6 with the biased variance, exact-erf GELU), and the
// backward dx and the 12 weight gradients of the closed form at
// block_pallas.py:249-283, recomputing the forward.
//
// Why another design. block.cu gives a CTA a whole sample with every weight
// in shared memory. At emb 192 / M 768 the weights alone are 1.78 MB and one
// sample's qkv at N 257 is 592 KB, against the 227 KB a CTA can hold; its
// backward's [B, W] weight-gradient partials would be 227 MB at the cifar
// encoder. Here nothing is resident: intermediates live in a float32
// workspace [B N, *] in device memory (L2 holds most of it at the shipped
// shapes), and weights pass through shared memory as k-tiles.
//
// Design. Each direction is one persistent cooperative launch: as many CTAs
// of kThreads threads as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each walking the
// work items of a phase in a grid-stride loop, phases separated by a
// grid-wide barrier (a counter and a generation word at the head of the
// workspace, zeroed by one 8-byte memset before the launch; each wait traps
// after 10 s instead of hanging the card). Phases and their items:
//   forward  P0 qkv = LN1(x) Wqkv + b (LN1's row statistics formed in each
//               tile's prologue, and kept for the backward);
//            P1 attention: a warp a (b, head, 16-query tile, 64-column
//               slice of the head), an online softmax in base 2 over 8-key
//               blocks, the scores over the whole head recomputed in each
//               slice; o and the rows' log2-sum-exp2;
//            P2 r = x + o Wp + bp;  P3 m1 = LN2(r) W1 + b1 (LN2's statistics
//               in the prologue);  P4 y = r + gelu(m1) W2 + b2.
//   backward P0-P3 as the forward (the recompute), then
//            P4 dm1 = (dy W2^T) gelu'(m1) | dW2 = gelu(m1)^T dy | db2;
//            P5 dh2 = dm1 W1^T | dW1 = LN2(r)^T dm1 | db1;
//            P6 dr = dy + LN2 backward (a warp a row) | dln2 scale, bias;
//            P7 do = dr Wp^T | dWp = o^T dr | dbp;
//            P8 attention backward: a warp a (b, head, 16-key tile, slice)
//               for dk, dv over every query, and a warp a (b, head, 16-query
//               tile, slice) for dq over every key, p recomputed from the
//               row's log2-sum-exp2 in each, delta = rowsum(do o) formed by
//               the same sums in both;
//            P9 dh1 = dqkv Wqkv^T | dWqkv = LN1(x)^T dqkv | dbqkv;
//            P10 dx = dr + LN1 backward | dln1 scale, bias;
//            P11 each weight gradient's row slices added in order.
// The phases' work items are functions of their own (__noinline__), each
// compiled once for both kernels. Products are 64 x 64 output tiles of kThreads threads (a warp 16 rows),
// operands staged [64][32] and [32][64] in shared memory with the next
// k-tile's loads in flight in registers, every product 3xTF32 mma.sync
// m16n8k8 (tf32_mma.cuh: each 8-deep step summed from zero, then added with
// one rounding add), and every kChunkK of depth summed from zero before it
// is added to the tile's total. A weight gradient L^T R sums over all B N
// rows: a tile's rows are cut into wgrad_slices fixed slices of at least
// kSliceRows rows, a work item each, written to a [slices, W] workspace and
// added in slice order in P11, so its sum is three levels of fixed order
// (8-deep steps, kChunkK chunks, slices); bias and LayerNorm gradients are
// column sums of three levels too (kSumRows rows a lane, kSumRows such sums,
// then in order). No atomics anywhere: two runs give bitwise-equal outputs.
// Attention at hd < 8 runs on the tensor cores padded to an 8-deep step.
//
// Bound on an H100 SXM (3xTF32 at 495 TFLOP/s, 3.35 TB/s), counting each
// input and output byte once: at (B, N, D, H, M) = (128, 65, 192, 3, 768),
// the vit_som_cifar-10 encoder block, the forward's 2 B N (4D^2 + 2DM) +
// 4 B H N^2 hd = 7.78 GFLOP take 47 us as 3xTF32 (the 14.5 MB 4.3 us) and
// the backward's 23.3 GFLOP 141 us; at N 257 the forward's 35.6 GFLOP take
// 216 us: bound by operations. The workspace traffic, the recomputed scores
// of a sliced head and of the backward's two attention passes, and the
// forward recomputed in the backward are this design's, not the function's,
// and are not counted. This first design is correct before it is fast
// (PERF.md gives its times).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;  // a CTA: 4 warps
constexpr int kWarps = kThreads / 32;
// CTAs an SM the launch bounds ask for: 2 (255 registers) read 1.46 / 4.38
// ms forward / backward at the cifar-10 encoder block, 3 (168) 1.57 / 5.18,
// 4 (128) 1.85 / 6.30 (NVIDIA H100 80GB HBM3, 700.00 W; in turns, one call)
constexpr int kMinBlocks = 2;
constexpr int kTileM = 64;     // rows of a product's output tile (16 a warp)
constexpr int kTileN = 64;     // columns of a product's output tile
constexpr int kTileK = 32;     // depth of a staged k-tile
constexpr int kChunkK = 256;   // depth summed from zero before it joins the total
constexpr int kLdA = kTileK + 4;  // A fragment reads (g * 36 + t) hit 32 banks
constexpr int kLdB = kTileN + 8;  // B fragment reads (t * 72 + g) hit 32 banks
constexpr int kAttnRows = 16;  // query or key rows of an attention warp
constexpr int kAttnCols = 64;  // output columns of an attention warp (a head's slice)
constexpr int kSumRows = 32;   // rows a lane sums from zero in a column sum
constexpr int kSliceRows = 2048;  // rows of a weight-gradient slice, at least
constexpr int kMaxSlices = 16;
constexpr int kAlign = 32;     // floats: every workspace buffer starts on 128 bytes
constexpr int kNumWeights = 12;
constexpr int kBadShape = -1;
constexpr int kSmallWorkspace = -3;
constexpr float kLnEps = 1e-6f;
constexpr float kLog2e = 1.4426950408889634f;
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

__host__ __device__ inline int wrows(int k, int D, int M) {
  return (k == QKV_W || k == PROJ_W || k == FC1_W) ? D : (k == FC2_W ? M : 1);
}

__host__ __device__ inline int wcols(int k, int D, int M) {
  return (k == QKV_W || k == QKV_B) ? 3 * D : ((k == FC1_W || k == FC1_B) ? M : D);
}

// offset of weight k in the packed gradients (WEIGHT_NAMES order, each [in,
// out] row-major), as block.cu packs them
__host__ __device__ inline long long woff(int k, int D, int M) {
  long long off = 0;
  for (int j = 0; j < k; ++j) off += (long long)wrows(j, D, M) * wcols(j, D, M);
  return off;
}

__host__ __device__ inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

__host__ __device__ inline long long aligned(long long n) { return (n + kAlign - 1) / kAlign * kAlign; }

// row slices of a weight gradient's sum over R rows (ops/block_fused.py:
// wgrad_slices)
__host__ __device__ inline int wgrad_slices(long long R) {
  const int s = cdiv(R, kSliceRows);
  return s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s);
}

// The workspace, in floats from its start (ops/block_fused.py:
// workspace_bytes): the barrier's words, then each buffer at a multiple of
// kAlign floats. R = B N rows. The forward's: qkv [R, 3D], o [R, D], r [R,
// D], m1 [R, M] (before GELU), LN1's and LN2's (mean, rstd) [R, 2], the
// rows' log2-sum-exp2 [B, H, N]; the backward's besides: dm1 [R, M], dh2,
// dr, do [R, D], dqkv [R, 3D], dh1 [R, D] and the weight gradients' slices
// [S, W].
struct Layout {
  long long qkv, o, r, m1, st1, st2, lse, dm1, dh2, dr, dout, dqkv, dh1, part, total;
};

// the offset of a buffer of n floats at `at`, which moves past it
__host__ __device__ inline long long take(long long& at, long long n) {
  const long long off = at;
  at += aligned(n);
  return off;
}

__host__ __device__ inline Layout make_layout(int B, int N, int D, int H, int M, bool backward) {
  const long long R = (long long)B * N;
  Layout L;
  long long at = kAlign;  // the barrier's two words
  L.qkv = take(at, R * 3 * D);
  L.o = take(at, R * D);
  L.r = take(at, R * D);
  L.m1 = take(at, R * M);
  L.st1 = take(at, 2 * R);
  L.st2 = take(at, 2 * R);
  L.lse = take(at, R * H);
  L.dm1 = L.dh2 = L.dr = L.dout = L.dqkv = L.dh1 = L.part = 0;
  if (backward) {
    L.dm1 = take(at, R * M);
    L.dh2 = take(at, R * D);
    L.dr = take(at, R * D);
    L.dout = take(at, R * D);
    L.dqkv = take(at, R * 3 * D);
    L.dh1 = take(at, R * D);
    L.part = take(at, (long long)wgrad_slices(R) * woff(kNumWeights, D, M));
  }
  L.total = at;
  return L;
}

struct Params {
  const float* x;
  const float* dy;
  Weights w;
  float* y;
  float* dx;
  float* dw;
  float* ws;
  int B, N, D, H, hd, M;
  float scale;
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ float gelu(float x) { return 0.5f * x * (1.f + erff(x * kInvSqrt2)); }

__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * kInvSqrt2)) + x * kInvSqrt2Pi * expf(-0.5f * x * x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every CTA of the launch waits here until all have arrived; writes before
// it are visible to every CTA after it. bar[0] counts arrivals, bar[1] is
// the generation: the last to arrive resets the count and moves the
// generation on. A wait past 10 s traps (a launch that was not co-resident
// would otherwise hang the card).
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (*gen == seen) {
        __nanosleep(64);
        if (global_ns() - t0 > 10000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// an operand: element (i, j) at p[i * s0 + j * s1], zero outside [rows, cols)
struct Mat {
  const float* p;
  long long s0, s1;
  int rows, cols;
};

// a vector: element c at p[c * s]
struct Vec {
  const float* p;
  long long s;
  __device__ __forceinline__ float operator[](int c) const { return __ldg(p + c * s); }
};

enum ProKind { PRO_NONE, PRO_LN, PRO_GELU };
enum EpiKind { EPI_NONE, EPI_BIAS, EPI_BIAS_RES, EPI_GELU_GRAD };

// C[m0.., n0..] = A B + epilogue, over depths [k_lo, k_hi) of A's columns and
// B's rows. The prologue acts on A's elements as they are loaded: PRO_LN
// (x - mean) rstd scale + bias of an activation row (A's row i, or with
// `trans` its column k: A = L^T) and feature (the other index), the row's
// statistics in `stats` [R, 2] (without `trans` the tile forms them itself
// and, from its first column tile, stores them there); PRO_GELU gelu(x).
struct Gemm {
  Mat a, b;
  int pro, trans;
  float* stats;
  Vec ln_s, ln_b;
  int epi;
  Vec bias;
  const float* aux;  // EPI_BIAS_RES: the residual; EPI_GELU_GRAD: m1
  long long ld_aux;
  float* c;
  long long ldc;
  int k_lo, k_hi;
};

struct Smem {
  float a[kTileM * kLdA];
  float b[kTileK * kLdB];
  float stats[kTileM * 2];
  float sums[kWarps * 32];
};

// a CTA's shared memory, 19.4 KB, static (named here, not passed, so the
// out-of-line work items address it as shared memory)
__shared__ Smem sm;

// the (mean, rstd) of rows m0.. of the activations a ([rows, cols]) into
// st, a warp 16 rows, lanes over the columns and a butterfly sum; with
// `keep` also into stats [R, 2]
__device__ __noinline__ void tile_row_stats(Mat a, float* stats, int m0, float* st, bool keep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, C = a.cols;
  for (int i = 16 * warp; i < 16 * warp + 16; ++i) {
    const int row = m0 + i;
    float mean = 0.f, rstd = 0.f;
    if (row < a.rows) {
      const float* x = a.p + row * a.s0;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += x[c * a.s1];
      mean = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = x[c * a.s1] - mean;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / C + kLnEps);
      if (keep && lane == 0) {
        stats[2 * row] = mean;
        stats[2 * row + 1] = rstd;
      }
    }
    if (lane == 0) {
      st[2 * i] = mean;
      st[2 * i + 1] = rstd;
    }
  }
}

// the prologue on A's element (i, k), loaded as v
__device__ __forceinline__ float a_pro(const Gemm& g, const float* st, int m0, int i, int k, float v) {
  if (g.pro == PRO_LN) {
    const int row = g.trans ? k : i, f = g.trans ? i : k;
    const float mean = g.trans ? g.stats[2 * row] : st[2 * (i - m0)];
    const float rstd = g.trans ? g.stats[2 * row + 1] : st[2 * (i - m0) + 1];
    v = (v - mean) * rstd * g.ln_s[f] + g.ln_b[f];
  } else if (g.pro == PRO_GELU) {
    v = gelu(v);
  }
  return v;
}

constexpr int kPerThreadA = kTileM * kTileK / kThreads;  // 16
constexpr int kPerThreadB = kTileK * kTileN / kThreads;  // 16

// element u of this thread's share of a k-tile: (row, depth) of A, with
// consecutive threads on consecutive addresses of A's unit-stride index
__device__ __forceinline__ void a_coord(const Gemm& g, int u, int* i, int* k) {
  const int e = threadIdx.x + kThreads * u;
  if (g.a.s1 == 1) {
    *i = e / kTileK;
    *k = e % kTileK;
  } else {
    *i = e % kTileM;
    *k = e / kTileM;
  }
}

__device__ __forceinline__ void b_coord(const Gemm& g, int u, int* k, int* j) {
  const int e = threadIdx.x + kThreads * u;
  if (g.b.s1 == 1) {
    *k = e / kTileN;
    *j = e % kTileN;
  } else {
    *k = e % kTileK;
    *j = e / kTileK;
  }
}

__device__ __forceinline__ void load_tiles(const Gemm& g, int m0, int n0, int k0,
                                           float (&ra)[kPerThreadA], float (&rb)[kPerThreadB]) {
#pragma unroll
  for (int u = 0; u < kPerThreadA; ++u) {
    int i, k;
    a_coord(g, u, &i, &k);
    const int gi = m0 + i, gk = k0 + k;
    ra[u] = gi < g.a.rows && gk < g.k_hi ? g.a.p[gi * g.a.s0 + gk * g.a.s1] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPerThreadB; ++u) {
    int k, j;
    b_coord(g, u, &k, &j);
    const int gk = k0 + k, gj = n0 + j;
    rb[u] = gk < g.k_hi && gj < g.b.cols ? g.b.p[gk * g.b.s0 + gj * g.b.s1] : 0.f;
  }
}

__device__ __forceinline__ void store_tiles(const Gemm& g, int m0, int k0,
                                            const float (&ra)[kPerThreadA],
                                            const float (&rb)[kPerThreadB]) {
#pragma unroll
  for (int u = 0; u < kPerThreadA; ++u) {
    int i, k;
    a_coord(g, u, &i, &k);
    const int gi = m0 + i, gk = k0 + k;
    sm.a[i * kLdA + k] = g.pro != PRO_NONE && gi < g.a.rows && gk < g.k_hi
                             ? a_pro(g, sm.stats, m0, gi, gk, ra[u]) : ra[u];
  }
#pragma unroll
  for (int u = 0; u < kPerThreadB; ++u) {
    int k, j;
    b_coord(g, u, &k, &j);
    sm.b[k * kLdB + j] = rb[u];
  }
}

// one 64 x 64 output tile of gin (tile index over row tiles x column
// tiles). The descriptor is copied and the copy handed to nothing out of
// line, so its fields stay in registers: read through the reference, every
// element's address waited on 64-bit loads of them from local memory
__device__ __noinline__ void gemm_tile(const Gemm& gin, int tile) {
  const Gemm g = gin;
  const int tiles_n = cdiv(g.b.cols, kTileN);
  const int m0 = tile / tiles_n * kTileM, n0 = tile % tiles_n * kTileN;
  const int warp = threadIdx.x >> 5, gq = lane_g(), t = lane_t();
  __syncthreads();  // the previous item is done with the shared tiles
  if (g.pro == PRO_LN && !g.trans) {
    tile_row_stats(g.a, g.stats, m0, sm.stats, n0 == 0);
    __syncthreads();
  }
  float acc[8][4], part[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = part[n][e] = 0.f;
  float ra[kPerThreadA], rb[kPerThreadB];
  load_tiles(g, m0, n0, g.k_lo, ra, rb);
  for (int k0 = g.k_lo; k0 < g.k_hi; k0 += kTileK) {
    __syncthreads();
    store_tiles(g, m0, k0, ra, rb);
    __syncthreads();
    if (k0 + kTileK < g.k_hi) load_tiles(g, m0, n0, k0 + kTileK, ra, rb);
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const float* ap = sm.a + (16 * warp + gq) * kLdA + 8 * ks + t;
      const Frag fa = split_a(ap[0], ap[8 * kLdA], ap[4], ap[8 * kLdA + 4]);
      const float* bp = sm.b + (8 * ks + t) * kLdB + gq;
#pragma unroll
      for (int n = 0; n < 8; ++n) mma3(part[n], fa, bp[8 * n], bp[4 * kLdB + 8 * n]);
    }
    const int done = k0 + kTileK - g.k_lo;
    if (done % kChunkK == 0 || k0 + kTileK >= g.k_hi) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] += part[n][e];
          part[n][e] = 0.f;
        }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + 16 * warp + gq + 8 * (e >> 1), col = n0 + 8 * n + 2 * t + (e & 1);
      if (row >= g.a.rows || col >= g.b.cols) continue;
      float v = acc[n][e];
      if (g.epi == EPI_BIAS) {
        v += g.bias[col];
      } else if (g.epi == EPI_BIAS_RES) {
        v = g.aux[row * g.ld_aux + col] + (v + g.bias[col]);
      } else if (g.epi == EPI_GELU_GRAD) {
        v *= gelu_grad(g.aux[row * g.ld_aux + col]);
      }
      g.c[row * g.ldc + col] = v;
    }
}

__device__ __forceinline__ int gemm_tiles(const Gemm& g) {
  return cdiv(g.a.rows, kTileM) * cdiv(g.b.cols, kTileN);
}

// ---------------------------------------------------------------------------
// column sums and row phases
// ---------------------------------------------------------------------------

// out[c] = sum over rows of src[r][c], times xhat(act[r][c]) when `act` is
// given (a LayerNorm scale's gradient, stats the rows' (mean, rstd))
struct ColSum {
  const float* src;
  long long ld;
  const float* act;
  long long ld_act;
  const float* stats;
  float* out;
  int cols;
};

// 32 columns of s: a lane a column, warp w the kSumRows-row chunks w, w + 4,
// ...: a chunk summed from zero, kSumRows chunks summed, those sums added in
// order, then the four warps' totals in warp order
__device__ __noinline__ void colsum_item(const ColSum& sin, int group, int R) {
  const ColSum s = sin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = 32 * group + lane;
  float total = 0.f, level = 0.f;
  int chunks = 0;
  if (col < s.cols) {
    for (int r0 = kSumRows * warp; r0 < R; r0 += kSumRows * kWarps) {
      float part = 0.f;
      const int r1 = min(r0 + kSumRows, R);
      for (int r = r0; r < r1; ++r) {
        float v = s.src[r * s.ld + col];
        if (s.act) v *= (s.act[r * s.ld_act + col] - s.stats[2 * r]) * s.stats[2 * r + 1];
        part += v;
      }
      level += part;
      if (++chunks == kSumRows) {
        total += level;
        level = 0.f;
        chunks = 0;
      }
    }
    total += level;
  }
  __syncthreads();
  sm.sums[32 * warp + lane] = total;
  __syncthreads();
  if (warp == 0 && col < s.cols) {
    float v = sm.sums[lane];
    for (int w = 1; w < kWarps; ++w) v += sm.sums[32 * w + lane];
    s.out[col] = v;
  }
}

// LayerNorm backward of one row: out = base + rstd (ds - mean(ds) - xhat
// mean(ds xhat)), ds = dh * scale, xhat from act and the row's statistics
__device__ __noinline__ void ln_bwd_row(int row, const float* dh, const float* act, const float* stats, Vec sc,
                           const float* base, float* out, int D) {
  const int lane = threadIdx.x & 31;
  const float mean = stats[2 * row], rstd = stats[2 * row + 1];
  const long long o = (long long)row * D;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float ds = dh[o + c] * sc[c], xh = (act[o + c] - mean) * rstd;
    s1 += ds;
    s2 += ds * xh;
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int c = lane; c < D; c += 32) {
    const float ds = dh[o + c] * sc[c], xh = (act[o + c] - mean) * rstd;
    out[o + c] = base[o + c] + rstd * (ds - m1 - xh * m2);
  }
}

// ---------------------------------------------------------------------------
// attention, a warp an item, over the qkv buffer [R, 3D] (q, k, v of head h
// at columns h hd, D + h hd, 2 D + h hd)
// ---------------------------------------------------------------------------

struct Attn {
  const float* qkv;
  float* o;         // [R, D]
  float* lse;       // [B, H, N], log2-sum-exp2 of the scaled scores
  const float* dout;  // [R, D]
  float* dqkv;      // [R, 3D]
  int N, D, H, hd;
  float scale;
};

// (b, h, 16-row tile, column slice) of an item number
__device__ __forceinline__ void attn_job(const Attn& a, int job, int* b, int* h, int* tile,
                                         int* slice) {
  const int slices = cdiv(a.hd, kAttnCols), tiles = cdiv(a.N, kAttnRows);
  *slice = job % slices;
  job /= slices;
  *tile = job % tiles;
  job /= tiles;
  *h = job % a.H;
  *b = job / a.H;
}

__device__ __forceinline__ int attn_jobs(const Attn& a, int B) {
  return B * a.H * cdiv(a.N, kAttnRows) * cdiv(a.hd, kAttnCols);
}

// element (row i, column d) of head h's q (which 0), k (1), v (2) or do (3)
// of batch row b, zero past N and hd
__device__ __forceinline__ float head_elem(const Attn& a, int which, int b, int h, int i, int d) {
  if (i >= a.N || d >= a.hd) return 0.f;
  const long long row = (long long)b * a.N + i;
  if (which == 3) return a.dout[row * a.D + h * a.hd + d];
  return a.qkv[row * 3 * a.D + which * a.D + h * a.hd + d];
}

// delta = rowsum(do o) over the head for rows r0 .. r0 + 7: lane l sums row
// r0 + (l & 7) over columns = l / 8 (mod 4), the four partials added by a
// butterfly; lane l (l < 8) then holds row r0 + l's
__device__ __forceinline__ float delta8(const Attn& a, int b, int h, int r0) {
  const int lane = threadIdx.x & 31, i = r0 + (lane & 7);
  float v = 0.f;
  if (i < a.N) {
    const long long row = (long long)b * a.N + i;
    const float* dr = a.dout + row * a.D + h * a.hd;
    const float* orow = a.o + row * a.D + h * a.hd;
    for (int d = lane >> 3; d < a.hd; d += 4) v = fmaf(dr[d], orow[d], v);
  }
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// s (16 x 8) += rows r0.. of `wa` times rows c0.. of `wb`, transposed, over
// the head's columns: s[e] is row r0 + g + 8 (e / 2), column c0 + 2 t + (e & 1)
__device__ __forceinline__ void head_scores(const Attn& a, int wa, int wb, int b, int h, int r0,
                                            int c0, float (&s)[4]) {
  const int g = lane_g(), t = lane_t();
  for (int d0 = 0; d0 < a.hd; d0 += 8) {
    const Frag fa = split_a(head_elem(a, wa, b, h, r0 + g, d0 + t),
                            head_elem(a, wa, b, h, r0 + g + 8, d0 + t),
                            head_elem(a, wa, b, h, r0 + g, d0 + t + 4),
                            head_elem(a, wa, b, h, r0 + g + 8, d0 + t + 4));
    mma3(s, fa, head_elem(a, wb, b, h, c0 + g, d0 + t), head_elem(a, wb, b, h, c0 + g, d0 + t + 4));
  }
}

// acc[n] += p (16 x 8, as a C tile) times rows j0.. of `wb` at the slice's
// columns col0 + 8 n ..
__device__ __forceinline__ void head_product(const Attn& a, const float (&p)[4], int wb, int b,
                                             int h, int j0, int col0, float (&acc)[8][4]) {
  const int g = lane_g(), t = lane_t();
  const Frag f = split_a(p[0], p[2], p[1], p[3]);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = col0 + 8 * n + g;
    if (col0 + 8 * n < a.hd)
      mma3(acc[n], f, head_elem(a, wb, b, h, j0 + 2 * t, col),
           head_elem(a, wb, b, h, j0 + 2 * t + 1, col));
  }
}

// stores acc (16 rows from r0, the slice's columns) into dst [R, ld] at
// column offset off + col0, rows < N, columns < hd; each value times
// inv[e / 2] when `inv` is given
__device__ __forceinline__ void store_head(const Attn& a, const float (&acc)[8][4], float* dst,
                                          long long ld, long long off, int b, int r0, int col0,
                                          const float* inv) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = col0 + 8 * n + 2 * t + (e & 1);
      if (row < a.N && col < a.hd) {
        const float v = inv ? acc[n][e] / inv[e >> 1] : acc[n][e];
        dst[((long long)b * a.N + row) * ld + off + col] = v;
      }
    }
}

// forward item: o and log2-sum-exp2 of a 16-query tile's column slice
__device__ __noinline__ void attn_fwd_warp(const Attn& ain, int job) {
  const Attn a = ain;
  int b, h, tile, slice;
  attn_job(a, job, &b, &h, &tile, &slice);
  const int t = lane_t(), i0 = kAttnRows * tile, col0 = kAttnCols * slice;
  const float sl = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j0 = 0; j0 < a.N; j0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    head_scores(a, 0, 1, b, h, i0, j0, s);
    float p[4], mx[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = j0 + 2 * t + (e & 1) < a.N ? s[e] * sl : -INFINITY;
    mx[0] = fmaxf(m[0], quad_max(fmaxf(p[0], p[1])));  // finite: key j0 < N
    mx[1] = fmaxf(m[1], quad_max(fmaxf(p[2], p[3])));
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) corr[r] = exp2f(m[r] - mx[r]);  // 0 at the first block
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp2f(p[e] - mx[e >> 1]);
    l[0] = fmaf(l[0], corr[0], quad_sum(p[0] + p[1]));
    l[1] = fmaf(l[1], corr[1], quad_sum(p[2] + p[3]));
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    head_product(a, p, 2, b, h, j0, col0, acc);
  }
  store_head(a, acc, a.o, a.D, (long long)h * a.hd, b, i0, col0, l);
  if (slice == 0 && t == 0) {
    const int g = lane_g();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i < a.N) a.lse[((long long)b * a.H + h) * a.N + i] = m[r] + log2f(l[r]);
    }
  }
}

// backward item, key role: dk and dv of a 16-key tile's column slice,
// summed over 8-query blocks: s^T = k q^T, dp^T = v do^T, p^T = exp2(s^T
// scale log2e - lse), ds^T = p^T (dp^T - delta) scale, dv += p^T do, dk +=
// ds^T q
__device__ __noinline__ void attn_dkdv_warp(const Attn& ain, int job) {
  const Attn a = ain;
  int b, h, tile, slice;
  attn_job(a, job, &b, &h, &tile, &slice);
  const int g = lane_g(), t = lane_t(), k0 = kAttnRows * tile, col0 = kAttnCols * slice;
  const float sl = a.scale * kLog2e;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.N;
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int q0 = 0; q0 < a.N; q0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    head_scores(a, 1, 0, b, h, k0, q0, s);
    head_scores(a, 2, 3, b, h, k0, q0, dp);
    const float d8 = delta8(a, b, h, q0);
    float lq[2], dq[2];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int qi = q0 + 2 * t + z;
      lq[z] = qi < a.N ? lse[qi] : 0.f;
      dq[z] = __shfl_sync(0xffffffffu, d8, 2 * t + z);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = k0 + g + 8 * (e >> 1) < a.N && q0 + 2 * t + (e & 1) < a.N;
      const float p = in ? exp2f(s[e] * sl - lq[e & 1]) : 0.f;
      dp[e] = in ? p * (dp[e] - dq[e & 1]) * a.scale : 0.f;
      s[e] = p;
    }
    head_product(a, s, 3, b, h, q0, col0, dv);
    head_product(a, dp, 0, b, h, q0, col0, dk);
  }
  store_head(a, dk, a.dqkv, 3 * a.D, a.D + (long long)h * a.hd, b, k0, col0, nullptr);
  store_head(a, dv, a.dqkv, 3 * a.D, 2 * a.D + (long long)h * a.hd, b, k0, col0, nullptr);
}

// backward item, query role: dq of a 16-query tile's column slice, summed
// over 8-key blocks: s = q k^T, dp = do v^T, ds = p (dp - delta) scale, dq
// += ds k
__device__ __noinline__ void attn_dq_warp(const Attn& ain, int job) {
  const Attn a = ain;
  int b, h, tile, slice;
  attn_job(a, job, &b, &h, &tile, &slice);
  const int g = lane_g(), t = lane_t(), i0 = kAttnRows * tile, col0 = kAttnCols * slice;
  const float sl = a.scale * kLog2e;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.N;
  const float da = __shfl_sync(0xffffffffu, delta8(a, b, h, i0), g);
  const float db = __shfl_sync(0xffffffffu, delta8(a, b, h, i0 + 8), g);
  const float dl[2] = {da, db};
  float lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lr[r] = i0 + g + 8 * r < a.N ? lse[i0 + g + 8 * r] : 0.f;
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  for (int j0 = 0; j0 < a.N; j0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    head_scores(a, 0, 1, b, h, i0, j0, s);
    head_scores(a, 3, 2, b, h, i0, j0, dp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool in = i0 + g + 8 * r < a.N && j0 + 2 * t + (e & 1) < a.N;
      const float p = in ? exp2f(s[e] * sl - lr[r]) : 0.f;
      dp[e] = in ? p * (dp[e] - dl[r]) * a.scale : 0.f;
    }
    head_product(a, dp, 1, b, h, j0, col0, dq);
  }
  store_head(a, dq, a.dqkv, 3 * a.D, (long long)h * a.hd, b, i0, col0, nullptr);
}

// ---------------------------------------------------------------------------
// the phases
// ---------------------------------------------------------------------------

__device__ __forceinline__ Vec wvec(const Weights& w, int k) { return Vec{w.ptr[k], w.s1[k]}; }

// weight k as a product's B operand ([in, out]), or transposed ([out, in])
__device__ __forceinline__ Mat wmat(const Params& p, int k, bool transpose) {
  const int rows = wrows(k, p.D, p.M), cols = wcols(k, p.D, p.M);
  if (transpose) return Mat{p.w.ptr[k], p.w.s1[k], p.w.s0[k], cols, rows};
  return Mat{p.w.ptr[k], p.w.s0[k], p.w.s1[k], rows, cols};
}

// an activation [R, C] (row stride C) as a product's A or B operand, or
// transposed ([C, R]: a weight gradient's L^T)
__device__ __forceinline__ Mat act(const float* x, int R, int C, bool transpose = false) {
  if (transpose) return Mat{x, 1, C, C, R};
  return Mat{x, C, 1, R, C};
}

__device__ __forceinline__ Gemm product(Mat a, Mat b, float* c, long long ldc) {
  Gemm g;
  g.a = a;
  g.b = b;
  g.pro = PRO_NONE;
  g.trans = 0;
  g.stats = nullptr;
  g.ln_s = g.ln_b = g.bias = Vec{nullptr, 0};
  g.epi = EPI_NONE;
  g.aux = nullptr;
  g.ld_aux = 0;
  g.c = c;
  g.ldc = ldc;
  g.k_lo = 0;
  g.k_hi = a.cols;
  return g;
}

__device__ __forceinline__ Gemm with_ln(Gemm g, float* stats, Vec s, Vec b, int trans) {
  g.pro = PRO_LN;
  g.stats = stats;
  g.ln_s = s;
  g.ln_b = b;
  g.trans = trans;
  return g;
}

__device__ __forceinline__ Gemm with_epi(Gemm g, int kind, Vec bias, const float* aux,
                                         long long ld_aux) {
  g.epi = kind;
  g.bias = bias;
  g.aux = aux;
  g.ld_aux = ld_aux;
  return g;
}

// the forward's workspace pointers
struct Buffers {
  float *qkv, *o, *r, *m1, *st1, *st2, *lse, *dm1, *dh2, *dr, *dout, *dqkv, *dh1, *part;
  unsigned* bar;
};

__device__ __forceinline__ Buffers buffers(const Params& p, bool backward) {
  const Layout L = make_layout(p.B, p.N, p.D, p.H, p.M, backward);
  float* w = p.ws;
  return Buffers{w + L.qkv, w + L.o,   w + L.r,    w + L.m1,   w + L.st1,
                 w + L.st2, w + L.lse, w + L.dm1,  w + L.dh2,  w + L.dr,
                 w + L.dout, w + L.dqkv, w + L.dh1, w + L.part, reinterpret_cast<unsigned*>(w)};
}

__device__ __forceinline__ Attn attn_of(const Params& p, const Buffers& bf) {
  return Attn{bf.qkv, bf.o, bf.lse, bf.dout, bf.dqkv, p.N, p.D, p.H, p.hd, p.scale};
}

// a phase: `gemms` products (weight-gradient slices first: the longest
// items), `sums` column sums, `rows` rows of a row function (a warp a row,
// 4 a CTA item) and `attn` attention warp items (4 a CTA item), spread over
// the CTAs in one grid-stride loop
struct Phase {
  Gemm gemm[2];
  int gemm_items[2];  // items of each product: tiles x its slices
  int slices[2];
  int ngemm;
  ColSum sum[3];
  int nsum;
  int row_kind;  // 0 none, 1 LN2 backward, 2 LN1 backward
  int attn_kind;  // 0 none, 1 forward, 2 backward (key and query roles)
};

__device__ Phase empty_phase() {
  Phase ph;
  ph.ngemm = ph.nsum = ph.row_kind = ph.attn_kind = 0;
  return ph;
}

__device__ void add_gemm(Phase& ph, const Gemm& g, int slices = 1) {
  ph.gemm[ph.ngemm] = g;
  ph.slices[ph.ngemm] = slices;
  ph.gemm_items[ph.ngemm] = gemm_tiles(g) * slices;
  ++ph.ngemm;
}

__device__ void add_sum(Phase& ph, const float* src, long long ld, int cols, float* out,
                        const float* act_ = nullptr, long long ld_act = 0,
                        const float* stats = nullptr) {
  ph.sum[ph.nsum++] = ColSum{src, ld, act_, ld_act, stats, out, cols};
}

__device__ __noinline__ void run_phase(const Params& p, const Buffers& bf, const Phase& ph) {
  const int R = p.B * p.N, warp = threadIdx.x >> 5;
  int counts[8], n = 0;
  for (int i = 0; i < ph.ngemm; ++i) counts[n++] = ph.gemm_items[i];
  for (int i = 0; i < ph.nsum; ++i) counts[n++] = cdiv(ph.sum[i].cols, 32);
  const Attn a = attn_of(p, bf);
  const int attn_warps = ph.attn_kind ? attn_jobs(a, p.B) * ph.attn_kind : 0;
  counts[n++] = ph.row_kind ? cdiv(R, kWarps) : 0;
  counts[n++] = cdiv(attn_warps, kWarps);
  int total = 0;
  for (int i = 0; i < n; ++i) total += counts[i];
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int k = item, kind = 0;
    while (k >= counts[kind]) k -= counts[kind++];
    if (kind < ph.ngemm) {
      Gemm g = ph.gemm[kind];
      const int slices = ph.slices[kind];
      if (slices > 1) {  // a weight-gradient slice: rows [lo, hi) into part[s]
        const int s = k % slices, span = cdiv(g.k_hi, slices);
        k /= slices;
        g.k_lo = s * span;
        g.k_hi = min(g.k_hi, g.k_lo + span);
        g.c += (long long)s * woff(kNumWeights, p.D, p.M);
      }
      gemm_tile(g, k);
    } else if (kind < ph.ngemm + ph.nsum) {
      colsum_item(ph.sum[kind - ph.ngemm], k, R);
    } else if (kind == ph.ngemm + ph.nsum) {
      const int row = kWarps * k + warp;
      if (row >= R) continue;
      if (ph.row_kind == 1)
        ln_bwd_row(row, bf.dh2, bf.r, bf.st2, wvec(p.w, LN2_S), p.dy, bf.dr, p.D);
      else
        ln_bwd_row(row, bf.dh1, p.x, bf.st1, wvec(p.w, LN1_S), bf.dr, p.dx, p.D);
    } else {
      const int job = kWarps * k + warp;
      if (job >= attn_warps) continue;
      const int per_role = attn_jobs(a, p.B);
      if (ph.attn_kind == 1) attn_fwd_warp(a, job);
      else if (job < per_role) attn_dkdv_warp(a, job);
      else attn_dq_warp(a, job - per_role);
    }
  }
  grid_sync(bf.bar);
}

// P0-P3: qkv, attention, r, m1 (and LN1's, LN2's statistics, the lse)
__device__ void forward_phases(const Params& p, const Buffers& bf, bool backward) {
  const int R = p.B * p.N, D = p.D, M = p.M;
  Phase ph = empty_phase();
  add_gemm(ph, with_epi(with_ln(product(act(p.x, R, D), wmat(p, QKV_W, false), bf.qkv, 3 * D),
                                bf.st1, wvec(p.w, LN1_S), wvec(p.w, LN1_B), 0),
                        EPI_BIAS, wvec(p.w, QKV_B), nullptr, 0));
  if (backward) add_sum(ph, p.dy, D, D, p.dw + woff(FC2_B, D, M));
  run_phase(p, bf, ph);

  ph = empty_phase();
  ph.attn_kind = 1;
  run_phase(p, bf, ph);

  ph = empty_phase();
  add_gemm(ph, with_epi(product(act(bf.o, R, D), wmat(p, PROJ_W, false), bf.r, D), EPI_BIAS_RES,
                        wvec(p.w, PROJ_B), p.x, D));
  run_phase(p, bf, ph);

  ph = empty_phase();
  add_gemm(ph, with_epi(with_ln(product(act(bf.r, R, D), wmat(p, FC1_W, false), bf.m1, M), bf.st2,
                                wvec(p.w, LN2_S), wvec(p.w, LN2_B), 0),
                        EPI_BIAS, wvec(p.w, FC1_B), nullptr, 0));
  run_phase(p, bf, ph);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) block_fwd_streamed(Params p) {
  const Buffers bf = buffers(p, false);
  forward_phases(p, bf, false);
  // P4: y = r + gelu(m1) W2 + b2 (no barrier after the last phase)
  const int R = p.B * p.N;
  Gemm g = with_epi(product(act(bf.m1, R, p.M), wmat(p, FC2_W, false), p.y, p.D), EPI_BIAS_RES,
                    wvec(p.w, FC2_B), bf.r, p.D);
  g.pro = PRO_GELU;
  for (int item = blockIdx.x; item < gemm_tiles(g); item += gridDim.x) gemm_tile(g, item);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) block_bwd_streamed(Params p) {
  const Buffers bf = buffers(p, true);
  forward_phases(p, bf, true);
  const int R = p.B * p.N, D = p.D, M = p.M, S = wgrad_slices(R);
  float* part = bf.part;

  // P4: dm1 = (dy W2^T) gelu'(m1); dW2 = gelu(m1)^T dy
  Phase ph = empty_phase();
  Gemm w2 = product(act(bf.m1, R, M, true), act(p.dy, R, D), part + woff(FC2_W, D, M), D);
  w2.pro = PRO_GELU;
  add_gemm(ph, w2, S);
  add_gemm(ph, with_epi(product(act(p.dy, R, D), wmat(p, FC2_W, true), bf.dm1, M), EPI_GELU_GRAD,
                        Vec{nullptr, 0}, bf.m1, M));
  run_phase(p, bf, ph);

  // P5: dh2 = dm1 W1^T; dW1 = LN2(r)^T dm1; db1
  ph = empty_phase();
  add_gemm(ph, with_ln(product(act(bf.r, R, D, true), act(bf.dm1, R, M), part + woff(FC1_W, D, M), M),
                       bf.st2, wvec(p.w, LN2_S), wvec(p.w, LN2_B), 1), S);
  add_gemm(ph, product(act(bf.dm1, R, M), wmat(p, FC1_W, true), bf.dh2, D));
  add_sum(ph, bf.dm1, M, M, p.dw + woff(FC1_B, D, M));
  run_phase(p, bf, ph);

  // P6: dr = dy + LN2 backward; dln2 scale and bias
  ph = empty_phase();
  ph.row_kind = 1;
  add_sum(ph, bf.dh2, D, D, p.dw + woff(LN2_S, D, M), bf.r, D, bf.st2);
  add_sum(ph, bf.dh2, D, D, p.dw + woff(LN2_B, D, M));
  run_phase(p, bf, ph);

  // P7: do = dr Wp^T; dWp = o^T dr; dbp
  ph = empty_phase();
  add_gemm(ph, product(act(bf.o, R, D, true), act(bf.dr, R, D), part + woff(PROJ_W, D, M), D), S);
  add_gemm(ph, product(act(bf.dr, R, D), wmat(p, PROJ_W, true), bf.dout, D));
  add_sum(ph, bf.dr, D, D, p.dw + woff(PROJ_B, D, M));
  run_phase(p, bf, ph);

  // P8: attention backward into dqkv
  ph = empty_phase();
  ph.attn_kind = 2;
  run_phase(p, bf, ph);

  // P9: dh1 = dqkv Wqkv^T; dWqkv = LN1(x)^T dqkv; dbqkv
  ph = empty_phase();
  add_gemm(ph, with_ln(product(act(p.x, R, D, true), act(bf.dqkv, R, 3 * D),
                               part + woff(QKV_W, D, M), 3 * D),
                       bf.st1, wvec(p.w, LN1_S), wvec(p.w, LN1_B), 1), S);
  add_gemm(ph, product(act(bf.dqkv, R, 3 * D), wmat(p, QKV_W, true), bf.dh1, D));
  add_sum(ph, bf.dqkv, 3 * D, 3 * D, p.dw + woff(QKV_B, D, M));
  run_phase(p, bf, ph);

  // P10: dx = dr + LN1 backward; dln1 scale and bias
  ph = empty_phase();
  ph.row_kind = 2;
  add_sum(ph, bf.dh1, D, D, p.dw + woff(LN1_S, D, M), p.x, D, bf.st1);
  add_sum(ph, bf.dh1, D, D, p.dw + woff(LN1_B, D, M));
  run_phase(p, bf, ph);

  // P11: the four weight matrices' slices added in slice order
  const int mats[4] = {QKV_W, PROJ_W, FC1_W, FC2_W};
  const long long W = woff(kNumWeights, D, M);
  for (int i = 0; i < 4; ++i) {
    const long long lo = woff(mats[i], D, M), n = (long long)wrows(mats[i], D, M) * wcols(mats[i], D, M);
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
         e += (long long)gridDim.x * kThreads) {
      float v = part[lo + e];
      for (int s = 1; s < S; ++s) v += part[s * W + lo + e];
      p.dw[lo + e] = v;
    }
  }
}

template <typename Kernel>
int grid_of(Kernel kernel, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return *per_sm * *sms;
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

template <typename Kernel>
int launch(Kernel kernel, Params p, long long ws_floats, bool backward, cudaStream_t s) {
  if (p.B < 1 || p.N < 1 || p.D < 1 || p.H < 1 || p.M < 1 || p.D % p.H) return kBadShape;
  if (ws_floats < make_layout(p.B, p.N, p.D, p.H, p.M, backward).total) return kSmallWorkspace;
  int per_sm = 0, sms = 0;
  const int grid = grid_of(kernel, &per_sm, &sms);
  if (grid <= 0) return grid < 0 ? -grid : kBadShape;
  cudaError_t err = cudaMemsetAsync(p.ws, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The constants ops/block_fused.py plans the workspace and the grid with:
// {kThreads, kTileM, kTileN, kTileK, kChunkK, kAttnRows, kAttnCols,
// kSumRows, kSliceRows, kMaxSlices, kAlign}.
extern "C" void block_streamed_constants(int* out) {
  const int c[] = {kThreads, kTileM, kTileN, kTileK, kChunkK, kAttnRows,
                   kAttnCols, kSumRows, kSliceRows, kMaxSlices, kAlign};
  for (int i = 0; i < 11; ++i) out[i] = c[i];
}

// The persistent grid: out = {CTAs, CTAs an SM, SMs}. Returns 0 or a CUDA
// error code.
extern "C" int block_streamed_grid(int backward, int* out) {
  const int grid = backward ? grid_of(block_bwd_streamed, out + 1, out + 2)
                            : grid_of(block_fwd_streamed, out + 1, out + 2);
  out[0] = grid > 0 ? grid : 0;
  return grid > 0 ? 0 : -grid;
}

// Both entry points launch on `stream` (one 8-byte memset of the barrier,
// then one cooperative kernel), allocate nothing and return
// cudaGetLastError() as an int (0 on success), -1 for a malformed shape or
// -3 for a workspace smaller than the layout needs (ops/block_fused.py:
// workspace_bytes gives it). x, dy, y, dx
// are contiguous [B, N, D]. The 12 weights come as pointers `wptr` in
// WEIGHT_NAMES order, each with its two strides (rows, columns; in floats)
// in `wstride`. `ws` is the workspace (ws_floats floats, 128-byte aligned).
// The backward writes the weight gradients to `dw`, packed in WEIGHT_NAMES
// order with each weight [in, out] row-major.
extern "C" int block_streamed_forward(const float* x, const void* const* wptr,
                                      const long long* wstride, float* y, float* ws,
                                      long long ws_floats, int B, int N, int D, int H, int M,
                                      float scale, void* stream) {
  Params p{x, nullptr, make_weights(wptr, wstride), y, nullptr, nullptr, ws,
           B, N, D, H, H > 0 ? D / H : 0, M, scale};
  return launch(block_fwd_streamed, p, ws_floats, false, static_cast<cudaStream_t>(stream));
}

extern "C" int block_streamed_backward(const float* x, const float* dy, const void* const* wptr,
                                       const long long* wstride, float* dx, float* dw, float* ws,
                                       long long ws_floats, int B, int N, int D, int H, int M,
                                       float scale, void* stream) {
  Params p{x, dy, make_weights(wptr, wstride), nullptr, dx, dw, ws,
           B, N, D, H, H > 0 ? D / H : 0, M, scale};
  return launch(block_bwd_streamed, p, ws_floats, true, static_cast<cudaStream_t>(stream));
}
