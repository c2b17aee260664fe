// Fused SOM forward for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel vitsom_tpu/ops/som_pallas.py:_som_kernel (launched
// by _forward_impl, wrapped by make_fused_som). It computes, for latents
// x [B, D] and prototypes p [P, D]:
//   dist [B, P]  cosine 1 - x.p / (|x| |p|)  or euclidean |x - p|
//   bmu  [B]     argmin over P, the first index on a tie
//   loss []      mean over B*P of w * dist, with analytic Gaussian weights
//                w = exp(-d2 / (2 T^2)) from square/hexa grid coordinates
//
// The Pallas kernel streams prototype tiles through one sequential grid and
// finalizes on its last step (som_pallas.py:133). CUDA blocks run in no
// order, so the work is two launches on one stream:
//   (a) som_partial_kernel: a grid of (128-prototype tiles, 64-row batch
//       tiles, S splits of D). Each split owns a contiguous range of D made
//       of whole 32-deep chunks (the last split may be shorter), so the grid
//       fills the card where the output has few tiles (2 at P 16, 4 at
//       P 196). A CTA is a consumer and two producer warpgroups:
//       - the producers copy each chunk of x and p with cp.async (16 bytes
//         a thread, zero-filled past the ragged B, P and D edges) into a
//         ring of 3 shared-memory stages, in the 128-byte-swizzled layout
//         the tensor cores read, then split every value a into a TF32
//         "big" part (in place) and a TF32 "small" residual beside it,
//         big = rna(a), small = rna(a - big), and add the squares of the
//         raw values to the rows' norms; an mbarrier hands the stage over
//         (one producer warpgroup alone kept the consumer waiting);
//       - the consumer multiplies each chunk with wgmma m64n128k8 in the
//         3xTF32 form, small*big + big*small + big*big from shared memory,
//         which keeps float32 accuracy (one TF32 product alone keeps about
//         three decimal digits). The tensor cores truncate what they add
//         into their accumulator, an error that grows with the number of
//         products added into it, so a chunk's 12 products start from zero
//         and reach the FP32 accumulator through an add that rounds to
//         nearest. A second mbarrier gives the stage back to the producers.
//       The CTA writes its partial dot products to a [S, B, P] workspace;
//       the CTAs of the first prototype tile write their rows' partial sums
//       of squares of x ([S, B]), those of the first batch tile the
//       prototypes' ([S, P]). No float atomics.
//   (b) som_finalize_kernel, launched early behind (a) (programmatic
//       dependent launch; it waits for (a) to complete): one CTA per batch
//       row sums the S partials in a fixed order, forms the distances as
//       the single-pass kernel did (the same rsqrtf(fmaxf(., 1e-24f)) and
//       fmaxf(., 0)), writes the row of dist, takes the first-index argmin,
//       then the analytic weights and the row's sum of w * dist. T comes
//       through a device pointer, read once a CTA, as the Pallas kernel
//       reads it from a (1, 1) SMEM operand: a CUDA graph that captured the
//       launch replays it with each step's temperature. The last
//       row to finish (an integer counter, reset by (a)) sums the B row
//       terms in row order into the loss. Every sum has a fixed order, so
//       two runs give bitwise-equal distances and losses.
//
// The split rule (ops/som_fused.py:plan_splits, from the shape alone): S is
// the number of splits that fits the grid in one wave of the H100's 132
// SMs, one CTA an SM (its 145 KB of shared memory), at most one split per
// chunk, then evened out over whole chunks. At the main path's shape
// (B 128, D 3136, P 1600): 26 tiles, S 5 (20 chunks a split, 18 in the
// last), 130 CTAs.
//
// Bound on an H100 SXM at that shape: float32-accurate products on the
// tensor cores take three TF32 products each, 3 * 2*B*P*D = 3.85 GFLOP
// against 495 TFLOP/s (7.78 us), and (B*D + P*D + B*P) * 4 + B*8 + 4 bytes
// = 22.5 MB against 3.35 TB/s (6.72 us): bound by operations, at 7.78 us
// (the FP32 non-tensor figure, 2*B*P*D at 67 TFLOP/s, is 19.2 us).
// What still holds it back: shared-memory bandwidth (each product reads
// both operands from shared memory, three times over for 3xTF32, beside
// the producers' copies and splits), the consumer waiting for the
// accumulator once a chunk, the finalize's fixed cost (it reads the S
// partials of every distance back from L2), and the 64-row tile's x reread
// by every prototype tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // batch rows per CTA: the wgmma's M
constexpr int kBN = 128;         // prototypes per CTA: the wgmma's N
constexpr int kBK = 32;          // depth chunk: one 128-byte swizzle row of floats
constexpr int kProducers = 256;  // two producer warpgroups
constexpr int kThreads = 128 + kProducers;  // the consumer warpgroup first
constexpr int kStages = 3;       // shared-memory ring
constexpr int kXBytes = kBM * kBK * 4;             // 8 KB
constexpr int kPBytes = kBN * kBK * 4;             // 16 KB
constexpr int kTileBytes = kXBytes + kPBytes;      // an x and a p tile
constexpr int kStageBytes = 2 * kTileBytes;        // big (copied in place), then small
// + 1024 to align the stages to the swizzle pattern, + the 2 x kStages mbarriers
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kVecsX = kBM * kBK / 4 / kProducers;  // 16-byte vectors a producer thread moves
constexpr int kVecsP = kBN * kBK / 4 / kProducers;
constexpr int kRowStep = kProducers / 8;  // between a producer thread's rows
constexpr int kFinalizeThreads = 1024;
constexpr int kMaxGroups = 16;  // split groups of a finalize row (small P)
constexpr int kCachedCols = 4;  // columns a finalize thread keeps in registers
constexpr float kSqrt3Over2 = 0.8660254037844386f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte group j of row r in a tile of 128-byte rows,
// 128-byte swizzled: the group index is xored with the row's index mod 8
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* gmem, bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled unless `valid`: the copies of rows whose length or
// start is not a multiple of 16 bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// waits for the phase of parity `parity` to complete; traps rather than
// hang if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// round to nearest TF32, ties away from zero: cvt.rna.tf32.f32 for finite a
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

// wgmma descriptor of a K-major operand in a 128-byte-swizzled tile whose
// 8-row groups are 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to d across the asynchronous products
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T on a 64 x 128 x 8 tile, both operands tf32 in shared memory
__device__ __forceinline__ void wgmma_m64n128k8(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads)
som_partial_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ p,
                   float* __restrict__ part_dot, float* __restrict__ part_x2,
                   float* __restrict__ part_p2, unsigned int* __restrict__ rows_done, int B,
                   int P, int D, int split_chunks, int wide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on such a boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int s = blockIdx.z;
  const int chunk0 = s * split_chunks;
  const int n_chunks = min(split_chunks, (D + kBK - 1) / kBK - chunk0);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], kProducers);
      mbar_init(&empty[st], 128);
    }
  }
  __syncthreads();

  if (tid < 128) {
    // consumer: chunk c waits in stage c % kStages, its big tiles first
    const int lane = tid % 32, warp = tid / 32;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % kStages;
      mbar_wait(&full[st], (c / kStages) & 1);
      const uint32_t big = smem_u32(smem + st * kStageBytes);
      const uint32_t small = big + kTileBytes;
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t o = 32 * kk;  // 8 floats of depth
        wgmma_m64n128k8(part, sw128_desc(small + o), sw128_desc(big + kXBytes + o), kk > 0);
        wgmma_m64n128k8(part, sw128_desc(big + o), sw128_desc(small + kXBytes + o), 1);
        wgmma_m64n128k8(part, sw128_desc(big + o), sw128_desc(big + kXBytes + o), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_operands(part);
      // the producers refill this stage with chunk c + kStages
      if (c + kStages < n_chunks) mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    // accumulator 4 n + e: row 16 warp + lane / 4 + 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2
    float* out = part_dot + (long long)s * B * P;
    const int wrow = row0 + 16 * warp + lane / 4;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = wrow + 8 * (e / 2);
        const int gc = col0 + 8 * n + 2 * (lane % 4) + e % 2;
        if (gr < B && gc < P) out[(long long)gr * P + gc] = acc[4 * n + e];
      }
  } else {
    // producers: thread q moves group j = q % 8 (floats 4j .. 4j + 3 of a
    // chunk) of x rows q / 8 + 32 i and of p rows q / 8 + 32 i
    const int q = tid - 128;
    const int j = q % 8, r0 = q / 8;
    const bool x_norms = blockIdx.x == 0;
    const bool p_norms = blockIdx.y == 0;
    const float* src[kVecsX + kVecsP];  // at this thread's group of the split's first chunk
    uint32_t row_ok = 0;
#pragma unroll
    for (int i = 0; i < kVecsX + kVecsP; ++i) {
      const bool is_x = i < kVecsX;
      const int r = (is_x ? row0 : col0) + r0 + kRowStep * (is_x ? i : i - kVecsX);
      const int rows = is_x ? B : P;
      src[i] = (is_x ? x + (long long)min(r, rows - 1) * ldx : p + (long long)min(r, rows - 1) * D) +
               chunk0 * kBK + 4 * j;
      row_ok |= (r < rows ? 1u : 0u) << i;
    }
    auto off = [&](int i) {  // vector i in a tile pair: x rows first, then p rows
      return i < kVecsX ? swz(r0 + kRowStep * i, j)
                        : kXBytes + swz(r0 + kRowStep * (i - kVecsX), j);
    };
    // 16 bytes a copy where the rows allow it (`wide`), else a float a
    // copy, zero past D
    auto load_chunk = [&](int c) {
      const uint32_t st = smem_u32(smem + (c % kStages) * kStageBytes);
      const int k0 = (chunk0 + c) * kBK + 4 * j;
      if (wide) {
#pragma unroll
        for (int i = 0; i < kVecsX + kVecsP; ++i)
          cp_async16(st + off(i), src[i] + c * kBK, k0 < D && (row_ok >> i & 1));
      } else {
#pragma unroll
        for (int i = 0; i < kVecsX + kVecsP; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(st + off(i) + 4 * e, src[i] + c * kBK + e, k0 + e < D && (row_ok >> i & 1));
      }
    };
    float sq[kVecsX + kVecsP];
#pragma unroll
    for (int i = 0; i < kVecsX + kVecsP; ++i) sq[i] = 0.f;

#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) load_chunk(c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      // this thread's copies of chunk c have landed: it splits them, all
      // loads first, so that no load waits behind a store the compiler
      // cannot prove to be elsewhere
      cp_async_wait<kStages - 2>();
      unsigned char* big = smem + (c % kStages) * kStageBytes;
      unsigned char* small = big + kTileBytes;
      float4 v[kVecsX + kVecsP];
#pragma unroll
      for (int i = 0; i < kVecsX + kVecsP; ++i)
        v[i] = *reinterpret_cast<const float4*>(big + off(i));
#pragma unroll
      for (int i = 0; i < kVecsX + kVecsP; ++i) {
        const float4 a = v[i];
        if (i < kVecsX ? x_norms : p_norms) {
          sq[i] = fmaf(a.x, a.x, sq[i]);
          sq[i] = fmaf(a.y, a.y, sq[i]);
          sq[i] = fmaf(a.z, a.z, sq[i]);
          sq[i] = fmaf(a.w, a.w, sq[i]);
        }
        const float4 hi = make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z), tf32_rna(a.w));
        *reinterpret_cast<float4*>(big + off(i)) = hi;
        *reinterpret_cast<float4*>(small + off(i)) =
            make_float4(tf32_rna(a.x - hi.x), tf32_rna(a.y - hi.y), tf32_rna(a.z - hi.z),
                        tf32_rna(a.w - hi.w));
      }
      // generic-proxy writes, read next by the tensor cores' async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[c % kStages]);
      // refill the stage of chunk c - 1 once the consumer is done with it
      const int nxt = c + kStages - 1;
      if (nxt < n_chunks) {
        if (nxt >= kStages) mbar_wait(&empty[nxt % kStages], (nxt / kStages - 1) & 1);
        load_chunk(nxt);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    // the finalize counts its finished rows here; it starts after this grid ends
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && q == 0) *rows_done = 0;
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    // the 8 threads of a tile row are neighbouring lanes
#pragma unroll
    for (int i = 0; i < kVecsX + kVecsP; ++i)
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], o);
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < kVecsX; ++i)
        if (x_norms && (row_ok >> i & 1))
          part_x2[(long long)s * B + row0 + r0 + kRowStep * i] = sq[i];
#pragma unroll
      for (int i = 0; i < kVecsP; ++i)
        if (p_norms && (row_ok >> (kVecsX + i) & 1))
          part_p2[(long long)s * P + col0 + r0 + kRowStep * i] = sq[kVecsX + i];
    }
  }
}

__device__ __forceinline__ void grid_coords(int idx, int cols, int hexa, float* a, float* b) {
  const int r = idx / cols;
  const int c = idx % cols;
  if (hexa) {
    *a = (float)c + 0.5f * (float)(r & 1);
    *b = (float)r * kSqrt3Over2;
  } else {
    *a = (float)r;
    *b = (float)c;
  }
}

// (value, index) pair: the smaller value wins, the lower index on a tie
__device__ __forceinline__ void argmin_merge(float* v, int* i, float ov, int oi) {
  if (ov < *v || (ov == *v && oi < *i)) {
    *v = ov;
    *i = oi;
  }
}

// sum of v over the CTA in a fixed order (shuffles within warps, then warps
// in order), returned to thread 0
__device__ __forceinline__ float block_sum(float v, float* s_sum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) s_sum[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < n_warps; ++w) total += s_sum[w];
  return total;
}

// One CTA per batch row. Thread (grp, col), grp < G, col < C, sums splits
// grp, grp + G, ... of columns col, col + C, ...; the G group sums of a
// column are then added in group order. G > 1 only where P <= C.
__global__ void __launch_bounds__(kFinalizeThreads)
som_finalize_kernel(const float* __restrict__ part_dot, const float* __restrict__ part_x2,
                    const float* __restrict__ part_p2, float* __restrict__ dist,
                    long long* __restrict__ bmu, float* __restrict__ row_partial,
                    unsigned int* __restrict__ rows_done, float* __restrict__ loss, int B, int P,
                    int S, int C, int G, int cols, int hexa, int cosine,
                    const float* __restrict__ temperature) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float s_dot[kFinalizeThreads], s_p2[kFinalizeThreads];
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ float s_sum[32];
  __shared__ float s_x2;
  __shared__ int s_bmu;
  __shared__ bool s_last;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int col = tid % C, grp = tid / C;
  const bool owner = grp == 0;  // ends up holding its columns' sums
  float* row = dist + (long long)b * P;

  // columns col + q C, q < nq, are summed here and kept in registers
  const int nq = min(kCachedCols, (P - col + C - 1) / C);
  float dot[kCachedCols], p2[kCachedCols];
#pragma unroll
  for (int q = 0; q < kCachedCols; ++q) dot[q] = p2[q] = 0.f;
  if (grp < G) {
#pragma unroll 4
    for (int s = grp; s < S; s += G) {
#pragma unroll
      for (int q = 0; q < kCachedCols; ++q) {
        if (q < nq) {
          dot[q] += part_dot[((long long)s * B + b) * P + col + q * C];
          p2[q] += part_p2[(long long)s * P + col + q * C];
        }
      }
    }
  }
  if (warp == 0) {
    float v = 0.f;
    for (int s = lane; s < S; s += 32) v += part_x2[(long long)s * B + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) s_x2 = v;
  }
  if (G > 1) {
    s_dot[tid] = dot[0];
    s_p2[tid] = p2[0];
    __syncthreads();
    if (owner) {
      dot[0] = p2[0] = 0.f;
      for (int h = 0; h < G; ++h) {
        dot[0] += s_dot[h * C + col];
        p2[0] += s_p2[h * C + col];
      }
    }
  }
  __syncthreads();
  const float x2 = s_x2;
  const float inv_x = rsqrtf(fmaxf(x2, 1e-24f));
  auto to_dist = [&](float d_, float p2_) {
    return cosine ? 1.f - d_ * inv_x * rsqrtf(fmaxf(p2_, 1e-24f))
                  : sqrtf(fmaxf(x2 - 2.f * d_ + p2_, 0.f));
  };

  // a thread walks its columns in increasing order, so a strict < keeps
  // its first minimal index
  float cached[kCachedCols];
  float best = INFINITY;
  int best_i = P;
#pragma unroll
  for (int q = 0; q < kCachedCols; ++q) {
    const int jj = col + q * C;
    cached[q] = to_dist(dot[q], p2[q]);
    if (owner && q < nq) {
      row[jj] = cached[q];
      if (cached[q] < best) {
        best = cached[q];
        best_i = jj;
      }
    }
  }
  if (owner) {  // columns beyond the registers, read back below
    for (int jj = col + kCachedCols * C; jj < P; jj += C) {
      float d_ = 0.f, p2_ = 0.f;
      for (int s = 0; s < S; ++s) {
        d_ += part_dot[((long long)s * B + b) * P + jj];
        p2_ += part_p2[(long long)s * P + jj];
      }
      const float d = to_dist(d_, p2_);
      row[jj] = d;
      if (d < best) {
        best = d;
        best_i = jj;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    argmin_merge(&best, &best_i, ov, oi);
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < n_warps ? s_val[lane] : INFINITY;
    best_i = lane < n_warps ? s_idx[lane] : P;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      argmin_merge(&best, &best_i, ov, oi);
    }
    if (lane == 0) s_bmu = best_i;
  }
  __syncthreads();
  const int k = s_bmu;

  // 2 T^2 as (2 T) T, the host's and the plain version's order
  const float t = *temperature;
  const float two_t2 = 2.f * t * t;
  float ba, bb;
  grid_coords(k, cols, hexa, &ba, &bb);
  auto weight = [&](int jj) {
    float pa, pb;
    grid_coords(jj, cols, hexa, &pa, &pb);
    const float da = ba - pa;
    const float db = bb - pb;
    return expf(-(da * da + db * db) / two_t2);
  };
  float acc = 0.f;
  if (owner) {
#pragma unroll
    for (int q = 0; q < kCachedCols; ++q)
      if (q < nq) acc = fmaf(weight(col + q * C), cached[q], acc);
    for (int jj = col + kCachedCols * C; jj < P; jj += C) acc = fmaf(weight(jj), row[jj], acc);
  }
  const float total = block_sum(acc, s_sum);
  if (tid == 0) {
    row_partial[b] = total;
    bmu[b] = k;
    // the last row to finish sums the row terms, in row order
    __threadfence();
    s_last = atomicAdd(rows_done, 1u) == static_cast<unsigned>(B - 1);
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    float v = 0.f;
    for (int i = tid; i < B; i += blockDim.x) v += __ldcg(row_partial + i);
    const float sum = block_sum(v, s_sum);
    if (tid == 0) loss[0] = sum / (static_cast<float>(B) * static_cast<float>(P));
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                   bool after_previous, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  // launched while the previous kernel runs; waits for it at griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_previous ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// The tile sizes (kBM, kBN, kBK): ops/som_fused.py plans the grid and the
// workspace with them and refuses to load a library whose sizes differ.
extern "C" void som_fused_tiles(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
}

// Launches (a) and (b) on `stream` and returns the CUDA error code (0 on
// success). x rows are `ldx` floats apart (the model hands over a strided
// view of its token buffer); p and the outputs are contiguous. The caller
// says whether every row takes 16-byte copies (`wide`: x and p 16-byte
// aligned, ldx and D multiples of 4; ops/som_fused.py:wide_copies), else
// the producers copy a float at a time, zero past D. The grid has `splits` splits
// of `split_chunks` 32-deep chunks (the last may have fewer, none is
// empty). `workspace` holds splits * (B*P + B + P) + B + 1 floats (the last
// one the row counter). `temperature` points to one float on the device,
// read after (a) completes. Nothing is allocated here.
extern "C" int som_fused_forward(const float* x, long long ldx, const float* p, float* dist,
                                 long long* bmu, float* workspace, float* loss, int B, int P,
                                 int D, int splits, int split_chunks, int cols, int hexa,
                                 int cosine, const float* temperature, int wide,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        som_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised = true;
  }
  float* part_dot = workspace;
  float* part_x2 = part_dot + (size_t)splits * B * P;
  float* part_p2 = part_x2 + (size_t)splits * B;
  float* row_partial = part_p2 + (size_t)splits * P;
  unsigned int* rows_done = reinterpret_cast<unsigned int*>(row_partial + B);

  const dim3 grid((P + kBN - 1) / kBN, (B + kBM - 1) / kBM, splits);
  cudaError_t err = launch(som_partial_kernel, grid, kThreads, kSmemBytes, s, false, x, ldx, p,
                           part_dot, part_x2, part_p2, rows_done, B, P, D, split_chunks, wide);
  if (err != cudaSuccess) return static_cast<int>(err);

  // C columns by G split groups, at most kFinalizeThreads threads
  const int C = P < kFinalizeThreads ? P : kFinalizeThreads;
  const int G = min(min(splits, kMaxGroups), kFinalizeThreads / C);
  const int threads = (C * G + 31) / 32 * 32;
  err = launch(som_finalize_kernel, dim3(B), threads, 0, s, true, (const float*)part_dot,
               (const float*)part_x2, (const float*)part_p2, dist, bmu, row_partial, rows_done,
               loss, B, P, splits, C, G, cols, hexa, cosine, temperature);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
