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
// order, so the work is split into three launches on one stream:
//   (a) som_distance_kernel: one CTA per (64-row batch tile, 64-prototype
//       tile); a shared-memory SGEMM loop over D in chunks of 32 that also
//       accumulates the row sums of squares of both operands, and an
//       epilogue that turns dot products into distances. Each chunk's
//       global loads are issued into registers before the previous chunk is
//       multiplied, so their latency overlaps the FMAs. The ragged P edge
//       (1600 = 25 * 64, 576 = 9 * 64; other maps are not multiples) and the
//       B edge are masked on load and store; nothing is padded in memory.
//   (b) som_finalize_kernel: one CTA per batch row; first-index argmin by
//       warp shuffles (the lower index wins every tie), then the analytic
//       weights and the row partial sum of w * dist.
//   (c) som_loss_reduce_kernel: one CTA sums the B row partials in a fixed
//       order, so two runs give bitwise-equal losses (no float atomics).
//
// Bound on an H100 SXM at the main path's shape (B 128, D 3136, P 1600):
// 2*B*P*D = 1.28 GFLOP of float32 FMA against 67 TFLOP/s outside the tensor
// cores (19 us), and (B*D + P*D + B*P) * 4 B = 22.5 MB against 3.35 TB/s
// (6.7 us): bound by operations. This first version uses plain FP32 FMAs
// (no TF32, no tensor cores: the tests hold distances to 1e-5) and a
// 64x64 tile, which gives only 2 * 25 = 50 CTAs for 132 SMs; wgmma/TMA
// tiles and a split over D are the later work that would close the gap.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;        // batch rows per CTA
constexpr int kBN = 64;        // prototypes per CTA
constexpr int kBK = 32;        // depth chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 4;
constexpr int kLoads = kBM * kBK / kThreads;  // 8 elements of each operand a chunk
constexpr int kFinalizeThreads = 256;
constexpr float kSqrt3Over2 = 0.8660254037844386f;

__global__ void __launch_bounds__(kThreads)
som_distance_kernel(const float* __restrict__ x, long long ldx,
                    const float* __restrict__ p, float* __restrict__ dist,
                    int B, int P, int D, int cosine) {
  // k-major tiles; the +1 pad keeps the transposing stores conflict-free
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ps[kBK][kBN + 1];
  __shared__ float x2s[kBM];
  __shared__ float p2s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 * j
  const int ty = tid / 16;  // output rows    ty + 16 * i
  // loads: lane = depth index in the chunk, rows warp + 8 * i, so each warp
  // reads 128 contiguous bytes of one row
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
  // the next chunk, held in registers while the current one is multiplied,
  // and per-lane partial sums of squares of the rows this thread loads
  float xr[kLoads], pr[kLoads], xsq[kLoads], psq[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) xsq[i] = psq[i] = 0.f;

  auto load = [&](int k0) {
    const int gk = k0 + lane;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int gr = row0 + warp + 8 * i;
      const int gc = col0 + warp + 8 * i;
      xr[i] = (gr < B && gk < D) ? x[(long long)gr * ldx + gk] : 0.f;
      pr[i] = (gc < P && gk < D) ? p[(long long)gc * D + gk] : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      xs[lane][warp + 8 * i] = xr[i];
      ps[lane][warp + 8 * i] = pr[i];
      xsq[i] = fmaf(xr[i], xr[i], xsq[i]);
      psq[i] = fmaf(pr[i], pr[i], psq[i]);
    }
    __syncthreads();
    // issue the next chunk's loads; they are in flight during the FMAs
    if (k0 + kBK < D) load(k0 + kBK);

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTile], b[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTile; ++j) b[j] = ps[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // row sums of squares: the 32 lanes of a warp hold one row's partials
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    float xv = xsq[i], pv = psq[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      xv += __shfl_xor_sync(0xffffffffu, xv, off);
      pv += __shfl_xor_sync(0xffffffffu, pv, off);
    }
    if (lane == 0) {
      x2s[warp + 8 * i] = xv;
      p2s[warp + 8 * i] = pv;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int r = ty + 16 * i;
    const int gr = row0 + r;
    if (gr >= B) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int c = tx + 16 * j;
      const int gc = col0 + c;
      if (gc >= P) continue;
      const float dot = acc[i][j];
      float d;
      if (cosine) {
        d = 1.f - dot * rsqrtf(fmaxf(x2s[r], 1e-24f)) * rsqrtf(fmaxf(p2s[c], 1e-24f));
      } else {
        d = sqrtf(fmaxf(x2s[r] - 2.f * dot + p2s[c], 0.f));
      }
      dist[(long long)gr * P + gc] = d;
    }
  }
}

__device__ __forceinline__ void grid_coords(int idx, int cols, int hexa, float* a,
                                            float* b) {
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

__global__ void __launch_bounds__(kFinalizeThreads)
som_finalize_kernel(const float* __restrict__ dist, long long* __restrict__ bmu,
                    float* __restrict__ row_partial, int P, int cols, int hexa,
                    float two_t2) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ float s_sum[32];
  __shared__ int s_bmu;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const float* row = dist + (long long)b * P;

  // a thread walks its columns in increasing order, so a strict < keeps
  // its first minimal index
  float best = INFINITY;
  int best_i = P;
  for (int j = tid; j < P; j += blockDim.x) {
    const float v = row[j];
    if (v < best) {
      best = v;
      best_i = j;
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

  float ba, bb;
  grid_coords(k, cols, hexa, &ba, &bb);
  float acc = 0.f;
  for (int j = tid; j < P; j += blockDim.x) {
    float pa, pb;
    grid_coords(j, cols, hexa, &pa, &pb);
    const float da = ba - pa;
    const float db = bb - pb;
    const float d2 = da * da + db * db;
    acc = fmaf(expf(-d2 / two_t2), row[j], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) s_sum[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < n_warps; ++w) total += s_sum[w];
    row_partial[b] = total;
    bmu[b] = k;
  }
}

__global__ void som_loss_reduce_kernel(const float* __restrict__ row_partial,
                                       float* __restrict__ loss, int B, float count) {
  __shared__ float s[256];
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int i = tid; i < B; i += blockDim.x) acc += row_partial[i];
  s[tid] = acc;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (tid < stride) s[tid] += s[tid + stride];
    __syncthreads();
  }
  if (tid == 0) loss[0] = s[0] / count;
}

}  // namespace

// Launches (a), (b) and (c) on `stream` and returns cudaGetLastError() as an
// int (0 on success). x rows are `ldx` floats apart (the model hands over a
// strided view of its token buffer); p and the outputs are contiguous.
// Scratch `row_partial` holds B floats. Nothing is allocated here.
extern "C" int som_fused_forward(const float* x, long long ldx, const float* p,
                                 float* dist, long long* bmu, float* row_partial,
                                 float* loss, int B, int P, int D, int cols, int hexa,
                                 int cosine, float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  som_distance_kernel<<<grid, kThreads, 0, s>>>(x, ldx, p, dist, B, P, D, cosine);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float two_t2 = 2.0f * temperature * temperature;
  som_finalize_kernel<<<B, kFinalizeThreads, 0, s>>>(dist, bmu, row_partial, P, cols,
                                                     hexa, two_t2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  som_loss_reduce_kernel<<<1, 256, 0, s>>>(row_partial, loss, B,
                                           static_cast<float>(B) * static_cast<float>(P));
  return static_cast<int>(cudaGetLastError());
}
