// Fused multi-head attention, forward and backward, for NVIDIA Hopper
// (sm_90a), float32.
//
// attn_fwd_kernel replaces the TPU kernel
// vitsom_tpu/ops/attention_pallas.py:_attn_fwd_kernel (launched by
// _fused_attention_fwd_impl). Per (batch row b, head h) it computes
//   o   = softmax(q k^T * hd^-0.5) v      [N, hd] columns h*hd.. of o [B, N, D]
//   lse = m + log(sum exp(s - m))          [N]     row (b, h) of lse [B, H, N]
// attn_bwd_kernel replaces _attn_bwd_kernel (launched by
// _fused_attention_bwd_impl; also the backward of attention.hybrid_attention).
// From q, k, v, o, do and lse it recomputes p = exp(s - lse) on chip and forms
//   dv = p^T do,  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta) * scale,  dq = ds k,  dk = ds^T q.
// No N x N tensor reaches device memory in either kernel.
//
// Bound on an H100 SXM (67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s)
// at the main path's shapes, counting each input and output byte once:
//   (B, N, H, hd) = (128, 197, 2, 8), the encoder: forward 4*B*H*N^2*hd =
//     318 MFLOP (4.75 us) against 6.66 MB (1.99 us); backward 10*B*H*N^2*hd
//     = 795 MFLOP (11.9 us) against 13.1 MB (3.9 us): bound by operations.
//   (128, 197, 2, 2), the decoder: 1.19 us forward, 2.97 us backward, also
//     operations; but here the 9.9 M exponentials per call (B*H*N^2; twice
//     that in the backward, which recomputes p in both passes) and the
//     shared-memory loads outweigh the 4 FMAs per score.
//
// Design (a first version that is right and simple; wgmma tiles, TMA and
// several heads per CTA are later work):
// - The TPU kernel takes a slab of batch rows per sequential grid step with
//   the whole [bb, N, D] slab in VMEM. Here one CTA owns one (b, h) and
//   stages that head's [N, hd] operands in dynamic shared memory
//   (cudaFuncSetAttribute above 48 KB; 2*N*hd*4 bytes, 128.5 KB at N 257,
//   hd 64). The wrapper refuses N that does not fit in a block's 227 KB.
// - Rows are owned by groups of TPR lanes; lane t of a group holds dims
//   [t*DPT, (t+1)*DPT) of its row in registers and dot products are summed
//   over the group by xor shuffles (every lane gets the same sum, since each
//   butterfly step adds the same two values). TPR is 1 up to hd 16, so a
//   thread owns a whole row; at hd 32..64 it is 2 or 4, so a thread holds at
//   most 16 dims of each operand instead of 64 (~128 registers for q and the
//   accumulator alone at hd 64). All lanes run the same trip counts (rows
//   past N recompute row N-1 and store nothing), so every shuffle is
//   reached by the whole warp.
// - Forward: keys in chunks of 8 with an online softmax, one exponential
//   per score plus one rescale per chunk; the chunk's 8 dot products are
//   independent FMA chains. Shared-memory rows are read as float4/float2
//   broadcasts (every group of a warp reads the same key row).
// - Backward: the TPU kernel holds q, k, v, o and do for a slab at once;
//   four [N, hd] f32 tensors at N 257, hd 64 take 257 KB, more than a CTA's
//   227 KB. So the CTA makes two passes and stages two tensors in each:
//   pass A (a group owns key row j, with q and do staged): dv_j, dk_j;
//   pass B (a group owns query row i, with k and v staged): dq_i.
//   delta and lse are staged once per row for both passes.
// - No atomics and a fixed order of every sum: two runs give bitwise-equal
//   outputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kKeyChunk = 8;
constexpr int kBadHeadDim = -1;

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

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DPT floats from shared memory, as 16- or 8-byte loads where the width allows
template <int DPT>
__device__ __forceinline__ void lds(const float* s, float (&r)[DPT]) {
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPT / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(s)[i];
      r[4 * i] = x.x;
      r[4 * i + 1] = x.y;
      r[4 * i + 2] = x.z;
      r[4 * i + 3] = x.w;
    }
  } else if constexpr (DPT % 2 == 0) {
#pragma unroll
    for (int i = 0; i < DPT / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(s)[i];
      r[2 * i] = x.x;
      r[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) r[i] = s[i];
  }
}

// DPT floats from device memory (strided views: no alignment assumed)
template <int DPT>
__device__ __forceinline__ void ldg(const float* __restrict__ g, float (&r)[DPT]) {
#pragma unroll
  for (int i = 0; i < DPT; ++i) r[i] = g[i];
}

template <int DPT>
__device__ __forceinline__ float dot(const float (&a)[DPT], const float (&b)[DPT]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) s = fmaf(a[i], b[i], s);
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

template <int HD, int TPR>
__global__ void __launch_bounds__(kMaxThreads)
attn_fwd_kernel(View q, View k, View v, float* __restrict__ o, float* __restrict__ lse, int N,
                int H, float scale) {
  constexpr int DPT = HD / TPR;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + N * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int col0 = h * HD;
  stage<HD>(ks, row_ptr(k, b, 0, col0), k.sr, N);
  stage<HD>(vs, row_ptr(v, b, 0, col0), v.sr, N);
  __syncthreads();

  const int t = threadIdx.x % TPR;
  const int group = threadIdx.x / TPR;
  const int groups = blockDim.x / TPR;
  const int c0 = col0 + t * DPT;
  const long long D = (long long)H * HD;
  for (int r0 = 0; r0 < N; r0 += groups) {
    const int i = r0 + group;
    const int ii = min(i, N - 1);
    float qr[DPT], acc[DPT];
    ldg<DPT>(row_ptr(q, b, ii, c0), qr);
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < N; j0 += kKeyChunk) {
      float s[kKeyChunk];
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        float kr[DPT];
        lds<DPT>(ks + min(j0 + c, N - 1) * HD + t * DPT, kr);
        s[c] = group_sum<TPR>(dot<DPT>(qr, kr)) * scale;
        if (j0 + c >= N) s[c] = -INFINITY;
      }
      float cm = s[0];
#pragma unroll
      for (int c = 1; c < kKeyChunk; ++c) cm = fmaxf(cm, s[c]);
      const float m_new = fmaxf(m, cm);
      const float corr = expf(m - m_new);  // 0 on the first chunk, 1 if the max held
      l *= corr;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kKeyChunk; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        float vr[DPT];
        lds<DPT>(vs + min(j0 + c, N - 1) * HD + t * DPT, vr);
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
      m = m_new;
    }
    if (i < N) {
      float* orow = o + ((long long)b * N + i) * D + c0;
#pragma unroll
      for (int d = 0; d < DPT; ++d) orow[d] = acc[d] / l;
      if (t == 0) lse[((long long)b * H + h) * N + i] = m + logf(l);
    }
  }
}

template <int HD, int TPR>
__global__ void __launch_bounds__(kMaxThreads)
attn_bwd_kernel(View q, View k, View v, View o, const float* __restrict__ lse, View dout,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int N,
                int H, float scale) {
  constexpr int DPT = HD / TPR;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;            // q in pass A, k in pass B: [N][HD]
  float* bs = smem + N * HD;   // do in pass A, v in pass B
  float* lse_s = smem + 2 * N * HD;
  float* delta_s = lse_s + N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int col0 = h * HD;
  const int t = threadIdx.x % TPR;
  const int group = threadIdx.x / TPR;
  const int groups = blockDim.x / TPR;
  const int c0 = col0 + t * DPT;
  const long long D = (long long)H * HD;

  stage<HD>(as, row_ptr(q, b, 0, col0), q.sr, N);
  stage<HD>(bs, row_ptr(dout, b, 0, col0), dout.sr, N);
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) lse_s[i] = lse_bh[i];
  // delta_i = rowsum(do_i * o_i) over this head, once per row
  for (int r0 = 0; r0 < N; r0 += groups) {
    const int i = r0 + group;
    const int ii = min(i, N - 1);
    float orow[DPT], drow[DPT];
    ldg<DPT>(row_ptr(o, b, ii, c0), orow);
    ldg<DPT>(row_ptr(dout, b, ii, c0), drow);
    const float delta = group_sum<TPR>(dot<DPT>(orow, drow));
    if (i < N && t == 0) delta_s[i] = delta;
  }
  __syncthreads();

  // pass A: a group owns key row j; dv_j = sum_i p_ij do_i, dk_j = sum_i ds_ij q_i
  for (int r0 = 0; r0 < N; r0 += groups) {
    const int j = r0 + group;
    const int jj = min(j, N - 1);
    float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
    ldg<DPT>(row_ptr(k, b, jj, c0), kr);
    ldg<DPT>(row_ptr(v, b, jj, c0), vr);
#pragma unroll
    for (int d = 0; d < DPT; ++d) dkr[d] = dvr[d] = 0.f;
#pragma unroll 2
    for (int i = 0; i < N; ++i) {
      float qi[DPT], doi[DPT];
      lds<DPT>(as + i * HD + t * DPT, qi);
      lds<DPT>(bs + i * HD + t * DPT, doi);
      const float p = expf(group_sum<TPR>(dot<DPT>(qi, kr)) * scale - lse_s[i]);
      const float dp = group_sum<TPR>(dot<DPT>(doi, vr));
      const float ds = p * (dp - delta_s[i]) * scale;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dvr[d] = fmaf(p, doi[d], dvr[d]);
        dkr[d] = fmaf(ds, qi[d], dkr[d]);
      }
    }
    if (j < N) {
      const long long off = ((long long)b * N + j) * D + c0;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dk[off + d] = dkr[d];
        dv[off + d] = dvr[d];
      }
    }
  }
  __syncthreads();
  stage<HD>(as, row_ptr(k, b, 0, col0), k.sr, N);
  stage<HD>(bs, row_ptr(v, b, 0, col0), v.sr, N);
  __syncthreads();

  // pass B: a group owns query row i; dq_i = sum_j ds_ij k_j
  for (int r0 = 0; r0 < N; r0 += groups) {
    const int i = r0 + group;
    const int ii = min(i, N - 1);
    float qi[DPT], doi[DPT], dqr[DPT];
    ldg<DPT>(row_ptr(q, b, ii, c0), qi);
    ldg<DPT>(row_ptr(dout, b, ii, c0), doi);
    const float lse_i = lse_s[ii];
    const float delta_i = delta_s[ii];
#pragma unroll
    for (int d = 0; d < DPT; ++d) dqr[d] = 0.f;
#pragma unroll 2
    for (int j = 0; j < N; ++j) {
      float kj[DPT], vj[DPT];
      lds<DPT>(as + j * HD + t * DPT, kj);
      lds<DPT>(bs + j * HD + t * DPT, vj);
      const float p = expf(group_sum<TPR>(dot<DPT>(qi, kj)) * scale - lse_i);
      const float dp = group_sum<TPR>(dot<DPT>(doi, vj));
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int d = 0; d < DPT; ++d) dqr[d] = fmaf(ds, kj[d], dqr[d]);
    }
    if (i < N) {
      float* out = dq + ((long long)b * N + i) * D + c0;
#pragma unroll
      for (int d = 0; d < DPT; ++d) out[d] = dqr[d];
    }
  }
}

// threads per CTA: the fewest passes over the N rows of TPR lanes each,
// at most kMaxThreads lanes a pass, spread evenly and rounded up to warps
int threads_for(int N, int tpr) {
  const int lanes = N * tpr;
  const int passes = (lanes + kMaxThreads - 1) / kMaxThreads;
  const int per_pass = (lanes + passes - 1) / passes;
  return (per_pass + 31) / 32 * 32;
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

template <int HD, int TPR>
int launch_fwd(View q, View k, View v, float* o, float* lse, int B, int N, int H, float scale,
               cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * 2 * (size_t)N * HD;
  cudaError_t err = allow_smem(attn_fwd_kernel<HD, TPR>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_kernel<HD, TPR><<<B * H, threads_for(N, TPR), smem, s>>>(q, k, v, o, lse, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int TPR>
int launch_bwd(View q, View k, View v, View o, const float* lse, View dout, float* dq, float* dk,
               float* dv, int B, int N, int H, float scale, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t smem = sizeof(float) * (2 * (size_t)N * HD + 2 * (size_t)N);
  cudaError_t err = allow_smem(attn_bwd_kernel<HD, TPR>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kernel<HD, TPR><<<B * H, threads_for(N, TPR), smem, s>>>(q, k, v, o, lse, dout, dq, dk,
                                                                    dv, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head dims the kernels are built for (every head_dim of a shipped ViT
// config: 2, 8, 32, 64; and 16, 48 of the JAX tests) with their lanes per row.
#define ATTN_HEAD_DIMS(X) X(2, 1) X(8, 1) X(16, 1) X(32, 2) X(48, 4) X(64, 4)

// Both entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() as an int (0 on success), or -1 for a head dim that is
// not built. q, k, v, o and do are [B, N, H*hd] views with unit column
// stride, batch stride *_sb and row stride *_sr in floats (the model hands
// over q, k, v sliced out of its fused qkv buffer, rows 3*D apart). The
// outputs o, lse [B, H, N], dq, dk, dv are contiguous.
extern "C" int attention_forward(const float* q, long long q_sb, long long q_sr, const float* k,
                                 long long k_sb, long long k_sr, const float* v, long long v_sb,
                                 long long v_sr, float* o, float* lse, int B, int N, int H,
                                 int hd, float scale, void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_FWD_CASE(HD, TPR) \
  case HD:                     \
    return launch_fwd<HD, TPR>(qv, kv, vv, o, lse, B, N, H, scale, s);
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
                                  long long do_sr, float* dq, float* dk, float* dv, int B, int N,
                                  int H, int hd, float scale, void* stream) {
  const View qv{q, q_sb, q_sr}, kv{k, k_sb, k_sr}, vv{v, v_sb, v_sr}, ov{o, o_sb, o_sr},
      dov{dout, do_sb, do_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define ATTN_BWD_CASE(HD, TPR) \
  case HD:                     \
    return launch_bwd<HD, TPR>(qv, kv, vv, ov, lse, dov, dq, dk, dv, B, N, H, scale, s);
    ATTN_HEAD_DIMS(ATTN_BWD_CASE)
#undef ATTN_BWD_CASE
    default:
      return kBadHeadDim;
  }
}
