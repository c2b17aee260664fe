// Float32-accurate products on Hopper's tensor cores as 3xTF32 mma.sync
// m16n8k8 tiles, shared by attention.cu and block.cu.
//
// An operand a is split into two TF32 parts, a = big + small to float32
// accuracy (tf32_rna rounds to nearest, ties away from zero). Each 8-deep
// step sums small*big + big*small + big*big from zero and then adds the
// result into the float32 accumulator with one rounding add: the tensor
// cores truncate what they add into their accumulator, so the accumulator
// never passes through them. A row's statistics over the quad of lanes that
// holds it are reduced by quad_max / quad_sum.
//
// Fragment layouts (g = lane / 4, t = lane % 4): A a0 = A[g][t], a1 =
// A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; B b0 = B[t][g], b1 =
// B[t + 4][g]; C c0, c1 = C[g][2t, 2t + 1], c2, c3 = C[g + 8][2t, 2t + 1].
// A C tile serves as the A operand of the next product when the summed
// index is permuted (A column t <-> 2t, t + 4 <-> 2t + 1): a = (c0, c2, c1,
// c3), with the B rows read as 2t and 2t + 1.

#pragma once

#include <stdint.h>

namespace {

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

// d += a b to float32 accuracy, b's TF32 parts given: three TF32 products
// summed from zero, then one rounding add
__device__ __forceinline__ void mma3_split(float (&d)[4], const Frag& a, uint32_t bb0,
                                          uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s, a.small, bb0, bb1);
  mma_tf32(s, a.big, bs0, bs1);
  mma_tf32(s, a.big, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

// d += a b to float32 accuracy, b = (b0, b1) this thread's B fragment
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  const uint32_t bb0 = tf32_rna(b0), bb1 = tf32_rna(b1);
  mma3_split(d, a, bb0, bb1, tf32_rna(b0 - __uint_as_float(bb0)),
             tf32_rna(b1 - __uint_as_float(bb1)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
