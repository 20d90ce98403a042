// 3xTF32: float32 products on the TF32 tensor cores (mma.sync m16n8k8),
// shared by the sparse convs K1 and K2 (csrc/sparse_conv3_mma.cuh) and the
// float32 attention instance (csrc/attention.cu).
//
// Each operand is split hi = rna(x), lo = rna(x - hi) (x = hi + lo to
// about 21 mantissa bits) and a product is lo*hi + hi*lo + hi*hi. The
// tensor cores truncate as they accumulate, so a caller keeps each chain
// of products short (from zero) and adds the chains in round-to-nearest
// FADD.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Round to the nearest TF32 (10 mantissa bits), ties away from zero: half
// a TF32 ulp added to the magnitude bits, the low 13 bits cleared. For
// every finite x this is cvt.rna.tf32.f32(x), in two full-rate integer
// operations where cvt runs at a fraction of that rate (14% of K1's
// float32 time per forward, brick_conv_timing.py).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 21 mantissa bits: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += A (16 x 8, row) B (8 x 8, col) in TF32. Fragments (g = lane / 4,
// t = lane % 4): a0 A[g][t], a1 A[g+8][t], a2 A[g][t+4], a3 A[g+8][t+4];
// b0 B[t][g], b1 B[t+4][g]; d0, d1 D[g][2t, 2t+1], d2, d3 D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi*hi
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t blo0,
                                           uint32_t bhi1, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

}  // namespace
