// 3xTF32 products on Hopper's tensor cores for the f32 forward
// (flash_fwd_tf32 in flash_attention.cu); the backward runs its 3xTF32 on
// wgmma (hopper.cuh).
//
// Each f32 operand x is split into TF32 values big = rna(x) and small =
// rna(x - big), and a product is small*big + big*small, then + big*big, on
// mma.sync m16n8k8 tf32 -> f32 (small*small is dropped, as in CUTLASS's
// fast-f32 GEMMs): about f32 accuracy at a third of the TF32 rate, where
// one TF32 product misses the f32 kernels' 1e-4 tolerance.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8x8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16x8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>

namespace {

// x to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32 for every finite x, in 2 integer instructions where
// sm_90a expands the cvt into 4 with an infinity test.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the 3xTF32 split: x = big + small + what TF32 cannot hold of x - big
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma1688(float (&c)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: small * big + big * small first, then big * big;
// small * small is dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma1688(c, a_small, b_big[0], b_big[1]);
  mma1688(c, a_big, b_small[0], b_small[1]);
  mma1688(c, a_big, b_big[0], b_big[1]);
}

}  // namespace
