// Tensor cores at f32 accuracy for the port's margin lanes kernel
// (margin_lanes_loss_grad.cu): mma.sync.aligned.m16n8k8 in TF32 with
// each f32 operand split into two TF32 halves ("3xTF32").  The softmax
// kernel (softmax_loss_grad.cu) carries the same pieces in its own
// source.  Each kernel source is its own library, so everything here has
// internal linkage.
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4g + t):
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)

#pragma once

#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 (nearest, ties away from zero) as the two integer
// operations it compiles to for a finite v, without its test for inf and
// NaN: an inf or NaN in X still makes lo, and so the result, NaN.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + (about 2^-22 v), both TF32.  lo is handed to the tensor
// cores unmasked: they ignore the low 13 bits of a .tf32 operand, so
// adding half its last place is already round-to-nearest (ties away).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// w = hi + lo + lo2 exactly, each TF32: hi rounded to nearest, lo the
// rest cut to TF32, lo2 what is left (at most 2 bits).  For W, whose
// split error would be the same in every row, the third part keeps the
// dots at f32 accuracy.
__device__ __forceinline__ void split_w(float w, uint32_t& hi, uint32_t& lo,
                                        uint32_t& lo2) {
  hi = to_tf32(w);
  const float rest = w - __uint_as_float(hi);
  lo = __float_as_uint(rest) & 0xffffe000u;
  lo2 = __float_as_uint(rest - __uint_as_float(lo));
}

// An element of X (widened to f32) as (hi, lo) TF32 halves; a bf16 value
// is exact in TF32 (lo = 0, and its pass is skipped).
template <typename T>
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    split_tf32(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// c += a b for one m16n8k8 TF32 fragment triple.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The passes of one fragment product with X as A: hi*hi into `big`,
// a_hi b_lo and (f32 X, kXLo) a_lo b_hi into `small`.  The tensor cores
// add a product's terms to C with truncation after aligning them to the
// largest, so a running C would shave every hi*hi term toward zero, by
// the same sign on every row: hi*hi starts from zero at each call and its
// result is added to `big` with a rounded f32 add.  The small terms
// (2^-11 of it) run on in `small`.
template <bool kXLo>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hh, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) big[i] += hh[i];
  mma_tf32(small, ah, bl);
  if constexpr (kXLo) mma_tf32(small, al, bh);
}

}  // namespace
