// Warp-level f32-accurate products on the tensor cores for ssd_scan.cu:
// mma.sync.m16n8k8 in TF32 with a 3xTF32 split. An f32 operand x is cut
// into hi = x with the low 13 mantissa bits cleared (TF32's 10 bits kept,
// by truncation: a mask, where cvt.rna.tf32 costs several instructions)
// and lo = x - hi, exact in f32; the tensor core reads lo's top 10
// mantissa bits, so hi + lo is within 2^-20 of x. a.b is summed as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32; the dropped a_lo.b_lo is
// below 2^-20 of a.b. An operand that is exact in TF32 (a bf16 input
// widened to f32) has lo = 0, and its term is skipped: two passes for one
// exact operand, one for two.
#pragma once
#include <stdint.h>

// hi and lo of x; lo = 0 where x is exact in TF32 (EXACT)
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// c += a.b, a 16x8 (row), b 8x8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += A[16 mt.., k] . B[k, 8 nt..] over k in [0, k_end) (a
// multiple of 8), for the n-tiles nt < nt_end. a(m, k) and b(k, n) read
// f32 from shared memory. Fragment layout of m16n8k8 (g = lane / 4,
// t = lane % 4): A rows g and g + 8 at columns t and t + 4, B column g at
// rows t and t + 4, C rows g and g + 8 at columns 2t and 2t + 1.
template <int MT, int NT, bool A_EXACT, bool B_EXACT, class FA, class FB>
__device__ __forceinline__ void warp_mma_3xtf32(float (&acc)[MT][NT][4],
                                                FA a, FB b, int k_end,
                                                int nt_end, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < k_end; k += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 16 + g;
      split_tf32<A_EXACT>(a(m, k + t), ah[mt][0], al[mt][0]);
      split_tf32<A_EXACT>(a(m + 8, k + t), ah[mt][1], al[mt][1]);
      split_tf32<A_EXACT>(a(m, k + t + 4), ah[mt][2], al[mt][2]);
      split_tf32<A_EXACT>(a(m + 8, k + t + 4), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nt_end) break;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32<B_EXACT>(b(k + t, nt * 8 + g), bh0, bl0);
      split_tf32<B_EXACT>(b(k + t + 4, nt * 8 + g), bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (!A_EXACT) mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
        if constexpr (!B_EXACT) mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
        mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}
