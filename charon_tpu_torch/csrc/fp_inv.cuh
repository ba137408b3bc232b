// fp_inv.cuh — the Fp inverse a^(p−2) for one thread: K11's (final_exp.cu,
// the inverse of its easy part) and K19's (normalize.cu, Z's norm).
//
// fp_inv is fp.pow_fixed's square-and-multiply, LSB first: 380 squarings
// and 229 products, the sequence K11's plain version runs, so K11 stays
// bit-identical to it.  fp_inv_w4 is the same power by 4-bit windows, MSB
// first: the table a¹..a¹⁵ (14 products), then per window four squarings
// and, for a non-zero digit, one product — 489 products.  Its output is
// another redundant residue of the same value; K19 canonicalises it.
// inv(0) = 0 for both.
#pragma once

#include "fp381.cuh"

namespace fp381 {

// a^(p−2), LSB first (fp.pow_fixed's schedule)
static __device__ __noinline__ void fp_inv(int* o, const int* a) {
  int result[NL], base[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) result[i] = i == 0;
  copy(base, a);
#pragma unroll 1
  for (int i = 0; i < EXP_PM2_BITS; ++i) {
    if ((EXP_PM2[i >> 5] >> (i & 31)) & 1u) {
      mul_n(result, result, base);
    }
    if (i != EXP_PM2_BITS - 1) mul_n(base, base, base);
  }
  copy(o, result);
}

// a^(p−2) by 4-bit windows, MSB first; digit k of p − 2 is bits 4k..4k+3
// of EXP_PM2 (the top one, k = 95, is 1).  The table sits in the thread's
// local memory.  o may alias a.
static __device__ __noinline__ void fp_inv_w4(int* o, const int* a) {
  constexpr int NDIG = (EXP_PM2_BITS + 3) / 4;
  int tbl[15][NL], acc[NL];
  copy(tbl[0], a);
  mul_n(tbl[1], a, a);
#pragma unroll 1
  for (int k = 2; k < 15; ++k) mul_n(tbl[k], tbl[k - 1], a);
  copy(acc, tbl[((EXP_PM2[(NDIG - 1) >> 3] >> (((NDIG - 1) & 7) * 4)) & 15)
                - 1]);
#pragma unroll 1
  for (int k = NDIG - 2; k >= 0; --k) {
#pragma unroll 1
    for (int j = 0; j < 4; ++j) mul_n(acc, acc, acc);
    const int d = (EXP_PM2[k >> 3] >> ((k & 7) * 4)) & 15;
    if (d) mul_n(acc, acc, tbl[d - 1]);
  }
  copy(o, acc);
}

}  // namespace fp381
