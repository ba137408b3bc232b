// fp381.cuh — BLS12-381 Fp / Fp2 / G2 arithmetic for one CUDA thread.
//
// The device field library shared by the port's kernels (fp_ops.cu: K1,
// g2.cu: K2 and K3).  It is the JAX package's column arithmetic
// (charon_tpu/ops/fp.py and the in-kernel library of ops/pallas_g2.py),
// carried over operation for operation so that every kernel is
// bit-identical to its plain PyTorch version:
//
//   element   32 little-endian 12-bit limbs in int32, each <= LMAX = 8191
//             (a redundant residue: value mod p, value < 2·2^384)
//   product   63 schoolbook columns, each <= 32·LMAX² < 2^31
//   reduce    (2 partial-carry rounds + fold of columns >= 32 through
//             FOLDC) × (1 + ITERS)
//   Fp2       lazy Karatsuba: the three sub-products combine at column
//             level with a spread multiple of p (OFF1 / OFF2) keeping the
//             columns nonnegative, then ONE reduction per coefficient
//   G2        complete RCB a = 0 doubling and addition (RCB16 Algs 7/9),
//             b3 = 12·(1 + u)
//
// All integer arithmetic is exact (no column ever reaches 2^31), so the
// order of additions cannot change a result.  Loops run over compile-time
// bounds and are fully unrolled, so limb arrays live in registers inside
// each function; the large Fp2 and G2 functions are __noinline__ to keep
// the code size (and the instruction cache footprint) bounded.
#pragma once

#include <cuda_runtime.h>

#include "fp381_consts.cuh"

namespace fp381 {

constexpr int NL = 32;      // limbs per element
constexpr int LB = 12;      // bits per limb
constexpr int MASK = 4095;

// One partial-carry round over columns x[0..W) widening to x[0..W]:
// x'[i] = (x[i] & MASK) + (x[i-1] >> 12).
template <int W>
__device__ __forceinline__ void carry_round(int* x) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int v = x[i];
    x[i] = (v & MASK) + carry;
    carry = v >> LB;
  }
  x[W] = carry;
}

// Fold columns x[32..W) into x[0..32): column 32+j is worth FOLDC[j] mod p.
template <int W>
__device__ __forceinline__ void fold(int* x) {
#pragma unroll
  for (int j = 0; j < W - NL; ++j) {
    const int h = x[NL + j];
#pragma unroll
    for (int i = 0; i < NL; ++i) x[i] += h * FOLDC[j][i];
  }
}

// fp._reduce(x, ITERS) on W columns (x holds W + 2 slots): the result is
// the redundant residue in x[0..32).
template <int W, int ITERS>
__device__ __forceinline__ void reduce(int* x) {
  carry_round<W>(x);
  carry_round<W + 1>(x);
  fold<W + 2>(x);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    carry_round<NL>(x);
    carry_round<NL + 1>(x);
    fold<NL + 2>(x);
  }
}

// 63 schoolbook columns c[k] = Σ_{i+j=k} a[i]·b[j].
__device__ __forceinline__ void conv(int* c, const int* a, const int* b) {
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int ai = a[i];
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += ai * b[j];
  }
}

__device__ __forceinline__ void copy(int* o, const int* x) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = x[i];
}

// ---- Fp ring ops (fp.mul / add / sub / neg / mul_small) -------------------

__device__ __forceinline__ void mul(int* o, const int* a, const int* b) {
  int c[2 * NL + 1];
  conv(c, a, b);
  reduce<2 * NL - 1, 5>(c);
  copy(o, c);
}

__device__ __forceinline__ void add(int* o, const int* a, const int* b) {
  int c[NL + 2];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] + b[i];
  reduce<NL, 1>(c);
  copy(o, c);
}

// a − b + 48p (spread form: every column stays nonnegative)
__device__ __forceinline__ void sub(int* o, const int* a, const int* b) {
  int c[NL + 3];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = SPREAD48P[i] + a[i] - b[i];
  c[NL] = SPREAD48P[NL];
  reduce<NL + 1, 1>(c);
  copy(o, c);
}

__device__ __forceinline__ void neg(int* o, const int* a) {
  int c[NL + 3];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = SPREAD48P[i] - a[i];
  c[NL] = SPREAD48P[NL];
  reduce<NL + 1, 1>(c);
  copy(o, c);
}

// a·k for 1 <= k <= 16
__device__ __forceinline__ void mul_small(int* o, const int* a, int k) {
  int c[NL + 2];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] * k;
  reduce<NL, 2>(c);
  copy(o, c);
}

// ---- Fp2 (pallas_g2 _f2add / _f2sub / _f2small / _f2mul / _f2sqr) --------

struct F2 {
  int c0[NL];
  int c1[NL];
};

__device__ __forceinline__ void f2_add(F2& o, const F2& a, const F2& b) {
  add(o.c0, a.c0, b.c0);
  add(o.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_sub(F2& o, const F2& a, const F2& b) {
  sub(o.c0, a.c0, b.c0);
  sub(o.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_small(F2& o, const F2& a, int k) {
  mul_small(o.c0, a.c0, k);
  mul_small(o.c1, a.c1, k);
}

// conv followed by two partial-carry rounds: 65 columns, each < 2^13
__device__ __forceinline__ void conv_pc2(int* t, const int* a, const int* b) {
  conv(t, a, b);
  carry_round<2 * NL - 1>(t);
  carry_round<2 * NL>(t);
}

// Lazy Karatsuba Fp2 product.  Reads a and b completely before writing o,
// so o may alias either operand.
static __device__ __noinline__ void f2_mul(F2& o, const F2& a, const F2& b) {
  int t0[2 * NL + 1], t1[2 * NL + 1], t2[2 * NL + 1];
  int sa[NL], sb[NL];
  conv_pc2(t0, a.c0, b.c0);
  conv_pc2(t1, a.c1, b.c1);
  add(sa, a.c0, a.c1);
  add(sb, b.c0, b.c1);
  conv_pc2(t2, sa, sb);
  int c[2 * NL + 4];  // 66 columns + 2 carry slots
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) c[i] = t2[i] - t0[i] - t1[i] + OFF2[i];
  c[2 * NL + 1] = OFF2[2 * NL + 1];
  reduce<2 * NL + 2, 6>(c);
  copy(o.c1, c);
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) c[i] = t0[i] - t1[i] + OFF1[i];
  c[2 * NL + 1] = OFF1[2 * NL + 1];
  reduce<2 * NL + 2, 6>(c);
  copy(o.c0, c);
}

// (a0+a1)(a0−a1) + 2·a0·a1·u.  o may alias a.
static __device__ __noinline__ void f2_sqr(F2& o, const F2& a) {
  int s[NL], d[NL];
  add(s, a.c0, a.c1);
  sub(d, a.c0, a.c1);
  int t[2 * NL + 3];
  conv_pc2(t, a.c0, a.c1);
#pragma unroll
  for (int i = 0; i < 2 * NL + 1; ++i) t[i] *= 2;
  reduce<2 * NL + 1, 5>(t);
  copy(o.c1, t);
  mul(o.c0, s, d);
}

// ×3b = ×12·(1 + u): ξ-rotation then a small multiple.  o may alias a.
__device__ __forceinline__ void f2_mul_b3(F2& o, const F2& a) {
  int s[NL], d[NL];
  sub(d, a.c0, a.c1);
  add(s, a.c0, a.c1);
  mul_small(o.c0, d, 12);
  mul_small(o.c1, s, 12);
}

// ---- G2 complete group law (pallas_g2 _g2_double / _g2_add) ---------------

struct G2 {
  F2 x, y, z;
};

// o may alias p
static __device__ __noinline__ void g2_double(G2& o, const G2& p) {
  F2 yy, yz, zz, xy, bzz, e8, s, d, t, u;
  f2_sqr(yy, p.y);
  f2_mul(yz, p.y, p.z);
  f2_sqr(zz, p.z);
  f2_mul(xy, p.x, p.y);
  f2_mul_b3(bzz, zz);
  f2_small(e8, yy, 8);
  f2_add(s, yy, bzz);
  f2_small(t, bzz, 3);
  f2_sub(d, yy, t);
  f2_mul(t, d, xy);
  f2_small(o.x, t, 2);
  f2_mul(t, bzz, e8);
  f2_mul(u, d, s);
  f2_add(o.y, t, u);
  f2_mul(o.z, yz, e8);
}

// o may alias p1 or p2
static __device__ __noinline__ void g2_add(G2& o, const G2& p1, const G2& p2) {
  F2 t0, t1, t2, t3, t4, t5, a, b;
  f2_mul(t0, p1.x, p2.x);
  f2_mul(t1, p1.y, p2.y);
  f2_mul(t2, p1.z, p2.z);
  f2_add(a, p1.x, p1.y);
  f2_add(b, p2.x, p2.y);
  f2_mul(t3, a, b);                 // pxy
  f2_add(a, p1.y, p1.z);
  f2_add(b, p2.y, p2.z);
  f2_mul(t4, a, b);                 // pyz
  f2_add(a, p1.x, p1.z);
  f2_add(b, p2.x, p2.z);
  f2_mul(t5, a, b);                 // pxz
  f2_add(a, t0, t1);
  f2_sub(t3, t3, a);                // X1Y2 + X2Y1
  f2_add(a, t1, t2);
  f2_sub(t4, t4, a);                // Y1Z2 + Y2Z1
  f2_add(a, t0, t2);
  f2_sub(t5, t5, a);                // X1Z2 + X2Z1
  F2 m, bz, s, d, by;
  f2_small(m, t0, 3);               // 3·X1X2
  f2_mul_b3(bz, t2);                // 3b·Z1Z2
  f2_add(s, t1, bz);
  f2_sub(d, t1, bz);
  f2_mul_b3(by, t5);
  f2_mul(a, t3, d);
  f2_mul(b, t4, by);
  f2_sub(o.x, a, b);
  f2_mul(a, d, s);
  f2_mul(b, m, by);
  f2_add(o.y, a, b);
  f2_mul(a, t4, s);
  f2_mul(b, t3, m);
  f2_add(o.z, a, b);
}

// ---- point planes in device memory: [6, 32, stride], row r ---------------

__device__ __forceinline__ void load_el(int* o, const int* plane, int r,
                                        int stride) {
#pragma unroll
  for (int k = 0; k < NL; ++k) o[k] = plane[(size_t)k * stride + r];
}

__device__ __forceinline__ void store_el(int* plane, const int* x, int r,
                                         int stride) {
#pragma unroll
  for (int k = 0; k < NL; ++k) plane[(size_t)k * stride + r] = x[k];
}

__device__ __forceinline__ void load_pt(G2& o, const int* p, int r,
                                        int stride) {
  const size_t ps = (size_t)NL * stride;
  load_el(o.x.c0, p + 0 * ps, r, stride);
  load_el(o.x.c1, p + 1 * ps, r, stride);
  load_el(o.y.c0, p + 2 * ps, r, stride);
  load_el(o.y.c1, p + 3 * ps, r, stride);
  load_el(o.z.c0, p + 4 * ps, r, stride);
  load_el(o.z.c1, p + 5 * ps, r, stride);
}

__device__ __forceinline__ void store_pt(int* p, const G2& x, int r,
                                         int stride) {
  const size_t ps = (size_t)NL * stride;
  store_el(p + 0 * ps, x.x.c0, r, stride);
  store_el(p + 1 * ps, x.x.c1, r, stride);
  store_el(p + 2 * ps, x.y.c0, r, stride);
  store_el(p + 3 * ps, x.y.c1, r, stride);
  store_el(p + 4 * ps, x.z.c0, r, stride);
  store_el(p + 5 * ps, x.z.c1, r, stride);
}

}  // namespace fp381
