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

// ---- Fp12 tower for the pairing kernels (pallas_pairing's in-kernel
// library): Fp6 = Fp2[v]/(v³ − ξ), Fp12 = Fp6[w]/(w² − v), ξ = 1 + u.  An
// F12 is laid out as its planes: plane m = (k·3 + j)·2 + c.  Every
// function below reads all of its operands before it writes its output, so
// the output may alias any operand.  The Fp2/Fp6 helpers are __noinline__:
// one copy each keeps the three pairing sources' code (and nvcc's time)
// bounded, at the price of passing operands through the local-memory stack.

static __device__ __noinline__ void mul_n(int* o, const int* a,
                                          const int* b) {
  mul(o, a, b);
}

static __device__ __noinline__ void f2_add_n(F2& o, const F2& a,
                                             const F2& b) {
  f2_add(o, a, b);
}

static __device__ __noinline__ void f2_sub_n(F2& o, const F2& a,
                                             const F2& b) {
  f2_sub(o, a, b);
}

static __device__ __noinline__ void f2_small_n(F2& o, const F2& a, int k) {
  f2_small(o, a, k);
}

// ×ξ = (1 + u): (a0 − a1) + (a0 + a1)·u
static __device__ __noinline__ void f2_mul_xi(F2& o, const F2& a) {
  int s[NL], d[NL];
  sub(d, a.c0, a.c1);
  add(s, a.c0, a.c1);
  copy(o.c0, d);
  copy(o.c1, s);
}

// Fp2 × Fp: both coefficients through the full multiplier
static __device__ __noinline__ void f2_mul_fp(F2& o, const F2& a,
                                              const int* s) {
  mul(o.c0, a.c0, s);
  mul(o.c1, a.c1, s);
}

struct F6 {
  F2 c[3];
};

struct F12 {
  F6 c[2];
};

static __device__ __noinline__ void f6_add(F6& o, const F6& a, const F6& b) {
#pragma unroll 1
  for (int i = 0; i < 3; ++i) f2_add_n(o.c[i], a.c[i], b.c[i]);
}

static __device__ __noinline__ void f6_sub(F6& o, const F6& a, const F6& b) {
#pragma unroll 1
  for (int i = 0; i < 3; ++i) f2_sub_n(o.c[i], a.c[i], b.c[i]);
}

// ×v: (ξ·a2, a0, a1)
static __device__ __noinline__ void f6_mul_by_v(F6& o, const F6& a) {
  F2 t;
  f2_mul_xi(t, a.c[2]);
  o.c[2] = a.c[1];
  o.c[1] = a.c[0];
  o.c[0] = t;
}

// Toom-style product: 6 Fp2 products (pallas_pairing._f6_mul)
static __device__ __noinline__ void f6_mul(F6& o, const F6& a, const F6& b) {
  F2 v0, v1, v2, s, t, t12, t01, t02, u;
  f2_mul(v0, a.c[0], b.c[0]);
  f2_mul(v1, a.c[1], b.c[1]);
  f2_mul(v2, a.c[2], b.c[2]);
  f2_add_n(s, a.c[1], a.c[2]);
  f2_add_n(t, b.c[1], b.c[2]);
  f2_mul(t12, s, t);
  f2_add_n(u, v1, v2);
  f2_sub_n(t12, t12, u);            // a1b2 + a2b1
  f2_add_n(s, a.c[0], a.c[1]);
  f2_add_n(t, b.c[0], b.c[1]);
  f2_mul(t01, s, t);
  f2_add_n(u, v0, v1);
  f2_sub_n(t01, t01, u);            // a0b1 + a1b0
  f2_add_n(s, a.c[0], a.c[2]);
  f2_add_n(t, b.c[0], b.c[2]);
  f2_mul(t02, s, t);
  f2_add_n(u, v0, v2);
  f2_sub_n(t02, t02, u);            // a0b2 + a2b0
  f2_mul_xi(u, t12);
  f2_add_n(o.c[0], v0, u);
  f2_mul_xi(u, v2);
  f2_add_n(o.c[1], t01, u);
  f2_add_n(o.c[2], t02, v1);
}

// Sparse (d0 + d1·v) product: 5 Fp2 products (pallas_pairing._f6_mul_by_01)
static __device__ __noinline__ void f6_mul_by_01(F6& o, const F6& a,
                                                 const F2& d0, const F2& d1) {
  F2 v0, v1, x12, x01, x02, s, t;
  f2_mul(v0, a.c[0], d0);
  f2_mul(v1, a.c[1], d1);
  f2_add_n(s, a.c[1], a.c[2]);
  f2_mul(x12, s, d1);
  f2_add_n(s, a.c[0], a.c[1]);
  f2_add_n(t, d0, d1);
  f2_mul(x01, s, t);
  f2_add_n(s, a.c[0], a.c[2]);
  f2_mul(x02, s, d0);
  f2_sub_n(s, x12, v1);
  f2_mul_xi(s, s);
  f2_add_n(o.c[0], v0, s);
  f2_add_n(s, v0, v1);
  f2_sub_n(o.c[1], x01, s);
  f2_sub_n(s, x02, v0);
  f2_add_n(o.c[2], s, v1);
}

// f² (pallas_pairing._f12_sqr)
static __device__ __noinline__ void f12_sqr(F12& o, const F12& f) {
  F6 v0, t, s, u;
  f6_mul(v0, f.c[0], f.c[1]);
  f6_add(s, f.c[0], f.c[1]);
  f6_mul_by_v(u, f.c[1]);
  f6_add(u, f.c[0], u);
  f6_mul(t, s, u);
  f6_sub(t, t, v0);
  f6_mul_by_v(u, v0);
  f6_sub(o.c[0], t, u);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) f2_small_n(o.c[1].c[i], v0.c[i], 2);
}

// f·g (pallas_pairing._f12_mul)
static __device__ __noinline__ void f12_mul(F12& o, const F12& f,
                                            const F12& g) {
  F6 aa, bb, s, t;
  f6_mul(aa, f.c[0], g.c[0]);
  f6_mul(bb, f.c[1], g.c[1]);
  f6_add(s, f.c[0], f.c[1]);
  f6_add(t, g.c[0], g.c[1]);
  f6_mul(s, s, t);                  // cross
  f6_add(t, aa, bb);
  f6_sub(o.c[1], s, t);
  f6_mul_by_v(t, bb);
  f6_add(o.c[0], aa, t);
}

// f·((c0 + c1·v) + c4·v·w): 13 Fp2 products (pallas_pairing._f12_mul_by_014)
static __device__ __noinline__ void f12_mul_by_014(F12& o, const F12& f,
                                                   const F2& c0, const F2& c1,
                                                   const F2& c4) {
  F6 aa, t6, bb, s;
  F2 o2;
  f6_mul_by_01(aa, f.c[0], c0, c1);
  f6_add(s, f.c[0], f.c[1]);
  f2_add_n(o2, c1, c4);
  f6_mul_by_01(t6, s, c0, o2);
  f2_mul(bb.c[1], f.c[1].c[0], c4);
  f2_mul(bb.c[2], f.c[1].c[1], c4);
  f2_mul(o2, f.c[1].c[2], c4);
  f2_mul_xi(bb.c[0], o2);           // bb = f1·c4·v: the v-rotation
  f6_add(s, aa, bb);
  f6_sub(o.c[1], t6, s);
  f6_mul_by_v(s, bb);
  f6_add(o.c[0], s, aa);
}

// ---- Miller-loop steps (pallas_pairing._dbl_step / _add_step) -------------
//
// The Miller accumulator is a projective twist point (X, Y, Z) ∈ Fp2³; a
// step returns the new point and the sparse line (c0, c1b, c4b).

struct Line {
  F2 c0, c1b, c4b;
};

// Doubling + the line through 2R, scaled by 2YZ² (EFD dbl-2007-bl, a = 0)
static __device__ __noinline__ void pp_double(G2& o, Line& l, const G2& p) {
  F2 XX, YY, s, XY, w, ss, B, wX, YYZ, sZ, wsq, YYss, sss, h, t, u;
  f2_sqr(XX, p.x);
  f2_sqr(YY, p.y);
  f2_mul(s, p.y, p.z);
  f2_mul(XY, p.x, p.y);
  f2_small_n(w, XX, 3);
  f2_sqr(ss, s);
  f2_mul(B, XY, s);
  f2_mul(l.c1b, w, p.z);
  f2_mul(wX, w, p.x);
  f2_mul(YYZ, YY, p.z);
  f2_mul(sZ, s, p.z);
  f2_sqr(wsq, w);
  f2_mul(YYss, YY, ss);
  f2_mul(sss, s, ss);
  f2_small_n(t, B, 8);
  f2_sub_n(h, wsq, t);
  f2_mul(t, h, s);                  // hs
  f2_small_n(o.x, t, 2);
  f2_small_n(t, B, 4);
  f2_sub_n(t, t, h);
  f2_mul(t, w, t);                  // wterm
  f2_small_n(u, YYss, 8);
  f2_sub_n(o.y, t, u);
  f2_small_n(o.z, sss, 8);
  f2_small_n(t, YYZ, 2);
  f2_sub_n(l.c0, t, wX);
  f2_small_n(l.c4b, sZ, 2);
}

// Mixed addition R + Q (Q affine (x2, y2)) + the line, scaled by δ
static __device__ __noinline__ void pp_add(G2& o, Line& l, const G2& p,
                                           const F2& x2, const F2& y2) {
  F2 yZ, xZ, theta, delta, c, d, dy, tx, e, f_, g, h, t, eY;
  f2_mul(yZ, y2, p.z);
  f2_mul(xZ, x2, p.z);
  f2_sub_n(theta, p.y, yZ);
  f2_sub_n(delta, p.x, xZ);
  f2_sqr(c, theta);
  f2_sqr(d, delta);
  f2_mul(dy, delta, y2);
  f2_mul(tx, theta, x2);
  f2_mul(e, delta, d);
  f2_mul(f_, p.z, c);
  f2_mul(g, p.x, d);
  f2_add_n(h, e, f_);
  f2_small_n(t, g, 2);
  f2_sub_n(h, h, t);
  f2_sub_n(t, g, h);
  f2_mul(t, theta, t);
  f2_mul(eY, e, p.y);
  f2_mul(o.z, p.z, e);
  f2_mul(o.x, delta, h);
  f2_sub_n(o.y, t, eY);
  f2_sub_n(l.c0, dy, tx);
  l.c1b = theta;
  l.c4b = delta;
}

// ---- G1 complete group law (RCB16 Algs 7/9, a = 0, b₃ = 12) ---------------

struct G1 {
  int x[NL], y[NL], z[NL];
};

static __device__ __noinline__ void g1_double(G1& o, const G1& p) {
  int yy[NL], yz[NL], zz[NL], xy[NL], bzz[NL], e8[NL], s[NL], d[NL],
      t[NL], u[NL];
  mul_n(yy, p.y, p.y);
  mul_n(yz, p.y, p.z);
  mul_n(zz, p.z, p.z);
  mul_n(xy, p.x, p.y);
  mul_small(bzz, zz, 12);
  mul_small(e8, yy, 8);
  add(s, yy, bzz);
  mul_small(t, bzz, 3);
  sub(d, yy, t);
  mul_n(t, d, xy);
  mul_small(o.x, t, 2);
  mul_n(t, bzz, e8);
  mul_n(u, d, s);
  add(o.y, t, u);
  mul_n(o.z, yz, e8);
}

static __device__ __noinline__ void g1_add(G1& o, const G1& p1,
                                           const G1& p2) {
  int t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], t5[NL], a[NL], b[NL];
  mul_n(t0, p1.x, p2.x);
  mul_n(t1, p1.y, p2.y);
  mul_n(t2, p1.z, p2.z);
  add(a, p1.x, p1.y);
  add(b, p2.x, p2.y);
  mul_n(t3, a, b);                  // pxy
  add(a, p1.y, p1.z);
  add(b, p2.y, p2.z);
  mul_n(t4, a, b);                  // pyz
  add(a, p1.x, p1.z);
  add(b, p2.x, p2.z);
  mul_n(t5, a, b);                  // pxz
  add(a, t0, t1);
  sub(t3, t3, a);                   // X1Y2 + X2Y1
  add(a, t1, t2);
  sub(t4, t4, a);                   // Y1Z2 + Y2Z1
  add(a, t0, t2);
  sub(t5, t5, a);                   // X1Z2 + X2Z1
  int m[NL], bz[NL], s[NL], d[NL], by[NL];
  mul_small(m, t0, 3);
  mul_small(bz, t2, 12);
  add(s, t1, bz);
  sub(d, t1, bz);
  mul_small(by, t5, 12);
  mul_n(a, t3, d);
  mul_n(b, t4, by);
  sub(o.x, a, b);
  mul_n(a, d, s);
  mul_n(b, m, by);
  add(o.y, a, b);
  mul_n(a, t4, s);
  mul_n(b, t3, m);
  add(o.z, a, b);
}

// ---- exact boundary (fp.canon_std / fp.is_zero / fp.sgn) ------------------
//
// A canonical form is unique, so these agree with the plain tensor code by
// construction, whatever the carry order.

// value(a) (32 nonnegative limbs <= LMAX) → 34 exact 12-bit digits
__device__ __forceinline__ void exact_digits(int* d, const int* a) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int v = a[i] + c;
    d[i] = v & MASK;
    c = v >> LB;
  }
  d[NL] = c & MASK;
  d[NL + 1] = c >> LB;
}

// d >= PMULT[k], lexicographic over 34 digits
__device__ __forceinline__ bool ge_pmult(const int* d, int k) {
#pragma unroll 1
  for (int i = NL + 1; i >= 0; --i) {
    if (d[i] != PMULT[k][i]) return d[i] > PMULT[k][i];
  }
  return true;
}

// a redundant residue → its canonical standard form in [0, p): subtract
// the largest multiple c·p <= value(a), c < 48
static __device__ __noinline__ void canon(int* o, const int* a) {
  int d[NL + 2];
  exact_digits(d, a);
  int c = 0;
#pragma unroll 1
  for (int k = 1; k < 48; ++k) {
    if (ge_pmult(d, k)) c = k;
  }
  int borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int v = d[i] - PMULT[c][i] - borrow;
    borrow = v < 0;
    o[i] = v + (borrow << LB);
  }
}

// value(a) ≡ 0 (mod p)
static __device__ __noinline__ bool is_zero(const int* a) {
  int c[NL];
  canon(c, a);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= c[i];
  return acc == 0;
}

// ZCash sign of a STANDARD-form element: a >= (p + 1) / 2
__device__ __forceinline__ bool sgn(const int* a) {
#pragma unroll 1
  for (int i = NL - 1; i >= 0; --i) {
    if (a[i] != HALF_P1[i]) return a[i] > HALF_P1[i];
  }
  return true;
}

__device__ __forceinline__ bool f2_is_zero(const F2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
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
