// fp_lanes.cuh — the csrc/fp381.cuh field library with one element spread
// over the G lanes of a row group: what kernels K11 (final_exp.cu) and K12
// (decompress.cu) compute on.
//
// Lane q of a group holds limbs B·q .. B·q + B − 1 of an element (B = 32 /
// G), so an Fp2 value is 2·B registers a lane instead of 64 a thread.  Every
// function computes exactly the integers of its fp381.cuh namesake — the
// same schoolbook columns, partial-carry rounds and folds — so a kernel on
// this library is bit-identical to one on fp381.cuh; integer arithmetic is
// exact, so the order in which the lanes add cannot change a bit.
// - conv: lane q computes columns B·q + t and 32 + B·q + t of a·b (t < B).
//   The operand a is held as two lane-relative windows, lo[m] = a[B·q + m −
//   31] and hi[m] = a[32 + B·q + m − 31], built from the group's blocks by
//   shuffles, so every register index is a compile-time constant; b is
//   gathered whole.  A lane's terms that index below limb 0 or above limb
//   31 are zero at compile time where the window says so.
// - a partial-carry round x'[i] = (x[i] & MASK) + (x[i−1] >> 12) needs the
//   column below a lane's block: one shuffle from the lane below (lane G − 1
//   for column 31 and column 63).  Columns 32..34 of the short reductions and
//   64..67 of the long ones are held by every lane alike.
// - a fold adds column 32 + j times FOLDC[j] to the 32 limbs: the high
//   columns are broadcast by shuffles, each lane folds them into its own
//   block, the constants read from shared memory (`Consts`, which a kernel
//   fills once a block): the lanes of a group read different words.
// The shuffles name only the group's own lanes (`Lane::mask`), so the groups
// of a warp may take different branches.
#pragma once

#include "fp381.cuh"

namespace fpl {

using fp381::LB;
using fp381::MASK;
using fp381::NL;

// fp381's constants, read at lane-dependent limbs, in shared memory
struct Consts {
  int foldc[36][NL];
  int spread[NL + 1];
  int off1[2 * NL + 2];
  int off2[2 * NL + 2];
};

// Thread `tid` of `nthreads` copies its share of the constants; the caller
// synchronises the block before the first use.
__device__ __forceinline__ void load_consts(Consts& k, int tid,
                                            int nthreads) {
  for (int i = tid; i < 36 * NL; i += nthreads) {
    k.foldc[i / NL][i % NL] = fp381::FOLDC[i / NL][i % NL];
  }
  for (int i = tid; i < NL + 1; i += nthreads) k.spread[i] = fp381::SPREAD48P[i];
  for (int i = tid; i < 2 * NL + 2; i += nthreads) {
    k.off1[i] = fp381::OFF1[i];
    k.off2[i] = fp381::OFF2[i];
  }
}

// A thread's place in its group of G lanes (groups aligned to G in the
// warp): its lane q and the shuffle mask of the group's lanes.
template <int G>
struct Lane {
  int q;
  unsigned mask;
  const Consts* k;
  __device__ __forceinline__ Lane(int tid, const Consts* c) : k(c) {
    static_assert(G >= 1 && G <= 32 && 32 % G == 0, "G divides a warp");
    const int w = tid & 31;
    q = w % G;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (w - q);
  }
  // value of `v` in the lane `d` below (0 below lane 0)
  __device__ __forceinline__ int below(int v, int d) const {
    const int r = __shfl_up_sync(mask, v, d, G);
    return q >= d ? r : 0;
  }
  // value of `v` in the lane `d` above (0 above lane G − 1)
  __device__ __forceinline__ int above(int v, int d) const {
    const int r = __shfl_down_sync(mask, v, d, G);
    return q + d < G ? r : 0;
  }
  __device__ __forceinline__ int from(int v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

template <int G>
struct F {
  static constexpr int B = NL / G;
  using L = Lane<G>;

  struct E {                 // an Fp element: this lane's limbs B·q + t
    int v[B];
  };
  struct E2 {
    E c0, c1;
  };
  struct P2 {                // a G2 point, projective
    E2 x, y, z;
  };
  // columns 0..67 of a product: lo (B·q + t), hi (32 + B·q + t), top
  // (64 + j, every lane alike)
  struct Cols {
    int lo[B], hi[B], top[4];
  };

  // ---- carry rounds and folds ---------------------------------------------

  // one round over a lane's block of columns; `prev` is the original value
  // of the column below it
  static __device__ __forceinline__ void carry_block(int* x, int prev) {
#pragma unroll
    for (int t = 0; t < B; ++t) {
      const int v = x[t];
      x[t] = (v & MASK) + (prev >> LB);
      prev = v;
    }
  }

  // carry_round<W> for 32 <= W <= 34: columns 0..W−1 → 0..W; ext holds
  // columns 32.. (every lane alike)
  template <int W>
  static __device__ __forceinline__ void carry_short(const L& l, int* lo,
                                                     int* ext) {
    const int p = l.below(lo[B - 1], 1);
    int prev = l.from(lo[B - 1], G - 1);
#pragma unroll
    for (int j = 0; j < W - NL; ++j) {
      const int v = ext[j];
      ext[j] = (v & MASK) + (prev >> LB);
      prev = v;
    }
    ext[W - NL] = prev >> LB;
    carry_block(lo, p);
  }

  // fold<W> for 32 < W <= 35: lo += Σ_j ext[j]·FOLDC[j]
  template <int W>
  static __device__ __forceinline__ void fold_short(const L& l, int* lo,
                                                    const int* ext) {
#pragma unroll
    for (int j = 0; j < W - NL; ++j) {
      const int* f = l.k->foldc[j] + B * l.q;
#pragma unroll
      for (int t = 0; t < B; ++t) lo[t] += ext[j] * f[t];
    }
  }

  // fp381::reduce<W, ITERS> for W <= 33 (lo and ext[0..W−33])
  template <int W, int ITERS>
  static __device__ __forceinline__ void reduce_short(const L& l, int* lo,
                                                      int* ext) {
    carry_short<W>(l, lo, ext);
    carry_short<W + 1>(l, lo, ext);
    fold_short<W + 2>(l, lo, ext);
#pragma unroll 1
    for (int it = 0; it < ITERS; ++it) {
      int e[3];
      carry_short<NL>(l, lo, e);
      carry_short<NL + 1>(l, lo, e);
      fold_short<NL + 2>(l, lo, e);
    }
  }

  // carry_round<W> for 63 <= W <= 67 over lo, hi and top[0..W−65]
  template <int W>
  static __device__ __forceinline__ void carry_long(const L& l, Cols& x) {
    const int p_lo = l.below(x.lo[B - 1], 1);
    const int p_hi = l.below(x.hi[B - 1], 1);
    const int c31 = l.from(x.lo[B - 1], G - 1);
    const int c63 = l.from(x.hi[B - 1], G - 1);
    if (W >= 64) {
      int prev = c63;
#pragma unroll
      for (int j = 0; j < W - 64; ++j) {
        const int v = x.top[j];
        x.top[j] = (v & MASK) + (prev >> LB);
        prev = v;
      }
      x.top[W >= 64 ? W - 64 : 0] = prev >> LB;
    }
    carry_block(x.lo, p_lo);
    carry_block(x.hi, l.q ? p_hi : c31);
  }

  // fold<W> for 64 < W <= 68: lo += Σ_{c=32}^{W−1} column c · FOLDC[c − 32]
  template <int W>
  static __device__ __forceinline__ void fold_long(const L& l, Cols& x) {
#pragma unroll
    for (int src = 0; src < G; ++src) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const int h = l.from(x.hi[k], src);
        const int* f = l.k->foldc[B * src + k] + B * l.q;
#pragma unroll
        for (int t = 0; t < B; ++t) x.lo[t] += h * f[t];
      }
    }
#pragma unroll
    for (int j = 0; j < W - 64; ++j) {
      const int* f = l.k->foldc[NL + j] + B * l.q;
#pragma unroll
      for (int t = 0; t < B; ++t) x.lo[t] += x.top[j] * f[t];
    }
  }

  // fp381::reduce<W, ITERS> for 63 <= W <= 66 → the residue in o
  template <int W, int ITERS>
  static __device__ __forceinline__ void reduce_long(const L& l, E& o,
                                                     Cols& x) {
    carry_long<W>(l, x);
    carry_long<W + 1>(l, x);
    fold_long<W + 2>(l, x);
    int e[3];
#pragma unroll 1
    for (int it = 0; it < ITERS; ++it) {
      carry_short<NL>(l, x.lo, e);
      carry_short<NL + 1>(l, x.lo, e);
      fold_short<NL + 2>(l, x.lo, e);
    }
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = x.lo[t];
  }

  // ---- the schoolbook columns ---------------------------------------------

  // 63 columns of a·b (column 63 zero): lo and hi of x
  static __device__ __forceinline__ void conv(const L& l, Cols& x,
                                              const E& a, const E& b) {
    // window m of lo: a[B·q + m − 31]; of hi: a[32 + B·q + m − 31]
    int wl[NL + B - 1], wh[NL + B - 1];
#pragma unroll
    for (int m = 0; m < NL + B - 1; ++m) wl[m] = wh[m] = 0;
#pragma unroll
    for (int d = 0; d < G; ++d) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        // block q − d at m = 31 − B·d + k; block q + d at m = B·d + k − 1
        wl[NL - 1 - B * d + k] = d ? l.below(a.v[k], d) : a.v[k];
        if (B * d + k >= 1) wh[B * d + k - 1] = d ? l.above(a.v[k], d) : a.v[k];
      }
    }
    int bb[NL];
#pragma unroll
    for (int src = 0; src < G; ++src) {
#pragma unroll
      for (int k = 0; k < B; ++k) bb[B * src + k] = l.from(b.v[k], src);
    }
#pragma unroll
    for (int t = 0; t < B; ++t) {
      int s = 0, u = 0;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        // terms whose window entry is zero at compile time drop out
        if (NL - 1 + t - j >= B - 1) s += bb[j] * wl[NL - 1 + t - j];
        if (NL - 1 + t - j <= NL - 2) u += bb[j] * wh[NL - 1 + t - j];
      }
      x.lo[t] = s;
      x.hi[t] = u;
    }
  }

  // conv + two partial-carry rounds: 65 columns (fp381::conv_pc2)
  static __device__ __forceinline__ void conv_pc2(const L& l, Cols& x,
                                                  const E& a, const E& b) {
    conv(l, x, a, b);
    carry_long<2 * NL - 1>(l, x);
    carry_long<2 * NL>(l, x);
  }

  // ---- Fp ring ops ---------------------------------------------------------

  static __device__ __noinline__ void mul(const L& l, E& o, const E& a,
                                          const E& b) {
    Cols x;
    conv(l, x, a, b);
    reduce_long<2 * NL - 1, 5>(l, o, x);
  }

  static __device__ __forceinline__ void add(const L& l, E& o, const E& a,
                                             const E& b) {
    int lo[B], e[3];
#pragma unroll
    for (int t = 0; t < B; ++t) lo[t] = a.v[t] + b.v[t];
    reduce_short<NL, 1>(l, lo, e);
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = lo[t];
  }

  // a − b + 48p (spread form)
  static __device__ __forceinline__ void sub(const L& l, E& o, const E& a,
                                             const E& b) {
    int lo[B], e[3];
    const int* s = l.k->spread + B * l.q;
#pragma unroll
    for (int t = 0; t < B; ++t) lo[t] = s[t] + a.v[t] - b.v[t];
    e[0] = l.k->spread[NL];
    reduce_short<NL + 1, 1>(l, lo, e);
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = lo[t];
  }

  static __device__ __forceinline__ void neg(const L& l, E& o, const E& a) {
    int lo[B], e[3];
    const int* s = l.k->spread + B * l.q;
#pragma unroll
    for (int t = 0; t < B; ++t) lo[t] = s[t] - a.v[t];
    e[0] = l.k->spread[NL];
    reduce_short<NL + 1, 1>(l, lo, e);
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = lo[t];
  }

  static __device__ __forceinline__ void mul_small(const L& l, E& o,
                                                   const E& a, int k) {
    int lo[B], e[3];
#pragma unroll
    for (int t = 0; t < B; ++t) lo[t] = a.v[t] * k;
    reduce_short<NL, 2>(l, lo, e);
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = lo[t];
  }

  // ---- Fp2 -----------------------------------------------------------------

  static __device__ __noinline__ void f2_add(const L& l, E2& o, const E2& a,
                                             const E2& b) {
    add(l, o.c0, a.c0, b.c0);
    add(l, o.c1, a.c1, b.c1);
  }

  static __device__ __noinline__ void f2_sub(const L& l, E2& o, const E2& a,
                                             const E2& b) {
    sub(l, o.c0, a.c0, b.c0);
    sub(l, o.c1, a.c1, b.c1);
  }

  static __device__ __noinline__ void f2_neg(const L& l, E2& o, const E2& a) {
    neg(l, o.c0, a.c0);
    neg(l, o.c1, a.c1);
  }

  static __device__ __noinline__ void f2_small(const L& l, E2& o,
                                               const E2& a, int k) {
    mul_small(l, o.c0, a.c0, k);
    mul_small(l, o.c1, a.c1, k);
  }

  // ×ξ = (a0 − a1) + (a0 + a1)·u (fp381::f2_mul_xi)
  static __device__ __noinline__ void f2_mul_xi(const L& l, E2& o,
                                                const E2& a) {
    E s, d;
    sub(l, d, a.c0, a.c1);
    add(l, s, a.c0, a.c1);
    o.c0 = d;
    o.c1 = s;
  }

  // ×3b = ×12·(1 + u) (fp381::f2_mul_b3)
  static __device__ __forceinline__ void f2_mul_b3(const L& l, E2& o,
                                                   const E2& a) {
    E s, d;
    sub(l, d, a.c0, a.c1);
    add(l, s, a.c0, a.c1);
    mul_small(l, o.c0, d, 12);
    mul_small(l, o.c1, s, 12);
  }

  // the lazy Karatsuba product (fp381::f2_mul); o may alias a or b
  static __device__ __noinline__ void f2_mul(const L& l, E2& o, const E2& a,
                                             const E2& b) {
    Cols t0, t1, t2;
    E sa, sb;
    conv_pc2(l, t0, a.c0, b.c0);
    conv_pc2(l, t1, a.c1, b.c1);
    add(l, sa, a.c0, a.c1);
    add(l, sb, b.c0, b.c1);
    conv_pc2(l, t2, sa, sb);
    const int* f2lo = l.k->off2 + B * l.q;
    const int* f2hi = l.k->off2 + NL + B * l.q;
    const int* f1lo = l.k->off1 + B * l.q;
    const int* f1hi = l.k->off1 + NL + B * l.q;
    Cols c;
#pragma unroll
    for (int t = 0; t < B; ++t) {
      c.lo[t] = t2.lo[t] - t0.lo[t] - t1.lo[t] + f2lo[t];
      c.hi[t] = t2.hi[t] - t0.hi[t] - t1.hi[t] + f2hi[t];
    }
    c.top[0] = t2.top[0] - t0.top[0] - t1.top[0] + l.k->off2[2 * NL];
    c.top[1] = l.k->off2[2 * NL + 1];
    reduce_long<2 * NL + 2, 6>(l, o.c1, c);
#pragma unroll
    for (int t = 0; t < B; ++t) {
      c.lo[t] = t0.lo[t] - t1.lo[t] + f1lo[t];
      c.hi[t] = t0.hi[t] - t1.hi[t] + f1hi[t];
    }
    c.top[0] = t0.top[0] - t1.top[0] + l.k->off1[2 * NL];
    c.top[1] = l.k->off1[2 * NL + 1];
    reduce_long<2 * NL + 2, 6>(l, o.c0, c);
  }

  // (a0 + a1)(a0 − a1) + 2·a0·a1·u (fp381::f2_sqr); o may alias a
  static __device__ __noinline__ void f2_sqr(const L& l, E2& o, const E2& a) {
    E s, d;
    add(l, s, a.c0, a.c1);
    sub(l, d, a.c0, a.c1);
    Cols t;
    conv_pc2(l, t, a.c0, a.c1);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      t.lo[k] *= 2;
      t.hi[k] *= 2;
    }
    t.top[0] *= 2;
    reduce_long<2 * NL + 1, 5>(l, o.c1, t);
    mul(l, o.c0, s, d);
  }

  // ---- G2 complete group law (fp381::g2_double / g2_add) -------------------

  static __device__ __noinline__ void g2_double(const L& l, P2& o,
                                                const P2& p) {
    E2 yy, yz, zz, xy, bzz, e8, s, d, t, u;
    f2_sqr(l, yy, p.y);
    f2_mul(l, yz, p.y, p.z);
    f2_sqr(l, zz, p.z);
    f2_mul(l, xy, p.x, p.y);
    f2_mul_b3(l, bzz, zz);
    f2_small(l, e8, yy, 8);
    f2_add(l, s, yy, bzz);
    f2_small(l, t, bzz, 3);
    f2_sub(l, d, yy, t);
    f2_mul(l, t, d, xy);
    f2_small(l, o.x, t, 2);
    f2_mul(l, t, bzz, e8);
    f2_mul(l, u, d, s);
    f2_add(l, o.y, t, u);
    f2_mul(l, o.z, yz, e8);
  }

  static __device__ __noinline__ void g2_add(const L& l, P2& o, const P2& p1,
                                             const P2& p2) {
    E2 t0, t1, t2, t3, t4, t5, a, b;
    f2_mul(l, t0, p1.x, p2.x);
    f2_mul(l, t1, p1.y, p2.y);
    f2_mul(l, t2, p1.z, p2.z);
    f2_add(l, a, p1.x, p1.y);
    f2_add(l, b, p2.x, p2.y);
    f2_mul(l, t3, a, b);
    f2_add(l, a, p1.y, p1.z);
    f2_add(l, b, p2.y, p2.z);
    f2_mul(l, t4, a, b);
    f2_add(l, a, p1.x, p1.z);
    f2_add(l, b, p2.x, p2.z);
    f2_mul(l, t5, a, b);
    f2_add(l, a, t0, t1);
    f2_sub(l, t3, t3, a);
    f2_add(l, a, t1, t2);
    f2_sub(l, t4, t4, a);
    f2_add(l, a, t0, t2);
    f2_sub(l, t5, t5, a);
    E2 m, bz, s, d, by;
    f2_small(l, m, t0, 3);
    f2_mul_b3(l, bz, t2);
    f2_add(l, s, t1, bz);
    f2_sub(l, d, t1, bz);
    f2_mul_b3(l, by, t5);
    f2_mul(l, a, t3, d);
    f2_mul(l, b, t4, by);
    f2_sub(l, o.x, a, b);
    f2_mul(l, a, d, s);
    f2_mul(l, b, m, by);
    f2_add(l, o.y, a, b);
    f2_mul(l, a, t4, s);
    f2_mul(l, b, t3, m);
    f2_add(l, o.z, a, b);
  }

  // ---- moving limbs ----------------------------------------------------------

  // this lane's block of a whole element `a` (32 limbs, any memory)
  static __device__ __forceinline__ void ld(const L& l, E& o, const int* a) {
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = a[B * l.q + t];
  }

  static __device__ __forceinline__ void st(const L& l, int* a, const E& x) {
#pragma unroll
    for (int t = 0; t < B; ++t) a[B * l.q + t] = x.v[t];
  }

  // an Fp2 as c0 at p, c1 at p + 32
  static __device__ __forceinline__ void ld2(const L& l, E2& o,
                                             const int* p) {
    ld(l, o.c0, p);
    ld(l, o.c1, p + NL);
  }

  static __device__ __forceinline__ void st2(const L& l, int* p,
                                             const E2& x) {
    st(l, p, x.c0);
    st(l, p + NL, x.c1);
  }

  // limbs of row r of a [32, stride] plane
  static __device__ __forceinline__ void ld_plane(const L& l, E& o,
                                                  const int* plane, int r,
                                                  int stride) {
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = plane[(size_t)(B * l.q + t) * stride + r];
  }

  static __device__ __forceinline__ void st_plane(const L& l, int* plane,
                                                  const E& x, int r,
                                                  int stride) {
#pragma unroll
    for (int t = 0; t < B; ++t) plane[(size_t)(B * l.q + t) * stride + r] = x.v[t];
  }

  // the constant with limb i = (i == 0 ? one : 0)
  static __device__ __forceinline__ void set_small(const L& l, E& o,
                                                   int one) {
#pragma unroll
    for (int t = 0; t < B; ++t) o.v[t] = (B * l.q + t == 0) ? one : 0;
  }
};

}  // namespace fpl
