// final_exp.cu — kernel K11: the whole final exponentiation
// f ↦ f^(3·(p¹²−1)/r) of an Fp12 row in ONE launch, a row on a block of
// THREADS threads: NG groups of G lanes, each group one Fp2 operation at a
// time on the csrc/fp_lanes.cuh library.
//
// Replaces: the K1 chain of pairing.final_exponentiate (the JAX package's
// charon_tpu/ops/pairing.py final_exponentiate, one jitted program whose
// field ops reach charon_tpu/ops/pallas_fp.py `_mul_kernel` :78,
// `_add_kernel` :97, `_sub_kernel` :104, `_neg_kernel` :112 and
// `_small_kernel_factory` :120).  Eagerly, that chain is 7,914 dependent K1
// launches per call, each on one row with ~130 µs of host glue.
//
// What it computes (ops/cuda_final_exp.py has the same sequence in plain
// PyTorch): the easy part conj(f)·f⁻¹ then frob²(f)·f; the hard part
// t0 = f^z·conj(f), t1 = t0^z·conj(t0), t2 = t1^z·frob(t1), t3 = (t2^z)^z,
// t5 = t3·frob²(t2)·conj(t2), and t5·f²·f.  Each ^z is 63 squarings and 5
// products over the bits of |z|, then a conjugation (z < 0; the argument
// is cyclotomic, so the inverse is the conjugate).  The squarings of the
// ^z chains are Granger–Scott's cyclotomic squaring (pairing.py leaves it
// as a future optimisation): after the easy part every value lies in the
// cyclotomic subgroup, where f² = (3A0² − 2Ā0) + (3s·A2² + 2Ā1)·w +
// (3A1² − 2Ā2)·w² over the Fp4 pairs A0 = (f00, f11), A1 = (f10, f02), A2
// = (f01, f12) (s = w³, Ā the Fp4 conjugate): nine Fp2 squarings, where
// the tower's squaring takes twelve Fp2 products.  f² of the last line is
// the tower's squaring.  f⁻¹ is tower.f12_inv's formula, its Fp inverse the
// fixed pow p − 2 by 4-bit windows (fp_inv.cuh's fp_inv_w4 schedule).
//
// Layout: [12, 32, R] int32 planes in and out (plane m = (k·3 + j)·2 + c),
// the ops/pairing.py Fp12 [2, 3, 2, 32, R] with no copy; on request a
// verdict byte a row, the result = 1 (`pairing.is_one`), which the batch
// check and the re-check read.
//
// What bounds it on an H100: int32 instructions.  The fewest known for the
// function, counted from fp381.cuh as [IMAD, other] (chip_smoke.py's
// final_exp_design_ops: the ^z squarings cyclotomic, the inverse's pow by
// 4-bit windows — what this design executes, less the lane split's zero
// terms and shuffles): [24,161,632, 27,523,140] a row, 0.0015 ms at R = 1
// and 3.17 ms at R = 2,048 at the card's full rate, 0.20 ms at R = 1 on
// the one SM a row's block runs on.  The first version's sequence, with
// the tower's squarings and a square-and-multiply pow (final_exp_ops),
// is [35,375,872, 40,642,194] a row: 0.0023 and 4.65 ms.  At R = 1 the
// time is the critical path: a row is one block on one SM.
//
// What the design does about it.  The first version ran a row on one warp,
// each Fp2 product of an Fp12 operation whole on one lane, and the
// inverse's 609 Fp products on lane 0 (27.9 ms at R = 1, 93× its one-warp
// bound).  Here every Fp2 operation runs on a group of G lanes, so the
// critical path of an Fp12 operation is one G-lane Fp2 operation per stage;
// the cyclotomic squaring cuts the 315 ^z squarings to two stages of
// nine squarings and six combinations; the inverse's Fp products run on
// group 0's G lanes.  Values live in shared memory as Fp2 pairs (65 words:
// the groups of a warp read different banks), a stage's tasks go to the
// groups in turn, and __syncthreads() separates the stages.  Every product
// and sum is the fp381.cuh function on the same inputs as the plain
// version's, so the kernel is bit-identical to it.  Not yet: the inverse's
// Fp6 products on several groups (they run on group 0 after one another),
// the combination stages at Fp rather than Fp2 granularity, and a
// thread-block cluster (one SM runs a row).  On the H100 (PERF.md row
// 25): 4.4 ms at R = 1 and 31.4 ms at R = 2,048, against the first
// version's 27.9 and 123.0 in the same call.

#include "fp_lanes.cuh"
#include "attrs.cuh"

namespace {

using fp381::NL;

constexpr int THREADS = 96;        // a row's block
constexpr int PW = 2 * NL + 1;     // an Fp2 slot: c0, c1, one pad word

// slots (Fp2 values) of a row's shared memory
enum {
  X = 0, T2 = 6, ACC = 12, BASE = 18, TMP = 24, PROD = 30, OPD = 48,
  F6R = 54, SQ = 63, NSLOT = 72
};

struct Smem {
  fpl::Consts k;
  int v[NSLOT][PW];
  int inv_tbl[15][NL];
};

template <int G>
struct K11 {
  using A = fpl::F<G>;
  using L = fpl::Lane<G>;
  using E = typename A::E;
  using E2 = typename A::E2;
  static constexpr int B = A::B;
  static constexpr int NG = THREADS / G;

  struct E6 {
    E2 c[3];
  };

  // ---- the block's stages ----------------------------------------------------

  static __device__ __forceinline__ void ld(const L& l, const Smem& s, E2& o,
                                            int slot) {
    A::ld2(l, o, s.v[slot]);
  }

  static __device__ __forceinline__ void st(const L& l, Smem& s, int slot,
                                            const E2& x) {
    A::st2(l, s.v[slot], x);
  }

  static __device__ __forceinline__ void fe(const L& l, E2& o, int k) {
#pragma unroll
    for (int t = 0; t < B; ++t) {
      o.c0.v[t] = fp381::FE_G[2 * k][B * l.q + t];
      o.c1.v[t] = fp381::FE_G[2 * k + 1][B * l.q + t];
    }
  }

  // o = conj(f) = (f0, −f1); o may alias f
  static __device__ void conj(const L& l, Smem& s, int grp, int o, int f) {
    for (int m = grp; m < 6; m += NG) {
      E2 x;
      ld(l, s, x, f + m);
      if (m >= 3) A::f2_neg(l, x, x);
      st(l, s, o + m, x);
    }
    __syncthreads();
  }

  // o = f^p, coefficient (k, j) by task k·3 + j: conj(x)·γ_j (j > 0), then
  // ·γw for k = 1 (tower.f12_frob); o may alias f
  static __device__ void frob(const L& l, Smem& s, int grp, int o, int f) {
    for (int m = grp; m < 6; m += NG) {
      const int k = m / 3, j = m % 3;
      E2 x, y, g;
      ld(l, s, x, f + m);
      y.c0 = x.c0;
      A::neg(l, y.c1, x.c1);
      if (j) {
        fe(l, g, j - 1);
        A::f2_mul(l, y, y, g);
      }
      if (k) {
        fe(l, g, 2);
        A::f2_mul(l, y, y, g);
      }
      st(l, s, o + m, y);
    }
    __syncthreads();
  }

  // K Toom-style Fp6 products a[k]·b[k] (fp381::f6_mul), into F6R[3k..]:
  // 6K product tasks, then 3K combination tasks (f12_warp.cuh's split)
  static __device__ void f6_products(const L& l, Smem& s, int grp, int K,
                                     const int* a, const int* b) {
    for (int task = grp; task < 6 * K; task += NG) {
      const int k = task / 6, p = task % 6;
      E2 x, y;
      if (p < 3) {
        ld(l, s, x, a[k] + p);
        ld(l, s, y, b[k] + p);
      } else {
        // p = 3: (1, 2); p = 4: (0, 1); p = 5: (0, 2)
        const int i = p == 3 ? 1 : 0, j = p == 4 ? 1 : 2;
        E2 u, v;
        ld(l, s, u, a[k] + i);
        ld(l, s, v, a[k] + j);
        A::f2_add(l, x, u, v);
        ld(l, s, u, b[k] + i);
        ld(l, s, v, b[k] + j);
        A::f2_add(l, y, u, v);
      }
      A::f2_mul(l, x, x, y);
      st(l, s, PROD + task, x);
    }
    __syncthreads();
    for (int task = grp; task < 3 * K; task += NG) {
      //   i = 0: v0 + ξ·(v3 − (v1 + v2))
      //   i = 1: (v4 − (v0 + v1)) + ξ·v2
      //   i = 2: (v5 − (v0 + v2)) + v1
      const int k = task / 3, i = task % 3;
      const int v = PROD + 6 * k;
      E2 p, q, u, t, m;
      ld(l, s, p, v + (i == 0 ? 1 : 0));
      ld(l, s, q, v + (i == 1 ? 1 : 2));
      A::f2_add(l, u, p, q);
      ld(l, s, p, v + 3 + i);
      A::f2_sub(l, t, p, u);
      if (i == 0) {
        A::f2_mul_xi(l, m, t);
        ld(l, s, p, v);
        A::f2_add(l, m, p, m);
      } else if (i == 1) {
        ld(l, s, p, v + 2);
        A::f2_mul_xi(l, m, p);
        A::f2_add(l, m, t, m);
      } else {
        ld(l, s, p, v + 1);
        A::f2_add(l, m, t, p);
      }
      st(l, s, F6R + task, m);
    }
    __syncthreads();
  }

  // o = f·g (fp381::f12_mul as f12_warp.cuh's w_mul splits it); o may
  // alias f or g
  static __device__ void mul(const L& l, Smem& s, int grp, int o, int f,
                             int g) {
    for (int task = grp; task < 6; task += NG) {   // f0 + f1, g0 + g1
      const int a = task < 3 ? f : g, i = task % 3;
      E2 x, y;
      ld(l, s, x, a + i);
      ld(l, s, y, a + 3 + i);
      A::f2_add(l, x, x, y);
      st(l, s, OPD + task, x);
    }
    __syncthreads();
    const int a[3] = {f, f + 3, OPD};
    const int b[3] = {g, g + 3, OPD + 3};
    f6_products(l, s, grp, 3, a, b);              // aa, bb, cross
    for (int task = grp; task < 6; task += NG) {
      const int i = task % 3;
      E2 x, y, w;
      if (task < 3) {                               // aa + v·bb
        ld(l, s, x, F6R + i);
        if (i == 0) {
          ld(l, s, y, F6R + 5);
          A::f2_mul_xi(l, w, y);
        } else {
          ld(l, s, w, F6R + 3 + i - 1);
        }
        A::f2_add(l, x, x, w);
        st(l, s, o + i, x);
      } else {                                      // cross − (aa + bb)
        ld(l, s, x, F6R + i);
        ld(l, s, y, F6R + 3 + i);
        A::f2_add(l, w, x, y);
        ld(l, s, x, F6R + 6 + i);
        A::f2_sub(l, x, x, w);
        st(l, s, o + 3 + i, x);
      }
    }
    __syncthreads();
  }

  // o = f² (fp381::f12_sqr as final_exp's w_sqr splits it); o may alias f
  static __device__ void sqr(const L& l, Smem& s, int grp, int o, int f) {
    for (int task = grp; task < 6; task += NG) {
      // s = f0 + f1 (tasks 0–2), u = f0 + v·f1 (tasks 3–5)
      const int i = task % 3;
      E2 x, y;
      ld(l, s, x, f + i);
      if (task >= 3 && i == 0) {
        ld(l, s, y, f + 5);
        A::f2_mul_xi(l, y, y);
      } else {
        ld(l, s, y, f + 3 + (task < 3 ? i : i - 1));
      }
      A::f2_add(l, x, x, y);
      st(l, s, OPD + task, x);
    }
    __syncthreads();
    const int a[2] = {f, OPD};
    const int b[2] = {f + 3, OPD + 3};
    f6_products(l, s, grp, 2, a, b);              // v0 = F6R[0..2], t
    for (int task = grp; task < 6; task += NG) {
      const int i = task % 3;
      E2 x, y, d;
      if (task < 3) {                               // (t − v0) − v·v0
        ld(l, s, x, F6R + 3 + i);
        ld(l, s, y, F6R + i);
        A::f2_sub(l, d, x, y);
        if (i == 0) {
          ld(l, s, y, F6R + 2);
          A::f2_mul_xi(l, y, y);
        } else {
          ld(l, s, y, F6R + i - 1);
        }
        A::f2_sub(l, d, d, y);
        st(l, s, o + i, d);
      } else {                                      // 2·v0
        ld(l, s, x, F6R + i);
        A::f2_small(l, x, x, 2);
        st(l, s, o + 3 + i, x);
      }
    }
    __syncthreads();
  }

  // o = f² for f in the cyclotomic subgroup (Granger–Scott); o may alias f.
  // Pair k = (a0, a1): S0 = a0², S1 = a1², S2 = (a0 + a1)², R = S0 + ξ·S1,
  // I = S2 − (S0 + S1); coefficient m gets 3X ∓ 2·f_m with X one of them.
  static __device__ void cyc_sqr(const L& l, Smem& s, int grp, int o,
                                 int f) {
    for (int task = grp; task < 9; task += NG) {
      const int k = task / 3, which = task % 3;
      const int a0 = k == 0 ? 0 : k == 1 ? 3 : 1;
      const int a1 = k == 0 ? 4 : k == 1 ? 2 : 5;
      E2 x, y;
      ld(l, s, x, f + (which == 1 ? a1 : a0));
      if (which == 2) {
        ld(l, s, y, f + a1);
        A::f2_add(l, x, x, y);
      }
      A::f2_sqr(l, x, x);
      st(l, s, SQ + task, x);
    }
    __syncthreads();
    for (int m = grp; m < 6; m += NG) {
      // m: (pair, R or I, ∓): 0 (0, R, −), 4 (0, I, +), 1 (1, R, −),
      // 5 (1, I, +), 2 (2, R, −), 3 (2, ξ·I, +)
      const int k = m == 0 || m == 4 ? 0 : m == 1 || m == 5 ? 1 : 2;
      E2 s0, s1, x, a;
      ld(l, s, s0, SQ + 3 * k);
      ld(l, s, s1, SQ + 3 * k + 1);
      if (m <= 2) {                                 // R
        A::f2_mul_xi(l, s1, s1);
        A::f2_add(l, x, s0, s1);
      } else {                                      // I (ξ·I for m = 3)
        A::f2_add(l, s0, s0, s1);
        ld(l, s, s1, SQ + 3 * k + 2);
        A::f2_sub(l, x, s1, s0);
        if (m == 3) A::f2_mul_xi(l, x, x);
      }
      ld(l, s, a, f + m);
      if (m <= 2) {
        A::f2_sub(l, a, x, a);
      } else {
        A::f2_add(l, a, x, a);
      }
      A::f2_small(l, a, a, 2);
      A::f2_add(l, a, a, x);
      st(l, s, o + m, a);
    }
    __syncthreads();
  }

  // o = g^z: the bits of |z| below the leading one, MSB first, the
  // squarings cyclotomic, then conj.  o must not alias g.
  static __device__ void exp_z(const L& l, Smem& s, int grp, int o, int g) {
    cyc_sqr(l, s, grp, o, g);
    if ((fp381::ABS_Z >> 62) & 1) mul(l, s, grp, o, o, g);
#pragma unroll 1
    for (int i = 61; i >= 0; --i) {
      cyc_sqr(l, s, grp, o, o);
      if ((fp381::ABS_Z >> i) & 1) mul(l, s, grp, o, o, g);
    }
    conj(l, s, grp, o, o);
  }

  // ---- the inverse, on one group (fp381's sequences) ------------------------

  // a^(p−2) by 4-bit windows, MSB first (fp_inv.cuh fp_inv_w4); the table
  // in shared memory; o may alias a
  static __device__ __noinline__ void fp_inv(const L& l, Smem& s, E& o,
                                             const E& a) {
    constexpr int NDIG = (fp381::EXP_PM2_BITS + 3) / 4;
    E t = a;
    A::st(l, s.inv_tbl[0], a);
    A::mul(l, t, a, a);
    A::st(l, s.inv_tbl[1], t);
#pragma unroll 1
    for (int k = 2; k < 15; ++k) {
      A::mul(l, t, t, a);
      A::st(l, s.inv_tbl[k], t);
    }
    E acc;
    A::ld(l, acc, s.inv_tbl[((fp381::EXP_PM2[(NDIG - 1) >> 3] >>
                              (((NDIG - 1) & 7) * 4)) & 15) - 1]);
#pragma unroll 1
    for (int k = NDIG - 2; k >= 0; --k) {
#pragma unroll 1
      for (int j = 0; j < 4; ++j) A::mul(l, acc, acc, acc);
      const int d = (fp381::EXP_PM2[k >> 3] >> ((k & 7) * 4)) & 15;
      if (d) {
        A::ld(l, t, s.inv_tbl[d - 1]);
        A::mul(l, acc, acc, t);
      }
    }
    o = acc;
  }

  static __device__ __noinline__ void f2_inv(const L& l, Smem& s, E2& o,
                                             const E2& a) {
    E s0, s1, n, t0, t1;
    A::mul(l, s0, a.c0, a.c0);
    A::mul(l, s1, a.c1, a.c1);
    A::add(l, n, s0, s1);
    fp_inv(l, s, n, n);
    A::mul(l, t0, a.c0, n);
    A::mul(l, t1, a.c1, n);
    o.c0 = t0;
    A::neg(l, o.c1, t1);
  }

  static __device__ __noinline__ void f6_mul(const L& l, E6& o, const E6& a,
                                             const E6& b) {
    E2 v0, v1, v2, x, y, t12, t01, t02, u;
    A::f2_mul(l, v0, a.c[0], b.c[0]);
    A::f2_mul(l, v1, a.c[1], b.c[1]);
    A::f2_mul(l, v2, a.c[2], b.c[2]);
    A::f2_add(l, x, a.c[1], a.c[2]);
    A::f2_add(l, y, b.c[1], b.c[2]);
    A::f2_mul(l, t12, x, y);
    A::f2_add(l, u, v1, v2);
    A::f2_sub(l, t12, t12, u);
    A::f2_add(l, x, a.c[0], a.c[1]);
    A::f2_add(l, y, b.c[0], b.c[1]);
    A::f2_mul(l, t01, x, y);
    A::f2_add(l, u, v0, v1);
    A::f2_sub(l, t01, t01, u);
    A::f2_add(l, x, a.c[0], a.c[2]);
    A::f2_add(l, y, b.c[0], b.c[2]);
    A::f2_mul(l, t02, x, y);
    A::f2_add(l, u, v0, v2);
    A::f2_sub(l, t02, t02, u);
    A::f2_mul_xi(l, u, t12);
    A::f2_add(l, o.c[0], v0, u);
    A::f2_mul_xi(l, u, v2);
    A::f2_add(l, o.c[1], t01, u);
    A::f2_add(l, o.c[2], t02, v1);
  }

  static __device__ __noinline__ void f6_inv(const L& l, Smem& s, E6& o,
                                             const E6& a) {
    E2 s0, s1, s2, p12, p01, p02, fa, fb, fc, t, u;
    E6 abc;
    A::f2_mul(l, s0, a.c[0], a.c[0]);
    A::f2_mul(l, s1, a.c[1], a.c[1]);
    A::f2_mul(l, s2, a.c[2], a.c[2]);
    A::f2_mul(l, p12, a.c[1], a.c[2]);
    A::f2_mul(l, p01, a.c[0], a.c[1]);
    A::f2_mul(l, p02, a.c[0], a.c[2]);
    A::f2_mul_xi(l, t, p12);
    A::f2_sub(l, abc.c[0], s0, t);
    A::f2_mul_xi(l, t, s2);
    A::f2_sub(l, abc.c[1], t, p01);
    A::f2_sub(l, abc.c[2], s1, p02);
    A::f2_mul(l, fa, a.c[0], abc.c[0]);
    A::f2_mul(l, fb, a.c[2], abc.c[1]);
    A::f2_mul(l, fc, a.c[1], abc.c[2]);
    A::f2_add(l, t, fb, fc);
    A::f2_mul_xi(l, u, t);
    A::f2_add(l, t, fa, u);
    f2_inv(l, s, t, t);
#pragma unroll 1
    for (int i = 0; i < 3; ++i) A::f2_mul(l, o.c[i], abc.c[i], t);
  }

  // TMP = X⁻¹ (tower.f12_inv's formula), on the group that calls it
  static __device__ __noinline__ void f12_inv(const L& l, Smem& s) {
    E6 f0, f1, s0, s1, u, t;
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      ld(l, s, f0.c[i], X + i);
      ld(l, s, f1.c[i], X + 3 + i);
    }
    f6_mul(l, s0, f0, f0);
    f6_mul(l, s1, f1, f1);
    A::f2_mul_xi(l, u.c[0], s1.c[2]);             // u = s0 − v·s1
    u.c[1] = s1.c[0];
    u.c[2] = s1.c[1];
#pragma unroll 1
    for (int i = 0; i < 3; ++i) A::f2_sub(l, u.c[i], s0.c[i], u.c[i]);
    f6_inv(l, s, t, u);
    f6_mul(l, s0, f0, t);
    f6_mul(l, s1, f1, t);
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      st(l, s, TMP + i, s0.c[i]);
      A::f2_neg(l, s1.c[i], s1.c[i]);
      st(l, s, TMP + 3 + i, s1.c[i]);
    }
  }
};

// ---- the kernel --------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(THREADS)
final_exp_kernel(int* __restrict__ out, unsigned char* __restrict__ verdict,
                 const int* __restrict__ in, int n) {
  using K = K11<G>;
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  fpl::load_consts(s.k, tid, THREADS);
#pragma unroll 1
  for (int i = tid; i < 12 * NL; i += THREADS) {
    const int plane = i / NL;
    s.v[X + plane / 2][(plane % 2) * NL + i % NL] = in[(size_t)i * n + r];
  }
  __syncthreads();
  const typename K::L l(tid, &s.k);
  const int grp = tid / G;
  // easy part: x = conj(x)·x⁻¹, then x = frob²(x)·x
  if (grp == 0) K::f12_inv(l, s);
  __syncthreads();
  K::conj(l, s, grp, ACC, X);
  K::mul(l, s, grp, X, ACC, TMP);
  K::frob(l, s, grp, ACC, X);
  K::frob(l, s, grp, ACC, ACC);
  K::mul(l, s, grp, X, ACC, X);
  // hard part
  int acc = ACC, base = BASE;
  K::exp_z(l, s, grp, acc, X);          // t0 = x^z · conj(x)
  K::conj(l, s, grp, TMP, X);
  K::mul(l, s, grp, acc, acc, TMP);
  int sw = base;
  base = acc;
  acc = sw;
  K::exp_z(l, s, grp, acc, base);       // t1 = t0^z · conj(t0)
  K::conj(l, s, grp, TMP, base);
  K::mul(l, s, grp, acc, acc, TMP);
  sw = base;
  base = acc;
  acc = sw;
  K::exp_z(l, s, grp, acc, base);       // t2 = t1^z · frob(t1)
  K::frob(l, s, grp, TMP, base);
  K::mul(l, s, grp, T2, acc, TMP);
  K::exp_z(l, s, grp, base, T2);        // t3 = (t2^z)^z
  K::exp_z(l, s, grp, acc, base);
  K::frob(l, s, grp, TMP, T2);          // t5 = t3 · frob²(t2) · conj(t2)
  K::frob(l, s, grp, TMP, TMP);
  K::mul(l, s, grp, acc, acc, TMP);
  K::conj(l, s, grp, TMP, T2);
  K::mul(l, s, grp, acc, acc, TMP);
  K::sqr(l, s, grp, TMP, X);            // x³
  K::mul(l, s, grp, TMP, TMP, X);
  K::mul(l, s, grp, acc, acc, TMP);     // t5 · x³
#pragma unroll 1
  for (int i = tid; i < 12 * NL; i += THREADS) {
    const int plane = i / NL;
    out[(size_t)i * n + r] = s.v[acc + plane / 2][(plane % 2) * NL + i % NL];
  }
  if (verdict && tid < 32) {
    // "f = 1" (pairing.is_one): thread e < 12 tests Fp coefficient e of
    // f − 1 (fp381 sub, then the exact zero test); the warp ANDs them
    int one = 1;
    if (tid < 12) {
      int c[NL], d[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) c[i] = tid == 0 && i == 0;
      fp381::sub(d, s.v[acc + tid / 2] + (tid % 2) * NL, c);
      one = fp381::is_zero(d);
    }
    one = __all_sync(0xffffffffu, one);
    if (tid == 0) verdict[r] = (unsigned char)one;
  }
}

}  // namespace

// out, in: [12, 32, n] int32; verdict: [n] uint8, each row's "= 1", or
// nullptr.  Returns the cudaError of the launch.
extern "C" int charon_final_exp(void* out, const void* in, void* verdict,
                                int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  final_exp_kernel<8><<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<unsigned char*>(verdict),
      static_cast<const int*>(in), n);
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_final_exp_attrs(int i, int threads, int smem,
                                      long long* out) {
  const void* const fns[] = {
      (const void*)final_exp_kernel<8>  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
