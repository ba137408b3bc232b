// f12_warp.cuh — one Fp12 product on one warp: the 18 Fp2 products of
// fp381::f12_mul (its three Toom Fp6 products) one per lane, operands and
// results in shared memory, `__syncwarp()` between the operand, product
// and combination stages, each stage one instruction stream for all its
// lanes (operands chosen by pointer, not by branch).  Every product and
// sum is the same fp381.cuh function on the same inputs as the sequential
// tower, so the split cannot change a bit.  Kernel K14 (fold.cu) runs
// it; K11 (final_exp.cu) splits the same stages over groups of lanes.

#pragma once

#include "fp381.cuh"

namespace f12w {

using fp381::F12;
using fp381::F2;
using fp381::F6;

// A warp's shared-memory working set for one product (8.25 KB).
struct Ws {
  F6 opd[2];     // the Fp6 operands a stage computes
  F2 prod[18];   // Fp2 products, one per lane
  F2 f6r[9];     // the Fp6 products' coefficients
};

// K Toom-style Fp6 products a[k]·b[k] (fp381::f6_mul), written to
// f6r[3k .. 3k + 2]: 6K product lanes, then 3K combination lanes.
static __device__ void w_f6_products(Ws& s, int lane, int K,
                                     const F6* const* a,
                                     const F6* const* b) {
  if (lane < 6 * K) {
    const int k = lane / 6, p = lane % 6;
    F2 x, y;
    const F2 *xp, *yp;
    if (p < 3) {
      xp = &a[k]->c[p];
      yp = &b[k]->c[p];
    } else {
      // p = 3: (1, 2); p = 4: (0, 1); p = 5: (0, 2)
      const int i = p == 3 ? 1 : 0, j = p == 4 ? 1 : 2;
      fp381::f2_add_n(x, a[k]->c[i], a[k]->c[j]);
      fp381::f2_add_n(y, b[k]->c[i], b[k]->c[j]);
      xp = &x;
      yp = &y;
    }
    fp381::f2_mul(s.prod[lane], *xp, *yp);
  }
  __syncwarp();
  if (lane < 3 * K) {
    // coefficient i of product k, every lane on the same instructions:
    //   i = 0: v0 + ξ·(v3 − (v1 + v2))
    //   i = 1: (v4 − (v0 + v1)) + ξ·v2
    //   i = 2: (v5 − (v0 + v2)) + v1
    // (lane i = 2 computes a ξ·v2 it does not use)
    const int k = lane / 3, i = lane % 3;
    const F2* v = &s.prod[6 * k];
    F2 u, t, m;
    fp381::f2_add_n(u, v[i == 0 ? 1 : 0], v[i == 1 ? 1 : 2]);
    fp381::f2_sub_n(t, v[3 + i], u);
    fp381::f2_mul_xi(m, i == 0 ? t : v[2]);
    fp381::f2_add_n(s.f6r[lane], i == 0 ? v[0] : t, i == 2 ? v[1] : m);
  }
  __syncwarp();
}

// o = f·g (fp381::f12_mul); o may alias f or g
static __device__ void w_mul(Ws& s, int lane, F12& o, const F12& f,
                             const F12& g) {
  if (lane < 6) {                       // f0 + f1 (lanes 0–2), g0 + g1
    const F12& a = lane < 3 ? f : g;
    const int i = lane % 3;
    fp381::f2_add_n(s.opd[lane / 3].c[i], a.c[0].c[i], a.c[1].c[i]);
  }
  __syncwarp();
  const F6* a[3] = {&f.c[0], &f.c[1], &s.opd[0]};
  const F6* b[3] = {&g.c[0], &g.c[1], &s.opd[1]};
  w_f6_products(s, lane, 3, a, b);     // aa, bb, cross
  if (lane < 6) {
    const int i = lane % 3;
    const F2* aa = &s.f6r[0];
    const F2* bb = &s.f6r[3];
    F2 w, t;
    fp381::f2_mul_xi(w, bb[2]);
    fp381::f2_add_n(t, aa[i], bb[i]);
    if (lane < 3) {                     // aa + v·bb
      fp381::f2_add_n(o.c[0].c[i], aa[i], i == 0 ? w : bb[i - 1]);
    } else {                            // cross − (aa + bb)
      fp381::f2_sub_n(o.c[1].c[i], s.f6r[6 + i], t);
    }
  }
  __syncwarp();
}

}  // namespace f12w
