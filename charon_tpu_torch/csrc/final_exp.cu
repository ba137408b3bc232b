// final_exp.cu — kernel K11: the whole final exponentiation
// f ↦ f^(3·(p¹²−1)/r) of an Fp12 row in ONE launch, one warp per row.
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
// is cyclotomic, so the inverse is the conjugate).  f⁻¹ is tower.f12_inv's
// formula, its Fp inverse the fixed pow p − 2, LSB first.
//
// Layout: [12, 32, R] int32 planes in and out (plane m = (k·3 + j)·2 + c),
// the ops/pairing.py Fp12 [2, 3, 2, 32, R] with no copy; on request a
// verdict byte a row, the result = 1 (`pairing.is_one`), which the batch
// check and the re-check read.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] (chip_smoke.py's OPS table, final_exp_ops): a squaring
// is the K5 SQR, [91,392, 108,042], a product the K5 F12MUL, [133,344,
// 152,494]; a row does 316 squarings, 34 products, 5 Frobenius maps (7 Fp2
// products each), 9 conjugations and one inverse (its pow p − 2: 380
// squarings and 229 products in Fp, [1,461,600, 825,804]): [35,375,872,
// 40,642,194] per row.  At the card's full rate, max(IMAD / 64, all /
// 128) clocks over 132 SMs at 1.98 GHz, that is 0.0023 ms at R = 1 and
// 4.65 ms at R = 2,048.  This design keeps a row on one warp, so at R = 1
// it occupies ONE SM and cannot beat that SM's rate: 0.300 ms (the
// `bound_one_warp_ms` of chip_smoke.py).  The function does not force
// that: an Fp12 step's 12–18 Fp2 products could spread over the SMs of a
// thread-block cluster.  The count is also high for the function: it
// charges each ^z squaring as a full K5 squaring, where the cyclotomic
// (Granger–Scott) squaring needs far fewer products.  Device memory sees
// 3 KB per row.
//
// What the design does about it, and what it does not yet: one warp per
// row.  The 12 Fp2 products of a squaring (its two Toom Fp6 products) and
// the 18 of a product (three) are independent: one lane each, operands and
// results in shared memory, `__syncwarp()` between the operand, product
// and combination stages, and each stage one instruction stream for all
// its lanes (operands chosen by pointer, not by branch; the product,
// `w_mul`, is csrc/f12_warp.cuh, which K14 shares).  Every product and
// sum is the same fp381.cuh function on the same inputs as the sequential
// K5 tower, so the split cannot change a bit.  One warp alone on an SM
// runs the unrolled field code at a small fraction of the schedulers'
// rate (the K5 kernels, a warp per SM, show ~0.15 instructions per clock),
// so the critical path of ~1 Fp2 product and ~4 sums per Fp12 op is what
// the row costs; the inverse's 609 dependent Fp products run on lane 0.
// Not yet: the cyclotomic squaring (Granger–Scott) for the 315 squarings
// of the ^z chains, several lanes per Fp2 product (its three convolutions,
// its two reductions), the inverse spread over the warp, and more than one
// warp per row.  Measured times: PERF.md.

#include "f12_warp.cuh"
#include "fp_inv.cuh"

namespace {

using fp381::F12;
using fp381::F2;
using fp381::F6;
using fp381::NL;
using fp381::fp_inv;
using f12w::Ws;
using f12w::w_f6_products;
using f12w::w_mul;

constexpr int WARP = 32;

__device__ __forceinline__ void fe_const(F2& o, int k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    o.c0[i] = fp381::FE_G[2 * k][i];
    o.c1[i] = fp381::FE_G[2 * k + 1][i];
  }
}

// o = f² (fp381::f12_sqr); o may alias f
__device__ void w_sqr(Ws& s, int lane, F12& o, const F12& f) {
  if (lane < 6) {
    // s = f0 + f1 (lanes 0–2), u = f0 + v·f1 (lanes 3–5)
    const int i = lane % 3;
    F2 t;
    fp381::f2_mul_xi(t, f.c[1].c[2]);
    const F2& b = lane < 3 ? f.c[1].c[i] : i == 0 ? t : f.c[1].c[i - 1];
    fp381::f2_add_n(s.opd[lane / 3].c[i], f.c[0].c[i], b);
  }
  __syncwarp();
  const F6* a[2] = {&f.c[0], &s.opd[0]};
  const F6* b[2] = {&f.c[1], &s.opd[1]};
  w_f6_products(s, lane, 2, a, b);     // v0 = f6r[0..2], t = f6r[3..5]
  const int i = lane % 3;
  const F2* v0 = &s.f6r[0];
  if (lane < 3) {                       // (t − v0) − v·v0
    F2 d, e;
    fp381::f2_sub_n(d, s.f6r[3 + i], v0[i]);
    fp381::f2_mul_xi(e, v0[2]);
    fp381::f2_sub_n(o.c[0].c[i], d, i == 0 ? e : v0[i - 1]);
  } else if (lane < 6) {                // 2·v0
    fp381::f2_small_n(o.c[1].c[i], v0[i], 2);
  }
  __syncwarp();
}

// o = conj(f) = (f0, −f1), one Fp element per lane; o may alias f
__device__ void w_conj(int lane, F12& o, const F12& f) {
  if (lane < 12) {
    const int* a = reinterpret_cast<const int*>(&f) + lane * NL;
    int* r = reinterpret_cast<int*>(&o) + lane * NL;
    if (lane < 6) {
      fp381::copy(r, a);
    } else {
      fp381::neg(r, a);
    }
  }
  __syncwarp();
}

// o = f^p, one Fp2 coefficient (k, j) per lane: conj(x)·γ_j (j > 0), then
// ·γw for k = 1 (tower.f12_frob); o may alias f
__device__ void w_frob(int lane, F12& o, const F12& f) {
  if (lane < 6) {
    const int k = lane / 3, j = lane % 3;
    const F2& x = f.c[k].c[j];
    F2 y, g;
    fp381::copy(y.c0, x.c0);
    fp381::neg(y.c1, x.c1);
    if (j) {
      fe_const(g, j - 1);
      fp381::f2_mul(y, y, g);
    }
    if (k) {
      fe_const(g, 2);
      fp381::f2_mul(y, y, g);
    }
    o.c[k].c[j] = y;
  }
  __syncwarp();
}

// o = g^z: the bits of |z| below the leading one, MSB first, then conj.
// o must not alias g.
__device__ void w_exp_z(Ws& s, int lane, F12& o, const F12& g) {
  w_sqr(s, lane, o, g);
  if ((fp381::ABS_Z >> 62) & 1) w_mul(s, lane, o, o, g);
#pragma unroll 1
  for (int i = 61; i >= 0; --i) {
    w_sqr(s, lane, o, o);
    if ((fp381::ABS_Z >> i) & 1) w_mul(s, lane, o, o, g);
  }
  w_conj(lane, o, o);
}

// ---- the inverse (one lane; sequential fp381 functions; its Fp inverse
// fp_inv, LSB first, is csrc/fp_inv.cuh's) ----------------------------------

__device__ __noinline__ void f2_inv(F2& o, const F2& a) {
  int s0[NL], s1[NL], n[NL], t0[NL], t1[NL];
  fp381::mul_n(s0, a.c0, a.c0);
  fp381::mul_n(s1, a.c1, a.c1);
  fp381::add(n, s0, s1);
  fp_inv(n, n);
  fp381::mul_n(t0, a.c0, n);
  fp381::mul_n(t1, a.c1, n);
  fp381::copy(o.c0, t0);
  fp381::neg(o.c1, t1);
}

__device__ __noinline__ void f6_inv(F6& o, const F6& a) {
  F2 s0, s1, s2, p12, p01, p02, A, B, C, t, u, fa, fb, fc;
  fp381::f2_mul(s0, a.c[0], a.c[0]);
  fp381::f2_mul(s1, a.c[1], a.c[1]);
  fp381::f2_mul(s2, a.c[2], a.c[2]);
  fp381::f2_mul(p12, a.c[1], a.c[2]);
  fp381::f2_mul(p01, a.c[0], a.c[1]);
  fp381::f2_mul(p02, a.c[0], a.c[2]);
  fp381::f2_mul_xi(t, p12);
  fp381::f2_sub_n(A, s0, t);
  fp381::f2_mul_xi(t, s2);
  fp381::f2_sub_n(B, t, p01);
  fp381::f2_sub_n(C, s1, p02);
  fp381::f2_mul(fa, a.c[0], A);
  fp381::f2_mul(fb, a.c[2], B);
  fp381::f2_mul(fc, a.c[1], C);
  fp381::f2_add_n(t, fb, fc);
  fp381::f2_mul_xi(u, t);
  fp381::f2_add_n(t, fa, u);
  f2_inv(t, t);
  fp381::f2_mul(o.c[0], A, t);
  fp381::f2_mul(o.c[1], B, t);
  fp381::f2_mul(o.c[2], C, t);
}

// o = f⁻¹ (tower.f12_inv's formula); o must not alias f
__device__ __noinline__ void f12_inv(F12& o, const F12& f) {
  F6 s0, s1, u, t;
  fp381::f6_mul(s0, f.c[0], f.c[0]);
  fp381::f6_mul(s1, f.c[1], f.c[1]);
  fp381::f6_mul_by_v(u, s1);
  fp381::f6_sub(u, s0, u);
  f6_inv(t, u);
  fp381::f6_mul(o.c[0], f.c[0], t);
  fp381::f6_mul(o.c[1], f.c[1], t);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    fp381::neg(o.c[1].c[i].c0, o.c[1].c[i].c0);
    fp381::neg(o.c[1].c[i].c1, o.c[1].c[i].c1);
  }
}

// ---- the kernel ------------------------------------------------------------

__global__ void __launch_bounds__(WARP)
final_exp_kernel(int* __restrict__ out, unsigned char* __restrict__ verdict,
                 const int* __restrict__ in, int n) {
  // one warp's working set in shared memory (15.75 KB): the Fp12 values
  // x, t2, acc, base, tmp, then a product's
  __shared__ struct {
    F12 slot[5];
    Ws w;
  } sh;
  Ws& s = sh.w;
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  F12& x = sh.slot[0];
  F12* t2 = &sh.slot[1];
  F12* acc = &sh.slot[2];
  F12* base = &sh.slot[3];
  F12& tmp = sh.slot[4];
  {
    int* e = reinterpret_cast<int*>(&x);
#pragma unroll 1
    for (int i = lane; i < 12 * NL; i += WARP) e[i] = in[(size_t)i * n + r];
  }
  __syncwarp();
  // easy part: x = conj(x)·x⁻¹, then x = frob²(x)·x
  if (lane == 0) f12_inv(tmp, x);
  __syncwarp();
  w_conj(lane, *acc, x);
  w_mul(s, lane, x, *acc, tmp);
  w_frob(lane, *acc, x);
  w_frob(lane, *acc, *acc);
  w_mul(s, lane, x, *acc, x);
  // hard part
  w_exp_z(s, lane, *acc, x);           // t0 = x^z · conj(x)
  w_conj(lane, tmp, x);
  w_mul(s, lane, *acc, *acc, tmp);
  F12* sw = base;
  base = acc;
  acc = sw;
  w_exp_z(s, lane, *acc, *base);       // t1 = t0^z · conj(t0)
  w_conj(lane, tmp, *base);
  w_mul(s, lane, *acc, *acc, tmp);
  sw = base;
  base = acc;
  acc = sw;
  w_exp_z(s, lane, *acc, *base);       // t2 = t1^z · frob(t1)
  w_frob(lane, tmp, *base);
  w_mul(s, lane, *t2, *acc, tmp);
  w_exp_z(s, lane, *base, *t2);        // t3 = (t2^z)^z
  w_exp_z(s, lane, *acc, *base);
  w_frob(lane, tmp, *t2);              // t5 = t3 · frob²(t2) · conj(t2)
  w_frob(lane, tmp, tmp);
  w_mul(s, lane, *acc, *acc, tmp);
  w_conj(lane, tmp, *t2);
  w_mul(s, lane, *acc, *acc, tmp);
  w_sqr(s, lane, tmp, x);              // x³
  w_mul(s, lane, tmp, tmp, x);
  w_mul(s, lane, *acc, *acc, tmp);     // t5 · x³
  {
    const int* e = reinterpret_cast<const int*>(acc);
#pragma unroll 1
    for (int i = lane; i < 12 * NL; i += WARP) out[(size_t)i * n + r] = e[i];
  }
  if (verdict) {
    // "f = 1" (pairing.is_one): lane m < 12 tests coefficient m of f − 1
    // (fp381 sub, then the exact zero test); the warp ANDs the twelve
    int one = 1;
    if (lane < 12) {
      int c[NL], d[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) c[i] = lane == 0 && i == 0;
      fp381::sub(d, reinterpret_cast<const int*>(acc) + lane * NL, c);
      one = fp381::is_zero(d);
    }
    one = __all_sync(0xffffffffu, one);
    if (lane == 0) verdict[r] = (unsigned char)one;
  }
}

}  // namespace

// out, in: [12, 32, n] int32; verdict: [n] uint8, each row's "= 1", or
// nullptr.  Returns the cudaError of the launch.
extern "C" int charon_final_exp(void* out, const void* in, void* verdict,
                                int n, void* stream) {
  final_exp_kernel<<<n, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<unsigned char*>(verdict),
      static_cast<const int*>(in), n);
  return (int)cudaGetLastError();
}
