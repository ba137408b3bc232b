// decompress.cu — kernel K12: the whole G2 point decompression of a batch
// in ONE launch, one thread per row.
//
// Replaces: the K1 chain of codec.g2_decompress (the JAX package's
// charon_tpu/ops/codec.py g2_decompress, whose field ops reach
// charon_tpu/ops/pallas_fp.py `_mul_kernel` :78, `_add_kernel` :97,
// `_sub_kernel` :104, `_neg_kernel` :112 and `_small_kernel_factory`
// :120).  Eagerly, that chain is 7,467 K1 launches per batch: 2,048
// signatures per verify tile, 71,680 per 10,000 × 7 combine.
//
// What it computes per row (ops/cuda_codec.py has the same sequence in
// plain PyTorch): rhs = x³ + b'; the Fp2 square root of Alg. 9 (codec.
// f2_sqrt): a1 = rhs^((p−3)/4), α = a1²·rhs, x0 = a1·rhs, the root u·x0
// where α = −1 and (α + 1)^((p−1)/2)·x0 elsewhere, ok = (root² == rhs);
// the ZCash sign of the canonical root and the flip; from_affine with the
// ∞ flag; and the subgroup check ψ(Q) == [z]Q: [|z|]Q by curve.scalar_mul's
// 2-bit windows over the 64 bits of |z| (tables Q, 2Q, 3Q; the additions
// of zero windows left out and the top window's entry as the start, the
// same group element), negated for z < 0, against ψ(Q) = (c_x·X̄, c_y·Ȳ,
// Z̄) by the projective equality.  Pows are LSB first, their squarings
// f2_sqr; the group law is the complete RCB doubling and addition of K2.
//
// Layout: x as two std-form limb planes [32, R] int32 (c0, c1), sign and
// inf flags [R] uint8 (torch.bool); out [6, 32, R] int32 (the projective
// points [3, 2, 32, R]) and ok [R] uint8.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] per row (chip_smoke.py's OPS table, decompress_ops):
// the two pows are 757 Fp2 squarings [5,152, 4,020] and 457 products
// [6,400, 5,320], [6,824,864, 5,474,380]; the rest of a valid row — x³,
// the root's check, the exact canonicalisations, and the ψ check's 63 G2
// doublings [51,616, 48,034], 5 additions [83,392, 83,458] and 6 Fp2
// products — [3,750,816, 3,527,808]: [10,575,680, 9,002,188] per valid
// row, less where the root fails (no ψ check) or a point is ∞.  A row
// needs max(IMAD / 64, all / 128) SM clocks: 1.29 ms for a verify tile's
// 2,048 rows and 45.3 ms for the combine's 71,680 over 132 SMs × 1.98 GHz;
// device memory sees 1 KB per row.
//
// What the design does about it, and what it does not yet: every row runs
// its whole chain in one thread, in registers and the local-memory stack,
// with no device-memory round trip: inputs in, the point and the flag out.
// Blocks of 32 threads.  A thread per row is bound by the latency of one
// warp's instruction stream (≈ 20 M instructions) at a verify tile's
// 2,048 rows, whether its 64 warps sit on 64 SMs or, in blocks of 8, on
// all 132 (tools/k12_block_probe.py on the H100: 61.8 ms with blocks of
// 32, 62.6 of 16, 64.7 of 8); at 71,680 rows (2,240 warps, waves of 8 an
// SM) the schedulers' rate counts, and smaller blocks lose (231.5, 391.0
// and 901.7 ms).  Not yet: several lanes per row (the three convolutions
// of an Fp2 product, the independent products of a G2 step), windowed
// pows (~240 Fp2 products fewer per row), a root that skips the second
// pow where α = −1.  Measured times: PERF.md.

#include "fp381.cuh"

namespace {

using fp381::F2;
using fp381::G2;
using fp381::NL;

enum { DC_B = 0, DC_M1 = 1, DC_CX = 2, DC_CY = 3 };

__device__ __forceinline__ void dc(F2& o, int k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    o.c0[i] = fp381::DC[2 * k][i];
    o.c1[i] = fp381::DC[2 * k + 1][i];
  }
}

__device__ __forceinline__ void f2_one(F2& o) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    o.c0[i] = i == 0;
    o.c1[i] = 0;
  }
}

__device__ __forceinline__ void f2_zero(F2& o) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o.c0[i] = o.c1[i] = 0;
}

__device__ __forceinline__ void f2_neg(F2& o, const F2& a) {
  fp381::neg(o.c0, a.c0);
  fp381::neg(o.c1, a.c1);
}

// a^e for a fixed exponent in 32-bit words, LSB first (tower.
// f2_pow_fixed's schedule, squarings by f2_sqr); o may alias a
__device__ __noinline__ void f2_pow(F2& o, const F2& a, const unsigned* e,
                                    int nbits) {
  F2 result, base = a;
  f2_one(result);
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    if ((e[i >> 5] >> (i & 31)) & 1u) fp381::f2_mul(result, result, base);
    if (i != nbits - 1) fp381::f2_sqr(base, base);
  }
  o = result;
}

// a == b in Fp2, exactly
__device__ __noinline__ bool f2_eq(const F2& a, const F2& b) {
  F2 d;
  fp381::f2_sub(d, a, b);
  return fp381::f2_is_zero(d);
}

// ψ(Q) == [z]Q (codec.g2_in_subgroup); true at ∞
__device__ __noinline__ bool in_subgroup(const G2& q) {
  G2 t[3];
  t[0] = q;
  fp381::g2_double(t[1], q);
  fp381::g2_add(t[2], t[1], q);
  G2 acc = t[(fp381::ABS_Z >> 62) - 1];
#pragma unroll 1
  for (int i = 1; i < 32; ++i) {
    const int w = (int)((fp381::ABS_Z >> (62 - 2 * i)) & 3);
    fp381::g2_double(acc, acc);
    fp381::g2_double(acc, acc);
    if (w) fp381::g2_add(acc, acc, t[w - 1]);
  }
  if (fp381::Z_NEG) f2_neg(acc.y, acc.y);
  // ψ(Q) = (c_x·conj(X), c_y·conj(Y), conj(Z))
  F2 c, cj, px, py, pz;
  dc(c, DC_CX);
  fp381::copy(cj.c0, q.x.c0);
  fp381::neg(cj.c1, q.x.c1);
  fp381::f2_mul(px, c, cj);
  dc(c, DC_CY);
  fp381::copy(cj.c0, q.y.c0);
  fp381::neg(cj.c1, q.y.c1);
  fp381::f2_mul(py, c, cj);
  fp381::copy(pz.c0, q.z.c0);
  fp381::neg(pz.c1, q.z.c1);
  // projective equality (curve.eq_points), ψ(Q) first
  const bool i1 = fp381::f2_is_zero(pz), i2 = fp381::f2_is_zero(acc.z);
  if (i1 || i2) return i1 && i2;
  F2 a, b;
  fp381::f2_mul(a, px, acc.z);
  fp381::f2_mul(b, acc.x, pz);
  if (!f2_eq(a, b)) return false;
  fp381::f2_mul(a, py, acc.z);
  fp381::f2_mul(b, acc.y, pz);
  return f2_eq(a, b);
}

__global__ void __launch_bounds__(32)
g2_decompress_kernel(int* __restrict__ out, unsigned char* __restrict__ ok,
                     const int* __restrict__ xc0, const int* __restrict__ xc1,
                     const unsigned char* __restrict__ sign,
                     const unsigned char* __restrict__ inf, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  F2 x, rhs, t, u;
  fp381::load_el(x.c0, xc0, r, n);
  fp381::load_el(x.c1, xc1, r, n);
  fp381::f2_sqr(t, x);                 // rhs = x³ + b'
  fp381::f2_mul(t, t, x);
  dc(u, DC_B);
  fp381::f2_add(rhs, t, u);
  // the square root
  F2 a1, alpha, x0, y;
  f2_pow(a1, rhs, fp381::EXP_P34, fp381::EXP_P34_BITS);
  fp381::f2_sqr(t, a1);
  fp381::f2_mul(alpha, t, rhs);
  fp381::f2_mul(x0, a1, rhs);
  f2_one(u);                           // (α + 1)^((p−1)/2) · x0
  fp381::f2_add(t, alpha, u);
  f2_pow(t, t, fp381::EXP_P12, fp381::EXP_P12_BITS);
  fp381::f2_mul(y, t, x0);
  dc(u, DC_M1);
  if (f2_eq(alpha, u)) {               // α = −1: the root is u·x0
    fp381::neg(y.c0, x0.c1);
    fp381::copy(y.c1, x0.c0);
  }
  fp381::f2_sqr(t, y);
  bool good = f2_eq(t, rhs);
  // the ZCash sign of the canonical root
  int y0[NL], y1[NL], acc = 0;
  fp381::canon(y0, y.c0);
  fp381::canon(y1, y.c1);
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= y1[i];
  const bool cur = acc == 0 ? fp381::sgn(y0) : fp381::sgn(y1);
  if (cur != (sign[r] != 0)) f2_neg(y, y);
  // from_affine with the ∞ flag
  G2 q;
  if (inf[r]) {
    f2_zero(q.x);
    f2_one(q.y);
    f2_zero(q.z);
    good = true;
  } else {
    q.x = x;
    q.y = y;
    f2_one(q.z);
  }
  good = good && in_subgroup(q);
  fp381::store_pt(out, q, r, n);
  ok[r] = good;
}

}  // namespace

// out [6, 32, n] int32, ok [n] uint8; xc0, xc1 [32, n] int32; sign, inf [n]
// uint8.  Returns the cudaError of the launch.
extern "C" int charon_g2_decompress(void* out, void* ok, const void* xc0,
                                    const void* xc1, const void* sign,
                                    const void* inf, int n, void* stream) {
  constexpr int block = 32;
  g2_decompress_kernel<<<(n + block - 1) / block, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<unsigned char*>(ok),
      static_cast<const int*>(xc0), static_cast<const int*>(xc1),
      static_cast<const unsigned char*>(sign),
      static_cast<const unsigned char*>(inf), n);
  return (int)cudaGetLastError();
}
