// decompress.cu — kernel K12: the whole G2 point decompression of a batch
// in ONE launch, a row on a group of G lanes (csrc/fp_lanes.cuh).
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
// Z̄) by the projective equality.  Both pows run 3-bit windows, MSB first
// (the table a..a⁷: one squaring, five products), their squarings f2_sqr;
// the group law is the complete RCB doubling and addition of K2.
//
// Layout: x as two std-form limb planes [32, R] int32 (c0, c1), sign and
// inf flags [R] uint8 (torch.bool); out [6, 32, R] int32 (the projective
// points [3, 2, 32, R]) and ok [R] uint8.
//
// What bounds it on an H100: int32 instructions.  The fewest known for the
// function, counted from fp381.cuh as [IMAD, other] (chip_smoke.py's
// decompress_design_ops: both pows by 3-bit windows, the second skipped
// where α = −1 — what this design executes, less the lane split's zero
// terms and shuffles), need max(IMAD / 64, all / 128) SM clocks a row:
// 1.12 ms for a verify tile's 2,048 rows and 39.4 ms for the combine's
// 71,680 over 132 SMs × 1.98 GHz; device memory sees 1 KB per row.  The
// first version's square-and-multiply pows (decompress_ops) would need
// 1.29 and 45.3 ms.
//
// What the design does about it.  The first version ran a row on one
// thread: 255 registers and an 11 KB local-memory stack, and at a verify
// tile's 2,048 rows 64 warps, each the latency of one ≈ 20 M-instruction
// stream (61.5 ms).  Here each Fp element of a row is spread over the G
// lanes of a group (B = 32 / G limbs a lane), so every product's
// convolution, carry rounds and folds split G ways and a row's critical
// path is its sequence of Fp2 operations on G lanes; 2,048 rows put
// 2,048·G threads on the card.  The pows' tables and the [|z|]Q tables
// (7 Fp2 values a row) sit in shared memory, thread-interleaved; the exact
// tests (α = −1, root² = rhs, the sign, ψ's equalities) gather the row's
// element to shared memory and every lane of the group canonicalises it
// alike.  The second pow is skipped where α = −1 (its result is not
// used).  The wrapper picks G from the rows (cuda_codec.decompress_lanes):
// G = 16 up to 3,072 rows (a verify tile, a combine of 3 shares), where a
// batch is one wave of 16-lane groups (132 SMs × 12 one-warp blocks × 2
// rows = 3,168) and its time one group's critical path, G = 8 above,
// where 16-lane groups need more waves and their larger share of
// shuffles and zero terms loses (tools/k11_k12_ab.py --sweep on the H100:
// 16 lanes 4.9 / 6.7 / 9.0 ms at 1 / 2,048 / 3,072 rows against 8 lanes'
// 6.6 / 7.8 / 10.5; 8 lanes 10.8 / 11.0 / 19.9 / 195 ms at 3,584 / 4,096
// / 7,168 / 71,680 against 16 lanes' 13.0 / 14.3 / 22.5 / 205; at 5,120
// rows, two waves for both, 16 lanes win again, 15.0 against 16.6; 4
// lanes, no longer built, tied with 8 at 8,192 and lost elsewhere).
// Not yet: the independent products of a doubling or an addition side by
// side on more lanes (a row's G2 steps run their products one after
// another), and the three convolutions of an Fp2 product on three
// groups.  On the H100
// (PERF.md row 26): 6.6 ms at 2,048 rows and 195 ms at 71,680, against
// the first version's 62.3 and 222.0 in the same call.

#include "fp_lanes.cuh"
#include "attrs.cuh"

namespace {

using fp381::NL;

constexpr int WARP = 32;
constexpr int TBL = 7;     // a^1..a^7 of a pow; 2Q and 3Q of [|z|]Q

enum { DC_B = 0, DC_M1 = 1, DC_CX = 2, DC_CY = 3 };

template <int G>
struct K12 {
  using A = fpl::F<G>;
  using L = fpl::Lane<G>;
  using E2 = typename A::E2;
  using P2 = typename A::P2;
  static constexpr int B = A::B;
  static constexpr int ROWS = WARP / G;

  // a block's shared memory: the constants, each thread's block of the 7
  // table entries (thread-interleaved), each row's gather scratch
  struct Smem {
    fpl::Consts k;
    int tbl[TBL][2][B][WARP];
    int scr[ROWS][2 * NL + 1];
  };

  static __device__ __forceinline__ void dc(const L& l, E2& o, int k) {
#pragma unroll
    for (int t = 0; t < B; ++t) {
      o.c0.v[t] = fp381::DC[2 * k][B * l.q + t];
      o.c1.v[t] = fp381::DC[2 * k + 1][B * l.q + t];
    }
  }

  static __device__ __forceinline__ void one(const L& l, E2& o) {
    A::set_small(l, o.c0, 1);
    A::set_small(l, o.c1, 0);
  }

  static __device__ __forceinline__ void put(Smem& s, int e, const E2& v) {
#pragma unroll
    for (int t = 0; t < B; ++t) {
      s.tbl[e][0][t][threadIdx.x] = v.c0.v[t];
      s.tbl[e][1][t][threadIdx.x] = v.c1.v[t];
    }
  }

  static __device__ __forceinline__ void get(const Smem& s, E2& v, int e) {
#pragma unroll
    for (int t = 0; t < B; ++t) {
      v.c0.v[t] = s.tbl[e][0][t][threadIdx.x];
      v.c1.v[t] = s.tbl[e][1][t][threadIdx.x];
    }
  }

  // a ≡ 0 (mod p), every lane of the group alike
  static __device__ __noinline__ bool f2_is_zero(const L& l, int* scr,
                                                 const E2& a) {
    A::st2(l, scr, a);
    l.sync();
    const bool z = fp381::is_zero(scr) && fp381::is_zero(scr + NL);
    l.sync();
    return z;
  }

  static __device__ __forceinline__ bool f2_eq(const L& l, int* scr,
                                               const E2& a, const E2& b) {
    E2 d;
    A::f2_sub(l, d, a, b);
    return f2_is_zero(l, scr, d);
  }

  // the ZCash sign of the canonical y (cuda_codec: y1 ≠ 0 ? sgn(y1) :
  // sgn(y0))
  static __device__ __noinline__ bool sign_of(const L& l, int* scr,
                                              const E2& y) {
    A::st2(l, scr, y);
    l.sync();
    int y0[NL], y1[NL], acc = 0;
    fp381::canon(y0, scr);
    fp381::canon(y1, scr + NL);
    l.sync();
#pragma unroll
    for (int i = 0; i < NL; ++i) acc |= y1[i];
    return acc == 0 ? fp381::sgn(y0) : fp381::sgn(y1);
  }

  // digit k (bits 3k..3k+2) of the exponent in 12 words
  static __device__ __forceinline__ int digit(const unsigned* e, int k) {
    const int bit = 3 * k, w = bit >> 5, off = bit & 31;
    unsigned v = e[w] >> off;
    if (off > 29 && w + 1 < 12) v |= e[w + 1] << (32 - off);
    return (int)(v & 7u);
  }

  // a^e by 3-bit windows, MSB first: the table a..a⁷ (a² by f2_sqr, then
  // products by a), then per window three squarings and, for a non-zero
  // digit, one product (cuda_codec._f2_pow_w3); o may alias a
  static __device__ __noinline__ void f2_pow_w3(const L& l, Smem& s,
                                                E2& o, const E2& a,
                                                const unsigned* e,
                                                int nbits) {
    E2 t = a;
    put(s, 0, a);
    A::f2_sqr(l, t, a);
    put(s, 1, t);
#pragma unroll 1
    for (int k = 2; k < TBL; ++k) {
      A::f2_mul(l, t, t, a);
      put(s, k, t);
    }
    const int nd = (nbits + 2) / 3;
    E2 acc;
    get(s, acc, digit(e, nd - 1) - 1);
#pragma unroll 1
    for (int k = nd - 2; k >= 0; --k) {
#pragma unroll 1
      for (int i = 0; i < 3; ++i) A::f2_sqr(l, acc, acc);
      const int d = digit(e, k);
      if (d) {
        get(s, t, d - 1);
        A::f2_mul(l, acc, acc, t);
      }
    }
    o = acc;
  }

  // ψ(Q) == [z]Q (codec.g2_in_subgroup); true at ∞.  2Q and 3Q in the
  // table's entries 0–2 and 3–5.
  static __device__ __noinline__ bool in_subgroup(const L& l, Smem& s,
                                                  int* scr, const P2& q) {
    P2 t, acc;
    A::g2_double(l, t, q);
    put(s, 0, t.x);
    put(s, 1, t.y);
    put(s, 2, t.z);
    A::g2_add(l, acc, t, q);
    put(s, 3, acc.x);
    put(s, 4, acc.y);
    put(s, 5, acc.z);
    static_assert(((fp381::ABS_Z >> 62) & 3) == 3, "|z|'s top window");
    // the top window of |z| is 3: acc = 3Q
#pragma unroll 1
    for (int i = 1; i < 32; ++i) {
      const int w = (int)((fp381::ABS_Z >> (62 - 2 * i)) & 3);
      A::g2_double(l, acc, acc);
      A::g2_double(l, acc, acc);
      if (w == 1) A::g2_add(l, acc, acc, q);
      if (w > 1) {
        get(s, t.x, 3 * (w - 2));
        get(s, t.y, 3 * (w - 2) + 1);
        get(s, t.z, 3 * (w - 2) + 2);
        A::g2_add(l, acc, acc, t);
      }
    }
    if (fp381::Z_NEG) A::f2_neg(l, acc.y, acc.y);
    // ψ(Q) = (c_x·conj(X), c_y·conj(Y), conj(Z))
    E2 c, cj, px, py, pz;
    dc(l, c, DC_CX);
    cj.c0 = q.x.c0;
    A::neg(l, cj.c1, q.x.c1);
    A::f2_mul(l, px, c, cj);
    dc(l, c, DC_CY);
    cj.c0 = q.y.c0;
    A::neg(l, cj.c1, q.y.c1);
    A::f2_mul(l, py, c, cj);
    pz.c0 = q.z.c0;
    A::neg(l, pz.c1, q.z.c1);
    // projective equality (curve.eq_points), ψ(Q) first
    const bool i1 = f2_is_zero(l, scr, pz), i2 = f2_is_zero(l, scr, acc.z);
    if (i1 || i2) return i1 && i2;
    E2 a, b;
    A::f2_mul(l, a, px, acc.z);
    A::f2_mul(l, b, acc.x, pz);
    if (!f2_eq(l, scr, a, b)) return false;
    A::f2_mul(l, a, py, acc.z);
    A::f2_mul(l, b, acc.y, pz);
    return f2_eq(l, scr, a, b);
  }
};

template <int G>
__global__ void __launch_bounds__(WARP)
g2_decompress_kernel(int* __restrict__ out, unsigned char* __restrict__ ok,
                     const int* __restrict__ xc0, const int* __restrict__ xc1,
                     const unsigned char* __restrict__ sign,
                     const unsigned char* __restrict__ inf, int n) {
  using K = K12<G>;
  using A = typename K::A;
  __shared__ typename K::Smem s;
  fpl::load_consts(s.k, threadIdx.x, WARP);
  __syncwarp();
  const typename K::L l(threadIdx.x, &s.k);
  const int grp = threadIdx.x / G;
  const int r = blockIdx.x * K::ROWS + grp;
  // a group past the last row leaves: every shuffle and warp sync below
  // names its own group's lanes alone
  if (r >= n) return;
  int* scr = s.scr[grp];
  typename K::E2 x, rhs, t, u;
  A::ld_plane(l, x.c0, xc0, r, n);
  A::ld_plane(l, x.c1, xc1, r, n);
  A::f2_sqr(l, t, x);                  // rhs = x³ + b'
  A::f2_mul(l, t, t, x);
  K::dc(l, u, DC_B);
  A::f2_add(l, rhs, t, u);
  // the square root
  typename K::E2 a1, alpha, x0, y;
  K::f2_pow_w3(l, s, a1, rhs, fp381::EXP_P34, fp381::EXP_P34_BITS);
  A::f2_sqr(l, t, a1);
  A::f2_mul(l, alpha, t, rhs);
  A::f2_mul(l, x0, a1, rhs);
  K::dc(l, u, DC_M1);
  if (K::f2_eq(l, scr, alpha, u)) {    // α = −1: the root is u·x0
    A::neg(l, y.c0, x0.c1);
    y.c1 = x0.c0;
  } else {                             // (α + 1)^((p−1)/2) · x0
    K::one(l, u);
    A::f2_add(l, t, alpha, u);
    K::f2_pow_w3(l, s, t, t, fp381::EXP_P12, fp381::EXP_P12_BITS);
    A::f2_mul(l, y, t, x0);
  }
  A::f2_sqr(l, t, y);
  bool good = K::f2_eq(l, scr, t, rhs);
  // the ZCash sign of the canonical root
  if (K::sign_of(l, scr, y) != (sign[r] != 0)) A::f2_neg(l, y, y);
  // from_affine with the ∞ flag
  typename K::P2 q;
  if (inf[r]) {
    A::set_small(l, q.x.c0, 0);
    A::set_small(l, q.x.c1, 0);
    K::one(l, q.y);
    A::set_small(l, q.z.c0, 0);
    A::set_small(l, q.z.c1, 0);
    good = true;
  } else {
    q.x = x;
    q.y = y;
    K::one(l, q.z);
  }
  good = good && K::in_subgroup(l, s, scr, q);
  const size_t ps = (size_t)NL * n;
  A::st_plane(l, out + 0 * ps, q.x.c0, r, n);
  A::st_plane(l, out + 1 * ps, q.x.c1, r, n);
  A::st_plane(l, out + 2 * ps, q.y.c0, r, n);
  A::st_plane(l, out + 3 * ps, q.y.c1, r, n);
  A::st_plane(l, out + 4 * ps, q.z.c0, r, n);
  A::st_plane(l, out + 5 * ps, q.z.c1, r, n);
  if (l.q == 0) ok[r] = good;
}

}  // namespace

// out [6, 32, n] int32, ok [n] uint8; xc0, xc1 [32, n] int32; sign, inf [n]
// uint8; `lanes` a row, 16 or 8 (cuda_codec.decompress_lanes).  Returns
// the cudaError of the launch.
extern "C" int charon_g2_decompress(int lanes, void* out, void* ok,
                                    const void* xc0, const void* xc1,
                                    const void* sign, const void* inf, int n,
                                    void* stream) {
  if (n <= 0 || (lanes != 16 && lanes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (n + WARP / lanes - 1) / (WARP / lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  unsigned char* k = static_cast<unsigned char*>(ok);
  const int* a = static_cast<const int*>(xc0);
  const int* b = static_cast<const int*>(xc1);
  const unsigned char* sg = static_cast<const unsigned char*>(sign);
  const unsigned char* in = static_cast<const unsigned char*>(inf);
  if (lanes == 16) {
    g2_decompress_kernel<16><<<grid, WARP, 0, s>>>(o, k, a, b, sg, in, n);
  } else {
    g2_decompress_kernel<8><<<grid, WARP, 0, s>>>(o, k, a, b, sg, in, n);
  }
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_decompress_attrs(int i, int threads, int smem,
                                       long long* out) {
  const void* const fns[] = {
      (const void*)g2_decompress_kernel<16>,  // 0
      (const void*)g2_decompress_kernel<8>    // 1
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
