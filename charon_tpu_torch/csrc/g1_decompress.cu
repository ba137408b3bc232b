// g1_decompress.cu — kernel K21: the whole G1 pubkey decompression of a
// key batch in ONE launch, one thread per row.
//
// Replaces: the K1 chain of codec.g1_decompress (the JAX package's
// charon_tpu/ops/codec.py g1_decompress :266 and g1_in_subgroup :254,
// whose field ops reach charon_tpu/ops/pallas_fp.py `_mul_kernel` :78,
// `_add_kernel` :97, `_sub_kernel` :104, `_neg_kernel` :112 and
// `_small_kernel_factory` :120).  Eagerly, that chain is 5,536 K1
// launches per key batch: the pubkey LRU's misses of a verify tile, up to
// 2,048 keys, five batches on the flush after a node starts.
//
// What it computes per row (ops/cuda_codec.py `g1_decompress_plain` runs
// the same sequence in plain PyTorch): rhs = x³ + 4; y = rhs^((p+1)/4) by
// fp.pow_fixed's square-and-multiply, LSB first (so y and the point are
// bit-identical to codec.g1_decompress's); ok = (y² == rhs); the ZCash
// sign of the canonical y and the flip; from_affine with the ∞ flag; and
// the verdict ok ∧ ¬∞ ∧ [r]P = ∞ — codec's ok with the backend's ∞ mask
// (E(Fp)[r] is exactly G1).  Only the verdict reads [r]P, so its schedule
// is this kernel's own: 4-bit windows of r, MSB first, over the table
// P..15P (one doubling, 13 additions), four doublings a window and one
// addition for each non-zero digit, every step the complete a = 0 law of
// fp381.cuh (g1_double / g1_add), so [r]P = ∞ exactly where the 2-bit
// schedule of curve.scalar_mul gives ∞.  Rows whose root fails, and ∞
// rows, skip the multiplication: their verdict is false whatever it
// gives.
//
// Layout: x as one std-form limb plane [32, R] int32, sign and inf flags
// [R] uint8 (torch.bool); out [3, 32, R] int32 (the projective points)
// and ok [R] uint8.
//
// What bounds it on an H100: int32 instructions.  A valid row's chain is
// ~3,400 Fp products: the pow's 378 squarings and 229 products, and
// [r]P's 253 doublings (8 products each) and 65 additions (12 each);
// chip_smoke.py counts them from the OPS table: ≈ 1.3 ms for a verify
// tile's 2,048 keys at the card's full rate, ≈ 6.5 ms for 10,000.  Device
// memory sees 0.5 KB a row.
//
// What the design does about it: one launch where there were 5,536, the
// row's values in registers and its local-memory stack, and [r]P by
// windows (2,804 products where the 2-bit schedule runs 3,604).  A
// thread per row with blocks of one warp and NO shared memory, on K19's
// model: on the first flush after a node starts this kernel runs on the
// prep thread's stream beside the launch thread's Miller loop, fold and
// final exponentiation, and a kernel that holds the SMs' shared memory
// makes those wait (PERF.md §6).  A lone warp's dependent chain is
// what a launch costs at a tile's 64 warps.  Not yet: the chain's
// products spread over lanes.

#include "fp381.cuh"
#include "attrs.cuh"

namespace {

using fp381::G1;
using fp381::NL;

constexpr int BLOCK = 32;
// 4-bit digits of r (255 bits): digit k is bits 4k..4k+3 of EXP_R
constexpr int R_DIGITS = (fp381::EXP_R_BITS + 3) / 4;

__device__ __forceinline__ int r_digit(int k) {
  return (fp381::EXP_R[k >> 3] >> ((k & 7) * 4)) & 15;
}

__device__ __forceinline__ void set_small(int* o, int v) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = i == 0 ? v : 0;
}

// a^e, LSB first (fp.pow_fixed's schedule): a set bit multiplies the
// result by the base, every bit but the last squares the base
__device__ __noinline__ void fp_pow(int* o, const int* a, const unsigned* e,
                                    int nbits) {
  int result[NL], base[NL];
  set_small(result, 1);
  fp381::copy(base, a);
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    if ((e[i >> 5] >> (i & 31)) & 1u) fp381::mul_n(result, result, base);
    if (i != nbits - 1) fp381::mul_n(base, base, base);
  }
  fp381::copy(o, result);
}

// [r]P == ∞, by 4-bit windows of r over the table P..15P (local memory)
__device__ __noinline__ bool r_mul_is_inf(const G1& p) {
  G1 tbl[15];
  tbl[0] = p;
  fp381::g1_double(tbl[1], p);
#pragma unroll 1
  for (int k = 2; k < 15; ++k) fp381::g1_add(tbl[k], tbl[k - 1], p);
  G1 acc = tbl[r_digit(R_DIGITS - 1) - 1];
#pragma unroll 1
  for (int k = R_DIGITS - 2; k >= 0; --k) {
#pragma unroll 1
    for (int j = 0; j < 4; ++j) fp381::g1_double(acc, acc);
    const int d = r_digit(k);
    if (d) fp381::g1_add(acc, acc, tbl[d - 1]);
  }
  return fp381::is_zero(acc.z);
}

__global__ void __launch_bounds__(BLOCK)
g1_decompress_kernel(int* __restrict__ pts, unsigned char* __restrict__ ok,
                     const int* __restrict__ x_std,
                     const unsigned char* __restrict__ sign,
                     const unsigned char* __restrict__ inf, int n) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= n) return;
  const size_t ps = (size_t)NL * n;
  G1 p;
  int rhs[NL], t[NL];
  fp381::load_el(p.x, x_std, r, n);
  // rhs = x·x·x + 4 (codec: fp.add(fp.mul(fp.sqr(x), x), b))
  fp381::mul_n(t, p.x, p.x);
  fp381::mul_n(t, t, p.x);
  set_small(p.z, 4);
  fp381::add(rhs, t, p.z);
  fp_pow(p.y, rhs, fp381::EXP_P14, fp381::EXP_P14_BITS);
  fp381::mul_n(t, p.y, p.y);
  fp381::sub(t, t, rhs);
  bool live = fp381::is_zero(t);
  fp381::canon(t, p.y);
  if (fp381::sgn(t) != (sign[r] != 0)) {
    fp381::neg(t, p.y);
    fp381::copy(p.y, t);
  }
  // from_affine: ∞ rows become exactly (0 : 1 : 0)
  if (inf[r]) {
    set_small(p.x, 0);
    set_small(p.y, 1);
    set_small(p.z, 0);
    live = false;
  } else {
    set_small(p.z, 1);
  }
  fp381::store_el(pts + 0 * ps, p.x, r, n);
  fp381::store_el(pts + 1 * ps, p.y, r, n);
  fp381::store_el(pts + 2 * ps, p.z, r, n);
  ok[r] = live && r_mul_is_inf(p);
}

}  // namespace

// Returns the cudaError of the launch.
extern "C" int charon_g1_decompress(void* pts, void* ok, const void* x_std,
                                    const void* sign, const void* inf, int n,
                                    void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  g1_decompress_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pts), static_cast<unsigned char*>(ok),
      static_cast<const int*>(x_std),
      static_cast<const unsigned char*>(sign),
      static_cast<const unsigned char*>(inf), n);
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_g1_decompress_attrs(int i, int threads, int smem,
                                          long long* out) {
  const void* const fns[] = {
      (const void*)g1_decompress_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
