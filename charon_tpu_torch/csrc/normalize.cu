// normalize.cu — kernel K19: projective G2 points → canonical affine
// (x, y) and the ∞ flag, a whole batch in ONE launch, one thread per row.
//
// Replaces: the K1 chain of codec.g2_normalize (the JAX package's
// charon_tpu/ops/codec.py g2_normalize :319, `curve.to_affine` then the
// standard form, whose field ops reach charon_tpu/ops/pallas_fp.py
// `_mul_kernel` :78, `_add_kernel` :97 and `_neg_kernel` :112).  Eagerly,
// that chain is 397 K1 launches a call (the Fermat pow bit by bit): once
// per combine on its 10,240 rows and once per device hash batch.
//
// What it computes per row (ops/cuda_codec.py `g2_normalize_plain` runs
// the same sequence in plain PyTorch): the norm n = Z0² + Z1², its
// inverse by 4-bit windows (csrc/fp_inv.cuh `fp_inv_w4`), Z⁻¹ = (Z0·n⁻¹,
// −Z1·n⁻¹), x = X·Z⁻¹ and y = Y·Z⁻¹ (fp381 f2_mul), each coefficient
// canonicalised exactly (fp381 canon), and ∞ = (Z0 ≡ 0 and Z1 ≡ 0): an ∞
// row has n = 0, so n⁻¹ = 0 and x = y = 0, `to_affine`'s (0, 0, True).
// The outputs are canonical, so they equal codec.g2_normalize's and the
// JAX package's bit for bit whatever chain computed the values.
//
// Layout: pts [6, 32, n] int32 (the projective [3, 2, 32, n]); out [4,
// 32, n] (xc0, xc1, yc0, yc1) and inf [n] uint8 (torch.bool).
//
// What bounds it on an H100: int32 instructions, ~495 Fp products a row
// (chip_smoke.py counts them with its OPS table): 0.73 ms for the
// combine's 10,240 rows at the card's full rate.  But the chain is one
// dependent sequence: a thread per row puts 320 warps on 132 SMs, and a
// warp alone on a scheduler runs the unrolled products at a small fraction
// of its rate (PERF.md: ~0.15 instructions a clock), so the row's chain
// length is what the launch costs.
//
// What the design does about it: one launch where there were 397, with
// the row's values in registers and its local-memory stack (no device
// memory between products), and the windowed pow's 489 products where
// the launches ran 609.  Blocks of one warp, so a small batch (64
// messages) spreads over as many SMs as it has warps.  Not yet: the
// products of the chain spread over lanes (one Fp product over 4 lanes).

#include "fp_inv.cuh"

namespace {

using fp381::F2;
using fp381::NL;

constexpr int BLOCK = 32;

__device__ __forceinline__ void store_canon(int* plane, const int* a, int r,
                                            int n) {
  int c[NL];
  fp381::canon(c, a);
  fp381::store_el(plane, c, r, n);
}

__global__ void __launch_bounds__(BLOCK)
g2_normalize_kernel(int* __restrict__ out, unsigned char* __restrict__ inf,
                    const int* __restrict__ pts, int n) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= n) return;
  const size_t ps = (size_t)NL * n;
  F2 x, y, z;
  fp381::load_el(x.c0, pts + 0 * ps, r, n);
  fp381::load_el(x.c1, pts + 1 * ps, r, n);
  fp381::load_el(y.c0, pts + 2 * ps, r, n);
  fp381::load_el(y.c1, pts + 3 * ps, r, n);
  fp381::load_el(z.c0, pts + 4 * ps, r, n);
  fp381::load_el(z.c1, pts + 5 * ps, r, n);
  inf[r] = fp381::is_zero(z.c0) && fp381::is_zero(z.c1);
  int s0[NL], s1[NL], ninv[NL];
  fp381::mul_n(s0, z.c0, z.c0);
  fp381::mul_n(s1, z.c1, z.c1);
  fp381::add(ninv, s0, s1);
  fp381::fp_inv_w4(ninv, ninv);
  F2 zi;
  fp381::mul_n(zi.c0, z.c0, ninv);
  fp381::mul_n(s0, z.c1, ninv);
  fp381::neg(zi.c1, s0);
  fp381::f2_mul(x, x, zi);
  fp381::f2_mul(y, y, zi);
  store_canon(out + 0 * ps, x.c0, r, n);
  store_canon(out + 1 * ps, x.c1, r, n);
  store_canon(out + 2 * ps, y.c0, r, n);
  store_canon(out + 3 * ps, y.c1, r, n);
}

}  // namespace

// Returns the cudaError of the launch.
extern "C" int charon_g2_normalize(void* out, void* inf, const void* pts,
                                   int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  g2_normalize_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<unsigned char*>(inf),
      static_cast<const int*>(pts), n);
  return (int)cudaGetLastError();
}
