// h2c.cu — kernels K7 (f2_chain<SQR|MUL|SQR4|SQR4MUL>), K8 (h2c_sswu) and
// K9 (h2c_point<ISO3|PSI>): the batched hash-to-G2 of the verify path's
// message cache, one thread per row.
//
// Replaces: charon_tpu/ops/pallas_h2c.py
//   K7 f2_chain<SQR>      _h2c_sqr_kernel      a²
//   K7 f2_chain<MUL>      _h2c_mul_kernel      a·b
//   K7 f2_chain<SQR4>     _h2c_sqr4_kernel     a¹⁶
//   K7 f2_chain<SQR4MUL>  _h2c_sqr4mul_kernel  a¹⁶·m (one 4-bit pow window)
//   K8 h2c_sswu           _h2c_sswu_kernel     SSWU fraction + both radicands
//   K9 h2c_point<ISO3>    _h2c_iso3_kernel     3-isogeny, projective output
//   K9 h2c_point<PSI>     _h2c_psi_kernel      ψ endomorphism
// (The cofactor clearing's pallas_g2.dblsel is K10 in g2.cu.)
//
// K9 runs only in the smoke run's kernel phase and as the reference the
// kernels that replaced it are held to: K23 (h2c_map.cu) takes ISO3 with
// the map tail's exact boundary, K22's "pre" program (g2_law.cu) the two
// ψ launches of the cofactor clearing.
//
// Layout: a batch of n-plane rows is [n, 32, stride] int32 (plane, limb,
// row); an Fp2 is 2 planes (c0, c1), a projective point 6 (X0 X1 Y0 Y1 Z0
// Z1).  K8 reads u [2, 32, n] and the exceptional flag row w [n] and
// writes [10, 32, n] = (xn, xd, Z·u², v1, v2); K9 ISO3 reads affine (x, y)
// [4, 32, n]; K9 PSI reads and writes [6, 32, n].  The SSWU, isogeny and ψ
// constants are the table H2C of fp381_consts.cuh (Fp2 constant i in rows
// 2i, 2i + 1), in __constant__ memory.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] per row (the rules of fp_ops.cu; chip_smoke.py's OPS
// table): an Fp2 product is [6,400, 5,320] and a square [5,152, 4,020];
// K7 SQR4MUL is 4 squares and a product, [27,008, 21,400]; K8 is 10
// products, 4 squares and 4 sums, [85,632, 72,656], and one product more
// where the flag is clear, [92,032, 77,976]; K9 ISO3 is 13 products
// and 11 sums, [86,016, 78,444]; PSI 2 products and 3 negations, [13,280,
// 11,924].  A row needs max(IMAD / 64, all / 128) SM clocks: at 132 SMs ×
// 1.98 GHz the 8,192-row sqrt chain of one 2,048-message batch needs
// 0.013 ms per SQR4MUL launch, against 768 B of device memory per row
// (0.002 ms at 3.35 TB/s).  One batch is ~450 launches.
//
// What the design does about it, and what it does not yet: each launch
// runs its whole step in one thread with no device-memory round trip
// between field ops (the Pallas kernels' VMEM fusion), on the fp381.cuh
// Fp2 functions, so every kernel is bit-identical to its plain version.
// A batch of 2,048 messages puts 8,192 threads into the sqrt chain and
// 2,048 into the ψ and cofactor steps: blocks of 32 give 64–256 blocks on
// 132 SMs, a warp or two per SM, so every launch is bound by instruction
// latency and its launch overhead, not by the int32 rate.  Fusing a whole
// fixed-exponent pow into one kernel (95 windows of one row in registers)
// is the next design.

#include "fp381.cuh"
#include "attrs.cuh"

namespace {

using fp381::F2;
using fp381::G2;

constexpr int BLOCK = 32;

// H2C table slots (ops/cuda_h2c.py)
constexpr int HC_ONE = 0, HC_Z = 1, HC_A = 2, HC_NEG_A = 3, HC_ZA = 4,
              HC_B = 5, HC_XN = 6, HC_XD = 10, HC_YN = 12, HC_YD = 16,
              HC_PSI_CX = 19, HC_PSI_CY = 20;

__device__ __forceinline__ void hc(F2& o, int k) {
#pragma unroll
  for (int i = 0; i < fp381::NL; ++i) {
    o.c0[i] = fp381::H2C[2 * k][i];
    o.c1[i] = fp381::H2C[2 * k + 1][i];
  }
}

__device__ __forceinline__ void load_f2(F2& o, const int* p, int r,
                                        int stride) {
  fp381::load_el(o.c0, p, r, stride);
  fp381::load_el(o.c1, p + (size_t)fp381::NL * stride, r, stride);
}

__device__ __forceinline__ void store_f2(int* p, const F2& x, int r,
                                         int stride) {
  fp381::store_el(p, x.c0, r, stride);
  fp381::store_el(p + (size_t)fp381::NL * stride, x.c1, r, stride);
}

// Σ kᵢ·xⁱ by Horner over the table slots first..first+deg (k_deg implied 1
// when MONIC, and then not stored).  o may not alias x.
template <int DEG, int MONIC>
__device__ __forceinline__ void horner(F2& o, const F2& x, int first) {
  F2 c;
  if (MONIC) {
    hc(c, first + DEG - 1);
    fp381::f2_add(o, x, c);
  } else {
    hc(o, first + DEG);
  }
#pragma unroll 1
  for (int i = DEG - 1 - (MONIC ? 1 : 0); i >= 0; --i) {
    fp381::f2_mul(o, o, x);
    hc(c, first + i);
    fp381::f2_add(o, o, c);
  }
}

enum { SQR = 0, MUL = 1, SQR4 = 2, SQR4MUL = 3 };

template <int OP>
__global__ void __launch_bounds__(BLOCK)
f2_chain_kernel(int* __restrict__ out, const int* __restrict__ a,
                const int* __restrict__ b, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  F2 x;
  load_f2(x, a, r, n);
  if (OP == SQR) {
    fp381::f2_sqr(x, x);
  } else if (OP == MUL) {
    F2 y;
    load_f2(y, b, r, n);
    fp381::f2_mul(x, x, y);
  } else {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) fp381::f2_sqr(x, x);
    if (OP == SQR4MUL) {
      F2 y;
      load_f2(y, b, r, n);
      fp381::f2_mul(x, x, y);
    }
  }
  store_f2(out, x, r, n);
}

// pallas_h2c._sswu_body, operation for operation
__global__ void __launch_bounds__(BLOCK)
h2c_sswu_kernel(int* __restrict__ out, const int* __restrict__ u,
                const int* __restrict__ w, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t f2s = (size_t)2 * fp381::NL * n;  // one Fp2 of planes
  F2 uu, c, u2, zu2, zu2sq, tv1, xd, xn, t, xd2, xd3, xn3, gx;
  load_f2(uu, u, r, n);
  fp381::f2_sqr(u2, uu);
  hc(c, HC_Z);
  fp381::f2_mul(zu2, c, u2);
  fp381::f2_sqr(zu2sq, zu2);
  fp381::f2_add(tv1, zu2sq, zu2);
  if (w[r] != 0) {
    hc(xd, HC_ZA);
  } else {
    hc(c, HC_NEG_A);
    fp381::f2_mul(xd, c, tv1);
  }
  hc(c, HC_ONE);
  fp381::f2_add(t, tv1, c);
  hc(c, HC_B);
  fp381::f2_mul(xn, c, t);
  fp381::f2_sqr(xd2, xd);
  fp381::f2_mul(xd3, xd2, xd);
  fp381::f2_sqr(t, xn);
  fp381::f2_mul(xn3, t, xn);
  fp381::f2_mul(t, xn, xd2);
  hc(c, HC_A);
  fp381::f2_mul(t, c, t);
  fp381::f2_add(gx, xn3, t);
  hc(c, HC_B);
  fp381::f2_mul(t, c, xd3);
  fp381::f2_add(gx, gx, t);
  store_f2(out + 0 * f2s, xn, r, n);
  store_f2(out + 1 * f2s, xd, r, n);
  store_f2(out + 2 * f2s, zu2, r, n);
  fp381::f2_mul(gx, gx, xd);                  // v1
  store_f2(out + 3 * f2s, gx, r, n);
  fp381::f2_mul(t, zu2sq, zu2);               // (Z·u²)³
  fp381::f2_mul(t, t, gx);                    // v2
  store_f2(out + 4 * f2s, t, r, n);
}

enum { ISO3 = 0, PSI = 1 };

template <int KIND>
__global__ void __launch_bounds__(BLOCK)
h2c_point_kernel(int* __restrict__ out, const int* __restrict__ in, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t f2s = (size_t)2 * fp381::NL * n;
  if (KIND == ISO3) {
    F2 x, y, xnum, xden, ynum, yden, t;
    load_f2(x, in, r, n);
    load_f2(y, in + f2s, r, n);
    horner<3, 0>(xnum, x, HC_XN);
    horner<2, 1>(xden, x, HC_XD);
    horner<3, 0>(ynum, x, HC_YN);
    horner<3, 1>(yden, x, HC_YD);
    fp381::f2_mul(t, xnum, yden);
    store_f2(out, t, r, n);
    fp381::f2_mul(t, ynum, xden);
    fp381::f2_mul(t, y, t);
    store_f2(out + f2s, t, r, n);
    fp381::f2_mul(t, xden, yden);
    store_f2(out + 2 * f2s, t, r, n);
  } else {
    G2 p;
    F2 c;
    fp381::load_pt(p, in, r, n);
    fp381::neg(p.x.c1, p.x.c1);
    fp381::neg(p.y.c1, p.y.c1);
    fp381::neg(p.z.c1, p.z.c1);
    hc(c, HC_PSI_CX);
    fp381::f2_mul(p.x, c, p.x);
    hc(c, HC_PSI_CY);
    fp381::f2_mul(p.y, c, p.y);
    fp381::store_pt(out, p, r, n);
  }
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// op 0: a²; 1: a·b; 2: a¹⁶; 3: a¹⁶·b.  out, a, b [2, 32, n].
extern "C" int charon_f2_chain(int op, void* out, const void* a,
                               const void* b, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(a);
  const int* y = static_cast<const int*>(b);
  switch (op) {
    case SQR:
      f2_chain_kernel<SQR><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
      break;
    case MUL:
      f2_chain_kernel<MUL><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
      break;
    case SQR4:
      f2_chain_kernel<SQR4><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
      break;
    case SQR4MUL:
      f2_chain_kernel<SQR4MUL><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out [10, 32, n] = (xn, xd, Z·u², v1, v2) of u [2, 32, n]; w [n] flags.
extern "C" int charon_h2c_sswu(void* out, const void* u, const void* w,
                               int n, void* stream) {
  h2c_sswu_kernel<<<grid_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(u),
      static_cast<const int*>(w), n);
  return (int)cudaGetLastError();
}

// kind 0: the 3-isogeny of affine [4, 32, n]; kind 1: ψ of [6, 32, n].
// out [6, 32, n].
extern "C" int charon_h2c_point(int kind, void* out, const void* in, int n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(in);
  if (kind == ISO3) {
    h2c_point_kernel<ISO3><<<grid_of(n), BLOCK, 0, s>>>(o, x, n);
  } else if (kind == PSI) {
    h2c_point_kernel<PSI><<<grid_of(n), BLOCK, 0, s>>>(o, x, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_h2c_attrs(int i, int threads, int smem,
                                long long* out) {
  const void* const fns[] = {
      (const void*)f2_chain_kernel<SQR>,  // 0
      (const void*)f2_chain_kernel<MUL>,  // 1
      (const void*)f2_chain_kernel<SQR4>,  // 2
      (const void*)f2_chain_kernel<SQR4MUL>,  // 3
      (const void*)h2c_sswu_kernel,  // 4
      (const void*)h2c_point_kernel<ISO3>,  // 5
      (const void*)h2c_point_kernel<PSI>  // 6
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
