// pairing.cu — kernels K4 (pp_step<DBL|ADD>), K5 (f12_step<SQR|MUL014|
// F12MUL>) and K6 (g1_dblsel): the batched Miller loop, its product fold
// and the RLC scaling of the verify path, one thread per pair row.
//
// Replaces: charon_tpu/ops/pallas_pairing.py
//   K4 pp_step<DBL>      _pp_dbl_kernel       doubling + line (c0, c1b, c4b)
//   K4 pp_step<ADD>      _pp_add_kernel       mixed addition + line (c0, θ, δ)
//   K5 f12_step<SQR>     _pp_sqr_kernel       f ← f²
//   K5 f12_step<MUL014>  _pp_mul014_kernel    f ← f·ℓ(P), P projective
//   K5 f12_step<F12MUL>  _pp_f12mul_kernel    f ← a·b (the product fold)
//   K6 g1_dblsel         _pp_g1_dblsel_kernel acc ← 4·acc + table[w], w=0 keeps
//
// Layout: a batch of n-plane rows is [n, 32, stride] int32 (plane, limb,
// row); an Fp12 is 12 planes, plane m = (k·3 + j)·2 + c for coefficient
// w^k v^j u^c, which is exactly the memory order of fp381::F12.  K4 writes
// [12, 32, R]: the new (X, Y, Z) in planes 0–5 and the line in 6–11, so the
// Miller loop slices both without a copy.  K5 reads its inputs at a row
// stride of its own, so the product fold multiplies the two halves of one
// tensor (rows [0, s) by rows [s, 2s)) in place of a copy.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] per row (the rules of fp_ops.cu; chip_smoke.py's OPS
// table): an Fp2 product is [6,400, 5,320]; K4 DBL [95,872, 87,384], ADD
// [83,328, 73,710]; K5 SQR [91,392, 108,042], MUL014 [107,776, 108,656],
// F12MUL [133,344, 152,494]; K6 [72,832, 54,151] with the addition,
// [41,024, 28,920] without.  A row needs max(IMAD / 64, all / 128) SM
// clocks; at 132 SMs × 1.98 GHz a verify tile (4,096 Miller rows) needs
// 0.020–0.035 ms per launch, against 1.9–4.6 KB of device memory per row
// (at most 0.006 ms at 3.35 TB/s).  The whole Miller loop of a tile is 198
// launches: ~4.9 ms of int32 work.
//
// What the design does about it, and what it does not yet: every step runs
// whole in one thread with no device-memory round trip between field ops
// (the Pallas kernels' VMEM fusion); the Fp2 product keeps its columns in
// registers and the tower functions are __noinline__, so Fp6/Fp12
// temporaries live in the thread's local-memory stack (L1-cached).  A tile
// has only 4,096 threads — blocks of 32 give 128 blocks, about one warp per
// SM on 132 SMs — so every launch is bound by instruction latency, not by
// the int32 rate: pp_mul014 takes the same ~0.67 ms at 132 rows as at
// 2,048 (PERF.md).  The verify path's Miller loop is now kernel K13
// (csrc/miller.cu: the whole loop in one launch, 8 threads a row, the state
// in shared memory); K4 and the K5 SQR/MUL014 steps stay as the
// counterparts of their Pallas kernels and the plain bodies K13 is held
// to, and F12MUL and K6 still serve the fold and the RLC scaling, where a
// lane split per row and wgmma for the limb products are the next designs.

#include "fp381.cuh"
#include "attrs.cuh"

namespace {

using fp381::F12;
using fp381::F2;
using fp381::G1;
using fp381::G2;
using fp381::Line;
using fp381::NL;

constexpr int BLOCK = 32;

// Planes [np, 32, stride] at row r ↔ a struct of np consecutive elements.
template <int NP, class T>
__device__ __forceinline__ void load_planes(T& o, const int* p, int r,
                                            int stride) {
  static_assert(sizeof(T) == NP * NL * sizeof(int), "plane count");
  int* e = reinterpret_cast<int*>(&o);
  const size_t ps = (size_t)NL * stride;
#pragma unroll 1
  for (int m = 0; m < NP; ++m) fp381::load_el(e + m * NL, p + m * ps, r, stride);
}

template <int NP, class T>
__device__ __forceinline__ void store_planes(int* p, const T& x, int r,
                                             int stride) {
  static_assert(sizeof(T) == NP * NL * sizeof(int), "plane count");
  const int* e = reinterpret_cast<const int*>(&x);
  const size_t ps = (size_t)NL * stride;
#pragma unroll 1
  for (int m = 0; m < NP; ++m) fp381::store_el(p + m * ps, e + m * NL, r, stride);
}

enum PpKind { PP_DBL = 0, PP_ADD = 1 };

// out [12, 32, n] = (X3, Y3, Z3, line); xyz [6, 32, n]; q [4, 32, n]
template <int KIND>
__global__ void __launch_bounds__(BLOCK)
pp_step_kernel(int* __restrict__ out, const int* __restrict__ xyz,
               const int* __restrict__ q, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  G2 p, o;
  Line l;
  load_planes<6>(p, xyz, r, n);
  if (KIND == PP_DBL) {
    fp381::pp_double(o, l, p);
  } else {
    F2 qq[2];
    load_planes<4>(qq, q, r, n);
    fp381::pp_add(o, l, p, qq[0], qq[1]);
  }
  store_planes<6>(out, o, r, n);
  store_planes<6>(out + (size_t)6 * NL * n, l, r, n);
}

enum F12Kind { F12_SQR = 0, F12_MUL014 = 1, F12_MUL = 2 };

// out [12, 32, n] (row stride n); a [12, 32, istride]; MUL014: b the line
// [6, 32, istride] and p (xP, −yP, zP) [3, 32, istride]; F12MUL: b
// [12, 32, istride].
template <int KIND>
__global__ void __launch_bounds__(BLOCK)
f12_step_kernel(int* __restrict__ out, const int* __restrict__ a,
                const int* __restrict__ b, const int* __restrict__ p, int n,
                int istride) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  F12 f, o;
  load_planes<12>(f, a, r, istride);
  if (KIND == F12_SQR) {
    fp381::f12_sqr(o, f);
  } else if (KIND == F12_MUL014) {
    Line l;
    G1 pt;                                   // (xP, −yP, zP)
    load_planes<6>(l, b, r, istride);
    load_planes<3>(pt, p, r, istride);
    F2 c0, c1, c4;
    fp381::f2_mul_fp(c0, l.c0, pt.z);
    fp381::f2_mul_fp(c1, l.c1b, pt.x);
    fp381::f2_mul_fp(c4, l.c4b, pt.y);
    fp381::f12_mul_by_014(o, f, c0, c1, c4);
  } else {
    F12 g;
    load_planes<12>(g, b, r, istride);
    fp381::f12_mul(o, f, g);
  }
  store_planes<12>(out, o, r, n);
}

// acc ← 4·acc + table[w] (w = 0 keeps 4·acc); all [3, 32, n], w [n]
__global__ void __launch_bounds__(BLOCK)
g1_dblsel_kernel(int* __restrict__ out, const int* __restrict__ acc,
                 const int* __restrict__ t1, const int* __restrict__ t2,
                 const int* __restrict__ t3, const int* __restrict__ w,
                 int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int wr = w[r];
  G1 a;
  load_planes<3>(a, acc, r, n);
  fp381::g1_double(a, a);
  fp381::g1_double(a, a);
  if (wr != 0) {
    G1 s;
    load_planes<3>(s, wr == 1 ? t1 : wr == 2 ? t2 : t3, r, n);
    fp381::g1_add(a, a, s);
  }
  store_planes<3>(out, a, r, n);
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// kind 0: doubling step; kind 1: mixed addition with q.  Returns the
// cudaError of the launch.
extern "C" int charon_pp_step(int kind, void* out, const void* xyz,
                              const void* q, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(xyz);
  const int* y = static_cast<const int*>(q);
  if (kind == PP_DBL) {
    pp_step_kernel<PP_DBL><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
  } else if (kind == PP_ADD) {
    pp_step_kernel<PP_ADD><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// kind 0: f²; kind 1: f·ℓ(P); kind 2: a·b.  Inputs at row stride istride,
// the output at row stride n.
extern "C" int charon_f12_step(int kind, void* out, const void* a,
                               const void* b, const void* p, int n,
                               int istride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(a);
  const int* y = static_cast<const int*>(b);
  const int* z = static_cast<const int*>(p);
  if (kind == F12_SQR) {
    f12_step_kernel<F12_SQR><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, z, n,
                                                         istride);
  } else if (kind == F12_MUL014) {
    f12_step_kernel<F12_MUL014><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, z, n,
                                                            istride);
  } else if (kind == F12_MUL) {
    f12_step_kernel<F12_MUL><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, z, n,
                                                         istride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int charon_g1_dblsel(void* out, const void* acc, const void* t1,
                                const void* t2, const void* t3,
                                const void* w, int n, void* stream) {
  g1_dblsel_kernel<<<grid_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(acc),
      static_cast<const int*>(t1), static_cast<const int*>(t2),
      static_cast<const int*>(t3), static_cast<const int*>(w), n);
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_pairing_attrs(int i, int threads, int smem,
                                    long long* out) {
  const void* const fns[] = {
      (const void*)pp_step_kernel<PP_DBL>,  // 0
      (const void*)pp_step_kernel<PP_ADD>,  // 1
      (const void*)f12_step_kernel<F12_SQR>,  // 2
      (const void*)f12_step_kernel<F12_MUL014>,  // 3
      (const void*)f12_step_kernel<F12_MUL>,  // 4
      (const void*)g1_dblsel_kernel  // 5
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
