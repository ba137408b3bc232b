// g2.cu — kernels K2 (g2_step<DBL|ADD>), K3 (straus_step<HEAD>) and K10
// (g2_sel<DBL>): whole BLS12-381 G2 group-law steps, one thread per point
// row.
//
// Replaces: charon_tpu/ops/pallas_g2.py
//   K2 g2_step<DBL>      _dbl_kernel        (complete RCB doubling)
//   K2 g2_step<ADD>      _add_kernel        (complete RCB addition)
//   K3 straus_step<1>    _dbl3sel_s_kernel  acc ← 8·acc ± table[|d|]
//   K3 straus_step<0>    _addsel_s_kernel   acc ← acc ± table[|d|]
//   K10 g2_sel<1>        _dblsel_kernel     acc ← 4·acc + table[w]
//   K10 g2_sel<0>        _addsel_kernel     acc ← acc + table[w]
// (K3: d ∈ [−4, 3] a balanced base-8 digit; d = 0 keeps the accumulator
// and skips the addition; a negative digit negates the table point's Y.
// K10: w ∈ {0, 1, 2, 3} an UNSIGNED 2-bit window over {Q, 2Q, 3Q}, two
// doublings not three, no negation; w = 0 keeps the accumulator.  K10
// dblsel serves the [|x|]-multiplies of hash-to-G2's cofactor clearing,
// one launch per window with the same w on every row.)
//
// Layout: a point batch is [6, 32, stride] int32 — planes X0 X1 Y0 Y1 Z0 Z1
// × limbs × rows.  K3 reads the four tables (P, 2P, 3P, 4P) and the digit
// row through pointers already offset to the share's first row and the
// tables' row stride, so the Straus loop slices nothing.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] (the rules of fp_ops.cu): an Fp2 product is [6,400,
// 5,320], a doubling [51,616, 48,034], an addition [83,392, 83,458]; a K3
// head step [238,240, 227,560] and a tail step [83,392, 83,458] per row (a
// zero digit drops the addition), against 1.5 KB (K2 dbl) to 3.8 KB (K3)
// of device memory per row.  A row needs max(IMAD / 64, all / 128) SM
// clocks (IMAD runs only on the FMA pipe, 64 lanes per SM per clock; the
// schedulers issue 128 lanes per SM per clock in all), so at 132 SMs ×
// 1.98 GHz one window of the 10,000-validator, 7-share combine (10,240
// rows × (head + 6 tails)) needs at most 0.45 ms; its 3.8 KB × 7 × 10,240
// bytes need 0.08 ms at 3.35 TB/s.
//
// K10 dblsel is two doublings and, where w ≠ 0, one addition per row:
// [186,624, 179,526] instructions, against 4.6 KB of device memory per row
// (acc, one table row, out).  Hash-to-G2 launches it on one row per
// message (2,048 per verify tile): blocks of 32, one warp on each of 64
// SMs, so it is bound by instruction latency, not by the int32 rate, as
// K3 is.
//
// What the design does about it, and what it does not yet: the whole step
// runs in one thread with no device-memory round trip between field ops
// (the Pallas kernels' VMEM fusion); columns live in registers inside each
// function, fold constants in __constant__ memory.  The Fp2 product and
// the group-law functions are __noinline__, so their temporaries sit in
// local memory (L1-cached) between calls: this trades spills for a bounded
// code size.  A Straus step has only 10,240 threads — about 78 per SM on
// 132 SMs, under one warp per scheduler — so K3 is bound by instruction
// latency, not by the int32 rate: spreading one row over several threads,
// or fusing the 87 windows into one kernel, is the next design.

#include "fp381.cuh"

namespace {

using fp381::G2;

constexpr int BLOCK = 64;
// K10 runs on one row per message: blocks of 32 put 2,048 rows on 64 SMs
// where blocks of 64 would use 32.
constexpr int SEL_BLOCK = 32;

template <int DBL>
__global__ void __launch_bounds__(BLOCK)
g2_step_kernel(int* __restrict__ out, const int* __restrict__ a,
               const int* __restrict__ b, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  G2 p, q;
  fp381::load_pt(p, a, r, n);
  if (DBL) {
    fp381::g2_double(q, p);
  } else {
    fp381::load_pt(q, b, r, n);
    fp381::g2_add(q, p, q);
  }
  fp381::store_pt(out, q, r, n);
}

template <int HEAD>
__global__ void __launch_bounds__(BLOCK)
straus_step_kernel(int* __restrict__ out, const int* __restrict__ acc,
                   const int* __restrict__ t1, const int* __restrict__ t2,
                   const int* __restrict__ t3, const int* __restrict__ t4,
                   int tstride, const int* __restrict__ digits, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int w = digits[r];
  G2 a, s;
  fp381::load_pt(a, acc, r, n);
  if (HEAD) {
    fp381::g2_double(a, a);
    fp381::g2_double(a, a);
    fp381::g2_double(a, a);
  }
  if (w != 0) {
    const int wa = w < 0 ? -w : w;
    const int* t = wa == 1 ? t1 : wa == 2 ? t2 : wa == 3 ? t3 : t4;
    fp381::load_pt(s, t, r, tstride);
    if (w < 0) {
      fp381::neg(s.y.c0, s.y.c0);
      fp381::neg(s.y.c1, s.y.c1);
    }
    fp381::g2_add(a, a, s);
  }
  fp381::store_pt(out, a, r, n);
}

// acc ← (4·acc if DBL else acc) + table[w]; w = 0 keeps the accumulator.
// All [6, 32, n], w [n].
template <int DBL>
__global__ void __launch_bounds__(SEL_BLOCK)
g2_sel_kernel(int* __restrict__ out, const int* __restrict__ acc,
              const int* __restrict__ t1, const int* __restrict__ t2,
              const int* __restrict__ t3, const int* __restrict__ w, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int wr = w[r];
  G2 a;
  fp381::load_pt(a, acc, r, n);
  if (DBL) {
    fp381::g2_double(a, a);
    fp381::g2_double(a, a);
  }
  if (wr != 0) {
    G2 s;
    fp381::load_pt(s, wr == 1 ? t1 : wr == 2 ? t2 : t3, r, n);
    fp381::g2_add(a, a, s);
  }
  fp381::store_pt(out, a, r, n);
}

int grid_of(int n, int block = BLOCK) { return (n + block - 1) / block; }

}  // namespace

// kind 0: out = 2·a; kind 1: out = a + b.  [6, 32, n] each.
extern "C" int charon_g2_step(int kind, void* out, const void* a,
                              const void* b, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(a);
  const int* y = static_cast<const int*>(b);
  if (kind == 0) {
    g2_step_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
  } else if (kind == 1) {
    g2_step_kernel<0><<<grid_of(n), BLOCK, 0, s>>>(o, x, y, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One Straus window step over n rows: out, acc [6, 32, n]; t1..t4 point
// planes of row stride tstride, offset to the step's first row; digits
// offset likewise.
extern "C" int charon_straus_step(int head, void* out, const void* acc,
                                  const void* t1, const void* t2,
                                  const void* t3, const void* t4,
                                  int tstride, const void* digits, int n,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* a = static_cast<const int*>(acc);
  const int* p1 = static_cast<const int*>(t1);
  const int* p2 = static_cast<const int*>(t2);
  const int* p3 = static_cast<const int*>(t3);
  const int* p4 = static_cast<const int*>(t4);
  const int* d = static_cast<const int*>(digits);
  if (head) {
    straus_step_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(o, a, p1, p2, p3, p4,
                                                       tstride, d, n);
  } else {
    straus_step_kernel<0><<<grid_of(n), BLOCK, 0, s>>>(o, a, p1, p2, p3, p4,
                                                       tstride, d, n);
  }
  return (int)cudaGetLastError();
}

// dbl 1: out = 4·acc + table[w]; dbl 0: out = acc + table[w] (w = 0 keeps).
// out, acc, t1..t3 [6, 32, n]; w [n].
extern "C" int charon_g2_sel(int dbl, void* out, const void* acc,
                             const void* t1, const void* t2, const void* t3,
                             const void* w, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* a = static_cast<const int*>(acc);
  const int* p1 = static_cast<const int*>(t1);
  const int* p2 = static_cast<const int*>(t2);
  const int* p3 = static_cast<const int*>(t3);
  const int* d = static_cast<const int*>(w);
  if (dbl) {
    g2_sel_kernel<1><<<grid_of(n, SEL_BLOCK), SEL_BLOCK, 0, s>>>(
        o, a, p1, p2, p3, d, n);
  } else {
    g2_sel_kernel<0><<<grid_of(n, SEL_BLOCK), SEL_BLOCK, 0, s>>>(
        o, a, p1, p2, p3, d, n);
  }
  return (int)cudaGetLastError();
}
