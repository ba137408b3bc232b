// miller.cu — kernel K13: the whole batched Miller loop f_{|z|,Q}(P) of a
// verify tile in ONE launch, a group of LANES threads per pair row, the
// row's state in shared memory.
//
// Replaces: the 198 launches per tile of the K4/K5 step kernels that
// cuda_pairing.miller_loop_plain sequences (csrc/pairing.cu; the JAX
// package's charon_tpu/ops/pallas_pairing.py `miller_rows` :489 over
// `_pp_dbl_kernel` :328, `_pp_add_kernel` :332, `_pp_sqr_kernel` :336 and
// `_pp_mul014_kernel` :340): 63 doublings, 5 mixed additions, 62 Fp12
// squarings and 68 line multiplies over the 63 bits of |z| below its
// leading one.
//
// What it computes: the same ops on the same inputs as that sequence, so
// its result is bit-identical to the plain version.  The loop is written
// out as a dataflow graph of fp381.cuh field ops and list-scheduled on the
// host (ops/miller_program.py): a STEP is up to LANES independent ops of
// one kind, the Fp2 product f2_mul, the Fp2 square f2_sqr, the Fp product
// mul, or LIN — fp381's add, sub and mul_small as one function — and lane
// i of every row group runs op i of the step.  The kernel is the
// interpreter of that program (csrc/program.cuh, which K15 shares): it
// decodes each lane's op (operand and output slots by pointer, no branch
// but the step's kind, which every lane of a warp shares), runs it, and
// __syncwarp()s.  Slots are Fp elements in the row's shared memory; P, Q
// and the constants one and zero are read from the row's input block in
// device memory.  f is written once, at the end.
//
// Layout: in [n, 11, 32] int32, a row's input block (xP, −yP, zP, Q's x
// and y as Fp2, (1, 0), (0, 0)); the program [steps, LANES] int2; fout
// the 12 output planes' codes; out [12, 32, n] (plane m = (k·3 + j)·2 +
// c), the K5 layout.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] per row (chip_smoke.py's OPS table): 63 K4 doublings
// [95,872, 87,384], 5 additions [83,328, 73,710], 62 K5 squarings
// [91,392, 108,042] and 68 line multiplies [107,776, 108,656]:
// [19,451,648, 19,960,954], max(IMAD / 64, all / 128) = 307,911 SM clocks
// a row, 4.83 ms for a verify tile's 4,096 rows over 132 SMs at 1.98 GHz.
// Device memory sees ~3 KB a row (the program is shared and cached).
//
// What the design does about it, and what it does not yet: the step
// kernels ran one thread per row, 128 warps for a tile — about one per
// SM — with their Fp6/Fp12 temporaries on a 6–10 KB local-memory stack a
// thread.  Here a warp holds 32 / LANES rows and each thread runs whole
// field ops on shared-memory operands with its columns in registers:
// with LANES = 8 and 52 slots a row (6,816 B with program.cuh's padding), a
// block of one warp needs 27.3 KB, 8 blocks fit an SM — as many warps as
// 255 registers a thread allow — and a tile's 1,024 warps run in one
// wave (54 slots would not fit 8 blocks).  The scheduler runs the
// doubling chain of T ahead of the line multiplications of f, and cheap
// LIN steps as soon as they are ready so that products gather into full
// steps; the instructions a lane issues per row (Program.cost) are ~1.5×
// the ideal even split of the row's ops over its lanes.  A lone warp's
// program takes most of a tile's time: the SM's issue rate is far from
// full at 8 warps.  Not yet: several lanes per Fp2 product (its three
// convolutions) to shorten each step, the Fp2 square's two halves on two
// lanes (an f2_sqr step has at most two ops), products with their operand
// sums folded in (fewer slots, fewer steps), fewer registers a thread for
// more warps an SM.  `miller_thread` below is the probe design: the same
// loop, one thread per row, the K4/K5 functions on the thread's stack.
// Measured times: PERF.md.

#include "program.cuh"

namespace {

using fp381::F12;
using fp381::F2;
using fp381::G1;
using fp381::G2;
using fp381::Line;
using fp381::NL;

constexpr int WARP = 32;
constexpr int IN_PLANES = 11;

// The interpreter of program.cuh on the Miller program: no SEL; `digits`
// is unused (the launcher's common signature).
__global__ void __launch_bounds__(WARP)
miller_loop_kernel(int* __restrict__ out, const int* __restrict__ in,
                   const int2* __restrict__ prog, int steps,
                   const int* __restrict__ fout,
                   const int* __restrict__ digits, int lanes, int slots,
                   int n) {
  program::run<IN_PLANES, 12, false>(out, in, prog, steps, fout, digits,
                                     lanes, slots, n);
}

// ---- the probe design: one thread per row, the K4/K5 functions ------------

template <int NP, class T>
__device__ __forceinline__ void load_planes(T& o, const int* p, int r,
                                            int stride) {
  int* e = reinterpret_cast<int*>(&o);
  const size_t ps = (size_t)NL * stride;
#pragma unroll 1
  for (int m = 0; m < NP; ++m) fp381::load_el(e + m * NL, p + m * ps, r, stride);
}

__device__ __noinline__ void line_mul(F12& f, const Line& l, const G1& pt) {
  F2 c0, c1, c4;
  fp381::f2_mul_fp(c0, l.c0, pt.z);
  fp381::f2_mul_fp(c1, l.c1b, pt.x);
  fp381::f2_mul_fp(c4, l.c4b, pt.y);
  fp381::f12_mul_by_014(f, f, c0, c1, c4);
}

// p [3, 32, n] (xP, −yP, zP), q [4, 32, n] affine; out [12, 32, n]
__global__ void __launch_bounds__(WARP)
miller_thread_kernel(int* __restrict__ out, const int* __restrict__ p,
                     const int* __restrict__ q, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  G1 pt;
  F2 qq[2];
  load_planes<3>(pt, p, r, n);
  load_planes<4>(qq, q, r, n);
  G2 t, t2;
  t.x = qq[0];
  t.y = qq[1];
  F12 f;
  int* fe = reinterpret_cast<int*>(&f);
#pragma unroll 1
  for (int i = 0; i < 12 * NL; ++i) fe[i] = 0;
  fe[0] = 1;
  int* tz = reinterpret_cast<int*>(&t.z);
#pragma unroll 1
  for (int i = 0; i < 2 * NL; ++i) tz[i] = 0;
  tz[0] = 1;
  Line l;
#pragma unroll 1
  for (int i = 62; i >= 0; --i) {
    if (i != 62) fp381::f12_sqr(f, f);
    fp381::pp_double(t2, l, t);
    t = t2;
    line_mul(f, l, pt);
    if ((fp381::ABS_Z >> i) & 1) {
      fp381::pp_add(t2, l, t, qq[0], qq[1]);
      t = t2;
      line_mul(f, l, pt);
    }
  }
  const size_t ps = (size_t)NL * n;
#pragma unroll 1
  for (int m = 0; m < 12; ++m) fp381::store_el(out + m * ps, fe + m * NL, r, n);
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_miller_loop(void* out, const void* in,
                                  const void* prog, int steps,
                                  const void* fout, int lanes, int slots,
                                  int n, void* stream) {
  return program::launch(miller_loop_kernel, out, in, prog, steps, fout,
                         nullptr, lanes, slots, n, stream);
}

extern "C" int charon_miller_thread(void* out, const void* p, const void* q,
                                    int n, void* stream) {
  miller_thread_kernel<<<(n + WARP - 1) / WARP, WARP, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(p),
      static_cast<const int*>(q), n);
  return (int)cudaGetLastError();
}
