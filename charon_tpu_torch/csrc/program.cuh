// program.cuh — the interpreter of a scheduled op program: what kernels
// K13 (miller.cu, the Miller loop), K15 (g1_scalar_mul.cu, the RLC
// scalar multiplication), K16 (straus.cu, the combine's Straus MSM),
// K17 (g2_zmul.cu, hash-to-G2's [|x|]-multiply), K18 (f2_chain.cu), K20
// (g1_tables.cu), K22 (g2_law.cu) and K23 (h2c_map.cu) run.
//
// A group of `lanes` threads owns one row.  ops/miller_program.py writes
// the row's whole computation as a dataflow graph of fp381.cuh field ops
// and list-schedules it on the host: a STEP is up to `lanes` independent
// ops of one kind, and lane i of every row group runs op i of the step.
// The interpreter decodes each lane's op (operand and output slots by
// pointer, no branch but the step's kind, which every lane of a warp
// shares), runs it, and __syncwarp()s.  Slots are Fp elements in the
// row's shared memory; the row's input block (the planes of its points
// and the constants one and zero) stays in device memory.  The outputs
// are written once, at the end.
//
// The op kinds: the Fp2 product f2_mul, the Fp2 square f2_sqr, the Fp
// product mul, LIN — fp381's add, sub, neg and mul_small as one function,
// or a copy (below) — and, where the kernel instantiates it, SEL: a per-row copy
// chosen by the row's digit d of a window, operand a where d = 0, else
// the operand coded b + stride·(d − 1) (K15's table point T[d], and its
// choice between 4·acc and 4·acc + T[d]; K16's table point, Y's sign and
// the choice between acc and acc ± T[|d|]).
//
// Layout: in [n, IN_PLANES, 32] int32, a row's input block; the program
// [steps, lanes] int2 (ops/miller_program.py ENCODING); fout, one code a
// output plane; digits [nwin, n] int32 (SEL only); out [OUT_PLANES, 32, n].

#pragma once

#include "fp381.cuh"

namespace program {

using fp381::F2;
using fp381::NL;

constexpr int WARP = 32;
constexpr int GLOBAL = 192;    // operand codes >= GLOBAL: input planes
// Shared memory holds a row's slots as Fp2 pairs (c1 right after c0, the
// F2 layout), each pair followed by one pad word: the lanes of a group
// read limb k of different pairs at once, and a stride of 65 words puts
// them in different banks (a stride of 64 put every lane of the warp in
// one bank: 32-way conflicts on every operand).
constexpr int PAIRW = 2 * NL + 1;

// A row's words: its pairs, rounded up to 8 (mod 32), so that the row
// groups of a warp, which run the same op on the same slots, sit 8 banks
// apart.
__host__ __device__ constexpr int row_words(int slots) {
  return slots / 2 * PAIRW + ((8 - slots / 2 * PAIRW) % 32 + 32) % 32;
}

enum Kind { NOP = 0, MUL2 = 1, SQR2 = 2, MUL = 3, LIN = 4, SEL = 5 };

// o = spread·48p + k·a + s·b, reduced with 1 or 2 rounds after the first
// (fp381's add: k = s = 1, iters 1; sub: k = 1, s = −1, spread, iters 1;
// mul_small: s = 0, iters 2).  The columns are the same integers as in
// those functions, one zero column wider where they have none, which the
// carry rounds and the fold carry through unchanged: the same bits.
// iters = 0 copies a unreduced (ψ's conjugation keeps c0's limbs).
__device__ __forceinline__ void lin(int* o, const int* a, const int* b,
                                    int k, int s, int iters, int spread) {
  if (iters == 0) {
    fp381::copy(o, a);
    return;
  }
  int c[NL + 3];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[i] = spread * fp381::SPREAD48P[i] + k * a[i] + s * b[i];
  }
  c[NL] = spread * fp381::SPREAD48P[NL];
  fp381::reduce<NL + 1, 1>(c);
  if (iters == 2) {
    fp381::carry_round<NL>(c);
    fp381::carry_round<NL + 1>(c);
    fp381::fold<NL + 2>(c);
  }
  fp381::copy(o, c);
}

__device__ __forceinline__ const int* operand(int code, const int* sm,
                                              const int* gin) {
  return code >= GLOBAL ? gin + (code - GLOBAL) * NL
                        : sm + (code >> 1) * PAIRW + (code & 1) * NL;
}

// The AND of a flag over the `lanes` lanes of each row group (lanes a
// power of two dividing the warp, groups aligned: every thread of the
// warp must call it).
__device__ __forceinline__ int group_and(int v, int lanes) {
#pragma unroll 1
  for (int off = 1; off < lanes; off <<= 1) {
    v &= __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The step loop of a program on one row group: lane `lane` of `lanes`
// runs its op of every step on the row's slots `sm` and input block
// `gin`, and SEL reads the row's digit of window w as digit(w).
template <bool HAS_SEL, class Digit>
__device__ __forceinline__ void exec(const int2* __restrict__ prog,
                                     int steps, int lanes, int lane, int* sm,
                                     const int* gin, Digit digit) {
  int2 op = prog[lane];
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int2 next = s + 1 < steps ? prog[(s + 1) * lanes + lane]
                                    : make_int2(0, 0);
    const int kind = op.x & 0xff;
    if (kind != NOP) {
      int* o = const_cast<int*>(operand((op.x >> 8) & 0xff, sm, gin));
      const int* a = operand((op.x >> 16) & 0xff, sm, gin);
      const int* b = operand((op.x >> 24) & 0xff, sm, gin);
      if (kind == MUL2) {
        fp381::f2_mul(*reinterpret_cast<F2*>(o),
                      *reinterpret_cast<const F2*>(a),
                      *reinterpret_cast<const F2*>(b));
      } else if (kind == SQR2) {
        fp381::f2_sqr(*reinterpret_cast<F2*>(o),
                      *reinterpret_cast<const F2*>(a));
      } else if (kind == MUL) {
        fp381::mul_n(o, a, b);
      } else if (HAS_SEL && kind == SEL) {
        const int d = digit(op.y & 0xff);
        const int code = d == 0 ? (op.x >> 16) & 0xff
                                : ((op.x >> 24) & 0xff) +
                                      ((op.y >> 8) & 0xff) * (d - 1);
        fp381::copy(o, operand(code, sm, gin));
      } else {
        lin(o, a, b, op.y & 0xff, ((op.y >> 8) & 0xf) - 1,
            (op.y >> 12) & 0xf, (op.y >> 16) & 1);
      }
    }
    __syncwarp();
    op = next;
  }
}

// The body of a program kernel: one warp per block, 32 / lanes rows;
// rows past n run the last row's program (so every lane reaches every
// __syncwarp) and write nothing.
template <int IN_PLANES, int OUT_PLANES, bool HAS_SEL>
__device__ __forceinline__ void run(int* __restrict__ out,
                                    const int* __restrict__ in,
                                    const int2* __restrict__ prog, int steps,
                                    const int* __restrict__ fout,
                                    const int* __restrict__ digits,
                                    int lanes, int slots, int n) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int r = blockIdx.x * (WARP / lanes) + grp;
  const int rr = r < n ? r : n - 1;
  int* sm = smem + grp * row_words(slots);
  const int* gin = in + (size_t)rr * IN_PLANES * NL;
  exec<HAS_SEL>(prog, steps, lanes, lane, sm, gin,
                [&](int w) { return digits[(size_t)w * n + rr]; });
  if (r < n) {
#pragma unroll 1
    for (int i = lane; i < OUT_PLANES * NL; i += lanes) {
      const int* e = operand(fout[i / NL], sm, gin);
      out[(size_t)i * n + r] = e[i % NL];
    }
  }
}

using Kernel = void (*)(int*, const int*, const int2*, int, const int*,
                        const int*, int, int, int);

// Launch a program kernel: `lanes` threads a row, `slots` Fp elements of
// shared memory a row.  Returns the cudaError of the launch (or of the
// shared-memory attribute).
inline int launch(Kernel kernel, void* out, const void* in,
                  const void* prog, int steps, const void* fout,
                  const void* digits, int lanes, int slots, int n,
                  void* stream) {
  if (lanes <= 0 || WARP % lanes || slots <= 0 || slots % 2 ||
      slots > GLOBAL || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * row_words(slots) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + rows - 1) / rows, WARP, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(in),
      static_cast<const int2*>(prog), steps, static_cast<const int*>(fout),
      static_cast<const int*>(digits), lanes, slots, n);
  return (int)cudaGetLastError();
}

}  // namespace program
