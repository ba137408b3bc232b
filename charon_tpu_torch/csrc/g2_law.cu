// g2_law.cu — kernel K22: K2's launch sequences on the complete G2 law,
// each in ONE launch: the combine's Straus tables and hash-to-G2's group
// law around the cofactor clearing.
//
// Replaces: the K2 launches (g2.cu g2_step_kernel, one complete doubling
// or addition a row each; the JAX package's charon_tpu/ops/pallas_g2.py
// `_dbl_kernel` :350 / `_add_kernel` :354) of
//   - the combine's tables P → 2P, 3P = 2P + P, 4P = 2·2P (three
//     launches over 71,680 rows; pallas_g2.py :811-813);
//   - a hash batch's halves' sum R = M₀ + M₁ and the clearing's doubling
//     2R (pallas_h2c.py `hash_to_g2_rows` :614 / `clear_cofactor_rows`
//     :550), and since the K9 redesign the clearing's ψ(R) and ψ²(2R)
//     (K9 PSI, h2c.cu `h2c_point_kernel<PSI>`, two launches: pallas_h2c.py
//     `_h2c_psi_kernel` :311): each ψ a conjugation — a copy of c0 and
//     fp381 neg's columns for c1 as LIN forms — and two MUL2 by the ψ
//     constants, which ride in each row's input block;
//   - the clearing's five additions ((t1 + t0) − R) + (−[|x|]ψ(R) − ψ(R))
//     + ψ²(2R), whose three point negations K1 launched (6 fp_neg).
//
// What it computes: the same doublings and additions on the same inputs
// as those launches, each fp381.cuh's function (the negations LIN forms
// with fp381 neg's columns), so every output is bit-identical to the K2
// sequence, ∞ rows included.  Each sequence is one straight-line program
// with no SEL (ops/miller_program.py `law_program`: "tables", "pre",
// "post"), scheduled on the host and run by program.cuh's interpreter, a
// group of 8 lanes a row — the fastest of chip_smoke.py's sweep at every
// shape of the path; at the combine's rows also faster than the three
// steps fused in one thread a row, K2's form, which the sweep tried
// (PERF.md §6).
//
// Layout: in [n, IN_PLANES, 32] int32, a row's input block (its points'
// x, y, z as Fp2 planes, 6 a point); the program [steps, lanes] int2;
// fout the output planes' codes; out [OUT_PLANES, 32, n].
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// (chip_smoke.py's OPS table): the tables are 2 doublings and 1 addition
// a row, 0.80 ms for the combine's 71,680 rows at the card's full rate;
// a hash batch's programs are 1 doubling + 1 addition and 5 additions
// a message.  Device memory sees 3 KB a tables row (in, then out).
//
// What the design does about it: K2 runs one thread a row at 255
// registers and 4–4.6 KB of stack, each launch a round trip of its
// points through device memory (three at the combine's 71,680 rows), and
// each of a hash batch's 7 launches a lone warp's chain at 64 or 2,048
// rows.  Here a batch's steps are one launch, the row's values stay on
// the SM, and the interpreter's lanes run a step's independent Fp2
// products side by side, which shortens the chain at a hash batch's
// rows (the clearing's additions: 2.61 ms as K2 launches, 0.53 on 8
// lanes at 64 rows on an H100).  At the combine's 71,680 rows the SMs
// are full either way and the work is what counts: K22 gains only the
// round trips (6.21–6.31 ms against 6.92–6.99).

#include "program.cuh"
#include "attrs.cuh"

namespace {

constexpr int WARP = 32;

template <int IN_PLANES, int OUT_PLANES>
__global__ void __launch_bounds__(WARP)
g2_law_kernel(int* __restrict__ out, const int* __restrict__ in,
              const int2* __restrict__ prog, int steps,
              const int* __restrict__ fout, const int* __restrict__ digits,
              int lanes, int slots, int n) {
  program::run<IN_PLANES, OUT_PLANES, false>(out, in, prog, steps, fout,
                                             digits, lanes, slots, n);
}

}  // namespace

// kind 0: the tables (6 planes in, 18 out); 1: the halves' sum, its
// double, ψ of the sum and ψ² of the double (12 planes and ψ's two Fp2
// constants in, 24 out); 2: the clearing's additions (36, 6).  Returns
// the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_g2_law(int kind, void* out, const void* in,
                             const void* prog, int steps, const void* fout,
                             int lanes, int slots, int n, void* stream) {
  const program::Kernel kernels[3] = {g2_law_kernel<6, 18>,
                                      g2_law_kernel<16, 24>,
                                      g2_law_kernel<36, 6>};
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  return program::launch(kernels[kind], out, in, prog, steps, fout,
                         nullptr, lanes, slots, n, stream);
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_g2_law_attrs(int i, int threads, int smem,
                                   long long* out) {
  const void* const fns[] = {
      (const void*)g2_law_kernel<6, 18>,  // 0
      (const void*)g2_law_kernel<16, 24>,  // 1
      (const void*)g2_law_kernel<36, 6>  // 2
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
