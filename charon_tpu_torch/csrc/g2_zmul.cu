// g2_zmul.cu — kernel K17: one [|x|]-multiply of hash-to-G2's cofactor
// clearing in ONE launch, a group of lanes per point row.
//
// Replaces: the 2 K2 launches (g2.cu g2_step_kernel: the table {Q, 2Q,
// 3Q}) and 32 K10 launches (g2.cu g2_sel_kernel<1>, one 2-bit window of
// |x| each) that cuda_h2c.zmul_steps makes — the JAX package's
// charon_tpu/ops/pallas_h2c.py `_zmul` :537 over pallas_g2.py `dblsel`
// :501 / `_dblsel_kernel` :389 (acc ← 4·acc + T[w], w = 0 keeping 4·acc).
//
// What it computes: [|x|]Q per row, |x| = 0xd201000000010000, from ∞:
// the same doublings and additions on the same inputs as those launches
// (each an fp381.cuh function), so the result is bit-identical to them,
// ∞ rows included.  The windows of |x| are host constants, the same for
// every row, so the whole multiply — one doubling and one addition for
// the table, two doublings a window, one addition for each of the 5
// non-zero windows (a zero window keeps 4·acc, so it needs none) — is ONE
// straight-line program with no SEL, scheduled by ops/miller_program.py
// (`zmul_program`) and run by program.cuh's interpreter.
//
// Layout: in [n, 10, 32] int32, a row's input block (Q as x, y, z Fp2
// planes, then the Fp2 constants one and zero); the program [steps,
// lanes] int2; fout the 6 output planes' codes; out [6, 32, n].
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] (chip_smoke.py's OPS table): 65 doublings and 6
// additions a row, [3,855,392, 3,622,958], so max(IMAD / 64, all / 128)
// = 60,241 SM clocks a row: 0.94 ms for a hash batch's 4,096 rows over
// 132 SMs at 1.98 GHz.  Device memory sees ~2 KB a row.
//
// What the design does about it: K10 ran one thread per row — a 2,048-
// message batch is 64 warps, one warp on each of 64 SMs — 32 launches in
// a row, each a lone warp's dependent chain.  Here `lanes` threads share
// a row (a doubling's four products side by side), the row's values live
// in shared memory, and the 34 launches are one; the cofactor clearing
// also runs [|x|]P and [|x|]ψ(P) as one launch over both row sets.

#include "program.cuh"
#include "attrs.cuh"

namespace {

constexpr int WARP = 32;
constexpr int IN_PLANES = 10;

__global__ void __launch_bounds__(WARP)
g2_zmul_kernel(int* __restrict__ out, const int* __restrict__ in,
               const int2* __restrict__ prog, int steps,
               const int* __restrict__ fout, const int* __restrict__ digits,
               int lanes, int slots, int n) {
  program::run<IN_PLANES, 6, false>(out, in, prog, steps, fout, digits,
                                    lanes, slots, n);
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_g2_zmul(void* out, const void* in, const void* prog,
                              int steps, const void* fout, int lanes,
                              int slots, int n, void* stream) {
  return program::launch(g2_zmul_kernel, out, in, prog, steps, fout,
                         nullptr, lanes, slots, n, stream);
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_g2_zmul_attrs(int i, int threads, int smem,
                                    long long* out) {
  const void* const fns[] = {
      (const void*)g2_zmul_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
