// g1_scalar_mul.cu — kernel K15: the RLC scaling of a verify tile, every
// pair row's G1 point times its 64-bit random coefficient, in ONE launch,
// a group of lanes per row.
//
// Replaces: the 32 launches per tile of kernel K6 (pairing.cu
// g1_dblsel_kernel) that cuda_pairing.g1_scalar_mul_plain iterates — the
// JAX package's charon_tpu/ops/pallas_pairing.py `g1_scalar_mul_rows`
// :520 over `_pp_g1_dblsel_kernel` :349: per 2-bit window, MSB first,
// acc ← 4·acc + T[w] with T = {P, 2P, 3P} and w = 0 keeping 4·acc.
//
// What it computes: the same ops on the same inputs as those windows
// (two complete a = 0 doublings and one complete addition of cuda_pairing
// `_g1_double` / `_g1_add`, each an fp381.cuh product, sum, difference or
// small multiple), so the result is bit-identical to the iterated plain
// version, ∞ and padding rows included.  The 32 windows are a dataflow
// graph of those ops, scheduled on the host by ops/miller_program.py
// (`g1_program`) and run by K13's interpreter (csrc/program.cuh) with its
// SEL op: per window it copies T[w] into slots (T[0] stands in as P, so
// every row runs the same addition: one instruction stream a warp), then
// keeps 4·acc where w = 0 and the sum elsewhere.  The addition a zero
// digit discards costs ~11% more int32 work than K6's branch.
//
// Layout: in [n, 11, 32] int32, a row's input block (T1 = P, T2 = 2P,
// T3 = 3P as x, y, z planes, then one and zero); the program [steps,
// lanes] int2; fout the 3 output planes' codes; digits [32, n] int32 in
// 0..3, each lane reading its row's digit of a window from device memory;
// out [3, 32, n] projective (x, y, z).
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] (chip_smoke.py's OPS table): a window is two doublings
// and, for a non-zero digit, an addition — [72,832, 54,151] with it —
// so with every digit non-zero a row is [2,330,624, 1,732,832]:
// max(IMAD / 64, all / 128) = 36,416 SM clocks a row, 0.57 ms for a
// verify tile's 4,096 rows over 132 SMs at 1.98 GHz (chip_smoke.py counts
// the additions of the run's own digits).  Device memory sees 1.9 KB a
// row: its input block, digits and output.
//
// What the design does about it: K6 ran one thread per row — 128 warps a
// tile, about one per SM — 32 launches in a row, each costing one warp's
// dependent instruction chain.  Here `lanes` threads share a row (the
// addition's six products and the doublings' four run side by side) and
// a tile is one launch; the row's values live in shared memory (the
// scheduler keeps ≤ 18 slots live; 20 slots are 2,720 B a row), so 8
// warps an SM — as many as 255 registers a thread allow — hold 8 × 32 /
// lanes rows.  The lanes and slots are the program's, chosen by
// chip_smoke.py's sweep over 2, 4 and 8 lanes: 4 lanes, 3.5–3.6 ms at a
// tile's 4,096 rows against 4.8–5.3 with 8 and 5.9–6.4 with 2
// (PERF.md).  Not yet: more rows an SM (a tile is ~1 warp a scheduler
// at 4 lanes), fewer instructions a lane (products with their operand
// sums folded in).

#include "program.cuh"
#include "attrs.cuh"

namespace {

constexpr int WARP = 32;
constexpr int IN_PLANES = 11;

__global__ void __launch_bounds__(WARP)
g1_scalar_mul_kernel(int* __restrict__ out, const int* __restrict__ in,
                     const int2* __restrict__ prog, int steps,
                     const int* __restrict__ fout,
                     const int* __restrict__ digits, int lanes, int slots,
                     int n) {
  program::run<IN_PLANES, 3, true>(out, in, prog, steps, fout, digits,
                                   lanes, slots, n);
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_g1_scalar_mul(void* out, const void* in,
                                    const void* prog, int steps,
                                    const void* fout, const void* digits,
                                    int lanes, int slots, int n,
                                    void* stream) {
  return program::launch(g1_scalar_mul_kernel, out, in, prog, steps, fout,
                         digits, lanes, slots, n, stream);
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_g1_scalar_mul_attrs(int i, int threads, int smem,
                                          long long* out) {
  const void* const fns[] = {
      (const void*)g1_scalar_mul_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
