// g1_tables.cu — kernel K20: the RLC tables 2P and 3P of a verify tile's
// pair rows in ONE launch, a group of lanes per row.
//
// Replaces: the 31 K1 launches a tile (csrc/fp_ops.cu) of
// `curve.double_point` and `add_points` on FP_OPS — the JAX backend's
// charon_tpu/tbls/backend_tpu.py `_rlc_g1_tables_kernel` :543, whose
// field ops reach charon_tpu/ops/pallas_fp.py `_mul_kernel` :78,
// `_add_kernel` :97, `_sub_kernel` :104 and `_small_kernel_factory`
// :120.
//
// What it computes: per row P = (x, y, z), 2P by the complete a = 0
// doubling and 3P = 2P + P by the complete addition (RCB16 Algs 9 / 7,
// b₃ = 12), the ops of `cuda_pairing._g1_double` / `_g1_add` — one
// straight-line program of fp381.cuh products, sums, differences and
// small multiples (ops/miller_program.py `g1_tables_program`, 16 steps at
// 4 lanes), run by program.cuh's interpreter with K15's settings.  The
// plain version (`cuda_pairing.g1_tables_plain`) executes the same program
// on PyTorch tensors, bit for bit; it equals the K1 chain by value (other
// redundant limbs), ∞ rows included.
//
// Layout: in [n, 3, 32] int32, a row's (x, y, z); the program [steps,
// lanes] int2; fout the 6 output planes' codes; out [6, 32, n]: 2P's
// planes, then 3P's.
//
// What bounds it on an H100: int32 instructions — a doubling and an
// addition, 20 Fp products a row (chip_smoke.py counts them): ~0.01 ms
// for a tile's 4,096 rows at the card's full rate; device memory sees 1.1
// KB a row.  What the design does about it: the 31 launches, each ~0.03–
// 0.06 ms of launch latency at these shapes, become one, whose 4 lanes a
// row run the doubling's four products and the addition's six side by
// side.

#include "program.cuh"

namespace {

constexpr int WARP = 32;
constexpr int IN_PLANES = 3;

__global__ void __launch_bounds__(WARP)
g1_tables_kernel(int* __restrict__ out, const int* __restrict__ in,
                 const int2* __restrict__ prog, int steps,
                 const int* __restrict__ fout, const int* __restrict__ digits,
                 int lanes, int slots, int n) {
  program::run<IN_PLANES, 6, false>(out, in, prog, steps, fout, digits,
                                    lanes, slots, n);
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_g1_tables(void* out, const void* in, const void* prog,
                                int steps, const void* fout, int lanes,
                                int slots, int n, void* stream) {
  return program::launch(g1_tables_kernel, out, in, prog, steps, fout,
                         nullptr, lanes, slots, n, stream);
}
