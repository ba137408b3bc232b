// f2_chain.cu — kernel K18: each hash batch's Fp2 square root and its
// inversion-and-affine step, one launch each, a group of lanes per row.
//
// Replaces: the K7 launches (h2c.cu f2_chain_kernel<SQR|MUL|SQR4|
// SQR4MUL>) of the fixed-exponent chains — the JAX package's charon_tpu/
// ops/pallas_h2c.py `f2_pow_rows` :482, `f2_sqrt_rows` :497 and
// `f2_inv_rows` :517 over `_h2c_sqr_kernel` :290, `_h2c_mul_kernel` :294,
// `_h2c_sqr4_kernel` :298 and `_h2c_sqr4mul_kernel` :302: 14 table
// launches and ~95 window launches a pow, three pows and their glue a
// batch, 336 launches (cuda_h2c `f2_sqrt_steps`, `f2_affine_steps`).
//
// What it computes: one of three straight-line programs that
// ops/miller_program.py builds and schedules (`chain_program`) —
//   sqrt    Alg. 9 on v: a1 = v^((p−3)/4), α = a1²·v, x0 = a1·v, root_u =
//           u·x0, root_b = (α + 1)^((p−1)/2)·x0 → α, both roots and
//           their squares; the exact tests α = −1 and root² = v and the
//           select stay on the host side of the wrapper (cuda_h2c
//           `f2_sqrt_rows`);
//   inv     a⁻¹ = ā·(a·ā)^(p−2), inv(0) = 0 (`f2_inv_rows`);
//   affine  the map's step after the root: xd⁻¹, xn·xd⁻¹, Z·u²·xn·xd⁻¹
//           and root·xd⁻² (`f2_affine_rows`).
// Every exponent is a host constant, so a pow is its fixed windows — the
// table, then per window the squarings and one product — and the whole
// chain, glue included, one program with no branch.  The programs split
// each Fp2 square into 2 Fp products and each Fp2 product into 4, and the
// norm's pow runs in Fp alone (its imaginary part is zero in value), so
// lanes of a row work side by side.  The plain version
// (`miller_program.chain_run_plain`) executes the same program on PyTorch
// tensors, bit for bit.
//
// The interpreter is program.cuh's `exec`, without SEL (the programs have
// none); a program's input block and output planes differ per program,
// so this kernel takes their counts at run time.
//
// Layout: in [n, in planes, 32] int32, a row's input block (sqrt: v, one;
// inv: a; affine: xd, xn, Z·u², root); the program [steps, lanes] int2;
// fout one code a output plane; out [out planes, 32, n].
//
// What bounds it on an H100: int32 instructions.  chip_smoke.py counts
// the function's ops with its OPS table (`chain_ops`: whole Fp2 ops,
// 4-bit windows, the chosen root squared once): the root's 2.57 ms for a
// 2,048-message batch's 8,192 rows at the card's full rate, 0.080 ms for
// the slot-start batch's 256; the ops this program issues (`program_ops`)
// come to 1.22× as many IMADs.  But the chain is serial: a
// pow's squarings depend each on the last, so a row's time is its
// program's steps, and a slot-start batch fills 8–32 warps on 132 SMs.
// What the design does about it: 336 launches become 2; 2–4 lanes share
// a row (a square's two products, a product's four in one step); the
// row's values live in shared memory, 3-bit windows keeping the root's
// table at 7 entries (24 slots a row).  The lanes, slots and window width
// are the program's: chip_smoke.py's sweep chose them (PERF.md).

#include "program.cuh"

namespace {

using fp381::NL;

constexpr int WARP = 32;

__global__ void __launch_bounds__(WARP)
f2_chain_program_kernel(int* __restrict__ out, const int* __restrict__ in,
                        const int2* __restrict__ prog, int steps,
                        const int* __restrict__ fout, int in_planes,
                        int out_planes, int lanes, int slots, int n) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int r = blockIdx.x * (WARP / lanes) + grp;
  const int rr = r < n ? r : n - 1;
  int* sm = smem + grp * program::row_words(slots);
  const int* gin = in + (size_t)rr * in_planes * NL;
  program::exec<false>(prog, steps, lanes, lane, sm, gin,
                       [](int) { return 0; });
  if (r < n) {
#pragma unroll 1
    for (int i = lane; i < out_planes * NL; i += lanes) {
      const int* e = program::operand(fout[i / NL], sm, gin);
      out[(size_t)i * n + r] = e[i % NL];
    }
  }
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_f2_chain_program(void* out, const void* in,
                                       const void* prog, int steps,
                                       const void* fout, int in_planes,
                                       int out_planes, int lanes, int slots,
                                       int n, void* stream) {
  if (lanes <= 0 || WARP % lanes || slots <= 0 || slots % 2 ||
      slots > program::GLOBAL || n <= 0 || in_planes <= 0 ||
      out_planes <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * program::row_words(slots) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      f2_chain_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  f2_chain_program_kernel<<<(n + rows - 1) / rows, WARP, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(in),
      static_cast<const int2*>(prog), steps, static_cast<const int*>(fout),
      in_planes, out_planes, lanes, slots, n);
  return (int)cudaGetLastError();
}
