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
//           their squares; then the kernel's epilogue, the exact tests
//           α = −1 and root² = v (fp381's sub and is_zero, the two
//           coefficients on two lanes) and the select → the root and an
//           ok byte a row (cuda_h2c `f2_sqrt_rows`; their plain version
//           `sqrt_select_plain`);
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
// fout one code a output plane; out [out planes, 32, n] (sqrt: the root
// [2, 32, n] and ok [n] uint8).
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

// The sqrt program's output planes (miller_program.sqrt_dag): α, root_u,
// root_b, root_u², root_b², an Fp2 each; its input block's v (planes 0,
// 1).
constexpr int SQ_ALPHA = 0, SQ_ROOT_U = 2, SQ_ROOT_B = 4, SQ_SQ_U = 6,
              SQ_SQ_B = 8;

// SQRT = 1: the root's exact boundary after the program — α = −1 (the
// root is root_u, else root_b) and root² = v, each an exact zero test of
// the difference, c0 and c1 on two lanes of the row's group — then the
// chosen root's 2 planes and the ok byte.  SQRT = 0: the program's output
// planes as they are.
template <int SQRT>
__global__ void __launch_bounds__(WARP)
f2_chain_program_kernel(int* __restrict__ out, unsigned char* __restrict__ ok,
                        const int* __restrict__ in,
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
  if (SQRT) {
    // −1 = (p − 1, 0): p's canonical digits less one
    int m1 = 1;
#pragma unroll 1
    for (int j = lane; j < 2; j += lanes) {
      int c[NL], d[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        c[i] = j == 0 ? fp381::PMULT[1][i] - (i == 0) : 0;
      }
      fp381::sub(d, program::operand(fout[SQ_ALPHA + j], sm, gin), c);
      m1 &= fp381::is_zero(d);
    }
    m1 = program::group_and(m1, lanes);
    int good = 1;
#pragma unroll 1
    for (int j = lane; j < 2; j += lanes) {
      int d[NL];
      fp381::sub(d,
                 program::operand(fout[(m1 ? SQ_SQ_U : SQ_SQ_B) + j], sm,
                                  gin),
                 gin + j * NL);
      good &= fp381::is_zero(d);
    }
    good = program::group_and(good, lanes);
    if (r < n) {
      const int root = m1 ? SQ_ROOT_U : SQ_ROOT_B;
#pragma unroll 1
      for (int i = lane; i < 2 * NL; i += lanes) {
        out[(size_t)i * n + r] =
            program::operand(fout[root + i / NL], sm, gin)[i % NL];
      }
      if (lane == 0) ok[r] = (unsigned char)good;
    }
  } else if (r < n) {
#pragma unroll 1
    for (int i = lane; i < out_planes * NL; i += lanes) {
      const int* e = program::operand(fout[i / NL], sm, gin);
      out[(size_t)i * n + r] = e[i % NL];
    }
  }
}

}  // namespace

// ok == nullptr: the program's out_planes planes into out; else the sqrt
// program's root (2 planes) into out and its ok byte a row into ok.
// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_f2_chain_program(void* out, void* ok, const void* in,
                                       const void* prog, int steps,
                                       const void* fout, int in_planes,
                                       int out_planes, int lanes, int slots,
                                       int n, void* stream) {
  if (lanes <= 0 || WARP % lanes || slots <= 0 || slots % 2 ||
      slots > program::GLOBAL || n <= 0 || in_planes <= 0 ||
      out_planes <= 0 || (ok && out_planes != 10)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * program::row_words(slots) * (int)sizeof(int);
  auto kernel = ok ? f2_chain_program_kernel<1> : f2_chain_program_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + rows - 1) / rows, WARP, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<unsigned char*>(ok),
      static_cast<const int*>(in), static_cast<const int2*>(prog), steps,
      static_cast<const int*>(fout), in_planes, out_planes, lanes, slots, n);
  return (int)cudaGetLastError();
}
