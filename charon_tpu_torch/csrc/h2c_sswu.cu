// h2c_sswu.cu — kernel K24: the head of hash-to-G2's map, from a row's u
// to SSWU's fraction and both square-root radicands, in ONE launch, a
// group of lanes per row.
//
// Replaces: K8 (h2c.cu `h2c_sswu_kernel`, one thread a row: the JAX
// package's charon_tpu/ops/pallas_h2c.py `_h2c_sswu_kernel` :285,
// `_sswu_body` :172-209) on the path, and the two flags the JAX package's
// `pack_messages` computes per row on the host in Fp2 arithmetic: the
// exceptional flag tv1 = 0 and RFC 9380's sgn0(u), which K23 reads.
//
// What it computes, row by row:
//   prologue  u into the row's pinned slot pair; fp381::canon of c0 and
//             c1 on two lanes, ANDed over the group: the exceptional flag
//             exc = (u ≡ 0) — tv1 = Z²u⁴ + Zu² is 0 exactly there, since
//             Z·u² = −1 has no root (−1 is a square in Fp2, Z = −(2 + i)
//             is not: its norm 5 is a non-residue mod p) — and sgn0(u),
//             the parity of canonical c0, or of canonical c1 where c0 is
//             0 (K23's code);
//   body      SSWU as ops/miller_program.py's straight-line `sswu_dag`:
//             every op on the operands K8 gives it, so every value keeps
//             its bits; xd's choice between −A'·tv1 and Z·A' a SEL whose
//             digit is exc (where K8 tests its flag); program.cuh's
//             interpreter on the row's group of lanes, the six Fp2
//             constants one block in device memory that every row reads
//             (the program's input planes);
//   epilogue  the five output pairs and the sgn0(u) row.
// The plain version, `cuda_h2c.sswu_head_plain`, is the same prologue in
// plain tensor code around the program executed on tensors: bit for bit,
// and bit for bit K8 (and JAX's `_sswu_body`) given the host's flags.
//
// Layout: u [2, 32, n] int32; consts [12, 32] int32 (miller_program.SW_ONE
// ..); the program [steps, lanes] int2; fout the 10 output planes' codes;
// out [10, 32, n]; sgn [n] int32.
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// (chip_smoke.py's OPS table): K8's 10 Fp2 products, 4 squares and 4 sums
// a row, the product −A'·tv1 where the flag is clear (the program runs it
// on every row, and the SEL picks after it) and the prologue's two
// canonicalisations.  A slot-start batch is 128 rows and a 2,048-message
// batch 4,096: at the card's full rate ~0.001 and ~0.02 ms.  K8 ran one
// thread a row through a serial chain of 14 Fp2 operations (255
// registers, 568 B spilled), a lone warp on each of 4–128 SMs, so the
// chain's latency was the launch.  Here the independent products run side
// by side on the row's lanes — the chain is 9 products deep — and the
// row's values live in shared-memory slots; the slots a row stay few (the
// launch shares the prep stream's SMs with the launch thread's kernels).

#include "program.cuh"
#include "attrs.cuh"

namespace {

using fp381::NL;

constexpr int WARP = 32;
// miller_program.SW_U: the pinned pair of u
constexpr int SW_U = 0;

__device__ __forceinline__ int* slot(int* sm, int code) {
  return sm + (code >> 1) * program::PAIRW + (code & 1) * NL;
}

__global__ void __launch_bounds__(WARP)
h2c_sswu_head_kernel(int* __restrict__ out, int* __restrict__ sgn,
                     const int* __restrict__ u,
                     const int* __restrict__ consts,
                     const int2* __restrict__ prog, int steps,
                     const int* __restrict__ fout, int lanes, int slots,
                     int n) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int r = blockIdx.x * (WARP / lanes) + grp;
  const int rr = r < n ? r : n - 1;
  int* sm = smem + grp * program::row_words(slots);
  // prologue: u (planes 0–1)
#pragma unroll 1
  for (int i = lane; i < 2 * NL; i += lanes) {
    slot(sm, SW_U + i / NL)[i % NL] = u[(size_t)i * n + rr];
  }
  __syncwarp();
  // bit 0 the parity of canonical c0, bit 1 c0 = 0, bit 2 the parity of
  // canonical c1, bit 3 c1 = 0; a lane sets the bits of its coefficient
  // and leaves the others 1, and the group ANDs them
  int bits = 15;
#pragma unroll 1
  for (int j = lane; j < 2; j += lanes) {
    int c[NL];
    fp381::canon(c, slot(sm, SW_U + j));
    int any = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) any |= c[i];
    bits &= j == 0 ? 12 | (c[0] & 1) | (any == 0) << 1
                   : 3 | (c[0] & 1) << 2 | (any == 0) << 3;
  }
  bits = program::group_and(bits, lanes);
  const int exc = (bits >> 1) & (bits >> 3) & 1;
  // body: SSWU, the SEL of xd reading exc
  program::exec<true>(prog, steps, lanes, lane, sm, consts,
                      [exc](int) { return exc; });
  if (r < n) {
#pragma unroll 1
    for (int i = lane; i < 10 * NL; i += lanes) {
      out[(size_t)i * n + r] =
          program::operand(fout[i / NL], sm, consts)[i % NL];
    }
    if (lane == 0) sgn[r] = (bits & 1) | ((bits >> 1) & (bits >> 2) & 1);
  }
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_h2c_sswu_head(void* out, void* sgn, const void* u,
                                    const void* consts, const void* prog,
                                    int steps, const void* fout, int lanes,
                                    int slots, int n, void* stream) {
  if (lanes <= 0 || WARP % lanes || slots < 2 || slots % 2 ||
      slots > program::GLOBAL || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * program::row_words(slots) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      h2c_sswu_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  h2c_sswu_head_kernel<<<(n + rows - 1) / rows, WARP, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<int*>(sgn),
      static_cast<const int*>(u), static_cast<const int*>(consts),
      static_cast<const int2*>(prog), steps, static_cast<const int*>(fout),
      lanes, slots, n);
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_h2c_sswu_attrs(int i, int threads, int smem,
                                     long long* out) {
  const void* const fns[] = {
      (const void*)h2c_sswu_head_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
