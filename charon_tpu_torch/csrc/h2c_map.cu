// h2c_map.cu — kernel K23: the tail of hash-to-G2's map, from the affine
// step's (x₁, x₂, y) to the mapped projective point on E, in ONE launch, a
// group of lanes per row.
//
// Replaces: K9 ISO3 (h2c.cu `h2c_point_kernel<ISO3>`, one thread a row:
// the JAX package's charon_tpu/ops/pallas_h2c.py `_h2c_iso3_kernel` :306)
// and the exactness glue around it in `map_to_g2_rows` (pallas_h2c.py
// :601-612, cuda_h2c.py before this kernel): x's select by ok₁, the RFC
// 9380 sgn0 sign fix of y — two exact canonicalisations and a K1
// negation of both coefficients — and the isogeny's ∞ guard, two exact
// zero tests; ~60 small PyTorch launches and 2 K1 launches a batch.
//
// What it computes, row by row:
//   prologue  x = ok₁ ? x₁ : x₂ and y into the row's pinned slot pairs;
//             sgn0(y) by RFC 9380 (the parity of canonical c0, or of
//             canonical c1 where c0 is 0: fp381::canon of each coefficient,
//             c0 and c1 on two lanes — not fp381::sgn's ZCash rule); where
//             it differs from sgn0(u), y ← −y with fp381::neg, the columns
//             of K1's negation;
//   body      the 3-isogeny as ops/miller_program.py's straight-line
//             `iso3_dag`: the four Horner evaluations of h2c.cu's
//             `horner<DEG, MONIC>` side by side, then xn·yd, y·(yn·xd) and
//             xd·yd, every op on the operands K9 gives it, so every value
//             keeps its bits; program.cuh's interpreter on the row's group
//             of lanes, the 13 coefficients one block in device memory
//             that every row reads (the program's input planes);
//   epilogue  where Z ≡ 0 (fp381::is_zero of c0 and c1 on two lanes) the
//             exact (0 : 1 : 0) of cuda_g2._INF_PLANES, else (X, Y, Z).
// The plain version, `cuda_h2c.map_tail_plain`, is the same prologue and
// epilogue in plain tensor code around the program executed on tensors:
// bit for bit, and bit for bit the JAX package's map tail.
//
// Layout: aff [6, 32, n] int32 (x₁, x₂, y, as K18's affine step writes
// them), ok1 [n] uint8, sgn [n] int32 (the host's sgn0(u)); consts [26, 32]
// int32 (miller_program.MT_XN..); the program [steps, lanes] int2; fout
// the 6 output planes' codes; out [6, 32, n].
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// (chip_smoke.py's OPS table): 13 Fp2 products and 11 sums a row, as K9,
// plus the boundary — two canonicalisations, at most one Fp2 negation and
// two zero tests.  A slot-start batch is 128 rows and a 2,048-message
// batch 4,096: at the card's full rate 0.001 and 0.02 ms.  K9 ran one
// thread a row through a serial chain of 13 products (255 registers,
// spilling), a lone warp on each of 4–128 SMs, so the chain's latency was
// the launch (0.58 ms).  Here the Horner chains run side by side on the
// row's lanes — the chain is 5 Fp2 products deep — and the boundary's
// canonicalisations split over two lanes; the slots a row stay few (the
// launch shares the prep stream's SMs with the launch thread's kernels).

#include "program.cuh"
#include "attrs.cuh"

namespace {

using fp381::NL;

constexpr int WARP = 32;
// miller_program.MT_X / MT_Y: the pinned pairs of x and y
constexpr int MT_X = 0, MT_Y = 2;

__device__ __forceinline__ int* slot(int* sm, int code) {
  return sm + (code >> 1) * program::PAIRW + (code & 1) * NL;
}

__global__ void __launch_bounds__(WARP)
h2c_map_tail_kernel(int* __restrict__ out, const int* __restrict__ aff,
                    const unsigned char* __restrict__ ok1,
                    const int* __restrict__ sgn,
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
  // prologue: x = ok₁ ? x₁ : x₂ (aff planes 0–1 or 2–3), y (planes 4–5)
  const int xsrc = ok1[rr] ? 0 : 2;
#pragma unroll 1
  for (int i = lane; i < 4 * NL; i += lanes) {
    const int pl = i / NL;
    const int src = pl < 2 ? xsrc + pl : 2 + pl;
    slot(sm, MT_X + pl)[i % NL] = aff[((size_t)src * NL + i % NL) * n + rr];
  }
  __syncwarp();
  // sgn0(y): bit 0 the parity of canonical c0, bit 1 c0 = 0, bit 2 the
  // parity of canonical c1; a lane sets the bits of its coefficient and
  // leaves the others 1, and the group ANDs them
  int bits = 7;
#pragma unroll 1
  for (int j = lane; j < 2; j += lanes) {
    int c[NL];
    fp381::canon(c, slot(sm, MT_Y + j));
    int any = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) any |= c[i];
    bits &= j == 0 ? 4 | (c[0] & 1) | (any == 0) << 1 : 3 | (c[0] & 1) << 2;
  }
  bits = program::group_and(bits, lanes);
  const int sgn0 = (bits & 1) | ((bits >> 1) & (bits >> 2) & 1);
  if (sgn0 != (sgn[rr] != 0)) {
#pragma unroll 1
    for (int j = lane; j < 2; j += lanes) {
      int* yj = slot(sm, MT_Y + j);
      fp381::neg(yj, yj);
    }
  }
  __syncwarp();
  // body: the isogeny
  program::exec<false>(prog, steps, lanes, lane, sm, consts,
                       [](int) { return 0; });
  // epilogue: Z ≡ 0 → (0 : 1 : 0)
  int inf = 1;
#pragma unroll 1
  for (int j = lane; j < 2; j += lanes) {
    inf &= fp381::is_zero(program::operand(fout[4 + j], sm, consts));
  }
  inf = program::group_and(inf, lanes);
  if (r < n) {
#pragma unroll 1
    for (int i = lane; i < 6 * NL; i += lanes) {
      out[(size_t)i * n + r] =
          inf ? i == 2 * NL
              : program::operand(fout[i / NL], sm, consts)[i % NL];
    }
  }
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_h2c_map_tail(void* out, const void* aff,
                                   const void* ok1, const void* sgn,
                                   const void* consts, const void* prog,
                                   int steps, const void* fout, int lanes,
                                   int slots, int n, void* stream) {
  if (lanes <= 0 || WARP % lanes || slots < 4 || slots % 2 ||
      slots > program::GLOBAL || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * program::row_words(slots) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      h2c_map_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  h2c_map_tail_kernel<<<(n + rows - 1) / rows, WARP, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(aff),
      static_cast<const unsigned char*>(ok1), static_cast<const int*>(sgn),
      static_cast<const int*>(consts), static_cast<const int2*>(prog), steps,
      static_cast<const int*>(fout), lanes, slots, n);
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_h2c_map_attrs(int i, int threads, int smem,
                                    long long* out) {
  const void* const fns[] = {
      (const void*)h2c_map_tail_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
