// fp_ops.cu — kernel K1: the BLS12-381 Fp ring ops, one thread per row.
//
// Replaces: charon_tpu/ops/pallas_fp.py  _mul_kernel, _add_kernel,
//           _sub_kernel, _neg_kernel and _small_kernel_factory(k)._kern.
//
// Layout: operands and result are [L, 32, R] int32 (limb axis second,
// rows last); row i = l·R + r reads limb k at (l·32 + k)·R + r, so a warp
// reads 32 consecutive rows of one limb — one 128-byte line per limb.
//
// What bounds it on an H100.  Int32 instructions, counted from fp381.cuh
// as [IMAD, other] (a product or fold term one IMAD; a partial-carry
// column three ALU instructions; a column sum one three-input add): mul
// [2,400, 1,356] per row, add [128, 422], sub and neg [160, 428],
// mul_small [224, 585].  Bytes per row: 384 for the two-operand ops, 256
// for neg and mul_small.  On compute capability 9.0 IMAD issues only on the
// FMA pipe, 64 lanes per SM per clock (CUDA C++ Programming Guide,
// arithmetic-instruction throughput table), and the four schedulers issue
// at most 128 lanes of instructions per SM per clock whatever pipe runs
// them; so a row needs max(IMAD / 64, all / 128) SM clocks, over 132 SMs ×
// 1.98 GHz (the 1,980 MHz maximum nvidia-smi reports for an H100 SXM).  The
// memory rate is 3.35 TB/s.  So mul is bound by its IMADs (0.143 ns per
// row against 0.115 ns of memory time), and add, sub, neg and mul_small by
// their bytes (0.016–0.024 ns of issue time against 0.08–0.11 ns of
// memory time).
//
// What the design does about it: every column, carry and fold stays in
// registers (fully unrolled loops over compile-time bounds); the fold
// constants sit in __constant__ memory, where a warp's threads all read
// the same FOLDC[j][i] and the constant cache broadcasts it as an IMAD
// operand; device memory sees each input limb once and each output limb
// once.  No shared memory, no synchronisation.
//
// Where it runs: since K11–K23 took its chains and its last glue (the
// verify tile's p-side negation and is_one's difference into K15 and
// K11, a hash batch's exact tests and sign fix into K18 and K23), no
// flush and no combine launches K1.  The re-check of a rejected tile
// negates its unscaled p-side with it; chip_smoke.py holds it against
// its plain versions in its kernel phase.

#include "fp381.cuh"
#include "attrs.cuh"

namespace {

enum Op { MUL = 0, ADD = 1, SUB = 2, NEG = 3, SMALL = 4 };

template <int OP>
__global__ void __launch_bounds__(128)
fp_op_kernel(int* __restrict__ out, const int* __restrict__ a,
             const int* __restrict__ b, int k, int n, int rstride) {
  using namespace fp381;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l = i / rstride;
  const int r = i - l * rstride;
  const size_t base = (size_t)l * NL * rstride;
  int x[NL], y[NL], o[NL];
  load_el(x, a + base, r, rstride);
  if (OP == MUL || OP == ADD || OP == SUB) load_el(y, b + base, r, rstride);
  if (OP == MUL) mul(o, x, y);
  if (OP == ADD) add(o, x, y);
  if (OP == SUB) sub(o, x, y);
  if (OP == NEG) neg(o, x);
  if (OP == SMALL) mul_small(o, x, k);
  store_el(out + base, o, r, rstride);
}

}  // namespace

// out = op(a, b) over n rows of row stride rstride; returns the cudaError.
extern "C" int charon_fp_op(int op, int k, void* out, const void* a,
                            const void* b, int n, int rstride,
                            void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* x = static_cast<const int*>(a);
  const int* y = static_cast<const int*>(b);
  switch (op) {
    case MUL: fp_op_kernel<MUL><<<grid, block, 0, s>>>(o, x, y, k, n, rstride); break;
    case ADD: fp_op_kernel<ADD><<<grid, block, 0, s>>>(o, x, y, k, n, rstride); break;
    case SUB: fp_op_kernel<SUB><<<grid, block, 0, s>>>(o, x, y, k, n, rstride); break;
    case NEG: fp_op_kernel<NEG><<<grid, block, 0, s>>>(o, x, y, k, n, rstride); break;
    case SMALL: fp_op_kernel<SMALL><<<grid, block, 0, s>>>(o, x, y, k, n, rstride); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_fp_ops_attrs(int i, int threads, int smem,
                                   long long* out) {
  const void* const fns[] = {
      (const void*)fp_op_kernel<MUL>,  // 0
      (const void*)fp_op_kernel<ADD>,  // 1
      (const void*)fp_op_kernel<SUB>,  // 2
      (const void*)fp_op_kernel<NEG>,  // 3
      (const void*)fp_op_kernel<SMALL>  // 4
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
