// straus.cu — kernel K16: the combine's whole Straus window loop (87
// windows × T shares) in ONE launch, a group of lanes per validator row.
//
// Replaces: the 87 + 87·(T − 1) launches per combine of kernel K3
// (g2.cu straus_step_kernel<HEAD>) that cuda_g2.straus_steps iterates —
// the JAX package's charon_tpu/ops/pallas_g2.py `straus_combine` :797
// over `_dbl3sel_s_kernel` :706 (acc ← 8·acc ± T[|d|] for share 0) and
// `_addsel_s_kernel` :700 (acc ← acc ± T[|d|] for shares 1..T − 1), d a
// balanced base-8 digit in [−4, 3], d = 0 keeping acc.
//
// What it computes: acc = Σ_k Σ_i d_{k,i}·8^(86−i)·P_k per row, the same
// ops on the same inputs as those steps (three complete doublings a
// window, one complete addition a share, each an fp381.cuh function), so
// the result is bit-identical to the iterated plain steps, ∞ and padding
// rows included.  Two programs scheduled on the host by
// ops/miller_program.py (`straus_programs`) run through program.cuh's
// interpreter: HEAD (acc ← 8·acc) once a window, TAIL (SEL T[|d|] from
// the share's block, Y negated by a LIN 0 − y and a SEL on the sign, one
// addition, SEL keeping acc where d = 0) once a share.  The accumulator
// stays in the row's slots 0–5 for the whole loop: each run's outputs
// are copied there (`run_program`; the scheduler keeps them outside
// those slots), and the result is written once.  A program addresses at most
// 64 input planes and 256 digit windows, so TAIL addresses ONE share's
// block — T1..T4 as 24 planes — and the three fields of one digit
// (ST_ABS = |d| mod 4, T4 standing in for 0 and 4; ST_NEG = d < 0;
// ST_NZ = d ≠ 0), and the kernel points the block and the digit at
// share k before each run.
//
// Layout: tables [T·n, 24, 32] int32, row k·n + r holding share k's four
// table points of row r (the wrapper repacks straus_tables' four [6, 32,
// T·n] batches once a combine); digits [nwin, T·n] int32, rows t-major;
// live [nwin, T] int32, 0 where share k's digits of window i are 0 on
// every row; the two programs [steps, lanes] int2 and their 6 output
// codes; out [6, 32, n].
//
// What bounds it on an H100: int32 instructions.  Counted from fp381.cuh
// as [IMAD, other] (chip_smoke.py's OPS table): a doubling [51,616,
// 48,034], an addition [83,392, 83,458]; a window is three doublings per
// row and one addition per non-zero digit.  On the combine's digits (one
// index set for every validator: 164 of the 609 (window, share) digits
// non-zero) the 10,240 rows need ≈ 16 ms at 132 SMs × 1.98 GHz; on
// random digits ≈ 36 ms.  Device memory sees the digits, a table point
// for each non-zero digit and the output: ≈ 1.3 GB on the combine's
// digits, 0.4 ms.
//
// What the design does about it: K3 ran one thread per row, 10,240
// threads in 609 launches, each costing a lone warp's dependent chain.
// Here the loop runs on the device: `lanes` threads share a row (a
// doubling's four products, an addition's six, side by side), the row
// lives in shared memory, and every warp skips a TAIL run whose digits
// are 0 on every row of the batch (SEL would keep acc there, so the bits
// are the same) — on the combine 445 of the 609.  The skip is the same
// for the whole grid, not voted a warp: the warps of an SM then run the
// same code at the same time, and a warp of zero-digit padding rows that
// skipped on its own ran out of step with the rest and slowed its SM
// (tools/straus_rounds_probe.py).  Lanes and slots are the programs',
// chosen by chip_smoke.py's sweep over 2, 4 and 8 lanes.

#include "program.cuh"

namespace {

using fp381::NL;

constexpr int WARP = 32;
constexpr int IN_PLANES = 24;   // one share's T1..T4 as (x, y, z) planes
constexpr int ACC = 6;          // the accumulator's planes: slots 0..5
// TAIL's SEL windows (ops/miller_program.py ST_ABS, ST_NEG, ST_NZ)
constexpr int ST_ABS = 0, ST_NEG = 1;

__device__ __forceinline__ int* slot(int* sm, int s) {
  return const_cast<int*>(program::operand(s, sm, nullptr));
}

// Run HEAD or TAIL on the row's slots, then copy its outputs into the
// accumulator's slots.  One copy of the interpreter serves both programs
// (HEAD has no SEL, so the digit it is given is never read): with a copy
// each, the warps of an SM that ran different programs at once were
// slower (see PERF.md).
static __device__ __noinline__ void run_program(
    const int2* __restrict__ prog, int steps, const int* __restrict__ fout,
    int lanes, int lane, int* sm, const int* gin, int d) {
  const int ad = d < 0 ? -d : d;
  program::exec<true>(prog, steps, lanes, lane, sm, gin, [=](int w) {
    return w == ST_ABS ? (ad & 3) : w == ST_NEG ? d < 0 : d != 0;
  });
#pragma unroll 1
  for (int i = lane; i < ACC * NL; i += lanes) {
    slot(sm, i / NL)[i % NL] = slot(sm, fout[i / NL])[i % NL];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WARP)
straus_msm_kernel(int* __restrict__ out, const int* __restrict__ tables,
                  const int* __restrict__ digits,
                  const int* __restrict__ live,
                  const int2* __restrict__ head, int head_steps,
                  const int* __restrict__ head_out,
                  const int2* __restrict__ tail, int tail_steps,
                  const int* __restrict__ tail_out, int nwin, int t_count,
                  int n, int lanes, int slots) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int r = blockIdx.x * (WARP / lanes) + grp;
  const int rr = r < n ? r : n - 1;
  int* sm = smem + grp * program::row_words(slots);
  // acc = ∞ = (0 : 1 : 0): limb 0 of y's c0 is 1, every other limb 0
#pragma unroll 1
  for (int i = lane; i < ACC * NL; i += lanes) {
    slot(sm, i / NL)[i % NL] = i == 2 * NL;
  }
  __syncwarp();
  const size_t rt = (size_t)t_count * n;
#pragma unroll 1
  for (int i = 0; i < nwin; ++i) {
    run_program(head, head_steps, head_out, lanes, lane, sm, nullptr, 0);
#pragma unroll 1
    for (int k = 0; k < t_count; ++k) {
      if (!live[i * t_count + k]) continue;
      const size_t row = (size_t)k * n + rr;
      run_program(tail, tail_steps, tail_out, lanes, lane, sm,
                  tables + row * IN_PLANES * NL, digits[i * rt + row]);
    }
  }
  if (r < n) {
#pragma unroll 1
    for (int i = lane; i < ACC * NL; i += lanes) {
      out[(size_t)i * n + r] = slot(sm, i / NL)[i % NL];
    }
  }
}

}  // namespace

// Returns the cudaError of the launch (or of the shared-memory attribute).
extern "C" int charon_straus_msm(void* out, const void* tables,
                                 const void* digits, const void* live,
                                 const void* head,
                                 int head_steps, const void* head_out,
                                 const void* tail, int tail_steps,
                                 const void* tail_out, int nwin, int t_count,
                                 int n, int lanes, int slots, void* stream) {
  if (lanes <= 0 || WARP % lanes || slots <= 0 || slots % 2 ||
      slots > program::GLOBAL || n <= 0 || nwin <= 0 || t_count <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = WARP / lanes;
  const int bytes = rows * program::row_words(slots) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      straus_msm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  straus_msm_kernel<<<(n + rows - 1) / rows, WARP, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(tables),
      static_cast<const int*>(digits), static_cast<const int*>(live),
      static_cast<const int2*>(head),
      head_steps, static_cast<const int*>(head_out),
      static_cast<const int2*>(tail), tail_steps,
      static_cast<const int*>(tail_out), nwin, t_count, n, lanes, slots);
  return (int)cudaGetLastError();
}
