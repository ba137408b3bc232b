// fp_mul_lanes.cu — a probe, not on any path: one Fp product spread over
// the 4 lanes of a row group, against csrc/fp381.cuh's one-thread product,
// each in a chain of dependent squarings (the shape of a fixed-exponent
// pow, the critical path of kernels K18 and K19).
//
// The 4-lane product computes exactly fp381::mul's integers — the same
// column sums, carry rounds and folds; integer arithmetic is exact, so the
// order of additions cannot change a bit.  Lane q of a group owns the
// columns 8q..8q+7 and 32+8q..32+8q+7 and, at the end, the output limbs
// 8q..8q+7.
// - conv: column 8q+t = Σ_j b[j]·a[8q+t−j].  The operand a is held as a
//   lane-relative window L[s] = a[8q+s] (H[s] = a[8q+32+s] for the high
//   columns), built from the lanes' own blocks by shuffles, so every
//   register index is a compile-time constant; b is all-gathered.
// - carry rounds: x'[i] = (x[i] & MASK) + (x[i−1] >> 12) needs only the
//   previous column's value, one shuffle from the neighbouring lane.
// - folds: the high columns (and column 64) are broadcast by shuffles;
//   each lane folds them into its own 8 limbs, the fold constants in
//   shared memory (the lanes of a warp read different rows of them).
//
// Kernels: chain1_kernel, a thread a row, acc ← acc² by fp381::mul_n
// `iters` times; chain4_kernel, 4 lanes a row (8 rows a one-warp block),
// the same chain by mul4.  Layout: rows [n, 32] int32 in and out.
// Build and run: tools/fp_mul_lanes_probe.py (nvcc, ctypes).

#include "fp381.cuh"

namespace {

using fp381::LB;
using fp381::MASK;
using fp381::NL;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int FROWS = 33;   // the fold rows a product uses (columns 32..64)

__device__ __forceinline__ int from_below(int v, int d, int q) {
  const int r = __shfl_up_sync(FULL, v, d, 4);
  return q >= d ? r : 0;
}

__device__ __forceinline__ int from_above(int v, int d, int q) {
  const int r = __shfl_down_sync(FULL, v, d, 4);
  return q + d < 4 ? r : 0;
}

__device__ __forceinline__ int from_lane(int v, int src) {
  return __shfl_sync(FULL, v, src, 4);
}

// one carry round over 8 consecutive columns; `prev` is the original value
// of the column before them
__device__ __forceinline__ void carry8(int* x, int prev) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int v = x[t];
    x[t] = (v & MASK) + (prev >> LB);
    prev = v;
  }
}

// o = this lane's block of fp381::mul(a, b): a given as the lanes' own
// blocks own[8] (limbs 8q..8q+7), b as all 32 limbs; fc the fold
// constants in shared memory.  o may alias own.
//
// Window indices m = s + 31: L[m] = a[8q+s] holds lane q−d's block at
// s = −8d..−8d+7 (zero below lane 0 and for d = 4); H[m] = a[8q+32+s]
// holds lane q+d's block at s = 8d−32..8d−25 (zero above lane 3, and for
// s ≥ 0, where the index passes 31).
__device__ __forceinline__ void mul4(int* o, const int* own, const int* b,
                                     int q, const int (*fc)[NL]) {
  int L[39], H[39];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    L[31 + k] = own[k];
    L[23 + k] = from_below(own[k], 1, q);
    L[15 + k] = from_below(own[k], 2, q);
    L[7 + k] = from_below(own[k], 3, q);
    if (k) L[k - 1] = 0;
    if (k) H[k - 1] = own[k];
    H[7 + k] = from_above(own[k], 1, q);
    H[15 + k] = from_above(own[k], 2, q);
    H[23 + k] = from_above(own[k], 3, q);
    H[31 + k] = 0;
  }
  // conv: 8 low and 8 high columns
  int lo[8], hi[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    int s = 0, u = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      s += b[j] * L[t - j + 31];
      u += b[j] * H[t - j + 31];
    }
    lo[t] = s;
    hi[t] = u;
  }
  // carry_round<63> (column 63 starts at 0, as conv leaves it in effect),
  // then carry_round<64>, which also makes column 64 of column 63
  int c64 = 0;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const int p_lo = from_below(lo[7], 1, q);
    const int p_up = from_below(hi[7], 1, q);
    const int c31 = from_lane(lo[7], 3);
    const int c63 = from_lane(hi[7], 3);
    if (round) c64 = c63 >> LB;
    carry8(lo, p_lo);
    carry8(hi, q ? p_up : c31);
  }
  // fold<65>: limb i += Σ_j column(32 + j)·FOLDC[j][i]
#pragma unroll
  for (int src = 0; src < 4; ++src) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int h = from_lane(hi[k], src);
      const int* f = fc[8 * src + k] + 8 * q;
#pragma unroll
      for (int t = 0; t < 8; ++t) lo[t] += h * f[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) lo[t] += c64 * fc[32][8 * q + t];
  // 5 × (carry_round<32>, carry_round<33>, fold<34>)
#pragma unroll 1
  for (int it = 0; it < 5; ++it) {
    int p = from_below(lo[7], 1, q);
    int x32 = from_lane(lo[7], 3) >> LB;
    carry8(lo, p);
    p = from_below(lo[7], 1, q);
    const int c31 = from_lane(lo[7], 3);
    const int x33 = x32 >> LB;
    x32 = (x32 & MASK) + (c31 >> LB);
    carry8(lo, p);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      lo[t] += x32 * fc[0][8 * q + t] + x33 * fc[1][8 * q + t];
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t] = lo[t];
}

__global__ void __launch_bounds__(WARP)
chain1_kernel(int* __restrict__ out, const int* __restrict__ in, int n,
              int iters) {
  const int r = blockIdx.x * WARP + threadIdx.x;
  if (r >= n) return;
  int acc[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) acc[k] = in[(size_t)r * NL + k];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) fp381::mul_n(acc, acc, acc);
#pragma unroll
  for (int k = 0; k < NL; ++k) out[(size_t)r * NL + k] = acc[k];
}

__global__ void __launch_bounds__(WARP)
chain4_kernel(int* __restrict__ out, const int* __restrict__ in, int n,
              int iters) {
  __shared__ int fc[FROWS][NL];
  for (int i = threadIdx.x; i < FROWS * NL; i += WARP) {
    fc[i / NL][i % NL] = fp381::FOLDC[i / NL][i % NL];
  }
  __syncthreads();
  const int q = threadIdx.x % 4;
  const int r = blockIdx.x * (WARP / 4) + threadIdx.x / 4;
  const int rr = r < n ? r : n - 1;
  int own[8], b[NL];
#pragma unroll
  for (int k = 0; k < 8; ++k) own[k] = in[(size_t)rr * NL + 8 * q + k];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int src = 0; src < 4; ++src) {
#pragma unroll
      for (int k = 0; k < 8; ++k) b[8 * src + k] = from_lane(own[k], src);
    }
    mul4(own, own, b, q, fc);
  }
  if (r < n) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[(size_t)r * NL + 8 * q + k] = own[k];
  }
}

}  // namespace

// lanes 1: chain1_kernel, 4: chain4_kernel.  Returns the cudaError of the
// launch.
extern "C" int charon_probe_chain(int lanes, void* out, const void* in, int n,
                                  int iters, void* stream) {
  if (n <= 0 || iters < 0 || (lanes != 1 && lanes != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = lanes == 1 ? WARP : WARP / 4;
  auto kernel = lanes == 1 ? chain1_kernel : chain4_kernel;
  kernel<<<(n + rows - 1) / rows, WARP, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int*>(in), n, iters);
  return (int)cudaGetLastError();
}
