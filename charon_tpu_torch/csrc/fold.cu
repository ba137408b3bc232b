// fold.cu — kernel K14: the product fold of a verify tile, the product of
// all its R Miller rows' Fp12 values (R a power of two), in ONE launch.
//
// Replaces: the log₂ R launches per tile of the K5 F12MUL kernel
// (pairing.cu f12_step_kernel<2>) that cuda_pairing.fold_product_plain
// sequences — 12 at a tile's 4,096 rows; the JAX package's fold in
// charon_tpu/ops/pallas_pairing.py `miller_product_tiled` :535 over
// `_pp_f12mul_kernel` :345: out[i] = f[i]·f[i + s] for s = R/2, R/4 … 1.
//
// What it computes: the same products in the same pairing order as that
// sequence, each fp381::f12_mul's arithmetic split over a warp by
// csrc/f12_warp.cuh (`w_mul`, K11's product), so the result is
// bit-identical to the plain fold.  A row flagged in `drop` (infinity
// members, rejected entries, padding: cuda_pairing.mask_rows) is read as
// Fp12 one.
//
// Layout: in [12, 32, R] int32 planes (plane m = (k·3 + j)·2 + c, the K5
// layout); drop [R] bytes or null; scratch [R, 384] int32, two halves of
// R/2 rows in the F12 layout (384 contiguous words a row), between which
// the levels' rows ping-pong; out [12, 32, 1].
//
// What bounds it on an H100: int32 instructions for the R − 1 products,
// each the K5 F12MUL [133,344, 152,494] (chip_smoke.py's OPS table):
// 0.035 ms for a tile's 4,095 over 132 SMs at 1.98 GHz — and the chain:
// the log₂ R levels depend on each other, so at least 12 dependent warp
// products (~0.05 ms each at the issue rate of one warp, from K11's 26.74
// ms for ~350 of them and a 609-product inverse) whatever the rows.
//
// What the design does about it: K5 ran one thread per product, 12
// launches a tile, each costing one thread's whole dependent Fp12 chain
// (the last 10 levels have almost no rows).  Here a product takes a warp
// (18 Fp2 products one per lane), the grid is persistent — as many
// one-warp blocks as fit the SMs together, each looping over its share of
// a level's products — and the levels run in one cooperative launch with
// a grid-wide barrier between them.  A level's operands load from device
// memory into the warp's shared memory; the rows a level writes are read
// by other SMs after the barrier, so they are read with ld.global.cg (L2,
// not a stale L1 line from an earlier level).  Measured times: PERF.md.

#include <cooperative_groups.h>

#include "f12_warp.cuh"
#include "attrs.cuh"

namespace {

using fp381::F12;
using fp381::NL;
using f12w::w_mul;

constexpr int WARP = 32;
constexpr int F12W = 12 * NL;   // words an Fp12 row

struct FoldWs {
  F12 a, b;      // a level's two operands; the product lands in a
  f12w::Ws w;
};

// Row r of the [12, 32, n] planes, or Fp12 one where drop[r].
__device__ __forceinline__ void load_plane_row(F12& o, const int* in,
                                               const unsigned char* drop,
                                               int r, int n, int lane) {
  int* e = reinterpret_cast<int*>(&o);
  const bool one = drop != nullptr && drop[r];
#pragma unroll 1
  for (int i = lane; i < F12W; i += WARP) {
    e[i] = one ? (i == 0) : in[(size_t)i * n + r];
  }
}

__device__ __forceinline__ void load_row(F12& o, const int* row, int lane) {
  int* e = reinterpret_cast<int*>(&o);
#pragma unroll 1
  for (int i = lane; i < F12W; i += WARP) e[i] = __ldcg(row + i);
}

// One warp a block; every block runs every level (the grid barrier needs
// them all), looping over its share of the level's products.
__global__ void __launch_bounds__(WARP)
f12_fold_kernel(int* __restrict__ out, const int* __restrict__ in,
                const unsigned char* __restrict__ drop, int* scratch,
                int n) {
  __shared__ FoldWs s;
  const int lane = threadIdx.x;
  const int* ea = reinterpret_cast<const int*>(&s.a);
  if (n == 1) {
    if (blockIdx.x == 0) {
      load_plane_row(s.a, in, drop, 0, 1, lane);
      __syncwarp();
      for (int i = lane; i < F12W; i += WARP) out[i] = ea[i];
    }
    return;
  }
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int* half_buf[2] = {scratch, scratch + (size_t)(n / 2) * F12W};
  int level = 0;
  for (int half = n / 2; half >= 1; half /= 2, ++level) {
    const int* src = half_buf[(level + 1) & 1];
    int* dst = half_buf[level & 1];
    for (int i = blockIdx.x; i < half; i += gridDim.x) {
      if (level == 0) {
        load_plane_row(s.a, in, drop, i, n, lane);
        load_plane_row(s.b, in, drop, i + half, n, lane);
      } else {
        load_row(s.a, src + (size_t)i * F12W, lane);
        load_row(s.b, src + (size_t)(i + half) * F12W, lane);
      }
      __syncwarp();
      w_mul(s.w, lane, s.a, s.a, s.b);
      int* o = half == 1 ? out : dst + (size_t)i * F12W;
#pragma unroll 1
      for (int k = lane; k < F12W; k += WARP) o[k] = ea[k];
      __syncwarp();
    }
    if (half > 1) grid.sync();
  }
}

}  // namespace

// in [12, 32, n] (n a power of two), drop [n] bytes or null, scratch
// [n · 384] int32, out [12, 32, 1].  Sizes the persistent grid by the
// kernel's occupancy and launches it cooperatively.  Returns the
// cudaError of the occupancy query or of the launch.
extern "C" int charon_f12_fold(void* out, const void* in, const void* drop,
                               void* scratch, int n, void* stream) {
  if (n <= 0 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                        f12_fold_kernel,
                                                        WARP, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int want = n / 2 > 1 ? n / 2 : 1;
  const int blocks = per_sm * sms < want ? per_sm * sms : want;
  int* o = static_cast<int*>(out);
  const int* i = static_cast<const int*>(in);
  const unsigned char* d = static_cast<const unsigned char*>(drop);
  int* sc = static_cast<int*>(scratch);
  void* args[] = {&o, &i, &d, &sc, &n};
  err = cudaLaunchCooperativeKernel((void*)f12_fold_kernel, dim3(blocks),
                                    dim3(WARP), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel contract audit's query (attrs.cuh) of kernel i of `fns`.
extern "C" int charon_fold_attrs(int i, int threads, int smem,
                                 long long* out) {
  const void* const fns[] = {
      (const void*)f12_fold_kernel  // 0
  };
  return attrs::query(fns, (int)(sizeof(fns) / sizeof(fns[0])), i,
                      threads, smem, out);
}
