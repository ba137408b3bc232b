// The kernel contract audit's host-side query: what the runtime reports of
// a compiled kernel, and how many of its blocks an SM holds at a launch
// geometry.  Each source's `charon_<stem>_attrs` (beside its launchers)
// hands its kernels' addresses to `attrs::query`; chip_smoke.py's
// `contract` phase holds the figures against the compiler's report
// (-Xptxas -v) and ops/smem_budget.py's model
// (analysis/kernel_audit.py).
//
// Host code only: it adds no device code, so every kernel compiles as it
// did without it.
#pragma once

#include <cuda_runtime.h>

namespace attrs {

// Fields of `out`, in order.
enum Field {
  NUM_REGS = 0,
  LOCAL_BYTES = 1,          // local memory a thread: the stack frame
  STATIC_SMEM = 2,          // static shared memory a block
  MAX_DYNAMIC_SMEM = 3,     // dynamic shared memory a block may use,
                            // before the query raises it to `smem`
  MAX_THREADS = 4,          // threads a block (its __launch_bounds__)
  BLOCKS_PER_SM = 5,        // at (threads, smem): the occupancy API's
  NUM_FIELDS = 6
};

// Kernel `i` of the `n` in `fns`, at `threads` a block and `smem` bytes of
// dynamic shared memory → `out[NUM_FIELDS]`.  Returns the cudaError of the
// first call that fails (cudaErrorInvalidValue for an index out of range).
inline int query(const void* const* fns, int n, int i, int threads,
                 int smem, long long* out) {
  if (i < 0 || i >= n || threads <= 0 || smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
  if (err != cudaSuccess) return (int)err;
  if (smem > a.maxDynamicSharedSizeBytes) {
    // as the program kernels' launchers do before they launch: without
    // it a block over 48 KB fits no SM
    err = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i],
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[NUM_REGS] = a.numRegs;
  out[LOCAL_BYTES] = (long long)a.localSizeBytes;
  out[STATIC_SMEM] = (long long)a.sharedSizeBytes;
  out[MAX_DYNAMIC_SMEM] = a.maxDynamicSharedSizeBytes;
  out[MAX_THREADS] = a.maxThreadsPerBlock;
  out[BLOCKS_PER_SM] = blocks;
  return (int)cudaSuccess;
}

}  // namespace attrs
