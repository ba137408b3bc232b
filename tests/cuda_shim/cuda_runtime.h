// A g++ stand-in for the CUDA runtime header, so that the tests can run
// the port's device code on the CPU: a block's threads are std::threads
// (`run_grid` runs the blocks one after another), `__shared__` is a static
// shared by them, and each shuffle, `__syncwarp` and `__all_sync` is an
// exchange over a barrier of its mask's lanes (one barrier per warp and
// mask), `__syncthreads` a barrier of the block.  Only what the kernels of
// tests/test_torch_lanes.py use.  Compile with g++ -std=c++20.
#pragma once
#include <atomic>
#include <barrier>
#include <bit>
#include <cstddef>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct dim3s { unsigned x, y, z; };
inline thread_local dim3s threadIdx, blockIdx, blockDim;
struct Grp {
  std::barrier<> bar;
  int slot[32];
  explicit Grp(int n) : bar(n) {}
};
inline std::mutex g_mu;
inline std::map<uint64_t, std::unique_ptr<Grp>> g_grps;
inline std::barrier<>* g_block = nullptr;
inline Grp& grp_of(unsigned mask) {
  const uint64_t key = ((uint64_t)(threadIdx.x / 32) << 32) | mask;
  std::lock_guard<std::mutex> lk(g_mu);
  auto& p = g_grps[key];
  if (!p) p = std::make_unique<Grp>(std::popcount(mask));
  return *p;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { grp_of(mask).bar.arrive_and_wait(); }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline int xch(unsigned mask, int v, int src) {
  Grp& g = grp_of(mask);
  const int lane = threadIdx.x % 32;
  g.slot[lane] = v;
  g.bar.arrive_and_wait();
  const int r = g.slot[src];
  g.bar.arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned mask, int v, int src, int w = 32) {
  const int lane = threadIdx.x % 32;
  return xch(mask, v, lane / w * w + src % w);
}
inline int __shfl_up_sync(unsigned mask, int v, unsigned d, int w = 32) {
  const int lane = threadIdx.x % 32;
  return xch(mask, v, (lane % w) >= (int)d ? lane - (int)d : lane);
}
inline int __shfl_down_sync(unsigned mask, int v, unsigned d, int w = 32) {
  const int lane = threadIdx.x % 32;
  return xch(mask, v, (lane % w) + (int)d < w ? lane + (int)d : lane);
}
inline int __all_sync(unsigned mask, int v) {
  Grp& g = grp_of(mask);
  const int lane = threadIdx.x % 32;
  g.slot[lane] = v != 0;
  g.bar.arrive_and_wait();
  int r = 1;
  for (int i = 0; i < 32; ++i) if (mask >> i & 1) r &= g.slot[i];
  g.bar.arrive_and_wait();
  return r;
}
template <class F>
inline void run_grid(int grid, int threads, F f) {
  for (int b = 0; b < grid; ++b) {
    g_grps.clear();
    std::barrier<> blk(threads);
    g_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        blockDim = {(unsigned)threads, 1, 1};
        f();
      });
    for (auto& t : ts) t.join();
  }
}
