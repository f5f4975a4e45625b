// CPU emulation of the CUDA execution model, for testing the port's
// kernel sources without a GPU or nvcc.
//
// Each CUDA thread of a block runs on its own std::thread; blocks run one
// after another (over grid.y, then grid.x); __syncthreads is a std::barrier over the block's
// threads; __shared__ variables are function statics (one block is live
// at a time) and dynamic shared memory is one buffer per block, filled
// with 0xCD so a kernel that reads it before writing shows up.  Only the
// device features the port's kernels use are provided.  The test
// rewrites `kernel<<<grid, block, smem, stream>>>(args)` into
// `emu_launch(kernel, grid, block, smem, stream, args)` and
// `extern __shared__ uint4 smem[];` into a pointer to that buffer.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// One streaming multiprocessor: blocks run one after another.
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
// The emulator's dynamic shared memory has no 48 KB default to lift.
template <class K>
int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// Read-only cache load: a plain load.
template <class T>
T __ldg(const T* p) {
  return *p;
}

inline thread_local std::barrier<>* emu_barrier = nullptr;
inline void* emu_dyn_smem = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline void __threadfence_block() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint64_t v = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) {
    uint32_t sel = (s >> (4 * i)) & 7;
    r |= uint32_t((v >> (8 * sel)) & 0xFF) << (8 * i);
  }
  return r;
}
inline int __clz(int x) { return x ? __builtin_clz(unsigned(x)) : 32; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return uint32_t((((uint64_t(hi) << 32) | lo) << s) >> 32);
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return uint32_t((((uint64_t(hi) << 32) | lo) >> s));
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int smem, cudaStream_t,
                A... args) {
  std::vector<uint8_t> dyn(size_t(smem) + 64);
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    std::memset(dyn.data(), 0xCD, dyn.size());
    emu_dyn_smem = reinterpret_cast<void*>(
        (reinterpret_cast<uintptr_t>(dyn.data()) + 15) & ~uintptr_t(15));
    std::barrier<> bar(block.x);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b % grid.x, b / grid.x);
        blockDim = block;
        gridDim = grid;
        emu_barrier = &bar;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
