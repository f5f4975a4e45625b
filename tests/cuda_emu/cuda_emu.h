// CPU emulation of the CUDA execution model, for testing the port's
// kernel sources without a GPU or nvcc.
//
// Each CUDA thread of a block runs on its own std::thread.  Blocks run one
// cluster at a time (over grid.y, then grid.x; a launch without a cluster
// is a cluster of one block), and a cluster's blocks run together, each
// with its own dynamic shared memory, filled with 0xCD so a kernel that
// reads it before writing shows up.  __syncthreads is a std::barrier over
// the block's threads, cluster.sync() one over the cluster's,
// map_shared_rank() points into a peer block's dynamic shared memory, and
// a warp shuffle (__shfl_xor_sync, __shfl_sync from a source lane)
// exchanges values through a per-warp buffer between two barriers of the
// warp's threads, and so does a ballot (__ballot_sync);
// the split cluster barrier
// (__cluster_barrier_arrive / _wait) is arrive and wait on the cluster's,
// and st.async pushes count bytes off an emulated mbarrier.
// __shared__ variables are function
// statics, shared by every block of a cluster, so a kernel launched with
// clusters keeps all of its shared memory dynamic.  cp.async copies
// (__pipeline_memcpy_async) complete at once.  The SM count reported is
// 1, or EMU_SM_COUNT from the environment.  Only the device features the
// port's kernels use are provided.  The test rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` into
// `emu_launch(kernel, grid, block, smem, stream, args)` and
// `extern __shared__ uint4 smem[];` into a pointer to that buffer.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct int2 {
  int x, y;
};
struct int4 {
  int x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }
inline int2 make_int2(int a, int b) { return int2{a, b}; }
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// One streaming multiprocessor, unless EMU_SM_COUNT says otherwise (the
// count only sizes launches: blocks still run a cluster at a time).
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  const char* e = std::getenv("EMU_SM_COUNT");
  *v = e ? std::atoi(e) : 1;
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
// Float intrinsics: a fused multiply-add and an add rounded to nearest
// even, a float's bits as an int and back, and a float-to-int conversion
// rounding half to even (the default rounding mode) that saturates at the
// int range, as the card's does.
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int x;
  std::memcpy(&x, &f, sizeof x);
  return x;
}
inline int __float2int_rn(float x) {
  const float r = std::nearbyint(x);
  if (!(r > -2147483648.0f)) return r != r ? 0 : INT32_MIN;
  if (r >= 2147483648.0f) return INT32_MAX;
  return int(r);
}

// What a thread of the running cluster sees of it.
struct EmuCluster {
  std::barrier<>* bar;
  unsigned size;
  void* const* smem;    // each block's dynamic shared memory, by rank
};

inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline thread_local uint64_t* emu_warp_slots = nullptr;
inline thread_local void* emu_dyn_smem = nullptr;
inline thread_local EmuCluster emu_cluster{};
inline thread_local unsigned emu_block_rank = 0;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// Every lane of the warp takes part, as the kernels call it.
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  emu_warp_barrier->arrive_and_wait();
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline void __threadfence_block() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

// Warp shuffle (every lane of the warp takes part, as the kernels do).
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask, int = 32) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
  const unsigned lane = threadIdx.x % 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp_slots[lane] = bits;
  emu_warp_barrier->arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_warp_slots[lane ^ unsigned(lane_mask)], sizeof(T));
  emu_warp_barrier->arrive_and_wait();
  return r;
}

// Warp shuffle from a source lane: lane l gets the value of lane
// src_lane mod width within its width-lane segment (every lane of the
// warp takes part, as the kernels call it).
template <class T>
T __shfl_sync(unsigned, T v, int src_lane, int width = 32) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
  const unsigned lane = threadIdx.x % 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp_slots[lane] = bits;
  emu_warp_barrier->arrive_and_wait();
  const unsigned w = unsigned(width);
  const unsigned src = lane / w * w + unsigned(src_lane) % w;
  T r;
  std::memcpy(&r, &emu_warp_slots[src], sizeof(T));
  emu_warp_barrier->arrive_and_wait();
  return r;
}

// Warp vote: bit l of the result is lane l's predicate (every lane of the
// warp takes part, as the kernels call it).
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned lane = threadIdx.x % 32;
  emu_warp_slots[lane] = pred ? 1u : 0u;
  emu_warp_barrier->arrive_and_wait();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l)
    if (emu_warp_slots[l]) r |= 1u << l;
  emu_warp_barrier->arrive_and_wait();
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

// cp.async through the pipeline primitives: the copy completes at once.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// The cluster barrier split in two and the peer-address query (sm_90's
// intrinsics).
inline thread_local std::optional<std::barrier<>::arrival_token> emu_arrival;
inline void __cluster_barrier_arrive() {
  emu_arrival.emplace(emu_cluster.bar->arrive());
}
inline void __cluster_barrier_arrive_relaxed() { __cluster_barrier_arrive(); }
inline void __cluster_barrier_wait() {
  emu_cluster.bar->wait(std::move(*emu_arrival));
  emu_arrival.reset();
}
inline void* __cluster_map_shared_rank(const void* p, unsigned rank) {
  const auto off = reinterpret_cast<uintptr_t>(p)
                   - reinterpret_cast<uintptr_t>(emu_dyn_smem);
  return reinterpret_cast<void*>(
      reinterpret_cast<uintptr_t>(emu_cluster.smem[rank]) + off);
}

// csrc/dsmem.cuh's pushes (st.async counted off a peer's mbarrier): the
// test gives the sources an empty dsmem.cuh, and these stand in.  An
// mbarrier is a record keyed by its address: arrivals still pending this
// phase, bytes still expected (may go below zero before the expect), and
// the phase's parity.
struct EmuMbar {
  unsigned count = 1, pending = 1;
  long long tx = 0;
  unsigned phase = 0;
};
inline std::mutex emu_mbar_mu;
inline std::condition_variable emu_mbar_cv;
inline std::map<const void*, EmuMbar> emu_mbars;
inline void emu_mbar_settle(EmuMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.count;
    emu_mbar_cv.notify_all();
  }
}
inline void ljt_mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> lk(emu_mbar_mu);
  emu_mbars[bar] = EmuMbar{count, count, 0, 0};
}
inline void ljt_fence_mbar_init() {}
inline void ljt_mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lk(emu_mbar_mu);
  EmuMbar& m = emu_mbars[bar];
  m.tx += bytes;
  m.pending -= 1;
  emu_mbar_settle(m);
}
inline void ljt_st_async_u64(unsigned long long* slot, unsigned rank,
                             unsigned long long v, uint64_t* bar) {
  auto* remote = static_cast<unsigned long long*>(
      __cluster_map_shared_rank(slot, rank));
  const void* rbar = __cluster_map_shared_rank(bar, rank);
  std::lock_guard<std::mutex> lk(emu_mbar_mu);
  *remote = v;
  EmuMbar& m = emu_mbars[rbar];
  m.tx -= 8;
  emu_mbar_settle(m);
}
inline void ljt_mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(emu_mbar_mu);
  emu_mbar_cv.wait(lk, [&] { return emu_mbars[bar].phase != parity; });
}

namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster.bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_block_rank; }
  unsigned num_blocks() const { return emu_cluster.size; }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return static_cast<T*>(__cluster_map_shared_rank(p, rank));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

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

// Runs the grid a cluster of `cs` blocks (consecutive in x) at a time.
template <class K, class... A>
void emu_launch_clusters(K kernel, dim3 grid, dim3 block, size_t smem,
                         unsigned cs, A... args) {
  const unsigned warps = (block.x + 31) / 32;
  std::vector<std::vector<uint8_t>> dyn(cs,
                                        std::vector<uint8_t>(smem + 64));
  std::vector<void*> base(cs);
  std::vector<uint64_t> slots(size_t(cs) * warps * 32);
  for (unsigned b0 = 0; b0 < grid.x * grid.y; b0 += cs) {
    std::barrier<> cluster_bar(cs * block.x);
    std::vector<std::unique_ptr<std::barrier<>>> bars, warp_bars;
    for (unsigned j = 0; j < cs; ++j) {
      std::memset(dyn[j].data(), 0xCD, dyn[j].size());
      base[j] = reinterpret_cast<void*>(
          (reinterpret_cast<uintptr_t>(dyn[j].data()) + 15) & ~uintptr_t(15));
      bars.emplace_back(new std::barrier<>(block.x));
      for (unsigned w = 0; w < warps; ++w)
        warp_bars.emplace_back(
            new std::barrier<>(std::min(32u, block.x - 32 * w)));
    }
    const EmuCluster cl{&cluster_bar, cs, base.data()};
    std::vector<std::thread> threads;
    for (unsigned j = 0; j < cs; ++j)
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, j, t] {
          const unsigned b = b0 + j;
          threadIdx = dim3(t);
          blockIdx = dim3(b % grid.x, b / grid.x);
          blockDim = block;
          gridDim = grid;
          emu_barrier = bars[j].get();
          emu_warp_barrier = warp_bars[j * warps + t / 32].get();
          emu_warp_slots = &slots[(size_t(j) * warps + t / 32) * 32];
          emu_dyn_smem = base[j];
          emu_cluster = cl;
          emu_block_rank = j;
          kernel(args...);
        });
    for (auto& th : threads) th.join();
  }
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, int smem, cudaStream_t,
                A... args) {
  emu_launch_clusters(kernel, grid, block, size_t(smem), 1u, args...);
}

// cudaLaunchKernelEx with an optional cluster dimension (x only).
template <class K, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, A... args) {
  unsigned cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (cfg->attrs[i].val.clusterDim.y != 1
          || cfg->attrs[i].val.clusterDim.z != 1)
        return cudaErrorInvalidValue;
      cs = cfg->attrs[i].val.clusterDim.x;
    }
  if (cs == 0 || cfg->gridDim.x % cs) return cudaErrorInvalidValue;
  emu_launch_clusters(kernel, cfg->gridDim, cfg->blockDim,
                      cfg->dynamicSmemBytes, cs, args...);
  return cudaSuccess;
}
