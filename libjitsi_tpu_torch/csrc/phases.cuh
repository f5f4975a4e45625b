// Readings for the phase probes: builds of a kernel with clock64 stamps
// (M's and N's tile, `gcm_tile.cuh`; kernel O, `gcm_fill.cu`; H's F8
// instance, `srtp_fanout.cu`).  The shipped kernels compile none of it.
// The CPU emulation of the tests has no global timer, SM or warp slot:
// there the timer is its clock, the SM 0 and the warp slot the warp's
// index in its block.
#pragma once

#include <cstdint>

// The global nanosecond timer.
__device__ __forceinline__ long long phase_globaltimer() {
#ifdef __CUDA_ARCH__
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return (long long)ns;
#else
  return clock64();
#endif
}

// The SM the calling thread runs on.
__device__ __forceinline__ int phase_smid() {
#ifdef __CUDA_ARCH__
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return int(sm);
#else
  return 0;
#endif
}

// The calling warp's slot on its SM (`%warpid`); its SM sub-partition is
// the slot mod 4.
__device__ __forceinline__ int phase_warpid() {
#ifdef __CUDA_ARCH__
  unsigned w;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(w));
  return int(w);
#else
  return int(threadIdx.x) >> 5;
#endif
}

// The stamps of a tile of the SRTCP NULL probe (`ljt_srtcp_null_phases`:
// kernels I-NULL and J-NULL, `srtcp_null.cu`), kSlots words a tile: its
// start (thread 0), its SM, the global timer at its start, its rows;
// thread 0's stream id in hand (and its length and first message blocks,
// which share that round trip), its midstates in hand; the tile's end
// (every store drained), the global timer then, its threads; then warp
// w's end (its stores drained; 0 for a warp that copies nothing) at
// kWarp + w, and hashing lane r's end (its outputs written) at kLane + r.
// Slot kSink takes a loaded value before a stamp that must wait on it.
namespace ljt_null_phase {
constexpr int kStart = 0, kSm = 1, kTimer = 2, kRows = 3, kId = 4, kMid = 5,
              kEnd = 6, kTimerEnd = 7, kThreads = 8, kSink = 9, kWarp = 10,
              kLane = 14, kSlots = 46;

// A tile's stamps in `stamps`, its start stamped by thread 0.
__device__ __forceinline__ long long* start(long long* stamps, int rows) {
  long long* st = stamps + size_t(blockIdx.x) * kSlots;
  if (threadIdx.x == 0) {
    st[kStart] = clock64();
    st[kSm] = phase_smid();
    st[kTimer] = phase_globaltimer();
    st[kRows] = rows;
    st[kThreads] = blockDim.x;
  }
  return st;
}

// The tile's end, once every thread's stores have drained.
__device__ __forceinline__ void end(long long* st) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    st[kEnd] = clock64();
    st[kTimerEnd] = phase_globaltimer();
  }
}
}  // namespace ljt_null_phase
