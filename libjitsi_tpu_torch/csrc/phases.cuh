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
