// Pushes into a peer block's shared memory (sm_90 thread block clusters),
// tracked by an mbarrier in the receiving block: the sender issues
// st.async and goes on; the store itself counts its bytes off the
// receiver's mbarrier (complete_tx), and the receiver waits on that
// mbarrier's phase.  No fence or cluster barrier on the sender's side.
//
//   ljt_mbar_init        one thread: an mbarrier expecting `count`
//                        arrivals a phase; ljt_fence_mbar_init publishes
//                        it to the cluster (before a cluster barrier)
//   ljt_mbar_expect_tx   one arrival that also expects `bytes` of stores
//   ljt_st_async_u64     store v at `slot` and count 8 bytes off `bar`,
//                        both addresses of this block mapped to `rank`
//   ljt_mbar_wait        wait until the phase of parity `parity` is done
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t ljt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ljt_mbar_init(uint64_t* bar,
                                              unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(ljt_smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void ljt_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void ljt_mbar_expect_tx(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(ljt_smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t ljt_mapa(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(ljt_smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void ljt_st_async_u64(unsigned long long* slot,
                                                 unsigned rank,
                                                 unsigned long long v,
                                                 uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, "
      "[%2];"
      :: "r"(ljt_mapa(slot, rank)), "l"(v), "r"(ljt_mapa(bar, rank))
      : "memory");
}

__device__ __forceinline__ void ljt_mbar_wait(uint64_t* bar,
                                              unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LJT_MBAR_WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra LJT_MBAR_WAIT_%=;\n"
      "}"
      :: "r"(ljt_smem_addr(bar)), "r"(parity) : "memory");
}
