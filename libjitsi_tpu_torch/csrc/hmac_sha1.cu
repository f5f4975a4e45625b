// Kernel B: batched HMAC-SHA1 from per-row key midstates.
//
// Replaces: libjitsi_tpu/kernels/sha1.py `hmac_sha1` (XLA device code on
// the SRTP path).  midstates [n, 2, 5] u32 (ipad, opad states from
// `hmac_precompute`), data [n, width] u8, lengths [n] i32 -> tags
// [n, 20] u8.  Lengths are clamped to [0, width].
//
// Bound on the H100: operations.  A 64-byte block needs at least 432
// instructions of the INT32 pipe (three rotates or LOP3 per round, three
// per schedule word) against 64 bytes read, above the card's ~5 per byte
// balance point of that pipe's rate to HBM bandwidth.
// Design: one thread per row, padding synthesized while reading (no
// padded copy of the message), each row compressing only its own blocks
// (the JAX form masks every row up to the widest one), the 80 rounds
// unrolled with the schedule in a 16-word register ring.

#include <cuda_runtime.h>

#include <cstdint>

#include "sha1.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    hmac_sha1_kernel(const uint32_t* __restrict__ midstates,
                     const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lengths,
                     uint8_t* __restrict__ out, int n, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t mid[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) mid[k] = midstates[size_t(i) * 10 + k];
  int len = lengths[i];
  len = len < 0 ? 0 : (len > width ? width : len);
  const uint8_t* row = data + size_t(i) * width;
  LjtMsg m{row, len, len, width, 0u,
           (reinterpret_cast<uintptr_t>(row) & 3) == 0};
  uint32_t d[5];
  ljt_hmac_sha1(mid, m, d);
  uint8_t* o = out + size_t(i) * 20;
#pragma unroll
  for (int k = 0; k < 5; ++k) ljt_store_be32(o + 4 * k, d[k]);
}

}  // namespace

extern "C" int ljt_hmac_sha1(const void* midstates, const void* data,
                             const void* lengths, void* out, int n,
                             int width, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  hmac_sha1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(midstates),
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint8_t*>(out), n, width);
  return int(cudaGetLastError());
}
