// Kernel A: batched AES block encryption, each block under its own keys.
//
// Replaces: libjitsi_tpu/kernels/aes_bitsliced.py `aes_encrypt_pallas_bitsliced`
// (the Pallas TPU kernel) and the `aes_encrypt` core selector of
// libjitsi_tpu/kernels/aes.py.  blocks [n, 16] u8, round keys [n, R, 16]
// u8 (R = 11 or 15) -> out [n, 16] u8.
//
// Bound on the H100: bytes.  Each block reads R*16 + 16 bytes and writes
// 16, and needs at least 24*nr + 12 instructions of the INT32 pipe (LOP3,
// SHF, PRMT); at 3.35 TB/s and 16.7 Tops/s the round keys' traffic
// dominates (208 B vs 252 instructions per AES-128 block).  Design: one thread per block, its round keys and
// block loaded as 16-byte vectors (the rows are contiguous and 16-byte
// aligned), one T-table in shared memory once per CTA (built from the
// S-box through the read-only cache; the last round reads its S-box
// bytes from the same table), rounds fully unrolled so the state and
// keys stay in registers.

#include <cuda_runtime.h>

#include <cstdint>

#include "aes.cuh"

namespace {

constexpr int kThreads = 256;

template <int NR>
__global__ void __launch_bounds__(kThreads)
    aes_encrypt_kernel(const uint8_t* __restrict__ rk_all,
                       const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t te0[256];
  ljt_aes_fill_te0(te0);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* k4 =
      reinterpret_cast<const uint4*>(rk_all + size_t(i) * (NR + 1) * 16);
  uint32_t rk[4 * (NR + 1)];
#pragma unroll
  for (int r = 0; r <= NR; ++r) {
    uint4 v = k4[r];
    rk[4 * r] = ljt_bswap32(v.x);
    rk[4 * r + 1] = ljt_bswap32(v.y);
    rk[4 * r + 2] = ljt_bswap32(v.z);
    rk[4 * r + 3] = ljt_bswap32(v.w);
  }
  uint4 b = reinterpret_cast<const uint4*>(in)[i];
  uint32_t s[4] = {ljt_bswap32(b.x), ljt_bswap32(b.y), ljt_bswap32(b.z),
                   ljt_bswap32(b.w)};
  ljt_aes_encrypt_block<NR>(te0, rk, s);
  reinterpret_cast<uint4*>(out)[i] =
      make_uint4(ljt_bswap32(s[0]), ljt_bswap32(s[1]), ljt_bswap32(s[2]),
                 ljt_bswap32(s[3]));
}

}  // namespace

extern "C" int ljt_aes_encrypt(const void* round_keys, const void* blocks,
                               void* out, int n, int nr, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rk = static_cast<const uint8_t*>(round_keys);
  const uint8_t* in = static_cast<const uint8_t*>(blocks);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (nr == 10) {
    aes_encrypt_kernel<10><<<grid, kThreads, 0, s>>>(rk, in, o, n);
  } else if (nr == 14) {
    aes_encrypt_kernel<14><<<grid, kThreads, 0, s>>>(rk, in, o, n);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
