// Kernel A: batched AES block encryption, each block under its own keys.
//
// Replaces: libjitsi_tpu/kernels/aes_bitsliced.py `aes_encrypt_pallas_bitsliced`
// (the Pallas TPU kernel) and the `aes_encrypt` core selector of
// libjitsi_tpu/kernels/aes.py.  blocks [n, 16] u8, round keys [n, R, 16]
// u8 (R = 11 or 15) -> out [n, 16] u8.
//
// Bound on the H100: bytes.  Each block reads R*16 + 16 bytes and writes
// 16, and needs at least 24*nr + 12 instructions of the INT32 pipe (LOP3,
// SHF, PRMT) in the T-table count that `chip_smoke.py` keeps as the bound;
// at 3.35 TB/s and 16.7 Tops/s the round keys' traffic dominates (208 B
// vs 252 instructions per AES-128 block).  The gather-free core of
// `aes.cuh` issues several times that count, so the kernel runs closer to
// its instruction issue than to its bytes.
//
// Design: one thread per pair of consecutive blocks, each under its own
// round keys (a lone last block is paired with itself and written once).
// Blocks and round keys load as 16-byte vectors (the rows are contiguous
// and 16-byte aligned); each round's two keys are shifted and sliced
// into one key word set as the round needs them (`ljt_aes_slice_keys`),
// so nothing is staged in shared memory and the rounds stay in
// registers.  The rounds run in the same loop as in the tile kernels
// (`ljt_aes_encrypt_pair`).

#include <cuda_runtime.h>

#include <cstdint>

#include "aes.cuh"

namespace {

constexpr int kThreads = 128;

// Round key r of a pair, sliced from the two blocks' byte-order keys.
struct PairRound {
  uint32_t k[8];

  __device__ __forceinline__ uint32_t operator()(int i) const { return k[i]; }
};

// Two blocks' own byte-order round keys, each round's sliced as the core
// asks for it.
struct PairKeys {
  const uint4* a;  // [R] block a's round keys
  const uint4* b;

  __device__ __forceinline__ PairRound round(int r) const {
    const uint4 u = a[r], v = b[r];
    const uint32_t wa[4] = {ljt_bswap32(u.x), ljt_bswap32(u.y),
                            ljt_bswap32(u.z), ljt_bswap32(u.w)};
    const uint32_t wb[4] = {ljt_bswap32(v.x), ljt_bswap32(v.y),
                            ljt_bswap32(v.z), ljt_bswap32(v.w)};
    PairRound out;
    ljt_aes_slice_keys(r, wa, wb, out.k);
    return out;
  }
};

template <int NR>
__global__ void __launch_bounds__(kThreads)
    aes_encrypt_kernel(const uint8_t* __restrict__ rk_all,
                       const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int n) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int j = i + 1 < n ? i + 1 : i;
  const uint4* rk4 = reinterpret_cast<const uint4*>(rk_all);
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  const uint4 x = in4[i], y = in4[j];
  uint32_t a[4] = {ljt_bswap32(x.x), ljt_bswap32(x.y), ljt_bswap32(x.z),
                   ljt_bswap32(x.w)};
  uint32_t b[4] = {ljt_bswap32(y.x), ljt_bswap32(y.y), ljt_bswap32(y.z),
                   ljt_bswap32(y.w)};
  uint32_t s[8];
  ljt_aes_encrypt_pair<NR>(
      PairKeys{rk4 + size_t(i) * (NR + 1), rk4 + size_t(j) * (NR + 1)}, a, b,
      s);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  out4[i] = make_uint4(ljt_bswap32(a[0]), ljt_bswap32(a[1]), ljt_bswap32(a[2]),
                       ljt_bswap32(a[3]));
  if (j != i)
    out4[j] = make_uint4(ljt_bswap32(b[0]), ljt_bswap32(b[1]),
                         ljt_bswap32(b[2]), ljt_bswap32(b[3]));
}

}  // namespace

extern "C" int ljt_aes_encrypt(const void* round_keys, const void* blocks,
                               void* out, int n, int nr, void* stream) {
  if (n <= 0) return 0;
  const int pairs = (n + 1) / 2;
  const dim3 grid((pairs + kThreads - 1) / kThreads);
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
