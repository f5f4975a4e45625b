// Kernels F and G: G.711 µ-law / A-law encode and decode.
//
// Replaces: libjitsi_tpu/kernels/g711.py `ulaw_encode` / `alaw_encode`
// (kernel F) and `ulaw_decode` / `alaw_decode` (kernel G), XLA device
// code on the conference bridge's path.  The law is an argument
// (0 = µ-law, 1 = A-law).
//   F: pcm [n] i16 -> codes [n] u8, the G.711 segment arithmetic with the
//      exponent taken as the integer bit length of the magnitude
//      (31 - clz), which is the spec.  The JAX package takes it as
//      floor(log2(float(mag))), which differs from the spec only at µ-law
//      input ±8060 (log2(8192) rounds below 13 there).
//   G: codes [n] u8 -> pcm [n] i16 through a 256-entry table that each
//      block builds in shared memory from the spec, as g711.py builds its
//      tables.
//
// Bound on the H100: bytes (3 per sample, a handful of integer operations
// beside them).  Design: a grid-stride loop over the flat sample array,
// one sample per thread per step.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

__device__ __forceinline__ uint8_t ulaw_encode1(int x) {
  const int sign = x < 0 ? 0x80 : 0;
  const int mag = min(abs(x), 32635) + 0x84;
  const int exp = min(max(bit_length(mag) - 1 - 7, 0), 7);
  const int mant = (mag >> (exp + 3)) & 0x0F;
  return uint8_t(~(sign | (exp << 4) | mant) & 0xFF);
}

__device__ __forceinline__ uint8_t alaw_encode1(int x) {
  const int sign = x >= 0 ? 0x80 : 0;
  const int mag = min(abs(x), 32767) >> 3;          // 13-bit magnitude
  const int exp = min(max(bit_length(max(mag, 1)) - 1 - 4, 0), 7);
  const int mant = exp == 0 ? (mag >> 1) & 0x0F : (mag >> exp) & 0x0F;
  return uint8_t((sign | (exp << 4) | mant) ^ 0x55);
}

__device__ __forceinline__ int16_t ulaw_decode1(int u) {
  const int v = ~u & 0xFF;
  const int exp = (v >> 4) & 0x07;
  const int x = ((((v & 0x0F) << 3) + 0x84) << exp) - 0x84;
  return int16_t((v & 0x80) ? -x : x);
}

__device__ __forceinline__ int16_t alaw_decode1(int a) {
  const int v = a ^ 0x55;
  const int exp = (v >> 4) & 0x07;
  const int mant = v & 0x0F;
  const int x = exp == 0 ? (mant << 4) + 8 : ((mant << 4) + 0x108) << (exp - 1);
  return int16_t((v & 0x80) ? x : -x);   // sign bit set == positive
}

__global__ void __launch_bounds__(kThreads)
    g711_encode_kernel(const int16_t* __restrict__ pcm,
                       uint8_t* __restrict__ out, int n, int law) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = law ? alaw_encode1(pcm[i]) : ulaw_encode1(pcm[i]);
}

__global__ void __launch_bounds__(kThreads)
    g711_decode_kernel(const uint8_t* __restrict__ codes,
                       int16_t* __restrict__ out, int n, int law) {
  __shared__ int16_t lut[256];
  const int t = threadIdx.x;
  lut[t] = law ? alaw_decode1(t) : ulaw_decode1(t);   // blockDim == 256
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + t; i < n; i += stride)
    out[i] = lut[codes[i]];
}

dim3 grid_for(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return dim3(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int ljt_g711_encode(const void* pcm, void* out, int n, int law,
                               void* stream) {
  if (n < 0 || (law != 0 && law != 1)) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  g711_encode_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<uint8_t*>(out), n, law);
  return int(cudaGetLastError());
}

extern "C" int ljt_g711_decode(const void* codes, void* out, int n, int law,
                               void* stream) {
  if (n < 0 || (law != 0 && law != 1)) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  g711_decode_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int16_t*>(out), n, law);
  return int(cudaGetLastError());
}
