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
// beside them).
// Design of F: each lane encodes 8 samples a step, one 16-byte load and
// one 8-byte store, when pcm is 16-byte and out 8-byte aligned; the
// ragged tail (n % 8 samples) and misaligned pointers take one sample a
// step.  The grid covers the array in one step where the card can hold
// that many blocks at once (8 of 256 threads a SM) and strides beyond.
// The law is chosen once a launch, outside the loop.
// Design of G: a grid-stride loop over the flat code array, one code per
// thread per step, the grid capped at 1,024 blocks.

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

template <int LAW>
__device__ __forceinline__ uint8_t encode1(int x) {
  return LAW ? alaw_encode1(x) : ulaw_encode1(x);
}

template <int LAW>
__device__ __forceinline__ void encode_all(const int16_t* __restrict__ pcm,
                                           uint8_t* __restrict__ out, int n,
                                           bool vec) {
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int done = 0;
  if (vec) {
    const int nv = n / 8;
    const uint4* in8 = reinterpret_cast<const uint4*>(pcm);
    uint2* out8 = reinterpret_cast<uint2*>(out);
    for (int i = tid; i < nv; i += stride) {
      const uint4 v = __ldg(in8 + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t b[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = encode1<LAW>(int(int16_t(w[k])));
        const uint32_t hi = encode1<LAW>(int(w[k]) >> 16);
        b[k / 2] |= (lo | (hi << 8)) << (16 * (k % 2));
      }
      out8[i] = make_uint2(b[0], b[1]);
    }
    done = nv * 8;
  }
  for (int i = done + tid; i < n; i += stride) out[i] = encode1<LAW>(pcm[i]);
}

__global__ void __launch_bounds__(kThreads)
    g711_encode_kernel(const int16_t* __restrict__ pcm,
                       uint8_t* __restrict__ out, int n, int law, int vec) {
  if (law)
    encode_all<1>(pcm, out, n, vec != 0);
  else
    encode_all<0>(pcm, out, n, vec != 0);
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

// F's grid: one step for every lane where the card holds the blocks at
// once (8 blocks of 256 threads a SM), a grid-stride loop beyond.
dim3 encode_grid(int n, bool vec) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms < 1)
    sms = 1;
  const int lanes = vec ? (n + 7) / 8 : n;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  const int most = 8 * sms;
  return dim3(blocks < most ? blocks : most);
}

}  // namespace

extern "C" int ljt_g711_encode(const void* pcm, void* out, int n, int law,
                               void* stream) {
  if (n < 0 || (law != 0 && law != 1)) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int vec = reinterpret_cast<uintptr_t>(pcm) % 16 == 0
                  && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  g711_encode_kernel<<<encode_grid(n, vec), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<uint8_t*>(out), n, law,
      vec);
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
