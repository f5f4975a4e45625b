// Byte-order helpers shared by the AES and SHA-1 device code, and a clamp.
//
// SRTP, AES (FIPS-197) and SHA-1 (FIPS 180-4) all read their 32-bit
// words big-endian; the card loads little-endian, so a loaded word is
// byte-swapped once with a byte permute.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t ljt_bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t ljt_rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// Big-endian word at p (any alignment).
__device__ __forceinline__ uint32_t ljt_load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

__device__ __forceinline__ int ljt_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void ljt_store_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}
