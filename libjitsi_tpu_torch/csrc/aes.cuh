// AES-128/256 block encryption for Hopper: shared-memory T-table core.
//
// Replaces the block cipher of libjitsi_tpu/kernels/aes.py (`aes_encrypt`,
// whose TPU form is the Pallas kernel `aes_encrypt_pallas_bitsliced` in
// libjitsi_tpu/kernels/aes_bitsliced.py).  The TPU kernel is a
// gather-free Boolean circuit on 128 lanes only because Mosaic cannot
// lower table gathers; an SM does a 256-entry table lookup from shared
// memory in one instruction, so the core here is the classic T-table
// round (FIPS-197 §5.2 folded into four lookups per column): one 1 KB
// T-table built in shared memory once per CTA, the other three T-tables
// obtained by byte rotation, and the last round's S-box byte taken from
// the same table (byte 1 of Te0[x] is S[x]).
//
// The table is built from an S-box in global memory read through the
// read-only cache: the constant cache would serialize the 256 distinct
// per-lane indices.  One 1 KB copy per CTA: 32 copies laid out one per
// shared-memory bank remove the lookups' bank conflicts, but measured
// slower at every shape of kernels C and D on the H100 (their 32 KB caps
// the CTAs an SM holds, and these kernels wait on latency and issue, not
// on banks).
//
// State and round keys are FIPS-197 byte order read as big-endian
// column words (word c = bytes 4c..4c+3), which is the layout of
// `expand_key` ([R, 16] uint8, R = Nr + 1).
#pragma once

#include <cstdint>

#include "bytes.cuh"

static __device__ const uint8_t kLjtSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
};

// Te0[x] = S[x] * (02, 01, 01, 03), most significant byte first, from
// s = S[x].
__device__ __forceinline__ uint32_t ljt_te0_from_sbox(uint32_t s) {
  const uint32_t s2 = ((s << 1) ^ ((s & 0x80u) ? 0x1Bu : 0u)) & 0xFFu;
  return (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
}

// Fill Te0 (256 words) in shared memory.  Every thread of the CTA takes
// part; the caller syncs before use.
__device__ __forceinline__ void ljt_aes_fill_te0(uint32_t* t) {
  for (int x = threadIdx.x; x < 256; x += blockDim.x)
    t[x] = ljt_te0_from_sbox(__ldg(&kLjtSbox[x]));
}

__device__ __forceinline__ uint32_t ljt_ror8(uint32_t x) {
  return __funnelshift_r(x, x, 8);
}
__device__ __forceinline__ uint32_t ljt_ror16(uint32_t x) {
  return __funnelshift_r(x, x, 16);
}
__device__ __forceinline__ uint32_t ljt_ror24(uint32_t x) {
  return __funnelshift_r(x, x, 24);
}

// One full round's column: Te0[a>>24] ^ Te1[(b>>16)&ff] ^ Te2[(c>>8)&ff] ^
// Te3[d&ff] with Te_k = ror(Te0, 8k).
__device__ __forceinline__ uint32_t ljt_aes_col(const uint32_t* t, uint32_t a,
                                                uint32_t b, uint32_t c,
                                                uint32_t d) {
  return t[a >> 24] ^ ljt_ror8(t[(b >> 16) & 0xFF]) ^
         ljt_ror16(t[(c >> 8) & 0xFF]) ^ ljt_ror24(t[d & 0xFF]);
}

// Last round: S[x] is byte 1 (and byte 2) of Te0[x], so each output byte
// is one masked or shifted table word.
__device__ __forceinline__ uint32_t ljt_aes_last_col(const uint32_t* t,
                                                     uint32_t a, uint32_t b,
                                                     uint32_t c, uint32_t d) {
  return ((t[a >> 24] << 8) & 0xFF000000u) |
         (t[(b >> 16) & 0xFF] & 0x00FF0000u) |
         (t[(c >> 8) & 0xFF] & 0x0000FF00u) | ((t[d & 0xFF] >> 16) & 0xFFu);
}

// Encrypt one block.  t: Te0 in shared memory; rk: 4 * (NR + 1)
// big-endian round-key words; s: the block as 4 big-endian words,
// encrypted in place.
template <int NR>
__device__ __forceinline__ void ljt_aes_encrypt_block(const uint32_t* t,
                                                      const uint32_t* rk,
                                                      uint32_t s[4]) {
  uint32_t s0 = s[0] ^ rk[0], s1 = s[1] ^ rk[1];
  uint32_t s2 = s[2] ^ rk[2], s3 = s[3] ^ rk[3];
#pragma unroll
  for (int r = 1; r < NR; ++r) {
    uint32_t t0 = ljt_aes_col(t, s0, s1, s2, s3) ^ rk[4 * r];
    uint32_t t1 = ljt_aes_col(t, s1, s2, s3, s0) ^ rk[4 * r + 1];
    uint32_t t2 = ljt_aes_col(t, s2, s3, s0, s1) ^ rk[4 * r + 2];
    uint32_t t3 = ljt_aes_col(t, s3, s0, s1, s2) ^ rk[4 * r + 3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  s[0] = ljt_aes_last_col(t, s0, s1, s2, s3) ^ rk[4 * NR];
  s[1] = ljt_aes_last_col(t, s1, s2, s3, s0) ^ rk[4 * NR + 1];
  s[2] = ljt_aes_last_col(t, s2, s3, s0, s1) ^ rk[4 * NR + 2];
  s[3] = ljt_aes_last_col(t, s3, s0, s1, s2) ^ rk[4 * NR + 3];
}

// CTR counter block j: the 16-byte IV (4 big-endian words) plus j as a
// full 128-bit big-endian integer with carry (NIST SP 800-38A; SRTP's
// 16-bit block counter is the case where the IV's low 16 bits are 0).
__device__ __forceinline__ void ljt_ctr_block(const uint32_t iv[4],
                                              uint32_t j, uint32_t c[4]) {
  uint32_t l3 = iv[3] + j;
  uint32_t carry = l3 < j;
  uint32_t l2 = iv[2] + carry;
  carry = l2 < carry;
  uint32_t l1 = iv[1] + carry;
  carry = l1 < carry;
  c[0] = iv[0] + carry;
  c[1] = l1;
  c[2] = l2;
  c[3] = l3;
}
