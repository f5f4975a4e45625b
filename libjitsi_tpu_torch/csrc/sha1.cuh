// HMAC-SHA1 for Hopper: one thread hashes one message, padding on the fly.
//
// Replaces libjitsi_tpu/kernels/sha1.py `hmac_sha1` (and `sha1`), which
// materializes every row's padded message as a [B, nblk * 64] buffer
// (`_pad_and_blockify`) and masks the compression of blocks past each
// row's length.  Here the padding bytes (0x80, zeros, the 64-bit bit
// length) are produced as the words are read, so nothing beyond the
// message itself is ever stored, and a row runs exactly its own block
// count.  HMAC starts from the per-key ipad/opad midstates
// (`hmac_precompute`), so a tag is the inner tail plus one outer block.
#pragma once

#include <cstdint>

#include "bytes.cuh"

// FIPS 180-4 §6.1.2 compression of one block; w is consumed as the
// 16-word ring of the message schedule.
__device__ __forceinline__ void ljt_sha1_compress(uint32_t h[5],
                                                  uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = ljt_rotl32(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^ w[(t - 14) & 15] ^
                          w[t & 15],
                      1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    uint32_t tmp = ljt_rotl32(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = ljt_rotl32(b, 30);
    b = a;
    a = tmp;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

// A message of `mlen` bytes read from one buffer row: bytes [0, dlen)
// are p[i], bytes [dlen, mlen) are taken from the big-endian word
// `extra` (the SRTP rollover counter appended for the MAC), and every
// position at or past `width` reads as 0 — a byte that would fall off
// the end of the row is a zero, as in the JAX package.
struct LjtMsg {
  const uint8_t* p;
  int dlen;
  int mlen;
  int width;
  uint32_t extra;
  bool aligned;  // p is 4-byte aligned: whole words load in one access
};

__device__ __forceinline__ uint32_t ljt_msg_byte(const LjtMsg& m, int i) {
  if (i >= m.width) return 0;
  if (i < m.dlen) return m.p[i];
  return (m.extra >> (8 * (3 - (i - m.dlen)))) & 0xFF;
}

// Big-endian word of the padded message at byte i (i % 4 == 0).
__device__ __forceinline__ uint32_t ljt_msg_word(const LjtMsg& m, int i) {
  if (m.aligned && i + 4 <= m.dlen && i + 4 <= m.width)
    return ljt_bswap32(*reinterpret_cast<const uint32_t*>(m.p + i));
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int pos = i + k;
    uint32_t b = pos < m.mlen ? ljt_msg_byte(m, pos)
                              : (pos == m.mlen ? 0x80u : 0u);
    v = (v << 8) | b;
  }
  return v;
}

__device__ __forceinline__ void ljt_msg_block(const LjtMsg& m, int b,
                                              uint32_t w[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = ljt_msg_word(m, b * 64 + 4 * j);
}

// An SRTP MAC message staged in shared memory: the row's bytes [0, dlen)
// as little-endian 32-bit words (row[q] holds bytes 4q..4q+3, dlen <=
// width), then the 4-byte rollover counter, of which the bytes that
// would fall at or past `width` read as 0; mlen = dlen + 4.  Whole words
// are read as words; only the word that holds the end of the data is
// merged with the ROC and the 0x80 pad byte, in registers.
struct LjtRowMsg {
  const uint32_t* row;
  int dlen;
  int mlen;
  uint64_t tail;  // big-endian bytes after the data: ROC, 0x80, 0, 0, 0

  __device__ __forceinline__ LjtRowMsg(const uint32_t* r, int len, int width,
                                       uint32_t roc)
      : row(r), dlen(len), mlen(len + 4) {
    const int room = width - len;  // ROC bytes that fit in the row
    if (room < 4) roc = room <= 0 ? 0u : roc & (0xFFFFFFFFu << (32 - 8 * room));
    tail = (uint64_t(roc) << 32) | 0x80000000u;
  }

  // Big-endian message word at byte i (i % 4 == 0), padding included.
  __device__ __forceinline__ uint32_t word(int i) const {
    uint32_t v = 0;
    if (i < dlen) {
      v = ljt_bswap32(row[i >> 2]);
      const int cut = i + 4 - dlen;  // data bytes missing from this word
      if (cut > 0) v &= 0xFFFFFFFFu << (8 * cut);
    }
    const int d = i - dlen;  // where the tail starts relative to the word
    if (d < 0 && d > -4)
      v |= uint32_t(tail >> 32) >> (-8 * d);
    else if (d >= 0 && d < 8)
      v |= uint32_t((tail << (8 * d)) >> 32);
    return v;
  }
};

__device__ __forceinline__ void ljt_msg_block(const LjtRowMsg& m, int b,
                                              uint32_t w[16]) {
  const int q0 = b * 16;
  if (b * 64 + 64 <= m.dlen) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = ljt_bswap32(m.row[q0 + j]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = m.word(b * 64 + 4 * j);
  }
}

// HMAC-SHA1(key, msg) from the key's midstates: mid[0..4] is the state
// after the ipad block, mid[5..9] after the opad block.  Msg is LjtMsg or
// LjtRowMsg.
template <class Msg>
__device__ __forceinline__ void ljt_hmac_sha1(const uint32_t mid[10],
                                              const Msg& m,
                                              uint32_t out[5]) {
  uint32_t h[5] = {mid[0], mid[1], mid[2], mid[3], mid[4]};
  const int nblk = (m.mlen + 9 + 63) / 64;
  // bit length of ipad block || message; < 2^32 for any row width here
  const uint32_t bitlen = uint32_t(m.mlen + 64) * 8u;
  for (int b = 0; b < nblk; ++b) {
    uint32_t w[16];
    ljt_msg_block(m, b, w);
    if (b == nblk - 1) {
      w[14] = 0;
      w[15] = bitlen;
    }
    ljt_sha1_compress(h, w);
  }
  // outer: opad midstate || the 20-byte inner digest, one padded block
  uint32_t w[16] = {h[0], h[1], h[2], h[3], h[4], 0x80000000u, 0, 0,
                    0,    0,    0,    0,    0,    0,    0,           (20 + 64) * 8};
  out[0] = mid[5];
  out[1] = mid[6];
  out[2] = mid[7];
  out[3] = mid[8];
  out[4] = mid[9];
  ljt_sha1_compress(out, w);
}

// Byte k (0..19) of a digest held as 5 big-endian words.
__device__ __forceinline__ uint8_t ljt_digest_byte(const uint32_t d[5],
                                                   int k) {
  return uint8_t(d[k >> 2] >> (8 * (3 - (k & 3))));
}
