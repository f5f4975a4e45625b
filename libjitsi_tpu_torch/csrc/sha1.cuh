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

// A MAC message staged in shared memory: the row's bytes [0, dlen) as
// little-endian 32-bit words (row[q] holds bytes 4q..4q+3, dlen <=
// width), then, for SRTP and SRTCP, a 4-byte word (the rollover counter,
// or E || SRTCP index), of which the bytes that would fall at or past
// `width` read as 0, so mlen = dlen + 4; for a bare message (kernel B)
// nothing, so mlen = dlen.  Whole words are read as words; only the word
// that holds the end of the data is merged with the word and the 0x80
// pad byte, in registers.
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

  // The row's bytes [0, len) alone (len may be negative where the staged
  // row starts past the message: then only the padding is read).
  __device__ __forceinline__ LjtRowMsg(const uint32_t* r, int len)
      : row(r), dlen(len), mlen(len), tail(uint64_t(0x80) << 56) {}

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

// Block b of the message, padding included (the bit length is the
// caller's).
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

// The outer hash of HMAC-SHA1: the opad midstate mid[5..9] over the
// 20-byte inner digest h, one padded block.
__device__ __forceinline__ void ljt_hmac_outer(const uint32_t mid[10],
                                               const uint32_t h[5],
                                               uint32_t out[5]) {
  uint32_t w[16] = {h[0], h[1], h[2], h[3], h[4], 0x80000000u, 0, 0,
                    0,    0,    0,    0,    0,    0,    0,           (20 + 64) * 8};
  out[0] = mid[5];
  out[1] = mid[6];
  out[2] = mid[7];
  out[3] = mid[8];
  out[4] = mid[9];
  ljt_sha1_compress(out, w);
}

// HMAC-SHA1(key, msg) from the key's midstates: mid[0..4] is the state
// after the ipad block, mid[5..9] after the opad block.  Msg is LjtRowMsg
// or a type with its own `ljt_msg_block` and `mlen` (kernel C's).
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
  ljt_hmac_outer(mid, h, out);
}

// Byte k (0..19) of a digest held as 5 big-endian words.
__device__ __forceinline__ uint8_t ljt_digest_byte(const uint32_t d[5],
                                                   int k) {
  return uint8_t(d[k >> 2] >> (8 * (3 - (k & 3))));
}

// The HMAC-SHA1 midstates of table row `sid` (tab_mid [S, 2, 5]).
__device__ __forceinline__ void ljt_load_mid(const uint32_t* tab_mid,
                                             int sid, uint32_t mid[10]) {
#pragma unroll
  for (int k = 0; k < 10; ++k) mid[k] = tab_mid[size_t(sid) * 10 + k];
}

// Write the first tag_len digest bytes at pos of a staged row, those at or
// past width dropped.
__device__ __forceinline__ void ljt_put_tag(uint32_t* row, int pos,
                                            int width, const uint32_t d[5],
                                            int tag_len) {
  uint8_t* b = reinterpret_cast<uint8_t*>(row);
#pragma unroll
  for (int k = 0; k < 20; ++k)
    if (k < tag_len && pos + k < width) b[pos + k] = ljt_digest_byte(d, k);
}
