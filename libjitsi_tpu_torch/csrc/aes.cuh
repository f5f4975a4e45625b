// AES-128/256 block encryption for Hopper: a gather-free, fixsliced core.
//
// Replaces the block cipher of libjitsi_tpu/kernels/aes.py (`aes_encrypt`,
// whose TPU form is the Pallas kernel `aes_encrypt_pallas_bitsliced` in
// libjitsi_tpu/kernels/aes_bitsliced.py).  Like that kernel, this core
// is a Boolean circuit on registers: no load anywhere has an address that
// depends on key or state bytes, and there is no table of any kind, so
// the cipher's timing and its memory traffic are the same for every key
// and every block (a T-table core leaks both through the cache and the
// shared-memory banks, and in SRTP's counter mode an observer knows part
// of the first round's input).
//
// Representation (Adomnicai and Peyrin, "Fixslicing AES-like Ciphers",
// TCHES 2021/1): a thread encrypts two blocks at once, sliced into eight
// 32-bit words.  Word b holds bit b of each of the pair's 32 bytes; the
// byte in row r, column c of block k sits at bit 8 * (3 - r) + 2 * c + k,
// so a row is one byte of the word and the two blocks alternate bit by
// bit.  `ljt_aes_pack` and `ljt_aes_transpose` move between that form and
// the blocks' big-endian column words with twelve SWAPMOVEs (one 8 x 8
// bit transpose, its own inverse).
//  - SubBytes is the Boyar-Peralta circuit (IACR ePrint 2009/191): 32
//    AND and 83 XOR/XNOR gates on the eight words, which ptxas fuses into
//    LOP3s.
//  - ShiftRows is never done.  After round r the state is kept as
//    ShiftRows^-(r mod 4) of the true state, so MixColumns finds a byte's
//    column neighbour one row down and (r mod 4) columns along: a rotation
//    of the word by 8 bits and of each byte by 2 (r mod 4) bits, two
//    funnel shifts and a LOP3 (one shift when r mod 4 is 0 and known
//    when the kernel is compiled).  Each round
//    key is stored in the same drifted form (`ljt_aes_slice_keys`).  Both
//    10 and 14 rounds end two ShiftRows short, which one byte permute a
//    column word puts right after unpacking.
//  - MixColumns' doubling is a re-labelling of the eight words and three
//    XORs; AddRoundKey is eight XORs.
//
// Round keys are kept as the callers have them, FIPS-197 byte order read
// as big-endian column words (word c = bytes 4c..4c+3; `expand_key`'s
// [R, 16] uint8 rows, R = Nr + 1), and sliced per round when they are
// used (kernel A) or once a tile (`srtp_tile.cuh`): 8 words a round key
// with both block slots holding it.  A pair whose blocks are under two
// keys takes each slot from its own key, one LOP3 a word
// (`LjtSlicedRound`).  The header declares no array: state and round keys
// come in as parameters, so nothing here can hold a table
// (tests/test_torch_aes_ct.py).
#pragma once

#include <cstdint>

#include "bytes.cuh"

__device__ __forceinline__ uint32_t ljt_ror(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// The bits of `hi` under mask m trade places with the bits of `lo` under
// m << n.
__device__ __forceinline__ void ljt_swapmove(uint32_t& lo, uint32_t& hi,
                                             uint32_t m, int n) {
  const uint32_t t = (hi ^ (lo >> n)) & m;
  hi ^= t;
  lo ^= t << n;
}

// Word index q and bit index l mod 8 trade places: x[q] bit 8h + l goes
// to x[l] bit 8h + q.
__device__ __forceinline__ void ljt_aes_transpose(uint32_t x[8]) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) ljt_swapmove(x[j], x[j + 1], 0x55555555u, 1);
  ljt_swapmove(x[0], x[2], 0x33333333u, 2);
  ljt_swapmove(x[1], x[3], 0x33333333u, 2);
  ljt_swapmove(x[4], x[6], 0x33333333u, 2);
  ljt_swapmove(x[5], x[7], 0x33333333u, 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) ljt_swapmove(x[j], x[j + 4], 0x0F0F0F0Fu, 4);
}

// Two blocks (4 big-endian column words each) into the sliced form; the
// transpose again takes it back.
__device__ __forceinline__ void ljt_aes_pack(const uint32_t a[4],
                                             const uint32_t b[4],
                                             uint32_t s[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[2 * j] = a[j];
    s[2 * j + 1] = b[j];
  }
  ljt_aes_transpose(s);
}

// SubBytes on the eight words (q[0] the low bit of every byte): Boyar and
// Peralta's circuit, x0 the high bit.
__device__ __forceinline__ void ljt_aes_sbox(uint32_t q[8]) {
  const uint32_t x0 = q[7], x1 = q[6], x2 = q[5], x3 = q[4];
  const uint32_t x4 = q[3], x5 = q[2], x6 = q[1], x7 = q[0];
  // top linear layer
  const uint32_t y14 = x3 ^ x5, y13 = x0 ^ x6, y9 = x0 ^ x3, y8 = x0 ^ x5;
  const uint32_t t0 = x1 ^ x2, y1 = t0 ^ x7, y4 = y1 ^ x3, y12 = y13 ^ y14;
  const uint32_t y2 = y1 ^ x0, y5 = y1 ^ x6, y3 = y5 ^ y8, t1 = x4 ^ y12;
  const uint32_t y15 = t1 ^ x5, y20 = t1 ^ x1, y6 = y15 ^ x7, y10 = y15 ^ t0;
  const uint32_t y11 = y20 ^ y9, y7 = x7 ^ y11, y17 = y10 ^ y11;
  const uint32_t y19 = y10 ^ y8, y16 = t0 ^ y11, y21 = y13 ^ y16;
  const uint32_t y18 = x0 ^ y16;
  // non-linear middle: the GF(2^4) inversion
  const uint32_t t2 = y12 & y15, t3 = y3 & y6, t4 = t3 ^ t2, t5 = y4 & x7;
  const uint32_t t6 = t5 ^ t2, t7 = y13 & y16, t8 = y5 & y1, t9 = t8 ^ t7;
  const uint32_t t10 = y2 & y7, t11 = t10 ^ t7, t12 = y9 & y11;
  const uint32_t t13 = y14 & y17, t14 = t13 ^ t12, t15 = y8 & y10;
  const uint32_t t16 = t15 ^ t12, t17 = t4 ^ t14, t18 = t6 ^ t16;
  const uint32_t t19 = t9 ^ t14, t20 = t11 ^ t16, t21 = t17 ^ y20;
  const uint32_t t22 = t18 ^ y19, t23 = t19 ^ y21, t24 = t20 ^ y18;
  const uint32_t t25 = t21 ^ t22, t26 = t21 & t23, t27 = t24 ^ t26;
  const uint32_t t28 = t25 & t27, t29 = t28 ^ t22, t30 = t23 ^ t24;
  const uint32_t t31 = t22 ^ t26, t32 = t31 & t30, t33 = t32 ^ t24;
  const uint32_t t34 = t23 ^ t33, t35 = t27 ^ t33, t36 = t24 & t35;
  const uint32_t t37 = t36 ^ t34, t38 = t27 ^ t36, t39 = t29 & t38;
  const uint32_t t40 = t25 ^ t39, t41 = t40 ^ t37, t42 = t29 ^ t33;
  const uint32_t t43 = t29 ^ t40, t44 = t33 ^ t37, t45 = t42 ^ t41;
  const uint32_t z0 = t44 & y15, z1 = t37 & y6, z2 = t33 & x7;
  const uint32_t z3 = t43 & y16, z4 = t40 & y1, z5 = t29 & y7;
  const uint32_t z6 = t42 & y11, z7 = t45 & y17, z8 = t41 & y10;
  const uint32_t z9 = t44 & y12, z10 = t37 & y3, z11 = t33 & y4;
  const uint32_t z12 = t43 & y13, z13 = t40 & y5, z14 = t29 & y2;
  const uint32_t z15 = t42 & y9, z16 = t45 & y14, z17 = t41 & y8;
  // bottom linear layer
  const uint32_t t46 = z15 ^ z16, t47 = z10 ^ z11, t48 = z5 ^ z13;
  const uint32_t t49 = z9 ^ z10, t50 = z2 ^ z12, t51 = z2 ^ z5;
  const uint32_t t52 = z7 ^ z8, t53 = z0 ^ z3, t54 = z6 ^ z7;
  const uint32_t t55 = z16 ^ z17, t56 = z12 ^ t48, t57 = t50 ^ t53;
  const uint32_t t58 = z4 ^ t46, t59 = z3 ^ t54, t60 = t46 ^ t57;
  const uint32_t t61 = z14 ^ t57, t62 = t52 ^ t58, t63 = t49 ^ t58;
  const uint32_t t64 = z4 ^ t59, t65 = t61 ^ t62, t66 = z1 ^ t63;
  const uint32_t t67 = t64 ^ t65;
  const uint32_t s3 = t53 ^ t66;
  q[7] = t59 ^ t63;
  q[6] = t64 ^ ~s3;
  q[5] = t55 ^ ~t67;
  q[4] = s3;
  q[3] = t51 ^ t66;
  q[2] = t47 ^ t65;
  q[1] = t56 ^ ~t62;
  q[0] = t48 ^ ~t60;
}

// The state one row down and k columns along (k = round mod 4): the row
// below is the next byte up the word, a column is 2 bits of a byte.
// With k known when the kernel is compiled, k = 0 folds to one rotation.
__device__ __forceinline__ uint32_t ljt_aes_row1(uint32_t w, int k) {
  const int s = (2 * k) & 7;
  const uint32_t m = (0xFFu >> s) * 0x01010101u;
  return (ljt_ror(w, 24 + s) & m) | (ljt_ror(w, 16 + s) & ~m);
}

// Two rows down and 2k columns along.
__device__ __forceinline__ uint32_t ljt_aes_row2(uint32_t w, int k) {
  const int s = (4 * k) & 7;
  const uint32_t m = (0xFFu >> s) * 0x01010101u;
  return (ljt_ror(w, 16 + s) & m) | (ljt_ror(w, 8 + s) & ~m);
}

// MixColumns of a state drifted by k ShiftRows, then the round key whose
// word i is key(i): out = 2 (a0 ^ a1) ^ a1 ^ (a2 ^ a3), with a1 = row1(a)
// and a2 ^ a3 = row2(a0 ^ a1); doubling shifts the bit planes up and
// folds plane 7 into planes 0, 1, 3 and 4 (x^8 = x^4 + x^3 + x + 1).
template <class Key>
__device__ __forceinline__ void ljt_aes_mix(uint32_t s[8], int k,
                                            const Key& key) {
  const uint32_t y0 = ljt_aes_row1(s[0], k), t0 = s[0] ^ y0;
  const uint32_t y1 = ljt_aes_row1(s[1], k), t1 = s[1] ^ y1;
  const uint32_t y2 = ljt_aes_row1(s[2], k), t2 = s[2] ^ y2;
  const uint32_t y3 = ljt_aes_row1(s[3], k), t3 = s[3] ^ y3;
  const uint32_t y4 = ljt_aes_row1(s[4], k), t4 = s[4] ^ y4;
  const uint32_t y5 = ljt_aes_row1(s[5], k), t5 = s[5] ^ y5;
  const uint32_t y6 = ljt_aes_row1(s[6], k), t6 = s[6] ^ y6;
  const uint32_t y7 = ljt_aes_row1(s[7], k), t7 = s[7] ^ y7;
  s[0] = t7 ^ y0 ^ ljt_aes_row2(t0, k) ^ key(0);
  s[1] = t0 ^ t7 ^ y1 ^ ljt_aes_row2(t1, k) ^ key(1);
  s[2] = t1 ^ y2 ^ ljt_aes_row2(t2, k) ^ key(2);
  s[3] = t2 ^ t7 ^ y3 ^ ljt_aes_row2(t3, k) ^ key(3);
  s[4] = t3 ^ t7 ^ y4 ^ ljt_aes_row2(t4, k) ^ key(4);
  s[5] = t4 ^ y5 ^ ljt_aes_row2(t5, k) ^ key(5);
  s[6] = t5 ^ y6 ^ ljt_aes_row2(t6, k) ^ key(6);
  s[7] = t6 ^ y7 ^ ljt_aes_row2(t7, k) ^ key(7);
}

// Column words w of a round key shifted by ShiftRows^-K (row r moved K r
// columns right), the form a key takes in round r, K = r mod 4, into
// k[2c + slot]: the slot a block takes before slicing.
template <int K>
__device__ __forceinline__ void ljt_aes_key_shift(const uint32_t w[4],
                                                  uint32_t k[8], int slot) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    k[2 * j + slot] = (w[j] & 0xFF000000u) |
                      (w[(j - K) & 3] & 0x00FF0000u) |
                      (w[(j - 2 * K) & 3] & 0x0000FF00u) |
                      (w[(j - 3 * K) & 3] & 0x000000FFu);
}

// A round key of block a's keys (column words wa) and block b's (wb) in
// sliced form into k, block a's in the even bits, for a round r with
// r mod 4 = K.
template <int K>
__device__ __forceinline__ void ljt_aes_slice_key(const uint32_t wa[4],
                                                  const uint32_t wb[4],
                                                  uint32_t k[8]) {
  ljt_aes_key_shift<K>(wa, k, 0);
  ljt_aes_key_shift<K>(wb, k, 1);
  ljt_aes_transpose(k);
}

// The same for a round known only at run time.
__device__ __forceinline__ void ljt_aes_slice_keys(int round,
                                                   const uint32_t wa[4],
                                                   const uint32_t wb[4],
                                                   uint32_t k[8]) {
  switch (round & 3) {
    case 0:
      ljt_aes_slice_key<0>(wa, wb, k);
      break;
    case 1:
      ljt_aes_slice_key<1>(wa, wb, k);
      break;
    case 2:
      ljt_aes_slice_key<2>(wa, wb, k);
      break;
    default:
      ljt_aes_slice_key<3>(wa, wb, k);
      break;
  }
}

// Round key r of a pair in sliced form, 8 words with both slots holding
// the key: block a of the pair takes the even bits of ka's words, block
// b the odd bits of kb's.  key(i) is word i.
struct LjtSlicedRound {
  const uint32_t* ka;
  const uint32_t* kb;

  __device__ __forceinline__ uint32_t operator()(int i) const {
    return (ka[i] & 0x55555555u) | (kb[i] & 0xAAAAAAAAu);
  }
};

// Round keys already sliced, 8 words a round (`ljt_aes_slice_keys`),
// block a's from ka and block b's from kb.  Any other key source gives
// `ljt_aes_encrypt_pair` the same `round(r)`: an object whose (i) is
// word i of round key r in sliced form.
struct LjtSlicedKeys {
  const uint32_t* ka;
  const uint32_t* kb;

  __device__ __forceinline__ LjtSlicedRound round(int r) const {
    return LjtSlicedRound{ka + 8 * r, kb + 8 * r};
  }
};

// AddRoundKey: the eight words of `key` into the state.
template <class Key>
__device__ __forceinline__ void ljt_aes_add_key(uint32_t s[8],
                                                const Key& key) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] ^= key(i);
}

// The rotations' closing fix-up: the state after the last round is
// ShiftRows^-2 of the ciphertext, so rows 1 and 3 (bytes 2 and 0 of a
// column word) trade columns c and c + 2 as the pair is unpacked.
__device__ __forceinline__ void ljt_aes_close(uint32_t s[8], uint32_t a[4],
                                              uint32_t b[4]) {
  ljt_aes_transpose(s);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = __byte_perm(s[2 * j], s[2 * (j ^ 2)], 0x3614);
    b[j] = __byte_perm(s[2 * j + 1], s[2 * (j ^ 2) + 1], 0x3614);
  }
}

// Encrypt the pair of blocks a, b (4 big-endian column words each) in
// place, through the caller's eight words s of sliced state;
// keys.round(r)(i) is word i of round key r in sliced form.  One loop
// over the rounds, with no branch in it: MixColumns takes its rotations
// from the round at run time (two funnel shifts and a LOP3 a word for
// each of its two rotations) and folds the round key in, so the key's
// loads issue before the round needs them.  The code stays a couple of
// hundred instructions, which the tile kernels run beside the SHA-1
// rounds of their hashing warp.
template <int NR, class Keys>
__device__ __forceinline__ void ljt_aes_encrypt_pair(const Keys& keys,
                                                     uint32_t a[4],
                                                     uint32_t b[4],
                                                     uint32_t s[8]) {
  static_assert(NR % 4 == 2, "the closing fix-up assumes NR = 2 mod 4");
  ljt_aes_pack(a, b, s);
  ljt_aes_add_key(s, keys.round(0));
#pragma unroll 1
  for (int r = 1; r < NR; ++r) {
    ljt_aes_sbox(s);
    ljt_aes_mix(s, r & 3, keys.round(r));
  }
  ljt_aes_sbox(s);
  ljt_aes_add_key(s, keys.round(NR));
  ljt_aes_close(s, a, b);
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
