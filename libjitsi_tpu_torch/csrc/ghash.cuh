// GHASH's GF(2^128) multiply for Hopper, constant-time: a warp holds the
// hash key's bit matrix in registers and steps Horner's rule with
// popcounts and ballots.
//
// Replaces the GF(2^128) product of libjitsi_tpu/kernels/ghash.py (`ghash`,
// `ghash_grouped`: the 128 x 128 GF(2) matrix of H as an int8 matmul on
// the TPU's MXU; `ghash_grouped_packed`: the same matrix as packed words,
// AND and popcount).  Multiplication by the fixed hash key H = E(K, 0^128)
// is GF(2)-linear, so one Horner step Y <- (Y xor X) * H is the matrix M_H
// applied to a 128-bit vector: bit i of the product is the parity of the
// 128 bits of (row i of M_H) AND (Y xor X).  The port keeps M_H packed,
// [128][4] words a stream (`kernels/ghash.py`: row i's bit j at bit
// 31 - j % 32 of word j / 32, which is also how a 16-byte block reads as
// four big-endian words).
//
// Form: one warp takes a row's Horner chain.  Lane l keeps four matrix
// rows in registers for the whole chain, rows 32q + 31 - l for q = 0..3,
// 16 words.  A step is t = y ^ x (four words, the same on every lane),
// then for each of the four rows 4 AND folded by XOR into one word, a
// popcount and its low bit, then four `__ballot_sync`s that set bit l of
// product word q from lane l: which is bit 31 - l of word q in the packed
// order, so the ballots reassemble the 128-bit y on every lane.  About 38
// instructions a step alone (the latency probe's loop); the GCM tiles read
// x as one broadcast 16-byte shared load from the row's staged GHASH input
// (`gcm_tile.cuh`), where the first form built it on every lane from the
// staged row (8 clamped loads, 4 byte permutes, 4 length masks: 97 a step).
//
// Why this form: no load address and no branch depends on H, the key, the
// GHASH state or the data.  The matrix rows are addressed by the lane and
// by the stream's table row (both public), once a chain; the state never
// leaves registers; a step is the same instructions for every value.  The
// usual fast software GHASH, Shoup's 4-bit or 8-bit tables, indexes a
// table derived from H by state bits, which leaks both through the cache
// and the shared-memory banks.  The other constant-time form, a masked
// shift-and-reduce carry-less multiply of H on one thread (128 masked
// steps a block), issues fewer lane-instructions a block (~1,300 against
// ~3,100 here) but keeps a row's chain on one lane, 128 dependent steps a
// block; here a warp shares the chain, so a packet's tag waits on
// ceil(aad/16) + ceil(ct/16) + 1 steps of ~100 cycles.  Wide launches,
// where issue binds and not a row's latency, favour the other form
// (PERF.md §6).  The header declares no array and no table, has no
// branch, and takes no subscript but a lane's row number
// (tests/test_torch_gcm_ct.py).
#pragma once

#include <cstdint>

// The four packed matrix rows a lane keeps, rows 32q + 31 - lane.
struct LjtGhashRows {
  uint4 q0, q1, q2, q3;
};

// Lane `lane`'s rows of the packed matrix `gm` ([128] uint4 rows, 16-byte
// aligned).
__device__ __forceinline__ LjtGhashRows ljt_ghash_lane_rows(const uint4* gm,
                                                            int lane) {
  return LjtGhashRows{gm[31 - lane], gm[63 - lane], gm[95 - lane],
                      gm[127 - lane]};
}

// Parity of the 128 bits of row m AND t.
__device__ __forceinline__ unsigned ljt_ghash_dot(const uint4 m,
                                                  const uint4 t) {
  return unsigned(__popc((m.x & t.x) ^ (m.y & t.y) ^ (m.z & t.z) ^
                         (m.w & t.w))) & 1u;
}

// One Horner step of GHASH on every lane of the warp (all 32 take part):
// returns (y ^ x) * H, with y and x as four big-endian words.
__device__ __forceinline__ uint4 ljt_ghash_step(const LjtGhashRows& m,
                                                const uint4 y,
                                                const uint4 x) {
  const uint4 t = make_uint4(y.x ^ x.x, y.y ^ x.y, y.z ^ x.z, y.w ^ x.w);
  return make_uint4(__ballot_sync(0xFFFFFFFFu, ljt_ghash_dot(m.q0, t)),
                    __ballot_sync(0xFFFFFFFFu, ljt_ghash_dot(m.q1, t)),
                    __ballot_sync(0xFFFFFFFFu, ljt_ghash_dot(m.q2, t)),
                    __ballot_sync(0xFFFFFFFFu, ljt_ghash_dot(m.q3, t)));
}
