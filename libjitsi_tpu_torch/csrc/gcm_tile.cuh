// The AEAD-GCM tile (RFC 7714; NIST SP 800-38D) shared by kernels M and N
// (`srtp_gcm.cu`, seal and open, with their cached instances) and kernel
// H's GCM instance (`srtp_fanout.cu`).
//
// A tile is the row tile of the SRTP kernels (`srtp_tile.cuh`): one CTA of
// 128 threads, at most 32 rows, set-up loading rows, keys and per-row
// values in overlapping round trips.  A row's policy (`Rows`) gives its
// AAD as the window start and the end of its ciphertext as the window
// end, and J0 = IV || 0x00000001 as its counter block.  Then:
//  1. CTR (`gcm_ctr_tile`): the tile's (row, block) entries, one more a
//     row than its keystream blocks, flattened and handed out two a thread
//     to the gather-free AES core (`aes.cuh`).  Entry 0 of a row is
//     E(K, J0), the tag mask, kept in shared memory; entry k >= 1 is
//     keystream block k - 1, counter J0 + k = inc32(J0) + (k - 1), XORed
//     into the row (seal: in place; open: into the tile's second copy, so
//     the hash still reads the ciphertext).  J0's low word is 1 and a row
//     has at most 2,048 blocks, so the core's 128-bit counter add never
//     carries and gives GCM's inc32 sequence.  The cached instances run
//     no AES: they XOR each row's slot of the keystream cache instead and
//     read its tag mask from the cache's table (`gcm_ks_tile`).
//  2. GHASH (`gcm_hash_tile`): warp w takes rows w, w + 4, ...; the warp
//     keeps the row's packed matrix in registers (`ghash.cuh`) and steps
//     over the row's real block count, ceil(aad/16) + ceil(ct/16) + 1,
//     each block read from the staged row (all lanes read the same words)
//     with the bytes past the AAD or the ciphertext masked to 0.  Seal
//     writes the tag (digest ^ tag mask) at the row's end, lanes 0-15 a
//     byte each; open compares all 16 bytes with no early exit and
//     writes the verdict.
//  3. The rows are stored.
//
// Nothing here branches on or indexes by the key, H, the GHASH state or
// the data: lengths, offsets, slots and table rows are public
// (tests/test_torch_gcm_ct.py holds the sources to that).
//
// Edge semantics (held against `kernels/gcm.py`): lengths clamped to
// [0, width]; the AAD clamped to the clamped length (seal) or to it less
// the tag (open); seal's tag bytes past the width dropped; open fails a
// row shorter than a tag.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ghash.cuh"
#include "srtp_tile.cuh"

namespace ljt_gcm {

using namespace ljt_tile;

constexpr int kTag = 16;
// Words a row keeps after the tile: its tag mask (4), clamped length,
// matrix row and cache slot.
constexpr int kExtraWords = 7;

struct Extra {
  uint32_t* ek;   // [rows][4] the tag mask E(K, J0), big-endian words
  int* len;       // clamped length
  int* gm_row;    // table row of the packed GHASH matrix
  int* slot;      // the cached instances' slot
};

__device__ __forceinline__ Extra carve_extra(uint32_t* smem, int tile_rows,
                                             int width, int nr, TileKind kind,
                                             int schedules) {
  uint32_t* p = smem + tile_words(tile_rows, width, nr, kind, schedules);
  Extra x;
  x.ek = p;
  x.len = reinterpret_cast<int*>(p + 4 * tile_rows);
  x.gm_row = x.len + tile_rows;
  x.slot = x.gm_row + tile_rows;
  return x;
}

// A row's AAD end and ciphertext end from its length, AAD length and the
// row width: (off, end) for `load_tile`'s window.
__device__ __forceinline__ void gcm_window(int len, int aad, int width,
                                           bool open, int& off, int& end) {
  const int l = ljt_clamp(len, 0, width);
  const int m = open ? (l - kTag > 0 ? l - kTag : 0) : l;
  off = ljt_clamp(aad, 0, m);
  end = m;
}

// AES over the tile's (row, entry) list: entry 0 of row r is E(K, J0) into
// ek[4r..4r+3]; entry k >= 1 is keystream block j0 + k - 1, XORed into
// `rows`.  t.iv holds J0; t.cnt the keystream blocks of a row's window.
template <int NR>
__device__ __forceinline__ void gcm_ctr_tile(const Tile& t, uint32_t* rows,
                                             uint32_t* ek, int first,
                                             int count) {
  int total = 0;
  for (int r = 0; r < t.rows; ++r) total += t.cnt[r] + 1;
  int r = 0, lo = 0, hi = t.cnt[0] + 1;
  for (int f = 2 * first; f < total; f += 2 * count) {
    while (f >= hi) {
      ++r;
      lo = hi;
      hi += t.cnt[r] + 1;
    }
    const bool two = f + 1 < total;
    int rb = r, lob = lo, hib = hi;
    while (two && f + 1 >= hib) {
      ++rb;
      lob = hib;
      hib += t.cnt[rb] + 1;
    }
    const int ja = f - lo, jb = f + 1 - lob;
    uint32_t a[4], b[4], s[8];
    ljt_ctr_block(t.iv + 4 * r, uint32_t(ja), a);
    ljt_ctr_block(t.iv + 4 * rb, uint32_t(jb), b);
    ljt_aes_encrypt_pair<NR>(LjtSlicedKeys{t.rk + r * rk_stride(NR),
                                           t.rk + rb * rk_stride(NR)},
                             a, b, s);
    if (ja == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ek[4 * r + k] = a[k];
    } else {
      xor_block(rows + r * t.stride, t.off[r] + 16 * (t.j0[r] + ja - 1),
                t.s[r], t.e[r], a);
    }
    if (two) {
      if (jb == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) ek[4 * rb + k] = b[k];
      } else {
        xor_block(rows + rb * t.stride, t.off[rb] + 16 * (t.j0[rb] + jb - 1),
                  t.s[rb], t.e[rb], b);
      }
    }
  }
}

// The cached instances' keystream stage: keystream byte k of row r's slot
// (`ks_tab` [n_slots][ks_bytes]) XORed into ciphertext byte k, for k below
// both the ciphertext's length and ks_bytes.
__device__ __forceinline__ void gcm_ks_tile(const Tile& t, const Extra& x,
                                            uint32_t* rows,
                                            const uint8_t* ks_tab,
                                            int ks_bytes) {
  const int total = t.rows * ks_bytes;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / ks_bytes;
    const int k = i - r * ks_bytes;
    const int col = t.off[r] + k;
    if (col < t.e[r])
      reinterpret_cast<uint8_t*>(rows + r * t.stride)[col] ^=
          ks_tab[size_t(x.slot[r]) * ks_bytes + k];
  }
}

// Big-endian word of a staged row's bytes p .. p + 3, bytes at or past
// `lim` as 0 (reads clamped into the row's `stride` words).
__device__ __forceinline__ uint32_t gcm_word(const uint32_t* row, int stride,
                                             int p, int lim) {
  const int q = p >> 2;
  const uint32_t w0 = row[ljt_clamp(q, 0, stride - 1)];
  const uint32_t w1 = row[ljt_clamp(q + 1, 0, stride - 1)];
  const uint32_t v = __byte_perm(w0, w1, 0x0123u + 0x1111u * uint32_t(p & 3));
  const int keep = lim - p;
  const uint32_t mask =
      keep >= 4 ? 0xFFFFFFFFu
                : (keep <= 0 ? 0u : ~(0xFFFFFFFFu >> (8 * keep)));
  return v & mask;
}

// A GHASH input block: 16 row bytes from p, those at or past lim as 0.
__device__ __forceinline__ uint4 gcm_block(const uint32_t* row, int stride,
                                           int p, int lim) {
  return make_uint4(gcm_word(row, stride, p, lim),
                    gcm_word(row, stride, p + 4, lim),
                    gcm_word(row, stride, p + 8, lim),
                    gcm_word(row, stride, p + 12, lim));
}

// Byte k (0..15) of 128 bits held as four big-endian words.
__device__ __forceinline__ uint32_t gcm_byte(const uint4 v, int k) {
  const int w = k >> 2;
  const uint32_t word = w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
  return (word >> (8 * (3 - (k & 3)))) & 0xFFu;
}

// GHASH of each row of the tile over its staged bytes t.buf, AAD [0,
// t.off) and ciphertext [t.off, t.e), a warp a row.  Seal (!Open) writes
// the tag into the row at t.e; open compares it with the 16 bytes there
// and writes auth_ok.
template <bool Open>
__device__ __forceinline__ void gcm_hash_tile(const Tile& t, const Extra& x,
                                              const uint4* tab_gm,
                                              bool* auth_ok, int width) {
  const int warp = int(threadIdx.x) >> 5;
  const int lane = int(threadIdx.x) & 31;
  for (int r = warp; r < t.rows; r += int(blockDim.x) >> 5) {
    const LjtGhashRows ghm =
        ljt_ghash_lane_rows(tab_gm + size_t(x.gm_row[r]) * 128, lane);
    uint32_t* row = t.buf + r * t.stride;
    const int alen = t.off[r];
    const int mend = t.e[r];
    const int nab = (alen + 15) >> 4;
    const int ncb = (mend - alen + 15) >> 4;
    uint4 ghy = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < nab; ++i)
      ghy = ljt_ghash_step(ghm, ghy, gcm_block(row, t.stride, 16 * i, alen));
    for (int i = 0; i < ncb; ++i)
      ghy = ljt_ghash_step(ghm, ghy,
                           gcm_block(row, t.stride, alen + 16 * i, mend));
    ghy = ljt_ghash_step(ghm, ghy, ljt_ghash_lengths(alen, mend - alen));
    const uint32_t* ekr = x.ek + 4 * r;
    const uint4 tag = make_uint4(ghy.x ^ ekr[0], ghy.y ^ ekr[1],
                                 ghy.z ^ ekr[2], ghy.w ^ ekr[3]);
    const uint32_t tagb = gcm_byte(tag, lane & 15);
    uint8_t* bytes = reinterpret_cast<uint8_t*>(row);
    if constexpr (Open) {
      // all 16 bytes compared, the verdict one ballot: no early exit
      const int col = ljt_clamp(mend + (lane & 15), 0, width - 1);
      const unsigned differs = lane < 16 && bytes[col] != tagb;
      const unsigned any = __ballot_sync(0xFFFFFFFFu, differs);
      if (lane == 0) auth_ok[t.base + r] = x.len[r] >= kTag && any == 0u;
    } else {
      if (lane < 16 && mend + lane < width) bytes[mend + lane] = uint8_t(tagb);
    }
  }
}

// The whole GCM tile over a kernel's rows: set-up, keystream (or the
// cached XOR), GHASH and the tag, the store.  `smem` is the kernel's
// dynamic shared memory; `Rows` the row policy (`len(regs)`,
// `key_row(row)`, and for the cached instances `slot(row)`; a policy
// with `kSchedules` 0 loads no round keys).
template <int NR, bool Open, bool Cached, class Rows>
__device__ __forceinline__ void gcm_tile(
    uint32_t* smem, const uint8_t* tab_rk, const uint4* tab_gm,
    const Rows& src, const uint8_t* ks_tab, const uint8_t* ek_tab,
    int n_slots, int ks_bytes, uint8_t* out, int32_t* out_len, bool* auth_ok,
    int n, int width, int tile_rows) {
  constexpr TileKind kKind = Open ? kSecondCopy : kInPlace;
  constexpr int kSched = Cached ? 0 : 1;
  const Tile t = carve(smem, tile_rows, n, width, NR, kKind, kSched);
  const Extra x = carve_extra(smem, tile_rows, width, NR, kKind, kSched);
  const typename Rows::Regs g = load_tile<NR>(t, tab_rk, src, width);
  if (int(threadIdx.x) < t.rows) {
    const int r = threadIdx.x;
    const int len = src.len(g);
    x.len[r] = ljt_clamp(len, 0, width);
    x.gm_row[r] = src.key_row(t.base + r);
    out_len[t.base + r] = Open ? len - kTag : len + kTag;
    if constexpr (Cached) {
      const int si = ljt_clamp(src.slot(t.base + r), 0, n_slots - 1);
      x.slot[r] = si;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x.ek[4 * r + k] = ljt_load_be32(ek_tab + size_t(si) * 16 + 4 * k);
    }
  }
  __syncthreads();
  uint32_t* dst = Open ? t.out : t.buf;
  if constexpr (Cached)
    gcm_ks_tile(t, x, dst, ks_tab, ks_bytes);
  else
    gcm_ctr_tile<NR>(t, dst, x.ek, threadIdx.x, blockDim.x);
  __syncthreads();
  gcm_hash_tile<Open>(t, x, tab_gm, auth_ok, width);
  __syncthreads();
  store_rows(dst, out + size_t(t.base) * width, t.rows, width, t.stride);
}

}  // namespace ljt_gcm
