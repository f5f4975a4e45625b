// Device code of the warp-per-row form, which kernel I (SRTCP protect,
// `srtcp_cm.cu`) alone still runs; C, D, H and J run the row-tile form of
// `srtp_tile.cuh`.
//
// One warp owns one packet row: it stages the row in shared memory, its
// lanes take the row's AES-CTR keystream blocks in turn and XOR them into
// the staged bytes, lane 0 runs the HMAC-SHA1 over the staged row
// (`sha1.cuh`), and the warp writes the row back.  Every block also builds
// the AES T-table once (`aes.cuh`) for its warps.
//
// Shared memory of a block: the T-table (256 words), then per warp its
// round keys (4 * (NR + 1) words) and its staged row (`ljt_row_words`).
#pragma once

#include <cstdint>

#include "aes.cuh"
#include "sha1.cuh"

// Warps a block of the warp-per-row kernels holds, at most.
constexpr int kLjtRowWarps = 4;
// Static shared-memory budget a block of these kernels keeps within, so a
// launch never needs more than the default 48 KB of dynamic shared memory.
constexpr int kLjtRowSmemBytes = 48 * 1024;

__host__ __device__ constexpr int ljt_row_words(int width) {
  return (width + 3) / 4;
}

// Words of shared memory a warp needs beside the block's T-table.
__host__ __device__ constexpr int ljt_warp_words(int width, int nr) {
  return 4 * (nr + 1) + ljt_row_words(width);
}

// Warps a block gets for rows of `width` bytes (0: the width cannot run).
inline int ljt_row_warps(int width, int nr) {
  const int fit = (kLjtRowSmemBytes / 4 - 256) / ljt_warp_words(width, nr);
  return fit < kLjtRowWarps ? fit : kLjtRowWarps;
}

inline int ljt_row_smem(int width, int nr, int warps) {
  return 4 * (256 + warps * ljt_warp_words(width, nr));
}

// This warp's round keys and staged row inside the block's shared memory.
struct LjtWarpRow {
  uint32_t* te;   // the block's T-table
  uint32_t* rk;   // 4 * (NR + 1) big-endian round-key words
  uint32_t* row;  // the staged row, bytes in memory order
  int lane;
};

__device__ __forceinline__ LjtWarpRow ljt_warp_row(uint32_t* smem, int width,
                                                   int nr) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  LjtWarpRow w;
  w.te = smem;
  w.rk = smem + 256 + warp * 4 * (nr + 1);
  w.row = smem + 256 + warps * 4 * (nr + 1) + warp * ljt_row_words(width);
  w.lane = threadIdx.x & 31;
  return w;
}

// The round keys of table row `sid` (tab_rk [S, NR + 1, 16]) as words.
__device__ __forceinline__ void ljt_warp_load_keys(const LjtWarpRow& w,
                                                   const uint8_t* tab_rk,
                                                   int sid, int nr) {
  const uint8_t* k = tab_rk + size_t(sid) * (nr + 1) * 16;
  for (int q = w.lane; q < 4 * (nr + 1); q += 32)
    w.rk[q] = ljt_load_be32(k + 4 * q);
}

// Row bytes [0, width) from global memory into the staged row.
__device__ __forceinline__ void ljt_warp_load_row(const LjtWarpRow& w,
                                                  const uint8_t* g,
                                                  int width) {
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 3) == 0) {
    const uint32_t* g4 = reinterpret_cast<const uint32_t*>(g);
    for (int q = w.lane; q < width / 4; q += 32) w.row[q] = g4[q];
  } else {
    uint8_t* b = reinterpret_cast<uint8_t*>(w.row);
    for (int i = w.lane; i < width; i += 32) b[i] = g[i];
  }
}

__device__ __forceinline__ void ljt_warp_store_row(const LjtWarpRow& w,
                                                   uint8_t* g, int width) {
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 3) == 0) {
    uint32_t* g4 = reinterpret_cast<uint32_t*>(g);
    for (int q = w.lane; q < width / 4; q += 32) g4[q] = w.row[q];
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(w.row);
    for (int i = w.lane; i < width; i += 32) g[i] = b[i];
  }
}

// XOR the AES-CTR keystream into the staged bytes [s, e): column c takes
// keystream byte c - off (s >= off).  Lanes take keystream blocks in turn.
template <int NR>
__device__ __forceinline__ void ljt_warp_ctr(const LjtWarpRow& w,
                                             const uint32_t iv[4], int off,
                                             int s, int e) {
  if (s >= e) return;
  uint8_t* b = reinterpret_cast<uint8_t*>(w.row);
  const int j0 = (s - off) >> 4, j1 = (e - 1 - off) >> 4;
  for (int j = j0 + w.lane; j <= j1; j += 32) {
    uint32_t c[4];
    ljt_ctr_block(iv, uint32_t(j), c);
    ljt_aes_encrypt_block<NR>(w.te, w.rk, c);
    const int base = off + 16 * j;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = base + k;
      if (col >= s && col < e)
        b[col] ^= uint8_t(c[k >> 2] >> (8 * (3 - (k & 3))));
    }
  }
}

// Write bytes of the big-endian word v at [pos, pos + 4), those at or past
// width dropped.
__device__ __forceinline__ void ljt_put_word(uint32_t* row, int pos,
                                             int width, uint32_t v) {
  uint8_t* b = reinterpret_cast<uint8_t*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (pos + k < width) b[pos + k] = uint8_t(v >> (8 * (3 - k)));
}
