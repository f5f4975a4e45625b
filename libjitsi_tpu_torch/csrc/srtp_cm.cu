// Kernels C and D: fused SRTP AES-CM + HMAC-SHA1 protect and unprotect.
//
// Replace: libjitsi_tpu/transform/srtp/kernel.py `srtp_protect` and
// `srtp_unprotect` (CM path), together with the per-stream key gather of
// libjitsi_tpu/transform/srtp/context.py `_protect_rtp_dev` /
// `_unprotect_rtp_impl`.  The JAX path chains the AES core (the Pallas
// kernel `aes_encrypt_pallas_bitsliced` or an XLA core), the CTR counter
// and window XOR (`ctr_crypt_uniform/_offset`), HMAC-SHA1 (`hmac_sha1`)
// and the byte scatter/gather (`scatter_bytes`, `gather_span`) as
// separate XLA stages over [B, W] planes, and first gathers a
// [B, R, 16] round-key tensor per packet row.
//
// Bound on the H100: operations at the main path's shapes (a 172-byte
// packet: 11 AES blocks + 4 SHA-1 compressions, at least ~4,500
// instructions of the INT32 pipe per row against ~0.4 KB moved).  The
// bound does not see that SHA-1 is sequential within a message: a row
// of k compressions is a chain of 80k dependent rounds, so the longest
// row of a launch sets a latency floor.
//
// The first form (one 32-thread CTA per row) reached ~30x the bound:
// one lane ran the whole HMAC while 31 waited, a 7-block packet left 25
// lanes of the AES-CTR idle, every CTA rebuilt the T-table from constant
// memory at per-lane indices (which the constant cache serializes) and
// regathered its keys, state-indexed T-table lookups conflicted 3-4 ways
// on shared-memory banks, and the hash read the end of every row byte by
// byte.
//
// Design: one CTA of 128 threads per tile of rows, so set-up is paid per
// tile and each kind of work is lane-dense.
//  - A launch sizes its tiles (at most 32 rows) so every SM gets about
//    two: a part of a few thousand rows spreads over the whole card.
//  - Set-up issues every global load before the first shared-memory
//    store, so its round trips to memory overlap: the tile's rows (16
//    bytes a load, kept at a row stride of an odd number of 32-bit words,
//    so a lane-per-row read hits 32 different banks), each row's round
//    keys (16 bytes a load, odd stride too), IV and window, and the S-box
//    for the tile's one T-table (read-only cache, `aes.cuh`).
//  - AES-CTR runs over the tile's (row, keystream block) pairs, so short
//    rows leave no lane idle; a keystream block is XORed into the row
//    word by word when the window starts on a word (every RTP header
//    length), byte by byte otherwise.
//  - HMAC-SHA1 runs one row per lane of warp 0, midstates in registers,
//    message words read whole from the staged row, the ROC and padding
//    merged in registers (`LjtRowMsg`).
//  - Unprotect (D): warp 0 hashes the staged ciphertext while warps 1-3
//    decrypt into a second staged copy that becomes the output.  The tag
//    compare covers every tag byte.
//  - Protect (C): warps 1-3 make the keystream level by level (block k
//    of every row, then block k + 1) and count each level done; warp 0
//    hashes each 64-byte block of its row as soon as the levels under it
//    are complete (`PipedRowMsg`), so the hash runs behind the XOR
//    instead of after it, and sleeps between polls so the shared-memory
//    pipe stays with the producers.
// On the H100 these kernels wait on latency and on instruction issue, not
// on shared-memory banks: one T-table copy per bank (32 KB a tile) lost
// at every shape measured, because it caps the tiles an SM holds.  Rows
// wider than a 32-row tile can hold get fewer rows per tile (at least 3
// at the wrappers' 32,768-byte limit).
//
// Semantics (held byte for byte against the plain PyTorch versions in
// transform/srtp/kernel.py): lengths are clamped to [0, width]; message
// bytes at or past the width read as 0 and tag bytes past it are
// dropped; stream ids are clamped into the table; protect writes the tag
// at the packet length and returns length + tag_len; unprotect checks
// all tag_len bytes with no early exit (a row shorter than its tag
// fails), decrypts [payload_off, mlen) and leaves the tag bytes in the
// output past mlen.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "aes.cuh"
#include "sha1.cuh"

namespace {

constexpr int kThreads = 128;     // warp 0 hashes, warps 1-3 keystream
constexpr int kTileRows = 32;     // rows of a tile: one per lane of warp 0
constexpr int kCtasPerSm = 2;     // tiles a launch aims to give each SM
constexpr int kTeWords = 256;     // the T-table
constexpr int kRowParams = 5;     // off, s, e, j0, cnt
// Shared memory a block may use on sm_90 (H100, H200): 227 KB.
constexpr int kMaxSmemBytes = 232448;

__host__ __device__ constexpr int rk_stride(int nr) {
  return 4 * (nr + 1) + 1;        // odd: rows' keys in different banks
}
__host__ __device__ constexpr int row_stride(int width) {
  return ((width + 3) / 4) | 1;   // words; odd: rows in different banks
}
// Keystream levels of a row (blocks a window can span).
__host__ __device__ constexpr int max_levels(int width) {
  return (width + 15) / 16 + 1;
}
// 32-bit words of shared memory for a tile of `rows` rows: protect keeps
// one staged copy of each row and a counter per keystream level,
// unprotect a second copy of each row.
__host__ __device__ constexpr int tile_words(int rows, int width, int nr,
                                             bool unprotect) {
  return kTeWords + (unprotect ? 0 : max_levels(width)) +
         rows * (rk_stride(nr) + 4 + kRowParams +
                 (unprotect ? 2 : 1) * row_stride(width));
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Tile {
  uint32_t* te;     // [256] T-table
  uint32_t* rk;     // [rows][rk_stride] round keys
  uint32_t* iv;     // [rows][4] counter IVs
  int* off;         // payload_off
  int* s;           // window [s, e) inside the row
  int* e;
  int* j0;          // first keystream block of the window
  int* cnt;         // keystream blocks of the window
  uint32_t* buf;    // [rows][row_stride] the staged input rows
  uint32_t* out;    // [rows][row_stride] unprotect's output rows
  int* level;       // protect: keystream blocks done at each level
  int rows;         // real rows of this tile
  int base;         // first row of the tile
  int stride;       // row_stride(width)
};

__device__ __forceinline__ Tile carve(uint32_t* smem, int tile_rows, int n,
                                      int width, int nr, bool unprotect) {
  Tile t;
  t.te = smem;
  t.rk = t.te + kTeWords;
  t.iv = t.rk + tile_rows * rk_stride(nr);
  t.off = reinterpret_cast<int*>(t.iv + tile_rows * 4);
  t.s = t.off + tile_rows;
  t.e = t.s + tile_rows;
  t.j0 = t.e + tile_rows;
  t.cnt = t.j0 + tile_rows;
  t.stride = row_stride(width);
  t.buf = reinterpret_cast<uint32_t*>(t.cnt + tile_rows);
  t.out = unprotect ? t.buf + tile_rows * t.stride : nullptr;
  t.level = unprotect ? nullptr
                      : reinterpret_cast<int*>(t.buf + tile_rows * t.stride);
  t.base = blockIdx.x * tile_rows;
  t.rows = n - t.base < tile_rows ? n - t.base : tile_rows;
  return t;
}

__device__ __forceinline__ bool aligned(const void* p, int a) {
  return (reinterpret_cast<uintptr_t>(p) & uintptr_t(a - 1)) == 0;
}

// The tile's rows (contiguous in global memory from g) into shared rows
// of `stride` words, and into `dst2` too when given.  Each thread keeps
// kInFlight loads outstanding before it stores, so a tile costs a few
// round trips to memory, not one per load.
constexpr int kInFlight = 8;

template <class V>
__device__ __forceinline__ void put(uint32_t* d, const V& v);
template <>
__device__ __forceinline__ void put<uint4>(uint32_t* d, const uint4& v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
template <>
__device__ __forceinline__ void put<uint32_t>(uint32_t* d, const uint32_t& v) {
  d[0] = v;
}

// Units of V (4 or 16 bytes) from g to the shared rows.
template <class V>
__device__ __forceinline__ void stage_units(const V* g, uint32_t* dst,
                                            uint32_t* dst2, int rows,
                                            int per, int stride) {
  constexpr int kWords = int(sizeof(V) / 4);
  const int total = rows * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += kInFlight * blockDim.x) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * int(blockDim.x);
      if (i < total) v[u] = g[i];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * int(blockDim.x);
      if (i < total) {
        const int r = i / per;
        const int w = r * stride + kWords * (i - r * per);
        put(dst + w, v[u]);
        if (dst2) put(dst2 + w, v[u]);
      }
    }
  }
}

__device__ __forceinline__ void stage_rows(const uint8_t* g, uint32_t* dst,
                                           uint32_t* dst2, int rows,
                                           int width, int stride) {
  if ((width & 15) == 0 && aligned(g, 16)) {
    stage_units(reinterpret_cast<const uint4*>(g), dst, dst2, rows,
                width >> 4, stride);
  } else if ((width & 3) == 0 && aligned(g, 4)) {
    stage_units(reinterpret_cast<const uint32_t*>(g), dst, dst2, rows,
                width >> 2, stride);
  } else {
    uint8_t* d1 = reinterpret_cast<uint8_t*>(dst);
    uint8_t* d2 = reinterpret_cast<uint8_t*>(dst2);
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width;
      const int b = 4 * r * stride + (i - r * width);
      d1[b] = g[i];
      if (d2) d2[b] = g[i];
    }
  }
}

__device__ __forceinline__ void store_rows(const uint32_t* src, uint8_t* g,
                                           int rows, int width, int stride) {
  if ((width & 15) == 0 && aligned(g, 16)) {
    const int per = width >> 4;
    uint4* g4 = reinterpret_cast<uint4*>(g);
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per;
      const uint32_t* w = src + r * stride + 4 * (i - r * per);
      g4[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else if ((width & 3) == 0 && aligned(g, 4)) {
    const int per = width >> 2;
    uint32_t* g1 = reinterpret_cast<uint32_t*>(g);
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per;
      g1[i] = src[r * stride + (i - r * per)];
    }
  } else {
    const uint8_t* s1 = reinterpret_cast<const uint8_t*>(src);
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width;
      g[i] = s1[4 * r * stride + (i - r * width)];
    }
  }
}

// Set-up of a tile: T-table, each row's round keys, IV and keystream
// window [max(off, 0), min(end, width)) with end the packet length
// (protect) or length - tag_len (unprotect), and the staged rows.  Every
// global load is issued before the first shared-memory store, so the
// round trips to memory overlap instead of following one another.
template <int NR>
__device__ __forceinline__ void load_tile(
    const Tile& t, const uint8_t* tab_rk, const int32_t* stream,
    int n_streams, const uint8_t* data, const int32_t* length,
    const int32_t* payload_off, const uint8_t* iv, int width, int end_less) {
  constexpr int kSbox = 256 / kThreads;     // S-box entries a thread turns
  constexpr int kKeyLoads = (NR + 4) / 4;   // 16-byte key loads a thread
  uint32_t sbox[kSbox];
#pragma unroll
  for (int u = 0; u < kSbox; ++u)
    sbox[u] = __ldg(&kLjtSbox[threadIdx.x + u * kThreads]);
  // four threads gather each row's round keys, 16 bytes a load
  const int kr = threadIdx.x >> 2;
  const bool key_vec = aligned(tab_rk, 16);
  const uint8_t* key = nullptr;
  uint4 kv[kKeyLoads];
  if (kr < t.rows) {
    const int sid = clamp_int(stream[t.base + kr], 0, n_streams - 1);
    key = tab_rk + size_t(sid) * (NR + 1) * 16;
#pragma unroll
    for (int u = 0; u < kKeyLoads; ++u) {
      const int q = (threadIdx.x & 3) + 4 * u;
      if (key_vec && q <= NR) kv[u] = reinterpret_cast<const uint4*>(key)[q];
    }
  }
  // one thread per row for its window and IV
  const int r = threadIdx.x;
  const bool iv_vec = aligned(iv, 16);
  int len = 0, off = 0;
  uint4 ivv = make_uint4(0, 0, 0, 0);
  if (r < t.rows) {
    len = length[t.base + r];
    off = payload_off[t.base + r];
    if (iv_vec) ivv = reinterpret_cast<const uint4*>(iv)[t.base + r];
  }
  stage_rows(data + size_t(t.base) * width, t.buf, t.out, t.rows, width,
             t.stride);
  if (t.level)
    for (int i = threadIdx.x; i < max_levels(width); i += blockDim.x)
      t.level[i] = 0;
#pragma unroll
  for (int u = 0; u < kSbox; ++u)
    t.te[threadIdx.x + u * kThreads] = ljt_te0_from_sbox(sbox[u]);
  if (kr < t.rows) {
    uint32_t* d = t.rk + kr * rk_stride(NR);
    if (key_vec) {
#pragma unroll
      for (int u = 0; u < kKeyLoads; ++u) {
        const int q = (threadIdx.x & 3) + 4 * u;
        if (q <= NR) {
          d[4 * q] = ljt_bswap32(kv[u].x);
          d[4 * q + 1] = ljt_bswap32(kv[u].y);
          d[4 * q + 2] = ljt_bswap32(kv[u].z);
          d[4 * q + 3] = ljt_bswap32(kv[u].w);
        }
      }
    } else {
      for (int w = threadIdx.x & 3; w < 4 * (NR + 1); w += 4)
        d[w] = ljt_load_be32(key + 4 * w);
    }
  }
  if (r < t.rows) {
    const int end = clamp_int(len, 0, width) - end_less;
    const int s = off > 0 ? off : 0;
    const int e = end < width ? end : width;
    t.off[r] = off;
    t.s[r] = s;
    t.e[r] = e;
    t.j0[r] = s < e ? (s - off) >> 4 : 0;
    t.cnt[r] = s < e ? ((e - 1 - off) >> 4) - ((s - off) >> 4) + 1 : 0;
    if (iv_vec) {
      t.iv[4 * r] = ljt_bswap32(ivv.x);
      t.iv[4 * r + 1] = ljt_bswap32(ivv.y);
      t.iv[4 * r + 2] = ljt_bswap32(ivv.z);
      t.iv[4 * r + 3] = ljt_bswap32(ivv.w);
    } else {
      const uint8_t* v = iv + size_t(t.base + r) * 16;
#pragma unroll
      for (int k = 0; k < 4; ++k) t.iv[4 * r + k] = ljt_load_be32(v + 4 * k);
    }
  }
}

// XOR keystream block c (4 big-endian words) into row bytes
// [base, base + 16) inside the window [s, e).
__device__ __forceinline__ void xor_block(uint32_t* row, int base, int s,
                                          int e, const uint32_t c[4]) {
  if ((base & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = base + 4 * k;
      const int lo = s - p > 0 ? s - p : 0;
      const int hi = e - p < 4 ? e - p : 4;
      if (lo < hi) {
        const uint32_t keep_hi = hi == 4 ? 0xFFFFFFFFu : (1u << (8 * hi)) - 1;
        const uint32_t mask = keep_hi & ~((1u << (8 * lo)) - 1);
        row[p >> 2] ^= ljt_bswap32(c[k]) & mask;
      }
    }
  } else {
    uint8_t* b = reinterpret_cast<uint8_t*>(row);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = base + k;
      if (col >= s && col < e)
        b[col] ^= uint8_t(c[k >> 2] >> (8 * (3 - (k & 3))));
    }
  }
}

// AES-CTR over the tile's (row, keystream block) pairs, flattened: thread
// `first` of `count` takes every count-th pair.  Rows are XORed in `rows`.
template <int NR>
__device__ __forceinline__ void ctr_tile(const Tile& t, uint32_t* rows,
                                         int first, int count) {
  int total = 0;
  for (int r = 0; r < t.rows; ++r) total += t.cnt[r];
  int r = 0, lo = 0, hi = t.cnt[0];
  for (int f = first; f < total; f += count) {
    while (f >= hi) {
      ++r;
      lo = hi;
      hi += t.cnt[r];
    }
    const int j = t.j0[r] + (f - lo);
    uint32_t c[4];
    ljt_ctr_block(t.iv + 4 * r, uint32_t(j), c);
    ljt_aes_encrypt_block<NR>(t.te, t.rk + r * rk_stride(NR), c);
    xor_block(rows + r * t.stride, t.off[r] + 16 * j, t.s[r], t.e[r], c);
  }
}

// Protect's AES-CTR, level by level: keystream block k of every row of
// the tile, then block k + 1, so the first bytes of every row are ready
// first.  After each pair (a padding pair of a row with fewer blocks
// included) the thread counts it in t.level[k], so level k is complete
// when its count reaches the tile's rows.
template <int NR>
__device__ __forceinline__ void ctr_levels(const Tile& t, int first,
                                           int count) {
  int levels = 0;
  for (int r = 0; r < t.rows; ++r)
    levels = t.cnt[r] > levels ? t.cnt[r] : levels;
  int k = first / t.rows, r = first - k * t.rows;
  const int dk = count / t.rows, dr = count - dk * t.rows;
  for (; k < levels;) {
    if (k < t.cnt[r]) {
      const int j = t.j0[r] + k;
      uint32_t c[4];
      ljt_ctr_block(t.iv + 4 * r, uint32_t(j), c);
      ljt_aes_encrypt_block<NR>(t.te, t.rk + r * rk_stride(NR), c);
      xor_block(t.buf + r * t.stride, t.off[r] + 16 * j, t.s[r], t.e[r], c);
    }
    __threadfence_block();
    atomicAdd(&t.level[k], 1);
    k += dk;
    r += dr;
    if (r >= t.rows) {
      r -= t.rows;
      ++k;
    }
  }
}

// A protect row as the hashing lane reads it: before each 64-byte block it
// waits until every keystream level that block's window bytes need is
// complete.
struct PipedRowMsg {
  LjtRowMsg msg;
  int mlen;
  const int* level;
  int rows, off, s, e, j0;
  mutable int ready;  // levels already seen complete
};

__device__ __forceinline__ void ljt_msg_block(const PipedRowMsg& m, int b,
                                              uint32_t w[16]) {
  const int last = (64 * b + 64 < m.e ? 64 * b + 64 : m.e) - 1;
  if (last >= m.s) {
    const int need = ((last - m.off) >> 4) - m.j0;
    while (m.ready <= need) {
      while (*reinterpret_cast<const volatile int*>(m.level + m.ready) <
             m.rows)
        __nanosleep(64);  // leave the shared-memory pipe to the producers
      ++m.ready;
    }
    __threadfence_block();
  }
  ljt_msg_block(m.msg, b, w);
}

__device__ __forceinline__ void load_mid(const uint32_t* tab_mid, int sid,
                                         uint32_t mid[10]) {
#pragma unroll
  for (int k = 0; k < 10; ++k) mid[k] = tab_mid[size_t(sid) * 10 + k];
}

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_protect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, int n, int width, int tag_len,
    int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, /*unprotect=*/false);
  load_tile<NR>(t, tab_rk, stream, n_streams, data, length, payload_off, iv,
                width, 0);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: the keystream, level by level
    ctr_levels<NR>(t, threadIdx.x - 32, blockDim.x - 32);
  } else if (int(threadIdx.x) < t.rows) {
    // warp 0: one row a lane, each 64-byte block hashed once its
    // ciphertext is complete
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int len_in = length[row];
    const int len = clamp_int(len_in, 0, width);
    uint32_t mid[10];
    load_mid(tab_mid, clamp_int(stream[row], 0, n_streams - 1), mid);
    const LjtRowMsg msg(t.buf + r * t.stride, len, width, roc[row]);
    const PipedRowMsg piped{msg, msg.mlen, t.level, t.rows, t.off[r],
                            t.s[r], t.e[r], t.j0[r], 0};
    uint32_t d[5];
    ljt_hmac_sha1(mid, piped, d);
    uint8_t* b = reinterpret_cast<uint8_t*>(t.buf + r * t.stride);
#pragma unroll
    for (int k = 0; k < 20; ++k)
      if (k < tag_len && len + k < width) b[len + k] = ljt_digest_byte(d, k);
    out_len[row] = len_in + tag_len;
  }
  __syncthreads();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
}

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_unprotect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_mlen, uint8_t* __restrict__ auth_ok, int n,
    int width, int tag_len, int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, /*unprotect=*/true);
  load_tile<NR>(t, tab_rk, stream, n_streams, data, length, payload_off, iv,
                width, tag_len);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: decrypt [payload_off, mlen) into the output copy; the
    // tag bytes past mlen stay
    ctr_tile<NR>(t, t.out, threadIdx.x - 32, blockDim.x - 32);
  } else if (int(threadIdx.x) < t.rows) {
    // warp 0: MAC over ciphertext[:mlen] || ROC, then every tag byte
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int len_in = length[row];
    const int mlen = clamp_int(len_in, 0, width) - tag_len;
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t mid[10];
      load_mid(tab_mid, clamp_int(stream[row], 0, n_streams - 1), mid);
      uint32_t d[5];
      ljt_hmac_sha1(mid, LjtRowMsg(t.buf + r * t.stride, mlen, width, roc[row]),
                    d);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(t.buf + r * t.stride);
      diff = 0;
#pragma unroll
      for (int k = 0; k < 20; ++k)
        if (k < tag_len) diff |= uint32_t(b[mlen + k] ^ ljt_digest_byte(d, k));
    }
    auth_ok[row] = diff == 0;
    out_mlen[row] = len_in - tag_len;
  }
  __syncthreads();
  store_rows(t.out, out + size_t(t.base) * width, t.rows, width, t.stride);
}

// Streaming multiprocessors of the current device (0 if unknown).
int multiprocessors() {
  static std::atomic<int> cached[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 32 && cached[dev].load()) return cached[dev].load();
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 32) cached[dev].store(sms);
  return sms;
}

// Rows per tile for n rows of this width: the fewest rows that still give
// every SM kCtasPerSm tiles (a part of a few thousand rows spreads over
// the whole card instead of a quarter of it), at most a full tile, and
// no more than fit the SM's shared memory (0: the width cannot run).
int tile_rows_for(int n, int width, int nr, bool unprotect) {
  const int fixed = tile_words(0, width, nr, unprotect);
  const int per_row = tile_words(1, width, nr, unprotect) - fixed;
  const int fit = (kMaxSmemBytes / 4 - fixed) / per_row;
  const int ctas = kCtasPerSm * multiprocessors();
  int rows = ctas > 0 ? (n + ctas - 1) / ctas : kTileRows;
  rows = rows < 1 ? 1 : (rows > kTileRows ? kTileRows : rows);
  return fit < rows ? fit : rows;
}

// Allow `kernel` the dynamic shared memory above the 48 KB default, once
// per device (`done` holds one bit per device).
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, std::atomic<unsigned>& done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return int(cudaErrorInvalidValue);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load() & bit)) return 0;
  const int rc = int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes));
  if (rc == 0) done.fetch_or(bit);
  return rc;
}

}  // namespace

extern "C" int ljt_srtp_protect_cm(const void* tab_rk, const void* tab_mid,
                                   const void* stream, int n_streams,
                                   const void* data, const void* length,
                                   const void* payload_off, const void* iv,
                                   const void* roc, void* out, void* out_len,
                                   int n, int width, int nr, int tag_len,
                                   void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 && nr != 14) return int(cudaErrorInvalidValue);
  const int rows = tile_rows_for(n, width, nr, false);
  if (width <= 0 || rows < 1) return int(cudaErrorInvalidValue);
  const int smem = 4 * tile_words(rows, width, nr, false);
  const dim3 grid((n + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define LJT_PROTECT_ARGS                                                    \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint32_t*>(tab_mid), \
      static_cast<const int32_t*>(stream), n_streams,                        \
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length), \
      static_cast<const int32_t*>(payload_off),                              \
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),    \
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), n, width,  \
      tag_len, rows
  int rc;
  if (nr == 10) {
    static std::atomic<unsigned> done;
    rc = allow_smem(srtp_protect_cm_kernel<10>, smem, done);
    if (rc) return rc;
    srtp_protect_cm_kernel<10><<<grid, kThreads, smem, s>>>(LJT_PROTECT_ARGS);
  } else {
    static std::atomic<unsigned> done;
    rc = allow_smem(srtp_protect_cm_kernel<14>, smem, done);
    if (rc) return rc;
    srtp_protect_cm_kernel<14><<<grid, kThreads, smem, s>>>(LJT_PROTECT_ARGS);
  }
#undef LJT_PROTECT_ARGS
  return int(cudaGetLastError());
}

extern "C" int ljt_srtp_unprotect_cm(const void* tab_rk, const void* tab_mid,
                                     const void* stream, int n_streams,
                                     const void* data, const void* length,
                                     const void* payload_off, const void* iv,
                                     const void* roc, void* out,
                                     void* out_mlen, void* auth_ok, int n,
                                     int width, int nr, int tag_len,
                                     void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 && nr != 14) return int(cudaErrorInvalidValue);
  const int rows = tile_rows_for(n, width, nr, true);
  if (width <= 0 || rows < 1) return int(cudaErrorInvalidValue);
  const int smem = 4 * tile_words(rows, width, nr, true);
  const dim3 grid((n + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define LJT_UNPROTECT_ARGS                                                  \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint32_t*>(tab_mid), \
      static_cast<const int32_t*>(stream), n_streams,                        \
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length), \
      static_cast<const int32_t*>(payload_off),                              \
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),    \
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_mlen),           \
      static_cast<uint8_t*>(auth_ok), n, width, tag_len, rows
  int rc;
  if (nr == 10) {
    static std::atomic<unsigned> done;
    rc = allow_smem(srtp_unprotect_cm_kernel<10>, smem, done);
    if (rc) return rc;
    srtp_unprotect_cm_kernel<10><<<grid, kThreads, smem, s>>>(
        LJT_UNPROTECT_ARGS);
  } else {
    static std::atomic<unsigned> done;
    rc = allow_smem(srtp_unprotect_cm_kernel<14>, smem, done);
    if (rc) return rc;
    srtp_unprotect_cm_kernel<14><<<grid, kThreads, smem, s>>>(
        LJT_UNPROTECT_ARGS);
  }
#undef LJT_UNPROTECT_ARGS
  return int(cudaGetLastError());
}
