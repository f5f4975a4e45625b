// The row-tile form shared by the fused SRTP kernels: C and D
// (`srtp_cm.cu`), K and L (`srtp_f8.cu`), H (`srtp_fanout.cu`), I and J
// (`srtcp_cm.cu`), the F8 and NULL instances of C, D, I and J, and the
// AEAD-GCM tiles of M, N and H's GCM instance (`gcm_tile.cuh`); H's F8
// instance and K and L take its set-up pieces and carving with an F8 tile
// of their own (`srtp_fanout.cu`, `srtp_f8.cu`).
//
// One CTA of 128 threads takes a tile of rows, so set-up is paid per tile
// and each kind of work is lane-dense:
//  - A launch sizes its tiles (at most 32 rows) so every SM gets a few
//    (two for C and D, four for H and J): a part of a few thousand rows
//    spreads over the whole card.
//  - Set-up issues every global load before the first shared-memory
//    store, so its round trips to memory overlap: the tile's rows (16
//    bytes a load, kept at a row stride of an odd number of 32-bit words,
//    so a lane-per-row read hits 32 different banks), each row's round
//    keys (16 bytes a load, odd stride too), the per-row values the
//    kernel's `Rows` policy loads (length, offset, IV or what it is built
//    from).  Each row's round keys are then shifted and sliced into the
//    form of the gather-free AES core (`aes.cuh`): 8 words a round, both
//    block slots holding the key.
//  - AES-CTR runs over the tile's flattened (row, keystream block) list,
//    two consecutive entries a thread (the core encrypts a pair of
//    blocks; when the two belong to different rows, each takes its own
//    row's key), so short rows leave no lane idle; a keystream block is
//    XORed into the row word by word when the window starts on a word
//    (every RTP header length), byte by byte otherwise.
//  - HMAC-SHA1 runs one row per lane of warp 0, midstates in registers,
//    message words read whole from the staged row, the ROC or SRTCP word
//    and the padding merged in registers (`LjtRowMsg`).
//  - Unprotect (D, J): warp 0 hashes the staged ciphertext while warps
//    1-3 decrypt into a second staged copy that becomes the output
//    (`ctr_tile`).  Protect: C hashes behind keystream levels
//    (`srtp_cm.cu`); H and I encrypt in place with all four warps, then
//    hash (`srtp_fanout.cu`, `srtcp_cm.cu`).
// Rows wider than a 32-row tile can hold get fewer rows per tile (at
// least 3 at the wrappers' 32,768-byte limit), and a launch raises the
// dynamic shared-memory limit where a tile needs more than 48 KB.  The
// AEAD-GCM tiles (`gcm_tile.cuh`) take this set-up, carving and plan with
// 256 threads a CTA and two tiles an SM, and put each row's staged GHASH
// input before the tile and nine words a row after it (`plan`'s `extra`:
// at least 2 rows a tile at 32,768 bytes for open, 3 for seal).
//
// A kernel says where its rows, keys and windows come from with a `Rows`
// policy (see `load_tile`): the table row of a row's keys, the global
// bytes of its staged row, the per-row values it loads, and from them
// the row's payload offset, the end of its keystream window and its IV.
// A policy may also say how many key schedules a row carries
// (`kSchedules`): 1 by default (k_e), 2 for AES-F8 (k_e and k_e XOR m,
// `tab_f8`), 0 for the NULL cipher, whose tiles load no round keys.
//
// AES-F8 (RFC 3711 §4.1.2; K, L, H's F8 instance and the F8 instances
// of I and J) is sequential over a row's blocks, so `f8_tile` (I's and
// J's) gives a thread two rows and walks both chains in lockstep, one pair
// of blocks a step; H-F8, K and L walk them the same way in their own
// tiles (`f8_chain_rows`) under each pair's schedules sliced together
// (`slice_f8_schedules`), counting each step so H-F8's copies and K's
// rows are hashed behind the chains (`ChainedRowMsg`).
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "aes.cuh"
#include "sha1.cuh"

namespace ljt_tile {

constexpr int kThreads = 128;     // warp 0 hashes; keystream on the rest
constexpr int kTileRows = 32;     // rows of a tile: one per lane of warp 0
// Tiles a launch aims to give each SM: C and D take two; H, I and J,
// whose launches on the SFU path are a few thousand rows or fewer, four,
// which measured faster at every SFU shape (more hashing warps, shorter
// tiles).
constexpr int kCtasPerSm = 2;
constexpr int kCtasPerSmSfu = 4;
constexpr int kRowParams = 5;     // off, s, e, j0, cnt
// Shared memory a block may use on sm_90 (H100, H200): 227 KB.
constexpr int kMaxSmemBytes = 232448;

__host__ __device__ constexpr int rk_stride(int nr) {
  return 8 * (nr + 1) + 1;        // sliced keys; odd: rows in different banks
}
__host__ __device__ constexpr int row_stride(int width) {
  return ((width + 3) / 4) | 1;   // words; odd: rows in different banks
}
// Keystream levels of a row (blocks a window can span).
__host__ __device__ constexpr int max_levels(int width) {
  return (width + 15) / 16 + 1;
}
// What a tile keeps beside its staged rows: a counter per keystream level
// (C, which hashes behind the levels), nothing (H, which encrypts in
// place and then hashes), or a second copy of each row that the
// keystream decrypts into while the first is hashed (D, J).
enum TileKind { kLevels, kInPlace, kSecondCopy };
// 32-bit words of shared memory for a tile of `rows` rows whose rows
// carry `schedules` key schedules (0, 1 or 2), and `extra` words a row
// that a kernel keeps after the tile (the GCM tiles' tag masks).
__host__ __device__ constexpr int tile_words(int rows, int width, int nr,
                                             TileKind kind,
                                             int schedules = 1,
                                             int extra = 0) {
  return (kind == kLevels ? max_levels(width) : 0) +
         rows * (schedules * rk_stride(nr) + 4 + kRowParams + extra +
                 (kind == kSecondCopy ? 2 : 1) * row_stride(width));
}

struct Tile {
  uint32_t* rk;     // [rows][rk_stride] sliced round keys, 8 words a round
  uint32_t* rk2;    // F8: [rows][rk_stride] the k_e XOR m schedules
  uint32_t* iv;     // [rows][4] counter IVs
  int* off;         // payload_off
  int* s;           // window [s, e) inside the row
  int* e;
  int* j0;          // first keystream block of the window
  int* cnt;         // keystream blocks of the window
  uint32_t* buf;    // [rows][row_stride] the staged input rows
  uint32_t* out;    // [rows][row_stride] kSecondCopy: the output rows
  int* level;       // kLevels: keystream blocks done at each level
  int rows;         // real rows of this tile
  int base;         // first row of the tile
  int stride;       // row_stride(width)
};

__device__ __forceinline__ Tile carve(uint32_t* smem, int tile_rows, int n,
                                      int width, int nr, TileKind kind,
                                      int schedules = 1) {
  Tile t;
  t.rk = smem;
  t.rk2 = schedules == 2 ? smem + tile_rows * rk_stride(nr) : nullptr;
  t.iv = t.rk + schedules * tile_rows * rk_stride(nr);
  t.off = reinterpret_cast<int*>(t.iv + tile_rows * 4);
  t.s = t.off + tile_rows;
  t.e = t.s + tile_rows;
  t.j0 = t.e + tile_rows;
  t.cnt = t.j0 + tile_rows;
  t.stride = row_stride(width);
  t.buf = reinterpret_cast<uint32_t*>(t.cnt + tile_rows);
  t.out = kind == kSecondCopy ? t.buf + tile_rows * t.stride : nullptr;
  t.level = kind == kLevels
                ? reinterpret_cast<int*>(t.buf + tile_rows * t.stride)
                : nullptr;
  t.base = blockIdx.x * tile_rows;
  t.rows = n - t.base < tile_rows ? n - t.base : tile_rows;
  return t;
}

__device__ __forceinline__ bool aligned(const void* p, int a) {
  return (reinterpret_cast<uintptr_t>(p) & uintptr_t(a - 1)) == 0;
}

// The global bytes a tile stages.  C, D and J stage rows base .. base +
// rows of their input, one after another from `g`; H stages for row r
// the packet src[base + r] names.
struct TileRows {
  const uint8_t* g;  // the tile's first row

  __device__ __forceinline__ bool vec(int a, int width) const {
    return (width & (a - 1)) == 0 && aligned(g, a);
  }
  // unit i (of V) of the tile's rows, `per` units a row
  template <class V>
  __device__ __forceinline__ V unit(int i, int) const {
    return reinterpret_cast<const V*>(g)[i];
  }
  __device__ __forceinline__ uint8_t byte(int i, int) const { return g[i]; }
};

struct GatheredRows {
  const uint8_t* data;  // [n_src, width] packets
  const int32_t* src;   // packet of each row, clamped into [0, n_src)
  int n_src, base, width;

  __device__ __forceinline__ bool vec(int a, int) const {
    return (width & (a - 1)) == 0 && aligned(data, a);
  }
  __device__ __forceinline__ const uint8_t* row(int r) const {
    return data + size_t(ljt_clamp(src[base + r], 0, n_src - 1)) * width;
  }
  template <class V>
  __device__ __forceinline__ V unit(int i, int per) const {
    const int r = i / per;
    return reinterpret_cast<const V*>(row(r))[i - r * per];
  }
  __device__ __forceinline__ uint8_t byte(int i, int) const {
    const int r = i / width;
    return row(r)[i - r * width];
  }
};

// The tile's rows into shared rows of `stride` words, and into `dst2` too
// when given.  Each thread keeps kInFlight loads outstanding before it
// stores, so a tile costs a few round trips to memory, not one per load.
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

// Units of V (4 or 16 bytes) from the tile's rows to the shared rows.
template <class V, class Src>
__device__ __forceinline__ void stage_units(const Src& g, uint32_t* dst,
                                            uint32_t* dst2, int rows,
                                            int per, int stride) {
  constexpr int kWords = int(sizeof(V) / 4);
  const int total = rows * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += kInFlight * blockDim.x) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * int(blockDim.x);
      if (i < total) v[u] = g.template unit<V>(i, per);
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

template <class Src>
__device__ __forceinline__ void stage_rows(const Src& g, uint32_t* dst,
                                           uint32_t* dst2, int rows,
                                           int width, int stride) {
  if (g.vec(16, width)) {
    stage_units<uint4>(g, dst, dst2, rows, width >> 4, stride);
  } else if (g.vec(4, width)) {
    stage_units<uint32_t>(g, dst, dst2, rows, width >> 2, stride);
  } else {
    uint8_t* d1 = reinterpret_cast<uint8_t*>(dst);
    uint8_t* d2 = reinterpret_cast<uint8_t*>(dst2);
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width;
      const int b = 4 * r * stride + (i - r * width);
      const uint8_t v = g.byte(i, width);
      d1[b] = v;
      if (d2) d2[b] = v;
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

// Set-up of a tile: each row's sliced round keys, IV and keystream
// window [max(off, 0), min(end, width)), and the staged rows.  Every
// global load is issued before the first shared-memory store, so the
// round trips to memory overlap instead of following one another.
//
// `Rows` gives, for row `row` of the launch: `key_row(row)`, the table
// row of its round keys; `staged(base)`, the bytes to stage (`TileRows`
// or `GatheredRows`); `lead(row)`, the row's loads that others depend on
// (`Rows::Lead`, empty where none do); `load(row, lead)`, the row's
// other loads (`Rows::Regs`); both made by thread r of the tile, which is
// lane r of the hashing warp; and `window(regs, row, width, off, end,
// iv)`, its payload offset, window end and IV from them.  A row's lead
// loads are issued before the first load that waits on a loaded value, so
// they share its round trip.  Returns thread r's `Regs`, so the hashing
// lane keeps what it loaded.
// Key schedules a `Rows` policy's rows carry: its `kSchedules`, else 1.
template <class Rows, class = void>
struct Schedules : std::integral_constant<int, 1> {};
template <class Rows>
struct Schedules<Rows, std::void_t<decltype(Rows::kSchedules)>>
    : std::integral_constant<int, Rows::kSchedules> {};

// A row's round keys from the table row `key` (loaded as kv[] where the
// table is 16-byte aligned) into the core's sliced form at d: this
// thread's rounds (thread 4k + i takes rounds i, i + 4, ...).
template <int NR>
__device__ __forceinline__ void slice_row_keys(uint32_t* d, const uint4* kv,
                                               const uint8_t* key,
                                               bool key_vec) {
#pragma unroll
  for (int u = 0; u < (NR + 4) / 4; ++u) {
    const int q = (threadIdx.x & 3) + 4 * u;
    if (q <= NR) {
      uint32_t w[4], o[8];
      if (key_vec) {
        w[0] = ljt_bswap32(kv[u].x);
        w[1] = ljt_bswap32(kv[u].y);
        w[2] = ljt_bswap32(kv[u].z);
        w[3] = ljt_bswap32(kv[u].w);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = ljt_load_be32(key + 16 * q + 4 * k);
      }
      ljt_aes_slice_keys(q, w, w, o);
#pragma unroll
      for (int k = 0; k < 8; ++k) d[8 * q + k] = o[k];
    }
  }
}

// Round keys sliced for a pair of blocks, each block slot already holding
// its own block's key (`ljt_aes_slice_keys` of the two blocks' keys, or
// of one key twice): round r's word i is k[8r + i], read as it is, with
// no merge of two schedules a round (kernel O's runs, H-F8's chains).
struct LjtPairRound {
  const uint32_t* k;
  __device__ __forceinline__ uint32_t operator()(int i) const { return k[i]; }
};
struct LjtPairKeys {
  const uint32_t* k;
  __device__ __forceinline__ LjtPairRound round(int r) const {
    return LjtPairRound{k + 8 * r};
  }
};

template <int NR, class Rows>
__device__ __forceinline__ typename Rows::Regs load_tile(
    const Tile& t, const uint8_t* tab_rk, const Rows& src, int width) {
  constexpr int kKeyLoads = (NR + 4) / 4;   // 16-byte key loads a thread
  constexpr int kSched = Schedules<Rows>::value;
  // four threads gather each row's round keys, 16 bytes a load (thread
  // 4k + i takes rounds i, i + 4, ...), and one thread per row loads its
  // window and IV
  const int kr = threadIdx.x >> 2;
  const int r = threadIdx.x;
  const bool key_vec = aligned(tab_rk, 16);
  const uint8_t* key = nullptr;
  const uint8_t* key2 = nullptr;
  bool key2_vec = false;
  uint4 kv[kKeyLoads];
  uint4 kv2[kSched == 2 ? kKeyLoads : 1];
  int sid = 0;
  if (kSched > 0 && kr < t.rows) sid = src.key_row(t.base + kr);
  typename Rows::Lead lead{};
  if (r < t.rows) lead = src.lead(t.base + r);
  if (kSched > 0 && kr < t.rows) {
    key = tab_rk + size_t(sid) * (NR + 1) * 16;
#pragma unroll
    for (int u = 0; u < kKeyLoads; ++u) {
      const int q = (threadIdx.x & 3) + 4 * u;
      if (key_vec && q <= NR) kv[u] = reinterpret_cast<const uint4*>(key)[q];
    }
    if constexpr (kSched == 2) {
      key2 = src.tab_f8 + size_t(sid) * (NR + 1) * 16;
      key2_vec = aligned(src.tab_f8, 16);
#pragma unroll
      for (int u = 0; u < kKeyLoads; ++u) {
        const int q = (threadIdx.x & 3) + 4 * u;
        if (key2_vec && q <= NR)
          kv2[u] = reinterpret_cast<const uint4*>(key2)[q];
      }
    }
  }
  typename Rows::Regs regs{};
  if (r < t.rows) regs = src.load(t.base + r, lead);
  stage_rows(src.staged(t.base), t.buf, t.out, t.rows, width, t.stride);
  if (t.level)
    for (int i = threadIdx.x; i < max_levels(width); i += blockDim.x)
      t.level[i] = 0;
  if (kSched > 0 && kr < t.rows) {
    slice_row_keys<NR>(t.rk + kr * rk_stride(NR), kv, key, key_vec);
    if constexpr (kSched == 2)
      slice_row_keys<NR>(t.rk2 + kr * rk_stride(NR), kv2, key2, key2_vec);
  }
  if (r < t.rows) {
    int off, end;
    uint32_t iv[4];
    src.window(regs, t.base + r, width, off, end, iv);
    const int s = off > 0 ? off : 0;
    const int e = end < width ? end : width;
    t.off[r] = off;
    t.s[r] = s;
    t.e[r] = e;
    t.j0[r] = s < e ? (s - off) >> 4 : 0;
    t.cnt[r] = s < e ? ((e - 1 - off) >> 4) - ((s - off) >> 4) + 1 : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) t.iv[4 * r + k] = iv[k];
  }
  return regs;
}

// A 16-byte IV read as 4 big-endian words: from the uint4 loaded in
// set-up when the IVs are 16-byte aligned, else byte by byte.
__device__ __forceinline__ void iv_words(bool vec, const uint4& v,
                                         const uint8_t* p, uint32_t iv[4]) {
  if (vec) {
    iv[0] = ljt_bswap32(v.x);
    iv[1] = ljt_bswap32(v.y);
    iv[2] = ljt_bswap32(v.z);
    iv[3] = ljt_bswap32(v.w);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) iv[k] = ljt_load_be32(p + 4 * k);
  }
}

// The rows of the SRTP kernels C, D, K and L and their NULL instances:
// staged from the tile's first row on, keys by stream id, one IV a row
// given, the window from payload_off to the clamped length less
// `end_less` (0 for protect, the tag for unprotect).
struct SrtpRows {
  const int32_t* stream;
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const int32_t* payload_off;
  const uint8_t* iv;
  int width, end_less;

  struct Lead {};
  struct Regs {
    int len, off;
    uint4 iv;
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(stream[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ TileRows staged(int base) const {
    return TileRows{data + size_t(base) * width};
  }
  __device__ __forceinline__ Lead lead(int) const { return {}; }
  __device__ __forceinline__ Regs load(int row, const Lead&) const {
    Regs g{length[row], payload_off[row], make_uint4(0, 0, 0, 0)};
    if (aligned(iv, 16)) g.iv = reinterpret_cast<const uint4*>(iv)[row];
    return g;
  }
  __device__ __forceinline__ void window(const Regs& g, int row, int w,
                                         int& off, int& end,
                                         uint32_t ivw[4]) const {
    off = g.off;
    end = ljt_clamp(g.len, 0, w) - end_less;
    iv_words(aligned(iv, 16), g.iv, iv + size_t(row) * 16, ivw);
  }
};

// The cipher of a kernel instance: AES-CM (C, D, H, I, J), AES-F8 (K, L
// and the F8 instances of I and J) or NULL (the NULL instances of C, D, I
// and J, which authenticate only).
enum Cipher { kCm, kF8, kNull };

__host__ __device__ constexpr int schedules_of(Cipher c) {
  return c == kF8 ? 2 : (c == kNull ? 0 : 1);
}

// A policy's rows carrying a second schedule, k_e XOR m from `tab_f8`
// (AES-F8), or none (NULL).
template <class Base>
struct F8Rows : Base {
  static constexpr int kSchedules = 2;
  const uint8_t* tab_f8;
};
template <class Base>
struct NullRows : Base {
  static constexpr int kSchedules = 0;
};

template <Cipher C, class Base>
using CipherRows = std::conditional_t<
    C == kF8, F8Rows<Base>, std::conditional_t<C == kNull, NullRows<Base>, Base>>;

template <Cipher C, class Base>
__device__ __forceinline__ CipherRows<C, Base> cipher_rows(
    const Base& base, const uint8_t* tab_f8) {
  if constexpr (C == kF8)
    return F8Rows<Base>{base, tab_f8};
  else if constexpr (C == kNull)
    return NullRows<Base>{base};
  else
    return base;
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

// AES-CTR over the tile's (row, keystream block) entries, flattened:
// thread `first` of `count` takes every count-th pair of consecutive
// entries, which may lie in two rows (then each block is under its own
// row's keys) or, at the end, be one entry alone (then the second block
// is encrypted and dropped).  Rows are XORed in `rows`.
template <int NR>
__device__ __forceinline__ void ctr_tile(const Tile& t, uint32_t* rows,
                                         int first, int count) {
  int total = 0;
  for (int r = 0; r < t.rows; ++r) total += t.cnt[r];
  int r = 0, lo = 0, hi = t.cnt[0];
  for (int f = 2 * first; f < total; f += 2 * count) {
    while (f >= hi) {
      ++r;
      lo = hi;
      hi += t.cnt[r];
    }
    const bool two = f + 1 < total;
    int rb = r, lob = lo, hib = hi;
    while (two && f + 1 >= hib) {
      ++rb;
      lob = hib;
      hib += t.cnt[rb];
    }
    const int ja = t.j0[r] + (f - lo), jb = t.j0[rb] + (f + 1 - lob);
    uint32_t a[4], b[4], s[8];
    ljt_ctr_block(t.iv + 4 * r, uint32_t(ja), a);
    ljt_ctr_block(t.iv + 4 * rb, uint32_t(jb), b);
    ljt_aes_encrypt_pair<NR>(LjtSlicedKeys{t.rk + r * rk_stride(NR),
                                           t.rk + rb * rk_stride(NR)},
                             a, b, s);
    xor_block(rows + r * t.stride, t.off[r] + 16 * ja, t.s[r], t.e[r], a);
    if (two)
      xor_block(rows + rb * t.stride, t.off[rb] + 16 * jb, t.s[rb], t.e[rb],
                b);
  }
}

// AES-F8 (RFC 3711 §4.1.2) over the tile's rows: thread `first` of
// `count` takes rows 2i and 2i + 1 (i = first, first + count, ...) and
// walks both rows' keystream chains in lockstep, one pair of blocks a
// step, each block under its own row's keys.  Step 0 is IV' = E(k_e XOR m,
// IV) under the rows' second schedules; then S(j) = E(k_e, IV' ^ j ^
// S(j - 1)), S(-1) = 0, with j XORed big-endian into bytes 12-15 only
// (word 3), and each S(j) XORed into its row's window as it comes.  A row
// with fewer blocks stops contributing while the other goes on; a tile of
// odd rows gives its last thread one row (the second slot encrypts row
// 2i again and is dropped).  Rows are XORed in `rows`.
template <int NR>
__device__ __forceinline__ void f8_tile(const Tile& t, uint32_t* rows,
                                        int first, int count) {
  for (int ra = 2 * first; ra < t.rows; ra += 2 * count) {
    const bool two = ra + 1 < t.rows;
    const int rb = two ? ra + 1 : ra;
    // blocks each chain needs: every block up to the window's last
    const int na = t.j0[ra] + t.cnt[ra];
    const int nb = two ? t.j0[rb] + t.cnt[rb] : 0;
    const int steps = na > nb ? na : nb;
    if (steps == 0) continue;
    uint32_t a[4], b[4], s[8], ia[4], ib[4], pa[4], pb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = t.iv[4 * ra + k];
      b[k] = t.iv[4 * rb + k];
    }
    ljt_aes_encrypt_pair<NR>(LjtSlicedKeys{t.rk2 + ra * rk_stride(NR),
                                           t.rk2 + rb * rk_stride(NR)},
                             a, b, s);
    // ia, ib: IV'; pa, pb: S(j - 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ia[k] = a[k];
      ib[k] = b[k];
      pa[k] = 0;
      pb[k] = 0;
    }
    const LjtSlicedKeys ke{t.rk + ra * rk_stride(NR),
                           t.rk + rb * rk_stride(NR)};
    for (int j = 0; j < steps; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = ia[k] ^ pa[k];
        b[k] = ib[k] ^ pb[k];
      }
      a[3] ^= uint32_t(j);
      b[3] ^= uint32_t(j);
      ljt_aes_encrypt_pair<NR>(ke, a, b, s);
      if (j < na)
        xor_block(rows + ra * t.stride, t.off[ra] + 16 * j, t.s[ra], t.e[ra],
                  a);
      if (j < nb)
        xor_block(rows + rb * t.stride, t.off[rb] + 16 * j, t.s[rb], t.e[rb],
                  b);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pa[k] = a[k];
        pb[k] = b[k];
      }
    }
  }
}

// AES-F8 as H's F8 instance, K and L walk it (`srtp_fanout.cu`,
// `srtp_f8.cu`): thread i
// of the first half takes rows i and i + half and walks both chains in
// lockstep as `f8_tile` does, under the pair's schedules sliced together
// (t.rk2 and t.rk at pair i: block a's slot row i's key, block b's row i
// + half's), and after each step's XOR raises the rows' `done`
// (keystream blocks of the chain XORed), so a hashing lane can read each
// block of a row as it becomes final.  `iv_stamp` (a phase probe's;
// nullptr otherwise) takes the clock when IV' is done.
template <int NR>
__device__ __forceinline__ void f8_chain_rows(const Tile& t, uint32_t* rows,
                                              int* done, int i,
                                              long long* iv_stamp = nullptr) {
  const int half = (t.rows + 1) >> 1;
  if (i >= half) return;
  const int ra = i;
  const bool two = i + half < t.rows;
  const int rb = two ? i + half : ra;
  const int na = t.j0[ra] + t.cnt[ra];
  const int nb = two ? t.j0[rb] + t.cnt[rb] : 0;
  const int steps = na > nb ? na : nb;
  if (steps == 0) return;
  uint32_t a[4], b[4], s[8], ia[4], ib[4], pa[4], pb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = t.iv[4 * ra + k];
    b[k] = t.iv[4 * rb + k];
  }
  ljt_aes_encrypt_pair<NR>(LjtPairKeys{t.rk2 + i * rk_stride(NR)}, a, b, s);
  if (iv_stamp) *iv_stamp = clock64();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ia[k] = a[k];
    ib[k] = b[k];
    pa[k] = 0;
    pb[k] = 0;
  }
  volatile int* vd = done;
  const LjtPairKeys ke{t.rk + i * rk_stride(NR)};
  for (int j = 0; j < steps; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = ia[k] ^ pa[k];
      b[k] = ib[k] ^ pb[k];
    }
    a[3] ^= uint32_t(j);
    b[3] ^= uint32_t(j);
    ljt_aes_encrypt_pair<NR>(ke, a, b, s);
    if (j < na)
      xor_block(rows + ra * t.stride, t.off[ra] + 16 * j, t.s[ra], t.e[ra],
                a);
    if (j < nb)
      xor_block(rows + rb * t.stride, t.off[rb] + 16 * j, t.s[rb], t.e[rb],
                b);
    __threadfence_block();
    if (j < na) vd[ra] = j + 1;
    if (j < nb) vd[rb] = j + 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pa[k] = a[k];
      pb[k] = b[k];
    }
  }
}

// A row's MAC message as its hashing lane reads it behind the chain
// (`f8_chain_rows`; H-F8's copies, K's rows):
// before each 64-byte block it waits until the chain has XORed every
// keystream block that covers the block's window bytes (`done`).
struct ChainedRowMsg {
  LjtRowMsg msg;
  int mlen;
  const int* done;
  int off, s, e;
};

__device__ __forceinline__ void ljt_msg_block(const ChainedRowMsg& m, int b,
                                              uint32_t w[16]) {
  const int last = (64 * b + 64 < m.e ? 64 * b + 64 : m.e) - 1;
  if (last >= m.s) {
    const int need = ((last - m.off) >> 4) + 1;
    while (*reinterpret_cast<const volatile int*>(m.done) < need)
      __nanosleep(64);
    __threadfence_block();
  }
  ljt_msg_block(m.msg, b, w);
}

// Both round-key schedules of a tile's chain pairs (`f8_chain_rows`: rows
// i and i + half), by table row (`ids`, clamped into the tables: H-F8's
// legs, K's and L's streams): each round key of rows i and i + half
// sliced together, k_e from tab_rk into t.rk and k_e XOR m from tab_f8
// into t.rk2 at pair i.  A task is one round key of one pair, in the
// order (schedule, round, pair), so a warp's lanes mostly share a round
// and its form of the key shift; each of the CTA's `threads` threads
// takes tasks tid, tid + threads, ..., kInFlight pairs of loads in
// flight.
template <int NR>
__device__ __forceinline__ void slice_f8_schedules(const Tile& t,
                                                   const uint8_t* tab_rk,
                                                   const uint8_t* tab_f8,
                                                   const int32_t* ids,
                                                   int n_streams,
                                                   int threads) {
  const int half = (t.rows + 1) >> 1;
  const int per = (NR + 1) * half;
  const int tasks = 2 * per;
  // the table row of round `round` of row r's schedule `sch`, 16 bytes
  auto key = [&](int sch, int r, int round) {
    const int id = ljt_clamp(ids[t.base + r], 0, n_streams - 1);
    return (sch ? tab_f8 : tab_rk) + (size_t(id) * (NR + 1) + round) * 16;
  };
  for (int q0 = threadIdx.x; q0 < tasks; q0 += kInFlight * threads) {
    uint4 ka[kInFlight], kb[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int q = q0 + u * threads;
      if (q < tasks) {
        const int sch = q >= per;
        const int rem = q - sch * per;
        const int round = rem / half;
        const int i = rem - round * half;
        const int rb = i + half < t.rows ? i + half : i;
        if (aligned(sch ? tab_f8 : tab_rk, 16)) {
          ka[u] = *reinterpret_cast<const uint4*>(key(sch, i, round));
          kb[u] = *reinterpret_cast<const uint4*>(key(sch, rb, round));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int q = q0 + u * threads;
      if (q < tasks) {
        const int sch = q >= per;
        const int rem = q - sch * per;
        const int round = rem / half;
        const int i = rem - round * half;
        const int rb = i + half < t.rows ? i + half : i;
        uint32_t wa[4], wb[4], o[8];
        if (aligned(sch ? tab_f8 : tab_rk, 16)) {
          wa[0] = ljt_bswap32(ka[u].x);
          wa[1] = ljt_bswap32(ka[u].y);
          wa[2] = ljt_bswap32(ka[u].z);
          wa[3] = ljt_bswap32(ka[u].w);
          wb[0] = ljt_bswap32(kb[u].x);
          wb[1] = ljt_bswap32(kb[u].y);
          wb[2] = ljt_bswap32(kb[u].z);
          wb[3] = ljt_bswap32(kb[u].w);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wa[c] = ljt_load_be32(key(sch, i, round) + 4 * c);
            wb[c] = ljt_load_be32(key(sch, rb, round) + 4 * c);
          }
        }
        ljt_aes_slice_keys(round, wa, wb, o);
        uint32_t* d = (sch ? t.rk2 : t.rk) + i * rk_stride(NR) + 8 * round;
#pragma unroll
        for (int c = 0; c < 8; ++c) d[c] = o[c];
      }
    }
  }
}

// The keystream stage of a tile under cipher C, XORed into `rows`:
// AES-CTR over (row, block) entries, AES-F8 chains two rows a thread,
// nothing for NULL.
template <int NR, Cipher C>
__device__ __forceinline__ void keystream_tile(const Tile& t, uint32_t* rows,
                                               int first, int count) {
  if constexpr (C == kCm)
    ctr_tile<NR>(t, rows, first, count);
  else if constexpr (C == kF8)
    f8_tile<NR>(t, rows, first, count);
}

// ---------------------------------------------------------------- launch

// Streaming multiprocessors of the current device (0 if unknown).
inline int multiprocessors() {
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
// every SM `per_sm` tiles (a part of a few thousand rows spreads over
// the whole card instead of a quarter of it), at most `max_rows` (a full
// tile), and no more than fit the SM's shared memory (0: the width
// cannot run).
inline int tile_rows_for(int n, int width, int nr, TileKind kind,
                         int per_sm, int schedules = 1, int extra = 0,
                         int max_rows = kTileRows) {
  const int fixed = tile_words(0, width, nr, kind, schedules, extra);
  const int per_row =
      tile_words(1, width, nr, kind, schedules, extra) - fixed;
  const int fit = (kMaxSmemBytes / 4 - fixed) / per_row;
  const int ctas = per_sm * multiprocessors();
  int rows = ctas > 0 ? (n + ctas - 1) / ctas : max_rows;
  rows = rows < 1 ? 1 : (rows > max_rows ? max_rows : rows);
  return fit < rows ? fit : rows;
}

// A launch of a tiled kernel: rows a tile, dynamic shared memory, tiles.
struct Plan {
  int rows, smem, grid;
};

// Plan the launch of `kernel` over n rows of `width` bytes whose rows
// carry `schedules` key schedules and `extra` words, `per_sm` tiles an
// SM of at most `max_rows` rows, and allow it the dynamic shared memory
// above the 48 KB default where it needs it, once per device (`done`
// holds one bit per device).  Returns a CUDA error code,
// cudaErrorInvalidValue for a width no tile holds.
template <class Kernel>
int plan(Kernel kernel, std::atomic<unsigned>& done, int n, int width, int nr,
         TileKind kind, int per_sm, Plan* p, int schedules = 1,
         int extra = 0, int max_rows = kTileRows) {
  p->rows = width > 0 ? tile_rows_for(n, width, nr, kind, per_sm, schedules,
                                      extra, max_rows)
                      : 0;
  if (p->rows < 1) return int(cudaErrorInvalidValue);
  p->smem = 4 * tile_words(p->rows, width, nr, kind, schedules, extra);
  p->grid = (n + p->rows - 1) / p->rows;
  if (p->smem <= 48 * 1024) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return int(cudaErrorInvalidValue);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load() & bit)) return 0;
  const int rc = int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes));
  if (rc == 0) done.fetch_or(bit);
  return rc;
}

}  // namespace ljt_tile
