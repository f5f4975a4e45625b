// Kernels I-NULL and J-NULL: batched SRTCP NULL_HMAC_SHA1_80 protect and
// unprotect.
//
// Replace: libjitsi_tpu/transform/srtp/kernel.py `srtcp_protect` (:164)
// and `srtcp_unprotect` (:193) with encrypt=False, together with the
// per-stream gather of the RTCP midstates in libjitsi_tpu/transform/srtp/
// context.py `_protect_rtcp_dev` / `_unprotect_rtcp_dev`.
//
// RFC 3711 §3.4 under the NULL cipher: no byte of a row changes but I's
// E || SRTCP-index word and tag.
//  - I writes the word (the host's, E = 0) at len and the tag over
//    [0, len) || word at len + 4; bytes at or past the width are dropped
//    and the length grows by 4 + tag_len.
//  - J passes every row through, reads the word at mlen = len - tag_len -
//    4 and checks every tag byte over [0, mlen + 4) with no early exit; a
//    row whose mlen is negative fails.  It returns the rows, mlen,
//    auth_ok, the E bit and the 31-bit index.
//
// Bound on the H100: bytes, each row read and written once (1,504 bytes a
// row on the paths, against a MAC message of at most 208); its time is the
// longest row's MAC chain on one lane: the launch, two dependent round
// trips (the stream id, then its midstates) and 2-5 compressions.
//
// Design.  The row tile these replace (the NULL instances of
// `srtcp_cm.cu`'s tiles) staged every row into shared memory, hashed 3
// rows a tile on warp 0 behind a barrier while 125 threads waited, and
// stored every byte back after a second barrier: 2.0x the MAC floor.
// Here:
//  - A CTA of 128 threads takes `tile_rows` consecutive rows (the fewest
//    that give every SM kTilesPerSm tiles, at most 32: one a lane of
//    warp 0); no shared memory.  Four small tiles an SM measured faster
//    than one or two large ones at every launch on the paths.
//  - Warp 0 hashes: lane r reads row r's message straight from global
//    memory through the read-only path, 16 bytes a load where the rows
//    allow, one 64-byte block in 16 registers.  The stream id, the
//    length, I's word and block 0 (as far as the width allows: the
//    length is not known yet) are issued together, the midstates and
//    block 1 once the id is in, block b + 2 while block b is compressed:
//    the first compression waits on two round trips.  The padding and
//    (I) the word are merged into a block in registers from two words
//    worked out once a row (`RowMsgEnd`); a block that is data in every
//    lane of the warp skips the merge.
//  - Warps 1-3 copy the tile's rows global to global, 16 bytes a load,
//    four loads in flight a thread, while the hash runs.  I's word and
//    tag are written by their hashing lane after one barrier, over the
//    copy of the bytes they replace.
// Semantics (held byte for byte against `srtcp_protect_plain` /
// `srtcp_unprotect_plain` with cipher "null" in transform/srtp/kernel.py):
// lengths are clamped to [0, width] and stream ids into the table; the
// word's bytes at or past the width read as 0 in I's MAC; J reads the word
// at positions clamped into [0, width - 1].  The round keys (`tab_rk`)
// are unused; both key lengths keep their instance.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "phases.cuh"
#include "sha1.cuh"
#include "srtp_tile.cuh"

namespace {

using ljt_tile::aligned;
using ljt_tile::multiprocessors;
namespace ph = ljt_null_phase;

constexpr int kThreads = 128;     // warp 0 hashes; warps 1-3 copy
constexpr int kTileRows = 32;     // one a lane of warp 0
constexpr int kTilesPerSm = 4;
constexpr int kCopyLoads = 4;     // copy loads in flight a thread

// A row's bytes in global memory, read as 16-byte units where the width
// is a multiple of 16 and the rows start aligned, else as 4-byte ones
// where it is a multiple of 4, else byte by byte.
struct RowBytes {
  const uint8_t* row;
  int unit;

  // Block b's 16 words as stored (bytes 64b .. 64b + 63, little-endian);
  // only bytes below `lim` (at most the width) are read, the rest are 0.
  __device__ __forceinline__ void block(int b, int lim,
                                        uint32_t raw[16]) const {
    if (unit == 16) {
      const uint4* p = reinterpret_cast<const uint4*>(row) + 4 * b;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 v = 64 * b + 16 * c < lim ? __ldg(p + c)
                                              : make_uint4(0, 0, 0, 0);
        raw[4 * c] = v.x;
        raw[4 * c + 1] = v.y;
        raw[4 * c + 2] = v.z;
        raw[4 * c + 3] = v.w;
      }
    } else if (unit == 4) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + 16 * b;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        raw[j] = 64 * b + 4 * j < lim ? __ldg(p + j) : 0u;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 64 * b + 4 * j + k;
          if (i < lim) v |= uint32_t(__ldg(row + i)) << (8 * k);
        }
        raw[j] = v;
      }
    }
  }
};

// The unit a launch reads and writes rows in: 16 bytes, 4 or 1.
__device__ __forceinline__ int row_unit(const void* a, const void* b,
                                        int width) {
  if ((width & 15) == 0 && aligned(a, 16) && aligned(b, 16)) return 16;
  if ((width & 3) == 0 && aligned(a, 4) && aligned(b, 4)) return 4;
  return 1;
}

// A MAC message as SHA-1 words: a row's data bytes [0, dlen), then the
// 8 bytes of `tail` (big-endian: I's word cut at the width and 0x80, or
// J's 0x80 alone), then zeros, as `LjtRowMsg` reads it.  The tail falls
// in the word that holds the data's end (at q0, whose top bytes m0 are
// data) and the next one: tw0, tw1, worked out once a row.
struct RowMsgEnd {
  int dlen, q0;
  uint32_t m0, tw0, tw1;

  __device__ __forceinline__ RowMsgEnd(int len, uint64_t tail) : dlen(len) {
    const int r = len & 3;
    q0 = len - r;
    m0 = r ? 0xFFFFFFFFu << (32 - 8 * r) : 0u;
    tw0 = uint32_t(tail >> (32 + 8 * r));
    tw1 = uint32_t((tail << (32 - 8 * r)) >> 32);
  }

  // Message block b from its row words as stored.
  __device__ __forceinline__ void block(const uint32_t raw[16], int b,
                                        uint32_t w[16]) const {
    const int rel = dlen - 64 * b;
    const int qrel = q0 - 64 * b;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = 4 * j;
      uint32_t v = o < rel ? ljt_bswap32(raw[j]) &
                                 (o + 4 <= rel ? 0xFFFFFFFFu : m0)
                           : 0u;
      if (o == qrel) v |= tw0;
      if (o == qrel + 4) v |= tw1;
      w[j] = v;
    }
  }
};

// The least of v over the 32 lanes of the warp (every lane takes part).
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    const int o = __shfl_xor_sync(0xFFFFFFFFu, v, k);
    v = o < v ? o : v;
  }
  return v;
}

// HMAC-SHA1 from the key's midstates of an mlen-byte message `m`, its
// row's bytes read through `src`.  `cur` and `nxt` arrive holding blocks 0
// and 1 as loaded; block b + 2 is loaded while block b is compressed.  A
// block of data in every lane of the warp (below `dmin`, the warp's
// shortest data; the test is the same in every lane) skips the merge.
__device__ __forceinline__ void hash_row(const RowBytes& src,
                                         const uint32_t mid[10],
                                         const RowMsgEnd& m, int mlen,
                                         int dmin, uint32_t cur[16],
                                         uint32_t nxt[16], uint32_t d[5]) {
  uint32_t h[5] = {mid[0], mid[1], mid[2], mid[3], mid[4]};
  const int nblk = (mlen + 9 + 63) / 64;
  // bit length of ipad block || message; < 2^32 for any row width here
  const uint32_t bitlen = uint32_t(mlen + 64) * 8u;
  for (int b = 0; b < nblk; ++b) {
    uint32_t w[16];
    if (64 * b + 64 <= dmin) {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = ljt_bswap32(cur[j]);
    } else {
      m.block(cur, b, w);
    }
    if (b == nblk - 1) {
      w[14] = 0;
      w[15] = bitlen;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) cur[j] = nxt[j];
    src.block(b + 2, m.dlen, nxt);
    ljt_sha1_compress(h, w);
  }
  ljt_hmac_outer(mid, h, d);
}

// Copy `rows` rows of `width` bytes from g to o in units V, thread `first`
// of `count` taking every count-th unit, kCopyLoads loads in flight.
template <class V>
__device__ __forceinline__ void copy_units(const uint8_t* g, uint8_t* o,
                                           int rows, int width, int first,
                                           int count) {
  const int total = rows * (width / int(sizeof(V)));
  const V* gv = reinterpret_cast<const V*>(g);
  V* ov = reinterpret_cast<V*>(o);
  for (int i0 = first; i0 < total; i0 += kCopyLoads * count) {
    V v[kCopyLoads];
#pragma unroll
    for (int u = 0; u < kCopyLoads; ++u)
      if (i0 + u * count < total) v[u] = __ldg(gv + i0 + u * count);
#pragma unroll
    for (int u = 0; u < kCopyLoads; ++u)
      if (i0 + u * count < total) ov[i0 + u * count] = v[u];
  }
}

// Warps 1-3: the tile's rows copied through, global to global.
__device__ __forceinline__ void copy_rows(const uint8_t* g, uint8_t* o,
                                          int rows, int width, int unit) {
  const int first = threadIdx.x - 32, count = blockDim.x - 32;
  if (unit == 16)
    copy_units<uint4>(g, o, rows, width, first, count);
  else if (unit == 4)
    copy_units<uint32_t>(g, o, rows, width, first, count);
  else
    copy_units<uint8_t>(g, o, rows, width, first, count);
}

#define LJT_NULL_PROTECT_PARAMS                                              \
  const uint32_t *__restrict__ tab_mid, const int32_t *__restrict__ stream,  \
      int n_streams, const uint8_t *__restrict__ data,                       \
      const int32_t *__restrict__ length,                                    \
      const uint32_t *__restrict__ index_word, uint8_t *__restrict__ out,    \
      int32_t *__restrict__ out_len, int n, int width, int tag_len,          \
      int tile_rows
#define LJT_NULL_PROTECT_ARGS                                                \
  tab_mid, stream, n_streams, data, length, index_word, out, out_len, n,     \
      width, tag_len, tile_rows
#define LJT_NULL_UNPROTECT_PARAMS                                            \
  const uint32_t *__restrict__ tab_mid, const int32_t *__restrict__ stream,  \
      int n_streams, const uint8_t *__restrict__ data,                       \
      const int32_t *__restrict__ length, uint8_t *__restrict__ out,         \
      int32_t *__restrict__ out_mlen, uint8_t *__restrict__ auth_ok,         \
      int32_t *__restrict__ e_bit, int32_t *__restrict__ index, int n,       \
      int width, int tag_len, int tile_rows
#define LJT_NULL_UNPROTECT_ARGS                                              \
  tab_mid, stream, n_streams, data, length, out, out_mlen, auth_ok, e_bit,   \
      index, n, width, tag_len, tile_rows

// The phase probe's stamp once `v`, a loaded value, is in hand.
__device__ __forceinline__ void stamp_after(long long* st, int slot,
                                            uint32_t v) {
  st[ph::kSink] = v;
  st[slot] = clock64();
}

// A copying warp's end, its stores drained (the phase probe's).
__device__ __forceinline__ void stamp_copy_end(long long* st) {
  __threadfence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st[ph::kWarp + (threadIdx.x >> 5)] = clock64();
}

// A hashing lane's round trips: the stream id, the length, block 0 (as far
// as the width allows: the length is not known yet) and (I) the word
// together, then the midstates and block 1.
struct LaneSetUp {
  int sid, len_in;
  uint32_t mid[10];
};

template <bool Phases>
__device__ __forceinline__ LaneSetUp lane_set_up(
    const uint32_t* tab_mid, const int32_t* stream, int n_streams,
    const int32_t* length, int row, int width, const RowBytes& src,
    uint32_t cur[16], uint32_t nxt[16], long long* st) {
  LaneSetUp g;
  g.sid = ljt_clamp(stream[row], 0, n_streams - 1);
  g.len_in = length[row];
  src.block(0, width, cur);
  if constexpr (Phases)
    if (threadIdx.x == 0) stamp_after(st, ph::kId, g.sid ^ g.len_in);
  ljt_load_mid(tab_mid, g.sid, g.mid);
  src.block(1, width, nxt);
  if constexpr (Phases)
    if (threadIdx.x == 0) stamp_after(st, ph::kMid, g.mid[0] ^ g.mid[9]);
  return g;
}

// I-NULL's tile; `stamps`: the phase probe's (Phases).  Lane r of warp 0
// hashes row r (lanes past the tile's rows shadow row 0 and write
// nothing); warps 1-3 copy the rows through; after one barrier lane r
// writes row r's word and tag over its copy.
template <bool Phases = false>
__device__ __forceinline__ void protect_tile(LJT_NULL_PROTECT_PARAMS,
                                             long long* stamps = nullptr) {
  const int base = blockIdx.x * tile_rows;
  const int rows = n - base < tile_rows ? n - base : tile_rows;
  const int tid = threadIdx.x;
  const int unit = row_unit(data, out, width);
  [[maybe_unused]] long long* st = nullptr;
  if constexpr (Phases) st = ph::start(stamps, rows);
  const int row = base + (tid < rows ? tid : 0);
  int len = 0;
  uint32_t word = 0, d[5];
  if (tid >= 32) {
    copy_rows(data + size_t(base) * width, out + size_t(base) * width, rows,
              width, unit);
    if constexpr (Phases) stamp_copy_end(st);
  } else {
    // the MAC over [0, len) || word
    const RowBytes src{data + size_t(row) * width, unit};
    uint32_t cur[16], nxt[16];
    word = index_word[row];
    const LaneSetUp g = lane_set_up<Phases>(tab_mid, stream, n_streams,
                                            length, row, width, src, cur,
                                            nxt, st);
    len = ljt_clamp(g.len_in, 0, width);
    // the word's bytes that fit in the row, then the 0x80 pad byte
    const int room = width - len;
    const uint32_t fit =
        room >= 4 ? word
                  : (room <= 0 ? 0u : word & (0xFFFFFFFFu << (32 - 8 * room)));
    hash_row(src, g.mid,
             RowMsgEnd(len, (uint64_t(fit) << 32) | 0x80000000u), len + 4,
             warp_min(len), cur, nxt, d);
    if (tid < rows) out_len[row] = g.len_in + 4 + tag_len;
  }
  // the word and tag land after the copy of the bytes they replace
  __syncthreads();
  if (tid < rows) {
    uint8_t* o = out + size_t(row) * width;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (len + k < width) o[len + k] = uint8_t(word >> (8 * (3 - k)));
#pragma unroll
    for (int k = 0; k < 20; ++k)
      if (k < tag_len && len + 4 + k < width)
        o[len + 4 + k] = ljt_digest_byte(d, k);
    if constexpr (Phases) {
      __threadfence();
      st[ph::kLane + tid] = clock64();
    }
  }
  if constexpr (Phases) ph::end(st);
}

// J-NULL's tile; `stamps`: the phase probe's (Phases).  Lane r of warp 0
// checks row r (lanes past the tile's rows shadow row 0 and write
// nothing); warps 1-3 copy the rows through.
template <bool Phases = false>
__device__ __forceinline__ void unprotect_tile(LJT_NULL_UNPROTECT_PARAMS,
                                               long long* stamps = nullptr) {
  const int base = blockIdx.x * tile_rows;
  const int rows = n - base < tile_rows ? n - base : tile_rows;
  const int tid = threadIdx.x;
  const int unit = row_unit(data, out, width);
  [[maybe_unused]] long long* st = nullptr;
  if constexpr (Phases) st = ph::start(stamps, rows);
  if (tid >= 32) {
    copy_rows(data + size_t(base) * width, out + size_t(base) * width, rows,
              width, unit);
    if constexpr (Phases) stamp_copy_end(st);
  } else {
    // the MAC over [0, mlen + 4) (the packet and the word as they sit in
    // the row), then every tag byte
    const int row = base + (tid < rows ? tid : 0);
    const uint8_t* rp = data + size_t(row) * width;
    const RowBytes src{rp, unit};
    uint32_t cur[16], nxt[16];
    const LaneSetUp g = lane_set_up<Phases>(tab_mid, stream, n_streams,
                                            length, row, width, src, cur,
                                            nxt, st);
    const int mlen = ljt_clamp(g.len_in, 0, width) - tag_len - 4;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word = (word << 8) | __ldg(rp + ljt_clamp(mlen + k, 0, width - 1));
    uint8_t tag[20];
#pragma unroll
    for (int k = 0; k < 20; ++k)
      tag[k] = k < tag_len && mlen >= 0 ? __ldg(rp + mlen + 4 + k) : 0;
    const int dmin = warp_min(mlen >= 0 ? mlen + 4 : INT_MAX);
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t d[5];
      hash_row(src, g.mid, RowMsgEnd(mlen + 4, uint64_t(0x80) << 56),
               mlen + 4, dmin, cur, nxt, d);
      diff = 0;
#pragma unroll
      for (int k = 0; k < 20; ++k)
        if (k < tag_len) diff |= uint32_t(tag[k] ^ ljt_digest_byte(d, k));
    }
    if (tid < rows) {
      auth_ok[row] = diff == 0;
      out_mlen[row] = g.len_in - tag_len - 4;
      e_bit[row] = int32_t(word >> 31);
      index[row] = int32_t(word & 0x7FFFFFFFu);
      if constexpr (Phases) {
        __threadfence();
        st[ph::kLane + tid] = clock64();
      }
    }
  }
  if constexpr (Phases) ph::end(st);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtcp_protect_null_kernel(LJT_NULL_PROTECT_PARAMS) {
  protect_tile(LJT_NULL_PROTECT_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtcp_unprotect_null_kernel(LJT_NULL_UNPROTECT_PARAMS) {
  unprotect_tile(LJT_NULL_UNPROTECT_ARGS);
}

// The phase probe's instances: the same tiles with clock64 stamps; on no
// path.
__global__ void __launch_bounds__(kThreads)
    srtcp_protect_null_phases_kernel(LJT_NULL_PROTECT_PARAMS,
                                     long long* stamps) {
  protect_tile<true>(LJT_NULL_PROTECT_ARGS, stamps);
}

__global__ void __launch_bounds__(kThreads)
    srtcp_unprotect_null_phases_kernel(LJT_NULL_UNPROTECT_PARAMS,
                                       long long* stamps) {
  unprotect_tile<true>(LJT_NULL_UNPROTECT_ARGS, stamps);
}

// A launch of n rows: rows a tile (the fewest that give every SM
// `per_sm` tiles, at most kTileRows) and tiles.
struct Plan {
  int rows, grid;
};

Plan plan(int n, int per_sm) {
  const int ctas = per_sm * multiprocessors();
  int rows = ctas > 0 ? (n + ctas - 1) / ctas : kTileRows;
  rows = rows < 1 ? 1 : (rows > kTileRows ? kTileRows : rows);
  return Plan{rows, (n + rows - 1) / rows};
}

// The launches of I-NULL and J-NULL, or of their phase probe (which also
// takes the stamps and writes the plan: rows a tile, tiles, threads).
template <bool Phases = false>
int launch_protect(const void* tab_mid, const void* stream, int n_streams,
                   const void* data, const void* length,
                   const void* index_word, void* out, void* out_len, int n,
                   int width, int nr, int tag_len, void* cuda_stream,
                   int per_sm = kTilesPerSm, long long* stamps = nullptr,
                   int* plan_out = nullptr) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0 || width <= 0 || per_sm < 1)
    return int(cudaErrorInvalidValue);
  const Plan p = plan(n, per_sm);
  if constexpr (Phases) {
    plan_out[0] = p.rows;
    plan_out[1] = p.grid;
    plan_out[2] = kThreads;
  }
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* mid = static_cast<const uint32_t*>(tab_mid);
  const auto* sid = static_cast<const int32_t*>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ln = static_cast<const int32_t*>(length);
  const auto* word = static_cast<const uint32_t*>(index_word);
  auto* o = static_cast<uint8_t*>(out);
  auto* olen = static_cast<int32_t*>(out_len);
  if constexpr (Phases)
    srtcp_protect_null_phases_kernel<<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, word, o, olen, n, width, tag_len, p.rows,
        stamps);
  else if (nr == 10)
    srtcp_protect_null_kernel<10><<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, word, o, olen, n, width, tag_len, p.rows);
  else
    srtcp_protect_null_kernel<14><<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, word, o, olen, n, width, tag_len, p.rows);
  return int(cudaGetLastError());
}

template <bool Phases = false>
int launch_unprotect(const void* tab_mid, const void* stream, int n_streams,
                     const void* data, const void* length, void* out,
                     void* out_mlen, void* auth_ok, void* e_bit, void* index,
                     int n, int width, int nr, int tag_len, void* cuda_stream,
                     int per_sm = kTilesPerSm, long long* stamps = nullptr,
                     int* plan_out = nullptr) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0 || width <= 0 || per_sm < 1)
    return int(cudaErrorInvalidValue);
  const Plan p = plan(n, per_sm);
  if constexpr (Phases) {
    plan_out[0] = p.rows;
    plan_out[1] = p.grid;
    plan_out[2] = kThreads;
  }
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* mid = static_cast<const uint32_t*>(tab_mid);
  const auto* sid = static_cast<const int32_t*>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ln = static_cast<const int32_t*>(length);
  auto* o = static_cast<uint8_t*>(out);
  auto* ml = static_cast<int32_t*>(out_mlen);
  auto* ok = static_cast<uint8_t*>(auth_ok);
  auto* eb = static_cast<int32_t*>(e_bit);
  auto* ix = static_cast<int32_t*>(index);
  if constexpr (Phases)
    srtcp_unprotect_null_phases_kernel<<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, o, ml, ok, eb, ix, n, width, tag_len,
        p.rows, stamps);
  else if (nr == 10)
    srtcp_unprotect_null_kernel<10><<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, o, ml, ok, eb, ix, n, width, tag_len,
        p.rows);
  else
    srtcp_unprotect_null_kernel<14><<<p.grid, kThreads, 0, s>>>(
        mid, sid, n_streams, d, ln, o, ml, ok, eb, ix, n, width, tag_len,
        p.rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtcp_protect_null(const void* tab_rk, const void* tab_mid,
                                      const void* stream, int n_streams,
                                      const void* data, const void* length,
                                      const void* iv, const void* index_word,
                                      void* out, void* out_len, int n,
                                      int width, int nr, int tag_len,
                                      void* cuda_stream) {
  (void)tab_rk;
  (void)iv;
  return launch_protect(tab_mid, stream, n_streams, data, length, index_word,
                        out, out_len, n, width, nr, tag_len, cuda_stream);
}

extern "C" int ljt_srtcp_unprotect_null(
    const void* tab_rk, const void* tab_mid, const void* stream,
    int n_streams, const void* data, const void* length, const void* iv,
    void* out, void* out_mlen, void* auth_ok, void* e_bit, void* index, int n,
    int width, int nr, int tag_len, void* cuda_stream) {
  (void)tab_rk;
  (void)iv;
  return launch_unprotect(tab_mid, stream, n_streams, data, length, out,
                          out_mlen, auth_ok, e_bit, index, n, width, nr,
                          tag_len, cuda_stream);
}

// The phase probe of I-NULL and J-NULL: their tiles as shipped with
// clock64 stamps, planned for `per_sm` tiles an SM (0: as shipped);
// stamps as `phases.cuh` lays them out, kSlots a tile in stamps [tiles *
// kSlots], and the plan (rows a tile, tiles, threads) in plan_out [3].
// out_len is J's out_mlen when `unprotect`; index_word is I's alone, and
// auth_ok, e_bit and index J's.
extern "C" int ljt_srtcp_null_phases(
    const void* tab_mid, const void* stream, int n_streams, const void* data,
    const void* length, const void* index_word, void* out, void* out_len,
    void* auth_ok, void* e_bit, void* index, void* stamps, void* plan_out,
    int n, int width, int tag_len, int unprotect, int per_sm,
    void* cuda_stream) {
  if (stamps == nullptr || plan_out == nullptr || per_sm < 0)
    return int(cudaErrorInvalidValue);
  auto* st = static_cast<long long*>(stamps);
  auto* po = static_cast<int*>(plan_out);
  const int k = per_sm ? per_sm : kTilesPerSm;
  return unprotect
             ? launch_unprotect<true>(tab_mid, stream, n_streams, data,
                                      length, out, out_len, auth_ok, e_bit,
                                      index, n, width, 10, tag_len,
                                      cuda_stream, k, st, po)
             : launch_protect<true>(tab_mid, stream, n_streams, data, length,
                                    index_word, out, out_len, n, width, 10,
                                    tag_len, cuda_stream, k, st, po);
}
