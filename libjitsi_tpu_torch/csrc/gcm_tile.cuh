// The AEAD-GCM tile (RFC 7714; NIST SP 800-38D) shared by kernels M and N
// (`srtp_gcm.cu`, seal and open, with their cached instances) and kernel
// H's GCM instance (`srtp_fanout.cu`).
//
// A tile is one CTA of 256 threads (8 warps) over at most 32 rows of the
// SRTP row tile (`srtp_tile.cuh`): set-up (`load_tile`) loads rows, keys
// and per-row values in overlapping round trips.  A row's policy (`Rows`)
// gives its AAD as the window start and the end of its ciphertext as the
// window end, and J0 = IV || 0x00000001 as its counter block.  Then:
//  - CTR (`gcm_ctr_tile`): the tile's (row, block) entries, one more a row
//    than its keystream blocks, flattened and handed out two a thread to
//    the gather-free AES core (`aes.cuh`).  Entry 0 of a row is E(K, J0),
//    the tag mask, kept in shared memory; entry k >= 1 is keystream block
//    k - 1, counter J0 + k = inc32(J0) + (k - 1), XORed into the row
//    (seal: in place; open: into the tile's second copy, so the hash
//    still reads the ciphertext).  J0's low word is 1 and a row has at
//    most 2,048 blocks, so the core's 128-bit counter add never carries
//    and gives GCM's inc32 sequence.  Each entry done adds one to its
//    row's count (`done`), so a row is ready when the count reaches its
//    entries.  The cached instances run no AES: all warps XOR each row's
//    slot of the keystream cache instead and read its tag mask from the
//    cache's table (`gcm_ks_tile`).
//  - GHASH (`gcm_hash_row`): a warp takes a row, keeps the row's packed
//    matrix in registers (`ghash.cuh`) and first stages the row's GHASH
//    input once, as 16-byte blocks of big-endian words in a shared array
//    of its own: the AAD and the ciphertext each zero-padded to whole
//    blocks (only their last partial blocks are masked, here), then the
//    lengths block.  The Horner chain is then one broadcast 16-byte
//    shared load a step and the step itself, over ceil(aad/16) +
//    ceil(ct/16) + 1 blocks.  Seal writes the tag (digest ^ tag mask) at
//    the row's end, lanes 0-15 a byte each; open compares all 16 bytes
//    with no early exit and writes the verdict.
//  - Who does what: all warps run CTR first, two entries a thread from
//    thread 0 on, so a tile of at most 256 entries (every open and seal
//    launch of the mix batch but the 544-byte one, and the SRTCP launch)
//    leaves warps 4-7 without any.  Warp w's first row is w + 4 (mod 8),
//    so those warps start hashing rows 0-3 at once; after its first row a
//    warp takes the tile's next row (a shared counter) until none is
//    left, so short and long rows spread over the warps.  Seal (M,
//    H-GCM) hashes a row as soon as its count says its ciphertext is
//    whole (no barrier over the tile).  Open (N) hashes the first copy
//    while the decrypt writes the second, so its hash warps wait on a
//    row's count only for the tag mask, and the tile costs about the
//    longer of the two, not their sum.  The cached instances XOR (all
//    warps), then hash.
//  - The rows are stored behind one barrier.
//
// Nothing here branches on or indexes by the key, H, the GHASH state or
// the data: lengths, offsets, slots, rows, lanes and counts are public
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
#include "phases.cuh"
#include "srtp_tile.cuh"

namespace ljt_gcm {

using namespace ljt_tile;

constexpr int kTag = 16;
// The GCM tile's threads and warps; warps 4-7 take the first rows.
constexpr int kGcmThreads = 256;
constexpr int kGcmWarps = kGcmThreads / 32;
constexpr int kFirstHashWarp = 4;
// Tiles a launch aims to give each SM (`tile_rows_for`): chosen on an H100
// at the paths' shapes (PERF.md §6).
constexpr int kGcmTilesPerSm = 2;
// Words a row keeps after the SRTP tile: its tag mask (4), clamped length,
// matrix row, cache slot, the count of its CTR entries done, and one word
// of which the first row's is the tile's next row to hand out.
constexpr int kExtraWords = 9;

// GHASH blocks a row of `width` bytes can need: ceil(aad/16) +
// ceil(ct/16) + 1 with aad + ct <= width.
__host__ __device__ constexpr int gcm_blocks(int width) {
  return (width + 15) / 16 + 2;
}
// Words a row takes beside the SRTP tile's (`plan`'s `extra`): the extra
// words and its staged GHASH input.
__host__ __device__ constexpr int gcm_row_words(int width) {
  return kExtraWords + 4 * gcm_blocks(width);
}

struct Extra {
  uint32_t* ek;   // [rows][4] the tag mask E(K, J0), big-endian words
  int* len;       // clamped length
  int* gm_row;    // table row of the packed GHASH matrix
  int* slot;      // the cached instances' slot
  int* done;      // CTR entries of the row done
  int* next;      // [1] the next row a warp takes
};

// The GCM tile's shared memory: each row's staged GHASH input first
// (gcm_blocks(width) 16-byte blocks a row, so every block is aligned),
// then the SRTP tile, then the extra words.
struct GcmTile {
  uint4* gs;
  int gstride;    // blocks a row
  Tile t;
  Extra x;
};

__device__ __forceinline__ GcmTile carve_gcm(uint32_t* smem, int tile_rows,
                                             int n, int width, int nr,
                                             TileKind kind, int schedules) {
  GcmTile g;
  g.gs = reinterpret_cast<uint4*>(smem);
  g.gstride = gcm_blocks(width);
  uint32_t* base = smem + 4 * g.gstride * tile_rows;
  g.t = carve(base, tile_rows, n, width, nr, kind, schedules);
  uint32_t* p = base + tile_words(tile_rows, width, nr, kind, schedules);
  g.x.ek = p;
  g.x.len = reinterpret_cast<int*>(p + 4 * tile_rows);
  g.x.gm_row = g.x.len + tile_rows;
  g.x.slot = g.x.gm_row + tile_rows;
  g.x.done = g.x.slot + tile_rows;
  g.x.next = g.x.done + tile_rows;
  return g;
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

// One CTR entry of row r done: its bytes (or its tag mask) visible to the
// tile before the row's count moves.
__device__ __forceinline__ void entry_done(int* done, int r) {
  __threadfence_block();
  atomicAdd(done + r, 1);
}

// The tile's CTR entries: a row's keystream blocks and its E(K, J0).
__device__ __forceinline__ int gcm_entries(const Tile& t) {
  int total = 0;
  for (int r = 0; r < t.rows; ++r) total += t.cnt[r] + 1;
  return total;
}

// AES over the tile's `total` (row, entry) list: entry 0 of row r is E(K,
// J0) into ek[4r..4r+3]; entry k >= 1 is keystream block j0 + k - 1,
// XORed into `rows`.  t.iv holds J0; t.cnt the keystream blocks of a
// row's window.  Thread `first` of `count` takes every count-th pair of
// entries, and counts each in its row's `done`.
template <int NR>
__device__ __forceinline__ void gcm_ctr_tile(const Tile& t, uint32_t* rows,
                                             uint32_t* ek, int* done,
                                             int total, int first,
                                             int count) {
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
    entry_done(done, r);
    if (two) {
      if (jb == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) ek[4 * rb + k] = b[k];
      } else {
        xor_block(rows + rb * t.stride, t.off[rb] + 16 * (t.j0[rb] + jb - 1),
                  t.s[rb], t.e[rb], b);
      }
      entry_done(done, rb);
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

// A row's GHASH input, staged by the 32 lanes of its warp into `gs`
// (16-byte blocks of big-endian words): the AAD [0, alen) and the
// ciphertext [alen, mend) of the staged row, each zero-padded to whole
// blocks, then the lengths block be64(aad bits) || be64(ct bits)
// (lengths < 2^29).  Returns the blocks.
__device__ __forceinline__ int gcm_stage_input(const uint32_t* row,
                                               int stride, int alen, int mend,
                                               uint4* gs, int lane) {
  const int nab = (alen + 15) >> 4;
  const int ncb = (mend - alen + 15) >> 4;
  uint32_t* g = reinterpret_cast<uint32_t*>(gs);
  for (int w = lane; w < 4 * (nab + ncb + 1); w += 32) {
    const int blk = w >> 2;
    const int k = w & 3;
    const int p =
        4 * k + (blk < nab ? 16 * blk : alen + 16 * (blk - nab));
    const uint32_t v = gcm_word(row, stride, p, blk < nab ? alen : mend);
    const uint32_t len = k == 1 ? uint32_t(alen) * 8u
                                : (k == 3 ? uint32_t(mend - alen) * 8u : 0u);
    g[w] = blk < nab + ncb ? v : len;
  }
  return nab + ncb + 1;
}

// Byte k (0..15) of 128 bits held as four big-endian words.
__device__ __forceinline__ uint32_t gcm_byte(const uint4 v, int k) {
  const int w = k >> 2;
  const uint32_t word = w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
  return (word >> (8 * (3 - (k & 3)))) & 0xFFu;
}

// Until row r's count reaches `want` (its CTR entries), then see them.
__device__ __forceinline__ void wait_row(const int* done, int r, int want) {
  while (*reinterpret_cast<const volatile int*>(done + r) < want)
    __nanosleep(32);
  __threadfence_block();
}

// The next row for the calling warp to hash (all 32 lanes call it).
__device__ __forceinline__ int take_row(int* next, int lane) {
  int r = 0;
  if (lane == 0) r = atomicAdd(next, 1);
  return __shfl_sync(0xFFFFFFFFu, r, 0);
}

// GHASH of row r of the tile on the calling warp, whose lanes hold the
// row's matrix rows `ghm`, over its staged bytes t.buf: AAD [0, t.off)
// and ciphertext [t.off, t.e).  Seal (!Open) waits until the row's
// ciphertext is whole (`Wait`) and writes the tag into the row at t.e;
// open hashes at once, waits for the tag mask (`Wait`), and compares the
// tag with the 16 bytes there and writes auth_ok.
template <bool Open, bool Wait>
__device__ __forceinline__ void gcm_hash_row(const GcmTile& g, int r,
                                             const LjtGhashRows& ghm,
                                             int lane, bool* auth_ok,
                                             int width) {
  const Tile& t = g.t;
  uint32_t* row = t.buf + r * t.stride;
  const int alen = t.off[r];
  const int mend = t.e[r];
  if (Wait && !Open) wait_row(g.x.done, r, t.cnt[r] + 1);
  uint4* gs = g.gs + r * g.gstride;
  const int nb = gcm_stage_input(row, t.stride, alen, mend, gs, lane);
  __syncwarp();
  uint4 ghy = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
  for (int i = 0; i < nb; ++i) ghy = ljt_ghash_step(ghm, ghy, gs[i]);
  if (Wait && Open) wait_row(g.x.done, r, t.cnt[r] + 1);
  const uint32_t* ekr = g.x.ek + 4 * r;
  const uint4 tag = make_uint4(ghy.x ^ ekr[0], ghy.y ^ ekr[1],
                               ghy.z ^ ekr[2], ghy.w ^ ekr[3]);
  const uint32_t tagb = gcm_byte(tag, lane & 15);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(row);
  if constexpr (Open) {
    // all 16 bytes compared, the verdict one ballot: no early exit
    const int col = ljt_clamp(mend + (lane & 15), 0, width - 1);
    const unsigned differs = lane < 16 && bytes[col] != tagb;
    const unsigned any = __ballot_sync(0xFFFFFFFFu, differs);
    if (lane == 0) auth_ok[t.base + r] = g.x.len[r] >= kTag && any == 0u;
  } else {
    if (lane < 16 && mend + lane < width) bytes[mend + lane] = uint8_t(tagb);
  }
}

// The phase probe's clock64 stamps of a tile (`kPhaseSlots` words a tile,
// in the probe build only): the tile's start, set-up done, keystream
// barrier (0 where the hash overlaps the keystream), hash joined, rows
// stored, its real rows, the global timer (ns) at its start and its SM;
// then for each warp w (up to 8) its keystream start and end and its hash
// start and end at kPhaseWarp + 4w (0 for a warp that has none).
constexpr int kPhaseSlots = 40;
constexpr int kPhaseWarp = 8;

__device__ __forceinline__ void phase_stamp(long long* st, int slot) {
  if (st != nullptr && threadIdx.x == 0) st[slot] = clock64();
}
__device__ __forceinline__ void warp_stamp(long long* st, int k) {
  if (st != nullptr && (threadIdx.x & 31) == 0)
    st[kPhaseWarp + 4 * (threadIdx.x >> 5) + k] = clock64();
}

// The whole GCM tile over a kernel's rows: set-up, keystream (or the
// cached XOR) and GHASH with the tag as the header says, the store.
// `smem` is the kernel's dynamic shared memory; `Rows` the row policy
// (`len(regs)`, `key_row(row)`, and for the cached instances `slot(row)`;
// a policy with `kSchedules` 0 loads no round keys).  `stamps` (the phase
// probe only; nullptr in the shipped kernels, where Phases is false and no
// stamp is compiled) takes the tile's `kPhaseSlots` clock64 stamps.
template <int NR, bool Open, bool Cached, class Rows, bool Phases = false>
__device__ __forceinline__ void gcm_tile(
    uint32_t* smem, const uint8_t* tab_rk, const uint4* tab_gm,
    const Rows& src, const uint8_t* ks_tab, const uint8_t* ek_tab,
    int n_slots, int ks_bytes, uint8_t* out, int32_t* out_len, bool* auth_ok,
    int n, int width, int tile_rows, long long* stamps = nullptr) {
  constexpr TileKind kKind = Open ? kSecondCopy : kInPlace;
  constexpr int kSched = Cached ? 0 : 1;
  long long* st = nullptr;
  if constexpr (Phases) {
    st = stamps + size_t(blockIdx.x) * kPhaseSlots;
    phase_stamp(st, 0);
    if (threadIdx.x == 0) {
      st[6] = phase_globaltimer();
      st[7] = phase_smid();
    }
  }
  const GcmTile g = carve_gcm(smem, tile_rows, n, width, NR, kKind, kSched);
  const Tile& t = g.t;
  const Extra& x = g.x;
  const int warp = int(threadIdx.x) >> 5;
  const int lane = int(threadIdx.x) & 31;
  // warp w's first row is w + 4 (mod 8): rows 0-3 go to the warps that
  // get the last CTR entries, or none
  const int first = (warp + kGcmWarps - kFirstHashWarp) % kGcmWarps;
  const typename Rows::Regs regs = load_tile<NR>(t, tab_rk, src, width);
  if (int(threadIdx.x) < t.rows) {
    const int r = threadIdx.x;
    const int len = src.len(regs);
    x.len[r] = ljt_clamp(len, 0, width);
    x.gm_row[r] = src.key_row(t.base + r);
    x.done[r] = 0;
    out_len[t.base + r] = Open ? len - kTag : len + kTag;
    if constexpr (Cached) {
      const int si = ljt_clamp(src.slot(t.base + r), 0, n_slots - 1);
      x.slot[r] = si;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x.ek[4 * r + k] = ljt_load_be32(ek_tab + size_t(si) * 16 + 4 * k);
    }
  }
  if (threadIdx.x == 0) x.next[0] = kGcmWarps;
  __syncthreads();
  if constexpr (Phases) {
    phase_stamp(st, 1);
    if (threadIdx.x == 0) st[5] = t.rows;
  }
  uint32_t* dst = Open ? t.out : t.buf;
  if constexpr (Cached) {
    if constexpr (Phases) warp_stamp(st, 0);
    gcm_ks_tile(t, x, dst, ks_tab, ks_bytes);
    if constexpr (Phases) warp_stamp(st, 1);
    __syncthreads();
    if constexpr (Phases) phase_stamp(st, 2);
  } else {
    // entries go two a thread from thread 0 on: a tile of at most 256
    // leaves warps 4-7 none, and they hash at once
    if constexpr (Phases) warp_stamp(st, 0);
    gcm_ctr_tile<NR>(t, dst, x.ek, x.done, gcm_entries(t), threadIdx.x,
                     kGcmThreads);
    if constexpr (Phases) warp_stamp(st, 1);
  }
  // each warp hashes its first row, then takes rows until none is left
  if constexpr (Phases)
    if (first < t.rows) warp_stamp(st, 2);
  for (int r = first; r < t.rows; r = take_row(x.next, lane))
    gcm_hash_row<Open, !Cached>(
        g, r, ljt_ghash_lane_rows(tab_gm + size_t(x.gm_row[r]) * 128, lane),
        lane, auth_ok, width);
  if constexpr (Phases)
    if (first < t.rows) warp_stamp(st, 3);
  __syncthreads();
  if constexpr (Phases) phase_stamp(st, 3);
  store_rows(dst, out + size_t(t.base) * width, t.rows, width, t.stride);
  if constexpr (Phases) {
    __syncthreads();
    phase_stamp(st, 4);
  }
}

}  // namespace ljt_gcm
