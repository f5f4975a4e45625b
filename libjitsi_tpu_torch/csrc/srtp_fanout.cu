// Kernel H: the SFU fan-out, one SRTP protect (AES-CM, AES-F8 or NULL, with
// HMAC-SHA1) of every (packet, receiver leg) pair, each under its leg's
// keys.
//
// Replaces: libjitsi_tpu/sfu/translator.py `_fanout_protect` (the XLA
// fan-out launch over `kernel.srtp_protect`) together with the host
// expansion of `RtpTranslator.translate_async`: the JAX path copies each
// decrypted packet once per receiver (`data[src]`), builds one RFC 3711
// §4.1.1 IV per copy on the host, pads rows and width to size classes for
// XLA's compile cache and uploads the [N, W] expansion.  Here the P
// decrypted packets are uploaded once; each output row names its packet
// (`src`) and its receiver leg (`recv`), and the kernel gathers the leg's
// round keys, HMAC midstates and session salt from the translator's
// tables, builds the IV from salt ^ SSRC ^ 48-bit index, takes the
// rollover counter as index >> 16, encrypts [payload_off, length) and
// appends the tag over header || ciphertext || ROC.
//
// Bound on the H100: operations (a 172-byte packet is 11 AES blocks and 4
// SHA-1 compressions, some 4,500 INT32-pipe instructions, against ~400
// bytes moved per copy).  SHA-1 is a chain: one row's compressions run one
// after another on one lane.
//
// Design: the row-tile form of kernels C and D (`srtp_tile.cuh`).  The
// first form, one warp a copy with lane 0 hashing, idled 31 lanes through
// the whole HMAC, kept 11 of 32 lanes busy on a 180-byte copy's
// keystream and rebuilt the T-table and keys every 4 copies.  Here one
// CTA of 128 threads takes a tile of at most 32 copies:
//  - set-up loads each copy's packet (`src`) and leg (`recv`) first, and
//    then, in one more round trip to memory, the packet's length,
//    offset, SSRC and index, the leg's round keys, HMAC midstates and
//    salt, and the packet bytes, staged once per copy (the copies differ
//    once encrypted; a packet's copies are neighbours, so their reads
//    after the first hit L2);
//  - the IV (salt ^ SSRC ^ index) is built on the card, in the thread
//    that then hashes the copy;
//  - all four warps make the keystream over the tile's (copy, block)
//    pairs, in place; then lane r of warp 0 hashes copy r, with the
//    midstates, length and ROC it loaded in set-up still in registers,
//    and writes the tag.
// Kernel C's pipelined hash (warp 0 hashing each block behind keystream
// levels made by warps 1-3) was slower here under AES-CM on an H100 at
// every SFU shape (275 x 10 and 1,100 x 10 copies of 80-180 bytes, 128 x
// 512 of 172): the hash waits on the levels and competes with them, and
// the keystream has a quarter fewer threads.  (F8's keystream is a long
// sequential chain, and its own tile hashes behind it: below.)  A copy's MAC (4-5 SHA-1
// compressions on one lane) is the floor of a tile.  Rows are
// packet-major in the order the host gives them.
//
// Instances (a template parameter, each its own kernel name):
//  - AES-CM (`srtp_fanout_cm`, H itself): the IV built on the card from
//    the leg's salt, as above.
//  - NULL (`srtp_fanout_null`; JAX `_fanout_protect` with encrypt=False,
//    translator.py:397): the keystream stage compiled out and no round
//    keys loaded; each copy is tagged under its leg's midstates and its
//    payload stays in clear.
//  - AES-F8 (`srtp_fanout_f8`): each copy's RFC 3711 §4.1.2 IV (0x00 ||
//    M,PT || SEQ || TS || SSRC || ROC) depends on its packet only, so the
//    host builds one a packet and the copy gathers its packet's; IV' is
//    taken under the leg's k_e XOR m schedule and the chain walked under
//    its k_e.  The JAX translator has no such path: under an F8 profile
//    it runs AES-CM (translator.py:377-397), so the oracle of this
//    instance is the F8 table's protect of the copy at the same index.
//    F8 is a chain of one AES pair a step, and the core's pair nearly
//    fills its SM sub-partition's INT32 pipe, so its tile is its own
//    (`fanout_f8_copies`): a tile of up to kF8Rows copies, one tile an SM
//    where the launch allows, on 256 threads.  Warps 0-1 walk the chains,
//    two copies a thread (`f8_chain_rows`), so an SM's chains share at
//    most two warps, each on its own sub-partition.  Set-up slices both
//    schedules with all threads, each round key of a thread's two copies
//    sliced together (the core's two block slots), so a chain step reads
//    8 key words a round and merges none.  Each step's
//    blocks are counted in their copy's `done`, and warps 2-3 and 6-7
//    (the sub-partitions of no chain warp) hash one copy a lane behind its
//    chain, each 64-byte SHA-1 block as soon as its bytes are final
//    (`ChainedRowMsg`), loading the leg's midstates themselves: the tag
//    follows the last step by about a compression, and no chain thread
//    keeps a midstate.
//  - AEAD-GCM (`srtp_fanout_gcm`; JAX `_fanout_protect_gcm` and
//    `gcm_protect_fanout`, translator.py:73 and kernels/gcm.py:415, with
//    the leg-major to packet-major flip `_fanout_packet_major`,
//    translator.py:81): the GCM tile of kernel M (`gcm_tile.cuh`: 256
//    threads, two tiles an SM, its staged GHASH input and rows handed
//    to warps as they come free) over the gathered copies.  Each copy's
//    RFC 7714 §8.1 IV, salt ^ (00 00 ||
//    SSRC || 48-bit index), is built on the card from the leg's salt as
//    under AES-CM; the AAD is the packet's RTP header; the copy is sealed
//    under the leg's round keys and packed GHASH matrix (gathered by
//    `recv`, in place of the midstates), and the 16-byte tag follows it.
//    Rows come out in the order of `src` / `recv`, which the translator
//    makes packet-major, so no flip runs.
//
// Semantics (held byte for byte against `srtp_fanout_protect_plain` in
// transform/srtp/kernel.py): src and recv are clamped into the packet and
// table rows, lengths to [0, width]; message bytes at or past the width
// read as 0 and tag bytes past it are dropped; the output row is the
// whole width-byte packet row with the window encrypted and the tag
// written at the length, and its length is length + tag_len.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gcm_tile.cuh"
#include "phases.cuh"
#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

// H's rows under AES-CM and NULL: copy k of the launch is packet src[k]
// under leg recv[k], both clamped into their tables; its ROC is index >>
// 16.  Its IV: under AES-CM RFC 3711 §4.1.1's salt ^ (SSRC << 64) ^
// (48-bit index << 16), from the leg's salt; none under NULL.
template <Cipher C>
struct FanoutRows {
  const uint8_t* tab_salt;  // AES-CM: [n_streams, 16] leg salts
  const uint32_t* tab_mid;
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const int32_t* payload_off;
  const uint32_t* ssrc;     // AES-CM
  const int64_t* index;
  int n_src;
  const int32_t* src;
  const int32_t* recv;
  int width;

  struct Lead {
    int p, leg;  // the copy's packet and leg, clamped
  };
  struct Regs {
    int len, off, leg;
    uint32_t ssrc;
    uint64_t idx;       // the 48-bit packet index
    uint4 v;            // AES-CM: the leg's salt
    uint32_t mid[10];
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(recv[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ GatheredRows staged(int base) const {
    return GatheredRows{data, src, n_src, base, width};
  }
  __device__ __forceinline__ Lead lead(int row) const {
    return Lead{ljt_clamp(src[row], 0, n_src - 1), key_row(row)};
  }
  __device__ __forceinline__ Regs load(int, const Lead& lead) const {
    Regs g;
    const int p = lead.p;
    g.leg = lead.leg;
    g.len = length[p];
    g.off = payload_off[p];
    g.idx = uint64_t(index[p]) & 0xFFFFFFFFFFFFull;
    g.ssrc = 0;
    g.v = make_uint4(0, 0, 0, 0);
    if constexpr (C == kCm) {
      g.ssrc = ssrc[p];
      if (aligned(tab_salt, 16))
        g.v = reinterpret_cast<const uint4*>(tab_salt)[g.leg];
    }
    ljt_load_mid(tab_mid, g.leg, g.mid);
    return g;
  }
  __device__ __forceinline__ void window(const Regs& g, int, int w, int& off,
                                         int& end, uint32_t ivw[4]) const {
    off = g.off;
    end = ljt_clamp(g.len, 0, w);
    if constexpr (C == kCm) {
      iv_words(aligned(tab_salt, 16), g.v, tab_salt + size_t(g.leg) * 16,
               ivw);
      ivw[1] ^= g.ssrc;
      ivw[2] ^= uint32_t(g.idx >> 16);
      ivw[3] ^= uint32_t(g.idx & 0xFFFF) << 16;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) ivw[k] = 0;
    }
  }
};

#define LJT_FANOUT_PARAMS                                                    \
  const uint8_t *__restrict__ tab_rk, const uint32_t *__restrict__ tab_mid,  \
      const uint8_t *__restrict__ tab_salt, int n_streams,                   \
      const uint8_t *__restrict__ data, const int32_t *__restrict__ length,  \
      const int32_t *__restrict__ payload_off,                               \
      const uint32_t *__restrict__ ssrc, const int64_t *__restrict__ index,  \
      int n_src, const int32_t *__restrict__ src,                            \
      const int32_t *__restrict__ recv, uint8_t *__restrict__ out,           \
      int32_t *__restrict__ out_len, int n, int width, int tag_len,          \
      int tile_rows
#define LJT_FANOUT_ARGS                                                      \
  tab_rk, tab_mid, tab_salt, n_streams, data, length, payload_off, ssrc,     \
      index, n_src, src, recv, out, out_len, n, width, tag_len, tile_rows

// H's body under AES-CM and NULL: the keystream over the staged copies
// in place (AES-CM: all four warps over the tile's (copy, block) pairs;
// NULL: none), then lane r of warp 0 hashes copy r, its midstates, length
// and index still in registers from set-up, and writes the tag.
template <int NR, Cipher C>
__device__ __forceinline__ void srtp_fanout_tile(LJT_FANOUT_PARAMS) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kInPlace, schedules_of(C));
  const typename FanoutRows<C>::Regs g = load_tile<NR>(
      t, tab_rk,
      cipher_rows<C>(FanoutRows<C>{tab_salt, tab_mid, n_streams, data,
                                   length, payload_off, ssrc, index, n_src,
                                   src, recv, width},
                     nullptr),
      width);
  __syncthreads();
  if constexpr (C != kNull) {
    keystream_tile<NR, C>(t, t.buf, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  if (int(threadIdx.x) < t.rows) {
    const int r = threadIdx.x;
    const int len = ljt_clamp(g.len, 0, width);
    uint32_t d[5];
    ljt_hmac_sha1(g.mid,
                  LjtRowMsg(t.buf + r * t.stride, len, width,
                            uint32_t(g.idx >> 16)),
                  d);
    ljt_put_tag(t.buf + r * t.stride, len, width, d, tag_len);
    out_len[t.base + r] = g.len + tag_len;
  }
  __syncthreads();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_fanout_cm_kernel(LJT_FANOUT_PARAMS) {
  srtp_fanout_tile<NR, kCm>(LJT_FANOUT_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_fanout_null_kernel(LJT_FANOUT_PARAMS) {
  srtp_fanout_tile<NR, kNull>(LJT_FANOUT_ARGS);
}

template <Cipher C>
auto fanout_kernel(int nr) {
  if constexpr (C == kCm)
    return nr == 10 ? srtp_fanout_cm_kernel<10> : srtp_fanout_cm_kernel<14>;
  else
    return nr == 10 ? srtp_fanout_null_kernel<10>
                    : srtp_fanout_null_kernel<14>;
}

// The launch of H and of its NULL instance (`tab_salt` and `ssrc` unused
// by the NULL one).
template <Cipher C>
int launch_fanout(const void* tab_rk, const void* tab_mid,
                  const void* tab_salt, int n_streams, const void* data,
                  const void* length, const void* payload_off,
                  const void* ssrc, const void* index, int n_src,
                  const void* src, const void* recv, void* out,
                  void* out_len, int n, int width, int nr, int tag_len,
                  void* cuda_stream) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_src <= 0 || n_streams <= 0)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = fanout_kernel<C>(nr);
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kInPlace,
                      kCtasPerSmSfu, &p, schedules_of(C));
  if (rc) return rc;
  kernel<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(tab_rk),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const uint8_t*>(tab_salt), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint32_t*>(ssrc), static_cast<const int64_t*>(index),
      n_src, static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(recv), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_len), n, width, tag_len, p.rows);
  return int(cudaGetLastError());
}

// ----------------------------------------------------- the F8 instance

constexpr int kF8Threads = 256;
constexpr int kF8Rows = 128;          // copies a tile: two a chain thread
constexpr int kF8ChainThreads = 64;   // warps 0-1 walk the chains
constexpr int kF8TilesPerSm = 1;
// Words a copy keeps after the SRTP tile: the keystream blocks of its
// chain XORed so far.
constexpr int kF8ExtraWords = 1;

// The F8 phase probe's stamps of a tile (kF8PhaseSlots words a tile): its
// start, set-up done, IV' done (warp 0's first chain), 0, the hash joined,
// the rows stored, its SM, the global timer (ns) at its start and its
// rows; then for each warp w at kF8PhaseWarp + 3w its slot on the SM + 1
// (`%warpid`; 0 for a warp that walks no chain and hashes no copy), its
// chain's end and its hash's end (lane 0's).
constexpr int kF8PhaseSlots = 40;
constexpr int kF8PhaseWarp = 16;

// A copy's MAC message as its hashing lane reads it behind the chain:
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
// i and i + half), by leg (recv, clamped into the tables): each round key
// of rows i and i + half sliced together, k_e from tab_rk into t.rk and
// k_e XOR m from tab_f8 into t.rk2 at pair i.  A task is one round key of
// one pair, in the order (schedule, round, pair), so a warp's lanes
// mostly share a round and its form of the key shift; every thread takes
// tasks tid, tid + kF8Threads, ..., kInFlight pairs of loads in flight.
template <int NR>
__device__ __forceinline__ void slice_f8_schedules(const Tile& t,
                                                   const uint8_t* tab_rk,
                                                   const uint8_t* tab_f8,
                                                   const int32_t* recv,
                                                   int n_streams) {
  const int half = (t.rows + 1) >> 1;
  const int per = (NR + 1) * half;
  const int tasks = 2 * per;
  // the table row of round `round` of row r's schedule `sch`, 16 bytes
  auto key = [&](int sch, int r, int round) {
    const int leg = ljt_clamp(recv[t.base + r], 0, n_streams - 1);
    return (sch ? tab_f8 : tab_rk) + (size_t(leg) * (NR + 1) + round) * 16;
  };
  for (int q0 = threadIdx.x; q0 < tasks; q0 += kInFlight * kF8Threads) {
    uint4 ka[kInFlight], kb[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int q = q0 + u * kF8Threads;
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
      const int q = q0 + u * kF8Threads;
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

// H-F8's tile: set-up with all threads; then the chains on warps 0-1
// while warps 2-3 and 6-7 (the other two sub-partitions) hash one copy a
// lane behind them; then the store.  `stamps`: the phase probe's
// (Phases).
template <int NR, bool Phases = false>
__device__ __forceinline__ void fanout_f8_copies(
    LJT_FANOUT_PARAMS, const uint8_t* __restrict__ tab_f8,
    const uint8_t* __restrict__ iv, long long* stamps = nullptr) {
  extern __shared__ uint4 smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  const Tile t = carve(words, tile_rows, n, width, NR, kInPlace, 2);
  int* done = reinterpret_cast<int*>(
      words + tile_words(tile_rows, width, NR, kInPlace, 2));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  long long* st = nullptr;
  if constexpr (Phases) {
    st = stamps + size_t(blockIdx.x) * kF8PhaseSlots;
    if (tid == 0) {
      st[0] = clock64();
      st[6] = phase_smid();
      st[7] = phase_globaltimer();
    }
  }
  // set-up: copy r's window and IV (thread r), both schedules of each
  // chain pair (a round key a task, at the pair's index: the SRTP tile's
  // two schedule areas are carved a row each, and half of each is used),
  // the copies' bytes
  if (tid < t.rows) {
    const int p = ljt_clamp(src[t.base + tid], 0, n_src - 1);
    const int off = payload_off[p];
    const int end = ljt_clamp(length[p], 0, width);
    const bool iv_vec = aligned(iv, 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (iv_vec) v = reinterpret_cast<const uint4*>(iv)[p];
    uint32_t ivw[4];
    iv_words(iv_vec, v, iv + size_t(p) * 16, ivw);
    const int s = off > 0 ? off : 0;
    const int e = end < width ? end : width;
    t.off[tid] = off;
    t.s[tid] = s;
    t.e[tid] = e;
    t.j0[tid] = s < e ? (s - off) >> 4 : 0;
    t.cnt[tid] = s < e ? ((e - 1 - off) >> 4) - ((s - off) >> 4) + 1 : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) t.iv[4 * tid + k] = ivw[k];
    done[tid] = 0;
  }
  slice_f8_schedules<NR>(t, tab_rk, tab_f8, recv, n_streams);
  stage_rows(GatheredRows{data, src, n_src, t.base, width}, t.buf, nullptr,
             t.rows, width, t.stride);
  __syncthreads();
  if constexpr (Phases) {
    if (tid == 0) {
      st[1] = clock64();
      st[8] = t.rows;
    }
  }
  [[maybe_unused]] const int pw = kF8PhaseWarp + 3 * warp;
  if (tid < kF8ChainThreads) {
    f8_chain_rows<NR>(t, t.buf, done, tid,
                      Phases && tid == 0 ? st + 2 : nullptr);
    if constexpr (Phases) {
      if (lane == 0 && tid < (t.rows + 1) >> 1) {
        st[pw] = phase_warpid() + 1;
        st[pw + 1] = clock64();
      }
    }
  } else if ((warp & 3) >= 2) {
    // warps 2-3 and 6-7: copy h's MAC behind its chain, then its tag
    const int h = (warp < 4 ? warp - 2 : warp - 4) * 32 + lane;
    if (h < t.rows) {
      const int row = t.base + h;
      const int p = ljt_clamp(src[row], 0, n_src - 1);
      const int len_in = length[p];
      const int len = ljt_clamp(len_in, 0, width);
      const uint64_t idx = uint64_t(index[p]) & 0xFFFFFFFFFFFFull;
      uint32_t mid[10], d[5];
      ljt_load_mid(tab_mid, ljt_clamp(recv[row], 0, n_streams - 1), mid);
      const LjtRowMsg msg(t.buf + h * t.stride, len, width,
                          uint32_t(idx >> 16));
      ljt_hmac_sha1(mid, ChainedRowMsg{msg, msg.mlen, done + h, t.off[h],
                                       t.s[h], t.e[h]},
                    d);
      ljt_put_tag(t.buf + h * t.stride, len, width, d, tag_len);
      out_len[row] = len_in + tag_len;
      if constexpr (Phases) {
        if (lane == 0) {
          st[pw] = phase_warpid() + 1;
          st[pw + 2] = clock64();
        }
      }
    }
  }
  __syncthreads();
  if constexpr (Phases)
    if (tid == 0) st[4] = clock64();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
  if constexpr (Phases) {
    __syncthreads();
    if (tid == 0) st[5] = clock64();
  }
}

template <int NR>
__global__ void __launch_bounds__(kF8Threads)
    srtp_fanout_f8_kernel(LJT_FANOUT_PARAMS,
                          const uint8_t* __restrict__ tab_f8,
                          const uint8_t* __restrict__ iv) {
  fanout_f8_copies<NR>(LJT_FANOUT_ARGS, tab_f8, iv);
}

// The phase probe's instance of H-F8 (AES-128): the same tile with its
// clock64 stamps; on no path.
__global__ void __launch_bounds__(kF8Threads)
    fanout_f8_phases_kernel(LJT_FANOUT_PARAMS,
                            const uint8_t* __restrict__ tab_f8,
                            const uint8_t* __restrict__ iv,
                            long long* stamps) {
  fanout_f8_copies<10, true>(LJT_FANOUT_ARGS, tab_f8, iv, stamps);
}

// The launch of H-F8 (or of its phase probe, AES-128 only, which also
// takes the stamps and writes the plan: rows a tile, dynamic shared
// memory, tiles).  A tile takes ceil(n / SMs) copies, at most kF8Rows and
// as many as fit the SM's shared memory.
template <bool Phases = false>
int launch_fanout_f8(const void* tab_rk, const void* tab_f8,
                     const void* tab_mid, int n_streams, const void* data,
                     const void* length, const void* payload_off,
                     const void* iv, const void* index, int n_src,
                     const void* src, const void* recv, void* out,
                     void* out_len, int n, int width, int nr, int tag_len,
                     void* cuda_stream, long long* stamps = nullptr,
                     int* plan_out = nullptr) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || (Phases && nr != 10) || n_src <= 0 ||
      n_streams <= 0 || tab_f8 == nullptr || iv == nullptr)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = [nr] {
    if constexpr (Phases)
      return fanout_f8_phases_kernel;
    else
      return nr == 10 ? srtp_fanout_f8_kernel<10> : srtp_fanout_f8_kernel<14>;
  }();
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kInPlace,
                      kF8TilesPerSm, &p, 2, kF8ExtraWords, kF8Rows);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* rk = static_cast<const uint8_t*>(tab_rk);
  const auto* mid = static_cast<const uint32_t*>(tab_mid);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ln = static_cast<const int32_t*>(length);
  const auto* off = static_cast<const int32_t*>(payload_off);
  const auto* ix = static_cast<const int64_t*>(index);
  const auto* sp = static_cast<const int32_t*>(src);
  const auto* rv = static_cast<const int32_t*>(recv);
  const auto* f8 = static_cast<const uint8_t*>(tab_f8);
  const auto* ivp = static_cast<const uint8_t*>(iv);
  auto* o = static_cast<uint8_t*>(out);
  auto* olen = static_cast<int32_t*>(out_len);
  if constexpr (Phases) {
    plan_out[0] = p.rows;
    plan_out[1] = p.smem;
    plan_out[2] = p.grid;
    kernel<<<p.grid, kF8Threads, p.smem, s>>>(
        rk, mid, nullptr, n_streams, d, ln, off, nullptr, ix, n_src, sp, rv,
        o, olen, n, width, tag_len, p.rows, f8, ivp, stamps);
  } else {
    kernel<<<p.grid, kF8Threads, p.smem, s>>>(
        rk, mid, nullptr, n_streams, d, ln, off, nullptr, ix, n_src, sp, rv,
        o, olen, n, width, tag_len, p.rows, f8, ivp);
  }
  return int(cudaGetLastError());
}

// H's GCM rows: copy k is packet src[k] under leg recv[k]; its AAD is
// the packet's header, its ciphertext the rest of the packet, and its J0
// the RFC 7714 §8.1 IV from the leg's salt, the SSRC and the index, ||
// 0x00000001.
struct FanoutGcmRows {
  const uint8_t* tab_salt;  // [n_streams, 16] leg salts (first 12 bytes)
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const int32_t* payload_off;
  const uint32_t* ssrc;
  const int64_t* index;
  int n_src;
  const int32_t* src;
  const int32_t* recv;
  int width;

  struct Lead {
    int p, leg;
  };
  struct Regs {
    int len, off, leg;
    uint32_t ssrc;
    uint64_t idx;
    uint4 salt;
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(recv[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ GatheredRows staged(int base) const {
    return GatheredRows{data, src, n_src, base, width};
  }
  __device__ __forceinline__ Lead lead(int row) const {
    return Lead{ljt_clamp(src[row], 0, n_src - 1), key_row(row)};
  }
  __device__ __forceinline__ Regs load(int, const Lead& lead) const {
    Regs g;
    g.leg = lead.leg;
    g.len = length[lead.p];
    g.off = payload_off[lead.p];
    g.ssrc = ssrc[lead.p];
    g.idx = uint64_t(index[lead.p]) & 0xFFFFFFFFFFFFull;
    g.salt = make_uint4(0, 0, 0, 0);
    if (aligned(tab_salt, 16))
      g.salt = reinterpret_cast<const uint4*>(tab_salt)[g.leg];
    return g;
  }
  __device__ __forceinline__ int len(const Regs& g) const { return g.len; }
  __device__ __forceinline__ void window(const Regs& g, int, int w, int& off,
                                         int& end, uint32_t ivw[4]) const {
    ljt_gcm::gcm_window(g.len, g.off, w, false, off, end);
    iv_words(aligned(tab_salt, 16), g.salt, tab_salt + size_t(g.leg) * 16,
             ivw);
    // bytes 2-5 the SSRC, 6-11 the 48-bit index
    ivw[0] ^= g.ssrc >> 16;
    ivw[1] ^= (g.ssrc << 16) | uint32_t((g.idx >> 32) & 0xFFFF);
    ivw[2] ^= uint32_t(g.idx & 0xFFFFFFFFu);
    ivw[3] = 1u;
  }
};

template <int NR>
__global__ void __launch_bounds__(ljt_gcm::kGcmThreads) srtp_fanout_gcm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint4* __restrict__ tab_gm,
    const uint8_t* __restrict__ tab_salt, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off,
    const uint32_t* __restrict__ ssrc, const int64_t* __restrict__ index,
    int n_src, const int32_t* __restrict__ src,
    const int32_t* __restrict__ recv, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, int n, int width, int tile_rows) {
  extern __shared__ uint4 smem[];
  ljt_gcm::gcm_tile<NR, false, false>(
      reinterpret_cast<uint32_t*>(smem), tab_rk, tab_gm,
      FanoutGcmRows{tab_salt, n_streams, data, length, payload_off, ssrc,
                    index, n_src, src, recv, width},
      nullptr, nullptr, 0, 0, out, out_len, nullptr, n, width, tile_rows);
}

}  // namespace

extern "C" int ljt_srtp_fanout_gcm(const void* tab_rk, const void* tab_gm,
                                   const void* tab_salt, int n_streams,
                                   const void* data, const void* length,
                                   const void* payload_off, const void* ssrc,
                                   const void* index, int n_src,
                                   const void* src, const void* recv,
                                   void* out, void* out_len, int n, int width,
                                   int nr, void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 || n_src <= 0 || n_streams <= 0 ||
      (reinterpret_cast<uintptr_t>(tab_gm) & 15))
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done;
  auto kernel = srtp_fanout_gcm_kernel<10>;
  Plan p;
  const int rc = plan(kernel, done, n, width, nr, kInPlace,
                      ljt_gcm::kGcmTilesPerSm, &p, 1,
                      ljt_gcm::gcm_row_words(width));
  if (rc) return rc;
  kernel<<<p.grid, ljt_gcm::kGcmThreads, p.smem,
           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(tab_rk), static_cast<const uint4*>(tab_gm),
      static_cast<const uint8_t*>(tab_salt), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint32_t*>(ssrc), static_cast<const int64_t*>(index),
      n_src, static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(recv), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_len), n, width, p.rows);
  return int(cudaGetLastError());
}

extern "C" int ljt_srtp_fanout_cm(const void* tab_rk, const void* tab_mid,
                                  const void* tab_salt, int n_streams,
                                  const void* data, const void* length,
                                  const void* payload_off, const void* ssrc,
                                  const void* index, int n_src,
                                  const void* src, const void* recv,
                                  void* out, void* out_len, int n, int width,
                                  int nr, int tag_len, void* cuda_stream) {
  return launch_fanout<kCm>(tab_rk, tab_mid, tab_salt, n_streams, data,
                            length, payload_off, ssrc, index, n_src, src,
                            recv, out, out_len, n, width, nr, tag_len,
                            cuda_stream);
}

// The NULL instance takes H's arguments; its round keys, salts and SSRCs
// are not read.
extern "C" int ljt_srtp_fanout_null(const void* tab_rk, const void* tab_mid,
                                    const void* tab_salt, int n_streams,
                                    const void* data, const void* length,
                                    const void* payload_off, const void* ssrc,
                                    const void* index, int n_src,
                                    const void* src, const void* recv,
                                    void* out, void* out_len, int n,
                                    int width, int nr, int tag_len,
                                    void* cuda_stream) {
  return launch_fanout<kNull>(tab_rk, tab_mid, tab_salt, n_streams, data,
                              length, payload_off, ssrc, index, n_src, src,
                              recv, out, out_len, n, width, nr, tag_len,
                              cuda_stream);
}

// The F8 instance: the k_e XOR m table after the round keys, and each
// packet's IV (`iv` [n_src, 16]) in place of the salts and SSRCs.
extern "C" int ljt_srtp_fanout_f8(const void* tab_rk, const void* tab_f8,
                                  const void* tab_mid, int n_streams,
                                  const void* data, const void* length,
                                  const void* payload_off, const void* iv,
                                  const void* index, int n_src,
                                  const void* src, const void* recv,
                                  void* out, void* out_len, int n, int width,
                                  int nr, int tag_len, void* cuda_stream) {
  return launch_fanout_f8(tab_rk, tab_f8, tab_mid, n_streams, data, length,
                          payload_off, iv, index, n_src, src, recv, out,
                          out_len, n, width, nr, tag_len, cuda_stream);
}

// The F8 phase probe: H-F8 at AES-128 as `ljt_srtp_fanout_f8` launches it,
// each tile writing its kF8PhaseSlots clock64 stamps to stamps [tiles *
// kF8PhaseSlots] and the plan (rows a tile, dynamic shared memory bytes,
// tiles) to plan_out [3].
extern "C" int ljt_srtp_fanout_f8_phases(
    const void* tab_rk, const void* tab_f8, const void* tab_mid,
    int n_streams, const void* data, const void* length,
    const void* payload_off, const void* iv, const void* index, int n_src,
    const void* src, const void* recv, void* out, void* out_len,
    void* stamps, void* plan_out, int n, int width, int tag_len,
    void* cuda_stream) {
  if (stamps == nullptr || plan_out == nullptr)
    return int(cudaErrorInvalidValue);
  return launch_fanout_f8<true>(
      tab_rk, tab_f8, tab_mid, n_streams, data, length, payload_off, iv,
      index, n_src, src, recv, out, out_len, n, width, 10, tag_len,
      cuda_stream, static_cast<long long*>(stamps),
      static_cast<int*>(plan_out));
}
