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
// levels made by warps 1-3) was slower here on an H100 at every SFU
// shape (275 x 10 and 1,100 x 10 copies of 80-180 bytes, 128 x 512 of
// 172): the hash waits on the levels and competes with them, and the
// keystream has a quarter fewer threads.  A copy's MAC (4-5 SHA-1
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
//    its k_e, two copies a thread (`f8_tile`, as K does), then the copy is
//    tagged.  The JAX translator has no such path: under an F8 profile it
//    runs AES-CM (translator.py:377-397), so the oracle of this instance
//    is the F8 table's protect of the copy at the same index.
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

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

// H's rows: copy k of the launch is packet src[k] under leg recv[k], both
// clamped into their tables; its ROC is index >> 16.  Its IV: under
// AES-CM RFC 3711 §4.1.1's salt ^ (SSRC << 64) ^ (48-bit index << 16),
// from the leg's salt; under AES-F8 its packet's row of `iv`; none under
// NULL.
template <Cipher C>
struct FanoutRows {
  const uint8_t* tab_salt;  // AES-CM: [n_streams, 16] leg salts
  const uint8_t* iv;        // AES-F8: [n_src, 16] packet IVs
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
    int len, off, leg, p;
    uint32_t ssrc;
    uint64_t idx;       // the 48-bit packet index
    uint4 v;            // AES-CM: the leg's salt; AES-F8: the packet's IV
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
    g.p = p;
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
    } else if constexpr (C == kF8) {
      if (aligned(iv, 16)) g.v = reinterpret_cast<const uint4*>(iv)[p];
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
    } else if constexpr (C == kF8) {
      iv_words(aligned(iv, 16), g.v, iv + size_t(g.p) * 16, ivw);
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

// H's body, one instance a cipher: the keystream over the staged copies
// in place (AES-CM: all four warps over the tile's (copy, block) pairs;
// AES-F8: the chains, two copies a thread; NULL: none), then lane r of
// warp 0 hashes copy r, its midstates, length and index still in
// registers from set-up, and writes the tag.
template <int NR, Cipher C>
__device__ __forceinline__ void srtp_fanout_tile(
    LJT_FANOUT_PARAMS, const uint8_t* __restrict__ tab_f8,
    const uint8_t* __restrict__ iv) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kInPlace, schedules_of(C));
  const typename FanoutRows<C>::Regs g = load_tile<NR>(
      t, tab_rk,
      cipher_rows<C>(FanoutRows<C>{tab_salt, iv, tab_mid, n_streams, data,
                                   length, payload_off, ssrc, index, n_src,
                                   src, recv, width},
                     tab_f8),
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
  srtp_fanout_tile<NR, kCm>(LJT_FANOUT_ARGS, nullptr, nullptr);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_fanout_f8_kernel(LJT_FANOUT_PARAMS,
                          const uint8_t* __restrict__ tab_f8,
                          const uint8_t* __restrict__ iv) {
  srtp_fanout_tile<NR, kF8>(LJT_FANOUT_ARGS, tab_f8, iv);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_fanout_null_kernel(LJT_FANOUT_PARAMS) {
  srtp_fanout_tile<NR, kNull>(LJT_FANOUT_ARGS, nullptr, nullptr);
}

template <Cipher C>
auto fanout_kernel(int nr) {
  if constexpr (C == kCm)
    return nr == 10 ? srtp_fanout_cm_kernel<10> : srtp_fanout_cm_kernel<14>;
  else if constexpr (C == kF8)
    return nr == 10 ? srtp_fanout_f8_kernel<10> : srtp_fanout_f8_kernel<14>;
  else
    return nr == 10 ? srtp_fanout_null_kernel<10>
                    : srtp_fanout_null_kernel<14>;
}

// The launch of H and of its F8 and NULL instances; `tab_f8` and `iv`, the
// F8 instance's second key table and packet IVs, are unused by the
// others, as `tab_salt` and `ssrc` are by the F8 and NULL instances.
template <Cipher C>
int launch_fanout(const void* tab_rk, const void* tab_f8, const void* tab_mid,
                  const void* tab_salt, int n_streams, const void* data,
                  const void* length, const void* payload_off,
                  const void* ssrc, const void* index, const void* iv,
                  int n_src, const void* src, const void* recv, void* out,
                  void* out_len, int n, int width, int nr, int tag_len,
                  void* cuda_stream) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_src <= 0 || n_streams <= 0 ||
      (C == kF8 && (tab_f8 == nullptr || iv == nullptr)))
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = fanout_kernel<C>(nr);
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kInPlace,
                      kCtasPerSmSfu, &p, schedules_of(C));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* rk = static_cast<const uint8_t*>(tab_rk);
  const auto* mid = static_cast<const uint32_t*>(tab_mid);
  const auto* salt = static_cast<const uint8_t*>(tab_salt);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ln = static_cast<const int32_t*>(length);
  const auto* off = static_cast<const int32_t*>(payload_off);
  const auto* sr = static_cast<const uint32_t*>(ssrc);
  const auto* ix = static_cast<const int64_t*>(index);
  const auto* sp = static_cast<const int32_t*>(src);
  const auto* rv = static_cast<const int32_t*>(recv);
  auto* o = static_cast<uint8_t*>(out);
  auto* olen = static_cast<int32_t*>(out_len);
  if constexpr (C == kF8)
    kernel<<<p.grid, kThreads, p.smem, s>>>(
        rk, mid, salt, n_streams, d, ln, off, sr, ix, n_src, sp, rv, o, olen,
        n, width, tag_len, p.rows, static_cast<const uint8_t*>(tab_f8),
        static_cast<const uint8_t*>(iv));
  else
    kernel<<<p.grid, kThreads, p.smem, s>>>(rk, mid, salt, n_streams, d, ln,
                                            off, sr, ix, n_src, sp, rv, o,
                                            olen, n, width, tag_len, p.rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtp_fanout_cm(const void* tab_rk, const void* tab_mid,
                                  const void* tab_salt, int n_streams,
                                  const void* data, const void* length,
                                  const void* payload_off, const void* ssrc,
                                  const void* index, int n_src,
                                  const void* src, const void* recv,
                                  void* out, void* out_len, int n, int width,
                                  int nr, int tag_len, void* cuda_stream) {
  return launch_fanout<kCm>(tab_rk, nullptr, tab_mid, tab_salt, n_streams,
                            data, length, payload_off, ssrc, index, nullptr,
                            n_src, src, recv, out, out_len, n, width, nr,
                            tag_len, cuda_stream);
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
  return launch_fanout<kNull>(tab_rk, nullptr, tab_mid, tab_salt, n_streams,
                              data, length, payload_off, ssrc, index, nullptr,
                              n_src, src, recv, out, out_len, n, width, nr,
                              tag_len, cuda_stream);
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
  return launch_fanout<kF8>(tab_rk, tab_f8, tab_mid, nullptr, n_streams, data,
                            length, payload_off, nullptr, index, iv, n_src,
                            src, recv, out, out_len, n, width, nr, tag_len,
                            cuda_stream);
}
