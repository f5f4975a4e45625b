// Kernels K and L: fused SRTP AES-F8 + HMAC-SHA1 protect and unprotect.
//
// Replace: libjitsi_tpu/transform/srtp/kernel.py `srtp_protect` and
// `srtp_unprotect` with `f8_round_keys` set (the F8 profile,
// F8_128_HMAC_SHA1_80), whose keystream is libjitsi_tpu/kernels/aes.py
// `f8_keystream` (:351) XORed in by `f8_crypt_uniform` (:430) or
// `f8_crypt_offset` (:492): an XLA `lax.scan` over a packet's blocks, each
// step one batched AES call, then the HMAC and the byte scatter/gather as
// separate XLA stages over [B, W] planes, after a [B, R, 16] gather of both
// key schedules per packet row.
//
// RFC 3711 §4.1.2: IV' = E(k_e XOR m, IV), S(j) = E(k_e, IV' ^ j ^
// S(j - 1)), S(-1) = 0, j a 32-bit big-endian counter in bytes 12-15.  The
// host builds the IV (0x00 || M,PT || SEQ || TS || SSRC || ROC) and keeps
// both schedules per stream (context.py); each row reads its two round-key
// rows from the tables by stream id, as C and D read one.
//
// Bound on the H100: the chain, not bytes or operations.  A row's blocks
// depend one on the next, so the longest row of a launch is a chain of
// (its blocks + 1) AES pair steps on one lane: a 950-byte payload is 60
// blocks + IV', 61 steps of ~3,900 cycles each at AES-128 (`latency_floor`
// `aes_pair_cycles`), about 0.12 ms at 1,980 MHz.  The operations bound
// (AES blocks + SHA-1 compressions at the INT32 pipe's rate, reckoned as
// C's) is some 40x below the chain's floor at a production-mix batch.
//
// Design: H-F8's tile (`srtp_fanout.cu`) over the SRTP rows.  The core's
// pair of blocks nearly fills its SM sub-partition's INT32 pipe, so a
// chain step costs what the core costs only where a warp walks chains
// alone on its sub-partition, under keys it reads as they are:
//  - A tile of up to kRows rows on 128 threads (at most 64 rows) or 256,
//    one tile an SM where the launch allows (kTilesPerSm: on an H100, 2
//    tiles an SM timed the same and 4 up to 1.09x slower at the mix
//    batch's launches).  Chain thread i of warp 0 (and 1) walks rows i
//    and i + half in lockstep (`f8_chain_rows`), one
//    `ljt_aes_encrypt_pair` a step.
//  - Set-up, with every thread: each row's window and IV; each chain
//    pair's k_e schedules and its k_e XOR m schedules, a round key of the
//    two rows sliced together into the core's two block slots
//    (`slice_f8_schedules`, by stream id), so a step reads 8 key words a
//    round and merges none; the rows staged.
//  - Protect (K): the chains encrypt in place, each step's blocks counted
//    in their row's `done`; the warps of the other sub-partitions (2-3,
//    and 6-7 at 256 threads) hash one row a lane, each 64-byte SHA-1 block
//    of ciphertext || ROC as soon as the keystream blocks covering it are
//    XORed (`ChainedRowMsg`), and write the tag: no barrier between the
//    chain and the hash, which ends once the blocks the last keystream
//    block reaches and the outer hash are compressed.
//  - Unprotect (L): the chains decrypt into a second staged copy, which
//    becomes the output, while the same hashing warps hash the staged
//    ciphertext and check every tag byte.
// (On `f8_tile`, with each row's schedules sliced apart and merged on
// every round of every step, a step took ~4,900 cycles on an H100, and
// K's hash after every chain of its tile added a 950-byte row's 17
// compressions.)
// The phase probe (`ljt_srtp_f8_phases`, below) stamps this tile's
// set-up, IV', chains, hash and store with clock64; the shipped kernels
// carry no stamp.
//
// Semantics (held byte for byte against `srtp_protect_plain` /
// `srtp_unprotect_plain` with cipher "f8" in transform/srtp/kernel.py):
// those of C and D (lengths clamped to [0, width], bytes past the width
// dropped or read as 0, stream ids clamped into the table, every tag byte
// checked, the tag bytes left in the output past mlen).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "phases.cuh"
#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

constexpr int kMaxThreads = 256;
constexpr int kNarrowRows = 64;   // rows a 128-thread tile holds: 32 pairs
constexpr int kRows = 128;        // rows a 256-thread tile holds: 64 pairs
constexpr int kTilesPerSm = 1;
// Words a row keeps after the SRTP tile: the keystream blocks of its
// chain XORed so far.
constexpr int kExtraWords = 1;

// The phase probe's stamps of a tile (kPhaseSlots words a tile, as
// H-F8's): its start, set-up done, IV' done (warp 0's first chain), 0, the
// hash joined, the rows stored, its SM, the global timer (ns) at its
// start, its rows, thread 0's rows' loads done, its slicing done, the
// global timer at its end; then for each warp w at kPhaseWarp + 3w its
// slot on the SM + 1 (`%warpid`; 0 for a warp that walks no chain and
// hashes no row), its chain's end and its hash's end (lane 0's).
constexpr int kPhaseSlots = 40;
constexpr int kPhaseWarp = 16;

#define LJT_F8_PARAMS                                                       \
  const uint8_t *__restrict__ tab_rk, const uint8_t *__restrict__ tab_f8,   \
      const uint32_t *__restrict__ tab_mid,                                 \
      const int32_t *__restrict__ stream, int n_streams,                    \
      const uint8_t *__restrict__ data, const int32_t *__restrict__ length, \
      const int32_t *__restrict__ payload_off,                              \
      const uint8_t *__restrict__ iv, const uint32_t *__restrict__ roc,     \
      uint8_t *__restrict__ out, int32_t *__restrict__ out_len,             \
      uint8_t *__restrict__ auth_ok, int n, int width, int tag_len,         \
      int tile_rows
#define LJT_F8_ARGS                                                         \
  tab_rk, tab_f8, tab_mid, stream, n_streams, data, length, payload_off,    \
      iv, roc, out, out_len, auth_ok, n, width, tag_len, tile_rows

// K's (Unprotect false) and L's tile; `stamps`: the phase probe's
// (Phases).  out_len is L's out_mlen, and auth_ok L's alone.
template <int NR, bool Unprotect, bool Phases = false>
__device__ __forceinline__ void f8_rows_tile(LJT_F8_PARAMS,
                                             long long* stamps = nullptr) {
  constexpr TileKind kKind = Unprotect ? kSecondCopy : kInPlace;
  extern __shared__ uint4 smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  const Tile t = carve(words, tile_rows, n, width, NR, kKind, 2);
  int* done = reinterpret_cast<int*>(
      words + tile_words(tile_rows, width, NR, kKind, 2));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int threads = blockDim.x;
  long long* st = nullptr;
  if constexpr (Phases) {
    st = stamps + size_t(blockIdx.x) * kPhaseSlots;
    if (tid == 0) {
      st[0] = clock64();
      st[6] = phase_smid();
      st[7] = phase_globaltimer();
    }
  }
  // set-up: row r's window [payload_off, length less the tag for L) and IV
  // (thread r), both schedules of each chain pair, the rows
  const SrtpRows rows{stream, n_streams, data, length, payload_off, iv,
                      width, Unprotect ? tag_len : 0};
  if (tid < t.rows) {
    const SrtpRows::Regs g = rows.load(t.base + tid, {});
    int off, end;
    uint32_t ivw[4];
    rows.window(g, t.base + tid, width, off, end, ivw);
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
  if constexpr (Phases)
    if (tid == 0) st[9] = clock64();
  slice_f8_schedules<NR>(t, tab_rk, tab_f8, stream, n_streams, threads);
  if constexpr (Phases)
    if (tid == 0) st[10] = clock64();
  stage_rows(rows.staged(t.base), t.buf, t.out, t.rows, width, t.stride);
  __syncthreads();
  if constexpr (Phases) {
    if (tid == 0) {
      st[1] = clock64();
      st[8] = t.rows;
    }
  }
  [[maybe_unused]] const int pw = kPhaseWarp + 3 * warp;
  if (tid < threads / 4) {
    f8_chain_rows<NR>(t, Unprotect ? t.out : t.buf, done, tid,
                      Phases && tid == 0 ? st + 2 : nullptr);
    if constexpr (Phases) {
      if (lane == 0 && tid < (t.rows + 1) >> 1) {
        st[pw] = phase_warpid() + 1;
        st[pw + 1] = clock64();
      }
    }
  } else if ((warp & 3) >= 2) {
    // warps 2-3 (and 6-7): row h's MAC, then (K) its tag or (L) the check
    const int h = (warp < 4 ? warp - 2 : warp - 4) * 32 + lane;
    if (h < t.rows) {
      const int row = t.base + h;
      const int len_in = length[row];
      const int len = ljt_clamp(len_in, 0, width);
      uint32_t* r = t.buf + h * t.stride;
      uint32_t mid[10], d[5];
      ljt_load_mid(tab_mid, ljt_clamp(stream[row], 0, n_streams - 1), mid);
      if constexpr (Unprotect) {
        const int mlen = len - tag_len;
        uint32_t diff = 1;
        if (mlen >= 0) {
          ljt_hmac_sha1(mid, LjtRowMsg(r, mlen, width, roc[row]), d);
          const uint8_t* b = reinterpret_cast<const uint8_t*>(r);
          diff = 0;
#pragma unroll
          for (int k = 0; k < 20; ++k)
            if (k < tag_len)
              diff |= uint32_t(b[mlen + k] ^ ljt_digest_byte(d, k));
        }
        auth_ok[row] = diff == 0;
        out_len[row] = len_in - tag_len;
      } else {
        const LjtRowMsg msg(r, len, width, roc[row]);
        ljt_hmac_sha1(mid,
                      ChainedRowMsg{msg, msg.mlen, done + h, t.off[h],
                                    t.s[h], t.e[h]},
                      d);
        ljt_put_tag(r, len, width, d, tag_len);
        out_len[row] = len_in + tag_len;
      }
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
  store_rows(Unprotect ? t.out : t.buf, out + size_t(t.base) * width, t.rows,
             width, t.stride);
  if constexpr (Phases) {
    __syncthreads();
    if (tid == 0) {
      st[5] = clock64();
      st[11] = phase_globaltimer();
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kMaxThreads)
    srtp_protect_f8_kernel(LJT_F8_PARAMS) {
  f8_rows_tile<NR, false>(LJT_F8_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kMaxThreads)
    srtp_unprotect_f8_kernel(LJT_F8_PARAMS) {
  f8_rows_tile<NR, true>(LJT_F8_ARGS);
}

// The phase probe's instances of K and L (AES-128): the same tile with
// its clock64 stamps; on no path.
template <bool Unprotect>
__global__ void __launch_bounds__(kMaxThreads)
    srtp_f8_phases_kernel(LJT_F8_PARAMS, long long* stamps) {
  f8_rows_tile<10, Unprotect, true>(LJT_F8_ARGS, stamps);
}

// The launch of K or L, or of their phase probe (AES-128 only, which also
// takes the stamps and writes the plan: rows a tile, dynamic shared
// memory, tiles, threads).  A tile takes ceil(n / (per_sm * SMs)) rows,
// at most kRows and as many as fit the SM's shared memory, on 128
// threads where that is at most kNarrowRows rows, else 256.
template <bool Unprotect, bool Phases = false>
int launch_f8(const void* tab_rk, const void* tab_f8, const void* tab_mid,
              const void* stream, int n_streams, const void* data,
              const void* length, const void* payload_off, const void* iv,
              const void* roc, void* out, void* out_len, void* auth_ok,
              int n, int width, int nr, int tag_len, void* cuda_stream,
              int per_sm = kTilesPerSm, long long* stamps = nullptr,
              int* plan_out = nullptr) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || (Phases && nr != 10) || n_streams <= 0 ||
      per_sm < 1)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = [nr] {
    if constexpr (Phases)
      return srtp_f8_phases_kernel<Unprotect>;
    else if constexpr (Unprotect)
      return nr == 10 ? srtp_unprotect_f8_kernel<10>
                      : srtp_unprotect_f8_kernel<14>;
    else
      return nr == 10 ? srtp_protect_f8_kernel<10> : srtp_protect_f8_kernel<14>;
  }();
  Plan p;
  const int rc =
      plan(kernel, done[nr == 14], n, width, nr,
           Unprotect ? kSecondCopy : kInPlace, per_sm, &p, 2, kExtraWords,
           kRows);
  if (rc) return rc;
  const int threads = p.rows <= kNarrowRows ? kMaxThreads / 2 : kMaxThreads;
  if constexpr (Phases) {
    plan_out[0] = p.rows;
    plan_out[1] = p.smem;
    plan_out[2] = p.grid;
    plan_out[3] = threads;
  }
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* rk = static_cast<const uint8_t*>(tab_rk);
  const auto* f8 = static_cast<const uint8_t*>(tab_f8);
  const auto* mid = static_cast<const uint32_t*>(tab_mid);
  const auto* sid = static_cast<const int32_t*>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ln = static_cast<const int32_t*>(length);
  const auto* off = static_cast<const int32_t*>(payload_off);
  const auto* ivp = static_cast<const uint8_t*>(iv);
  const auto* rocp = static_cast<const uint32_t*>(roc);
  auto* o = static_cast<uint8_t*>(out);
  auto* olen = static_cast<int32_t*>(out_len);
  auto* ok = static_cast<uint8_t*>(auth_ok);
  if constexpr (Phases)
    kernel<<<p.grid, threads, p.smem, s>>>(rk, f8, mid, sid, n_streams, d, ln,
                                           off, ivp, rocp, o, olen, ok, n,
                                           width, tag_len, p.rows, stamps);
  else
    kernel<<<p.grid, threads, p.smem, s>>>(rk, f8, mid, sid, n_streams, d, ln,
                                           off, ivp, rocp, o, olen, ok, n,
                                           width, tag_len, p.rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtp_protect_f8(const void* tab_rk, const void* tab_f8,
                                   const void* tab_mid, const void* stream,
                                   int n_streams, const void* data,
                                   const void* length,
                                   const void* payload_off, const void* iv,
                                   const void* roc, void* out, void* out_len,
                                   int n, int width, int nr, int tag_len,
                                   void* cuda_stream) {
  return launch_f8<false>(tab_rk, tab_f8, tab_mid, stream, n_streams, data,
                          length, payload_off, iv, roc, out, out_len, nullptr,
                          n, width, nr, tag_len, cuda_stream);
}

extern "C" int ljt_srtp_unprotect_f8(const void* tab_rk, const void* tab_f8,
                                     const void* tab_mid, const void* stream,
                                     int n_streams, const void* data,
                                     const void* length,
                                     const void* payload_off, const void* iv,
                                     const void* roc, void* out,
                                     void* out_mlen, void* auth_ok, int n,
                                     int width, int nr, int tag_len,
                                     void* cuda_stream) {
  return launch_f8<true>(tab_rk, tab_f8, tab_mid, stream, n_streams, data,
                         length, payload_off, iv, roc, out, out_mlen, auth_ok,
                         n, width, nr, tag_len, cuda_stream);
}

// The phase probe of K and L (AES-128): the shipped tile with clock64
// stamps, kPhaseSlots a tile in stamps [tiles * kPhaseSlots], and its plan
// (rows a tile, dynamic shared memory bytes, tiles, threads) in plan_out
// [4], planned for `per_sm` tiles an SM (0: as the shipped kernels plan).
// out_len is L's out_mlen when `unprotect`; auth_ok is L's alone.
extern "C" int ljt_srtp_f8_phases(
    const void* tab_rk, const void* tab_f8, const void* tab_mid,
    const void* stream, int n_streams, const void* data, const void* length,
    const void* payload_off, const void* iv, const void* roc, void* out,
    void* out_len, void* auth_ok, void* stamps, void* plan_out, int n,
    int width, int tag_len, int unprotect, int per_sm, void* cuda_stream) {
  if (stamps == nullptr || plan_out == nullptr || per_sm < 0)
    return int(cudaErrorInvalidValue);
  auto* st = static_cast<long long*>(stamps);
  auto* po = static_cast<int*>(plan_out);
  const int k = per_sm ? per_sm : kTilesPerSm;
  return unprotect
             ? launch_f8<true, true>(tab_rk, tab_f8, tab_mid, stream,
                                     n_streams, data, length, payload_off, iv,
                                     roc, out, out_len, auth_ok, n, width, 10,
                                     tag_len, cuda_stream, k, st, po)
             : launch_f8<false, true>(tab_rk, tab_f8, tab_mid, stream,
                                      n_streams, data, length, payload_off,
                                      iv, roc, out, out_len, nullptr, n, width,
                                      10, tag_len, cuda_stream, k, st, po);
}
