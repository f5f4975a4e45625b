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
// lanes of the AES-CTR idle, every CTA rebuilt its AES tables and
// regathered its keys, and the hash read the end of every row byte by
// byte.
//
// Design: the row-tile form of `srtp_tile.cuh` (one CTA of 128 threads
// per tile of at most 32 rows, two tiles an SM; set-up loads issued
// together, round keys sliced once a tile for the gather-free AES core
// of `aes.cuh`; AES-CTR over (row, keystream block) entries, a pair a
// thread, on warps 1-3; HMAC-SHA1 one row a lane of warp 0).
//  - Unprotect (D): warp 0 hashes the staged ciphertext while warps 1-3
//    decrypt into a second staged copy that becomes the output.  The tag
//    compare covers every tag byte.
//  - Protect (C): warps 1-3 make the keystream level by level (block k
//    of every row, then block k + 1), two entries a thread, and count
//    each level done; warp 0 hashes each 64-byte block of its row as
//    soon as the levels under it are complete (`PipedRowMsg`), so the
//    hash runs behind the XOR instead of after it, and sleeps between
//    polls so the shared-memory pipe stays with the producers.
// Rows wider than a 32-row tile can hold get fewer rows per tile (at
// least 3 at the wrappers' 32,768-byte limit).
//
// The NULL cipher (NULL_HMAC_SHA1_80; JAX `srtp_protect` /
// `srtp_unprotect` with encrypt=False) runs as the NULL instances of C
// and D (`srtp_protect_null`, `srtp_unprotect_null`): the same bodies
// with the keystream stage compiled out, no round keys loaded, the row
// staged once and hashed on warp 0.
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

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

// Protect's AES-CTR, level by level: keystream block k of every row of
// the tile, then block k + 1, so the first bytes of every row are ready
// first.  A thread takes two consecutive entries of that order at a time
// (the core encrypts a pair of blocks; the second entry is the next row's
// block k, or row 0's block k + 1), and counts each entry, padding
// entries of rows with fewer blocks included, in t.level[k] when it is
// done, so level k is complete when its count reaches the tile's rows.
template <int NR>
__device__ __forceinline__ void ctr_levels(const Tile& t, int first,
                                           int count) {
  int levels = 0;
  for (int r = 0; r < t.rows; ++r)
    levels = t.cnt[r] > levels ? t.cnt[r] : levels;
  int k = 2 * first / t.rows, r = 2 * first - k * t.rows;
  const int dk = 2 * count / t.rows, dr = 2 * count - dk * t.rows;
  for (; k < levels;) {
    int kb = k, rb = r + 1;
    if (rb == t.rows) {
      rb = 0;
      ++kb;
    }
    const bool two = kb < levels;
    const bool live_a = k < t.cnt[r], live_b = two && kb < t.cnt[rb];
    if (live_a || live_b) {
      const int ja = t.j0[r] + k, jb = t.j0[rb] + kb;
      uint32_t a[4], b[4], s[8];
      ljt_ctr_block(t.iv + 4 * r, uint32_t(ja), a);
      ljt_ctr_block(t.iv + 4 * rb, uint32_t(jb), b);
      ljt_aes_encrypt_pair<NR>(LjtSlicedKeys{t.rk + r * rk_stride(NR),
                                             t.rk + rb * rk_stride(NR)},
                               a, b, s);
      if (live_a)
        xor_block(t.buf + r * t.stride, t.off[r] + 16 * ja, t.s[r], t.e[r],
                  a);
      if (live_b)
        xor_block(t.buf + rb * t.stride, t.off[rb] + 16 * jb, t.s[rb],
                  t.e[rb], b);
    }
    __threadfence_block();
    atomicAdd(&t.level[k], 1);
    if (two) atomicAdd(&t.level[kb], 1);
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

// C's and D's bodies, one instance a cipher: AES-CM (kernels C and D) or
// the NULL cipher (RFC 3711 §4.1.3), whose keystream stage is compiled
// out: its tiles load no round keys, and warp 0 hashes the staged rows
// as they came while the other warps only stage and store.
#define LJT_SRTP_PROTECT_PARAMS                                              \
  const uint8_t *__restrict__ tab_rk, const uint32_t *__restrict__ tab_mid,  \
      const int32_t *__restrict__ stream, int n_streams,                     \
      const uint8_t *__restrict__ data, const int32_t *__restrict__ length,  \
      const int32_t *__restrict__ payload_off,                               \
      const uint8_t *__restrict__ iv, const uint32_t *__restrict__ roc,      \
      uint8_t *__restrict__ out, int32_t *__restrict__ out_len, int n,       \
      int width, int tag_len, int tile_rows
#define LJT_SRTP_PROTECT_ARGS                                                \
  tab_rk, tab_mid, stream, n_streams, data, length, payload_off, iv, roc,    \
      out, out_len, n, width, tag_len, tile_rows

template <int NR, Cipher C>
__device__ __forceinline__ void srtp_protect_tile(LJT_SRTP_PROTECT_PARAMS) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, C == kNull ? kInPlace : kLevels, schedules_of(C));
  load_tile<NR>(t, tab_rk,
                cipher_rows<C>(SrtpRows{stream, n_streams, data, length,
                                        payload_off, iv, width, 0},
                               nullptr),
                width);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: the keystream, level by level
    if constexpr (C == kCm) ctr_levels<NR>(t, threadIdx.x - 32, blockDim.x - 32);
  } else if (int(threadIdx.x) < t.rows) {
    // warp 0: one row a lane, each 64-byte block hashed once its
    // ciphertext is complete
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int len_in = length[row];
    const int len = ljt_clamp(len_in, 0, width);
    uint32_t mid[10];
    ljt_load_mid(tab_mid, ljt_clamp(stream[row], 0, n_streams - 1), mid);
    const LjtRowMsg msg(t.buf + r * t.stride, len, width, roc[row]);
    uint32_t d[5];
    if constexpr (C == kNull) {
      ljt_hmac_sha1(mid, msg, d);
    } else {
      const PipedRowMsg piped{msg, msg.mlen, t.level, t.rows, t.off[r],
                              t.s[r], t.e[r], t.j0[r], 0};
      ljt_hmac_sha1(mid, piped, d);
    }
    ljt_put_tag(t.buf + r * t.stride, len, width, d, tag_len);
    out_len[row] = len_in + tag_len;
  }
  __syncthreads();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_protect_cm_kernel(LJT_SRTP_PROTECT_PARAMS) {
  srtp_protect_tile<NR, kCm>(LJT_SRTP_PROTECT_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_protect_null_kernel(LJT_SRTP_PROTECT_PARAMS) {
  srtp_protect_tile<NR, kNull>(LJT_SRTP_PROTECT_ARGS);
}

#define LJT_SRTP_UNPROTECT_PARAMS                                            \
  const uint8_t *__restrict__ tab_rk, const uint32_t *__restrict__ tab_mid,  \
      const int32_t *__restrict__ stream, int n_streams,                     \
      const uint8_t *__restrict__ data, const int32_t *__restrict__ length,  \
      const int32_t *__restrict__ payload_off,                               \
      const uint8_t *__restrict__ iv, const uint32_t *__restrict__ roc,      \
      uint8_t *__restrict__ out, int32_t *__restrict__ out_mlen,             \
      uint8_t *__restrict__ auth_ok, int n, int width, int tag_len,          \
      int tile_rows
#define LJT_SRTP_UNPROTECT_ARGS                                              \
  tab_rk, tab_mid, stream, n_streams, data, length, payload_off, iv, roc,    \
      out, out_mlen, auth_ok, n, width, tag_len, tile_rows

template <int NR, Cipher C>
__device__ __forceinline__ void srtp_unprotect_tile(
    LJT_SRTP_UNPROTECT_PARAMS) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, C == kNull ? kInPlace : kSecondCopy,
                       schedules_of(C));
  load_tile<NR>(t, tab_rk,
                cipher_rows<C>(SrtpRows{stream, n_streams, data, length,
                                        payload_off, iv, width, tag_len},
                               nullptr),
                width);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: decrypt [payload_off, mlen) into the output copy; the
    // tag bytes past mlen stay
    keystream_tile<NR, C>(t, t.out, threadIdx.x - 32, blockDim.x - 32);
  } else if (int(threadIdx.x) < t.rows) {
    // warp 0: MAC over ciphertext[:mlen] || ROC, then every tag byte
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int len_in = length[row];
    const int mlen = ljt_clamp(len_in, 0, width) - tag_len;
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t mid[10];
      ljt_load_mid(tab_mid, ljt_clamp(stream[row], 0, n_streams - 1), mid);
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
  store_rows(C == kNull ? t.buf : t.out, out + size_t(t.base) * width, t.rows,
             width, t.stride);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_unprotect_cm_kernel(LJT_SRTP_UNPROTECT_PARAMS) {
  srtp_unprotect_tile<NR, kCm>(LJT_SRTP_UNPROTECT_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    srtp_unprotect_null_kernel(LJT_SRTP_UNPROTECT_PARAMS) {
  srtp_unprotect_tile<NR, kNull>(LJT_SRTP_UNPROTECT_ARGS);
}

// The launches of C, D and their NULL instances (whose tiles carry no key
// schedule).
template <Cipher C>
int launch_protect(const void* tab_rk, const void* tab_mid,
                   const void* stream, int n_streams, const void* data,
                   const void* length, const void* payload_off,
                   const void* iv, const void* roc, void* out, void* out_len,
                   int n, int width, int nr, int tag_len, void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 && nr != 14) return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = C == kNull ? (nr == 10 ? srtp_protect_null_kernel<10>
                                       : srtp_protect_null_kernel<14>)
                           : (nr == 10 ? srtp_protect_cm_kernel<10>
                                       : srtp_protect_cm_kernel<14>);
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr,
                      C == kNull ? kInPlace : kLevels, kCtasPerSm, &p,
                      schedules_of(C));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), n, width,
      tag_len, p.rows);
  return int(cudaGetLastError());
}

template <Cipher C>
int launch_unprotect(const void* tab_rk, const void* tab_mid,
                     const void* stream, int n_streams, const void* data,
                     const void* length, const void* payload_off,
                     const void* iv, const void* roc, void* out,
                     void* out_mlen, void* auth_ok, int n, int width, int nr,
                     int tag_len, void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 && nr != 14) return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = C == kNull ? (nr == 10 ? srtp_unprotect_null_kernel<10>
                                       : srtp_unprotect_null_kernel<14>)
                           : (nr == 10 ? srtp_unprotect_cm_kernel<10>
                                       : srtp_unprotect_cm_kernel<14>);
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr,
                      C == kNull ? kInPlace : kSecondCopy, kCtasPerSm, &p,
                      schedules_of(C));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_mlen),
      static_cast<uint8_t*>(auth_ok), n, width, tag_len, p.rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtp_protect_cm(const void* tab_rk, const void* tab_mid,
                                   const void* stream, int n_streams,
                                   const void* data, const void* length,
                                   const void* payload_off, const void* iv,
                                   const void* roc, void* out, void* out_len,
                                   int n, int width, int nr, int tag_len,
                                   void* cuda_stream) {
  return launch_protect<kCm>(tab_rk, tab_mid, stream, n_streams, data,
                               length, payload_off, iv, roc, out, out_len, n,
                               width, nr, tag_len, cuda_stream);
}

extern "C" int ljt_srtp_protect_null(const void* tab_rk, const void* tab_mid,
                                     const void* stream, int n_streams,
                                     const void* data, const void* length,
                                     const void* payload_off, const void* iv,
                                     const void* roc, void* out,
                                     void* out_len, int n, int width, int nr,
                                     int tag_len, void* cuda_stream) {
  return launch_protect<kNull>(tab_rk, tab_mid, stream, n_streams, data,
                              length, payload_off, iv, roc, out, out_len, n,
                              width, nr, tag_len, cuda_stream);
}

extern "C" int ljt_srtp_unprotect_cm(const void* tab_rk, const void* tab_mid,
                                     const void* stream, int n_streams,
                                     const void* data, const void* length,
                                     const void* payload_off, const void* iv,
                                     const void* roc, void* out,
                                     void* out_mlen, void* auth_ok, int n,
                                     int width, int nr, int tag_len,
                                     void* cuda_stream) {
  return launch_unprotect<kCm>(tab_rk, tab_mid, stream, n_streams, data,
                                 length, payload_off, iv, roc, out, out_mlen,
                                 auth_ok, n, width, nr, tag_len, cuda_stream);
}

extern "C" int ljt_srtp_unprotect_null(
    const void* tab_rk, const void* tab_mid, const void* stream,
    int n_streams, const void* data, const void* length,
    const void* payload_off, const void* iv, const void* roc, void* out,
    void* out_mlen, void* auth_ok, int n, int width, int nr, int tag_len,
    void* cuda_stream) {
  return launch_unprotect<kNull>(tab_rk, tab_mid, stream, n_streams, data,
                                length, payload_off, iv, roc, out, out_mlen,
                                auth_ok, n, width, nr, tag_len, cuda_stream);
}
