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
// Design: the row-tile form of `srtp_tile.cuh` (tiles of at most 32 rows,
// two an SM, set-up loads issued together; each row's k_e and k_e XOR m
// schedules sliced once a tile for the gather-free AES core), with the
// keystream of `f8_tile`: a thread takes two rows and walks both chains in
// lockstep, one `ljt_aes_encrypt_pair` a step, each block under its own
// row's key (step 0 under the second schedules); the shorter row stops
// contributing while the other goes on.
//  - Protect (K): every warp's threads take row pairs and encrypt the
//    staged rows in place; then lane r of warp 0 hashes row r || ROC and
//    writes the tag, as H and I do.
//  - Unprotect (L): warp 0 hashes the staged ciphertext while warps 1-3
//    decrypt into a second staged copy that becomes the output, as D does.
// Simple and right first: a tile of 16 rows keeps 8 threads busy with
// the chains, and hashing behind the chain (C's `PipedRowMsg`) is left
// for a later redesign.
//
// Semantics (held byte for byte against `srtp_protect_plain` /
// `srtp_unprotect_plain` with cipher "f8" in transform/srtp/kernel.py):
// those of C and D (lengths clamped to [0, width], bytes past the width
// dropped or read as 0, stream ids clamped into the table, every tag byte
// checked, the tag bytes left in the output past mlen).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_protect_f8_kernel(
    const uint8_t* __restrict__ tab_rk, const uint8_t* __restrict__ tab_f8,
    const uint32_t* __restrict__ tab_mid, const int32_t* __restrict__ stream,
    int n_streams, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, int n, int width, int tag_len,
    int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kInPlace, schedules_of(kF8));
  load_tile<NR>(t, tab_rk,
                cipher_rows<kF8>(SrtpRows{stream, n_streams, data, length,
                                          payload_off, iv, width, 0},
                                 tab_f8),
                width);
  __syncthreads();
  // every warp: the F8 chains, two rows a thread, in place
  f8_tile<NR>(t, t.buf, threadIdx.x, blockDim.x);
  __syncthreads();
  if (int(threadIdx.x) < t.rows) {
    // warp 0: one row a lane, the MAC over ciphertext || ROC and the tag
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int len_in = length[row];
    const int len = ljt_clamp(len_in, 0, width);
    uint32_t mid[10];
    ljt_load_mid(tab_mid, ljt_clamp(stream[row], 0, n_streams - 1), mid);
    uint32_t d[5];
    ljt_hmac_sha1(mid, LjtRowMsg(t.buf + r * t.stride, len, width, roc[row]),
                  d);
    ljt_put_tag(t.buf + r * t.stride, len, width, d, tag_len);
    out_len[row] = len_in + tag_len;
  }
  __syncthreads();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
}

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_unprotect_f8_kernel(
    const uint8_t* __restrict__ tab_rk, const uint8_t* __restrict__ tab_f8,
    const uint32_t* __restrict__ tab_mid, const int32_t* __restrict__ stream,
    int n_streams, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_mlen, uint8_t* __restrict__ auth_ok, int n,
    int width, int tag_len, int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kSecondCopy, schedules_of(kF8));
  load_tile<NR>(t, tab_rk,
                cipher_rows<kF8>(SrtpRows{stream, n_streams, data, length,
                                          payload_off, iv, width, tag_len},
                                 tab_f8),
                width);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: decrypt [payload_off, mlen) into the output copy, two
    // rows a thread; the tag bytes past mlen stay
    f8_tile<NR>(t, t.out, threadIdx.x - 32, blockDim.x - 32);
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
  store_rows(t.out, out + size_t(t.base) * width, t.rows, width, t.stride);
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
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = nr == 10 ? srtp_protect_f8_kernel<10>
                         : srtp_protect_f8_kernel<14>;
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kInPlace,
                      kCtasPerSm, &p, schedules_of(kF8));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk), static_cast<const uint8_t*>(tab_f8),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), n, width,
      tag_len, p.rows);
  return int(cudaGetLastError());
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
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0)
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done[2];
  auto kernel = nr == 10 ? srtp_unprotect_f8_kernel<10>
                         : srtp_unprotect_f8_kernel<14>;
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kSecondCopy,
                      kCtasPerSm, &p, schedules_of(kF8));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk), static_cast<const uint8_t*>(tab_f8),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(payload_off),
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_mlen),
      static_cast<uint8_t*>(auth_ok), n, width, tag_len, p.rows);
  return int(cudaGetLastError());
}
