// Kernels I and J: batched SRTCP AES-CM + HMAC-SHA1 protect and unprotect.
//
// Replace: libjitsi_tpu/transform/srtp/kernel.py `srtcp_protect` (I) and
// `srtcp_unprotect` (J), CM path, together with the per-stream gather of
// the RTCP key tables in libjitsi_tpu/transform/srtp/context.py
// `_protect_rtcp_dev` / `_unprotect_rtcp_dev`.  Each row reads its round
// keys and midstates from the tables by stream id, as C and D do.
//
// RFC 3711 §3.4: the first 8 bytes (RTCP header and sender SSRC) stay
// clear; the E || SRTCP-index word follows the packet and the tag covers
// packet || word.
//  - I encrypts [8, len), writes the word (already holding the E bit) at
//    len and the tag over [0, len + 4) at len + 4; the length grows by
//    4 + tag_len.
//  - J reads the word at mlen = len - tag_len - 4, checks every tag byte
//    over [0, mlen + 4) with no early exit, and decrypts [8, mlen) only
//    where the E bit is set (E = 0 rows pass through).  It returns the
//    rows, mlen, auth_ok, the E bit and the 31-bit index.
// The host assigns the indices, parses the trailer before the launch to
// build the IVs and keeps the replay window (context.py).
//
// Bound on the H100: operations (AES blocks and SHA-1 compressions per
// row; a compound RTCP packet of 60-200 bytes is 4-12 AES blocks and 2-4
// compressions).  Design (a first, simple form, the same as kernel H's):
// one warp per row, four rows a block; lanes take keystream blocks in
// turn, lane 0 hashes.  J hashes the staged ciphertext first, then its
// lanes decrypt in place.
//
// Semantics (held byte for byte against `srtcp_protect_plain` /
// `srtcp_unprotect_plain` in transform/srtp/kernel.py): lengths are
// clamped to [0, width] and stream ids into the table; bytes written at or
// past the width are dropped and message bytes there read as 0; J reads
// the word at positions clamped into [0, width - 1] and fails rows whose
// mlen is negative.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_row.cuh"

namespace {

__device__ __forceinline__ void load_iv(const uint8_t* iv, int r,
                                        uint32_t out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = ljt_load_be32(iv + size_t(r) * 16 + 4 * k);
}

template <int NR>
__global__ void __launch_bounds__(32 * kLjtRowWarps) srtcp_protect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const uint8_t* __restrict__ iv, const uint32_t* __restrict__ index_word,
    uint8_t* __restrict__ out, int32_t* __restrict__ out_len, int n,
    int width, int tag_len) {
  extern __shared__ uint4 smem[];
  const LjtWarpRow w =
      ljt_warp_row(reinterpret_cast<uint32_t*>(smem), width, NR);
  ljt_aes_fill_te0(w.te);
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const bool live = r < n;
  int sid = 0;
  if (live) {
    sid = ljt_clamp(stream[r], 0, n_streams - 1);
    ljt_warp_load_keys(w, tab_rk, sid, NR);
    ljt_warp_load_row(w, data + size_t(r) * width, width);
  }
  __syncthreads();
  if (!live) return;
  const int len_in = length[r];
  const int len = ljt_clamp(len_in, 0, width);
  uint32_t ctr[4];
  load_iv(iv, r, ctr);
  ljt_warp_ctr<NR>(w, ctr, 8, 8, len);
  __syncwarp();
  if (w.lane == 0) {
    const uint32_t word = index_word[r];
    uint32_t mid[10];
    ljt_load_mid(tab_mid, sid, mid);
    uint32_t d[5];
    ljt_hmac_sha1(mid, LjtRowMsg(w.row, len, width, word), d);
    ljt_put_word(w.row, len, width, word);
    ljt_put_tag(w.row, len + 4, width, d, tag_len);
    out_len[r] = len_in + 4 + tag_len;
  }
  __syncwarp();
  ljt_warp_store_row(w, out + size_t(r) * width, width);
}

template <int NR>
__global__ void __launch_bounds__(32 * kLjtRowWarps) srtcp_unprotect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const uint8_t* __restrict__ iv, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_mlen, uint8_t* __restrict__ auth_ok,
    int32_t* __restrict__ e_bit, int32_t* __restrict__ index, int n,
    int width, int tag_len) {
  extern __shared__ uint4 smem[];
  const LjtWarpRow w =
      ljt_warp_row(reinterpret_cast<uint32_t*>(smem), width, NR);
  ljt_aes_fill_te0(w.te);
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const bool live = r < n;
  int sid = 0;
  if (live) {
    sid = ljt_clamp(stream[r], 0, n_streams - 1);
    ljt_warp_load_keys(w, tab_rk, sid, NR);
    ljt_warp_load_row(w, data + size_t(r) * width, width);
  }
  __syncthreads();
  if (!live) return;
  const int len_in = length[r];
  const int mlen = ljt_clamp(len_in, 0, width) - tag_len - 4;
  const uint8_t* b = reinterpret_cast<const uint8_t*>(w.row);
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    word = (word << 8) | b[ljt_clamp(mlen + k, 0, width - 1)];
  if (w.lane == 0) {
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t mid[10];
      ljt_load_mid(tab_mid, sid, mid);
      uint32_t d[5];
      ljt_hmac_sha1(mid, LjtRowMsg(w.row, mlen, width, word), d);
      diff = 0;
#pragma unroll
      for (int k = 0; k < 20; ++k)
        if (k < tag_len)
          diff |= uint32_t(b[mlen + 4 + k] ^ ljt_digest_byte(d, k));
    }
    auth_ok[r] = diff == 0;
    out_mlen[r] = len_in - tag_len - 4;
    e_bit[r] = int32_t(word >> 31);
    index[r] = int32_t(word & 0x7FFFFFFFu);
  }
  __syncwarp();  // the hash has read the ciphertext
  if (word >> 31) {
    uint32_t ctr[4];
    load_iv(iv, r, ctr);
    ljt_warp_ctr<NR>(w, ctr, 8, 8, mlen);
  }
  __syncwarp();
  ljt_warp_store_row(w, out + size_t(r) * width, width);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int n, int width, int nr, void* cuda_stream,
           Args... args) {
  const int warps = ljt_row_warps(width, nr);
  if (width <= 0 || warps < 1) return int(cudaErrorInvalidValue);
  const dim3 grid((n + warps - 1) / warps);
  kernel<<<grid, 32 * warps, ljt_row_smem(width, nr, warps),
           static_cast<cudaStream_t>(cuda_stream)>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtcp_protect_cm(const void* tab_rk, const void* tab_mid,
                                    const void* stream, int n_streams,
                                    const void* data, const void* length,
                                    const void* iv, const void* index_word,
                                    void* out, void* out_len, int n,
                                    int width, int nr, int tag_len,
                                    void* cuda_stream) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0)
    return int(cudaErrorInvalidValue);
  auto kernel = nr == 10 ? srtcp_protect_cm_kernel<10>
                         : srtcp_protect_cm_kernel<14>;
  return launch(kernel, n, width, nr, cuda_stream,
                static_cast<const uint8_t*>(tab_rk),
                static_cast<const uint32_t*>(tab_mid),
                static_cast<const int32_t*>(stream), n_streams,
                static_cast<const uint8_t*>(data),
                static_cast<const int32_t*>(length),
                static_cast<const uint8_t*>(iv),
                static_cast<const uint32_t*>(index_word),
                static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len),
                n, width, tag_len);
}

extern "C" int ljt_srtcp_unprotect_cm(const void* tab_rk, const void* tab_mid,
                                      const void* stream, int n_streams,
                                      const void* data, const void* length,
                                      const void* iv, void* out,
                                      void* out_mlen, void* auth_ok,
                                      void* e_bit, void* index, int n,
                                      int width, int nr, int tag_len,
                                      void* cuda_stream) {
  if (n <= 0) return 0;
  if ((nr != 10 && nr != 14) || n_streams <= 0)
    return int(cudaErrorInvalidValue);
  auto kernel = nr == 10 ? srtcp_unprotect_cm_kernel<10>
                         : srtcp_unprotect_cm_kernel<14>;
  return launch(kernel, n, width, nr, cuda_stream,
                static_cast<const uint8_t*>(tab_rk),
                static_cast<const uint32_t*>(tab_mid),
                static_cast<const int32_t*>(stream), n_streams,
                static_cast<const uint8_t*>(data),
                static_cast<const int32_t*>(length),
                static_cast<const uint8_t*>(iv), static_cast<uint8_t*>(out),
                static_cast<int32_t*>(out_mlen),
                static_cast<uint8_t*>(auth_ok), static_cast<int32_t*>(e_bit),
                static_cast<int32_t*>(index), n, width, tag_len);
}
