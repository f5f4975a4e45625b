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
// compressions).
//
// Design.  Both take the row-tile form of `srtp_tile.cuh`: one CTA of 128
// threads a tile of at most 32 rows, four tiles an SM; set-up loads each
// row's length, IV, E || index word and midstates together with the rows
// and round keys, which it slices for the gather-free AES core.
//  - J, as kernel D: lane r of warp 0 hashes row r's staged ciphertext
//    while warps 1-3 decrypt the E = 1 rows, over their (row, keystream
//    block) entries, into a second staged copy that becomes the output
//    (E = 0 rows have no keystream blocks and pass through).  The word
//    is read from the 4 bytes where the trailer sits.
//  - I, as kernel H: all four warps encrypt [8, len) of the staged rows
//    in place; then lane r of warp 0, whose midstates, length and word
//    are still in registers from set-up, hashes [0, len) || word and
//    writes the word at len and the tag at len + 4 into the staged row
//    (bytes at or past the width dropped), which the tile then stores.
// The first form of I (one warp a row, lane 0 hashing while 31 waited,
// the AES tables rebuilt every 4 rows) read 60x its bound.
//
// Semantics (held byte for byte against `srtcp_protect_plain` /
// `srtcp_unprotect_plain` in transform/srtp/kernel.py): lengths are
// clamped to [0, width] and stream ids into the table; bytes written at or
// past the width are dropped and message bytes there read as 0; J reads
// the word at positions clamped into [0, width - 1] and fails rows whose
// mlen is negative.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

// Write the bytes of the big-endian word v at [pos, pos + 4) of a staged
// row, those at or past width dropped.
__device__ __forceinline__ void put_word(uint32_t* row, int pos, int width,
                                         uint32_t v) {
  uint8_t* b = reinterpret_cast<uint8_t*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (pos + k < width) b[pos + k] = uint8_t(v >> (8 * (3 - k)));
}

// I's rows: staged from the tile's first row on, keys by stream id, one
// IV and one E || index word a row given; the window is [8, len).
struct SrtcpProtectRows {
  const int32_t* stream;
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const uint8_t* iv;
  const uint32_t* index_word;
  const uint32_t* tab_mid;
  int width;

  struct Lead {
    int sid;
  };
  struct Regs {
    int len;
    uint32_t word;
    uint4 iv;
    uint32_t mid[10];
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(stream[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ TileRows staged(int base) const {
    return TileRows{data + size_t(base) * width};
  }
  __device__ __forceinline__ Lead lead(int row) const {
    return Lead{key_row(row)};
  }
  __device__ __forceinline__ Regs load(int row, const Lead& lead) const {
    Regs g;
    g.len = length[row];
    g.word = index_word[row];
    g.iv = aligned(iv, 16) ? reinterpret_cast<const uint4*>(iv)[row]
                           : make_uint4(0, 0, 0, 0);
    ljt_load_mid(tab_mid, lead.sid, g.mid);
    return g;
  }
  __device__ __forceinline__ void window(const Regs& g, int row, int w,
                                         int& off, int& end,
                                         uint32_t ivw[4]) const {
    off = 8;
    end = ljt_clamp(g.len, 0, w);
    iv_words(aligned(iv, 16), g.iv, iv + size_t(row) * 16, ivw);
  }
};

template <int NR>
__global__ void __launch_bounds__(kThreads) srtcp_protect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const uint8_t* __restrict__ iv, const uint32_t* __restrict__ index_word,
    uint8_t* __restrict__ out, int32_t* __restrict__ out_len, int n,
    int width, int tag_len, int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kInPlace);
  const SrtcpProtectRows::Regs g = load_tile<NR>(
      t, tab_rk,
      SrtcpProtectRows{stream, n_streams, data, length, iv, index_word,
                       tab_mid, width},
      width);
  __syncthreads();
  // all four warps: the keystream over [8, len), in place
  ctr_tile<NR>(t, t.buf, threadIdx.x, blockDim.x);
  __syncthreads();
  if (int(threadIdx.x) < t.rows) {
    // warp 0: row r on lane r: the MAC over [0, len) || word, then the
    // word at len and the tag after it
    const int r = threadIdx.x;
    const int len = ljt_clamp(g.len, 0, width);
    uint32_t* row = t.buf + r * t.stride;
    uint32_t d[5];
    ljt_hmac_sha1(g.mid, LjtRowMsg(row, len, width, g.word), d);
    put_word(row, len, width, g.word);
    ljt_put_tag(row, len + 4, width, d, tag_len);
    out_len[t.base + r] = g.len + 4 + tag_len;
  }
  __syncthreads();
  store_rows(t.buf, out + size_t(t.base) * width, t.rows, width, t.stride);
}

// J's rows: staged from the tile's first row on, keys by stream id, one
// IV a row given; the window is [8, mlen) where the E bit of the word at
// mlen = length - tag_len - 4 is set, and empty where it is not.
struct SrtcpRows {
  const int32_t* stream;
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const uint8_t* iv;
  const uint32_t* tab_mid;
  int width, tag_len;

  struct Lead {
    int len, sid;
  };
  struct Regs {
    int len;
    uint32_t word;  // E || SRTCP index, read at positions clamped into the row
    uint4 iv;
    uint32_t mid[10];
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(stream[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ TileRows staged(int base) const {
    return TileRows{data + size_t(base) * width};
  }
  __device__ __forceinline__ int mlen(int len) const {
    return ljt_clamp(len, 0, width) - tag_len - 4;
  }
  __device__ __forceinline__ Lead lead(int row) const {
    return Lead{length[row], key_row(row)};
  }
  __device__ __forceinline__ Regs load(int row, const Lead& lead) const {
    Regs g;
    g.len = lead.len;
    const uint8_t* b = data + size_t(row) * width;
    const int m = mlen(g.len);
    g.word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g.word = (g.word << 8) | b[ljt_clamp(m + k, 0, width - 1)];
    g.iv = aligned(iv, 16) ? reinterpret_cast<const uint4*>(iv)[row]
                           : make_uint4(0, 0, 0, 0);
    ljt_load_mid(tab_mid, lead.sid, g.mid);
    return g;
  }
  __device__ __forceinline__ void window(const Regs& g, int row, int,
                                         int& off, int& end,
                                         uint32_t ivw[4]) const {
    off = 8;
    end = (g.word >> 31) ? mlen(g.len) : 0;
    iv_words(aligned(iv, 16), g.iv, iv + size_t(row) * 16, ivw);
  }
};

template <int NR>
__global__ void __launch_bounds__(kThreads) srtcp_unprotect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const uint8_t* __restrict__ iv, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_mlen, uint8_t* __restrict__ auth_ok,
    int32_t* __restrict__ e_bit, int32_t* __restrict__ index, int n,
    int width, int tag_len, int tile_rows) {
  extern __shared__ uint4 smem[];
  const Tile t = carve(reinterpret_cast<uint32_t*>(smem), tile_rows, n, width,
                       NR, kSecondCopy);
  const SrtcpRows rows{stream, n_streams, data, length, iv, tab_mid, width,
                       tag_len};
  const SrtcpRows::Regs g = load_tile<NR>(t, tab_rk, rows, width);
  __syncthreads();
  if (threadIdx.x >= 32) {
    // warps 1-3: decrypt the E = 1 rows' [8, mlen) into the output copy
    ctr_tile<NR>(t, t.out, threadIdx.x - 32, blockDim.x - 32);
  } else if (int(threadIdx.x) < t.rows) {
    // warp 0: MAC over ciphertext[:mlen] || word, then every tag byte
    const int r = threadIdx.x;
    const int row = t.base + r;
    const int mlen = rows.mlen(g.len);
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t d[5];
      ljt_hmac_sha1(g.mid,
                    LjtRowMsg(t.buf + r * t.stride, mlen, width, g.word), d);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(t.buf + r * t.stride);
      diff = 0;
#pragma unroll
      for (int k = 0; k < 20; ++k)
        if (k < tag_len)
          diff |= uint32_t(b[mlen + 4 + k] ^ ljt_digest_byte(d, k));
    }
    auth_ok[row] = diff == 0;
    out_mlen[row] = g.len - tag_len - 4;
    e_bit[row] = int32_t(g.word >> 31);
    index[row] = int32_t(g.word & 0x7FFFFFFFu);
  }
  __syncthreads();
  store_rows(t.out, out + size_t(t.base) * width, t.rows, width, t.stride);
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
  static std::atomic<unsigned> done[2];
  auto kernel = nr == 10 ? srtcp_protect_cm_kernel<10>
                         : srtcp_protect_cm_kernel<14>;
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kInPlace,
                      kCtasPerSmSfu, &p);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const uint8_t*>(iv),
      static_cast<const uint32_t*>(index_word), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_len), n, width, tag_len, p.rows);
  return int(cudaGetLastError());
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
  static std::atomic<unsigned> done[2];
  auto kernel = nr == 10 ? srtcp_unprotect_cm_kernel<10>
                         : srtcp_unprotect_cm_kernel<14>;
  Plan p;
  const int rc = plan(kernel, done[nr == 14], n, width, nr, kSecondCopy,
                      kCtasPerSmSfu, &p);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  kernel<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const uint8_t*>(tab_rk),
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const int32_t*>(stream), n_streams,
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length),
      static_cast<const uint8_t*>(iv), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_mlen), static_cast<uint8_t*>(auth_ok),
      static_cast<int32_t*>(e_bit), static_cast<int32_t*>(index), n, width,
      tag_len, p.rows);
  return int(cudaGetLastError());
}
