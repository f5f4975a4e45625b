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
// Bound on the H100: operations at the main path's shapes (172-byte
// packets: 11 AES blocks + 4 SHA-1 compressions, at least ~4,500
// instructions of the INT32 pipe per row against ~0.4 KB moved).  Design: one CTA (one warp) per packet row.
// The CTA gathers its stream's round keys straight from the key table
// (no [B, R, 16] tensor), keeps the row in shared memory, makes each
// keystream block on its own thread and XORs the payload window
// [payload_off, end) in place; then one thread runs the HMAC over the
// row || ROC (the ROC is synthesized into the message, never written
// to the row) and the row leaves in one copy.  The serial HMAC on one
// lane is the known cost of this simple form.
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

#include <cstdint>

#include "aes.cuh"
#include "sha1.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kMaxRkWords = 60;  // AES-256: 15 round keys

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr int smem_bytes(int width) {
  return int(sizeof(LjtAesTables)) + kMaxRkWords * 4 + ((width + 15) & ~15);
}

struct RowSmem {
  LjtAesTables* tables;
  uint32_t* rk;
  uint8_t* buf;
};

__device__ __forceinline__ RowSmem carve(uint4* smem) {
  RowSmem r;
  r.tables = reinterpret_cast<LjtAesTables*>(smem);
  r.rk = reinterpret_cast<uint32_t*>(r.tables + 1);
  r.buf = reinterpret_cast<uint8_t*>(r.rk + kMaxRkWords);
  return r;
}

// Tables, the row's round keys and the row's bytes into shared memory.
template <int NR>
__device__ __forceinline__ void load_row(const RowSmem& sm,
                                         const uint8_t* tab_rk, int sid,
                                         const uint8_t* row, int width) {
  ljt_aes_load_tables(*sm.tables);
  const uint8_t* k = tab_rk + size_t(sid) * (NR + 1) * 16;
  for (int i = threadIdx.x; i < 4 * (NR + 1); i += blockDim.x)
    sm.rk[i] = ljt_load_be32(k + 4 * i);
  if ((width & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(row);
    uint4* d4 = reinterpret_cast<uint4*>(sm.buf);
    for (int i = threadIdx.x; i < width / 16; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x) sm.buf[i] = row[i];
  }
}

__device__ __forceinline__ void store_row(const uint8_t* buf, uint8_t* row,
                                          int width) {
  if ((width & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(buf);
    uint4* d4 = reinterpret_cast<uint4*>(row);
    for (int i = threadIdx.x; i < width / 16; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x) row[i] = buf[i];
  }
}

// XOR the AES-CTR keystream into columns [max(off, 0), min(end, width)):
// column c takes keystream byte c - off.  Each thread makes whole
// keystream blocks; threads write disjoint bytes.
template <int NR>
__device__ __forceinline__ void ctr_xor(const RowSmem& sm,
                                        const uint8_t* iv16, int off,
                                        int end, int width) {
  const int s = off > 0 ? off : 0;
  const int e = end < width ? end : width;
  if (s >= e) return;
  const uint32_t iv[4] = {ljt_load_be32(iv16), ljt_load_be32(iv16 + 4),
                          ljt_load_be32(iv16 + 8), ljt_load_be32(iv16 + 12)};
  const int j0 = (s - off) >> 4;
  const int j1 = (e - 1 - off) >> 4;
  for (int j = j0 + int(threadIdx.x); j <= j1; j += blockDim.x) {
    uint32_t c[4];
    ljt_ctr_block(iv, uint32_t(j), c);
    ljt_aes_encrypt_block<NR>(*sm.tables, sm.rk, c);
    const int base = off + 16 * j;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = base + k;
      if (col >= s && col < e)
        sm.buf[col] ^= uint8_t(c[k >> 2] >> (8 * (3 - (k & 3))));
    }
  }
}

__device__ __forceinline__ void load_mid(const uint32_t* tab_mid, int sid,
                                         uint32_t mid[10]) {
#pragma unroll
  for (int k = 0; k < 10; ++k) mid[k] = tab_mid[size_t(sid) * 10 + k];
}

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_protect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, int width, int tag_len) {
  extern __shared__ uint4 smem[];
  const RowSmem sm = carve(smem);
  const int row = blockIdx.x;
  const int sid = clamp_int(stream[row], 0, n_streams - 1);
  load_row<NR>(sm, tab_rk, sid, data + size_t(row) * width, width);
  __syncthreads();
  const int len_in = length[row];
  const int len = clamp_int(len_in, 0, width);
  ctr_xor<NR>(sm, iv + size_t(row) * 16, payload_off[row], len, width);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t mid[10];
    load_mid(tab_mid, sid, mid);
    const LjtMsg m{sm.buf, len, len + 4, width, roc[row], true};
    uint32_t d[5];
    ljt_hmac_sha1(mid, m, d);
    for (int k = 0; k < tag_len && len + k < width; ++k)
      sm.buf[len + k] = ljt_digest_byte(d, k);
    out_len[row] = len_in + tag_len;
  }
  __syncthreads();
  store_row(sm.buf, out + size_t(row) * width, width);
}

template <int NR>
__global__ void __launch_bounds__(kThreads) srtp_unprotect_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const int32_t* __restrict__ stream, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off, const uint8_t* __restrict__ iv,
    const uint32_t* __restrict__ roc, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_mlen, uint8_t* __restrict__ auth_ok,
    int width, int tag_len) {
  extern __shared__ uint4 smem[];
  const RowSmem sm = carve(smem);
  const int row = blockIdx.x;
  const int sid = clamp_int(stream[row], 0, n_streams - 1);
  load_row<NR>(sm, tab_rk, sid, data + size_t(row) * width, width);
  __syncthreads();
  const int len_in = length[row];
  const int mlen = clamp_int(len_in, 0, width) - tag_len;
  // 1. MAC over ciphertext[:mlen] || ROC, 2. compare every tag byte
  if (threadIdx.x == 0) {
    uint32_t diff = 1;
    if (mlen >= 0) {
      uint32_t mid[10];
      load_mid(tab_mid, sid, mid);
      const LjtMsg m{sm.buf, mlen, mlen + 4, width, roc[row], true};
      uint32_t d[5];
      ljt_hmac_sha1(mid, m, d);
      diff = 0;
      for (int k = 0; k < tag_len; ++k)
        diff |= uint32_t(sm.buf[clamp_int(mlen + k, 0, width - 1)] ^
                         ljt_digest_byte(d, k));
    }
    auth_ok[row] = diff == 0;
    out_mlen[row] = len_in - tag_len;
  }
  __syncthreads();
  // 3. decrypt the payload window; the tag bytes past mlen stay
  ctr_xor<NR>(sm, iv + size_t(row) * 16, payload_off[row], mlen, width);
  __syncthreads();
  store_row(sm.buf, out + size_t(row) * width, width);
}

}  // namespace

extern "C" int ljt_srtp_protect_cm(const void* tab_rk, const void* tab_mid,
                                   const void* stream, int n_streams,
                                   const void* data, const void* length,
                                   const void* payload_off, const void* iv,
                                   const void* roc, void* out, void* out_len,
                                   int n, int width, int nr, int tag_len,
                                   void* cuda_stream) {
  if (n <= 0) return 0;
  const int smem = smem_bytes(width);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define LJT_PROTECT_ARGS                                                    \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint32_t*>(tab_mid), \
      static_cast<const int32_t*>(stream), n_streams,                        \
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length), \
      static_cast<const int32_t*>(payload_off),                              \
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),    \
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len), width,     \
      tag_len
  if (nr == 10) {
    srtp_protect_cm_kernel<10><<<n, kThreads, smem, s>>>(LJT_PROTECT_ARGS);
  } else if (nr == 14) {
    srtp_protect_cm_kernel<14><<<n, kThreads, smem, s>>>(LJT_PROTECT_ARGS);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef LJT_PROTECT_ARGS
  return int(cudaGetLastError());
}

extern "C" int ljt_srtp_unprotect_cm(const void* tab_rk, const void* tab_mid,
                                     const void* stream, int n_streams,
                                     const void* data, const void* length,
                                     const void* payload_off, const void* iv,
                                     const void* roc, void* out,
                                     void* out_mlen, void* auth_ok, int n,
                                     int width, int nr, int tag_len,
                                     void* cuda_stream) {
  if (n <= 0) return 0;
  const int smem = smem_bytes(width);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define LJT_UNPROTECT_ARGS                                                  \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint32_t*>(tab_mid), \
      static_cast<const int32_t*>(stream), n_streams,                        \
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length), \
      static_cast<const int32_t*>(payload_off),                              \
      static_cast<const uint8_t*>(iv), static_cast<const uint32_t*>(roc),    \
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_mlen),           \
      static_cast<uint8_t*>(auth_ok), width, tag_len
  if (nr == 10) {
    srtp_unprotect_cm_kernel<10><<<n, kThreads, smem, s>>>(LJT_UNPROTECT_ARGS);
  } else if (nr == 14) {
    srtp_unprotect_cm_kernel<14><<<n, kThreads, smem, s>>>(LJT_UNPROTECT_ARGS);
  } else {
    return int(cudaErrorInvalidValue);
  }
#undef LJT_UNPROTECT_ARGS
  return int(cudaGetLastError());
}
