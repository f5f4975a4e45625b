// Kernel H: the SFU fan-out, one AES-CM + HMAC-SHA1 SRTP protect of every
// (packet, receiver leg) pair, each under its leg's keys.
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
// Design (a first, simple form): one warp per output row, four rows a
// block.  The warp stages its packet row and its leg's round keys in
// shared memory, its lanes take the row's keystream blocks in turn, lane 0
// hashes the row, and the warp writes it out.  The hash leaves 31 lanes
// idle; other warps of the SM fill the issue slots.  Rows are packet-major
// in the order the host gives them.
//
// Semantics (held byte for byte against `srtp_fanout_protect_plain` in
// transform/srtp/kernel.py): src and recv are clamped into the packet and
// table rows, lengths to [0, width]; message bytes at or past the width
// read as 0 and tag bytes past it are dropped; the output row is the
// whole width-byte packet row with the window encrypted and the tag
// written at the length, and its length is length + tag_len.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_row.cuh"

namespace {

template <int NR>
__global__ void __launch_bounds__(32 * kLjtRowWarps) srtp_fanout_cm_kernel(
    const uint8_t* __restrict__ tab_rk, const uint32_t* __restrict__ tab_mid,
    const uint8_t* __restrict__ tab_salt, int n_streams,
    const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
    const int32_t* __restrict__ payload_off,
    const uint32_t* __restrict__ ssrc, const int64_t* __restrict__ index,
    int n_src, const int32_t* __restrict__ src,
    const int32_t* __restrict__ recv, uint8_t* __restrict__ out,
    int32_t* __restrict__ out_len, int n, int width, int tag_len) {
  extern __shared__ uint4 smem[];
  const LjtWarpRow w =
      ljt_warp_row(reinterpret_cast<uint32_t*>(smem), width, NR);
  ljt_aes_fill_te0(w.te);
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const bool live = r < n;
  int p = 0, leg = 0;
  if (live) {
    p = ljt_clamp(src[r], 0, n_src - 1);
    leg = ljt_clamp(recv[r], 0, n_streams - 1);
    ljt_warp_load_keys(w, tab_rk, leg, NR);
    ljt_warp_load_row(w, data + size_t(p) * width, width);
  }
  __syncthreads();
  if (!live) return;
  const int len_in = length[p];
  const int len = ljt_clamp(len_in, 0, width);
  const int off = payload_off[p];
  // RFC 3711 §4.1.1: IV = salt ^ (SSRC << 64) ^ (index << 16)
  const uint64_t idx = uint64_t(index[p]) & 0xFFFFFFFFFFFFull;
  const uint8_t* salt = tab_salt + size_t(leg) * 16;
  const uint32_t iv[4] = {
      ljt_load_be32(salt), ljt_load_be32(salt + 4) ^ ssrc[p],
      ljt_load_be32(salt + 8) ^ uint32_t(idx >> 16),
      ljt_load_be32(salt + 12) ^ (uint32_t(idx & 0xFFFF) << 16)};
  ljt_warp_ctr<NR>(w, iv, off, off > 0 ? off : 0, len);
  __syncwarp();
  if (w.lane == 0) {
    uint32_t mid[10];
    ljt_load_mid(tab_mid, leg, mid);
    uint32_t d[5];
    ljt_hmac_sha1(mid, LjtRowMsg(w.row, len, width, uint32_t(idx >> 16)), d);
    ljt_put_tag(w.row, len, width, d, tag_len);
    out_len[r] = len_in + tag_len;
  }
  __syncwarp();
  ljt_warp_store_row(w, out + size_t(r) * width, width);
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
  if (n <= 0) return 0;
  if (nr != 10 && nr != 14) return int(cudaErrorInvalidValue);
  const int warps = ljt_row_warps(width, nr);
  if (width <= 0 || n_src <= 0 || n_streams <= 0 || warps < 1)
    return int(cudaErrorInvalidValue);
  const int smem = ljt_row_smem(width, nr, warps);
  const dim3 grid((n + warps - 1) / warps);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define LJT_FANOUT_ARGS                                                      \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint32_t*>(tab_mid), \
      static_cast<const uint8_t*>(tab_salt), n_streams,                       \
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(length), \
      static_cast<const int32_t*>(payload_off),                               \
      static_cast<const uint32_t*>(ssrc), static_cast<const int64_t*>(index), \
      n_src, static_cast<const int32_t*>(src),                                \
      static_cast<const int32_t*>(recv), static_cast<uint8_t*>(out),          \
      static_cast<int32_t*>(out_len), n, width, tag_len
  if (nr == 10) {
    srtp_fanout_cm_kernel<10><<<grid, 32 * warps, smem, s>>>(LJT_FANOUT_ARGS);
  } else {
    srtp_fanout_cm_kernel<14><<<grid, 32 * warps, smem, s>>>(LJT_FANOUT_ARGS);
  }
#undef LJT_FANOUT_ARGS
  return int(cudaGetLastError());
}
