// Kernel B: batched HMAC-SHA1 from per-row key midstates.
//
// Replaces: libjitsi_tpu/kernels/sha1.py `hmac_sha1` (XLA device code on
// the SRTP path).  midstates [n, 2, 5] u32 (ipad, opad states from
// `hmac_precompute`), data [n, width] u8, lengths [n] i32 -> tags
// [n, 20] u8.  Lengths are clamped to [0, width].
//
// Bound on the H100: operations.  A 64-byte block needs at least 432
// instructions of the INT32 pipe (three rotates or LOP3 per round, three
// per schedule word) against 64 bytes read, above the card's ~5 per byte
// balance point of that pipe's rate to HBM bandwidth.  But one row's
// compressions depend on one another, so a launch takes at least the
// chain of its longest row on one lane (`chip_smoke.py` latency_floor).
//
// Design: the row-tile form of kernels C, D, H, I and J
// (`srtp_tile.cuh`), hash only.  One CTA of 128 threads takes a tile of
// rows:
//  - set-up: thread r loads row r's length and midstates, then the whole
//    CTA stages the tile's rows in shared memory at an odd word stride
//    (16-byte loads, several in flight a thread), so every global load
//    of the tile is issued before the first is waited on;
//  - thread r then hashes row r, every message word read whole from the
//    staged row, the padding and bit length merged in registers
//    (`LjtRowMsg` over the data alone): no compression waits on device
//    memory; it writes the tag as 5 big-endian words.
//  - Tiles: the fewest rows that still give every SM four tiles, at most
//    32 (one hashing warp): 4,096 rows are 512 tiles of 8, 1,100 rows 367
//    of 3.  Two other forms were measured and read slower on the H100
//    (PERF.md): 32-row tiles, one an SM, and 128-row tiles with all four
//    warps hashing.
//  - A row wider than a tile holds gets fewer rows a tile (the tile's own
//    rule); a row wider than the 227 KB a block can hold is staged in
//    chunks of whole 64-byte blocks, each hashed before the next is
//    staged.  Above 48 KB the launch raises the kernel's shared-memory
//    limit.
// The first form, one thread a row in 128-thread blocks reading each
// message word from device memory inside the hash chain, read 0.0322 ms
// at 4,096 x 1,504 (PERF.md).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

// Bytes [c0, c0 + cw) of each of the tile's rows (`stage_rows`' source).
struct ChunkRows {
  const uint8_t* g;  // the tile's first row
  int width;         // bytes a row
  int c0;            // the chunk's first byte

  __device__ __forceinline__ bool vec(int a, int cw) const {
    return ((cw | width | c0) & (a - 1)) == 0 && aligned(g, a);
  }
  template <class V>
  __device__ __forceinline__ V unit(int i, int per) const {
    const int r = i / per;
    return reinterpret_cast<const V*>(g + size_t(r) * width + c0)[i - r * per];
  }
  __device__ __forceinline__ uint8_t byte(int i, int cw) const {
    const int r = i / cw;
    return g[size_t(r) * width + c0 + (i - r * cw)];
  }
};

__global__ void __launch_bounds__(kThreads)
    hmac_sha1_kernel(const uint32_t* __restrict__ midstates,
                     const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lengths,
                     uint8_t* __restrict__ out, int n, int width,
                     int tile_rows, int chunk) {
  extern __shared__ uint4 smem[];
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);
  const int base = blockIdx.x * tile_rows;
  const int rows = n - base < tile_rows ? n - base : tile_rows;
  const int r = threadIdx.x;
  const int stride = row_stride(chunk < width ? chunk : width);
  uint32_t mid[10] = {};
  int len = 0;
  if (r < rows) {
    len = ljt_clamp(lengths[base + r], 0, width);
    ljt_load_mid(midstates, base + r, mid);
  }
  uint32_t h[5] = {mid[0], mid[1], mid[2], mid[3], mid[4]};
  const int nblk = (len + 9 + 63) / 64;
  const uint32_t bitlen = uint32_t(len + 64) * 8u;  // ipad block || data
  const uint8_t* g = data + size_t(base) * width;
  int c0 = 0;
  do {                       // one chunk, unless a row outgrows the block
    const int cw = chunk < width - c0 ? chunk : width - c0;
    if (c0) __syncthreads();                 // the last chunk is hashed
    stage_rows(ChunkRows{g, width, c0}, buf, nullptr, rows, cw, stride);
    __syncthreads();
    if (r < rows) {
      // the message from byte c0 on, blocks c0 / 64 .. of the row's nblk
      const LjtRowMsg m(buf + r * stride, len - c0);
      const int b0 = c0 / 64;
      int b1 = nblk;                 // the last chunk takes the padding
      if (c0 + cw < width && (c0 + cw) / 64 < b1) b1 = (c0 + cw) / 64;
      for (int b = b0; b < b1; ++b) {
        uint32_t w[16];
        ljt_msg_block(m, b - b0, w);
        if (b == nblk - 1) {
          w[14] = 0;
          w[15] = bitlen;
        }
        ljt_sha1_compress(h, w);
      }
    }
    c0 += chunk;
  } while (c0 < width);
  if (r < rows) {
    uint32_t d[5];
    ljt_hmac_outer(mid, h, d);
    uint8_t* o = out + size_t(base + r) * 20;
#pragma unroll
    for (int k = 0; k < 5; ++k) ljt_store_be32(o + 4 * k, d[k]);
  }
}

// Rows a tile and the chunk of a row staged at a time; returns the
// dynamic shared memory in bytes.
int plan_b(int n, int width, int* rows, int* chunk) {
  const int ctas = kCtasPerSmSfu * multiprocessors();
  int r = ctas > 0 ? (n + ctas - 1) / ctas : kTileRows;
  r = r < 1 ? 1 : (r > kTileRows ? kTileRows : r);
  const int fit = kMaxSmemBytes / 4 / row_stride(width);
  if (fit >= 1) {
    *rows = r < fit ? r : fit;
    *chunk = width;
  } else {                   // whole 64-byte blocks that fit r rows
    *rows = r;
    *chunk = (kMaxSmemBytes / 4 / r - 1) * 4 / 64 * 64;
  }
  return 4 * *rows * row_stride(*chunk < width ? *chunk : width);
}

}  // namespace

extern "C" int ljt_hmac_sha1(const void* midstates, const void* data,
                             const void* lengths, void* out, int n,
                             int width, void* stream) {
  if (n <= 0) return 0;
  if (width < 0) return int(cudaErrorInvalidValue);
  int rows, chunk;
  const int smem = plan_b(n, width, &rows, &chunk);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned> done;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return int(cudaErrorInvalidValue);
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (!bit || !(done.load() & bit)) {
      const int rc = int(cudaFuncSetAttribute(
          hmac_sha1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmemBytes));
      if (rc) return rc;
      done.fetch_or(bit);
    }
  }
  const int grid = (n + rows - 1) / rows;
  hmac_sha1_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(midstates),
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint8_t*>(out), n, width, rows, chunk);
  return int(cudaGetLastError());
}
