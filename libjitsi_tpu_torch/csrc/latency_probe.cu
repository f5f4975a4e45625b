// Latency probe for the tile kernels: the cycles one SHA-1 compression
// and one pair of AES blocks take on a lane when each waits on the one
// before.
//
// Kernels C, D, H, I and J hash a row on one lane, so a row of k
// compressions cannot finish sooner than k compressions back to back;
// their AES-CTR runs a few pairs of blocks per lane.  The operation
// bound of `chip_smoke.py` counts instructions and sees neither
// latency.  This probe runs the
// same device code (`sha1.cuh`, `aes.cuh`) in a chain on one warp and
// times it with clock64, so a chip run can state those floors.  It is
// not on any path.
//
//   ljt_probe_sha1_chain: state [32, 21] u32 per lane (h[5] then w[16]):
//     n times h = compress(h, w), w unchanged; h written back.
//   ljt_probe_aes_chain: round keys [nr + 1, 16] u8, blocks [64, 16] u8:
//     lane l encrypts its pair (blocks 2l, 2l + 1) n times with the
//     gather-free core, under round keys sliced in shared memory as a
//     tile slices them (`LjtSlicedKeys`); blocks written back.
//   cycles [32] i64: clock64 cycles each lane spent in its n steps.
//   ljt_probe_hmac_row: midstates [32, 2, 5] u32, rows [32, width] u8:
//     `lanes` threads (1-32) of one warp stage the rows in shared memory
//     and each runs,
//     `reps` times, the HMAC-SHA1 of its row's first `len` bytes || a
//     4-byte word, read as the hashing lane of a tile kernel reads it
//     (`LjtRowMsg`), each time's word the last digest's first word
//     (written to digest [lanes] u32); cycles [lanes] as above.  The
//     rows are staged at the tile kernels' odd word stride (`row_stride`),
//     so the lanes' message words fall in different banks.
//     Beside the chain of bare compressions, this is what one row's MAC
//     costs its lane: the message words, padding and the outer block.
//   ljt_probe_empty: one warp that does nothing.  Its time on the card is
//     the launch floor: no kernel, however little work it does, takes
//     less, so a kernel of a few microseconds is read against it.
//   ljt_probe_cluster: one empty cluster of `cs` blocks of 256 threads,
//     launched as kernel E launches its clusters: the floor of a cluster
//     launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "aes.cuh"
#include "sha1.cuh"
#include "srtp_tile.cuh"

namespace {

__global__ void sha1_chain_kernel(uint32_t* __restrict__ state,
                                  long long* __restrict__ cycles, int n) {
  uint32_t* st = state + threadIdx.x * 21;
  uint32_t h[5], w[16];
#pragma unroll
  for (int k = 0; k < 5; ++k) h[k] = st[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = st[5 + k];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    uint32_t x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = w[k];
    ljt_sha1_compress(h, x);
  }
  const long long t1 = clock64();
#pragma unroll
  for (int k = 0; k < 5; ++k) st[k] = h[k];
  cycles[threadIdx.x] = t1 - t0;
}

template <int NR>
__global__ void aes_chain_kernel(const uint8_t* __restrict__ rk_bytes,
                                 uint8_t* __restrict__ blocks,
                                 long long* __restrict__ cycles, int n) {
  __shared__ uint32_t rk[8 * (NR + 1)];
  for (int q = threadIdx.x; q <= NR; q += blockDim.x) {
    uint32_t w[4], o[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = ljt_load_be32(rk_bytes + 16 * q + 4 * k);
    ljt_aes_slice_keys(q, w, w, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) rk[8 * q + k] = o[k];
  }
  __syncthreads();
  uint8_t* p = blocks + threadIdx.x * 32;
  uint32_t a[4], b[4], s[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = ljt_load_be32(p + 4 * k);
    b[k] = ljt_load_be32(p + 16 + 4 * k);
  }
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i)
    ljt_aes_encrypt_pair<NR>(LjtSlicedKeys{rk, rk}, a, b, s);
  const long long t1 = clock64();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ljt_store_be32(p + 4 * k, a[k]);
    ljt_store_be32(p + 16 + 4 * k, b[k]);
  }
  cycles[threadIdx.x] = t1 - t0;
}

__global__ void hmac_row_kernel(const uint32_t* __restrict__ tab_mid,
                                const uint8_t* __restrict__ rows, int len,
                                int width, uint32_t* __restrict__ digest,
                                long long* __restrict__ cycles, int reps) {
  extern __shared__ uint4 smem[];
  uint32_t* staged = reinterpret_cast<uint32_t*>(smem);
  const int stride = ljt_tile::row_stride(width);
  uint8_t* b = reinterpret_cast<uint8_t*>(staged);
  for (int i = threadIdx.x; i < 32 * width; i += blockDim.x)
    b[4 * stride * (i / width) + i % width] = rows[i];
  __syncthreads();
  uint32_t mid[10];
  ljt_load_mid(tab_mid, threadIdx.x, mid);
  uint32_t word = 0;
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    uint32_t d[5];
    ljt_hmac_sha1(mid, LjtRowMsg(staged + threadIdx.x * stride, len, width,
                                 word),
                  d);
    word = d[0];
  }
  const long long t1 = clock64();
  digest[threadIdx.x] = word;
  cycles[threadIdx.x] = t1 - t0;
}

__global__ void probe_empty_kernel() {}

__global__ void __launch_bounds__(256) cluster_probe_kernel() {}

}  // namespace

extern "C" int ljt_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

extern "C" int ljt_probe_sha1_chain(void* state, void* cycles, int n,
                                    void* stream) {
  sha1_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), static_cast<long long*>(cycles), n);
  return int(cudaGetLastError());
}

extern "C" int ljt_probe_hmac_row(const void* tab_mid, const void* rows,
                                  int len, int width, void* digest,
                                  void* cycles, int reps, int lanes,
                                  void* stream) {
  if (len < 0 || len + 4 > width || width > 1024 || lanes < 1 || lanes > 32)
    return int(cudaErrorInvalidValue);
  hmac_row_kernel<<<1, lanes, 32 * 4 * ljt_tile::row_stride(width),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab_mid),
      static_cast<const uint8_t*>(rows), len, width,
      static_cast<uint32_t*>(digest), static_cast<long long*>(cycles), reps);
  return int(cudaGetLastError());
}

extern "C" int ljt_probe_aes_chain(const void* round_keys, void* blocks,
                                   void* cycles, int nr, int n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rk = static_cast<const uint8_t*>(round_keys);
  uint8_t* b = static_cast<uint8_t*>(blocks);
  long long* c = static_cast<long long*>(cycles);
  if (nr == 10) {
    aes_chain_kernel<10><<<1, 32, 0, s>>>(rk, b, c, n);
  } else if (nr == 14) {
    aes_chain_kernel<14><<<1, 32, 0, s>>>(rk, b, c, n);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" int ljt_probe_cluster(int cs, void* stream) {
  if (cs < 1 || cs > 16) return int(cudaErrorInvalidValue);
  if (cs > 8) {
    const int e = int(cudaFuncSetAttribute(
        cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1));
    if (e) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cs));
  cfg.blockDim = dim3(256);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int e = int(cudaLaunchKernelEx(&cfg, cluster_probe_kernel));
  if (e) return e;
  return int(cudaGetLastError());
}
