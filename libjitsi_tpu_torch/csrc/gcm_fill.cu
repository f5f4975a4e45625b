// Kernel O: the SRTP-GCM keystream cache's fill.  Each slot gets its
// packet's CTR keystream from inc32(J0) and its tag mask E(K, J0), under
// its stream's round keys, written straight into the cache's slot tables.
//
// Replaces: libjitsi_tpu/transform/srtp/keystream.py `_fill_dev` (:58),
// the XLA program that runs `aes_encrypt` over J0 and `ctr_keystream` over
// inc32(J0) for a padded chunk of 512 slots and scatters the rows into the
// tables (`.at[slot].set`), the round keys gathered into a [512, R, 16]
// tensor on the host first.  Here the kernel gathers each slot's round
// keys from the table by its stream row, takes any number of slots, and
// writes each block where it belongs.
//
// Bound on the H100: operations.  A 256-byte slot is 17 AES blocks (16 of
// keystream and J0's), some 4,500 instructions of the INT32 pipe in the
// T-table count, against 272 bytes written and ~220 read.
//
// Design: the SRTP tile's set-up (`srtp_tile.cuh`): a CTA of 128 threads
// takes up to 32 slots, four threads slice each slot's round keys into
// shared memory, one thread builds its J0 from the 12-byte IV; then the
// (slot, block) entries, nblocks + 1 a slot, are handed out two a thread
// to the gather-free AES core (`aes.cuh`), entry 0 a slot's E(K, J0) and
// entry k its keystream block k - 1 at counter J0 + k.  Each block is
// stored as one 16-byte vector.  Slots outside the tables are skipped.

#include <cuda_runtime.h>

#include <cstdint>

#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

template <int NR>
__global__ void __launch_bounds__(kThreads) gcm_ks_fill_kernel(
    const uint8_t* __restrict__ tab_rk, int n_streams,
    const int32_t* __restrict__ stream, const uint8_t* __restrict__ iv12,
    const int32_t* __restrict__ slot, uint8_t* __restrict__ ks_tab,
    uint8_t* __restrict__ ek_tab, int n, int n_slots, int ks_bytes,
    int tile_rows) {
  extern __shared__ uint4 smem[];
  uint32_t* rk = reinterpret_cast<uint32_t*>(smem);  // [rows][rk_stride]
  uint32_t* j0 = rk + tile_rows * rk_stride(NR);     // [rows][4]
  int* sl = reinterpret_cast<int*>(j0 + 4 * tile_rows);
  const int base = blockIdx.x * tile_rows;
  const int rows = n - base < tile_rows ? n - base : tile_rows;
  constexpr int kKeyLoads = (NR + 4) / 4;
  const int kr = threadIdx.x >> 2;
  const bool key_vec = aligned(tab_rk, 16);
  uint4 kv[kKeyLoads];
  const uint8_t* key = nullptr;
  if (kr < rows) {
    key = tab_rk +
          size_t(ljt_clamp(stream[base + kr], 0, n_streams - 1)) * (NR + 1) *
              16;
#pragma unroll
    for (int u = 0; u < kKeyLoads; ++u) {
      const int q = (threadIdx.x & 3) + 4 * u;
      if (key_vec && q <= NR) kv[u] = reinterpret_cast<const uint4*>(key)[q];
    }
  }
  if (int(threadIdx.x) < rows) {
    const int r = threadIdx.x;
    const uint8_t* p = iv12 + size_t(base + r) * 12;
    j0[4 * r] = ljt_load_be32(p);
    j0[4 * r + 1] = ljt_load_be32(p + 4);
    j0[4 * r + 2] = ljt_load_be32(p + 8);
    j0[4 * r + 3] = 1u;
    const int si = slot[base + r];
    sl[r] = si >= 0 && si < n_slots ? si : -1;
  }
  if (kr < rows) slice_row_keys<NR>(rk + kr * rk_stride(NR), kv, key, key_vec);
  __syncthreads();
  const int per = ks_bytes / 16 + 1;
  const int total = rows * per;
  uint4* ks4 = reinterpret_cast<uint4*>(ks_tab);
  uint4* ek4 = reinterpret_cast<uint4*>(ek_tab);
  for (int f = 2 * int(threadIdx.x); f < total; f += 2 * int(blockDim.x)) {
    const bool two = f + 1 < total;
    const int ra = f / per, ja = f - ra * per;
    const int g = two ? f + 1 : f;
    const int rb = g / per, jb = g - rb * per;
    uint32_t a[4], b[4], s[8];
    ljt_ctr_block(j0 + 4 * ra, uint32_t(ja), a);
    ljt_ctr_block(j0 + 4 * rb, uint32_t(jb), b);
    ljt_aes_encrypt_pair<NR>(
        LjtSlicedKeys{rk + ra * rk_stride(NR), rk + rb * rk_stride(NR)}, a,
        b, s);
    if (sl[ra] >= 0) {
      const uint4 v = make_uint4(ljt_bswap32(a[0]), ljt_bswap32(a[1]),
                                 ljt_bswap32(a[2]), ljt_bswap32(a[3]));
      if (ja == 0)
        ek4[sl[ra]] = v;
      else
        ks4[size_t(sl[ra]) * (per - 1) + ja - 1] = v;
    }
    if (two && sl[rb] >= 0) {
      const uint4 v = make_uint4(ljt_bswap32(b[0]), ljt_bswap32(b[1]),
                                 ljt_bswap32(b[2]), ljt_bswap32(b[3]));
      if (jb == 0)
        ek4[sl[rb]] = v;
      else
        ks4[size_t(sl[rb]) * (per - 1) + jb - 1] = v;
    }
  }
}

}  // namespace

extern "C" int ljt_gcm_ks_fill(const void* tab_rk, int n_streams,
                               const void* stream, const void* iv12,
                               const void* slot, void* ks_tab, void* ek_tab,
                               int n, int n_slots, int ks_bytes, int nr,
                               void* cuda_stream) {
  if (n <= 0) return 0;
  if (nr != 10 || n_streams <= 0 || ks_bytes <= 0 ||
      ks_bytes % 16 || (reinterpret_cast<uintptr_t>(ks_tab) & 15) ||
      (reinterpret_cast<uintptr_t>(ek_tab) & 15))
    return int(cudaErrorInvalidValue);
  const int rows = kTileRows;
  const int smem = 4 * rows * (rk_stride(nr) + 5);
  const int grid = (n + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* rk = static_cast<const uint8_t*>(tab_rk);
  const auto* st = static_cast<const int32_t*>(stream);
  const auto* iv = static_cast<const uint8_t*>(iv12);
  const auto* sl = static_cast<const int32_t*>(slot);
  auto* ks = static_cast<uint8_t*>(ks_tab);
  auto* ek = static_cast<uint8_t*>(ek_tab);
  gcm_ks_fill_kernel<10><<<grid, kThreads, smem, s>>>(
      rk, n_streams, st, iv, sl, ks, ek, n, n_slots, ks_bytes, rows);
  return int(cudaGetLastError());
}
