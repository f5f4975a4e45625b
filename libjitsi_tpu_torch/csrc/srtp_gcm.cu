// Kernels M and N: batched AEAD_AES_128_GCM seal and open (RFC 7714) of
// SRTP and SRTCP rows, each row under its table row's round keys and
// packed GHASH matrix; and their cached instances, which take the CTR
// keystream and the tag mask from the keystream cache's slot tables and
// run no AES.
//
// Replaces: libjitsi_tpu/kernels/gcm.py `gcm_protect` / `gcm_unprotect`
// (:156, :182), `gcm_protect_grouped` / `gcm_unprotect_grouped` (:238,
// :260), `gcm_protect_cached` / `gcm_unprotect_cached` (:318, :340) and
// their grouped forms (:378, :396), with the table gather of
// libjitsi_tpu/transform/srtp/context.py (`_protect_gcm_dev`,
// `_unprotect_gcm_impl`, `_gcm_rtp_protect_cached`, ...): XLA programs
// that run the AES kernel for the keystream and E(K, J0), build each row's
// GHASH input at the padded width and step the int8 GHASH matmul over it.
// Here one kernel does a row's CTR, E(K, J0), GHASH over its real blocks
// and the tag, reading the row's keys and matrix from the tables by
// stream id (`stream`), so no per-row key or matrix tensor exists.
//
// Bound on the H100: operations.  A 100-byte payload behind a 12-byte
// header is 7 AES blocks with J0's and 9 GHASH steps (a 128 x 128 GF(2)
// product each), against ~250 bytes moved.
//
// Design: the GCM tile (`gcm_tile.cuh`) over the SRTP tile
// (`srtp_tile.cuh`): 256 threads, at most 32 rows, the AES core over the
// flattened (row, block) entries, a warp a row for the Horner chain
// (`ghash.cuh`, the matrix in the warp's registers, each row's GHASH input
// staged once as aligned blocks so a step is one broadcast shared load
// and the step), rows handed to warps as they come free.  Seal encrypts
// in place and hashes each row as soon as its ciphertext is whole; open
// decrypts into the tile's second copy while the hash reads the first
// (on warps of their own where a tile has at most 256 entries), so the
// decrypt always runs and the caller masks rows that fail.  Tiles are
// sized for two an SM (`kGcmTilesPerSm`): on an H100 one, three and four
// read slower over the mix batch's launches (PERF.md §6).
//
// Instances (each its own kernel name and launch count):
// `srtp_gcm_seal` (M), `srtp_gcm_open` (N), `srtp_gcm_seal_cached`,
// `srtp_gcm_open_cached`.
//
// Semantics (held byte for byte against `kernels/gcm.py` through the
// wrappers in `transform/srtp/kernel.py`): stream ids clamped into the
// table, cache slots into the slot tables; lengths clamped to the row,
// the AAD to the clamped length (or to it less the tag on open); the
// cached instances XOR a row's slot bytes over at most ks_bytes of its
// ciphertext.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gcm_tile.cuh"

namespace {

using namespace ljt_tile;
using namespace ljt_gcm;

// M's and N's rows: staged from the tile's first row on, keys and matrix
// by stream id, AAD per row, IV per row (iv12, none for the cached
// instances), cache slot per row (cached instances).
template <bool Open>
struct GcmRows {
  const int32_t* stream;
  int n_streams;
  const uint8_t* data;
  const int32_t* length;
  const int32_t* aad_len;
  const uint8_t* iv12;
  const int32_t* slots;
  int width;

  struct Lead {};
  struct Regs {
    int len, aad;
    uint32_t iv0, iv1, iv2;
  };
  __device__ __forceinline__ int key_row(int row) const {
    return ljt_clamp(stream[row], 0, n_streams - 1);
  }
  __device__ __forceinline__ TileRows staged(int base) const {
    return TileRows{data + size_t(base) * width};
  }
  __device__ __forceinline__ Lead lead(int) const { return {}; }
  __device__ __forceinline__ Regs load(int row, const Lead&) const {
    Regs g{length[row], aad_len[row], 0u, 0u, 0u};
    if (iv12) {
      const uint8_t* p = iv12 + size_t(row) * 12;
      g.iv0 = ljt_load_be32(p);
      g.iv1 = ljt_load_be32(p + 4);
      g.iv2 = ljt_load_be32(p + 8);
    }
    return g;
  }
  __device__ __forceinline__ int len(const Regs& g) const { return g.len; }
  __device__ __forceinline__ int slot(int row) const { return slots[row]; }
  __device__ __forceinline__ void window(const Regs& g, int, int w, int& off,
                                         int& end, uint32_t ivw[4]) const {
    gcm_window(g.len, g.aad, w, Open, off, end);
    ivw[0] = g.iv0;
    ivw[1] = g.iv1;
    ivw[2] = g.iv2;
    ivw[3] = 1u;   // J0 = IV || 0x00000001
  }
};

#define LJT_GCM_PARAMS                                                      \
  const uint8_t *__restrict__ tab_rk, const uint4 *__restrict__ tab_gm,     \
      const int32_t *__restrict__ stream, int n_streams,                    \
      const uint8_t *__restrict__ data, const int32_t *__restrict__ length, \
      const int32_t *__restrict__ aad_len,                                  \
      const uint8_t *__restrict__ iv12, const int32_t *__restrict__ slots,  \
      const uint8_t *__restrict__ ks_tab,                                   \
      const uint8_t *__restrict__ ek_tab, int n_slots, int ks_bytes,        \
      uint8_t *__restrict__ out, int32_t *__restrict__ out_len,             \
      bool *__restrict__ auth_ok, int n, int width, int tile_rows

#define LJT_GCM_ARGS                                                        \
  tab_rk, tab_gm, stream, n_streams, data, length, aad_len, iv12, slots,    \
      ks_tab, ek_tab, n_slots, ks_bytes, out, out_len, auth_ok, n, width,   \
      tile_rows

template <int NR, bool Open, bool Cached, bool Phases = false>
__device__ __forceinline__ void srtp_gcm_body(uint32_t* smem,
                                              LJT_GCM_PARAMS,
                                              long long* stamps = nullptr) {
  const GcmRows<Open> rows{stream, n_streams, data, length, aad_len,
                           iv12,   slots,     width};
  if constexpr (Cached)
    gcm_tile<NR, Open, true, NullRows<GcmRows<Open>>, Phases>(
        smem, nullptr, tab_gm, NullRows<GcmRows<Open>>{rows}, ks_tab, ek_tab,
        n_slots, ks_bytes, out, out_len, auth_ok, n, width, tile_rows,
        stamps);
  else
    gcm_tile<NR, Open, false, GcmRows<Open>, Phases>(
        smem, tab_rk, tab_gm, rows, nullptr, nullptr, 0, 0, out, out_len,
        auth_ok, n, width, tile_rows, stamps);
}

// The four instances, each a kernel of its own name.
template <int NR>
__global__ void __launch_bounds__(kGcmThreads)
    srtp_gcm_seal_kernel(LJT_GCM_PARAMS) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<NR, false, false>(reinterpret_cast<uint32_t*>(smem),
                                  LJT_GCM_ARGS);
}

template <int NR>
__global__ void __launch_bounds__(kGcmThreads)
    srtp_gcm_open_kernel(LJT_GCM_PARAMS) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<NR, true, false>(reinterpret_cast<uint32_t*>(smem),
                                 LJT_GCM_ARGS);
}

__global__ void __launch_bounds__(kGcmThreads)
    srtp_gcm_seal_cached_kernel(LJT_GCM_PARAMS) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<10, false, true>(reinterpret_cast<uint32_t*>(smem),
                                 LJT_GCM_ARGS);
}

__global__ void __launch_bounds__(kGcmThreads)
    srtp_gcm_open_cached_kernel(LJT_GCM_PARAMS) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<10, true, true>(reinterpret_cast<uint32_t*>(smem),
                                LJT_GCM_ARGS);
}

// The phase probe's instances of M and N: the same tile with its clock64
// stamps (`gcm_tile.cuh`, kPhaseSlots a tile); on no path.
__global__ void __launch_bounds__(kGcmThreads)
    gcm_phases_seal_kernel(LJT_GCM_PARAMS, long long* stamps) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<10, false, false, true>(reinterpret_cast<uint32_t*>(smem),
                                        LJT_GCM_ARGS, stamps);
}

__global__ void __launch_bounds__(kGcmThreads)
    gcm_phases_open_kernel(LJT_GCM_PARAMS, long long* stamps) {
  extern __shared__ uint4 smem[];
  srtp_gcm_body<10, true, false, true>(reinterpret_cast<uint32_t*>(smem),
                                       LJT_GCM_ARGS, stamps);
}

// The instance: AES-128 only (the SRTP profiles have no AES-256 GCM
// suite); the cached instances run no AES (their tiles are planned as for
// nr = 10, without keys).
template <bool Open, bool Cached, bool Phases = false>
auto gcm_kernel() {
  if constexpr (Phases)
    return Open ? gcm_phases_open_kernel : gcm_phases_seal_kernel;
  else if constexpr (Cached)
    return Open ? srtp_gcm_open_cached_kernel : srtp_gcm_seal_cached_kernel;
  else if constexpr (Open)
    return srtp_gcm_open_kernel<10>;
  else
    return srtp_gcm_seal_kernel<10>;
}

#define LJT_GCM_CAST_ARGS                                                  \
  static_cast<const uint8_t*>(tab_rk), static_cast<const uint4*>(tab_gm),  \
      static_cast<const int32_t*>(stream), n_streams,                      \
      static_cast<const uint8_t*>(data),                                   \
      static_cast<const int32_t*>(length),                                 \
      static_cast<const int32_t*>(aad_len),                                \
      static_cast<const uint8_t*>(iv12),                                   \
      static_cast<const int32_t*>(slots),                                  \
      static_cast<const uint8_t*>(ks_tab),                                 \
      static_cast<const uint8_t*>(ek_tab), n_slots, ks_bytes,              \
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_len),          \
      static_cast<bool*>(auth_ok), n, width, p.rows

// One launch of an instance; cached instances take no round keys and no
// IVs.  The phase probe (Phases) also takes the stamps, may plan for
// `per_sm` tiles an SM in place of kGcmTilesPerSm, and writes the plan
// (rows a tile, dynamic shared memory, tiles) to plan_out.
template <bool Open, bool Cached, bool Phases = false>
int launch_gcm(const void* tab_rk, const void* tab_gm, const void* stream,
               int n_streams, const void* data, const void* length,
               const void* aad_len, const void* iv12, const void* slots,
               const void* ks_tab, const void* ek_tab, int n_slots,
               int ks_bytes, void* out, void* out_len, void* auth_ok, int n,
               int width, int nr, void* cuda_stream,
               long long* stamps = nullptr, int* plan_out = nullptr,
               int per_sm = 0) {
  if (n <= 0) return 0;
  if (nr != 10 || n_streams <= 0 || tab_gm == nullptr ||
      (reinterpret_cast<uintptr_t>(tab_gm) & 15) ||
      (Cached && (n_slots <= 0 || ks_bytes <= 0 || ks_bytes % 16)))
    return int(cudaErrorInvalidValue);
  static std::atomic<unsigned> done;
  auto kernel = gcm_kernel<Open, Cached, Phases>();
  Plan p;
  const int rc = plan(kernel, done, n, width, nr,
                      Open ? kSecondCopy : kInPlace,
                      per_sm > 0 ? per_sm : kGcmTilesPerSm, &p,
                      Cached ? 0 : 1, gcm_row_words(width));
  if (rc) return rc;
  if constexpr (Phases) {
    plan_out[0] = p.rows;
    plan_out[1] = p.smem;
    plan_out[2] = p.grid;
    kernel<<<p.grid, kGcmThreads, p.smem,
             static_cast<cudaStream_t>(cuda_stream)>>>(LJT_GCM_CAST_ARGS,
                                                       stamps);
  } else {
    kernel<<<p.grid, kGcmThreads, p.smem,
             static_cast<cudaStream_t>(cuda_stream)>>>(LJT_GCM_CAST_ARGS);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_srtp_gcm_seal(const void* tab_rk, const void* tab_gm,
                                 const void* stream, int n_streams,
                                 const void* data, const void* length,
                                 const void* aad_len, const void* iv12,
                                 void* out, void* out_len, int n, int width,
                                 int nr, void* cuda_stream) {
  if (iv12 == nullptr) return int(cudaErrorInvalidValue);
  return launch_gcm<false, false>(tab_rk, tab_gm, stream, n_streams, data,
                                  length, aad_len, iv12, nullptr, nullptr,
                                  nullptr, 0, 0, out, out_len, nullptr, n,
                                  width, nr, cuda_stream);
}

extern "C" int ljt_srtp_gcm_open(const void* tab_rk, const void* tab_gm,
                                 const void* stream, int n_streams,
                                 const void* data, const void* length,
                                 const void* aad_len, const void* iv12,
                                 void* out, void* mlen, void* auth_ok, int n,
                                 int width, int nr, void* cuda_stream) {
  if (iv12 == nullptr) return int(cudaErrorInvalidValue);
  return launch_gcm<true, false>(tab_rk, tab_gm, stream, n_streams, data,
                                 length, aad_len, iv12, nullptr, nullptr,
                                 nullptr, 0, 0, out, mlen, auth_ok, n, width,
                                 nr, cuda_stream);
}

extern "C" int ljt_srtp_gcm_seal_cached(
    const void* ks_tab, const void* ek_tab, const void* slot, int n_slots,
    int ks_bytes, const void* tab_gm, const void* stream, int n_streams,
    const void* data, const void* length, const void* aad_len, void* out,
    void* out_len, int n, int width, void* cuda_stream) {
  return launch_gcm<false, true>(nullptr, tab_gm, stream, n_streams, data,
                                 length, aad_len, nullptr, slot, ks_tab,
                                 ek_tab, n_slots, ks_bytes, out, out_len,
                                 nullptr, n, width, 10, cuda_stream);
}

extern "C" int ljt_srtp_gcm_open_cached(
    const void* ks_tab, const void* ek_tab, const void* slot, int n_slots,
    int ks_bytes, const void* tab_gm, const void* stream, int n_streams,
    const void* data, const void* length, const void* aad_len, void* out,
    void* mlen, void* auth_ok, int n, int width, void* cuda_stream) {
  return launch_gcm<true, true>(nullptr, tab_gm, stream, n_streams, data,
                                length, aad_len, nullptr, slot, ks_tab,
                                ek_tab, n_slots, ks_bytes, out, mlen,
                                auth_ok, n, width, 10, cuda_stream);
}

// The phase probe: M (open = 0) or N (open = 1) as `ljt_srtp_gcm_seal` /
// `_open` launch them (planned for `per_sm` tiles an SM, or as they are
// when 0), each tile writing its kPhaseSlots clock64 stamps to stamps
// [n * kPhaseSlots] (tile i at i * kPhaseSlots) and the launch's plan
// (rows a tile, dynamic shared memory bytes, tiles) to plan_out [3].
extern "C" int ljt_srtp_gcm_phases(const void* tab_rk, const void* tab_gm,
                                   const void* stream, int n_streams,
                                   const void* data, const void* length,
                                   const void* aad_len, const void* iv12,
                                   void* out, void* out_len, void* auth_ok,
                                   void* stamps, void* plan_out, int n,
                                   int width, int open, int per_sm,
                                   void* cuda_stream) {
  if (iv12 == nullptr || stamps == nullptr || plan_out == nullptr)
    return int(cudaErrorInvalidValue);
  auto* st = static_cast<long long*>(stamps);
  auto* po = static_cast<int*>(plan_out);
  return open ? launch_gcm<true, false, true>(
                    tab_rk, tab_gm, stream, n_streams, data, length, aad_len,
                    iv12, nullptr, nullptr, nullptr, 0, 0, out, out_len,
                    auth_ok, n, width, 10, cuda_stream, st, po, per_sm)
              : launch_gcm<false, false, true>(
                    tab_rk, tab_gm, stream, n_streams, data, length, aad_len,
                    iv12, nullptr, nullptr, nullptr, 0, 0, out, out_len,
                    nullptr, n, width, 10, cuda_stream, st, po, per_sm);
}
