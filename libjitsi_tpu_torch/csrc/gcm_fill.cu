// Kernel O: the SRTP-GCM keystream cache's fill.  Each slot gets its
// packet's CTR keystream from inc32(J0) and its tag mask E(K, J0), under
// its stream's round keys, written straight into the cache's slot tables.
//
// Replaces: libjitsi_tpu/transform/srtp/keystream.py `_fill_dev` (:58),
// the XLA program that runs `aes_encrypt` over J0 and `ctr_keystream` over
// inc32(J0) for a padded chunk of 512 slots and scatters the rows into the
// tables (`.at[slot].set`), the round keys gathered into a [512, R, 16]
// tensor on the host first.  Here the kernel gathers the round keys from
// the table by stream row, takes any number of slots, and writes each
// block where it belongs.
//
// Bound on the H100: operations.  A 256-byte slot is 17 AES blocks (16 of
// keystream and J0's), some 4,500 instructions of the INT32 pipe in the
// T-table count, against 272 bytes written and ~220 read.  The port's
// gather-free core (`aes.cuh`) issues more a block; its own count (the
// `sass` phase's `gcm_ks_fill_core`) sets the floor this kernel is held
// to.
//
// Design: the cache fills whole windows, runs of consecutive slots of one
// stream, so the work is the AES pairs and little else:
//  - A tile is kFillSlots consecutive slots on a CTA of kFillThreads
//    threads; a launch keeps at most kFillCtasPerSm CTAs an SM, each
//    taking tiles blockIdx.x, blockIdx.x + gridDim.x, ... (no second
//    partial wave of small tiles).
//  - Set-up: thread k loads slot k's stream id (and slot k - 1's), its IV
//    and its table slot; a slot whose stream id differs from the slot
//    before it (or the tile's first) heads a run, and a warp vote gives
//    the tile's runs as a 64-bit mask.  Each run's round keys are loaded
//    and sliced once, a round key a task, into the run head's place:
//    a window's 64 slots take one schedule, not 64.  A run is detected,
//    never assumed: any order of stream ids gives runs of one or more.
//  - AES: a run's (slot, block) entries, nblocks + 1 a slot, are paired
//    in order, so both blocks of a pair are under the run's one schedule
//    and the core reads 8 key words a round, not 16 (a run of an odd
//    entry count encrypts its last entry twice and keeps one).  Pairs are
//    handed to the threads in turn, the first of them moved on a warp a
//    tile: a window's 544 pairs (256-byte slots) are 17 whole warp-passes.
//    Entry 0 of a slot is E(K, J0), entry k its keystream block k - 1 at
//    counter J0 + k; each is stored as one 16-byte vector.  Slots outside
//    the tables are skipped.

#include <cuda_runtime.h>

#include <cstdint>

#include "phases.cuh"
#include "srtp_tile.cuh"

namespace {

using namespace ljt_tile;

constexpr int kFillThreads = 128;
constexpr int kFillSlots = 64;       // slots a tile: one a thread of warps 0-1
constexpr int kFillCtasPerSm = 8;    // CTAs a launch keeps on an SM at most
constexpr int kFillKeyLoads = 8;     // round-key loads a thread keeps in flight

// The phase probe's stamps of a tile (kFillPhaseSlots words a tile): its
// start, set-up done, AES and stores done, its SM, the global timer (ns)
// at its start, its slots, its runs and its CTA; then for each warp w its
// first and its last pass's end at kFillPhaseWarp + 2w; then the clock
// after the run vote (kFillPhaseVote) and after thread 0's round keys
// (kFillPhaseVote + 1).
constexpr int kFillPhaseSlots = 24;
constexpr int kFillPhaseWarp = 8;
constexpr int kFillPhaseVote = 16;

// A tile's shared memory: each run's sliced schedule at its head slot,
// each slot's J0, stream id and table slot, and the run masks (heads;
// heads of runs of an odd entry count), two words each.
struct FillTile {
  uint32_t* rk;   // [kFillSlots][rk_stride]
  uint32_t* j0;   // [kFillSlots][4]
  int* sid;       // [kFillSlots]
  int* dst;       // [kFillSlots] table slot, -1 outside the tables
  unsigned* heads;
  unsigned* odd;
};

template <int NR>
__host__ __device__ constexpr int fill_smem_words() {
  return kFillSlots * (rk_stride(NR) + 4 + 2) + 4;
}

template <int NR>
__device__ __forceinline__ FillTile carve_fill(uint32_t* smem) {
  FillTile f;
  f.rk = smem;
  f.j0 = f.rk + kFillSlots * rk_stride(NR);
  f.sid = reinterpret_cast<int*>(f.j0 + 4 * kFillSlots);
  f.dst = f.sid + kFillSlots;
  f.heads = reinterpret_cast<unsigned*>(f.dst + kFillSlots);
  f.odd = f.heads + 2;
  return f;
}

// The next run head after slot h in the mask, or `rows`.
__device__ __forceinline__ int next_head(unsigned long long m, int h,
                                         int rows) {
  const unsigned long long up = h + 1 < 64 ? m >> (h + 1) : 0ull;
  return up ? h + __ffsll(static_cast<long long>(up)) : rows;
}

// The tile's first pair of the run headed by slot h: half the entries of
// the slots before it plus the odd runs before it.
__device__ __forceinline__ int run_pairs_before(unsigned long long odd, int h,
                                                int per) {
  const unsigned long long below = h < 64 ? (1ull << h) - 1 : ~0ull;
  return (h * per + __popcll(odd & below)) >> 1;
}

// The 16 bytes of block (slot k, entry j) to the tables, where the slot
// lies inside them.
__device__ __forceinline__ void fill_store(const FillTile& f, int k, int j,
                                           int per, const uint32_t c[4],
                                           uint4* ks4, uint4* ek4) {
  const int d = f.dst[k];
  if (d < 0) return;
  const uint4 v = make_uint4(ljt_bswap32(c[0]), ljt_bswap32(c[1]),
                             ljt_bswap32(c[2]), ljt_bswap32(c[3]));
  if (j == 0)
    ek4[d] = v;
  else
    ks4[size_t(d) * (per - 1) + j - 1] = v;
}

#define LJT_FILL_PARAMS                                                     \
  const uint8_t *__restrict__ tab_rk, int n_streams,                        \
      const int32_t *__restrict__ stream, const uint8_t *__restrict__ iv12, \
      const int32_t *__restrict__ slot, uint8_t *__restrict__ ks_tab,       \
      uint8_t *__restrict__ ek_tab, int n, int n_slots, int ks_bytes
#define LJT_FILL_ARGS                                                       \
  tab_rk, n_streams, stream, iv12, slot, ks_tab, ek_tab, n, n_slots, ks_bytes

template <int NR, bool Phases = false>
__device__ __forceinline__ void gcm_ks_fill_tiles(LJT_FILL_PARAMS,
                                                  long long* stamps = nullptr) {
  extern __shared__ uint4 smem[];
  const FillTile f = carve_fill<NR>(reinterpret_cast<uint32_t*>(smem));
  const int tiles = (n + kFillSlots - 1) / kFillSlots;
  const int per = ks_bytes / 16 + 1;
  const int k = threadIdx.x;
  const int warp = k >> 5;
  const bool key_vec = aligned(tab_rk, 16);
  const bool iv_words4 = aligned(iv12, 4);
  uint4* ks4 = reinterpret_cast<uint4*>(ks_tab);
  uint4* ek4 = reinterpret_cast<uint4*>(ek_tab);
  for (int tile = blockIdx.x, it = 0; tile < tiles;
       tile += gridDim.x, ++it) {
    long long* st = nullptr;
    if constexpr (Phases) {
      st = stamps + size_t(tile) * kFillPhaseSlots;
      if (k == 0) {
        st[0] = clock64();
        st[3] = phase_smid();
        st[4] = phase_globaltimer();
        st[7] = blockIdx.x;
      }
    }
    const int base = tile * kFillSlots;
    const int rows = n - base < kFillSlots ? n - base : kFillSlots;
    // slot k: its stream id (a run head where it differs from slot k -
    // 1's), J0 = IV || 1 and its table slot
    bool head = false;
    if (k < rows) {
      const int sid = ljt_clamp(stream[base + k], 0, n_streams - 1);
      head = k == 0 ||
             sid != ljt_clamp(stream[base + k - 1], 0, n_streams - 1);
      const uint8_t* p = iv12 + size_t(base + k) * 12;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        f.j0[4 * k + c] =
            iv_words4 ? ljt_bswap32(reinterpret_cast<const uint32_t*>(p)[c])
                      : ljt_load_be32(p + 4 * c);
      f.j0[4 * k + 3] = 1u;
      const int si = slot[base + k];
      f.dst[k] = si >= 0 && si < n_slots ? si : -1;
      f.sid[k] = sid;
    }
    if (k < kFillSlots) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, head);
      if ((k & 31) == 0) f.heads[warp] = m;
    }
    __syncthreads();
    if constexpr (Phases)
      if (k == 0) st[kFillPhaseVote] = clock64();
    const unsigned long long hm =
        f.heads[0] | (static_cast<unsigned long long>(f.heads[1]) << 32);
    if (k < kFillSlots) {
      const bool odd =
          head && ((next_head(hm, k, rows) - k) * per & 1) != 0;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, odd);
      if ((k & 31) == 0) f.odd[warp] = m;
    }
    // each run's round keys, a (head slot, round) task a thread, loads in
    // flight kFillKeyLoads at a time
    const int tasks = rows * (NR + 1);
    for (int q0 = k; q0 < tasks; q0 += kFillKeyLoads * kFillThreads) {
      uint4 kv[kFillKeyLoads];
#pragma unroll
      for (int u = 0; u < kFillKeyLoads; ++u) {
        const int q = q0 + u * kFillThreads;
        const int h = q / (NR + 1);
        if (q < tasks && (hm >> h & 1ull) && key_vec)
          kv[u] = reinterpret_cast<const uint4*>(
              tab_rk)[size_t(f.sid[h]) * (NR + 1) + q - h * (NR + 1)];
      }
#pragma unroll
      for (int u = 0; u < kFillKeyLoads; ++u) {
        const int q = q0 + u * kFillThreads;
        const int h = q / (NR + 1);
        if (q < tasks && (hm >> h & 1ull)) {
          const int round = q - h * (NR + 1);
          uint32_t w[4], o[8];
          if (key_vec) {
            w[0] = ljt_bswap32(kv[u].x);
            w[1] = ljt_bswap32(kv[u].y);
            w[2] = ljt_bswap32(kv[u].z);
            w[3] = ljt_bswap32(kv[u].w);
          } else {
            const uint8_t* key =
                tab_rk + (size_t(f.sid[h]) * (NR + 1) + round) * 16;
#pragma unroll
            for (int c = 0; c < 4; ++c) w[c] = ljt_load_be32(key + 4 * c);
          }
          ljt_aes_slice_keys(round, w, w, o);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            f.rk[h * rk_stride(NR) + 8 * round + c] = o[c];
        }
      }
    }
    if constexpr (Phases)
      if (k == 0) st[kFillPhaseVote + 1] = clock64();
    __syncthreads();
    const unsigned long long om =
        f.odd[0] | (static_cast<unsigned long long>(f.odd[1]) << 32);
    if constexpr (Phases) {
      if (k == 0) {
        st[1] = clock64();
        st[5] = rows;
        st[6] = __popcll(hm);
      }
    }
    // the pairs, run by run; thread k starts at pair (k + 32 it) mod
    // kFillThreads, so a tile's last partial pass moves along the warps
    const int pairs = (rows * per + __popcll(om)) >> 1;
    int h = 0, hn = next_head(hm, 0, rows);
    int lo = 0, hi = run_pairs_before(om, hn, per);
    for (int q = (k + 32 * it) % kFillThreads; q < pairs;
         q += kFillThreads) {
      while (q >= hi) {
        h = hn;
        hn = next_head(hm, h, rows);
        lo = hi;
        hi = run_pairs_before(om, hn, per);
      }
      const int ea = 2 * (q - lo);
      const bool two = ea + 1 < (hn - h) * per;
      const int eb = two ? ea + 1 : ea;
      const int ka = h + ea / per, ja = ea % per;
      const int kb = h + eb / per, jb = eb % per;
      uint32_t a[4], b[4], s[8];
      ljt_ctr_block(f.j0 + 4 * ka, uint32_t(ja), a);
      ljt_ctr_block(f.j0 + 4 * kb, uint32_t(jb), b);
      ljt_aes_encrypt_pair<NR>(LjtPairKeys{f.rk + h * rk_stride(NR)}, a, b,
                               s);
      fill_store(f, ka, ja, per, a, ks4, ek4);
      if (two) fill_store(f, kb, jb, per, b, ks4, ek4);
      if constexpr (Phases) {
        if ((k & 31) == 0) {
          const int w = kFillPhaseWarp + 2 * warp;
          if (q < kFillThreads) st[w] = clock64();
          st[w + 1] = clock64();
        }
      }
    }
    // the next tile reuses the shared memory (the probe stamps the end)
    if (Phases || tile + int(gridDim.x) < tiles) __syncthreads();
    if constexpr (Phases)
      if (k == 0) st[2] = clock64();
  }
}

template <int NR>
__global__ void __launch_bounds__(kFillThreads)
    gcm_ks_fill_kernel(LJT_FILL_PARAMS) {
  gcm_ks_fill_tiles<NR>(LJT_FILL_ARGS);
}

// The phase probe's instance of O: the same tiles with their clock64
// stamps; on no path.
__global__ void __launch_bounds__(kFillThreads)
    gcm_fill_phases_kernel(LJT_FILL_PARAMS, long long* stamps) {
  gcm_ks_fill_tiles<10, true>(LJT_FILL_ARGS, stamps);
}

// One launch of O (or of its phase probe, which also writes each tile's
// stamps and the plan: slots a tile, dynamic shared memory, CTAs, tiles).
template <bool Phases>
int launch_fill(const void* tab_rk, int n_streams, const void* stream,
                const void* iv12, const void* slot, void* ks_tab,
                void* ek_tab, int n, int n_slots, int ks_bytes, int nr,
                void* cuda_stream, long long* stamps = nullptr,
                int* plan_out = nullptr) {
  if (n <= 0) return 0;
  if (nr != 10 || n_streams <= 0 || ks_bytes <= 0 ||
      ks_bytes % 16 || (reinterpret_cast<uintptr_t>(ks_tab) & 15) ||
      (reinterpret_cast<uintptr_t>(ek_tab) & 15))
    return int(cudaErrorInvalidValue);
  const int smem = 4 * fill_smem_words<10>();
  const int tiles = (n + kFillSlots - 1) / kFillSlots;
  const int sms = multiprocessors();
  const int most = kFillCtasPerSm * (sms > 0 ? sms : 1);
  const int grid = tiles < most ? tiles : most;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const auto* rk = static_cast<const uint8_t*>(tab_rk);
  const auto* st = static_cast<const int32_t*>(stream);
  const auto* iv = static_cast<const uint8_t*>(iv12);
  const auto* sl = static_cast<const int32_t*>(slot);
  auto* ks = static_cast<uint8_t*>(ks_tab);
  auto* ek = static_cast<uint8_t*>(ek_tab);
  if constexpr (Phases) {
    plan_out[0] = kFillSlots;
    plan_out[1] = smem;
    plan_out[2] = grid;
    plan_out[3] = tiles;
    gcm_fill_phases_kernel<<<grid, kFillThreads, smem, s>>>(
        rk, n_streams, st, iv, sl, ks, ek, n, n_slots, ks_bytes, stamps);
  } else {
    gcm_ks_fill_kernel<10><<<grid, kFillThreads, smem, s>>>(
        rk, n_streams, st, iv, sl, ks, ek, n, n_slots, ks_bytes);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ljt_gcm_ks_fill(const void* tab_rk, int n_streams,
                               const void* stream, const void* iv12,
                               const void* slot, void* ks_tab, void* ek_tab,
                               int n, int n_slots, int ks_bytes, int nr,
                               void* cuda_stream) {
  return launch_fill<false>(tab_rk, n_streams, stream, iv12, slot, ks_tab,
                            ek_tab, n, n_slots, ks_bytes, nr, cuda_stream);
}

// The phase probe: O as `ljt_gcm_ks_fill` launches it, each tile writing
// its kFillPhaseSlots clock64 stamps to stamps [tiles * kFillPhaseSlots]
// (tile i at i * kFillPhaseSlots) and the plan (slots a tile, dynamic
// shared memory bytes, CTAs, tiles) to plan_out [4].
extern "C" int ljt_gcm_ks_fill_phases(const void* tab_rk, int n_streams,
                                      const void* stream, const void* iv12,
                                      const void* slot, void* ks_tab,
                                      void* ek_tab, void* stamps,
                                      void* plan_out, int n, int n_slots,
                                      int ks_bytes, void* cuda_stream) {
  if (stamps == nullptr || plan_out == nullptr)
    return int(cudaErrorInvalidValue);
  return launch_fill<true>(tab_rk, n_streams, stream, iv12, slot, ks_tab,
                           ek_tab, n, n_slots, ks_bytes, 10, cuda_stream,
                           static_cast<long long*>(stamps),
                           static_cast<int*>(plan_out));
}
