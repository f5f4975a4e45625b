// Kernel E: fused mix-minus + RFC 6465 audio levels for C conferences.
//
// Replaces: libjitsi_tpu/kernels/pallas_ops.py `mix_minus_pallas` (the
// Pallas TPU kernel, body `_mix_kernel`) and its XLA twin
// libjitsi_tpu/conference/mixer.py `mix_minus_many`.
// pcm [C, N, F] i16 and active [C, N] u8 (0/1) give
//   out[c, i, f]  = clip(sum_{j active} pcm[c, j, f] - contrib[c, i, f])
//                   where contrib = active ? pcm : 0, as i16
//                   (an inactive row hears the full mix);
//   levels[c, i]  = RFC 6465 dBov of pcm[c, i, :] (not of contrib):
//                   ms = mean((pcm / 32768)^2),
//                   clip(rint(-10 log10(max(ms, 1e-12))), 0, 127),
//                   127 where ms <= 1e-12 or the row is inactive.
// The sum of squares is an exact 64-bit integer S, and
// ms = float(S) / F * 2^-30 in float32, so a split of the row over
// threads, blocks and stages cannot change a level.  Up to 65,535 rows
// the column sums are exact in 32 bits; beyond, their totals are kept in
// 64 bits (a column of 65,539 rows at 32,767 passes 2^31 - 1), so the mix
// is the exact clip at any N.
//
// Bound on the H100: bytes.  The function reads each sample once and
// writes it once (4 bytes a sample) with a few integer adds beside it:
// 15.7 MB, 4.7 us at [64, 64, 960].  At the conference bridge's
// [1, 256, 160] the bytes take 0.05 us; there the launch (0.87 us for
// an empty kernel, `chip_smoke.py`'s latency_floor phase), one round
// trip to memory and the exchange inside the cluster are the floor.
//
// Design: one thread block cluster per conference, split by columns.
//   - A block owns a range of 8-sample column vectors of every row and
//     stages it once in shared memory: 16-byte cp.async copies, all
//     issued before the first use, when F % 8 == 0 and pcm and out are
//     16-byte aligned; 2-byte loads otherwise (ragged F, a view at an odd
//     offset), padded with zeros.  A staged row is an odd number of
//     vectors long, so the rows' vectors fall in different banks.
//     Everything below reads that one copy: device memory sees each
//     sample read once and written once.
//   - The block's column sums need no other block: row groups of threads
//     (at most 16) sum the active rows, then one thread a column pair
//     adds the groups in order.  So the block writes out = clip(total -
//     contrib) without waiting on its peers: a thread keeps one column
//     vector's totals in registers and stores 16 bytes a row down it.
//   - A level needs the whole row.  Each block takes its columns' part
//     of every row's sum of squares (lanes of a row, warp shuffles) and
//     pushes it into the shared memory of the row's owner (rank row %
//     cluster), at the slot of its own rank, with st.async: the store
//     counts its bytes off the owner's mbarrier (csrc/dsmem.cuh).  The
//     owner's last threads wait on that mbarrier while its first ones
//     add the column groups, and add the ranks' parts in rank order.  No
//     atomics, no cluster barrier on the path after the start, and the
//     result does not depend on block order.  A relaxed cluster arrive
//     after the mbarrier's init, waited on before the first push, makes
//     sure every peer is running and ready.
//     (The first designs split the conference by rows, whose column
//     partials crossed the cluster before any output behind two cluster
//     barriers of ~900-1,000 cycles each; then by columns behind one
//     split barrier, whose release arrive waited for the pushed stores
//     to land.  PERF.md has their times.)
//   - Launch size (`make_plan`): enough blocks for two a streaming
//     multiprocessor, at most 8 a cluster (16, Hopper's non-portable
//     limit, while C * 8 < SMs), at most one a column vector: clusters of
//     16 at [1, 256, 160] (1 or 2 vectors each) and [1, 256, 960], 64
//     clusters of 5 at [64, 64, 960] (24 vectors each).  A cluster lives
//     in one GPC, so one conference moves its bytes through 16 SMs.
//     A frame too wide for one row of a block's columns to fit its
//     96 KB takes more blocks, up to the cluster limit: frames of up to
//     78,528 samples fit a cluster of 8, 157,056 one of 16.
//   - Rows that do not fit the 96 KB a block stages are taken in stages,
//     with a cluster barrier a stage; the mix then needs the totals of
//     every stage first, so those conferences read their samples twice.
//   - What one pass of that kernel does not take runs
//     `mix_minus_staged_kernel`: a conference of more than 65,535 rows
//     (its column totals in 64 bits), and a frame too wide for one row of
//     a block's columns to fit its 96 KB at the widest cluster (over
//     78,528 samples, 157,056 where C * 8 < SMs).  There a block takes its
//     columns in stages of at most `pitch` columns, as rows take stages:
//     each row's sum of squares is added up over the column stages in the
//     block's shared memory and pushed to the row's owner once, after the
//     last.  A tall conference of narrow frames, whose columns leave
//     blocks of the cluster free, also splits its rows into groups, one
//     a block across its columns (16 groups of 4,096-4,097 rows at
//     [1, 65,540, 8] on the H100): each group adds its rows' column
//     totals, takes its rows' levels (in place where a block holds whole
//     rows), and reads its column peers' totals over DSMEM behind one
//     cluster barrier.  The staged kernel may hold 227 KB, one block a
//     SM.  Where every row of a group fits one stage of rows, its mix is
//     written from the staged rows (the samples are read once);
//     otherwise a second pass takes each column stage's totals over
//     every stage of rows (unless the first took them) and then writes
//     its rows again.
//     `mix_minus_kernel` stays as it was for every shape it took, so the
//     paths' launches do not move.
//   - Above 48 KB of dynamic shared memory the launch first raises the
//     kernel's limit (cudaFuncSetAttribute).

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

#include "dsmem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;            // non-portable, Hopper's limit
constexpr int kMaxRows = 65535;            // exact int32 column sums
constexpr int kSmemBudget = 96 * 1024;     // two blocks a SM at the most
constexpr int kStagedBudget = 232448;      // the staged kernel: one a SM
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxColumnGroups = 16;       // rows a thread vs. adds after
constexpr int kStagedColumnGroups = 64;    // the same for thousands of rows
constexpr int kStageRows = 64;             // rows a column stage aims to hold

// A launch's shape, chosen on the host from (C, N, F) and the pointers.
struct Plan {
  int cluster;   // blocks of a conference (one cluster)
  int pitch;     // staged row length: the block's most vectors x 8, made
                 // an odd number of vectors (rows apart in all banks)
  int srows;     // rows staged at a time: N, unless they do not fit
  int vec;       // 1: 16-byte copies and stores; 0: 2-byte ones
  int smem;      // dynamic shared memory of a block, bytes
  int cstages;   // column stages of the widest block (1: none)
  int staged;    // 1: mix_minus_staged_kernel, 0: mix_minus_kernel
  int rsplit;    // row groups of the cluster (staged kernel; 1: none)
};

__host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ int imin(int a, int b) { return a < b ? a : b; }

// Rows a block owns in a stage of `srows` rows.
__host__ __device__ int owned(int srows, int cs) {
  return (srows + cs - 1) / cs;
}

// Shared memory of a block, in this order: slab int16 [srows, pitch],
// level slots u64 [cluster, owned], column-group partials int2
// [max(threads, pitch / 2)], totals int32 [pitch], active masks u32
// [srows], the slots' mbarrier.
int smem_bytes(int cs, int pitch, int srows) {
  return 2 * srows * pitch + round_up(8 * cs * owned(srows, cs), 16)
         + 8 * imax(kThreads, pitch / 2) + 4 * pitch + 4 * round_up(srows, 4)
         + 16;
}

// The same for mix_minus_staged_kernel: slab, level slots, row sums of
// squares u64 [srows], column-group partials, totals int64 [pitch] and
// their clipped int32 copy [pitch], active masks, the mbarrier.
int staged_smem_bytes(int cs, int pitch, int srows) {
  return 2 * srows * pitch + round_up(8 * cs * owned(srows, cs), 16)
         + round_up(8 * srows, 16) + 8 * imax(kThreads, pitch / 2)
         + 12 * pitch + 4 * round_up(srows, 4) + 16;
}

// Rows a block can stage at a time with `pitch` staged columns, within
// the budget (smem_bytes or staged_smem_bytes).
int rows_fit(bool staged, int cs, int pitch) {
  const int fixed = staged ? 8 * cs + 8 * imax(kThreads, pitch / 2)
                                 + 12 * pitch + 48
                           : 8 * cs + 8 * imax(kThreads, pitch / 2)
                                 + 4 * pitch + 48;
  return ((staged ? kStagedBudget : kSmemBudget) - fixed)
         / (2 * pitch + (staged ? 20 : 12));
}

void make_plan(const void* pcm, const void* out, int c, int n, int f,
               int sms, Plan* p) {
  const bool aligned = (reinterpret_cast<uintptr_t>(pcm) % 16 == 0)
                       && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  p->vec = (f % 8 == 0) && aligned;
  p->staged = n > kMaxRows;
  p->cstages = 1;
  p->rsplit = 1;
  const int nv = (f + 7) / 8;
  const int want = (2 * sms + c - 1) / c;
  const int most = c * kPortableCluster < sms ? kMaxCluster : kPortableCluster;
  // more blocks while one row of a block's columns does not fit
  for (p->cluster = imax(1, imin(imin(want, most), nv));; ++p->cluster) {
    p->pitch = ((nv + p->cluster - 1) / p->cluster | 1) * 8;
    p->srows = imin(n, rows_fit(p->staged, p->cluster, p->pitch));
    if (p->srows >= 1) break;
    if (p->cluster >= imin(most, nv)) {
      // too wide for the widest cluster: the block's columns in stages,
      // the widest (an odd number of vectors) that holds min(n,
      // kStageRows) rows, evened out over the block
      p->staged = 1;
      const int bv = (nv + p->cluster - 1) / p->cluster;
      const int rows = imin(n, kStageRows);
      int sv = 1;
      while (sv + 2 < bv && rows_fit(true, p->cluster, (sv + 2) * 8) >= rows)
        sv += 2;
      p->cstages = (bv + sv - 1) / sv;
      p->pitch = (((bv + p->cstages - 1) / p->cstages) | 1) * 8;
      p->srows = imin(n, rows_fit(true, p->cluster, p->pitch));
      break;
    }
  }
  if (p->staged && p->cstages == 1) {
    // a tall conference: its rows in groups over the blocks of the
    // cluster its columns leave free
    p->rsplit = imin(imax(1, imin(want, most) / p->cluster), n);
    p->srows = imin((n + p->rsplit - 1) / p->rsplit,
                    rows_fit(true, p->cluster, p->pitch));
  }
  p->smem = p->staged ? staged_smem_bytes(p->cluster, p->pitch, p->srows)
                      : smem_bytes(p->cluster, p->pitch, p->srows);
  p->cluster *= p->rsplit;
}

__device__ __forceinline__ int lo16(uint32_t w) { return int(int16_t(w)); }
__device__ __forceinline__ int hi16(uint32_t w) { return int(w) >> 16; }

// Adds the squares of 8 samples to s, one wide multiply-add a sample.
__device__ __forceinline__ long long add_squares8(long long s, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = lo16(w[k]), b = hi16(w[k]);
    s += (long long)a * a;
    s += (long long)b * b;
  }
  return s;
}

__device__ __forceinline__ int clip16(int v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

// A column total clamped to [-65536, 65535], which leaves
// clip(total - x) unchanged for any int16 x.
__device__ __forceinline__ int clip17(int v) {
  return v < -65536 ? -65536 : (v > 65535 ? 65535 : v);
}

// Starts copying rows [0, sn) x columns [c0, c0 + w) of `rows` (row
// length f) into the slab, each row padded with zeros to `wv` vectors;
// `stage_wait` completes it.  The 2-byte path copies at once.
__device__ __forceinline__ void stage_issue(int16_t* slab,
                                            const int16_t* rows, int sn,
                                            int f, int c0, int w, int wv,
                                            const Plan& p) {
  const int t = threadIdx.x;
  if (p.vec) {                     // w == 8 * wv here
    for (int i = t; i < sn * wv; i += kThreads) {
      const int r = i / wv, v = i - r * wv;
      __pipeline_memcpy_async(slab + r * p.pitch + v * 8,
                              rows + size_t(r) * f + c0 + v * 8, 16);
    }
    __pipeline_commit();
  } else {
    const int wp = wv * 8;
    for (int i = t; i < sn * wp; i += kThreads) {
      const int r = i / wp, col = i - r * wp;
      slab[r * p.pitch + col] =
          col < w ? rows[size_t(r) * f + c0 + col] : int16_t(0);
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_wait_prior(0);
  __syncthreads();
}

// out = clip(total - contrib) for the staged rows [0, sn) of this
// block's columns; `orows` is the first staged row's output.
__device__ __forceinline__ void write_mix(int16_t* orows, const int16_t* slab,
                                         const int* total,
                                         const uint32_t* mask, int sn, int f,
                                         int c0, int w, int wv,
                                         const Plan& p) {
  const int t = threadIdx.x;
  if (p.vec) {
    // a thread keeps one column vector's totals in registers and walks
    // down the rows: every rstep-th row from rfirst
    const bool narrow = wv <= kThreads;
    const int rstep = narrow ? kThreads / wv : 1;
    const int rfirst = narrow ? t / wv : 0;
    if (rfirst >= rstep) return;
    for (int v = narrow ? t % wv : t; v < wv; v += kThreads) {
      int ts[8];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int4 q = reinterpret_cast<const int4*>(total)[2 * v + k];
        ts[4 * k] = clip17(q.x);
        ts[4 * k + 1] = clip17(q.y);
        ts[4 * k + 2] = clip17(q.z);
        ts[4 * k + 3] = clip17(q.w);
      }
#pragma unroll 2
      for (int r = rfirst; r < sn; r += rstep) {
        const uint4 x = reinterpret_cast<const uint4*>(slab + r * p.pitch)[v];
        const uint32_t m = mask[r];
        const uint32_t xs[4] = {x.x & m, x.y & m, x.z & m, x.w & m};
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = clip16(ts[2 * k] - lo16(xs[k]));
          const int b = clip16(ts[2 * k + 1] - hi16(xs[k]));
          o[k] = (uint32_t(a) & 0xFFFFu) | (uint32_t(b) << 16);
        }
        *reinterpret_cast<uint4*>(orows + size_t(r) * f + c0 + v * 8) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  } else {
    for (int i = t; i < sn * w; i += kThreads) {
      const int r = i / w, col = i - r * w;
      const int x = int(slab[r * p.pitch + col]) & int(mask[r]);
      orows[size_t(r) * f + c0 + col] =
          int16_t(clip16(clip17(total[col]) - x));
    }
  }
}

// At most 85 registers a thread, so three blocks fit a SM.
__global__ void __launch_bounds__(kThreads, 3)
    mix_minus_kernel(const int16_t* __restrict__ pcm,
                     const uint8_t* __restrict__ active,
                     int16_t* __restrict__ out, uint8_t* __restrict__ levels,
                     int n, int f, Plan p) {
  extern __shared__ uint4 smem[];
  const int cs = p.cluster;
  const int rank = int(cooperative_groups::this_cluster().block_rank());
  const int conf = blockIdx.x / cs;
  const int t = threadIdx.x;
  // this block's columns: vectors [v0, v1) of the row's ceil(f / 8)
  const int nv = (f + 7) / 8;
  const int v0 = rank * nv / cs, v1 = (rank + 1) * nv / cs;
  const int c0 = v0 * 8;
  const int w = imin(v1 * 8, f) - c0;          // >= 1
  const int wv = v1 - v0;
  const int units = (w + 1) / 2;               // column pairs
  const int16_t* src = pcm + size_t(conf) * n * f;
  int16_t* dst = out + size_t(conf) * n * f;
  const uint8_t* act = active + size_t(conf) * n;
  const int ro = owned(p.srows, cs);

  int16_t* slab = reinterpret_cast<int16_t*>(smem);
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(slab + p.srows * p.pitch);
  int2* part = reinterpret_cast<int2*>(slots + (cs * ro + 1) / 2 * 2);
  int* total = reinterpret_cast<int*>(part + imax(kThreads, p.pitch / 2));
  uint32_t* mask = reinterpret_cast<uint32_t*>(total + p.pitch);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mask + round_up(p.srows, 4));

  // row sums of squares: `lanes` threads a row, `groups` rows at a time
  int lanes = 32;
  while (lanes > 1 && (lanes * p.srows > kThreads || lanes / 2 >= wv))
    lanes /= 2;
  const int groups = kThreads / lanes;
  // column sums: `cgroups` row groups of `units` threads
  const int cgroups = imax(1, imin(kThreads / units, kMaxColumnGroups));
  const bool two_pass = n > p.srows;

  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(slab);
  const int p2 = p.pitch / 2;

  for (int s0 = 0, parity = 0; s0 < n; s0 += p.srows, parity ^= 1) {
    const int sn = imin(p.srows, n - s0);
    stage_issue(slab, src + size_t(s0) * f, sn, f, c0, w, wv, p);
    if (s0 == 0) {       // while the copies fly: this block is running
      if (t == 0) {
        ljt_mbar_init(bar, 1);
        ljt_fence_mbar_init();
      }
      __cluster_barrier_arrive_relaxed();
    }
    for (int i = t; i < sn; i += kThreads)
      mask[i] = act[s0 + i] ? 0xFFFFFFFFu : 0u;
    stage_wait();
    if (s0 == 0) __cluster_barrier_wait();     // every peer is running
    if (t == 0)          // the parts of its rows that every rank will push
      ljt_mbar_expect_tx(bar, 8u * cs * (rank < sn ? owned(sn - rank, cs) : 0));
    // ---- this block's part of each row's sum of squares, pushed into
    // the row owner's slot for this rank
    {
      const int g = t / lanes, lane = t % lanes;
      for (int k = 0; k < (sn + groups - 1) / groups; ++k) {
        const int r = g + k * groups;
        long long s = 0;
        if (r < sn) {
          const uint4* row = reinterpret_cast<const uint4*>(slab + r * p.pitch);
          for (int v = lane; v < wv; v += lanes) s = add_squares8(s, row[v]);
        }
        for (int o = lanes / 2; o > 0; o /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && r < sn)
          ljt_st_async_u64(slots + rank * ro + r / cs, unsigned(r % cs),
                           (unsigned long long)s, bar);
      }
    }
    // ---- the column sums of the active rows (local to the block): row
    // group `cgr` of the threads takes every cgroups-th row
    const int cgr = t / units;
    if (cgr < cgroups) {
      for (int u = t % units; u < units; u += kThreads) {
        int a = 0, b = 0;
#pragma unroll 8
        for (int r = cgr; r < sn; r += cgroups) {
          const uint32_t x = s32[r * p2 + u] & mask[r];
          a += lo16(x);
          b += hi16(x);
        }
        part[cgr * units + u] = make_int2(a, b);
      }
    }
    __syncthreads();
    // ---- the block's column totals, its row groups added in order; on
    // the last threads meanwhile, the levels of the rows this block owns
    // (every rank's parts added in rank order)
    for (int u = t; u < units; u += kThreads) {
      int a = s0 ? total[2 * u] : 0, b = s0 ? total[2 * u + 1] : 0;
#pragma unroll 8
      for (int g = 0; g < cgroups; ++g) {
        a += part[g * units + u].x;
        b += part[g * units + u].y;
      }
      total[2 * u] = a;
      total[2 * u + 1] = b;
    }
    for (int k = kThreads - 1 - t; k < ro; k += kThreads) {
      const int r = rank + k * cs;
      if (r >= sn) break;
      if (k == kThreads - 1 - t) ljt_mbar_wait(bar, parity);
      unsigned long long s = 0;
#pragma unroll 4
      for (int q = 0; q < cs; ++q) s += slots[q * ro + k];
      const float ms = float(s) / float(f) * 9.31322574615478515625e-10f;
      uint8_t level = 127;
      if (mask[r] && !(ms <= 1e-12f)) {
        const float db = 10.0f * log10f(fmaxf(ms, 1e-12f));
        float x = rintf(-db);                  // half to even, as jnp.round
        x = x < 0.0f ? 0.0f : (x > 127.0f ? 127.0f : x);
        level = uint8_t(x);
      }
      levels[size_t(conf) * n + s0 + r] = level;
    }
    __syncthreads();
    if (two_pass) {      // every owner has read its slots: stage again
      __cluster_barrier_arrive();
      __cluster_barrier_wait();
    } else {             // the totals are complete
      write_mix(dst, slab, total, mask, sn, f, c0, w, wv, p);
    }
  }
  if (!two_pass) return;
  // ---- rows in stages: the totals are complete only now, so the mix
  // reads each stage again
  for (int s0 = 0; s0 < n; s0 += p.srows) {
    const int sn = imin(p.srows, n - s0);
    const int16_t* rows = src + size_t(s0) * f;
    stage_issue(slab, rows, sn, f, c0, w, wv, p);
    for (int i = t; i < sn; i += kThreads)
      mask[i] = act[s0 + i] ? 0xFFFFFFFFu : 0u;
    stage_wait();
    write_mix(dst + size_t(s0) * f, slab, total, mask, sn, f, c0, w, wv, p);
    __syncthreads();
  }
}

// A column total of 64 bits clamped as clip17 does.
__device__ __forceinline__ int clip17_64(long long v) {
  return v < -65536 ? -65536 : (v > 65535 ? 65535 : int(v));
}

// The column sums of the active staged rows [0, sn) into `part`: row
// group g of the threads takes every cgroups-th row, one column pair a
// thread (as in mix_minus_kernel).
__device__ __forceinline__ void column_sums(int2* part, const uint32_t* s32,
                                            const uint32_t* mask, int sn,
                                            int units, int cgroups, int p2) {
  const int t = threadIdx.x;
  const int cgr = t / units;
  if (cgr >= cgroups) return;
  for (int u = t % units; u < units; u += kThreads) {
    int a = 0, b = 0;
#pragma unroll 8
    for (int r = cgr; r < sn; r += cgroups) {
      const uint32_t x = s32[r * p2 + u] & mask[r];
      a += lo16(x);
      b += hi16(x);
    }
    part[cgr * units + u] = make_int2(a, b);
  }
}

// RFC 6465 level of a row from its exact sum of squares `sq` over f
// samples, 127 where the row is inactive (m == 0) or silent
// (mix_minus_kernel's arithmetic; that kernel keeps its own copy so that
// its code stays as the paths measured it).
__device__ __forceinline__ uint8_t row_level(unsigned long long sq,
                                             uint32_t m, int f) {
  const float ms = float(sq) / float(f) * 9.31322574615478515625e-10f;
  if (!m || ms <= 1e-12f) return 127;
  const float db = 10.0f * log10f(fmaxf(ms, 1e-12f));
  float x = rintf(-db);                        // half to even, as jnp.round
  x = x < 0.0f ? 0.0f : (x > 127.0f ? 127.0f : x);
  return uint8_t(x);
}

// stage_issue for the staged kernel.  On the 2-byte path a thread takes
// whole staged vectors, four in flight: it loads a vector's real samples
// (at most 8), zero past the block's columns, and stores the vector as
// one 16-byte word, so narrow frames (F = 1 is one sample of a vector)
// do not spend a store and a division on each padding sample.
__device__ __forceinline__ void stage_issue_staged(int16_t* slab,
                                                   const int16_t* rows,
                                                   int sn, int f, int c0,
                                                   int w, int wv,
                                                   const Plan& p) {
  if (p.vec) {
    stage_issue(slab, rows, sn, f, c0, w, wv, p);
    return;
  }
  const int t = threadIdx.x;
  const int all = sn * wv;
  for (int i0 = t; i0 < all; i0 += 4 * kThreads) {
    uint32_t x[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, r = i / wv, v = i - r * wv;
      const int16_t* g = rows + size_t(r) * f + c0 + v * 8;
      const int m = i < all ? imin(8, w - v * 8) : 0;   // real samples
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = 2 * j < m ? uint16_t(g[2 * j]) : 0u;
        const uint32_t hi = 2 * j + 1 < m ? uint16_t(g[2 * j + 1]) : 0u;
        x[k][j] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, r = i / wv, v = i - r * wv;
      if (i < all)
        reinterpret_cast<uint4*>(slab + r * p.pitch)[v] =
            make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
    }
  }
}

// Kernel E for the shapes one pass of mix_minus_kernel does not take:
// more than 65,535 rows (64-bit column totals) or a block's columns in
// stages of at most p.pitch columns (see the header).  The cluster is
// cs blocks across the columns times p.rsplit row groups: a tall
// conference of narrow frames splits its rows too, so that its samples
// move through every block of the cluster.  Pass 1 takes each stage of
// the block's rows through every column stage, adding up each row's sum
// of squares, then pushes the sums to the rows' owners in the row group,
// which write the levels; where the rows fit one stage (or the block's
// columns one stage) it also takes the column totals, and where the
// rows fit one stage it writes each column stage's mix.  Row groups then
// add their column totals, each block reading its column peers' parts.
// Pass 2 writes the mix of conferences whose rows take stages: per
// column stage, the totals over every stage of rows (unless pass 1 took
// them), then the rows again.
__global__ void __launch_bounds__(kThreads, 3)
    mix_minus_staged_kernel(const int16_t* __restrict__ pcm,
                            const uint8_t* __restrict__ active,
                            int16_t* __restrict__ out,
                            uint8_t* __restrict__ levels, int n, int f,
                            Plan p) {
  extern __shared__ uint4 smem[];
  const auto cluster = cooperative_groups::this_cluster();
  const int cs = p.cluster / p.rsplit;  // blocks across the columns
  const int rank = int(cluster.block_rank());
  const int crank = rank % cs, rgroup = rank / cs;
  const int conf = blockIdx.x / p.cluster;
  const int t = threadIdx.x;
  // this block's vectors [v0, v1) of the row's ceil(f / 8), in column
  // stages of at most spv vectors
  const int nv = (f + 7) / 8;
  const int v0 = int((long long)crank * nv / cs);
  const int v1 = int((long long)(crank + 1) * nv / cs);
  const int spv = p.pitch / 8;
  const int nstages = (v1 - v0 + spv - 1) / spv;
  // this block's rows [rb, rb + nr); every block takes the stages of the
  // largest group's `tall` rows, some of them empty
  const int rb = int((long long)rgroup * n / p.rsplit);
  const int nr = int((long long)(rgroup + 1) * n / p.rsplit) - rb;
  const int tall = (n + p.rsplit - 1) / p.rsplit;
  const int16_t* src = pcm + (size_t(conf) * n + rb) * f;
  int16_t* dst = out + (size_t(conf) * n + rb) * f;
  const uint8_t* act = active + size_t(conf) * n + rb;
  uint8_t* lvl = levels + size_t(conf) * n + rb;
  const int ro = owned(p.srows, cs);

  int16_t* slab = reinterpret_cast<int16_t*>(smem);
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(slab + p.srows * p.pitch);
  unsigned long long* acc = slots + (cs * ro + 1) / 2 * 2;
  int2* part = reinterpret_cast<int2*>(acc + (p.srows + 1) / 2 * 2);
  long long* total =
      reinterpret_cast<long long*>(part + imax(kThreads, p.pitch / 2));
  int* total32 = reinterpret_cast<int*>(total + p.pitch);
  uint32_t* mask = reinterpret_cast<uint32_t*>(total32 + p.pitch);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mask + round_up(p.srows, 4));

  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(slab);
  const int p2 = p.pitch / 2;
  const bool one_pass = tall <= p.srows;  // every row in one stage
  const bool fused = nstages == 1;      // the block's columns in one stage

  // column stage k: columns [c0, c0 + w), vectors wv
  auto stage_cols = [&](int k, int& c0, int& w, int& wv) {
    const int a = v0 + k * spv, b = imin(a + spv, v1);
    c0 = a * 8;
    w = imin(b * 8, f) - c0;
    wv = b - a;
  };
  auto load_mask = [&](int s0, int sn) {
    for (int i = t; i < sn; i += kThreads)
      mask[i] = act[s0 + i] ? 0xFFFFFFFFu : 0u;
  };
  // the staged rows' column sums added to the totals (fresh when s0 is 0)
  auto add_totals = [&](int s0, int sn, int w) {
    const int units = (w + 1) / 2;
    const int cgroups = imax(1, imin(kThreads / units, kStagedColumnGroups));
    column_sums(part, s32, mask, sn, units, cgroups, p2);
    __syncthreads();
    for (int u = t; u < units; u += kThreads) {
      int a = 0, b = 0;
#pragma unroll 8
      for (int g = 0; g < cgroups; ++g) {
        a += part[g * units + u].x;
        b += part[g * units + u].y;
      }
      total[2 * u] = (s0 ? total[2 * u] : 0) + a;
      total[2 * u + 1] = (s0 ? total[2 * u + 1] : 0) + b;
    }
    __syncthreads();
  };
  auto clip_totals = [&](int w) {
    for (int i = t; i < w; i += kThreads)
      total32[i] = clip17_64(total[i]);
    __syncthreads();
  };

  // ---- pass 1: the levels, and the mix where the rows fit one stage
  for (int s0 = 0, parity = 0; s0 < tall; s0 += p.srows, parity ^= 1) {
    const int sn = imax(0, imin(p.srows, nr - s0));
    for (int k = 0; k < nstages; ++k) {
      int c0, w, wv;
      stage_cols(k, c0, w, wv);
      stage_issue_staged(slab, src + size_t(s0) * f, sn, f, c0, w, wv, p);
      if (s0 == 0 && k == 0) {   // while the copies fly: this block runs
        if (t == 0) {
          ljt_mbar_init(bar, 1);
          ljt_fence_mbar_init();
        }
        __cluster_barrier_arrive_relaxed();
      }
      if (k == 0) {
        load_mask(s0, sn);
        for (int i = t; i < sn; i += kThreads) acc[i] = 0;
      }
      stage_wait();
      if (s0 == 0 && k == 0) __cluster_barrier_wait();  // peers running
      // this stage's part of each row's sum of squares: `lanes` threads
      // a row, `groups` rows at a time
      int lanes = 32;
      while (lanes > 1 && (lanes * p.srows > kThreads || lanes / 2 >= wv))
        lanes /= 2;
      const int groups = kThreads / lanes;
      const int g = t / lanes, lane = t % lanes;
      for (int q = 0; q < (sn + groups - 1) / groups; ++q) {
        const int r = g + q * groups;
        long long sq = 0;
        if (r < sn) {
          const uint4* row = reinterpret_cast<const uint4*>(slab + r * p.pitch);
          for (int v = lane; v < wv; v += lanes) sq = add_squares8(sq, row[v]);
        }
        for (int o = lanes / 2; o > 0; o /= 2)
          sq += __shfl_xor_sync(0xffffffffu, sq, o);
        if (lane == 0 && r < sn) acc[r] += (unsigned long long)sq;
      }
      if (one_pass || fused) add_totals(s0, sn, w);
      if (one_pass && p.rsplit == 1) {
        clip_totals(w);
        write_mix(dst, slab, total32, mask, sn, f, c0, w, wv, p);
      }
      __syncthreads();          // the slab is free for the next stage
    }
    if (cs == 1) {
      // the block holds whole rows: each row's sum is complete here
      for (int r = t; r < sn; r += kThreads)
        lvl[s0 + r] = row_level(acc[r], mask[r], f);
    } else {
      // each row's sum to the row's owner (column rank row % cs of the
      // row group), once
      if (t == 0)
        ljt_mbar_expect_tx(bar,
                           8u * cs * (crank < sn ? owned(sn - crank, cs) : 0));
      for (int r = t; r < sn; r += kThreads)
        ljt_st_async_u64(slots + crank * ro + r / cs,
                         unsigned(rgroup * cs + r % cs), acc[r], bar);
      // the levels of the rows this block owns, every rank's part added
      // in rank order
      for (int k = kThreads - 1 - t; k < ro; k += kThreads) {
        const int r = crank + k * cs;
        if (r >= sn) break;
        if (k == kThreads - 1 - t) ljt_mbar_wait(bar, parity);
        unsigned long long sq = 0;
        for (int q = 0; q < cs; ++q) sq += slots[q * ro + k];
        lvl[s0 + r] = row_level(sq, mask[r], f);
      }
    }
    __syncthreads();
    if (cs > 1 && s0 + p.srows < tall) {  // every owner read its slots
      __cluster_barrier_arrive();
      __cluster_barrier_wait();
    }
  }
  if (p.rsplit > 1) {
    // the column totals of the conference: the row groups' parts of this
    // block's columns (one column stage here), added in group order
    int c0, w, wv;
    stage_cols(0, c0, w, wv);
    __cluster_barrier_arrive();
    __cluster_barrier_wait();   // every part is complete
    for (int i = t; i < w; i += kThreads) {
      long long v = 0;
      for (int g = 0; g < p.rsplit; ++g)
        v += cluster.map_shared_rank(total, unsigned(g * cs + crank))[i];
      total32[i] = clip17_64(v);
    }
    __cluster_barrier_arrive();  // waited on before exit: peers read us
    __syncthreads();
    if (one_pass) {
      write_mix(dst, slab, total32, mask, nr, f, c0, w, wv, p);
      __cluster_barrier_wait();
      return;
    }
  }
  if (one_pass) return;
  // ---- pass 2: rows in stages, the mix of each column stage
  for (int k = 0; k < nstages; ++k) {
    int c0, w, wv;
    stage_cols(k, c0, w, wv);
    if (!fused) {
      for (int s0 = 0; s0 < nr; s0 += p.srows) {
        const int sn = imin(p.srows, nr - s0);
        stage_issue_staged(slab, src + size_t(s0) * f, sn, f, c0, w, wv, p);
        load_mask(s0, sn);
        stage_wait();
        add_totals(s0, sn, w);
      }
    }
    if (p.rsplit == 1) clip_totals(w);
    for (int s0 = 0; s0 < nr; s0 += p.srows) {
      const int sn = imin(p.srows, nr - s0);
      stage_issue_staged(slab, src + size_t(s0) * f, sn, f, c0, w, wv, p);
      load_mask(s0, sn);
      stage_wait();
      write_mix(dst + size_t(s0) * f, slab, total32, mask, sn, f, c0, w, wv,
                p);
      __syncthreads();
    }
  }
  if (p.rsplit > 1) __cluster_barrier_wait();
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess || sms < 1)
    return 1;
  return sms;
}

}  // namespace

// The launch kernel E would make for these arguments, for reports and
// tests: plan[8] = {cluster, staged columns a block, staged rows, vec,
// dynamic shared memory bytes, column stages of the widest block, 1 for
// mix_minus_staged_kernel, row groups of the cluster}.
extern "C" int ljt_mix_minus_plan(const void* pcm, const void* out, int c,
                                  int n, int f, void* plan) {
  if (c < 1 || n < 1 || f < 1) return int(cudaErrorInvalidValue);
  Plan p;
  make_plan(pcm, out, c, n, f, device_sms(), &p);
  int* o = static_cast<int*>(plan);
  o[0] = p.cluster; o[1] = p.pitch; o[2] = p.srows; o[3] = p.vec;
  o[4] = p.smem; o[5] = p.cstages; o[6] = p.staged; o[7] = p.rsplit;
  return 0;
}

// Returns 0 or the CUDA error of the launch.  Every shape has a plan; a
// grid of more than 2^31 - 1 blocks (over 2^27 conferences of frames
// wider than 9,000 samples, beyond any card's memory) returns
// cudaErrorInvalidValue with nothing launched.
extern "C" int ljt_mix_minus(const void* pcm, const void* active, void* out,
                             void* levels, int c, int n, int f,
                             void* stream) {
  if (c < 0 || n < 0 || f < 0) return int(cudaErrorInvalidValue);
  if (c == 0 || n == 0 || f == 0) return 0;
  Plan p;
  make_plan(pcm, out, c, n, f, device_sms(), &p);
  if (size_t(c) * p.cluster > size_t(0x7FFFFFFF))
    return int(cudaErrorInvalidValue);
  auto kernel = p.staged ? mix_minus_staged_kernel : mix_minus_kernel;
  if (p.smem > kDefaultSmem) {
    const int e = int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem));
    if (e) return e;
  }
  if (p.cluster > kPortableCluster) {
    const int e = int(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (e) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(c) * unsigned(p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(p.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int e = int(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int16_t*>(pcm),
      static_cast<const uint8_t*>(active), static_cast<int16_t*>(out),
      static_cast<uint8_t*>(levels), n, f, p));
  if (e) return e;
  return int(cudaGetLastError());
}
