// Kernel R: the polyphase windowed-sinc resampler, L/M.
//
// Replaces: libjitsi_tpu/kernels/resample.py `_resample_jit` (K13b, XLA
// device code: a window gather and an einsum), on the conference bridge's
// path wherever a leg's clock differs from the bridge's: the receive
// bank's deposit and the bridge's egress.
//   pcm [B, T] i16, bank [L, taps] f32 -> out [B, T*L/M] i16.
// Output sample j sits at upsampled position j*M = phase + L*base and is
//   acc = 0; for k = 0..taps-1: acc = fma(x[clamp(base - k + taps/2)],
//                                        bank[phase][k], acc)
// then rounded half to even and clamped to int16.  The taps go in that
// order through `__fmaf_rn`, which is how XLA on the CPU evaluates the
// JAX einsum, so the port's plain version, this kernel and the JAX package
// agree sample for sample.
//
// Bound on the H100: bytes (2 a sample in, 2 a sample out) against 16
// FMAs an output sample; at the conference's ratios (L/M of 2, 1/2, 6,
// 1/6, 160/147) bytes bind, and at its 20 ms rows of 255 legs the launch.
//
// Design.  The instances for the ratios the JAX resampler is documented
// for (8k/16k/24k <-> 48k, and 8k <-> 16k: L/1 and 1/M with L, M of 2, 3
// or 6; 16 taps) need no shared memory and no barrier:
//   - the bank is a kernel parameter: with the loops unrolled every lane
//     of a warp is at the same phase and tap at each FFMA, whose
//     coefficient comes from the constant bank through a uniform register
//     (ULDC), not from memory;
//   - each thread holds a window of input samples in registers, read from
//     global memory through the L1 in 8- or 16-byte loads (clamped sample
//     by sample only at a row's edges or where a launch is unaligned), and
//     computes a run of consecutive outputs from it: for L/1 all L phases
//     of kRun base positions, for 1/M kRun outputs M samples apart;
//   - samples become floats by a bias (2**23 + 2**15 added in the
//     exponent's field, then subtracted) and outputs int16 by the 1.5 *
//     2**23 bias, both exact, so no conversion instruction (a quarter of
//     the FMA rate) runs per sample; a thread stores its run in 8- or
//     16-byte words.
// Any other ratio or tap count takes the general instance: a block of
// warps stages the bank once in shared memory, its rows padded to an odd
// stride (lanes at distinct phases read distinct banks), behind one
// barrier with each warp's first span; each warp then walks items (a row
// and up to kGenChunk outputs), staging the item's input span in its own
// region with only `__syncwarp` between items, and each lane steps its
// phase and base by 32 outputs without a division.
// Each instance has a phase probe build (`ljt_resample_phases`, clock64
// stamps a warp); the shipped kernels compile none of it.

#include <cuda_runtime.h>

#include <cstdint>

#include "phases.cuh"

namespace {

constexpr int kTaps = 16;          // taps a phase of the templated instances
constexpr int kRun = 4;            // base positions (L/1), outputs (1/M)
constexpr int kThreads = 128;      // a block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 16;   // the grid's cap, then threads stride
constexpr int kGenChunk = 256;     // outputs of a general work item at most
constexpr int kGenSpan = 1024;     // input samples a warp stages (general)
constexpr int kMaxElements = 1 << 30;
// The phase probe's clock64 words a warp: its start, set-up done, the
// cycles of its items' span staging, tap loops and stores, its items, its
// end, its SM and warp slot, the global timer (ns) at its start and end,
// and its index.
constexpr int kRPhaseSlots = 12;

template <int L>
struct Bank {
  float c[L][kTaps];
};

// Exact int16 -> float of both halves of a word: the sign bits flipped
// (s + 2**15 as 16 bits), put under the exponent of 2**23, less 2**23 +
// 2**15.
__device__ __forceinline__ float lo_sample(uint32_t flipped) {
  return __int_as_float(int(__byte_perm(flipped, 0x4B00u, 0x5410)))
         - 8421376.0f;
}
__device__ __forceinline__ float hi_sample(uint32_t flipped) {
  return __int_as_float(int(__byte_perm(flipped, 0x4B00u, 0x5432)))
         - 8421376.0f;
}

// An output's int16 in the low half of a word: clamped, then rounded half
// to even by adding 1.5 * 2**23 (exact below 2**22), whose low bits are
// then the integer's.
__device__ __forceinline__ uint32_t out_bits(float acc) {
  const float y = fminf(fmaxf(acc, -32768.0f), 32767.0f);
  return uint32_t(__float_as_int(__fadd_rn(y, 12582912.0f)));
}

// Words of int16 pairs -> the window's floats.
template <int N>
__device__ __forceinline__ void unpack(const uint32_t (&words)[N / 2],
                                       float (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const uint32_t f = words[i] ^ 0x80008000u;
    w[2 * i] = lo_sample(f);
    w[2 * i + 1] = hi_sample(f);
  }
}

// A window of N input samples x[clamp(s0 + i)] of a row of t: `fetch`
// issues 16-byte (V = 8) or 8-byte (V = 4) loads of its raw words when it
// lies inside the row and the launch is aligned, and `get` turns them into
// floats (or, at a row's edge, loads and clamps sample by sample).
template <int N, int V>
struct Window {
  static_assert(N % V == 0 && (V == 4 || V == 8), "window of whole loads");
  uint32_t words[N / 2];
  const int16_t* x;
  int s0;
  bool raw;
  __device__ __forceinline__ void fetch(const int16_t* __restrict__ row,
                                        int t, int s, bool vec) {
    x = row;
    s0 = s;
    raw = vec && s >= 0 && s + N <= t;
    if (!raw) return;
    if constexpr (V == 8) {
      const uint4* p = reinterpret_cast<const uint4*>(x + s0);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const uint4 v = __ldg(p + i);
        words[4 * i] = v.x;
        words[4 * i + 1] = v.y;
        words[4 * i + 2] = v.z;
        words[4 * i + 3] = v.w;
      }
    } else {
      const uint2* p = reinterpret_cast<const uint2*>(x + s0);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const uint2 v = __ldg(p + i);
        words[2 * i] = v.x;
        words[2 * i + 1] = v.y;
      }
    }
  }
  __device__ __forceinline__ void get(int t, float (&w)[N]) const {
    if (raw) {
      unpack<N>(words, w);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        w[i] = float(x[min(max(s0 + i, 0), t - 1)]);
    }
  }
};

// Stores n int16 outputs (bits in the low halves of r) at y: as 16- or
// 8-byte words when `vec` (whole and aligned), else those below `valid`
// one by one.
template <int N>
__device__ __forceinline__ void store_run(int16_t* __restrict__ y,
                                          const uint32_t (&r)[N], bool vec,
                                          int valid) {
  if (vec) {
    uint32_t p[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      p[i] = __byte_perm(r[2 * i], r[2 * i + 1], 0x5410);
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        reinterpret_cast<uint4*>(y)[i] =
            make_uint4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        reinterpret_cast<uint2*>(y)[i] = make_uint2(p[2 * i], p[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < valid) y[i] = int16_t(r[i] & 0xFFFFu);
  }
}

// The probe's stamps of the calling warp (lane 0 writes them).
struct WarpStamps {
  long long* st;
  long long mark;
  __device__ __forceinline__ void start(long long* stamps) {
    const int wid = int((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    st = stamps + size_t(wid) * kRPhaseSlots;
    if ((threadIdx.x & 31) == 0) {
      st[0] = mark = clock64();
      st[7] = phase_smid();
      st[8] = phase_warpid();
      st[9] = phase_globaltimer();
      st[11] = wid;
    }
  }
  // the cycles since the last mark, added to slot i (slot 1 takes the
  // clock itself the first time)
  __device__ __forceinline__ void lap(int i) {
    if ((threadIdx.x & 31) == 0) {
      const long long now = clock64();
      if (i == 1) {
        if (st[1] == 0) st[1] = now;
      } else {
        st[i] += now - mark;
      }
      mark = now;
    }
  }
  __device__ __forceinline__ void end(int items) {
    if ((threadIdx.x & 31) == 0) {
      st[5] = items;
      st[6] = clock64();
      if (st[1] == 0) st[1] = st[6];
      st[10] = phase_globaltimer();
    }
  }
};

// L/1: thread u (in the grid's flat order, striding by the grid) takes
// base positions q0 .. q0 + kRun - 1 of its row (q0 = kRun * (u mod
// runs)), all L phases of each: L * kRun consecutive outputs from the
// window x[q0 - 8 .. q0 + kRun + 7].  A warp walks in step (its units
// are consecutive), so a row's edges diverge only the lanes that touch
// them.
template <int L, bool Phases>
__device__ __forceinline__ void up_walk(const int16_t* __restrict__ pcm,
                                        const Bank<L>& bank,
                                        int16_t* __restrict__ out, int t,
                                        int out_len, int runs, int units,
                                        bool vec, long long* stamps) {
  constexpr int N = kRun + kTaps;
  WarpStamps ws;
  if constexpr (Phases) ws.start(stamps);
  int items = 0;
  const int stride = int(gridDim.x * blockDim.x);
  for (int u = int(blockIdx.x * blockDim.x + threadIdx.x); u < units;
       u += stride) {
    const int row = u / runs;
    const int q0 = (u - row * runs) * kRun;
    Window<N, 4> win;
    win.fetch(pcm + size_t(row) * t, t, q0 - 8, vec);
    if constexpr (Phases) ws.lap(1);
    float w[N];
    win.get(t, w);
    if constexpr (Phases) ws.lap(2);
    uint32_t r[L * kRun];
#pragma unroll
    for (int a = 0; a < kRun; ++a)
#pragma unroll
      for (int p = 0; p < L; ++p) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          acc = __fmaf_rn(w[a + kTaps - k], bank.c[p][k], acc);
        r[a * L + p] = out_bits(acc);
      }
    if constexpr (Phases) ws.lap(3);
    store_run<L * kRun>(out + size_t(row) * out_len + size_t(L) * q0, r, vec,
                        L * (t - q0));
    if constexpr (Phases) {
      ws.lap(4);
      ++items;
    }
  }
  if constexpr (Phases) ws.end(items);
}

// 1/M: thread u takes outputs j0 .. j0 + kRun - 1 of its row (j0 = kRun *
// (u mod runs)), from the window x[j0*M - 8 ..], read in loads of V
// samples (16 bytes where j0*M is a multiple of 8 for every j0, i.e. M
// even; else 8).
template <int M, bool Phases>
__device__ __forceinline__ void down_walk(const int16_t* __restrict__ pcm,
                                          const Bank<1>& bank,
                                          int16_t* __restrict__ out, int t,
                                          int out_len, int runs, int units,
                                          bool vec, long long* stamps) {
  constexpr int V = M % 2 == 0 ? 8 : 4;
  constexpr int N = ((kRun - 1) * M + kTaps + 1 + V - 1) / V * V;
  WarpStamps ws;
  if constexpr (Phases) ws.start(stamps);
  int items = 0;
  const int stride = int(gridDim.x * blockDim.x);
  for (int u = int(blockIdx.x * blockDim.x + threadIdx.x); u < units;
       u += stride) {
    const int row = u / runs;
    const int j0 = (u - row * runs) * kRun;
    Window<N, V> win;
    win.fetch(pcm + size_t(row) * t, t, j0 * M - 8, vec);
    if constexpr (Phases) ws.lap(1);
    float w[N];
    win.get(t, w);
    if constexpr (Phases) ws.lap(2);
    uint32_t r[kRun];
#pragma unroll
    for (int a = 0; a < kRun; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        acc = __fmaf_rn(w[a * M + kTaps - k], bank.c[0][k], acc);
      r[a] = out_bits(acc);
    }
    if constexpr (Phases) ws.lap(3);
    store_run<kRun>(out + size_t(row) * out_len + j0, r, vec, out_len - j0);
    if constexpr (Phases) {
      ws.lap(4);
      ++items;
    }
  }
  if constexpr (Phases) ws.end(items);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    resample_up_kernel(const int16_t* __restrict__ pcm, Bank<L> bank,
                       int16_t* __restrict__ out, int t, int out_len,
                       int runs, int units, bool vec) {
  up_walk<L, false>(pcm, bank, out, t, out_len, runs, units, vec, nullptr);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    resample_up_phases_kernel(const int16_t* __restrict__ pcm, Bank<L> bank,
                              int16_t* __restrict__ out, int t, int out_len,
                              int runs, int units, bool vec,
                              long long* stamps) {
  up_walk<L, true>(pcm, bank, out, t, out_len, runs, units, vec, stamps);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    resample_down_kernel(const int16_t* __restrict__ pcm, Bank<1> bank,
                         int16_t* __restrict__ out, int t, int out_len,
                         int runs, int units, bool vec) {
  down_walk<M, false>(pcm, bank, out, t, out_len, runs, units, vec, nullptr);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    resample_down_phases_kernel(const int16_t* __restrict__ pcm,
                                Bank<1> bank, int16_t* __restrict__ out,
                                int t, int out_len, int runs, int units,
                                bool vec, long long* stamps) {
  down_walk<M, true>(pcm, bank, out, t, out_len, runs, units, vec, stamps);
}

// The general instance's launch: its outputs a work item, the 32-output
// step of a lane's position (dq base positions, dr phases), and the
// stride of a bank row in shared memory.
struct GenPlan {
  int l, m, taps, chunk, chunks, items, dq, dr, stride;
};

// Any L/M and tap count: the block stages the bank (rows padded to the
// odd stride `stride`), each warp its first item's span, behind one
// barrier; then each warp walks items of a row and up to `chunk` outputs,
// staging each item's span [s0, s0 + len) of input, clamped to the row,
// with only `__syncwarp` between items.  Lane i computes outputs i, i +
// 32, ... of the item, stepping its phase `rel` and base by (dq, dr).
template <bool Phases>
__device__ __forceinline__ void general_walk(const int16_t* __restrict__ pcm,
                                             const float* __restrict__ bank,
                                             int16_t* __restrict__ out, int t,
                                             int out_len, GenPlan g,
                                             long long* stamps) {
  extern __shared__ uint4 smem[];
  float* bank_s = reinterpret_cast<float*>(smem);
  const int warp = int(threadIdx.x >> 5), lane = int(threadIdx.x & 31);
  float* span_s = bank_s + g.l * g.stride + warp * kGenSpan;
  WarpStamps ws;
  if constexpr (Phases) ws.start(stamps);
  for (int i = int(threadIdx.x); i < g.l * g.taps; i += kThreads)
    bank_s[(i / g.taps) * g.stride + i % g.taps] = bank[i];
  const int half = g.taps / 2;
  const int wstride = int(gridDim.x) * kWarps;
  int w = int(blockIdx.x) * kWarps + warp;
  // an item's row, first output, outputs, first base and span start
  int row = 0, n = 0;
  long long j0 = 0, base0 = 0, s0 = 0;
  auto stage = [&]() {
    row = w / g.chunks;
    j0 = (long long)(w - row * g.chunks) * g.chunk;
    n = int(min((long long)g.chunk, out_len - j0));
    base0 = j0 * g.m / g.l;
    s0 = base0 + half - g.taps + 1;
    const int len = int((j0 + n - 1) * g.m / g.l - base0) + g.taps;
    const int16_t* x = pcm + size_t(row) * t;
    for (int i = lane; i < len; i += 32)
      span_s[i] = float(x[min(max(s0 + i, 0LL), (long long)t - 1)]);
  };
  if (w < g.items) stage();
  __syncthreads();
  if constexpr (Phases) ws.lap(1);
  int items = 0;
  while (w < g.items) {
    const long long p = (j0 + lane) * g.m;
    int base = int(p / g.l - base0), rel = int(p % g.l);
    int16_t* y = out + size_t(row) * out_len + j0;
    for (int r = lane; r < n; r += 32) {
      const float* c = bank_s + rel * g.stride;
      const float* v = span_s + base + g.taps - 1;   // tap k: v[-k]
      float acc = 0.0f;
#pragma unroll 16
      for (int k = 0; k < g.taps; ++k) acc = __fmaf_rn(v[-k], c[k], acc);
      y[r] = int16_t(out_bits(acc) & 0xFFFFu);
      base += g.dq;
      rel += g.dr;
      if (rel >= g.l) {
        rel -= g.l;
        ++base;
      }
    }
    if constexpr (Phases) {
      ws.lap(3);
      ++items;
    }
    w += wstride;
    __syncwarp();
    if (w < g.items) stage();
    __syncwarp();
    if constexpr (Phases) ws.lap(2);
  }
  if constexpr (Phases) ws.end(items);
}

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const int16_t* __restrict__ pcm,
                    const float* __restrict__ bank, int16_t* __restrict__ out,
                    int t, int out_len, GenPlan g) {
  general_walk<false>(pcm, bank, out, t, out_len, g, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    resample_phases_kernel(const int16_t* __restrict__ pcm,
                           const float* __restrict__ bank,
                           int16_t* __restrict__ out, int t, int out_len,
                           GenPlan g, long long* stamps) {
  general_walk<true>(pcm, bank, out, t, out_len, g, stamps);
}

int sm_count() {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms < 1)
    sms = 1;
  return sms;
}

template <class K, class... A>
int launch(K kernel, int blocks, int smem, void* stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(unsigned(kThreads));
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const int rc = int(cudaLaunchKernelEx(&cfg, kernel, args...));
  return rc ? rc : int(cudaGetLastError());
}

// Threads for `units` runs: a block of kThreads each, at most kBlocksPerSm
// blocks an SM (the threads then stride).
int blocks_for(long long units) {
  const long long most = (long long)kBlocksPerSm * sm_count();
  const long long b = (units + kThreads - 1) / kThreads;
  return int(b < most ? b : most);
}

// A launch's warps, threads a block and form (1 L/1, 2 1/M, 3 general);
// `cap` is the warps the probe's stamps have room for.
struct Plan {
  int walkers, threads, form, cap;
};

// Records the plan; a probe launch of more warps than its stamps hold is
// refused.
template <bool Phases>
bool planned(Plan* plan, int blocks, int form) {
  plan->walkers = blocks * kWarps;
  plan->form = form;
  return !Phases || plan->walkers <= plan->cap;
}

template <int L, bool Phases>
int launch_up(const void* pcm, const float* host, void* out, int rows, int t,
              int out_len, bool vec, void* stream, long long* stamps,
              Plan* plan) {
  Bank<L> bank;
  for (int i = 0; i < L * kTaps; ++i) bank.c[i / kTaps][i % kTaps] = host[i];
  const int runs = (t + kRun - 1) / kRun;
  const int units = rows * runs;
  const int blocks = blocks_for(units);
  if (!planned<Phases>(plan, blocks, 1)) return int(cudaErrorInvalidValue);
  const auto* x = static_cast<const int16_t*>(pcm);
  auto* y = static_cast<int16_t*>(out);
  if constexpr (Phases)
    return launch(resample_up_phases_kernel<L>, blocks, 0, stream, x, bank,
                  y, t, out_len, runs, units, vec, stamps);
  else
    return launch(resample_up_kernel<L>, blocks, 0, stream, x, bank, y, t,
                  out_len, runs, units, vec);
}

template <int M, bool Phases>
int launch_down(const void* pcm, const float* host, void* out, int rows,
                int t, int out_len, bool vec, void* stream, long long* stamps,
                Plan* plan) {
  Bank<1> bank;
  for (int k = 0; k < kTaps; ++k) bank.c[0][k] = host[k];
  const int runs = (out_len + kRun - 1) / kRun;
  const int units = rows * runs;
  const int blocks = blocks_for(units);
  if (!planned<Phases>(plan, blocks, 2)) return int(cudaErrorInvalidValue);
  const auto* x = static_cast<const int16_t*>(pcm);
  auto* y = static_cast<int16_t*>(out);
  if constexpr (Phases)
    return launch(resample_down_phases_kernel<M>, blocks, 0, stream, x, bank,
                  y, t, out_len, runs, units, vec, stamps);
  else
    return launch(resample_down_kernel<M>, blocks, 0, stream, x, bank, y, t,
                  out_len, runs, units, vec);
}

template <bool Phases>
int launch_general(const void* pcm, const void* bank, void* out, int rows,
                   int t, int out_len, int l, int m, int taps, void* stream,
                   long long* stamps, Plan* plan) {
  GenPlan g;
  g.l = l;
  g.m = m;
  g.taps = taps;
  g.stride = taps | 1;
  // outputs an item: as many as keep its span inside kGenSpan samples
  const long long fit = (long long)(kGenSpan - taps - 1) * l / m + 1;
  g.chunk = int(fit < kGenChunk ? fit : kGenChunk);
  g.chunks = (out_len + g.chunk - 1) / g.chunk;
  const long long items = (long long)rows * g.chunks;
  g.items = int(items);
  g.dq = int(32LL * m / l);
  g.dr = int(32LL * m % l);
  const int smem = int(sizeof(float)) * (l * g.stride + kWarps * kGenSpan);
  if (smem > 48 * 1024) {
    const int rc = Phases ? int(cudaFuncSetAttribute(
                                resample_phases_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem))
                          : int(cudaFuncSetAttribute(
                                resample_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem));
    if (rc) return int(cudaErrorInvalidValue);
  }
  const long long most = (long long)kBlocksPerSm * sm_count();
  const long long b = (items + kWarps - 1) / kWarps;
  const int blocks = int(b < most ? b : most);
  if (!planned<Phases>(plan, blocks, 3)) return int(cudaErrorInvalidValue);
  const auto* x = static_cast<const int16_t*>(pcm);
  const auto* c = static_cast<const float*>(bank);
  auto* y = static_cast<int16_t*>(out);
  if constexpr (Phases)
    return launch(resample_phases_kernel, blocks, smem, stream, x, c, y, t,
                  out_len, g, stamps);
  else
    return launch(resample_kernel, blocks, smem, stream, x, c, y, t, out_len,
                  g);
}

// Checks the arguments and picks the instance: L/1 or 1/M with L, M of 2,
// 3 or 6 at 16 taps run their own (bank from `host`), any other the
// general one (bank from device memory).  A launch is aligned (whole
// vector loads and stores) when both tensors start on 16 bytes and T and
// the output width are multiples of 8.
template <bool Phases>
int dispatch(const void* pcm, const void* bank, const void* host, void* out,
             int rows, int t, int out_len, int l, int m, int taps,
             void* stream, long long* stamps, Plan* plan) {
  if (pcm == nullptr || bank == nullptr || out == nullptr || rows < 0
      || t < 1 || l < 1 || m < 1 || taps < 1 || taps + 2 > kGenSpan
      || out_len != int((long long)t * l / m)
      || (long long)rows * t > kMaxElements
      || (long long)rows * out_len > kMaxElements)
    return int(cudaErrorInvalidValue);
  if (rows == 0 || out_len == 0) return 0;
  const bool vec = (reinterpret_cast<uintptr_t>(pcm) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(out) & 15) == 0
                   && t % 8 == 0 && out_len % 8 == 0;
  const float* h = static_cast<const float*>(host);
  if (taps == kTaps && h != nullptr && m == 1) {
    switch (l) {
      case 2:
        return launch_up<2, Phases>(pcm, h, out, rows, t, out_len, vec,
                                    stream, stamps, plan);
      case 3:
        return launch_up<3, Phases>(pcm, h, out, rows, t, out_len, vec,
                                    stream, stamps, plan);
      case 6:
        return launch_up<6, Phases>(pcm, h, out, rows, t, out_len, vec,
                                    stream, stamps, plan);
    }
  }
  if (taps == kTaps && h != nullptr && l == 1) {
    switch (m) {
      case 2:
        return launch_down<2, Phases>(pcm, h, out, rows, t, out_len, vec,
                                      stream, stamps, plan);
      case 3:
        return launch_down<3, Phases>(pcm, h, out, rows, t, out_len, vec,
                                      stream, stamps, plan);
      case 6:
        return launch_down<6, Phases>(pcm, h, out, rows, t, out_len, vec,
                                      stream, stamps, plan);
    }
  }
  return launch_general<Phases>(pcm, bank, out, rows, t, out_len, l, m, taps,
                                stream, stamps, plan);
}

}  // namespace

// pcm [rows, t] int16 -> out [rows, out_len] int16 (out_len = t*l/m) under
// the bank [l, taps] float32, in device memory (`bank`) and on the host
// (`bank_host`, read at the launch; NULL sends every ratio to the general
// instance).
extern "C" int ljt_resample(const void* pcm, const void* bank,
                            const void* bank_host, void* out, int rows, int t,
                            int out_len, int l, int m, int taps,
                            void* stream) {
  Plan plan{0, kThreads, 0, 0};
  return dispatch<false>(pcm, bank, bank_host, out, rows, t, out_len, l, m,
                         taps, stream, nullptr, &plan);
}

// The phase probe: the same launch with clock64 stamps, kRPhaseSlots words
// a warp, into stamps [walkers, kRPhaseSlots] (zeroed by the caller; a
// launch of more warps is refused), and its plan into plan_out [4]: the
// warps, threads a block, the form (1 L/1, 2 1/M, 3 general) and the
// words a warp.
extern "C" int ljt_resample_phases(const void* pcm, const void* bank,
                                   const void* bank_host, void* out,
                                   int rows, int t, int out_len, int l, int m,
                                   int taps, void* stamps, int walkers,
                                   void* plan_out, void* stream) {
  if (stamps == nullptr || plan_out == nullptr)
    return int(cudaErrorInvalidValue);
  Plan plan{0, kThreads, 0, walkers};
  const int rc = dispatch<true>(pcm, bank, bank_host, out, rows, t, out_len,
                                l, m, taps, stream,
                                static_cast<long long*>(stamps), &plan);
  int* p = static_cast<int*>(plan_out);
  p[0] = plan.walkers;
  p[1] = plan.threads;
  p[2] = plan.form;
  p[3] = kRPhaseSlots;
  return rc;
}
