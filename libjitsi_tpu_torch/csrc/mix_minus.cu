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
// threads cannot change a level.
//
// Bound on the H100: bytes.  Each sample is read once and written once
// (4 bytes per sample) with a few integer adds beside it.
// Design: one launch, two kinds of block, chosen by blockIdx.x
// (blockIdx.y is the conference).  A mix block owns 32 columns of one
// conference: its 8 warps sum every 8th participant row, the partial
// sums meet in shared memory, and each warp then writes its rows of the
// mix-minus.  A level block owns 8 participant rows, one warp each; the
// 32 lanes of a warp stride over the row and a shared-memory tree sums
// their 64-bit partials.  No atomics, so the result does not depend on
// the order in which blocks run.

#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;                  // columns of a mix block
constexpr int kGroups = kThreads / kCols;  // row groups of a mix block
constexpr int kRows = 8;                   // rows of a level block
constexpr int kLanes = kThreads / kRows;   // threads on one level row

__global__ void __launch_bounds__(kThreads)
    mix_minus_kernel(const int16_t* __restrict__ pcm,
                     const uint8_t* __restrict__ active,
                     int16_t* __restrict__ out, uint8_t* __restrict__ levels,
                     int n, int f, int mix_blocks) {
  const int c = blockIdx.y;
  const size_t base = size_t(c) * n * f;
  const int16_t* conf = pcm + base;
  const uint8_t* act = active + size_t(c) * n;
  const int t = threadIdx.x;

  if (int(blockIdx.x) < mix_blocks) {
    __shared__ int partial[kGroups][kCols];
    const int lane = t % kCols;
    const int grp = t / kCols;
    const int col = blockIdx.x * kCols + lane;
    const bool inside = col < f;
    int sum = 0;
    if (inside)
      for (int i = grp; i < n; i += kGroups)
        if (act[i]) sum += conf[size_t(i) * f + col];
    partial[grp][lane] = sum;
    __syncthreads();
    if (!inside) return;
    int total = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += partial[g][lane];
    int16_t* o = out + base;
    for (int i = grp; i < n; i += kGroups) {
      const int contrib = act[i] ? int(conf[size_t(i) * f + col]) : 0;
      int v = total - contrib;
      v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
      o[size_t(i) * f + col] = int16_t(v);
    }
    return;
  }

  __shared__ long long part[kThreads];
  const int row = (blockIdx.x - mix_blocks) * kRows + t / kLanes;
  const int lane = t % kLanes;
  long long s = 0;
  if (row < n) {
    const int16_t* x = conf + size_t(row) * f;
    for (int j = lane; j < f; j += kLanes) {
      const int v = x[j];
      s += v * v;                    // <= 2^30: exact in 32 bits
    }
  }
  part[t] = s;
  __syncthreads();
  for (int w = kLanes / 2; w > 0; w /= 2) {
    if (lane < w) part[t] += part[t + w];
    __syncthreads();
  }
  if (lane != 0 || row >= n) return;
  const float ms = float(part[t]) / float(f) * 9.31322574615478515625e-10f;
  uint8_t level = 127;
  if (act[row] && !(ms <= 1e-12f)) {
    const float db = 10.0f * log10f(fmaxf(ms, 1e-12f));
    float r = rintf(-db);              // half to even, as jnp.round
    r = r < 0.0f ? 0.0f : (r > 127.0f ? 127.0f : r);
    level = uint8_t(r);
  }
  levels[size_t(c) * n + row] = level;
}

}  // namespace

extern "C" int ljt_mix_minus(const void* pcm, const void* active, void* out,
                             void* levels, int c, int n, int f,
                             void* stream) {
  if (c < 0 || n < 0 || f < 0 || c > 65535) return int(cudaErrorInvalidValue);
  if (c == 0 || n == 0 || f == 0) return 0;
  const int mix_blocks = (f + kCols - 1) / kCols;
  const int level_blocks = (n + kRows - 1) / kRows;
  const dim3 grid(mix_blocks + level_blocks, c);
  mix_minus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<const uint8_t*>(active),
      static_cast<int16_t*>(out), static_cast<uint8_t*>(levels), n, f,
      mix_blocks);
  return int(cudaGetLastError());
}
