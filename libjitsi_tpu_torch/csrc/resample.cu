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
// 1/6, 160/147) bytes bind.
// Design: a block stages the bank in shared memory once, then walks work
// items (a row and a chunk of its outputs) in a grid-stride loop, so any
// row count runs (no grid.y, the 64-bit item index past 65,535 rows and
// past 2**31 outputs).  For each item it stages the span of input the
// chunk reads, converted to float and with each index clamped to the row,
// at most `span` samples (the wrapper sizes the chunk so its span fits),
// so a row longer than shared memory is read chunk by chunk.  Then each
// thread computes outputs of the chunk, one at a time, from shared
// memory.  An item's first position j0*M is split once in 64-bit; the
// outputs inside it take 32-bit offsets from there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const int16_t* __restrict__ pcm,
                    const float* __restrict__ bank, int16_t* __restrict__ out,
                    int rows, int t, int out_len, int l, int m, int taps,
                    int chunk) {
  extern __shared__ uint4 smem[];
  float* bank_s = reinterpret_cast<float*>(smem);   // [l * taps]
  float* span_s = bank_s + l * taps;                // [span]
  for (int i = threadIdx.x; i < l * taps; i += blockDim.x)
    bank_s[i] = bank[i];
  const long long chunks = (out_len + (long long)chunk - 1) / chunk;
  const long long items = chunks * rows;
  const int half = taps / 2;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long row = w / chunks;
    const long long j0 = (w % chunks) * chunk;
    const int n = int(min((long long)chunk, out_len - j0));
    // the item's first position j0*M = q0*L + r0; its span of input
    // [s0, s1], each index clamped to the row when staged
    const long long p0 = j0 * m;
    const long long q0 = p0 / l;
    const unsigned r0 = unsigned(p0 - q0 * l);
    const long long s0 = q0 + half - taps + 1;
    const int len = int(((j0 + n - 1) * m) / l + half - s0 + 1);
    const int16_t* x = pcm + row * t;
    __syncthreads();                    // the last item's reads are done
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const long long s = min(max(s0 + i, 0LL), (long long)t - 1);
      span_s[i] = float(x[s]);
    }
    __syncthreads();
    int16_t* y = out + row * out_len + j0;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      // output j0 + r: phase rel % L, base q0 + rel / L (32-bit: the
      // chunk keeps r * M inside the span times L)
      const unsigned rel = r0 + unsigned(r) * unsigned(m);
      const float* c = bank_s + (rel % unsigned(l)) * taps;
      const float* v = span_s + (rel / unsigned(l) + taps - 1);  // tap k: v[-k]
      float acc = 0.0f;
      for (int k = 0; k < taps; ++k) acc = __fmaf_rn(v[-k], c[k], acc);
      const int q = __float2int_rn(acc);
      y[r] = int16_t(min(max(q, -32768), 32767));
    }
  }
}

}  // namespace

extern "C" int ljt_resample(const void* pcm, const void* bank, void* out,
                            int rows, int t, int out_len, int l, int m,
                            int taps, int chunk, int span, void* stream) {
  if (rows < 0 || t < 1 || out_len < 0 || l < 1 || m < 1 || taps < 1
      || chunk < 1 || span < taps)
    return int(cudaErrorInvalidValue);
  // the chunk's span must fit what is staged
  if (((long long)(chunk - 1) * m) / l + taps + 1 > span)
    return int(cudaErrorInvalidValue);
  if (rows == 0 || out_len == 0) return 0;
  const int smem = int(sizeof(float)) * (l * taps + span);
  if (smem > 48 * 1024
      && cudaFuncSetAttribute(resample_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) != cudaSuccess)
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms < 1)
    sms = 1;
  const long long chunks = (out_len + (long long)chunk - 1) / chunk;
  const long long items = chunks * rows;
  const long long most = 8LL * sms;
  const dim3 grid(unsigned(items < most ? items : most));
  resample_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<const float*>(bank),
      static_cast<int16_t*>(out), rows, t, out_len, l, m, taps, chunk);
  return int(cudaGetLastError());
}
