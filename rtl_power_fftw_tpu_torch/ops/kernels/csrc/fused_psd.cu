// Fused averaged-PSD device step for NVIDIA Hopper (sm_90a).
//
// Replaces rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn
// at default precision: single-stream unwindowed (K1) and windowed (K2),
// and the streams variant of either (K4, streams=S>1). It computes the
// same function: raw interleaved u8 IQ frames (F, 2N) -> dequantize
// (u8 - 127) -> [times window[n] in FP32] -> length-N DFT -> |X|^2 ->
// drop frames f >= n_valid -> sum over frames, as an (N,) float32 vector
// of bins in natural (unshifted) order. K4 takes S streams of F frames
// each, (S*F, 2N), with a count n_valid[s] per stream, and gives one such
// vector per stream, (S, N).
//
// What bounds it on an H100. A radix-2 FFT of length N costs about
// 5 N log2(N) FP32 flops per frame against 2N bytes read from device
// memory: ~27 flop/byte at N = 2048, above the ~20 flop/byte where the
// FP32 CUDA cores stop being fed by 3.35 TB/s. Each radix-2 butterfly
// also moves 32 bytes through shared memory (two complex loads, two
// stores) for ~10 flops, so shared-memory bandwidth and the barrier
// after each of the log2(N) stages bound this kernel, not device memory.
//
// What the design does about it:
//  * device memory is touched once per input byte: each frame is read
//    coalesced as 32-bit words (two IQ pairs), dequantized in registers
//    and stored to shared memory as one 16-byte vector per thread;
//  * the window (K2) costs no memory traffic per frame: a thread loads
//    the same words w in every frame, so it loads its window values
//    (samples 2w and 2w+1, one float2 per word) into registers once per
//    block and multiplies in registers before the store. The windowed
//    and unwindowed kernels are two instantiations of one template, so
//    a null window compiles to the K1 code unchanged;
//  * the FFT is an in-place decimation-in-frequency radix-2 transform in
//    shared memory (fft_radix2.cuh, shared with fused_psd_large.cu). It
//    takes input in natural order (no bank-conflicting bit-reversed
//    scatter on the load) and leaves bins bit-reversed; each thread
//    accumulates |X|^2 of fixed shared-memory slots in registers across
//    frames and un-reverses the bin index only once per block, when it
//    writes its partial row;
//  * twiddles come from a per-stage table (stage with half-span m holds
//    W_{2m}^k, k < m, at offset m - 1) so neighbouring threads read
//    neighbouring addresses; the table is computed on the host in
//    float64 and rounded once to float32 (no fast-math, no __sinf);
//  * no float atomics: block g writes the f32 sum of its frames to
//    partial row g, and a second kernel (psd_sum.cuh) sums the G rows of
//    each bin in a fixed order in float64, so the result is the same on
//    every run;
//  * streams (K4) are a different split of the same grid, not another
//    kernel: block g serves stream g / G_s and its frames never cross a
//    stream (the wrapper takes a group that divides F), so stream s owns
//    partial rows [s*G_s, (s+1)*G_s) and the sum pass gives it its own
//    row of the output. The per-stream counts are an (S,) device array
//    each block reads once, since --streams has no upper bound.
//
// Eligibility (Hopper facts): power-of-two N with 64 <= N <= 16384. The
// complex f32 frame lives in shared memory, 8N bytes: 128 KB at 16384,
// which needs the opt-in above 48 KB (cudaFuncSetAttribute) and fits the
// 227 KB a block may use; 32768 (256 KB) does not, and larger N go to the
// two-pass four-step of fused_psd_large.cu. At N = 64 the N/2 butterflies
// of a stage fill exactly one warp.
//
// Tensor-core forms (the DFT as matrix products, as the TPU kernel does)
// are in fused_psd_fast.cu for the relaxed tier; overlapping the next
// frame's load with the current transform is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kMaxThreads = 512;

template <int LOG2N>
struct Shape {
  static constexpr int N = 1 << LOG2N;
  static constexpr int HALF = N / 2;
  static constexpr int THREADS = HALF < kMaxThreads ? HALF : kMaxThreads;
  static constexpr int PER_THREAD = N / THREADS;   // accumulated slots
};

// Pass 1: block g serves stream s = g / G_s (G_s blocks per stream; one
// stream for K1/K2) and transforms that stream's frames [j*group,
// min((j+1)*group, F, n_valid_s)), j = g mod G_s, one after another. It
// writes the f32 sum of their |X|^2 to partial row g. n_valid_s is
// stream_n_valid[s] where that array is given (K4), else n_valid.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(Shape<LOG2N>::THREADS)
psd_group_kernel(const uint32_t* __restrict__ raw,     // (S*F, N/2) words
                 const float2* __restrict__ twiddle,   // (N - 1,) per stage
                 const float2* __restrict__ window,    // (N/2,) or null
                 float* __restrict__ partial,          // (S*G_s, N)
                 int F, int group, int blocks_per_stream, int n_valid,
                 const int* __restrict__ stream_n_valid) {  // (S,) or null
  using S = Shape<LOG2N>;
  constexpr int WORDS = S::HALF / S::THREADS;          // words per thread
  extern __shared__ float4 smem[];
  float2* x = reinterpret_cast<float2*>(smem);         // (N,) complex
  const int tid = threadIdx.x;

  // K2: window values of samples 2w and 2w+1 for each word w this thread
  // loads, held in registers across all frames of the block.
  float2 win[WINDOWED ? WORDS : 1];
  if constexpr (WINDOWED) {
#pragma unroll
    for (int r = 0; r < WORDS; ++r) win[r] = __ldg(window + tid + r * S::THREADS);
  }

  float acc[S::PER_THREAD];
#pragma unroll
  for (int i = 0; i < S::PER_THREAD; ++i) acc[i] = 0.0f;

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = stream_n_valid == nullptr ? n_valid
                                           : __ldg(stream_n_valid + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const uint32_t* frames = raw + static_cast<size_t>(stream) * F * S::HALF;
  for (int f = f0; f < f1; ++f) {
    // Word w holds samples 2w and 2w+1 as bytes (re, im, re, im).
    const uint32_t* frame = frames + static_cast<size_t>(f) * S::HALF;
#pragma unroll
    for (int r = 0; r < WORDS; ++r) {
      const int w = tid + r * S::THREADS;
      const uint32_t v = __ldg(frame + w);
      float4 q = make_float4(static_cast<float>(static_cast<int>(v & 0xFFu) - 127),
                             static_cast<float>(static_cast<int>((v >> 8) & 0xFFu) - 127),
                             static_cast<float>(static_cast<int>((v >> 16) & 0xFFu) - 127),
                             static_cast<float>(static_cast<int>(v >> 24) - 127));
      if constexpr (WINDOWED) {
        q.x = __fmul_rn(q.x, win[r].x);
        q.y = __fmul_rn(q.y, win[r].x);
        q.z = __fmul_rn(q.z, win[r].y);
        q.w = __fmul_rn(q.w, win[r].y);
      }
      smem[w] = q;
    }
    __syncthreads();

    // Decimation in frequency: half-span m = N/2, N/4, ..., 1.
    dif_radix2<LOG2N, S::THREADS>(x, twiddle, tid);

    // Slot i now holds bin bit_reverse(i).
#pragma unroll
    for (int i = 0; i < S::PER_THREAD; ++i) {
      const float2 X = x[tid + i * S::THREADS];
      acc[i] += X.x * X.x + X.y * X.y;
    }
    __syncthreads();   // the next frame's load overwrites x
  }

  float* row = partial + static_cast<size_t>(blockIdx.x) * S::N;
#pragma unroll
  for (int i = 0; i < S::PER_THREAD; ++i) {
    row[bit_reverse<LOG2N>(tid + i * S::THREADS)] = acc[i];
  }
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int G_s, int blocks, int n_valid,
                          const void* stream_n_valid, cudaStream_t stream) {
  using S = Shape<LOG2N>;
  const int smem = static_cast<int>(sizeof(float2)) * S::N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psd_group_kernel<LOG2N, WINDOWED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  psd_group_kernel<LOG2N, WINDOWED><<<blocks, S::THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float2*>(window), static_cast<float*>(partial), F,
      group, G_s, n_valid, static_cast<const int*>(stream_n_valid));
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int G_s, int blocks, int n_valid,
                          const void* stream_n_valid, cudaStream_t stream) {
  return window == nullptr
             ? launch_groups<LOG2N, false>(raw, twiddle, window, partial, F,
                                           group, G_s, blocks, n_valid,
                                           stream_n_valid, stream)
             : launch_groups<LOG2N, true>(raw, twiddle, window, partial, F,
                                          group, G_s, blocks, n_valid,
                                          stream_n_valid, stream);
}

// Both passes for S streams of F frames, G_s blocks per stream.
int launch_both(const void* raw, const void* twiddle, const void* window,
                const void* stream_n_valid, void* partial, void* out,
                int device, int log2n, int S, int F, int group, int G_s,
                int n_valid, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = S * G_s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_groups<L>(raw, twiddle, window, partial, F, group, G_s,      \
                         blocks, n_valid, stream_n_valid, st);              \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G_s, 1 << log2n, out, st, S));
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 4-byte aligned;
// twiddle: (N - 1, 2) f32; window: (N,) f32, 8-byte aligned, or null for
// K1; partial: (ceil(F / group), N) f32 scratch; out: (N,) f32. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd(const void* raw, const void* twiddle, const void* window,
                  void* partial, void* out, int device, int log2n, int F,
                  int group, int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_both(raw, twiddle, window, nullptr, partial, out, device,
                     log2n, 1, F, group, (F + group - 1) / group, n_valid,
                     stream);
}

// K4: S streams of F frames. raw: (S*F, 2N) u8, 4-byte aligned, stream s
// in rows [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read by the
// kernel when it runs (a count outside [0, F] acts as its nearest bound);
// group must divide F; partial: (S*F/group, N) f32 scratch; out: (S, N)
// f32. Other arguments as rpf_fused_psd.
int rpf_fused_psd_streams(const void* raw, const void* twiddle,
                          const void* window, const void* n_valid,
                          void* partial, void* out, int device, int log2n,
                          int S, int F, int group, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || F <= 0 ||
      group <= 0 || F % group != 0 || n_valid == nullptr ||
      static_cast<long long>(S) * (F / group) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_both(raw, twiddle, window, n_valid, partial, out, device,
                     log2n, S, F, group, F / group, 0, stream);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
