// Fused averaged-PSD device step for NVIDIA Hopper (sm_90a).
//
// Replaces rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn,
// the single-stream variant at default precision, unwindowed (K1) and
// windowed (K2). It computes the same function: raw interleaved u8 IQ
// frames (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in FP32]
// -> length-N DFT -> |X|^2 -> drop frames f >= n_valid -> sum over
// frames, as an (N,) float32 vector of bins in natural (unshifted) order.
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
//    shared memory. It takes input in natural order (no bank-conflicting
//    bit-reversed scatter on the load) and leaves bins bit-reversed; each
//    thread accumulates |X|^2 of fixed shared-memory slots in registers
//    across frames and un-reverses the bin index only once per block,
//    when it writes its partial row;
//  * twiddles come from a per-stage table (stage with half-span m holds
//    W_{2m}^k, k < m, at offset m - 1) so neighbouring threads read
//    neighbouring addresses; the table is computed on the host in
//    float64 and rounded once to float32 (no fast-math, no __sinf);
//  * no float atomics: block g writes the f32 sum of its frames to
//    partial row g, and a second kernel (psd_sum.cuh) sums the G rows of
//    each bin in a fixed order in float64, so the result is the same on
//    every run.
//
// Eligibility (Hopper facts): power-of-two N with 64 <= N <= 16384. The
// complex f32 frame lives in shared memory, 8N bytes: 128 KB at 16384,
// which needs the opt-in above 48 KB (cudaFuncSetAttribute) and fits the
// 227 KB a block may use; 32768 (256 KB) does not. At N = 64 the N/2
// butterflies of a stage fill exactly one warp.
//
// Tensor-core forms (the DFT as matrix products, as the TPU kernel does)
// are in fused_psd_fast.cu for the relaxed tier; overlapping the next
// frame's load with the current transform is later work.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int LOG2N>
__device__ __forceinline__ int bit_reverse(int i) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - LOG2N));
}

// Pass 1: block g transforms frames [g*group, min((g+1)*group, F, n_valid))
// one after another and writes the f32 sum of their |X|^2 to partial row g.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(Shape<LOG2N>::THREADS)
psd_group_kernel(const uint32_t* __restrict__ raw,     // (F, N/2) words
                 const float2* __restrict__ twiddle,   // (N - 1,) per stage
                 const float2* __restrict__ window,    // (N/2,) or null
                 float* __restrict__ partial,          // (G, N)
                 int F, int group, int n_valid) {
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

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  for (int f = f0; f < f1; ++f) {
    // Word w holds samples 2w and 2w+1 as bytes (re, im, re, im).
    const uint32_t* frame = raw + static_cast<size_t>(f) * S::HALF;
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
#pragma unroll
    for (int s = LOG2N - 1; s >= 0; --s) {
      const int m = 1 << s;
      const float2* tw = twiddle + (m - 1);
#pragma unroll
      for (int r = 0; r < S::HALF / S::THREADS; ++r) {
        const int j = tid + r * S::THREADS;
        const int k = j & (m - 1);
        const int i0 = ((j >> s) << (s + 1)) + k;
        const int i1 = i0 + m;
        const float2 a = x[i0];
        const float2 b = x[i1];
        const float2 w = __ldg(tw + k);
        const float dr = a.x - b.x;
        const float di = a.y - b.y;
        x[i0] = make_float2(a.x + b.x, a.y + b.y);
        x[i1] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
      }
      __syncthreads();
    }

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
                          int group, int G, int n_valid, cudaStream_t stream) {
  using S = Shape<LOG2N>;
  const int smem = static_cast<int>(sizeof(float2)) * S::N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psd_group_kernel<LOG2N, WINDOWED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  psd_group_kernel<LOG2N, WINDOWED><<<G, S::THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float2*>(window), static_cast<float*>(partial), F,
      group, n_valid);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int G, int n_valid, cudaStream_t stream) {
  return window == nullptr
             ? launch_groups<LOG2N, false>(raw, twiddle, window, partial, F,
                                           group, G, n_valid, stream)
             : launch_groups<LOG2N, true>(raw, twiddle, window, partial, F,
                                          group, G, n_valid, stream);
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 6: e = launch_groups<6>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 7: e = launch_groups<7>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 8: e = launch_groups<8>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 9: e = launch_groups<9>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 10: e = launch_groups<10>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 11: e = launch_groups<11>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 12: e = launch_groups<12>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 13: e = launch_groups<13>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    case 14: e = launch_groups<14>(raw, twiddle, window, partial, F, group, G, n_valid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G, 1 << log2n, out, s));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
