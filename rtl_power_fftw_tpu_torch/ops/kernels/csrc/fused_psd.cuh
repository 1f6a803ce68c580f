// The group kernel of K1, K2 and K4 (fused_psd.cu) as one template.
//
// psd_group_kernel<LOG2N, WINDOWED, CUT> is their first pass; fused_psd.cu
// instantiates the default CUT = kK1Full, which compiles to the shipping
// kernel. The other cuts are the stage-attribution probes of
// fused_psd_probe.cu, P1's question (probes/profile_pallas.py:build)
// asked of K1: how long the load and dequantization, the transform, and
// the |X|^2 and sum each take.
//
//   kK1Full     the whole step;
//   kK1Dequant  load, dequantize and store to shared memory; the output
//               is the sum over frames of re + im of each sample n, kept
//               in registers (no transform, no read of shared memory);
//   kK1NoFft    the step without the transform (P1's `nomm` for K1): the
//               sum over frames of |x[n]|^2, in natural order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int LOG2N>
struct Shape {
  static constexpr int N = 1 << LOG2N;
  static constexpr int HALF = N / 2;
  static constexpr int THREADS = HALF < kMaxThreads ? HALF : kMaxThreads;
  static constexpr int PER_THREAD = N / THREADS;   // accumulated slots
};

enum : int { kK1Full = 0, kK1Dequant = 1, kK1NoFft = 2 };

// Pass 1: block g serves stream s = g / G_s (G_s blocks per stream; one
// stream for K1/K2) and transforms that stream's frames [j*group,
// min((j+1)*group, F, n_valid_s)), j = g mod G_s, one after another. It
// writes the f32 sum of their |X|^2 to partial row g. n_valid_s is
// stream_n_valid[s] where that array is given (K4), else n_valid.
template <int LOG2N, bool WINDOWED, int CUT = kK1Full>
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
  // kK1Dequant: re + im of samples 2w and 2w+1 of each word w.
  float dq[CUT == kK1Dequant ? WORDS : 1][2] = {};

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
      if constexpr (CUT == kK1Dequant) {
        dq[r][0] += q.x + q.y;
        dq[r][1] += q.z + q.w;
      }
      smem[w] = q;
    }
    __syncthreads();

    // Decimation in frequency: half-span m = N/2, N/4, ..., 1.
    if constexpr (CUT == kK1Full) dif_radix2<LOG2N, S::THREADS>(x, twiddle, tid);

    // Slot i now holds bin bit_reverse(i) (kK1NoFft: sample i).
    if constexpr (CUT != kK1Dequant) {
#pragma unroll
    for (int i = 0; i < S::PER_THREAD; ++i) {
      const float2 X = x[tid + i * S::THREADS];
      acc[i] += X.x * X.x + X.y * X.y;
    }
    }
    __syncthreads();   // the next frame's load overwrites x
  }

  float* row = partial + static_cast<size_t>(blockIdx.x) * S::N;
  if constexpr (CUT == kK1Full) {
#pragma unroll
  for (int i = 0; i < S::PER_THREAD; ++i) {
    row[bit_reverse<LOG2N>(tid + i * S::THREADS)] = acc[i];
  }
  } else if constexpr (CUT == kK1NoFft) {
#pragma unroll
    for (int i = 0; i < S::PER_THREAD; ++i) row[tid + i * S::THREADS] = acc[i];
  } else {
#pragma unroll
    for (int r = 0; r < WORDS; ++r) {
      reinterpret_cast<float2*>(row)[tid + r * S::THREADS] =
          make_float2(dq[r][0], dq[r][1]);
    }
  }
}

}  // namespace
