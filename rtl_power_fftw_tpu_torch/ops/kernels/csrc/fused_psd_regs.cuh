// The group kernel of K1, K2 and K4 (fused_psd.cu) as one template: the
// transform in registers (fft_regs.cuh), the next frame's bytes in flight.
//
// psd_regs_kernel<LOG2N, WINDOWED, CUT> is their first pass; fused_psd.cu
// instantiates the default CUT = kRegsFull. Two cuts are its
// stage-attribution probes (fused_psd_probe.cu), as fused_psd.cuh's are
// for the radix-2 kernel it replaced, three are the estimators' first
// passes (fused_psd_sk.cu, fused_psd_tapers.cu), and two store each
// frame's spectrum instead of summing it (fused_psd_frames.cu):
//
//   kRegsFull     the whole step;
//   kRegsDequant  load and dequantize; the output is the sum over frames
//                 of re + im of each sample n (no transform, no exchange);
//   kRegsNoFft    the step without the transform: the sum over frames of
//                 |x[n]|^2, in natural order;
//   kRegsSk       the whole step, and beside each |X|^2 sum in registers a
//                 sum of |X|^4: block g writes its |X|^2 row to partial row
//                 g, bit for bit kRegsFull's, and its |X|^4 row to row
//                 gridDim.x + g (two planes of gridDim.x rows);
//   kRegsSkPlane  kRegsSk with the |X|^4 sums out of registers: a thread's
//                 R sums live in its own slots of a shared-memory plane of
//                 LANES rows of N f32 after the ring (lane * PLANE_STRIDE
//                 + k * TF + t, conflict-free), each updated in place per
//                 frame with kRegsSk's expression, so both planes of
//                 partial rows are kRegsSk's bit for bit (PLANE_BYTES more
//                 shared memory);
//   kRegsTapers   the whole step windowed (WINDOWED) by row blockIdx.y of
//                 a (gridDim.y, N) table of tapers: block (g, k) writes
//                 partial row k * gridDim.x + g;
//   kRegsFrames   the transform of every valid frame f, its |X|^2 written
//                 as row f of an (F, N) f32 output (`partial`) in
//                 fftshifted bin order, (bin + N/2) & (N - 1); no sums;
//   kRegsFramesComplex  the same with X itself, unshifted, as row f of an
//                 (F, N) float2 output.
//
// The frame cuts stage each row through the lane's exchange buffer once
// the last pass is done with it (regs_frame_store): each thread writes its
// R slots there by bin, and the lane's threads then store the row
// coalesced, q = t, t + TF, .... Rows at or past n_valid are not written.
//
// A block is LANES frame lanes of TF = N / R threads (at least
// kRegsMinThreads threads a block, so LANES > 1 below N = 4096). Lane p of
// block g sums the frames f0 + p + LANES * i of the block's
// [f0, min(f0 + group, F, n_valid)). Each lane has two ring slots in
// shared memory for raw frames: while frame i is transformed, cp.async
// copies frame i + 1's bytes, 16 B a thread, into the other slot. A thread
// reads its R samples t + k*TF from the ring as u16 pairs, dequantizes
// them exactly in registers, and (K2) multiplies them by its R window
// values, held in registers for the whole block. |X|^2 of each of its R
// output slots is summed in f32 registers across the lane's frames; at the
// end the lanes' sums go to shared memory by bin and are added lane by
// lane in order, and the block writes its partial row coalesced.
//
// The transform after the load (regs_transform), the bin of each output
// slot (regs_slot_bin) and the lanes' row sum (regs_lane_sum) are device
// functions of their own: the polyphase filterbank's kernel
// (fused_psd_pfb.cu), whose load builds each frame from P rows, runs them
// too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_regs.cuh"

namespace {

constexpr int kRegsMinThreads = 256;

enum : int {
  kRegsFull = 0,
  kRegsDequant = 1,
  kRegsNoFft = 2,
  kRegsSk = 3,
  kRegsTapers = 4,
  kRegsSkPlane = 5,
  kRegsFrames = 6,
  kRegsFramesComplex = 7
};

template <int LOG2N>
struct RegsShape {
  using Plan = RegsPlan<LOG2N>;
  static constexpr int N = Plan::N;
  static constexpr int THREADS =
      Plan::TF < kRegsMinThreads ? kRegsMinThreads : Plan::TF;
  static constexpr int LANES = THREADS / Plan::TF;
  // A lane's exchange buffer, float2 elements, padded (pad_index).
  static constexpr int XSTRIDE = N + N / 16;
  // A lane's two ring slots of 2N bytes, and 32 bytes that put the lanes
  // of one warp (N <= 256) on different banks.
  static constexpr int RING_BYTES = 4 * N + 32;
  static constexpr int RING_OFFSET = LANES * XSTRIDE * 8;
  static constexpr int SMEM_BYTES = RING_OFFSET + LANES * RING_BYTES;
  // 16-byte copies a thread makes of each frame: 2N / 16 / TF.
  static constexpr int COPIES = Plan::R / 8;
  // kRegsSkPlane's |X|^4 sums, after the ring: a lane's N floats, and TF
  // more where a warp holds several lanes (TF < 32), which puts them on
  // other banks.
  static constexpr int PLANE_STRIDE = Plan::TF < 32 ? N + Plan::TF : N;
  static constexpr int PLANE_BYTES = LANES * PLANE_STRIDE * 4;
};

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// byte - 127 exactly, without a conversion instruction: 2^23 + byte as
// float bits, less 2^23 + 127.
__device__ __forceinline__ float dequant_byte(unsigned byte) {
  return __uint_as_float(0x4B000000u | byte) - 8388735.0f;
}

// The transform of a lane's frame in place, after its load into v (the
// thread's R samples t + k*TF): pass 0 from registers (butterfly t,
// outputs to t + k1 * TF of the lane's exchange buffer x), then passes 1
// .. PASSES - 1 through x, a barrier before each. Every thread of the block
// calls it; the threads of an inactive lane only meet the barriers. v ends
// as the thread's R output slots, slot k of bin regs_slot_bin(t, k).
template <int LOG2N>
__device__ __forceinline__ void regs_transform(
    float2 (&v)[RegsPlan<LOG2N>::R], float2* x, const float2* twiddle, int t,
    bool active) {
  using P = RegsPlan<LOG2N>;
  constexpr int R = P::R, TF = P::TF;
  if (active) {
    dif_regs<R>(v, 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k1 = rev_bits(r, log2_of(R));
      float2 y = v[r];
      if (k1 != 0) {
        const float2 w = __ldg(twiddle + k1 * TF + t);
        y = cmul(y, w.x, w.y);
      }
      x[pad_index(t + k1 * TF)] = y;
    }
  }
  __syncthreads();
  if (active) regs_pass<LOG2N, 1>(v, x, twiddle, t);
  if constexpr (P::PASSES > 2) {
    __syncthreads();
    if (active) regs_pass<LOG2N, 2>(v, x, twiddle, t);
  }
  if constexpr (P::PASSES > 3) {
    __syncthreads();
    if (active) regs_pass<LOG2N, 3>(v, x, twiddle, t);
  }
}

// The bin of thread t's output slot k after regs_transform: output
// rev_bits(k % RL) of last-pass butterfly b = t + (k / RL) * TF.
template <int LOG2N>
__device__ __forceinline__ int regs_slot_bin(int t, int k) {
  using P = RegsPlan<LOG2N>;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(LOG2N, LAST);
  constexpr int SL = P::span(LAST) / RL;
  const int b = t + (k / RL) * P::TF;
  const int q = (b / SL) * P::span(LAST) + (b % SL) +
                rev_bits(k % RL, log2_of(RL)) * SL;
  return pass_bin<LOG2N>(q);
}

// row[q] = the sum of the lanes' by-bin sums by_bin[l * N + q], added lane
// by lane in order; the block's threads take q = tid, tid + THREADS, ....
template <int LOG2N>
__device__ __forceinline__ void regs_lane_sum(const float* by_bin,
                                              float* row, int tid) {
  using S = RegsShape<LOG2N>;
  constexpr int N = S::N;
  for (int q = tid; q < N; q += S::THREADS) {
    float sum = by_bin[q];
#pragma unroll
    for (int l = 1; l < S::LANES; ++l) sum += by_bin[l * N + q];
    row[q] = sum;
  }
}

// The frame cuts' store of frame f's row (kRegsFrames: |X|^2 shifted, f32;
// kRegsFramesComplex: X, float2) from the thread's R output slots v,
// through the lane's exchange buffer x. Every thread of the block calls it
// (it meets two barriers); the threads of an inactive lane only meet them.
template <int LOG2N, int CUT>
__device__ __forceinline__ void regs_frame_store(
    const float2 (&v)[RegsPlan<LOG2N>::R], float2* x, void* out, int f,
    int t, bool active) {
  using P = RegsPlan<LOG2N>;
  constexpr int N = P::N, R = P::R, TF = P::TF;
  __syncthreads();   // every lane's last pass is done with its x
  if (active) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int bin = regs_slot_bin<LOG2N>(t, k);
      if constexpr (CUT == kRegsFrames) {
        reinterpret_cast<float*>(x)[(bin + N / 2) & (N - 1)] =
            v[k].x * v[k].x + v[k].y * v[k].y;
      } else {
        x[bin] = v[k];
      }
    }
  }
  __syncthreads();
  if (active) {
    if constexpr (CUT == kRegsFrames) {
      const float* src = reinterpret_cast<const float*>(x);
      float* row = static_cast<float*>(out) + static_cast<size_t>(f) * N;
      for (int q = t; q < N; q += TF) row[q] = src[q];
    } else {
      float2* row = static_cast<float2*>(out) + static_cast<size_t>(f) * N;
      for (int q = t; q < N; q += TF) row[q] = x[q];
    }
  }
}

// Pass 1: block g serves stream s = g / G_s (G_s blocks per stream; one
// stream for K1/K2) and sums |X|^2 of that stream's frames [j*group,
// min((j+1)*group, F, n_valid_s)), j = g mod G_s, into partial row g.
// n_valid_s is stream_n_valid[s] where that array is given (K4), else
// n_valid.
template <int LOG2N, bool WINDOWED, int CUT = kRegsFull>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_regs_kernel(const uint8_t* __restrict__ raw,     // (S*F, 2N), 16 B aligned
                const float2* __restrict__ twiddle,  // pass_twiddles(N)
                const float* __restrict__ window,    // (N,) or null
                float* __restrict__ partial,         // (S*G_s, N)
                int F, int group, int blocks_per_stream, int n_valid,
                const int* __restrict__ stream_n_valid) {  // (S,) or null
  using P = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = P::N, R = P::R, TF = P::TF;
  static_assert(P::span(P::PASSES) == 1, "the radices must multiply to N");
  static_assert(P::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  static_assert(CUT != kRegsTapers || WINDOWED, "a taper is a window");
  // The cuts that run the transform.
  constexpr bool FFT = CUT == kRegsFull || CUT == kRegsSk ||
                       CUT == kRegsTapers || CUT == kRegsSkPlane;
  // The cuts that also sum |X|^4.
  constexpr bool SK = CUT == kRegsSk || CUT == kRegsSkPlane;
  // The cuts that store each frame's spectrum.
  constexpr bool FRAMES = CUT == kRegsFrames || CUT == kRegsFramesComplex;
  extern __shared__ float4 regs_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(regs_smem) + lane * S::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(regs_smem) + S::RING_OFFSET +
                  lane * S::RING_BYTES;

  // K2: the window at the thread's R samples, for every frame of the
  // block.
  float win[WINDOWED ? R : 1];
  if constexpr (CUT == kRegsTapers) window += blockIdx.y * N;
  if constexpr (WINDOWED) {
#pragma unroll
    for (int k = 0; k < R; ++k) win[k] = __ldg(window + t + k * TF);
  }
  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;
  float acc2[CUT == kRegsSk ? R : 1];   // kRegsSk: the sums of |X|^4
  if constexpr (CUT == kRegsSk) {
#pragma unroll
    for (int k = 0; k < R; ++k) acc2[k] = 0.0f;
  }
  // kRegsSkPlane: the thread's sums of |X|^4, slot k at plane[k * TF].
  float* plane = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(regs_smem) + S::SMEM_BYTES) +
      lane * S::PLANE_STRIDE + t;
  if constexpr (CUT == kRegsSkPlane) {
#pragma unroll
    for (int k = 0; k < R; ++k) plane[k * TF] = 0.0f;
  }

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = stream_n_valid == nullptr ? n_valid
                                           : __ldg(stream_n_valid + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * N;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + S::LANES * i;
    if (i < iters && f < f1) {
      const uint8_t* src = frames + static_cast<size_t>(f) * 2 * N;
      uint8_t* dst = ring + (i & 1) * 2 * N;
#pragma unroll
      for (int c = 0; c < S::COPIES; ++c) {
        cp_async16(dst + 16 * (t + c * TF), src + 16 * (t + c * TF));
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const bool active = f0 + lane + S::LANES * i < f1;
    float2 v[R];
    if (active) {
      const uint16_t* iq = reinterpret_cast<const uint16_t*>(
          ring + (i & 1) * 2 * N);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const unsigned u = iq[t + k * TF];
        float re = dequant_byte(u & 0xFFu);
        float im = dequant_byte(u >> 8);
        if constexpr (WINDOWED) {
          re = __fmul_rn(re, win[k]);
          im = __fmul_rn(im, win[k]);
        }
        v[k] = make_float2(re, im);
      }
    }
    if constexpr (FRAMES) {
      regs_transform<LOG2N>(v, x, twiddle, t, active);
      regs_frame_store<LOG2N, CUT>(v, x, partial, f0 + lane + S::LANES * i,
                                   t, active);
      continue;
    }
    if constexpr (FFT) {
      regs_transform<LOG2N>(v, x, twiddle, t, active);
      if (active) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
        }
        if constexpr (CUT == kRegsSk) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const float p = v[k].x * v[k].x + v[k].y * v[k].y;
            acc2[k] += p * p;
          }
        }
        if constexpr (CUT == kRegsSkPlane) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const float p = v[k].x * v[k].x + v[k].y * v[k].y;
            plane[k * TF] += p * p;
          }
        }
      }
    } else {
      if (active) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          acc[k] += CUT == kRegsNoFft ? v[k].x * v[k].x + v[k].y * v[k].y
                                      : v[k].x + v[k].y;
        }
      }
      __syncthreads();   // the ring slot is rewritten next iteration
    }
  }
  cp_async_wait<0>();
  if constexpr (FRAMES) return;
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin, then added lane by lane in order (kRegsSk,
  // kRegsSkPlane: the |X|^4 sums by bin after them, in the exchange
  // buffers' room).
  float* by_bin = reinterpret_cast<float*>(regs_smem);   // (LANES, N)
  static_assert(2 * S::LANES * N * 4 <= S::RING_OFFSET, "two planes fit");
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // The transform's slot k, or (the cuts without one) sample t + k*TF.
    const int bin = FFT ? regs_slot_bin<LOG2N>(t, k) : t + k * TF;
    by_bin[lane * N + bin] = acc[k];
    if constexpr (CUT == kRegsSk) {
      by_bin[(S::LANES + lane) * N + bin] = acc2[k];
    }
    if constexpr (CUT == kRegsSkPlane) {
      by_bin[(S::LANES + lane) * N + bin] = plane[k * TF];
    }
  }
  __syncthreads();
  float* row = partial + static_cast<size_t>(blockIdx.x) * N;
  if constexpr (CUT == kRegsTapers) {
    row += static_cast<size_t>(blockIdx.y) * gridDim.x * N;
  }
  regs_lane_sum<LOG2N>(by_bin, row, tid);
  if constexpr (SK) {
    regs_lane_sum<LOG2N>(
        by_bin + S::LANES * N,
        partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * N, tid);
  }
}

}  // namespace
