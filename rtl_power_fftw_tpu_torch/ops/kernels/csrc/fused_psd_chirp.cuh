// The chirp-Z (Bluestein) group kernel of fused_psd_mixed.cu, on the
// register FFT of K1 (fft_regs.cuh): psd_chirp_kernel<LOG2M, WINDOWED>.
//
// X[k] = a[k] IFFT_M(FFT_M(x a) B)[k], a the chirp e^(-i pi n^2 / N),
// B = FFT_M of its conjugate laid out circularly, M = 2^LOG2M >= 2N - 1
// (at least 64, the register FFT's smallest size). Both M-point transforms
// run by K1's pass plan (pass_radix): M / R_0 threads a frame, R_0 values
// each in registers, one exchange through the lane's padded buffer
// between passes.
//
// Per frame, on thread t of a lane:
//  * pass 0 from the ring: the thread's samples s = t + k*TF, k < R_0 / 2
//    (the upper half of the frame is zero: N <= M / 2), dequantized
//    exactly, times the f32 window, then times a[s] (the order of
//    bluestein_psd_partial), zero at s >= N; its first radix-2 stage is
//    the half-zero stage; then the forward passes (regs_pass);
//  * the turn, in registers, on the last forward pass's outputs (element
//    q = b*R_L + k1 of butterfly b): times spectrum[q] (B / M in the
//    forward transform's element order, fused_psd_bluestein.spectrum_table
//    of this plan), conjugated, then the same butterfly again (the first
//    transposed pass, which has no twiddles), written back;
//  * the transposed passes down to pass 0 (regs_pass_t): the inverse of a
//    digit-reversed vector in natural order, conjugated, whose |.|^2 is
//    the power (|a[k]| = 1, so the last chirp is not applied). Pass 0's
//    outputs t + k1*TF belong to thread t in every frame, so |X|^2 of its
//    k1 < R_0 / 2 outputs is summed in f32 registers across the lane's
//    frames; bins >= N are dropped when the row is written.
//
// A block is LANES frame lanes of TF threads (K1's RegsShape: at least
// 256 threads). Lane p of block g sums the frames f0 + p + LANES * i of the
// block's [f0, min(f0 + group, F, n_valid)), its next frame in flight in
// its ring (frame_ring.cuh). At the end the lanes' sums go to shared memory
// by bin and are added lane by lane in order; the block writes its partial
// row (N rounded up to 32 floats, the rest 0) for psd_sum.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_mixed.cuh"  // cmulf, norm2
#include "fft_regs.cuh"
#include "frame_ring.cuh"

namespace {

template <int LOG2M>
struct ChirpShape {
  using Plan = RegsPlan<LOG2M>;
  static constexpr int M = Plan::N;
  static constexpr int R = Plan::R;
  static constexpr int TF = Plan::TF;
  static constexpr int THREADS =
      TF < kRegsMinThreads ? kRegsMinThreads : TF;
  static constexpr int LANES = THREADS / TF;
  // A lane's exchange buffer, float2 elements, padded (pad_index).
  static constexpr int XSTRIDE = M + M / 16;
  // The slots t + k*TF that may hold a sample: k < R / 2, as N <= M / 2.
  static constexpr int HALF = R / 2;
  // 256-thread blocks aim at K1's three an SM (at most 85 registers).
  static constexpr int MIN_BLOCKS = THREADS == kRegsMinThreads ? 3 : 1;
};

// The turn's inputs of one last-pass butterfly: input K is the value at
// element base + K, which the forward butterfly left in v[off +
// rev_bits(K)], times its spectrum entry, conjugated.
template <int RL, int K = 0, int R>
__device__ __forceinline__ void turn_inputs(float2 (&u)[RL],
                                            const float2 (&v)[R], int off,
                                            const float2* __restrict__ spec) {
  if constexpr (K < RL) {
    constexpr int r = rev_bits(K, log2_of(RL));
    const float2 y = cmulf(v[off + r], __ldg(spec + K));
    u[K] = make_float2(y.x, -y.y);
    turn_inputs<RL, K + 1>(u, v, off, spec);
  }
}

// |.|^2 of pass 0's outputs K < R / 2 (elements t + K*TF, in v[rev_bits(K)])
// added to acc[K].
template <int R, int K = 0>
__device__ __forceinline__ void add_half_power(float (&acc)[R / 2],
                                               const float2 (&v)[R]) {
  if constexpr (K < R / 2) {
    constexpr int r = rev_bits(K, log2_of(R));
    acc[K] += norm2(v[r]);
    add_half_power<R, K + 1>(acc, v);
  }
}

// Shared bytes of a block at N = bins: the lanes' exchange buffers, then
// their rings.
template <int LOG2M>
__host__ __device__ constexpr int chirp_smem_bytes(int bins) {
  using C = ChirpShape<LOG2M>;
  return C::LANES * (C::XSTRIDE * 8 + ring_bytes(bins));
}

// The chirp-Z kernel's M = 2^log2m (a register FFT's size) takes N = bins:
// even, 2N - 1 <= M, and M at most 64 where 2N - 1 <= 64 (the smallest
// register FFT), else the least power of two.
inline bool chirp_size_ok(int log2m, int bins) {
  if (log2m < kRegsMinLog2N || log2m > kRegsMaxLog2N || bins < 2 ||
      bins % 2 != 0) {
    return false;
  }
  const int M = 1 << log2m;
  return 2 * bins - 1 <= M && (M == 64 || 2 * bins - 1 > M / 2);
}

// Pass 1 of the step: block g serves stream s = g / G_s (one stream for
// the single-stream entry) and sums |X|^2 of that stream's frames
// [j*group, min((j+1)*group, F, n_valid_s)), j = g mod G_s, into partial
// row g. n_valid_s is stream_n_valid[s] where that array is given, else
// n_valid.
template <int LOG2M, bool WINDOWED>
__global__ void __launch_bounds__(ChirpShape<LOG2M>::THREADS,
                                  ChirpShape<LOG2M>::MIN_BLOCKS)
psd_chirp_kernel(const uint8_t* __restrict__ raw,      // (S*F, 2N)
                 const float2* __restrict__ twiddle,   // pass_twiddles(M)
                 const float* __restrict__ window,     // (N,) or null
                 const float2* __restrict__ chirp,     // (N,) a
                 const float2* __restrict__ spectrum,  // (M,) B / M
                 float* __restrict__ partial,          // (S*G_s, row)
                 int bins, int row, int width, int F, int group,
                 int blocks_per_stream, int n_valid,
                 const int* __restrict__ stream_n_valid) {
  using P = RegsPlan<LOG2M>;
  using C = ChirpShape<LOG2M>;
  constexpr int R = P::R, TF = P::TF, HALF = C::HALF;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(LOG2M, LAST);
  constexpr int BL = log2_of(RL);
  static_assert(P::PASSES >= 2, "the turn is the last pass's butterfly, "
                "and a ring slot is rewritten only after the barrier that "
                "ends pass 0");
  extern __shared__ float4 chirp_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  const int slot = ring_slot(bins);
  float2* x = reinterpret_cast<float2*>(chirp_smem) + lane * C::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(chirp_smem) +
                  C::LANES * C::XSTRIDE * 8 + lane * ring_bytes(bins);

  // The window at the thread's samples, held in registers for the whole
  // block where a thread has registers to spare (below 1024 threads).
  constexpr bool HOLD = WINDOWED && C::THREADS < 1024;
  float win[HOLD ? HALF : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const int s = t + k * TF;
      win[k] = s < bins ? __ldg(window + s) : 0.0f;
    }
  }
  float acc[HALF];
#pragma unroll
  for (int k = 0; k < HALF; ++k) acc[k] = 0.0f;

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = stream_n_valid == nullptr ? n_valid
                                           : __ldg(stream_n_valid + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + C::LANES - 1) / C::LANES;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * bins;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + C::LANES * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot,
                frames + static_cast<size_t>(f) * 2 * bins, 2 * bins, width,
                t, TF);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (pass 0 of frame i-1)
    const bool active = f0 + lane + C::LANES * i < f1;
    float2 v[R];
    if (active) {
      const uint16_t* iq =
          reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const int s = t + k * TF;
        float2 y = make_float2(0.0f, 0.0f);
        if (s < bins) {
          float w = 0.0f;
          if constexpr (HOLD) {
            w = win[k];
          } else if constexpr (WINDOWED) {
            w = __ldg(window + s);
          }
          y = cmulf(ring_sample<WINDOWED>(iq, s, w), __ldg(chirp + s));
        }
        v[k] = y;
      }
      // Pass 0 from registers: butterfly t, outputs to t + k1 * TF.
      dif_stage_half_zero<R>(v);
      dif_regs<R, R / 4>(v, 0);
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
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      // The last forward pass leaves output rev_bits(r) of butterfly
      // b = t + i2*TF in v[i2*RL + r]: element b*RL + rev_bits(r).
      regs_pass<LOG2M, LAST>(v, x, twiddle, t);
#pragma unroll
      for (int i2 = 0; i2 < R / RL; ++i2) {
        const int base = (t + i2 * TF) * RL;
        float2 u[RL];
        turn_inputs<RL>(u, v, i2 * RL, spectrum + base);
        dif_regs<RL>(u, 0);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          x[pad_index(base + rev_bits(r, BL))] = u[r];
        }
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass_t<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass_t<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      regs_pass_t<LOG2M, 0>(v, x, twiddle, t);
      add_half_power<R>(acc, v);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin, then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(chirp_smem);   // (LANES, row)
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const int bin = t + k * TF;
    if (bin < bins) by_bin[lane * row + bin] = acc[k];
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * row;
  for (int q = tid; q < row; q += C::THREADS) {
    float sum = 0.0f;
    if (q < bins) {
      sum = by_bin[q];
#pragma unroll
      for (int l = 1; l < C::LANES; ++l) sum += by_bin[l * row + q];
    }
    out[q] = sum;
  }
}

}  // namespace
