// Cross-spectral sums of two streams for NVIDIA Hopper (sm_90a): "CSD".
//
// Replaces the device step of rtl_power_fftw_tpu/models/coherence.py
// (_csd_step, 29-53; XLA there, no Pallas kernel). Two streams of raw
// interleaved u8 IQ frames, (F, 2N) each -> dequantize (u8 - 127) ->
// [times window[n] in FP32] -> X = DFT(x_f), Y = DFT(y_f) -> over the
// valid frames f < n_valid, four sums in float32, natural bin order:
//
//   plane 0  sum |X|^2          plane 2  sum Re(X conj Y)
//   plane 1  sum |Y|^2          plane 3  sum Im(X conj Y)
//
// as a (4, N) f32 output.
//
// The design is K1's (fused_psd_regs.cuh): lanes of TF threads, the
// transform in registers (regs_transform), the next frame's bytes in
// flight by cp.async into a two-slot ring. A lane runs stream x's frame f
// and then stream y's frame f through the same threads, so each thread
// holds the same bins of X and of Y: the lane's sequence of frames is x_f,
// y_f, x_f', y_f', ..., and the ring alternates between the two streams.
// X is parked in the thread's registers while Y is transformed; the four
// sums stay in registers (4 R floats a thread). At the end the lanes' sums
// go by bin through shared memory plane after plane and are added lane by
// lane in order into four planes of partial rows, one row a block (plane p
// row g at (p G + g) N), and psd_sum.cuh's float64 row sum gives each
// plane its output row: frames summed within a block's group, a divisor
// of the two-stage sum's chunk, then over the groups, as the JAX step's
// tree (g, chunk) sums them.
//
// Registers: 32 of them hold X and 64 the sums beside K1's. Up to 4096
// bins (256 threads a block) they fit; at 8192 and 16384, whose blocks
// are 512 and 1024 threads, ptxas spills what the block's register budget
// does not hold (chip_smoke.py prints the registers and spill of every
// instantiation).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kPlanes = 4;

// Block g sums frames [g * group, min((g + 1) * group, F, n_valid)) of
// both streams into partial rows (p * gridDim.x + g), p < 4; lane l takes
// frames g * group + l + LANES * j.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_csd_kernel(const uint8_t* __restrict__ raw_x,    // (F, 2N), 16 B aligned
               const uint8_t* __restrict__ raw_y,    // (F, 2N), 16 B aligned
               const float2* __restrict__ twiddle,   // pass_twiddles(N)
               const float* __restrict__ window,     // (N,) or null
               float* __restrict__ partial,          // (4, G, N)
               int F, int group, int n_valid) {
  using P = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = P::N, R = P::R, TF = P::TF;
  static_assert(P::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 csd_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(csd_smem) + lane * S::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(csd_smem) + S::RING_OFFSET +
                  lane * S::RING_BYTES;

  float win[WINDOWED ? R : 1];
  if constexpr (WINDOWED) {
#pragma unroll
    for (int k = 0; k < R; ++k) win[k] = __ldg(window + t + k * TF);
  }
  float acc[kPlanes][R];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int k = 0; k < R; ++k) acc[p][k] = 0.0f;
  }
  float2 px[R];   // X of the lane's current frame

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int pairs = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  const int iters = 2 * pairs;

  // Lane step i (stream i & 1, frame f0 + lane + LANES (i / 2)) into ring
  // slot i & 1 (an empty group past the lane's last frame, so that every
  // thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + S::LANES * (i >> 1);
    if (i < iters && f < f1) {
      const uint8_t* src =
          ((i & 1) ? raw_y : raw_x) + static_cast<size_t>(f) * 2 * N;
      uint8_t* dst = ring + (i & 1) * 2 * N;
#pragma unroll
      for (int c = 0; c < S::COPIES; ++c) {
        cp_async16(dst + 16 * (t + c * TF), src + 16 * (t + c * TF));
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int j = 0; j < pairs; ++j) {
    const bool active = f0 + lane + S::LANES * j < f1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // h = 0: stream x, 1: stream y
      prefetch(2 * j + h + 1);
      cp_async_wait<1>();   // this thread's copies of step 2j + h landed
      __syncthreads();      // everyone's; x is free (the last pass is done)
      float2 v[R];
      if (active) {
        const uint16_t* iq =
            reinterpret_cast<const uint16_t*>(ring + h * 2 * N);
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
      regs_transform<LOG2N>(v, x, twiddle, t, active);
      if (active) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          acc[h][k] += v[k].x * v[k].x + v[k].y * v[k].y;
          if (h == 0) {
            px[k] = v[k];
          } else {
            acc[2][k] += px[k].x * v[k].x + px[k].y * v[k].y;
            acc[3][k] += px[k].y * v[k].x - px[k].x * v[k].y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // Each plane: the lanes' sums by bin, then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(csd_smem);   // (LANES, N)
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      by_bin[lane * N + regs_slot_bin<LOG2N>(t, k)] = acc[p][k];
    }
    __syncthreads();
    regs_lane_sum<LOG2N>(
        by_bin,
        partial + (static_cast<size_t>(p) * gridDim.x + blockIdx.x) * N, tid);
    __syncthreads();   // by_bin is rewritten by the next plane
  }
}

template <int LOG2N, bool WINDOWED>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_csd_kernel<LOG2N, WINDOWED>,
                     RegsShape<LOG2N>::SMEM_BYTES, device, done);
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch(const void* raw_x, const void* raw_y, const void* twiddle,
                   const void* window, void* partial, int F, int group,
                   int blocks, int n_valid, int device, cudaStream_t stream) {
  const cudaError_t e = prepare<LOG2N, WINDOWED>(device);
  if (e != cudaSuccess) return e;
  psd_csd_kernel<LOG2N, WINDOWED>
      <<<blocks, RegsShape<LOG2N>::THREADS, RegsShape<LOG2N>::SMEM_BYTES,
         stream>>>(static_cast<const uint8_t*>(raw_x),
                   static_cast<const uint8_t*>(raw_y),
                   static_cast<const float2*>(twiddle),
                   static_cast<const float*>(window),
                   static_cast<float*>(partial), F, group, n_valid);
  return cudaGetLastError();
}

template <int LOG2N, bool WINDOWED>
cudaError_t attributes(int device, int* attrs) {
  const cudaError_t e = prepare<LOG2N, WINDOWED>(device);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_csd_kernel<LOG2N, WINDOWED>,
                           RegsShape<LOG2N>::THREADS,
                           RegsShape<LOG2N>::SMEM_BYTES, attrs);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw_x, raw_y: (F, 2N) u8 each, 16-byte
// aligned; twiddle: pass_twiddles(N), (rows, 2) f32; window: (N,) f32, or
// null; partial: (4, ceil(F / group), N) f32 scratch; out: (4, N) f32, the
// planes sum |X|^2, sum |Y|^2, sum Re(X conj Y), sum Im(X conj Y) over the
// frames f < n_valid. Returns a cudaError_t (0 on success); does not
// synchronise.
int rpf_fused_psd_csd(const void* raw_x, const void* raw_y,
                      const void* twiddle, const void* window, void* partial,
                      void* out, int device, int log2n, int F, int group,
                      int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (F + group - 1) / group;
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = window == nullptr                                                   \
            ? launch<L, false>(raw_x, raw_y, twiddle, window, partial, F,   \
                               group, blocks, n_valid, device, st)          \
            : launch<L, true>(raw_x, raw_y, twiddle, window, partial, F,    \
                              group, blocks, n_valid, device, st);          \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_psd_sum(partial, blocks, 1 << log2n, out, st, kPlanes));
}

// What the kernel gets at N = 2^log2n (windowed or not) on `device`:
// attrs[0..5] as fused_psd.cu's rpf_fused_psd_attributes. Launches
// nothing.
int rpf_fused_psd_csd_attributes(int log2n, int windowed, int device,
                                 int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = windowed ? attributes<L, true>(device, attrs)                        \
                 : attributes<L, false>(device, attrs);                      \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
