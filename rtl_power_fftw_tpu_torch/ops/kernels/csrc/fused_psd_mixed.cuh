// The group kernel of the awkward-N fused PSD steps (fused_psd_mixed.cu),
// as one template: psd_mixed_kernel<false, WINDOWED> is the mixed-radix
// kernel (7-smooth N, the DFT of each frame by the passes of
// fft_mixed.cuh), psd_mixed_kernel<true, WINDOWED> the chirp-Z kernel (any
// even N, the DFT as one circular convolution of power-of-two length
// M >= 2N - 1).
//
// A block is LANES frame lanes of TF threads (the plan's, from the
// wrapper). Lane p of block g sums the frames f0 + p + LANES * i of the
// block's [f0, min(f0 + group, F, n_valid)). A thread reads its first
// pass's samples straight from device memory as u16 pairs (a frame is 2N
// bytes, so only 4-byte aligned at N = 2 * odd: no 16-byte copies),
// dequantizes them exactly (u8 - 127 by float bits) and times the f32
// window where there is one; the chirp-Z kernel then multiplies them by
// its complex table a (the chirp e^(-i pi n^2 / N)) and takes the
// elements n >= N as 0. The
// first pass runs on those values in registers; the later passes go
// through the lane's padded exchange buffer in shared memory, one block
// barrier between passes. |X|^2 of each output is added to the lane's
// f32 accumulator in shared memory at its element; at the end the lanes'
// sums are added lane by lane in order for each bin and the block writes
// its partial row (N rounded up to 32 floats, the rest 0) for
// psd_sum.cuh.
//
// The chirp-Z kernel (Bluestein): X[k] = a[k] * IFFT_M(FFT_M(x a) * B)[k]
// with B = FFT_M(v), v the conjugate chirp laid out circularly. Its
// forward transform is the decimation in frequency over M, so FFT_M(x a)
// is left in digit-reversed element order; the table ``spectrum`` holds
// B / M in that same order (the wrapper permutes it). The
// inverse transform of a digit-reversed vector is the conjugate of the
// transposed passes (fft_mixed.cuh) run on its conjugate; |X[k]|^2 needs
// neither the last conjugate nor the last chirp (|a[k]| = 1). So: forward
// passes, the turn (last forward butterfly, times the table, conjugate,
// the same butterfly again), the transposed passes down to pass 0, whose
// outputs k < N are the bins in natural order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed.cuh"
#include "fused_psd_regs.cuh"  // dequant_byte
#include "psd_sum.cuh"

namespace {

// Threads a block may have (the wrapper's tf times lanes).
constexpr int kMixedMaxThreads = 512;
// Shared memory the kernels opt into: all a Hopper block may use.
constexpr int kMixedMaxSmem = 232448;

// The plan, by value: the wrapper's ints in this order
// (fused_psd_mixed.MixedLaunch.ints).
struct MixedPlan {
  int n;        // transform length: N, or the chirp-Z kernel's M
  int bins;     // N
  int row;      // a partial row: N rounded up to kSumBins
  int passes;   // P
  int tf;       // threads a frame lane
  int lanes;    // frame lanes a block
  int xstride;  // float2 of a lane's exchange buffer: pad_index(n - 1) + 1
  int radix[kMixedMaxPasses];
};
constexpr int kMixedPlanInts = 7 + kMixedMaxPasses;

// Shared bytes of a block: the lanes' exchange buffers, then their f32
// accumulators of N floats each.
__host__ __device__ inline int mixed_smem_bytes(const MixedPlan& p) {
  return p.lanes * (p.xstride * 8 + p.bins * 4);
}

// Element of the forward transform's output that holds bin k: k's
// mixed-radix digits (radix R_0 least significant) in reverse.
__device__ __forceinline__ int element_of_bin(const MixedPlan& p, int k) {
  int q = 0;
  int L = p.n;
  for (int j = 0; j < p.passes; ++j) {
    const int r = p.radix[j];
    L /= r;
    q += (k % r) * L;
    k /= r;
  }
  return q;
}

// Pass 0 of one frame on lane thread t: butterflies b = t, t + tf, ... of
// the n / R0, each over the samples b + n1 * S (S = n / R0), read from
// the frame's bytes; its outputs go to elements b + k1 * S times their
// twiddles, or (a one-pass plan) to the accumulator.
template <int R, bool CHIRP, bool WINDOWED>
__device__ __forceinline__ void first_pass(
    const uint8_t* __restrict__ frame, const float* __restrict__ window,
    const float2* __restrict__ chirp, const float2* __restrict__ tw,
    float2* x, float* acc, int n, int bins, bool last, int t, int tf) {
  const int S = n / R;
  const uint16_t* iq = reinterpret_cast<const uint16_t*>(frame);
  for (int b = t; b < S; b += tf) {
    float2 v[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const int s = b + n1 * S;
      float2 y = make_float2(0.0f, 0.0f);
      if (!CHIRP || s < bins) {
        const unsigned u = __ldg(iq + s);
        y = make_float2(dequant_byte(u & 0xFFu), dequant_byte(u >> 8));
        if constexpr (WINDOWED) {
          const float w = __ldg(window + s);
          y = make_float2(__fmul_rn(y.x, w), __fmul_rn(y.y, w));
        }
        if constexpr (CHIRP) y = cmulf(y, __ldg(chirp + s));
      }
      v[n1] = y;
    }
    dft_natural<R>(v);
    if (last) {
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) acc[b + k1 * S] += norm2(v[k1]);
    } else {
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        const float2 y = k1 == 0 ? v[k1] : cmulf(v[k1], __ldg(tw + k1 * S + b));
        x[pad_index(b + k1 * S)] = y;
      }
    }
  }
}

// Pass 1 of the step: block g serves stream s = g / G_s (one stream for
// the single-stream entry) and sums |X|^2 of that stream's frames
// [j*group, min((j+1)*group, F, n_valid_s)), j = g mod G_s, into partial
// row g. n_valid_s is stream_n_valid[s] where that array is given, else
// n_valid.
template <bool CHIRP, bool WINDOWED>
__global__ void __launch_bounds__(kMixedMaxThreads)
psd_mixed_kernel(const uint8_t* __restrict__ raw,        // (S*F, 2N)
                 const float2* __restrict__ twiddle,     // plan_twiddles
                 const float* __restrict__ window,       // (N,) or null
                 const float2* __restrict__ chirp,       // (N,) chirp-Z a
                 const float2* __restrict__ spectrum,    // (M,) chirp-Z B/M
                 float* __restrict__ partial,            // (S*G_s, row)
                 const MixedPlan p, int F, int group, int blocks_per_stream,
                 int n_valid, const int* __restrict__ stream_n_valid) {
  extern __shared__ float2 mixed_smem[];
  const int threads = p.tf * p.lanes;
  const int tid = threadIdx.x;
  const int lane = tid / p.tf;
  const int t = tid % p.tf;
  float2* x = mixed_smem + lane * p.xstride;
  float* acc_all = reinterpret_cast<float*>(mixed_smem + p.lanes * p.xstride);
  float* acc = acc_all + lane * p.bins;
  for (int i = tid; i < p.lanes * p.bins; i += threads) acc_all[i] = 0.0f;

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = stream_n_valid == nullptr ? n_valid
                                           : __ldg(stream_n_valid + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + p.lanes - 1) / p.lanes;
  const uint8_t* frames =
      raw + static_cast<size_t>(stream) * F * 2 * p.bins;
  const int P = p.passes;

  for (int i = 0; i < iters; ++i) {
    const int f = f0 + lane + p.lanes * i;
    const bool active = f < f1;
    // x is free (the last pass of frame i - 1 is done), and on the first
    // frame the accumulators are zero.
    __syncthreads();
    if (active) {
      const uint8_t* frame = frames + static_cast<size_t>(f) * 2 * p.bins;
      with_radix(p.radix[0], [&](auto rc) {
        first_pass<decltype(rc)::value, CHIRP, WINDOWED>(
            frame, window, chirp, twiddle, x, acc, p.n, p.bins, P == 1, t,
            p.tf);
      });
    }
    // The forward passes 1 .. P - 1 (for the chirp-Z kernel, the last is
    // the turn).
    int L = p.n / p.radix[0];
    int offset = p.n;
    for (int j = 1; j < P; ++j) {
      __syncthreads();
      if (active) {
        with_radix(p.radix[j], [&](auto rc) {
          constexpr int R = decltype(rc)::value;
          if constexpr (CHIRP) {
            if (j == P - 1) {
              turn_pass<R>(x, spectrum, p.n, L, t, p.tf);
            } else {
              dif_pass<R>(x, twiddle + offset, p.n, L, false, acc, t, p.tf);
            }
          } else {
            dif_pass<R>(x, twiddle + offset, p.n, L, j == P - 1, acc, t,
                        p.tf);
          }
        });
      }
      if (j < P - 1) {
        offset += L;
        L /= p.radix[j];
      }
    }
    if constexpr (CHIRP) {
      // The transposed passes P - 2 .. 0: L and offset walk back.
      for (int j = P - 2; j >= 0; --j) {
        L *= p.radix[j];
        offset -= L;
        __syncthreads();
        if (active) {
          with_radix(p.radix[j], [&](auto rc) {
            dit_pass<decltype(rc)::value>(x, twiddle + offset, p.n, L,
                                          j == 0, acc, p.bins, t, p.tf);
          });
        }
      }
    }
  }
  __syncthreads();   // every lane's accumulator is final

  float* row = partial + static_cast<size_t>(blockIdx.x) * p.row;
  for (int k = tid; k < p.row; k += threads) {
    float sum = 0.0f;
    if (k < p.bins) {
      const int q = CHIRP ? k : element_of_bin(p, k);
      sum = acc_all[q];
      for (int l = 1; l < p.lanes; ++l) sum += acc_all[l * p.bins + q];
    }
    row[k] = sum;
  }
}

inline cudaError_t read_plan(const int* ints, MixedPlan* p) {
  if (ints == nullptr) return cudaErrorInvalidValue;
  p->n = ints[0];
  p->bins = ints[1];
  p->row = ints[2];
  p->passes = ints[3];
  p->tf = ints[4];
  p->lanes = ints[5];
  p->xstride = ints[6];
  int n = 1;
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    p->radix[j] = ints[7 + j];
    if (j < p->passes) n *= p->radix[j];
  }
  const bool ok = p->passes >= 1 && p->passes <= kMixedMaxPasses &&
                  n == p->n && p->bins >= 1 && p->bins <= p->n &&
                  p->row % kSumBins == 0 && p->row >= p->bins &&
                  p->tf >= 1 && p->lanes >= 1 &&
                  p->tf * p->lanes <= kMixedMaxThreads &&
                  p->xstride == pad_index(p->n - 1) + 1 &&
                  mixed_smem_bytes(*p) <= kMixedMaxSmem;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// Opts the instantiation into all the shared memory a block may have,
// once per device (bit d of a mask for device d < 64; a device beyond
// that sets it every call), so that a launch costs no driver call for it.
template <bool CHIRP, bool WINDOWED>
cudaError_t prepare_mixed(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      psd_mixed_kernel<CHIRP, WINDOWED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMixedMaxSmem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Both passes for S streams of F frames, G_s blocks a stream.
template <bool CHIRP, bool WINDOWED>
int launch_mixed(const void* raw, const void* twiddle, const void* window,
                 const void* chirp, const void* spectrum,
                 const void* stream_n_valid, void* partial, void* out,
                 const int* plan_ints, int device, int S, int F, int group,
                 int G_s, int n_valid, void* stream) {
  MixedPlan p;
  cudaError_t e = read_plan(plan_ints, &p);
  if (e == cudaSuccess) e = use_device(device);
  if (e == cudaSuccess) e = prepare_mixed<CHIRP, WINDOWED>(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  psd_mixed_kernel<CHIRP, WINDOWED>
      <<<S * G_s, p.tf * p.lanes, mixed_smem_bytes(p), st>>>(
          static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float*>(window),
          static_cast<const float2*>(chirp),
          static_cast<const float2*>(spectrum), static_cast<float*>(partial),
          p, F, group, G_s, n_valid, static_cast<const int*>(stream_n_valid));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G_s, p.row, out, st, S));
}

// Argument checks of the single-stream and streams entries.
inline bool mixed_args_ok(int S, int F, int group, int n_valid,
                          bool streams) {
  if (S <= 0 || F <= 0 || group <= 0) return false;
  if (streams) {
    return F % group == 0 &&
           static_cast<long long>(S) * (F / group) <= 0x7fffffffLL;
  }
  return n_valid >= 0 && n_valid <= F;
}

// What the instantiation gets on `device` with the plan: registers and
// spill bytes a thread, static and dynamic shared bytes a block, threads
// a block, and the blocks that reside on one SM.
template <bool CHIRP, bool WINDOWED>
int mixed_attributes(const int* plan_ints, int device, int* attrs) {
  MixedPlan p;
  cudaError_t e = read_plan(plan_ints, &p);
  if (e == cudaSuccess && attrs == nullptr) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = use_device(device);
  if (e == cudaSuccess) e = prepare_mixed<CHIRP, WINDOWED>(device);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&fa, psd_mixed_kernel<CHIRP, WINDOWED>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = mixed_smem_bytes(p);
  attrs[4] = p.tf * p.lanes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], psd_mixed_kernel<CHIRP, WINDOWED>, attrs[4], attrs[3]));
}

}  // namespace
