// What the estimator libraries share (fused_psd_sk.cu, fused_psd_tapers.cu,
// fused_psd_pfb.cu): the opt-in to a block's shared memory, a kernel's
// attributes, and est_sum_kernel and est_streams_kernel, the second passes
// of the spectral-kurtosis and multitaper steps on one stream and on S.
//
// est_sum_kernel is psd_sum.cuh's row sum (sum_rows, psd_sum_kernel's own)
// over one or two planes of G partial rows (lane l of kSumLanes sums rows
// l, l + kSumLanes, ... in float64; the lanes are added in order; the total
// is rounded once to float32), so a plane sums to the bits psd_sum_kernel
// gives it. Its epilogue is the estimator's:
//
//   kEstSk      planes s1 and s2 -> out rows 0 and 1;
//   kEstSkGate  the same, and the excision gate of the spectral-kurtosis
//               step on them (the JAX package's models/kurtosis.py:_sk_keep
//               in float32): keep = |SK - 1| <= 2 sigma / sqrt(max(M, 1)) or
//               M < 2, SK = (M + 1) / max(M - 1, 1) * (M s2 / max(s1^2,
//               1e-30) - 1) with M = n_valid; out rows 2 and 3 are s1 * keep
//               and M * keep;
//   kEstTapers  one plane of K * G rows (every taper's rows) -> out row 0,
//               the total divided by K in float32.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

#include "psd_sum.cuh"

namespace {

// Opts `kernel` into `smem` bytes of dynamic shared memory where that is
// above the 48 KB default: once per device (bit d of `done` for device
// d < 64; a device beyond that sets it every call), as fused_psd.cu's
// prepare does.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int smem, int device,
                        std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// attrs[0..5]: registers and local (spill) bytes a thread, static and
// dynamic shared bytes a block, threads a block, blocks resident on one SM.
template <typename Kernel>
cudaError_t kernel_attributes(Kernel kernel, int threads, int smem,
                              int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = smem;
  attrs[4] = threads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[5], kernel,
                                                       threads, smem);
}

enum : int { kEstSk = 0, kEstSkGate = 1, kEstTapers = 2 };

// partial: (planes, G, N) f32; out: (2, N) kEstSk, (4, N) kEstSkGate, (N,)
// kEstTapers. m: n_valid (the gate's M) or K (kEstTapers); two_sigma: 2
// sigma rounded once to float32 (kEstSkGate).
template <int MODE>
__global__ void __launch_bounds__(kSumBins * kSumLanes)
est_sum_kernel(const float* __restrict__ partial, int G, int N, int m,
               float two_sigma, float* __restrict__ out) {
  constexpr int PLANES = MODE == kEstTapers ? 1 : 2;
  __shared__ double lane_sum[kSumLanes][kSumBins];
  const int b = threadIdx.x % kSumBins;
  const int lane = threadIdx.x / kSumBins;
  const int bin = blockIdx.x * kSumBins + b;
  float total[PLANES];   // lane 0's
#pragma unroll
  for (int s = 0; s < PLANES; ++s) {
    sum_rows(partial + static_cast<size_t>(s) * G * N, G, N, bin, b, lane,
             lane_sum, [&](double t) { total[s] = static_cast<float>(t); });
  }
  if (lane != 0) return;
  if constexpr (MODE == kEstTapers) {
    out[bin] = __fdiv_rn(total[0], static_cast<float>(m));
  } else {
    const float s1 = total[0];
    const float s2 = total[1];
    out[bin] = s1;
    out[N + bin] = s2;
    if constexpr (MODE == kEstSkGate) {
      // Each operation rounded on its own, in _sk_keep's order (no FMA).
      const float M = static_cast<float>(m);
      const float a = __fdiv_rn(__fadd_rn(M, 1.0f),
                                fmaxf(__fsub_rn(M, 1.0f), 1.0f));
      const float q = __fdiv_rn(__fmul_rn(M, s2),
                                fmaxf(__fmul_rn(s1, s1), 1e-30f));
      const float sk = __fmul_rn(a, __fsub_rn(q, 1.0f));
      const float limit = __fdiv_rn(two_sigma, __fsqrt_rn(fmaxf(M, 1.0f)));
      const float keep =
          (fabsf(__fsub_rn(sk, 1.0f)) <= limit || M < 2.0f) ? 1.0f : 0.0f;
      out[2 * N + bin] = __fmul_rn(s1, keep);
      out[3 * N + bin] = __fmul_rn(M, keep);
    }
  }
}

// The streams form of sum_rows: stream s's rows of a first pass that ran
// S streams of G_s blocks on Q grid rows (Q planes of S * G_s partial rows,
// block (s * G_s + j, q) writing row (q * S + s) * G_s + j). Its Q * G_s
// rows, taken in the order r = q * G_s + j, are summed as sum_rows sums a
// plane of Q * G_s rows (lane l takes r = l, l + kSumLanes, ...), so a
// stream sums to the bits one stream's pass gives it on the same grid.
template <typename Epilogue>
__device__ __forceinline__ void sum_stream_rows(
    const float* partial, int S, int G_s, int Q, int N, int s, int bin,
    int b, int lane, double (&lane_sum)[kSumLanes][kSumBins],
    Epilogue epilogue) {
  double acc = 0.0;
  const int rows = Q * G_s;
  for (int r = lane; r < rows; r += kSumLanes) {
    const int q = r / G_s;
    const size_t row = (static_cast<size_t>(q) * S + s) * G_s + (r - q * G_s);
    acc += static_cast<double>(partial[row * N + bin]);
  }
  lane_sum[lane][b] = acc;
  __syncthreads();
  if (lane == 0) {
    double t = 0.0;
    for (int l = 0; l < kSumLanes; ++l) t += lane_sum[l][b];
    epilogue(t);
  }
  __syncthreads();   // lane_sum is rewritten by the next call
}

// est_sum_kernel for S streams, stream s = blockIdx.y, blockIdx.y +
// gridDim.y, ...: kEstSk and kEstSkGate read two planes of S * G_s rows
// (s1, then s2; Q = 1) and write out (S, 2, N) or (S, 4, N), the gate's M
// the stream's own count (counts[s], a count outside [0, F] acting as its
// nearest bound); kEstTapers reads Q planes (a taper or a range of them
// each) and writes out (S, N), each total divided by k = K.
template <int MODE>
__global__ void __launch_bounds__(kSumBins * kSumLanes)
est_streams_kernel(const float* __restrict__ partial, int S, int G_s, int Q,
                   int N, const int* __restrict__ counts, int F, int k,
                   float two_sigma, float* __restrict__ out) {
  constexpr int PLANES = MODE == kEstTapers ? 1 : 2;
  constexpr int ROWS = MODE == kEstTapers ? 1 : MODE == kEstSk ? 2 : 4;
  __shared__ double lane_sum[kSumLanes][kSumBins];
  const int b = threadIdx.x % kSumBins;
  const int lane = threadIdx.x / kSumBins;
  const int bin = blockIdx.x * kSumBins + b;
  const size_t plane = static_cast<size_t>(S) * G_s * N;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    float total[PLANES];   // lane 0's
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      sum_stream_rows(partial + p * plane, S, G_s, PLANES == 1 ? Q : 1, N, s,
                      bin, b, lane, lane_sum,
                      [&](double t) { total[p] = static_cast<float>(t); });
    }
    if (lane != 0) continue;
    float* o = out + static_cast<size_t>(s) * ROWS * N;
    if constexpr (MODE == kEstTapers) {
      o[bin] = __fdiv_rn(total[0], static_cast<float>(k));
    } else {
      const float s1 = total[0];
      const float s2 = total[1];
      o[bin] = s1;
      o[N + bin] = s2;
      if constexpr (MODE == kEstSkGate) {
        // est_sum_kernel's gate, on the stream's own M.
        const float M = static_cast<float>(min(max(__ldg(counts + s), 0), F));
        const float a = __fdiv_rn(__fadd_rn(M, 1.0f),
                                  fmaxf(__fsub_rn(M, 1.0f), 1.0f));
        const float q = __fdiv_rn(__fmul_rn(M, s2),
                                  fmaxf(__fmul_rn(s1, s1), 1e-30f));
        const float sk = __fmul_rn(a, __fsub_rn(q, 1.0f));
        const float limit = __fdiv_rn(two_sigma, __fsqrt_rn(fmaxf(M, 1.0f)));
        const float keep =
            (fabsf(__fsub_rn(sk, 1.0f)) <= limit || M < 2.0f) ? 1.0f : 0.0f;
        o[2 * N + bin] = __fmul_rn(s1, keep);
        o[3 * N + bin] = __fmul_rn(M, keep);
      }
    }
  }
}

// S streams of F frames in groups of `group` (a divisor of F) with their
// (S,) counts, the S * F / group blocks of a first pass within a grid's x
// axis.
inline bool streams_args_ok(int S, int F, int group, const void* counts) {
  return S > 0 && F > 0 && group > 0 && F % group == 0 &&
         counts != nullptr &&
         static_cast<long long>(S) * (F / group) <= 0x7fffffffLL;
}

// Launches est_streams_kernel<MODE> on `stream` (arguments as above).
template <int MODE>
cudaError_t launch_est_streams(const void* partial, int S, int G_s, int Q,
                               int N, const void* counts, int F, int k,
                               float two_sigma, void* out,
                               cudaStream_t stream) {
  const dim3 grid(N / kSumBins, S < kMaxGridY ? S : kMaxGridY);
  est_streams_kernel<MODE><<<grid, kSumBins * kSumLanes, 0, stream>>>(
      static_cast<const float*>(partial), S, G_s, Q, N,
      static_cast<const int*>(counts), F, k, two_sigma,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace
