// What the estimator libraries share (fused_psd_sk.cu, fused_psd_tapers.cu,
// fused_psd_pfb.cu): the opt-in to a block's shared memory, a kernel's
// attributes, and est_sum_kernel, the second pass of the spectral-kurtosis
// and multitaper steps.
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

}  // namespace
