// Pass 2 of the fused PSD kernels (fused_psd.cu, fused_psd_fast.cu):
// out[s, bin] = sum over g of partial[s, g, bin], rows taken in a fixed
// order (lane l sums rows l, l + kSumLanes, ...; lanes are then added in
// order), in float64. Pass 1 writes one f32 partial row per block, so the
// result is the same on every run and no float atomics are needed.
// blockIdx.y walks the streams (K4); a single stream is a grid one high.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSumBins = 32;   // bins per block, one warp wide
constexpr int kSumLanes = 8;   // rows summed in parallel per bin
constexpr int kMaxGridY = 65535;

// The row sum of one plane `rows` ((G, N) f32) at bin blockIdx.x *
// kSumBins + b, in float64 in the fixed order, through the block's shared
// `lane_sum`: lane 0 passes the total to epilogue(total). Every thread of
// the block calls it (it meets two barriers). est_sum_kernel
// (fused_psd_est.cuh) runs it too.
template <typename Epilogue>
__device__ __forceinline__ void sum_rows(
    const float* rows, int G, int N, int bin, int b, int lane,
    double (&lane_sum)[kSumLanes][kSumBins], Epilogue epilogue) {
  double acc = 0.0;
#pragma unroll 4
  for (int g = lane; g < G; g += kSumLanes) {
    acc += static_cast<double>(rows[static_cast<size_t>(g) * N + bin]);
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

__global__ void __launch_bounds__(kSumBins * kSumLanes)
psd_sum_kernel(const float* __restrict__ partial, int S, int G, int N,
               float* __restrict__ out) {
  __shared__ double lane_sum[kSumLanes][kSumBins];
  const int b = threadIdx.x % kSumBins;
  const int lane = threadIdx.x / kSumBins;
  const int bin = blockIdx.x * kSumBins + b;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    sum_rows(partial + static_cast<size_t>(s) * G * N, G, N, bin, b, lane,
             lane_sum, [&](double t) {
               out[static_cast<size_t>(s) * N + bin] = static_cast<float>(t);
             });
  }
}

// N a multiple of kSumBins; partial (S, G, N) f32; out (S, N) f32.
inline cudaError_t launch_psd_sum(const void* partial, int G, int N, void* out,
                                  cudaStream_t stream, int S = 1) {
  const dim3 grid(N / kSumBins, S < kMaxGridY ? S : kMaxGridY);
  psd_sum_kernel<<<grid, kSumBins * kSumLanes, 0, stream>>>(
      static_cast<const float*>(partial), S, G, N, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace
