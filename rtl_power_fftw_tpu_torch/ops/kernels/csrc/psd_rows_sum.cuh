// The sum of a few partial rows (2..kSumLanes) of the large kernels
// (fused_psd_large.cu, fused_psd_chirp_large.cu, fused_psd_mixed_large.cu):
// the same bits as psd_sum.cuh's order at that many rows, 4 bins a thread.

#pragma once

#include <cuda_runtime.h>

#include "psd_sum.cuh"

namespace {

// The sum of G = 2..kSumLanes partial rows: out[bin] = the f32 rounding
// of ((0.0 + row_0) + row_1) + ... in float64, 4 bins a thread. That is
// psd_sum_kernel's order at G <= kSumLanes (lane l takes row l alone; the
// lanes past G add 0.0), so the same bits.
__global__ void __launch_bounds__(256)
psd_rows_sum(const float4* __restrict__ partial, int G, int N4,
             float4* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= N4) return;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  for (int g = 0; g < G; ++g) {
    const float4 p = partial[static_cast<size_t>(g) * N4 + i];
    a0 += static_cast<double>(p.x);
    a1 += static_cast<double>(p.y);
    a2 += static_cast<double>(p.z);
    a3 += static_cast<double>(p.w);
  }
  out[i] = make_float4(static_cast<float>(a0), static_cast<float>(a1),
                       static_cast<float>(a2), static_cast<float>(a3));
}

}  // namespace
