// The streams forms' shared parts of the large kernels (fused_psd_large.cu,
// fused_psd_mixed_large.cu, fused_psd_chirp_large.cu): a block's stream
// and frames, and each stream's sum of its partial rows.

#pragma once

#include <cuda_runtime.h>

#include "psd_sum.cuh"

namespace {

// A streams block's frames: S streams of F frames, (S*F, 2N), a pass's
// grid (G_s tiles, S): blockIdx.y is the stream s, and block x serves
// tile x mod tiles of that stream's frames [f0, min(f0 + group,
// n_valid[s])), f0 = (x / tiles) group, G_s = ceil(F / group): no block
// crosses a stream, and a stream's last group is the shorter. The count
// is read from device memory when the block runs (one outside [0, F] acts
// as its nearest bound). The stream on the grid's y axis keeps the
// block's frames as cheap to form again as a one-stream block's, so that
// the passes hold no more registers than the one-stream passes.
struct StreamsBlock {
  int rest;     // the block's partial row, s G_s + x / tiles
  int first;    // its first frame in the batch, s F + f0
  int frames;   // its frames
};

__device__ __forceinline__ StreamsBlock streams_block(
    int tiles, int F, int group, int G_s, const int* __restrict__ counts) {
  const int s = blockIdx.y;
  const int j = blockIdx.x / tiles;
  const int f0 = j * group;
  const int nv = min(max(__ldg(counts + s), 0), F);
  return {s * G_s + j, s * F + f0, max(min(f0 + group, nv) - f0, 0)};
}

// psd_rows_sum (psd_rows_sum.cuh) over S streams: stream s's G rows at
// partial + s G N4 to out + s N4, added in the same order, so each
// stream's bits are a one-stream sum's.
__global__ void __launch_bounds__(256)
streams_rows_sum(const float4* __restrict__ partial, int S, int G, int N4,
                 float4* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= N4) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float4* rows = partial + static_cast<size_t>(s) * G * N4;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    for (int g = 0; g < G; ++g) {
      const float4 p = rows[static_cast<size_t>(g) * N4 + i];
      a0 += static_cast<double>(p.x);
      a1 += static_cast<double>(p.y);
      a2 += static_cast<double>(p.z);
      a3 += static_cast<double>(p.w);
    }
    out[static_cast<size_t>(s) * N4 + i] =
        make_float4(static_cast<float>(a0), static_cast<float>(a1),
                    static_cast<float>(a2), static_cast<float>(a3));
  }
}

// Each of S streams' G >= 2 partial rows of `row` bins (a multiple of
// kSumBins), (S, G, row) f32, added into out (S, row) as a one-stream
// call of the large kernels adds its G rows: streams_rows_sum up to
// kSumLanes rows, psd_sum.cuh's kernel above.
inline cudaError_t launch_rows_sum(const void* partial, int S, int G,
                                   int row, void* out, cudaStream_t st) {
  if (G > kSumLanes) return launch_psd_sum(partial, G, row, out, st, S);
  const int n4 = row / 4;
  const dim3 grid((n4 + 255) / 256, S < kMaxGridY ? S : kMaxGridY);
  streams_rows_sum<<<grid, 256, 0, st>>>(static_cast<const float4*>(partial),
                                         S, G, n4, static_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace
