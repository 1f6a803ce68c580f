// The radix-2 shared-memory FFT the fused PSD kernels share: the whole
// transform of K1/K2/K4 (fused_psd.cu), and the column and row transforms
// of the large-N four-step (fused_psd_large.cu).
//
// dif_radix2 runs BATCH in-place decimation-in-frequency transforms of
// length 2^LOG2N on THREADS threads; element i of transform c lives at
// x[c * STRIDE + i]. It takes input in natural order and leaves slot i
// holding bin bit_reverse(i). Twiddles come from a per-stage table (the
// stage with half-span m holds W_{2m}^k, k < m, at offset m - 1), so
// neighbouring threads read neighbouring addresses; the table is computed
// on the host in float64 and rounded once to float32. Every stage ends in
// a barrier, so x may be read by any thread on return.
//
// Within a warp the butterflies belong to one transform (2^(LOG2N-1) >= 32
// wherever BATCH > 1), so a STRIDE padded past the length changes no
// stage's bank pattern; it only spreads the transforms over the banks for
// the loads and stores around the FFT.

#pragma once

#include <cuda_runtime.h>

namespace {

template <int LOG2N>
__device__ __forceinline__ int bit_reverse(int i) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - LOG2N));
}

template <int LOG2N, int THREADS, int BATCH = 1, int STRIDE = (1 << LOG2N)>
__device__ __forceinline__ void dif_radix2(float2* x,
                                           const float2* __restrict__ twiddle,
                                           int tid) {
  constexpr int HALF = (1 << LOG2N) / 2;
  static_assert((HALF * BATCH) % THREADS == 0,
                "the butterflies of a stage must split evenly over threads");
#pragma unroll
  for (int s = LOG2N - 1; s >= 0; --s) {
    const int m = 1 << s;
    const float2* tw = twiddle + (m - 1);
#pragma unroll
    for (int r = 0; r < HALF * BATCH / THREADS; ++r) {
      const int b = tid + r * THREADS;
      int j = b;
      int base = 0;
      if constexpr (BATCH > 1) {
        j = b & (HALF - 1);
        base = (b / HALF) * STRIDE;
      }
      const int k = j & (m - 1);
      const int i0 = base + ((j >> s) << (s + 1)) + k;
      const int i1 = i0 + m;
      const float2 a = x[i0];
      const float2 c = x[i1];
      const float2 w = __ldg(tw + k);
      const float dr = a.x - c.x;
      const float di = a.y - c.y;
      x[i0] = make_float2(a.x + c.x, a.y + c.y);
      x[i1] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
    }
    __syncthreads();
  }
}

}  // namespace
