// The streams passes of the large kernel ("L-S": large_streams_a,
// large_streams_b), which fused_psd_large.cu launches for its streams
// entry and the CLI estimators' forms of its passes (fused_psd_large_est.cu)
// launch at S >= 1 streams: the register passes of fused_psd_large_regs.cuh
// with the stream on the grid's y axis (large_streams.cuh: streams_block).
// What they do, and why, is stated at the top of fused_psd_large.cu; the
// code is the large kernel's own, moved here unchanged, so that both
// libraries compile it from one text.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_regs.cuh"
#include "fused_psd_large_regs.cuh"
#include "fused_psd_regs.cuh"
#include "large_streams.cuh"

namespace {

// large_regs_a over S streams: block (x, s) as streams_block; frame i of
// the block is frame first + i of the batch.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_A,
                                  LargeRegs<LOG2N>::MIN_BLOCKS_A)
large_streams_a(const uint8_t* __restrict__ raw,      // (S*F, 2N)
                const float2* __restrict__ twiddle,   // pass_twiddles(N1)
                const float2* __restrict__ inter,     // W_N^(k1 n2)
                const float* __restrict__ window,     // (N,) or null
                float2* __restrict__ scratch,         // (S*F, N)
                int F, int group, int G_s, const int* __restrict__ counts) {
  using L = LargeRegs<LOG2N>;
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2N>(tid);
  const int t = row_of<LOG2N>(tid);
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;

  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src =
          raw + static_cast<size_t>(first + i) * 2 * L::N + 2 * c0;
      uint8_t* dst = ring + (i & 1) * L::SLOT_A;
#pragma unroll
      for (int j = 0; j < L::COPIES_A; ++j) {
        const int q = tid + j * L::THREADS_A;
        const int row = q / L::PARTS;
        const int part = q % L::PARTS;
        cp_async16(dst + ring_offset<LOG2N>(row, part),
                   src + static_cast<size_t>(row) * 2 * L::N2 + 16 * part);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* tile = ring + (i & 1) * L::SLOT_A;
    float2* out = scratch + static_cast<size_t>(first + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      regs_a_batch<LOG2N, WINDOWED>(s, tile, window, x, twiddle, inter, out,
                                    c, t, c0);
    }
  }
  cp_async_wait<0>();
}

// large_regs_b over S streams: block (x, s) as streams_block, its sums to
// partial row s G_s + x / TILES_B of `rows`.
template <int LOG2N>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_B, 2)
large_streams_b(const float2* __restrict__ scratch,   // (S*F, N)
                const float2* __restrict__ twiddle,   // pass_twiddles(N2)
                float* __restrict__ rows,             // (S*G_s, N)
                int F, int group, int G_s, const int* __restrict__ counts) {
  using L = LargeRegs<LOG2N>;
  using P = RegsPlan<L::LOG2N2>;
  constexpr int TF = L::TF2;
  extern __shared__ float4 large_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_B;
  const int tid = threadIdx.x;
  const int r = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(large_smem) + r * L::XS2;
  const int k0 = (blockIdx.x % L::TILES_B) * L::B2;
  const StreamsBlock blk = streams_block(L::TILES_B, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;

  constexpr int kFrameBytes = L::RUNS * L::RUN * 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L::SLOT_B);
  const float2* ring2 = reinterpret_cast<const float2*>(ring);
  auto prefetch = [&](int i) {
    if (i < frames) {
      copy_runs<LOG2N>(ring,
                       scratch + static_cast<size_t>(first + i) * L::N +
                           k0 * L::B,
                       bar, tid);
    }
  };

  if (tid == 0) {
    mbarrier_init(bar, 1);
    if (frames > 0) mbarrier_expect(bar, kFrameBytes);
  }
  __syncthreads();
  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    mbarrier_wait(bar, i & 1);
    __syncthreads();
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int n2 = t + k * TF;
      v[k] = ring2[run_slot<LOG2N>(r, n2)];
    }
    if (tid == 0 && i + 1 < frames) mbarrier_expect(bar, kFrameBytes);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    prefetch(i + 1);
    first_pass<L::LOG2N2>(v, x, twiddle, t,
                          [](int e) { return pad_index(e); });
    __syncthreads();
    regs_pass<L::LOG2N2, 1>(v, x, twiddle, t);
    if constexpr (P::PASSES > 2) {
      __syncthreads();
      regs_pass<L::LOG2N2, 2>(v, x, twiddle, t);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
  }
  __syncthreads();

  float* by_bin = reinterpret_cast<float*>(large_smem);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int k2 = pass_bin<L::LOG2N2>(last_element<L::LOG2N2>(t, k));
    by_bin[r * L::XSR + pad_index(k2)] = acc[k];
  }
  __syncthreads();
  float* out = rows + static_cast<size_t>(blk.rest) * L::N;
#pragma unroll 4
  for (int j = tid; j < L::B2 * L::N2; j += L::THREADS_B) {
    const int rr = j % L::B2;
    const int k2 = j / L::B2;
    out[k0 + rr + (k2 << L::LOG2N1)] = by_bin[rr * L::XSR + pad_index(k2)];
  }
}

}  // namespace
