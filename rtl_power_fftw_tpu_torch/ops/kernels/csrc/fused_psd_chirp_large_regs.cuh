// What BL's register passes (fused_psd_chirp_large.cu) share with the
// estimators' forms of them (fused_psd_chirp_large_est.cu): the shapes
// beyond the large kernel's (ChirpRegs), pass A's piece copies and batch
// (copy_piece, chirp_a_batch), and the streams passes chirp_streams_a/b/c,
// which the estimators' forms launch at S >= 1 streams. What each pass
// does, and why, is stated at the top of fused_psd_chirp_large.cu; the
// code is BL's own, moved here unchanged, so that both libraries compile
// it from one text.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_mixed.cuh"   // cmulf
#include "fft_regs.cuh"
#include "frame_ring.cuh"
#include "fused_psd_chirp.cuh"   // turn_inputs
#include "fused_psd_large_regs.cuh"
#include "large_streams.cuh"

namespace {

// BL's shapes at M = 2^LOG2M beyond the large kernel's LargeRegs<LOG2M>;
// kept in step with chirp_regs_layout() in fused_psd_chirp_large.py.
template <int LOG2M>
struct ChirpRegs {
  using L = LargeRegs<LOG2M>;
  // Pass A: a ring slot holds the tile's rows n1 < M1 / 2 (N <= M / 2);
  // a batch's chirp values, 8 a thread. Blocks an SM: one at M =
  // 2^17..2^19 (213 registers), where the large kernel's two spill up to
  // 136 B and ran 9-12% slower; else the large kernel's, where one ran up
  // to 8% slower at 2^16 and 2^20 (probes/large_awkward_builds.py on an
  // H100).
  static constexpr int MIN_BLOCKS_A =
      LOG2M >= 17 && LOG2M <= 19 ? 1 : L::MIN_BLOCKS_A;
  static constexpr int ROWS_A = L::N1 / 2;
  static constexpr int SLOT_A = ROWS_A * L::ROW_BYTES;
  static constexpr int SMEM_A = L::XBYTES_A + 2 * SLOT_A;
  static constexpr int CHIRP_A = 8 * L::THREADS_A;
  // Pass B: the exchange rows and, in the same bytes, a frame's outputs by
  // run (run g at g * GS, as the ring); then the ring and its mbarrier.
  static constexpr int STAGE_B =
      L::XBYTES_B > L::SLOT_B ? L::XBYTES_B : L::SLOT_B;
  static constexpr int SMEM_B = STAGE_B + L::SLOT_B + 8;
  // Blocks an SM: one at M2 = 512 and 1024, where two (128 registers)
  // spill 44-428 B a thread and ran 1.05-1.57x slower at M = 2^17, 2^18
  // and 2^20 (1% faster at 2^19); two elsewhere, where one ran 2-9%
  // slower at 2^16, 2^21 and 2^22 (probes/large_awkward_builds.py).
  static constexpr int MIN_BLOCKS_B = L::N2 == 512 || L::N2 == 1024 ? 1 : 2;
  // Pass C: one batch of B columns a block, two exchange buffers. Blocks
  // an SM: one up to M = 2^20 (two spill up to 72 B and ran 1-4% slower
  // from 2^16), two above (one ran 1% slower at 2^22;
  // probes/large_awkward_builds.py).
  static constexpr int MIN_BLOCKS_C = LOG2M <= 20 ? 1 : 2;
  static constexpr int THREADS_C = L::THREADS_A;
  static constexpr int TILES_C = L::N2 / L::B;
  static constexpr int XFLOATS_C = L::B * L::XS;
  static constexpr int SMEM_C = 2 * L::XBYTES_A;
  static_assert(L::N1 * L::B == 16 * THREADS_C,
                "pass C copies 16 values a thread a frame");
  static_assert(STAGE_B % 16 == 0, "the ring stays 16-byte aligned");
  static_assert(RegsPlan<L::LOG2N2>::PASSES <= 3 &&
                    RegsPlan<L::LOG2N1>::PASSES <= 3,
                "at most one middle pass each way");
};

// `width` bytes (4, 8 or 16) from global to shared memory by cp.async.
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int width) {
  if (width == 16) {
    cp_async16(dst, src);
  } else if (width == 8) {
    cp_async_ca<8>(dst, src);
  } else {
    cp_async_ca<4>(dst, src);
  }
}

// Pass A's batch s on thread (c, t): the column's samples n = (t + k TF1)
// M2 + c0 + s B + c, k < 8, from the ring, dequantized [, windowed] and
// times a[n] (chirp: the batch's part of the table, value k of thread tid
// at k * THREADS_A + tid), 0 where n >= bins; pass 0 with the half-zero
// first stage; then regs_a_rest's passes and stores.
template <int LOG2M, bool WINDOWED>
__device__ __forceinline__ void chirp_a_batch(
    int s, const uint8_t* tile, const float* __restrict__ window,
    const float2* __restrict__ chirp, float2* x,
    const float2* __restrict__ twiddle, const float2* __restrict__ inter,
    float2* __restrict__ out, int c, int t, int c0, int bins) {
  using L = LargeRegs<LOG2M>;
  constexpr int TF = L::TF1;
  if (s > 0) __syncthreads();   // x is free (last pass of batch s - 1)
  const int col = s * L::B + c;
  const int byte = 2 * col;
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int row = t + k * TF;
    const int n = (row << L::LOG2N2) + c0 + col;
    float2 y = make_float2(0.0f, 0.0f);
    if (n < bins) {
      const unsigned u = *reinterpret_cast<const uint16_t*>(
          tile + ring_offset<LOG2M>(row, byte >> 4) + (byte & 15));
      float re = dequant_byte(u & 0xFFu);
      float im = dequant_byte(u >> 8);
      if constexpr (WINDOWED) {
        const float w = __ldg(window + n);
        re = __fmul_rn(re, w);
        im = __fmul_rn(im, w);
      }
      y = cmulf(make_float2(re, im),
                __ldg(chirp + k * L::THREADS_A + threadIdx.x));
    }
    v[k] = y;
  }
  dif_stage_half_zero<16>(v);
  dif_regs<16, 4>(v, 0);
  first_store<L::LOG2N1>(v, x, twiddle, t,
                         [c](int e) { return col_index<LOG2M>(c, e); });
  regs_a_rest<LOG2M>(s, v, x, twiddle, inter, out, c, t, c0);
}

// chirp_regs_a over S streams: block (x, s) as streams_block
// (large_streams.cuh); frame i of the block is frame first + i of the
// batch.
template <int LOG2M, bool WINDOWED>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_A,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_A)
chirp_streams_a(const uint8_t* __restrict__ raw,     // (S*F, 2 bins)
                const float2* __restrict__ twiddle,  // pass_twiddles(M1)
                const float2* __restrict__ inter,    // W_M^(k1 n2)
                const float* __restrict__ window,    // (bins,) or null
                const float2* __restrict__ chirp,    // a, the threads' order
                float2* __restrict__ scratch,        // (S*F, M)
                int bins, int width, int F, int group, int G_s,
                const int* __restrict__ counts) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2M>(tid);
  const int t = row_of<LOG2M>(tid);
  const int tile = blockIdx.x % L::TILES_A;
  const int c0 = tile * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  // The tile's rows with a sample (n1 M2 + c0 < bins), each 1 << lp
  // pieces of `width` = 1 << lw bytes; a piece is copied where its first
  // sample is below bins (bins and the piece's samples are multiples of
  // width / 2, so a piece is all in or all out).
  const int rows = min(CR::ROWS_A, (bins - c0 + L::N2 - 1) >> L::LOG2N2);
  const int lw = width == 16 ? 4 : width == 8 ? 3 : 2;
  const int lp = log2_of(L::ROW_BYTES) - lw;
  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src =
          raw + static_cast<size_t>(first + i) * 2 * bins + 2 * c0;
      uint8_t* dst = ring + (i & 1) * CR::SLOT_A;
      for (int q = tid; q < (rows << lp); q += L::THREADS_A) {
        const int row = q >> lp;
        const int byte = (q - (row << lp)) << lw;
        if ((row << L::LOG2N2) + c0 + (byte >> 1) < bins) {
          copy_piece(dst + ring_offset<LOG2M>(row, byte >> 4) + (byte & 15),
                     src + (static_cast<size_t>(row) << (L::LOG2N2 + 1)) +
                         byte,
                     width);
        }
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const uint8_t* slot = ring + (i & 1) * CR::SLOT_A;
    float2* out = scratch + static_cast<size_t>(first + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      chirp_a_batch<LOG2M, WINDOWED>(
          s, slot, window, chirp + (tile * L::SUBS + s) * CR::CHIRP_A, x,
          twiddle, inter, out, c, t, c0, bins);
    }
  }
  cp_async_wait<0>();
}

// chirp_regs_b over S streams: block (x, s) as streams_block.
template <int LOG2M>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_B,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_B)
chirp_streams_b(float2* __restrict__ scratch,          // (S*F, M)
                const float2* __restrict__ twiddle,   // pass_twiddles(M2)
                const float2* __restrict__ spectrum,  // (M1, M2) by element
                const float2* __restrict__ inter,     // W_M^(k1 m2)
                int F, int group, int G_s, const int* __restrict__ counts) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P = RegsPlan<L::LOG2N2>;
  constexpr int TF = L::TF2;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(L::LOG2N2, LAST);
  constexpr int BITS = log2_of(RL);
  extern __shared__ float4 large_smem[];
  float2* stage = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + CR::STAGE_B;
  const int tid = threadIdx.x;
  const int r = tid / TF;
  const int t = tid % TF;
  float2* x = stage + r * L::XS2;
  const int k0 = (blockIdx.x % L::TILES_B) * L::B2;
  const StreamsBlock blk = streams_block(L::TILES_B, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  const float2* spec = spectrum + static_cast<size_t>(k0 + r) * L::N2;
  const float2* tw = inter + k0 * L::B;

  // Frame i's B2 rows into the ring (copy_runs), counted on the ring's
  // mbarrier (phase i mod 2; thread 0 arms it for a frame's bytes before a
  // barrier that comes before any of that frame's copies).
  constexpr int kFrameBytes = L::RUNS * L::RUN * 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L::SLOT_B);
  const float2* ring2 = reinterpret_cast<const float2*>(ring);
  auto prefetch = [&](int i) {
    if (i < frames) {
      copy_runs<LOG2M>(ring,
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
    mbarrier_wait(bar, i & 1);   // frame i's runs have landed
    __syncthreads();             // the stage is free (frame i - 1's stores)
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = ring2[run_slot<LOG2M>(r, t + k * TF)];
    if (tid == 0 && i + 1 < frames) mbarrier_expect(bar, kFrameBytes);
    // The ring's reads (generic proxy) before the copy engine's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();             // every row is in registers
    prefetch(i + 1);             // frame i + 1 lands while i is transformed
    first_pass<L::LOG2N2>(v, x, twiddle, t,
                          [](int e) { return pad_index(e); });
    __syncthreads();
    if constexpr (P::PASSES > 2) {
      regs_pass<L::LOG2N2, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    // The last forward pass leaves output rev_bits(q) of butterfly
    // b = t + i2 TF in v[i2 RL + q]: element b RL + rev_bits(q).
    regs_pass<L::LOG2N2, LAST>(v, x, twiddle, t);
#pragma unroll
    for (int i2 = 0; i2 < 16 / RL; ++i2) {
      const int base = (t + i2 * TF) * RL;
      float2 u[RL];
      turn_inputs<RL>(u, v, i2 * RL, spec + base);
      dif_regs<RL>(u, 0);
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        x[pad_index(base + rev_bits(q, BITS))] = u[q];
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 2) {
      regs_pass_t<L::LOG2N2, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    regs_pass_t<L::LOG2N2, 0>(v, x, twiddle, t);   // v[q]: z[t + rev(q) TF]
    __syncthreads();             // every row's pass 0 has read x
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      stage[run_slot<LOG2M>(r, t + rev_bits(q, 4) * TF)] = v[q];
    }
    __syncthreads();
    float2* out =
        scratch + static_cast<size_t>(first + i) * L::N + k0 * L::B;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int e = tid + j * L::THREADS_B;   // run e / RUN, at e % RUN
      const int g = e / L::RUN;
      const int pos = g * L::N1 * L::B + (e - g * L::RUN);
      const float2 y = stage[g * L::GS + (e - g * L::RUN)];
      const float2 w = __ldg(tw + pos);
      out[pos] = cmul(y, w.x, w.y);
    }
  }
}

// chirp_regs_c over S streams: block (x, s) as streams_block, its sums
// to partial row s G_s + x / TILES_C of `rows`.
template <int LOG2M>
__global__ void __launch_bounds__(ChirpRegs<LOG2M>::THREADS_C,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_C)
chirp_streams_c(const float2* __restrict__ scratch,   // (S*F, M)
                const float2* __restrict__ twiddle,   // pass_twiddles(M1)
                float* __restrict__ rows,             // (S*G_s, row)
                int bins, int row, int F, int group, int G_s,
                const int* __restrict__ counts) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P = RegsPlan<L::LOG2N1>;
  constexpr int TF = L::TF1;
  extern __shared__ float4 large_smem[];
  float2* xb = reinterpret_cast<float2*>(large_smem);
  const int tid = threadIdx.x;
  const int c = col_of<LOG2M>(tid);
  const int t = row_of<LOG2M>(tid);
  const int batch = blockIdx.x % CR::TILES_C;
  const StreamsBlock blk = streams_block(CR::TILES_C, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  const auto index = [c](int e) { return col_index<LOG2M>(c, e); };

  // Frame i's batch (a run of M1 B values, value e at (k1, column) =
  // (e / B, e mod B)) into buffer i & 1, in the exchange's layout.
  auto prefetch = [&](int i) {
    if (i < frames) {
      const float2* src = scratch +
                          static_cast<size_t>(first + i) * L::N +
                          static_cast<size_t>(batch) * L::N1 * L::B;
      float2* dst = xb + (i & 1) * CR::XFLOATS_C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = tid + j * CR::THREADS_C;
        cp_async_ca<8>(dst + col_index<LOG2M>(e % L::B, e / L::B), src + e);
      }
    }
    cp_async_commit();
  };

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    cp_async_wait<0>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; frame i - 1's buffer is free
    prefetch(i + 1);
    float2* x = xb + (i & 1) * CR::XFLOATS_C;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x[index(t + k * TF)];
    // Pass 0 writes the thread's own elements: no barrier before it.
    first_pass<L::LOG2N1>(v, x, twiddle, t, index);
    __syncthreads();
    col_pass<LOG2M, 1>(v, x, twiddle, t, c);
    if constexpr (P::PASSES > 2) {
      __syncthreads();
      col_pass<LOG2M, 2>(v, x, twiddle, t, c);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
  }
  cp_async_wait<0>();
  float* out = rows + static_cast<size_t>(blk.rest) * row;
  const int m2 = batch * L::B + c;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int m1 = pass_bin<L::LOG2N1>(last_element<L::LOG2N1>(t, k));
    const int m = m2 + (m1 << L::LOG2N2);
    if (m < bins) out[m] = acc[k];
  }
}

}  // namespace
