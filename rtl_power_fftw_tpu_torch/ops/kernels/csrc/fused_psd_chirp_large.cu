// The large chirp-Z (Bluestein) fused averaged-PSD step for NVIDIA Hopper
// (sm_90a), kernel "BL": the port's step at every even bin count from 8194
// to 2^21 that neither the power-of-two kernels nor the mixed-radix ones
// take (a prime factor above 7: 16382, 20002, 99998), and at any even N
// there under --fft-backend bluestein. It replaces
// rtl_power_fftw_tpu/ops/dft.py:bluestein_psd_partial (XLA's FFT, no
// Pallas kernel) above the awkward-N library's chirp-Z kernel, whose whole
// transform of M <= 16384 points lives in a block's shared memory.
//
// The function is K1/K2's: raw interleaved u8 IQ frames (F, 2N) ->
// dequantize (u8 - 127) -> [times window[n] in FP32] -> length-N DFT ->
// |X|^2 -> drop frames f >= n_valid -> sum over frames, an (N,) float32
// vector of bins in natural order. The DFT is the chirp-Z transform
// X[m] = a[m] IFFT_M(FFT_M(x a) B)[m], a[n] = e^(-i pi n^2 / N), B =
// FFT_M of the conjugate chirp laid out circularly, M = chirp_size(N), a
// power of two from 32768 to 2^22 (fused_psd_bluestein.bluestein_
// constants' tables, float64 rounded once to f32). The inverse runs as the
// forward transform of the conjugate (IFFT(Y) = conj(FFT(conj Y)) / M, and
// |conj z|^2 = |z|^2, so the 1 / M rides on B and the last conjugation is
// dropped).
//
// Form: three passes over device memory on the large kernel's register
// passes (fused_psd_large_regs.cuh: M = M1 * M2, its split, layouts and
// thread maps, instantiated at compile time on log2 M, 15..22), sample
// n = n1 M2 + n2, frequency k = k1 + M1 k2, output m = m2 + M2 m1; a
// batch-major complex f32 scratch between passes (value (k1, n2) at
// ((n2 / B) M1 + k1) B + n2 mod B, fused_psd_large.scratch_index of M):
//  * Pass A (chirp_regs_a): large_regs_a's column transforms (radix-16
//    register passes of length M1, B columns a batch, C a tile), each
//    sample dequantized [, windowed] and times a[n] (a table in the
//    threads' order, fused_psd_chirp_large.chirp_regs_table, so that a
//    warp reads 256 adjacent bytes), 0 where n >= N. As N <= M / 2, rows
//    n1 >= M1 / 2 hold no sample: the ring holds only the rows below, only
//    the rows with a sample are copied, and pass 0's first radix-2 stage
//    is the half-zero one. Raw frames are 4-byte aligned at N = 2 * odd,
//    so the ring's copies are `width` bytes (4, 8 or 16: fused_psd_mixed.
//    copy_width); the next frame's tile is in flight while one is
//    transformed. Outputs times W_M^(n2 k1) to scratch, as large_regs_a.
//  * Pass B (chirp_regs_b): large_regs_b's rows (B2 rows of M2 values a
//    block, the next frame's runs copied by cp.async.bulk on an mbarrier
//    while one is transformed), and both row transforms in the block: the
//    forward passes over n2, then in registers on the last pass's
//    outputs (the turn of fused_psd_chirp.cuh) each value times B[k1 + M1
//    k2] / M (a row of the table in the transform's element order, read
//    as the threads walk it), conjugated, and the same butterfly again;
//    the transposed passes (fft_regs.cuh's regs_pass_t) down to pass 0
//    then leave z[m2] in natural order, never in device memory between
//    the transforms. Times W_M^(k1 m2) (pass A's table: the same values
//    in the same order), staged by run through shared memory and written
//    back to the frame's own runs of scratch, whole lines.
//  * Pass C (chirp_regs_c): a block takes one batch of B columns m2 (a
//    contiguous run of M1 B values a frame), copied 8 bytes a value by
//    cp.async straight into the exchange layout of the column transform,
//    the next frame's into a second buffer while one is transformed; the
//    length-M1 transform over k1 (m1), and |z|^2 summed over the block's
//    frames in f32 registers (a thread's outputs are the same elements in
//    every frame). Bins m < N, at most half of each column's, are written
//    to one partial row a block, or to `out` where there is one row;
//    2..8 rows are added by psd_rows_sum, more by psd_sum.cuh, in float64
//    in a fixed order. No float atomics: the result is the same on every
//    run.
// Every pass moves whole 32-byte sectors to and from scratch: pass A a
// batch's run of M1 B values, pass B runs of B2 B (4 values at M = 2^22),
// pass C a batch's run.
//
// What bounds it on an H100: besides the 2N bytes a frame read, the form
// moves 8M bytes of scratch a frame four times (written by A, read and
// written by B, read by C; at M = 2^20, F = 8, 256 MB, ~80 us at
// 3.35 TB/s) and reads the chirp, B / M and W_M tables (4M, 8M and 8M
// bytes, from L2 where they stay there), and does two M-point transforms
// a frame where the large kernel does one of N.
//
// The control. The first form of the three passes (tile_cols_kernel
// with the chirp, chirp_turn_kernel below, tile_power_kernel: run-time
// mixed-radix plans of fft_mixed_tile.cuh, one frame at a time) stays,
// launched by rpf_fused_psd_chirp_large_control for chip_smoke.py to time
// the register passes against; it is never on a session's path.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed_tile.cuh"
#include "fft_regs.cuh"
#include "frame_ring.cuh"
#include "fused_psd_chirp.cuh"   // turn_inputs
#include "fused_psd_large_regs.cuh"
#include "fused_psd_chirp_large_regs.cuh"
#include "large_streams.cuh"
#include "psd_sum.cuh"

namespace {

// --- The control: the first form's run-time tile passes ---

// Pass B (see the top of the file): block b takes rows [k0, k0 + count)
// of frames [j * group, min((j + 1) * group, F, n_valid)); two tiles in
// shared memory, x (the row DFT's input and output) and z (the second
// DFT's).
__global__ void __launch_bounds__(kTileThreads)
chirp_turn_kernel(float2* __restrict__ scratch,          // (F, M1, M2)
                  const float2* __restrict__ twiddle,    // plan_twiddles(M2)
                  const int* __restrict__ order,         // (M2,) elements
                  const float2* __restrict__ spectrum,   // (M1, M2) B / M
                  const float2* __restrict__ inter,      // (M1, M2)
                  const TilePlan p, int m1_len, int count, int xs, int F,
                  int group, int n_valid) {
  extern __shared__ float4 tile_smem[];
  const int m2_len = p.n;
  const int frame = m1_len * m2_len;
  const int tid = threadIdx.x;
  float2* x = reinterpret_cast<float2*>(tile_smem);
  float2* z = x + count * xs;
  const int tiles = (m1_len + count - 1) / count;
  const int k0 = (blockIdx.x % tiles) * count;
  const int rows = min(count, m1_len - k0);
  const int f0 = (blockIdx.x / tiles) * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int n = rows * m2_len;
  for (int f = f0; f < f1; ++f) {
    float2* fr = scratch + static_cast<size_t>(f) * frame + k0 * m2_len;
    for (int i = tid; i < n; i += kTileThreads) {
      const int r = i / m2_len;
      x[r * xs + pad_index(i - r * m2_len)] = fr[i];
    }
    __syncthreads();
    tile_transform(x, xs, rows, p, twiddle, tid, kTileThreads);
    for (int i = tid; i < n; i += kTileThreads) {
      const int r = i / m2_len;
      const int k2 = i - r * m2_len;
      const float2 y = cmulf(x[r * xs + pad_index(__ldg(order + k2))],
                             __ldg(spectrum + k0 * m2_len + i));
      z[r * xs + pad_index(k2)] = make_float2(y.x, -y.y);
    }
    __syncthreads();
    tile_transform(z, xs, rows, p, twiddle, tid, kTileThreads);
    for (int i = tid; i < n; i += kTileThreads) {
      const int r = i / m2_len;
      const int m2 = i - r * m2_len;
      fr[i] = cmulf(z[r * xs + pad_index(__ldg(order + m2))],
                    __ldg(inter + k0 * m2_len + i));
    }
    __syncthreads();   // x and z are free for the next frame
  }
}

using ColsKernel = void (*)(const uint8_t*, const float2*, const int*,
                            const float2*, const float*, const float2*,
                            float2*, const TilePlan, int, int, int, int, int,
                            int, int);

ColsKernel cols_kernel(bool windowed) {
  return windowed ? tile_cols_kernel<true, true>
                  : tile_cols_kernel<false, true>;
}

// Pass A unwindowed, windowed, pass B, pass C.
std::atomic<unsigned long long> bl_done[4];

const void* bl_kernel(int which) {
  return which == 0   ? reinterpret_cast<const void*>(cols_kernel(false))
         : which == 1 ? reinterpret_cast<const void*>(cols_kernel(true))
         : which == 2 ? reinterpret_cast<const void*>(chirp_turn_kernel)
                      : reinterpret_cast<const void*>(tile_power_kernel);
}


// --- The register passes ---
// (Their shapes ChirpRegs, pass A's batch chirp_a_batch and the streams
// passes chirp_streams_a/b/c are in fused_psd_chirp_large_regs.cuh, which
// the estimators' forms share.)

constexpr int kChirpMinLog2M = 15;
constexpr int kChirpMaxLog2M = 22;

// Pass A. Block b serves column tile b mod TILES_A (columns [c0, c0 + C))
// of frames [j * group, min((j + 1) * group, F, n_valid)), j = b /
// TILES_A; frame i's rows with a sample in ring slot i & 1 while frame
// i - 1 is transformed.
template <int LOG2M, bool WINDOWED>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_A,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_A)
chirp_regs_a(const uint8_t* __restrict__ raw,      // (F, 2 bins)
             const float2* __restrict__ twiddle,   // pass_twiddles(M1)
             const float2* __restrict__ inter,     // W_M^(k1 n2), as scratch
             const float* __restrict__ window,     // (bins,) or null
             const float2* __restrict__ chirp,     // a, the threads' order
             float2* __restrict__ scratch,         // (F, M), batch-major
             int bins, int width, int F, int group, int n_valid) {
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
  const int f0 = (blockIdx.x / L::TILES_A) * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
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
          raw + static_cast<size_t>(f0 + i) * 2 * bins + 2 * c0;
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
    float2* out = scratch + static_cast<size_t>(f0 + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      chirp_a_batch<LOG2M, WINDOWED>(
          s, slot, window, chirp + (tile * L::SUBS + s) * CR::CHIRP_A, x,
          twiddle, inter, out, c, t, c0, bins);
    }
  }
  cp_async_wait<0>();
}

// Pass B. Block b serves rows [k0, k0 + B2), k0 = (b mod TILES_B) * B2, of
// frames [j * group, min((j + 1) * group, F, n_valid)), j = b / TILES_B:
// per frame and row k1, the length-M2 transform over n2, the turn (times
// B / M, conjugated, the last butterfly again), the transposed passes
// (z[m2] in natural order), times W_M^(k1 m2), back to the frame's runs.
template <int LOG2M>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_B,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_B)
chirp_regs_b(float2* __restrict__ scratch,           // (F, M), batch-major
             const float2* __restrict__ twiddle,     // pass_twiddles(M2)
             const float2* __restrict__ spectrum,    // (M1, M2) by element
             const float2* __restrict__ inter,       // W_M^(k1 m2), as scratch
             int F, int group, int n_valid) {
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
  const int f0 = (blockIdx.x / L::TILES_B) * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
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
                       scratch + static_cast<size_t>(f0 + i) * L::N +
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
    float2* out = scratch + static_cast<size_t>(f0 + i) * L::N + k0 * L::B;
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

// Pass C. Block b serves batch b mod TILES_C (columns m2 in [B j, B j +
// B), j = b mod TILES_C) of frames [g * group, min((g + 1) * group, F,
// n_valid)), g = b / TILES_C: per frame the length-M1 transform of each
// column over k1, |z|^2 summed in registers; then bin m = m2 + M2 m1 of
// row g of `rows` where m < bins.
template <int LOG2M>
__global__ void __launch_bounds__(ChirpRegs<LOG2M>::THREADS_C,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_C)
chirp_regs_c(const float2* __restrict__ scratch,   // (F, M), batch-major
             const float2* __restrict__ twiddle,   // pass_twiddles(M1)
             float* __restrict__ rows,             // (ceil(F / group), row)
             int bins, int row, int F, int group, int n_valid) {
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
  const int g = blockIdx.x / CR::TILES_C;
  const int f0 = g * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
  const auto index = [c](int e) { return col_index<LOG2M>(c, e); };

  // Frame i's batch (a run of M1 B values, value e at (k1, column) =
  // (e / B, e mod B)) into buffer i & 1, in the exchange's layout.
  auto prefetch = [&](int i) {
    if (i < frames) {
      const float2* src = scratch + static_cast<size_t>(f0 + i) * L::N +
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
  float* out = rows + static_cast<size_t>(g) * row;
  const int m2 = batch * L::B + c;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int m1 = pass_bin<L::LOG2N1>(last_element<L::LOG2N1>(t, k));
    const int m = m2 + (m1 << L::LOG2N2);
    if (m < bins) out[m] = acc[k];
  }
}

// Pass A unwindowed (0), windowed (1), pass B (2), pass C (3).
template <int LOG2M, int WHICH>
const void* chirp_regs_kernel() {
  if constexpr (WHICH == 0) {
    return reinterpret_cast<const void*>(chirp_regs_a<LOG2M, false>);
  } else if constexpr (WHICH == 1) {
    return reinterpret_cast<const void*>(chirp_regs_a<LOG2M, true>);
  } else if constexpr (WHICH == 2) {
    return reinterpret_cast<const void*>(chirp_regs_b<LOG2M>);
  } else {
    return reinterpret_cast<const void*>(chirp_regs_c<LOG2M>);
  }
}

template <int LOG2M, int WHICH>
constexpr int chirp_regs_smem() {
  using CR = ChirpRegs<LOG2M>;
  return WHICH <= 1 ? CR::SMEM_A : WHICH == 2 ? CR::SMEM_B : CR::SMEM_C;
}

template <int LOG2M, int WHICH>
constexpr int chirp_regs_threads() {
  using L = LargeRegs<LOG2M>;
  return WHICH == 2 ? L::THREADS_B : L::THREADS_A;
}

// The devices (a bit each) on which the pass is opted into its shared
// memory (tile_opt_in).
template <int LOG2M, int WHICH>
std::atomic<unsigned long long>& chirp_regs_done() {
  static std::atomic<unsigned long long> done{0};
  return done;
}

template <int LOG2M, int WHICH>
cudaError_t prepare_chirp_regs(int device) {
  return tile_opt_in(chirp_regs_kernel<LOG2M, WHICH>(),
                     chirp_regs_smem<LOG2M, WHICH>(), device,
                     chirp_regs_done<LOG2M, WHICH>());
}

// Passes A, B, C and, for 2 or more partial rows, their sum, on `st`.
template <int LOG2M>
cudaError_t launch_chirp_regs(const void* raw, const void* twiddle,
                              const void* inter, const void* window,
                              const void* chirp, const void* spectrum,
                              void* scratch, void* partial, void* out,
                              int bins, int width, int F, int group_a,
                              int group_b, int group_c, int n_valid,
                              int device, cudaStream_t st) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P1 = RegsPlan<L::LOG2N1>;
  const float2* tw_a = static_cast<const float2*>(twiddle);
  const float2* tw_b = tw_a + P1::twiddle_offset(P1::PASSES - 1);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  const int groups_c = (F + group_c - 1) / group_c;
  const bool windowed = window != nullptr;
  cudaError_t e = windowed ? prepare_chirp_regs<LOG2M, 1>(device)
                           : prepare_chirp_regs<LOG2M, 0>(device);
  if (e == cudaSuccess) e = prepare_chirp_regs<LOG2M, 2>(device);
  if (e == cudaSuccess) e = prepare_chirp_regs<LOG2M, 3>(device);
  if (e != cudaSuccess) return e;
  const int blocks_a = (F + group_a - 1) / group_a * L::TILES_A;
  if (windowed) {
    chirp_regs_a<LOG2M, true><<<blocks_a, L::THREADS_A, CR::SMEM_A, st>>>(
        static_cast<const uint8_t*>(raw), tw_a,
        static_cast<const float2*>(inter), static_cast<const float*>(window),
        static_cast<const float2*>(chirp), static_cast<float2*>(scratch),
        bins, width, F, group_a, n_valid);
  } else {
    chirp_regs_a<LOG2M, false><<<blocks_a, L::THREADS_A, CR::SMEM_A, st>>>(
        static_cast<const uint8_t*>(raw), tw_a,
        static_cast<const float2*>(inter), nullptr,
        static_cast<const float2*>(chirp), static_cast<float2*>(scratch),
        bins, width, F, group_a, n_valid);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chirp_regs_b<LOG2M>
      <<<(F + group_b - 1) / group_b * L::TILES_B, L::THREADS_B, CR::SMEM_B,
         st>>>(static_cast<float2*>(scratch), tw_b,
               static_cast<const float2*>(spectrum),
               static_cast<const float2*>(inter), F, group_b, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float* rows = static_cast<float*>(groups_c == 1 ? out : partial);
  chirp_regs_c<LOG2M>
      <<<groups_c * CR::TILES_C, CR::THREADS_C, CR::SMEM_C, st>>>(
          static_cast<const float2*>(scratch), tw_a, rows, bins, row, F,
          group_c, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups_c == 1) return e;
  if (groups_c <= kSumLanes) {
    const int n4 = row / 4;
    psd_rows_sum<<<(n4 + 255) / 256, 256, 0, st>>>(
        static_cast<const float4*>(partial), groups_c, n4,
        static_cast<float4*>(out));
    return cudaGetLastError();
  }
  return launch_psd_sum(partial, groups_c, row, out, st);
}

// The streams passes: A unwindowed (0), windowed (1), B (2), C (3).
template <int LOG2M, int WHICH>
const void* chirp_streams_kernel() {
  if constexpr (WHICH == 0) {
    return reinterpret_cast<const void*>(chirp_streams_a<LOG2M, false>);
  } else if constexpr (WHICH == 1) {
    return reinterpret_cast<const void*>(chirp_streams_a<LOG2M, true>);
  } else if constexpr (WHICH == 2) {
    return reinterpret_cast<const void*>(chirp_streams_b<LOG2M>);
  } else {
    return reinterpret_cast<const void*>(chirp_streams_c<LOG2M>);
  }
}

template <int LOG2M, int WHICH>
cudaError_t prepare_chirp_streams(int device) {
  return tile_opt_in(chirp_streams_kernel<LOG2M, WHICH>(),
                     chirp_regs_smem<LOG2M, WHICH>(), device,
                     chirp_regs_done<LOG2M, WHICH + 4>());
}

// The streams passes A, B, C over S streams and, for 2 or more partial
// rows a stream, each stream's sum, on `st`.
template <int LOG2M>
cudaError_t launch_chirp_streams(const void* raw, const void* twiddle,
                                 const void* inter, const void* window,
                                 const void* chirp, const void* spectrum,
                                 const int* counts, void* scratch,
                                 void* partial, void* out, int bins,
                                 int width, int S, int F, int group_a,
                                 int group_b, int group_c, int device,
                                 cudaStream_t st) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P1 = RegsPlan<L::LOG2N1>;
  const float2* tw_a = static_cast<const float2*>(twiddle);
  const float2* tw_b = tw_a + P1::twiddle_offset(P1::PASSES - 1);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  const int g_a = (F + group_a - 1) / group_a;
  const int g_b = (F + group_b - 1) / group_b;
  const int g_c = (F + group_c - 1) / group_c;
  const bool windowed = window != nullptr;
  cudaError_t e = windowed ? prepare_chirp_streams<LOG2M, 1>(device)
                           : prepare_chirp_streams<LOG2M, 0>(device);
  if (e == cudaSuccess) e = prepare_chirp_streams<LOG2M, 2>(device);
  if (e == cudaSuccess) e = prepare_chirp_streams<LOG2M, 3>(device);
  if (e != cudaSuccess) return e;
  const dim3 blocks_a(g_a * L::TILES_A, S);
  if (windowed) {
    chirp_streams_a<LOG2M, true>
        <<<blocks_a, L::THREADS_A, CR::SMEM_A, st>>>(
            static_cast<const uint8_t*>(raw), tw_a,
            static_cast<const float2*>(inter),
            static_cast<const float*>(window),
            static_cast<const float2*>(chirp), static_cast<float2*>(scratch),
            bins, width, F, group_a, g_a, counts);
  } else {
    chirp_streams_a<LOG2M, false>
        <<<blocks_a, L::THREADS_A, CR::SMEM_A, st>>>(
            static_cast<const uint8_t*>(raw), tw_a,
            static_cast<const float2*>(inter), nullptr,
            static_cast<const float2*>(chirp), static_cast<float2*>(scratch),
            bins, width, F, group_a, g_a, counts);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chirp_streams_b<LOG2M>
      <<<dim3(g_b * L::TILES_B, S), L::THREADS_B, CR::SMEM_B, st>>>(
          static_cast<float2*>(scratch), tw_b,
          static_cast<const float2*>(spectrum),
          static_cast<const float2*>(inter), F, group_b, g_b, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float* rows = static_cast<float*>(g_c == 1 ? out : partial);
  chirp_streams_c<LOG2M>
      <<<dim3(g_c * CR::TILES_C, S), CR::THREADS_C, CR::SMEM_C, st>>>(
          static_cast<const float2*>(scratch), tw_a, rows, bins, row, F,
          group_c, g_c, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess || g_c == 1) return e;
  return launch_rows_sum(partial, S, g_c, row, out, st);
}

// What a pass gets on `device` (tile_attributes).
template <int LOG2M, int WHICH>
cudaError_t chirp_regs_attributes(int device, int* attrs) {
  return tile_attributes(chirp_regs_kernel<LOG2M, WHICH>(),
                         chirp_regs_smem<LOG2M, WHICH>(), device,
                         chirp_regs_done<LOG2M, WHICH>(), attrs,
                         chirp_regs_threads<LOG2M, WHICH>());
}

}  // namespace

extern "C" {

// Launches the register passes A, B, C and, for 2 or more partial rows,
// their sum on `stream`. raw: (F, 2N) u8, `width`-byte aligned (4, 8 or
// 16, dividing 2N: fused_psd_mixed.copy_width), N = bins, M = 2^log2m =
// chirp_size(N); twiddle: pass_twiddles(M1) then pass_twiddles(M2);
// inter: (M,) complex64, W_M^(k1 n2) in scratch's batch-major order
// (fused_psd_large.regs_inter_twiddle of M); window: (N,) f32, or null;
// chirp: (M / 2,) complex64, a[n] in the threads' order
// (fused_psd_chirp_large.chirp_regs_table); spectrum: (M1, M2) complex64,
// B / M by element (spectrum_regs_table); scratch: (F, M) complex64;
// partial: (ceil(F / group_c), row) f32 (unused for one row); out: (row,)
// f32, of which the first N are the bins (row: N rounded up to 32).
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_chirp_large(const void* raw, const void* twiddle,
                              const void* inter, const void* window,
                              const void* chirp, const void* spectrum,
                              void* scratch, void* partial, void* out,
                              int device, int log2m, int bins, int width,
                              int F, int group_a, int group_b, int group_c,
                              int n_valid, void* stream) {
  if (log2m < kChirpMinLog2M || log2m > kChirpMaxLog2M || F <= 0 ||
      group_a <= 0 || group_b <= 0 || group_c <= 0 || n_valid < 0 ||
      n_valid > F || bins < 2 || bins % 2 != 0 ||
      2 * bins > (1 << log2m) || 4 * bins <= (1 << log2m) ||
      (width != 4 && width != 8 && width != 16) ||
      (2 * bins) % width != 0 ||
      reinterpret_cast<uintptr_t>(raw) % width != 0 || raw == nullptr ||
      chirp == nullptr || spectrum == nullptr || inter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_chirp_regs<L>(raw, twiddle, inter, window, chirp, spectrum,  \
                             scratch, partial, out, bins, width, F, group_a, \
                             group_b, group_c, n_valid, device, st);        \
    break;
  switch (log2m) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// The streams entry: S streams of F frames. raw: (S*F, 2N) u8, stream s
// in frames [s F, s F + F); counts: (S,) int32 on the device, each
// stream's valid frames (read when the passes run); scratch: (S*F, M)
// complex64; partial: (S * ceil(F / group_c), row) f32 (unused for one
// row a stream); out: (S, row) f32. The other arguments as
// rpf_fused_psd_chirp_large's. Returns a cudaError_t (0 on success); does
// not synchronise.
int rpf_fused_psd_chirp_large_streams(
    const void* raw, const void* twiddle, const void* inter,
    const void* window, const void* chirp, const void* spectrum,
    const void* counts, void* scratch, void* partial, void* out, int device,
    int log2m, int bins, int width, int S, int F, int group_a, int group_b,
    int group_c, void* stream) {
  if (log2m < kChirpMinLog2M || log2m > kChirpMaxLog2M || S <= 0 ||
      S > kMaxGridY ||
      F <= 0 || group_a <= 0 || group_b <= 0 || group_c <= 0 ||
      bins < 2 || bins % 2 != 0 || 2 * bins > (1 << log2m) ||
      4 * bins <= (1 << log2m) ||
      (width != 4 && width != 8 && width != 16) ||
      (2 * bins) % width != 0 ||
      reinterpret_cast<uintptr_t>(raw) % width != 0 || raw == nullptr ||
      chirp == nullptr || spectrum == nullptr || inter == nullptr ||
      counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* n_valid = static_cast<const int*>(counts);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = launch_chirp_streams<L>(raw, twiddle, inter, window, chirp,          \
                                spectrum, n_valid, scratch, partial, out,    \
                                bins, width, S, F, group_a, group_b,         \
                                group_c, device, st);                        \
    break;
  switch (log2m) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// Writes what a register pass gets at M = 2^log2m on `device` into
// attrs[0..5] (which: 0 pass A, 1 pass A windowed, 2 pass B, 3 pass C):
// registers and local (spill) bytes a thread, static and dynamic shared
// bytes a block, threads a block, and the blocks that reside on one SM.
// Launches nothing.
int rpf_fused_psd_chirp_large_attributes(int log2m, int which, int device,
                                         int* attrs) {
  if (log2m < kChirpMinLog2M || log2m > kChirpMaxLog2M || which < 0 ||
      which > 3 || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
#define RPF_CASE(L)                                                   \
  case L:                                                             \
    e = which == 0   ? chirp_regs_attributes<L, 0>(device, attrs)     \
        : which == 1 ? chirp_regs_attributes<L, 1>(device, attrs)     \
        : which == 2 ? chirp_regs_attributes<L, 2>(device, attrs)     \
                     : chirp_regs_attributes<L, 3>(device, attrs);    \
    break;
  switch (log2m) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// The control: the first form's passes A, B, C and the row sum on `stream`.
// raw: (F, 2N) u8, 4-byte aligned, N = bins; tw1, tw2: plan_twiddles of M1's
// and M2's plans; order1, order2: (M1,), (M2,) int32, element_of_bin of each;
// inter: (M1, M2) complex64, W_M^(k1 n2); chirp: (N,) complex64 a; window:
// (N,) f32, or null; spectrum: (M1, M2) complex64, B[k1 + M1 k2] / M at (k1,
// k2); scratch: (F, M) complex64; partial: (ceil(F / group_c), row) f32; out:
// (row,) f32, of which the first N are the bins (row: N rounded up to 32);
// plan1, plan2: the plans' ints. cols_a, rows_b, cols_c: the transforms of a
// tile of each pass; xs1, xs2: the tiles' strides (M1's for A and C, M2's for
// B); group_*: frames a block of each pass. Returns a cudaError_t (0 on
// success); does not synchronise.
int rpf_fused_psd_chirp_large_control(
    const void* raw, const void* tw1, const void* order1, const void* inter,
    const void* chirp, const void* window, const void* tw2,
    const void* order2, const void* spectrum, void* scratch, void* partial,
    void* out, const int* plan1, const int* plan2, int device, int bins,
    int F, int cols_a, int xs1, int group_a, int rows_b, int xs2,
    int group_b, int cols_c, int group_c, int n_valid, void* stream) {
  TilePlan p1, p2;
  if (!read_tile_plan(plan1, &p1) || !read_tile_plan(plan2, &p2) ||
      F <= 0 || n_valid < 0 || n_valid > F || group_a <= 0 ||
      group_b <= 0 || group_c <= 0 || cols_a < 1 || rows_b < 1 ||
      cols_c < 1 || xs1 < p1.n || xs2 < p2.n || raw == nullptr ||
      chirp == nullptr || spectrum == nullptr || order1 == nullptr ||
      order2 == nullptr || bins < 2 || bins % 2 != 0 ||
      2 * bins - 1 > p1.n * p2.n ||
      reinterpret_cast<uintptr_t>(raw) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = p1.n * p2.n;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  const int smem_a = tile_smem_bytes(cols_a, xs1, 0);
  const int smem_b = tile_smem_bytes(2 * rows_b, xs2, 0);
  const int smem_c = tile_smem_bytes(cols_c, xs1, 4 * p1.n);
  if (smem_a > kTileMaxSmem || smem_b > kTileMaxSmem ||
      smem_c > kTileMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = tile_opt_in(bl_kernel(windowed ? 1 : 0), smem_a, device,
                    bl_done[windowed ? 1 : 0]);
  }
  if (e == cudaSuccess) e = tile_opt_in(bl_kernel(2), smem_b, device, bl_done[2]);
  if (e == cudaSuccess) e = tile_opt_in(bl_kernel(3), smem_c, device, bl_done[3]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_a = (p2.n + cols_a - 1) / cols_a;
  const int tiles_b = (p1.n + rows_b - 1) / rows_b;
  const int tiles_c = (p2.n + cols_c - 1) / cols_c;
  const int groups_c = (F + group_c - 1) / group_c;
  cols_kernel(windowed)<<<(F + group_a - 1) / group_a * tiles_a,
                          kTileThreads, smem_a, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(tw1),
      static_cast<const int*>(order1), static_cast<const float2*>(inter),
      static_cast<const float*>(window), static_cast<const float2*>(chirp),
      static_cast<float2*>(scratch), p1, p2.n, bins, cols_a, xs1, F, group_a,
      n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chirp_turn_kernel<<<(F + group_b - 1) / group_b * tiles_b, kTileThreads,
                      smem_b, st>>>(
      static_cast<float2*>(scratch), static_cast<const float2*>(tw2),
      static_cast<const int*>(order2), static_cast<const float2*>(spectrum),
      static_cast<const float2*>(inter), p2, p1.n, rows_b, xs2, F, group_b,
      n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_power_kernel<<<groups_c * tiles_c, kTileThreads, smem_c, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(tw1),
      static_cast<const int*>(order1), static_cast<float*>(partial), p1,
      p2.n, p2.n, 1, M, bins, row, cols_c, xs1, F, group_c, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, groups_c, row, out, st));
}

// What a pass of the control gets with `smem` dynamic bytes on `device`
// (which: 0 pass A, 1 pass A windowed, 2 pass B, 3 pass C), into
// attrs[0..5], as rpf_fused_psd_chirp_large_attributes. Launches nothing.
int rpf_fused_psd_chirp_large_control_attributes(int which, int smem,
                                                 int device, int* attrs) {
  if (which < 0 || which > 3 || smem < 0 || smem > kTileMaxSmem ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      tile_attributes(bl_kernel(which), smem, device, bl_done[which], attrs));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
