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
// constants' tables, float64 rounded once to f32).
//
// Form: three passes over device memory, M = M1 * M2 (M1 =
// 2^floor(log2 M / 2)), the inverse transform as the forward transform of
// the conjugate (IFFT(Y) = conj(FFT(conj Y)) / M, and |conj z|^2 =
// |z|^2, so the 1 / M rides on B and the last conjugation is dropped):
//  * Pass A (tile_cols_kernel<., true> of fft_mixed_tile.cuh): a tile of
//    C columns n2 of u[n1 M2 + n2] = x a (dequantized, [windowed,] times
//    the chirp; 0 where n >= N, never read), each a length-M1 DFT,
//    times W_M^(n2 k1), to scratch[f][k1][n2];
//  * Pass B (chirp_turn_kernel below): R rows k1 of a frame: the length-M2
//    DFT over n2, each Y[k1 + M1 k2] times B[k1 + M1 k2] / M (the table in
//    natural (k1, k2) order, gathered by the transform's digit-reversed
//    element), conjugated, to natural order k2 in a second buffer; the
//    length-M2 DFT of that over k2 (z's index m2), times W_M^(k1 m2), back
//    to the frame's own rows of scratch, scratch[f][k1][m2];
//  * Pass C (tile_power_kernel): a tile of columns m2, each the length-M1
//    DFT over k1 (m1), |z|^2 summed over the frames, written to bin m = m2
//    + M2 m1 of one partial row a block where m < N;
//  * psd_sum.cuh adds the partial rows in float64 in a fixed order.
// Every transform is fft_mixed.cuh's run-time mixed-radix passes on M1's
// and M2's power-of-two plans (radix 16 first), so that the kernels of ML
// (fused_psd_mixed_large.cu) serve both libraries; the large kernel's
// compile-time register passes (fft_regs.cuh) are a later redesign.
//
// What bounds it on an H100: besides the 2N bytes a frame read, the form
// moves 8M bytes of scratch a frame four times (written by A, read and
// written by B, read by C; at M = 2^20, F = 8, 256 MB, ~80 us at
// 3.35 TB/s), and does two M-point transforms a frame where the large
// kernel does one of N. This first form is plain: its times are written
// down (PERF.md), not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed_tile.cuh"
#include "psd_sum.cuh"

namespace {

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

}  // namespace

extern "C" {

// Launches passes A, B, C and the row sum on `stream`. raw: (F, 2N) u8,
// 4-byte aligned, N = bins; tw1, tw2: plan_twiddles of M1's and M2's
// plans; order1, order2: (M1,), (M2,) int32, element_of_bin of each;
// inter: (M1, M2) complex64, W_M^(k1 n2); chirp: (N,) complex64 a;
// window: (N,) f32, or null; spectrum: (M1, M2) complex64, B[k1 + M1 k2] /
// M at (k1, k2); scratch: (F, M) complex64; partial: (ceil(F / group_c),
// row) f32; out: (row,) f32, of which the first N are the bins (row: N
// rounded up to 32); plan1, plan2: the plans' ints. cols_a, rows_b,
// cols_c: the transforms of a tile of each pass; xs1, xs2: the tiles'
// strides (M1's for A and C, M2's for B); group_*: frames a block of each
// pass. Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_chirp_large(
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

// What a pass gets with `smem` dynamic bytes on `device` (which: 0 pass A,
// 1 pass A windowed, 2 pass B, 3 pass C), into attrs[0..5], as
// rpf_fused_psd_mixed_large_attributes. Launches nothing.
int rpf_fused_psd_chirp_large_attributes(int which, int smem, int device,
                                         int* attrs) {
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
