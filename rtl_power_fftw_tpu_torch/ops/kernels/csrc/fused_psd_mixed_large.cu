// The large mixed-radix fused averaged-PSD step for NVIDIA Hopper (sm_90a),
// kernel "ML": the port's step at the even 7-smooth bin counts (every prime
// factor <= 7) from 16386 to 2^22 that are not powers of two (20000, 49152,
// 100000, 10^6). Its JAX counterpart has no Pallas kernel: the JAX package
// computes these N with XLA's FFT through its transform ladder (the fft4
// rung of rtl_power_fftw_tpu/ops/spectral.py on the CPU).
//
// The function is the large kernel's (fused_psd_large.cu): raw interleaved
// u8 IQ frames (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in
// FP32] -> length-N DFT in FP32 -> |X|^2 -> drop frames f >= n_valid ->
// sum over frames, an (N,) float32 vector of bins in natural (unshifted)
// order.
//
// Form: a four-step FFT over device memory, N = N1 * N2 with both factors
// 7-smooth (fused_psd_mixed_large.mixed_large_split: the divisor of N
// nearest sqrt(N) with N1 <= 2048 and N2 <= 16384); sample n = n1 N2 + n2,
// bin k = k1 + N1 k2.
//  * Pass A (tile_cols_kernel of fft_mixed_tile.cuh): a block takes a tile
//    of C columns n2 (fused_psd_mixed_large.tile_count) of its frames, each
//    a length-N1 mixed-radix DFT by the run-time passes of fft_mixed.cuh in
//    shared memory, the window applied at the dequantization, and writes
//    Y[k1][n2] times the inter-stage twiddle W_N^(n2 k1) (the f32 rounding
//    of a float64 product, fused_psd_mixed_large.inter_twiddle) to a
//    complex f32 scratch, (F, N1, N2) row-major;
//  * Pass B (tile_power_kernel): a block takes R rows k1 of its frames,
//    each a length-N2 DFT by the same passes, |X|^2 summed over the frames
//    in shared memory, then its bins k1 + N1 k2 of one partial row a block
//    (k2's element by the plan's digit reversal, the host's
//    element_of_bin);
//  * psd_sum.cuh adds the partial rows in float64 in a fixed order.
// Frames >= n_valid are neither transformed nor written, and their scratch
// is never read. No float atomics: the result is the same on every run.
//
// What bounds it on an H100: the function reads 2N bytes a frame for about
// 5 N log2 N FP32 flops; this two-pass form also writes and reads back 8N
// bytes of scratch a frame (at 10^6, F = 8: 64 MB each way, ~38 us at
// 3.35 TB/s), the floor of the form. This first form is plain: one frame
// at a time, integer division in its loop indices, strided shared-memory
// reads; its times are written down (PERF.md), not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed_tile.cuh"
#include "psd_sum.cuh"

namespace {

using ColsKernel = void (*)(const uint8_t*, const float2*, const int*,
                            const float2*, const float*, const float2*,
                            float2*, const TilePlan, int, int, int, int, int,
                            int, int);

ColsKernel cols_kernel(bool windowed) {
  return windowed ? tile_cols_kernel<true, false>
                  : tile_cols_kernel<false, false>;
}

// Pass A unwindowed, windowed, pass B.
std::atomic<unsigned long long> ml_done[3];

const void* ml_kernel(int which) {
  return which == 0   ? reinterpret_cast<const void*>(cols_kernel(false))
         : which == 1 ? reinterpret_cast<const void*>(cols_kernel(true))
                      : reinterpret_cast<const void*>(tile_power_kernel);
}

}  // namespace

extern "C" {

// Launches pass A, pass B and the row sum on `stream`. raw: (F, 2N) u8,
// 4-byte aligned; tw1, tw2: plan_twiddles of N1's and N2's plans, (rows,
// 2) f32; order1, order2: (N1,), (N2,) int32, element_of_bin of each plan;
// inter: (N1, N2) complex64, W_N^(k1 n2); window: (N,) f32, or null;
// scratch: (F, N) complex64; partial: (ceil(F / group_b), row) f32; out:
// (row,) f32, of which the first N are the bins (row: N rounded up to 32);
// plan1, plan2: the plans' ints (n, passes, radices). cols: columns a
// pass-A tile; rows: rows a pass-B tile; xs1, xs2: the tiles' strides.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_mixed_large(const void* raw, const void* tw1,
                              const void* order1, const void* inter,
                              const void* window, const void* tw2,
                              const void* order2, void* scratch,
                              void* partial, void* out, const int* plan1,
                              const int* plan2, int device, int F, int cols,
                              int xs1, int group_a, int rows, int xs2,
                              int group_b, int n_valid, void* stream) {
  TilePlan p1, p2;
  if (!read_tile_plan(plan1, &p1) || !read_tile_plan(plan2, &p2) ||
      F <= 0 || n_valid < 0 || n_valid > F || group_a <= 0 ||
      group_b <= 0 || cols < 1 || rows < 1 || xs1 < p1.n || xs2 < p2.n ||
      raw == nullptr || order1 == nullptr || order2 == nullptr ||
      reinterpret_cast<uintptr_t>(raw) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = p1.n * p2.n;
  const int row = (N + kSumBins - 1) / kSumBins * kSumBins;
  const int smem_a = tile_smem_bytes(cols, xs1, 0);
  const int smem_b = tile_smem_bytes(rows, xs2, 4 * p2.n);
  if (smem_a > kTileMaxSmem || smem_b > kTileMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_kernel(windowed ? 1 : 0), smem_a, device,
                    ml_done[windowed ? 1 : 0]);
  }
  if (e == cudaSuccess) e = tile_opt_in(ml_kernel(2), smem_b, device, ml_done[2]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_a = (p2.n + cols - 1) / cols;
  const int tiles_b = (p1.n + rows - 1) / rows;
  const int groups_b = (F + group_b - 1) / group_b;
  cols_kernel(windowed)<<<(F + group_a - 1) / group_a * tiles_a,
                          kTileThreads, smem_a, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(tw1),
      static_cast<const int*>(order1), static_cast<const float2*>(inter),
      static_cast<const float*>(window), nullptr,
      static_cast<float2*>(scratch), p1, p2.n, N, cols, xs1, F, group_a,
      n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_power_kernel<<<groups_b * tiles_b, kTileThreads, smem_b, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(tw2),
      static_cast<const int*>(order2), static_cast<float*>(partial), p2,
      p1.n, 1, p2.n, N, N, row, rows, xs2, F, group_b, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, groups_b, row, out, st));
}

// What a pass gets with `smem` dynamic bytes on `device` (which: 0 pass A,
// 1 pass A windowed, 2 pass B), into attrs[0..5]: registers and spill
// bytes a thread, static and dynamic shared bytes a block, threads a
// block, and the blocks that reside on one SM. Launches nothing.
int rpf_fused_psd_mixed_large_attributes(int which, int smem, int device,
                                         int* attrs) {
  if (which < 0 || which > 2 || smem < 0 || smem > kTileMaxSmem ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      tile_attributes(ml_kernel(which), smem, device, ml_done[which], attrs));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
