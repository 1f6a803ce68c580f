// The awkward-N fused averaged-PSD steps for NVIDIA Hopper (sm_90a), one
// library over the template of fused_psd_mixed.cuh:
//  * the mixed-radix kernel: the port's step at the even 7-smooth bin
//    counts (every prime factor <= 7) up to 16384 that the power-of-two
//    kernels do not take. Its JAX counterpart has no Pallas kernel: the
//    JAX package computes these N with XLA's FFT through its transform
//    ladder (the fourstep, hybrid, xla and fft4 rungs of
//    rtl_power_fftw_tpu/ops/spectral.py);
//  * the chirp-Z (Bluestein) kernel: the step at the even bin counts up
//    to 8192 with a prime factor above 7 (and at any even N up to 8192
//    under --fft-backend bluestein). It replaces
//    rtl_power_fftw_tpu/ops/dft.py:bluestein_psd_partial (XLA's FFT, no
//    Pallas kernel). The DFT is X[k] = a[k] IFFT_M(FFT_M(x a) B)[k], a the
//    chirp e^(-i pi n^2 / N), B = FFT_M of its conjugate laid out
//    circularly, M = next_pow2(2N - 1) <= 16384.
//
// The function is K1/K2's (fused_psd.cu): raw interleaved u8 IQ frames
// (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in FP32] ->
// length-N DFT -> |X|^2 -> drop frames f >= n_valid -> sum over frames,
// an (N,) float32 vector of bins in natural (unshifted) order; the
// streams entry takes S streams of F frames, (S*F, 2N), with a count
// n_valid[s] per stream, and gives one such vector per stream, (S, N).
//
// What bounds it on an H100: for the mixed-radix kernel the bound of the
// function is the 2 bytes a sample it reads and the FP32 rate about
// equally (4 N log2 N - 6 N flops a frame, ~19 flop/byte at N = 2400: at
// F = 4096, ~5.9 us of device memory and ~5.7 us of FP32 at the H100
// SXM's peaks); the chirp-Z kernel does two M-point transforms a frame
// where K1 does one N-point transform (M >= 2N: over four times the
// flops, about 11 us of FP32 work at N = 998, F = 4096, against the
// 2.4 us its 8 MB of frames take to read). Both are first held back by
// the shared-memory traffic of their passes and the barriers between
// them; radix 3, 5 and 7 passes add to both.
//
// What the design does about it (fused_psd_mixed.cuh, fft_mixed.cuh):
//  * the plan (the wrapper's mixed_plan) takes the largest radices it can
//    (16, 8, then 7, 5, 3, then 4 or 2 for what is left), so a frame goes
//    through as few exchanges as its factors allow; the first pass runs
//    in registers on the samples as the thread reads them;
//  * the radix-R butterflies run in registers, radix 4/8/16 by
//    fft_regs.cuh's stages, 3/5/7 as direct DFTs over conjugate input
//    pairs; twiddles between passes come from one table the host builds
//    in float64 with exact integer angle reduction, rounded once to
//    float32 (plan_twiddles in fused_psd_mixed.py): no sincosf here;
//  * the chirp-Z kernel's inverse transform needs no reorder: the forward
//    transform leaves FFT_M(x a) in digit-reversed order, the table B / M
//    is held in that order (the wrapper permutes it), and the transposed
//    passes run on its conjugate give the conjugate of the inverse
//    transform in natural order, whose |.|^2 is the power; the last
//    forward pass and the first inverse pass are one turn in registers;
//    the chirp tables (a and B / M) are built on the host in float64 with
//    exact integer angle reduction (n^2 mod 2N) and rounded once, as
//    bluestein_psd_partial's; a window is applied before the chirp, in
//    the order of bluestein_psd_partial; the final chirp is not applied
//    (|a[k]| = 1);
//  * frames are read as u16 pairs (a frame of 2N bytes is only 4-byte
//    aligned at N = 2 * odd, so K1's 16-byte cp.async does not carry
//    over); at small N several frames share a block as lanes; at
//    M = 16384 a lane's exchange buffer takes 139 KB of shared memory, so
//    one frame a block (the opt-in above 48 KB);
//  * no float atomics: block g writes the f32 sum of its frames to
//    partial row g and psd_sum.cuh sums the rows in a fixed order in
//    float64, so the result is the same on every run; the streams entry
//    is K4's split of the same grid (block g serves stream g / G_s).
//
// These are simple kernels that are right first: no prefetch of the next
// frame, one block barrier between passes, the accumulator in shared
// memory.

#include "fused_psd_mixed.cuh"

namespace {

using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, const int*,
                         int, int, int, int, int, int, void*);
using AttributesFn = int (*)(const int*, int, int*);

// The instantiation of a route: chirp-Z or mixed-radix, windowed or not.
LaunchFn launch_of(bool chirp, bool windowed) {
  if (chirp) {
    return windowed ? launch_mixed<true, true> : launch_mixed<true, false>;
  }
  return windowed ? launch_mixed<false, true> : launch_mixed<false, false>;
}

// The chirp-Z tables come both or neither, and the turn between its
// transforms is the last pass's butterfly, so its plan has two passes or
// more.
bool chirp_args_ok(const void* chirp, const void* spectrum, const int* plan) {
  if (chirp == nullptr && spectrum == nullptr) return true;
  return chirp != nullptr && spectrum != nullptr && plan != nullptr &&
         plan[3] >= 2;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 2-byte aligned;
// twiddle: plan_twiddles of the plan, (rows, 2) f32; window: (N,) f32, or
// null; chirp, spectrum: null for the mixed-radix kernel, or the chirp-Z
// kernel's tables, (N,) complex64 a and (M,) complex64 B / M in the
// forward transform's element order; partial: (ceil(F / group), row) f32
// scratch; out: (row,) f32, of which the first N are the bins; plan: the
// wrapper's plan ints (n = N, or M for the chirp-Z kernel; bins = N).
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_mixed(const void* raw, const void* twiddle,
                        const void* window, const void* chirp,
                        const void* spectrum, void* partial, void* out,
                        const int* plan, int device, int F, int group,
                        int n_valid, void* stream) {
  if (!mixed_args_ok(1, F, group, n_valid, false) ||
      !chirp_args_ok(chirp, spectrum, plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_of(chirp != nullptr, window != nullptr)(
      raw, twiddle, window, chirp, spectrum, nullptr, partial, out, plan,
      device, 1, F, group, (F + group - 1) / group, n_valid, stream);
}

// S streams of F frames. raw: (S*F, 2N) u8, stream s in rows
// [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read by the kernel
// when it runs (a count outside [0, F] acts as its nearest bound); group
// must divide F; partial: (S*F/group, row) f32 scratch; out: (S, row)
// f32. Other arguments as rpf_fused_psd_mixed.
int rpf_fused_psd_mixed_streams(const void* raw, const void* twiddle,
                                const void* window, const void* chirp,
                                const void* spectrum, const void* n_valid,
                                void* partial, void* out, const int* plan,
                                int device, int S, int F, int group,
                                void* stream) {
  if (!mixed_args_ok(S, F, group, 0, true) || n_valid == nullptr ||
      !chirp_args_ok(chirp, spectrum, plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_of(chirp != nullptr, window != nullptr)(
      raw, twiddle, window, chirp, spectrum, n_valid, partial, out, plan,
      device, S, F, group, F / group, 0, stream);
}

// Writes what the kernel of the route (chirp-Z or not, windowed or not)
// gets with the plan on `device` into attrs[0..5]: registers and local
// (spill) bytes a thread, static and dynamic shared bytes a block,
// threads a block, and the blocks that reside on one SM. Launches
// nothing.
int rpf_fused_psd_mixed_attributes(const int* plan, int chirp, int windowed,
                                   int device, int* attrs) {
  AttributesFn fn =
      chirp ? (windowed ? mixed_attributes<true, true>
                        : mixed_attributes<true, false>)
            : (windowed ? mixed_attributes<false, true>
                        : mixed_attributes<false, false>);
  return fn(plan, device, attrs);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
