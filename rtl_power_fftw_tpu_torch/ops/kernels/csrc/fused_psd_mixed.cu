// The awkward-N fused averaged-PSD steps for NVIDIA Hopper (sm_90a), one
// library:
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
//    circularly, M = max(64, next_pow2(2N - 1)) <= 16384.
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
// the shared-memory traffic of their passes, the barriers between them and
// the latency those expose.
//
// What the design does about it:
//  * the chirp-Z kernel (fused_psd_chirp.cuh) runs its two transforms on
//    K1's register FFT (fft_regs.cuh): the pass plan, radices, strides
//    and twiddle offsets fixed at compile time for each M, M / R_0 threads
//    a frame with R_0 values each in registers; the inverse is the
//    transposed register passes (no reorder: the forward transform leaves
//    FFT_M(x a) digit-reversed, the table B / M is held in that order,
//    fused_psd_bluestein.spectrum_table of this plan), the turn between
//    them in registers; pass 0's outputs belong to fixed threads, so |X|^2
//    is summed in registers and the row written once a block;
//  * the mixed-radix kernel (fused_psd_mixed_ring.cuh) keeps a run-time
//    plan (317 eligible N): the largest radices first, lanes of whole
//    warps (fused_psd_mixed.ring_shape picks the lane width with the
//    fewest idle thread slots over the passes), no division in its pass
//    loops (the plan holds a division constant for each stride), its
//    last-pass sums in registers across frames (two classes by how many);
//  * both keep the next frame in flight: cp.async copies its bytes into a
//    ring slot in shared memory, 16 bytes a copy where N and the pointer
//    allow it, else 8 or 4 (a frame of 2N bytes is only 4-byte aligned at
//    N = 2 * odd; frame_ring.cuh);
//  * the radix-R butterflies run in registers, radix 4/8/16 by
//    fft_regs.cuh's stages, 3/5/7 as direct DFTs over conjugate input
//    pairs; twiddles come from tables the host builds in float64 with
//    exact integer angle reduction, rounded once to float32; the chirp
//    tables likewise (n^2 mod 2N); a window is applied before the chirp,
//    in the order of bluestein_psd_partial; the final chirp is not applied
//    (|a[k]| = 1): no sincosf here;
//  * no float atomics: block g writes the f32 sum of its frames to
//    partial row g and psd_sum.cuh sums the rows in a fixed order in
//    float64, so the result is the same on every run; the streams entry
//    is K4's split of the same grid (block g serves stream g / G_s).
//
// The kernels these replaced (fused_psd_mixed.cuh over fft_mixed.cuh's
// run-time passes: no prefetch, the accumulator in shared memory) stay as
// the control, launched only by the *_control entries.

#include <atomic>

#include "fused_psd_chirp.cuh"
#include "fused_psd_mixed.cuh"
#include "fused_psd_mixed_ring.cuh"

namespace {

// A failed runtime call's error, taken off the thread's last error so that
// a later launch's check does not report it again.
cudaError_t failed(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// Opts `kernel` into `most` dynamic shared bytes where a launch of `smem`
// is above the 48 KB default, once per device for each slot of `done` (bit
// d for device d < 64; a device beyond that sets it every call).
cudaError_t opt_in(const void* kernel, int smem, int most, int device,
                   std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const cudaError_t e = failed(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// What `kernel` gets with `threads` and `smem`: registers and spill bytes
// a thread, static and dynamic shared bytes a block, threads a block, and
// the blocks that reside on one SM.
cudaError_t kernel_attributes(const void* kernel, int threads, int smem,
                              int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = failed(cudaFuncGetAttributes(&fa, kernel));
  if (e != cudaSuccess) return e;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = smem;
  attrs[4] = threads;
  return failed(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], kernel, threads, smem));
}

// ---- The mixed-radix kernel. ----

using RingKernel = void (*)(const uint8_t*, const float2*, const int*,
                            const float*, float*, const RingPlan, int, int,
                            int, int, int, const int*);

// The ring kernels, [windowed][index]: kRingAccSmall or kRingAccLarge
// last-pass sums a thread.
constexpr int kRingKernels = 2;

RingKernel ring_kernel(bool windowed, int index) {
  static const RingKernel plain[kRingKernels] = {
      psd_ring_kernel<false, kRingAccSmall>,
      psd_ring_kernel<false, kRingAccLarge>};
  static const RingKernel hann[kRingKernels] = {
      psd_ring_kernel<true, kRingAccSmall>,
      psd_ring_kernel<true, kRingAccLarge>};
  return windowed ? hann[index] : plain[index];
}

std::atomic<unsigned long long> ring_done[2][kRingKernels];

// Both passes for S streams of F frames, G_s blocks a stream.
int launch_ring(const void* raw, const void* twiddle, const void* order,
                const void* window, const void* stream_n_valid, void* partial,
                void* out,
                const int* plan, int device, int S, int F, int group,
                int G_s, int n_valid, int width, void* stream) {
  RingPlan p;
  cudaError_t e = read_ring_plan(plan, &p);
  int smem = 0;
  const int index = e == cudaSuccess ? ring_pick(p, &smem) : -1;
  if (index < 0 || !width_ok(raw, p.n, width) || order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  const RingKernel kernel = ring_kernel(windowed, index);
  e = use_device(device);
  if (e == cudaSuccess) {
    e = opt_in(reinterpret_cast<const void*>(kernel), smem, kRingMaxSmem,
               device, ring_done[windowed][index]);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<S * G_s, p.tf * p.lanes, smem, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const int*>(order), static_cast<const float*>(window),
      static_cast<float*>(partial), p, width, F, group, G_s, n_valid,
      static_cast<const int*>(stream_n_valid));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G_s, p.row, out, st, S));
}

// ---- The chirp-Z kernel. ----

using ChirpKernel = void (*)(const uint8_t*, const float2*, const float*,
                             const float2*, const float2*, float*, int, int,
                             int, int, int, int, int, const int*);

constexpr int kChirpMinLog2M = kRegsMinLog2N;
constexpr int kChirpMaxLog2M = kRegsMaxLog2N;
constexpr int kChirpSizes = kChirpMaxLog2M - kChirpMinLog2M + 1;

struct ChirpInfo {
  ChirpKernel kernel;
  int threads;
  int (*smem)(int bins);
};

template <int LOG2M, bool WINDOWED>
ChirpInfo chirp_info() {
  return {psd_chirp_kernel<LOG2M, WINDOWED>, ChirpShape<LOG2M>::THREADS,
          chirp_smem_bytes<LOG2M>};
}

template <bool WINDOWED>
ChirpInfo chirp_of(int log2m) {
  switch (log2m) {
    case 6: return chirp_info<6, WINDOWED>();
    case 7: return chirp_info<7, WINDOWED>();
    case 8: return chirp_info<8, WINDOWED>();
    case 9: return chirp_info<9, WINDOWED>();
    case 10: return chirp_info<10, WINDOWED>();
    case 11: return chirp_info<11, WINDOWED>();
    case 12: return chirp_info<12, WINDOWED>();
    case 13: return chirp_info<13, WINDOWED>();
    default: return chirp_info<14, WINDOWED>();
  }
}

std::atomic<unsigned long long> chirp_done[2][kChirpSizes];

int launch_chirp(const void* raw, const void* twiddle, const void* window,
                 const void* chirp, const void* spectrum,
                 const void* stream_n_valid, void* partial, void* out,
                 int device, int log2m, int bins, int S, int F, int group,
                 int G_s, int n_valid, int width, void* stream) {
  if (!chirp_size_ok(log2m, bins) || !width_ok(raw, bins, width) ||
      chirp == nullptr || spectrum == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  const ChirpInfo info =
      windowed ? chirp_of<true>(log2m) : chirp_of<false>(log2m);
  const int smem = info.smem(bins);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = opt_in(reinterpret_cast<const void*>(info.kernel), smem,
               kMixedMaxSmem, device,
               chirp_done[windowed][log2m - kChirpMinLog2M]);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  info.kernel<<<S * G_s, info.threads, smem, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float*>(window), static_cast<const float2*>(chirp),
      static_cast<const float2*>(spectrum), static_cast<float*>(partial),
      bins, row, width, F, group, G_s, n_valid,
      static_cast<const int*>(stream_n_valid));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G_s, row, out, st, S));
}

// ---- The control: the kernel both replaced. ----

using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, const int*,
                         int, int, int, int, int, int, void*);
using AttributesFn = int (*)(const int*, int, int*);

// The control's instantiation of a route: chirp-Z or mixed-radix,
// windowed or not.
LaunchFn launch_of(bool chirp, bool windowed) {
  if (chirp) {
    return windowed ? launch_mixed<true, true> : launch_mixed<true, false>;
  }
  return windowed ? launch_mixed<false, true> : launch_mixed<false, false>;
}

// The control's chirp-Z tables come both or neither, and the turn between
// its transforms is the last pass's butterfly, so its plan has two passes
// or more.
bool chirp_args_ok(const void* chirp, const void* spectrum, const int* plan) {
  if (chirp == nullptr && spectrum == nullptr) return true;
  return chirp != nullptr && spectrum != nullptr && plan != nullptr &&
         plan[3] >= 2;
}

}  // namespace

extern "C" {

// The mixed-radix kernel: launches both passes on `stream`. raw: (F, 2N)
// u8, `width`-byte aligned (4, 8 or 16, and 2N a multiple of it: the ring's
// copy width); twiddle: plan_twiddles of the plan, (rows, 2) f32; order:
// (N,) int32, the element that holds each bin (element_of_bin); window:
// (N,) f32, or null; partial: (ceil(F / group), row) f32 scratch; out:
// (row,) f32, of which the first N are the bins; plan: the wrapper's
// ring plan ints.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_mixed(const void* raw, const void* twiddle,
                        const void* order, const void* window, void* partial,
                        void* out, const int* plan, int device, int F,
                        int group, int n_valid, int width, void* stream) {
  if (!mixed_args_ok(1, F, group, n_valid, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_ring(raw, twiddle, order, window, nullptr, partial, out, plan,
                     device, 1, F, group, (F + group - 1) / group, n_valid,
                     width, stream);
}

// S streams of F frames. raw: (S*F, 2N) u8, stream s in rows
// [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read by the kernel
// when it runs (a count outside [0, F] acts as its nearest bound); group
// must divide F; partial: (S*F/group, row) f32 scratch; out: (S, row)
// f32. Other arguments as rpf_fused_psd_mixed.
int rpf_fused_psd_mixed_streams(const void* raw, const void* twiddle,
                                const void* order, const void* window,
                                const void* n_valid, void* partial, void* out,
                                const int* plan, int device, int S, int F,
                                int group, int width, void* stream) {
  if (!mixed_args_ok(S, F, group, 0, true) || n_valid == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_ring(raw, twiddle, order, window, n_valid, partial, out, plan,
                     device, S, F, group, F / group, 0, width, stream);
}

// What the mixed-radix kernel gets with the plan on `device`, into
// attrs[0..5] (as rpf_fused_psd_attributes). Launches nothing.
int rpf_fused_psd_mixed_attributes(const int* plan, int windowed, int device,
                                   int* attrs) {
  RingPlan p;
  cudaError_t e = read_ring_plan(plan, &p);
  int smem = 0;
  const int index = e == cudaSuccess ? ring_pick(p, &smem) : -1;
  if (index < 0 || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel =
      reinterpret_cast<const void*>(ring_kernel(windowed != 0, index));
  e = use_device(device);
  if (e == cudaSuccess) {
    e = opt_in(kernel, smem, kRingMaxSmem, device,
               ring_done[windowed != 0][index]);
  }
  if (e == cudaSuccess) {
    e = kernel_attributes(kernel, p.tf * p.lanes, smem, attrs);
  }
  return static_cast<int>(e);
}

// The chirp-Z kernel at N = bins, M = 2^log2m (max(64, next_pow2(2N -
// 1))): raw as rpf_fused_psd_mixed; twiddle: pass_twiddles(M); chirp: (N,)
// complex64 a; spectrum: (M,) complex64 B / M in the element order of M's
// register plan; partial: (ceil(F / group), row) f32; out: (row,) f32.
int rpf_fused_psd_chirp(const void* raw, const void* twiddle,
                        const void* window, const void* chirp,
                        const void* spectrum, void* partial, void* out,
                        int device, int log2m, int bins, int F, int group,
                        int n_valid, int width, void* stream) {
  if (!mixed_args_ok(1, F, group, n_valid, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_chirp(raw, twiddle, window, chirp, spectrum, nullptr,
                      partial, out, device, log2m, bins, 1, F, group,
                      (F + group - 1) / group, n_valid, width, stream);
}

// The chirp-Z kernel's streams entry (arguments as
// rpf_fused_psd_mixed_streams and rpf_fused_psd_chirp).
int rpf_fused_psd_chirp_streams(const void* raw, const void* twiddle,
                                const void* window, const void* chirp,
                                const void* spectrum, const void* n_valid,
                                void* partial, void* out, int device,
                                int log2m, int bins, int S, int F, int group,
                                int width, void* stream) {
  if (!mixed_args_ok(S, F, group, 0, true) || n_valid == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_chirp(raw, twiddle, window, chirp, spectrum, n_valid,
                      partial, out, device, log2m, bins, S, F, group,
                      F / group, 0, width, stream);
}

// What the chirp-Z kernel at M = 2^log2m, N = bins gets on `device`, into
// attrs[0..5]. Launches nothing.
int rpf_fused_psd_chirp_attributes(int log2m, int bins, int windowed,
                                   int device, int* attrs) {
  if (!chirp_size_ok(log2m, bins) || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChirpInfo info =
      windowed ? chirp_of<true>(log2m) : chirp_of<false>(log2m);
  const void* kernel = reinterpret_cast<const void*>(info.kernel);
  const int smem = info.smem(bins);
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = opt_in(kernel, smem, kMixedMaxSmem, device,
               chirp_done[windowed != 0][log2m - kChirpMinLog2M]);
  }
  if (e == cudaSuccess) {
    e = kernel_attributes(kernel, info.threads, smem, attrs);
  }
  return static_cast<int>(e);
}

// The control (the kernel of fused_psd_mixed.cuh): launches both passes
// on `stream`. raw: (F, 2N) u8, 2-byte aligned; twiddle: plan_twiddles
// of the plan, (rows, 2) f32; window: (N,) f32, or null; chirp, spectrum:
// null for the mixed-radix kernel, or the chirp-Z kernel's tables, (N,)
// complex64 a and (M,) complex64 B / M in the forward transform's element
// order; partial: (ceil(F / group), row) f32 scratch; out: (row,) f32, of
// which the first N are the bins; plan: the wrapper's plan ints (n = N, or
// M for the chirp-Z kernel; bins = N).
int rpf_fused_psd_mixed_control(const void* raw, const void* twiddle,
                                const void* window, const void* chirp,
                                const void* spectrum, void* partial,
                                void* out, const int* plan, int device,
                                int F, int group, int n_valid,
                                void* stream) {
  if (!mixed_args_ok(1, F, group, n_valid, false) ||
      !chirp_args_ok(chirp, spectrum, plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_of(chirp != nullptr, window != nullptr)(
      raw, twiddle, window, chirp, spectrum, nullptr, partial, out, plan,
      device, 1, F, group, (F + group - 1) / group, n_valid, stream);
}

// The control's streams entry. Arguments as rpf_fused_psd_mixed_streams
// and rpf_fused_psd_mixed_control.
int rpf_fused_psd_mixed_control_streams(const void* raw, const void* twiddle,
                                        const void* window, const void* chirp,
                                        const void* spectrum,
                                        const void* n_valid, void* partial,
                                        void* out, const int* plan,
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

// What the control of the route (chirp-Z or not, windowed or not) gets
// with the plan on `device`, into attrs[0..5]. Launches nothing.
int rpf_fused_psd_mixed_control_attributes(const int* plan, int chirp,
                                           int windowed, int device,
                                           int* attrs) {
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
