// Per-frame spectra for NVIDIA Hopper (sm_90a): the frames kernel "FR".
//
// The device step of the library estimators that need each frame's
// spectrum, not the sum of |X|^2 over frames: the JAX package's
// spectrogram (rtl_power_fftw_tpu/models/spectrogram.py:_spectrogram_step,
// the fftshifted |X|^2 of every frame) and spectral_correlation
// (models/cyclo.py:_scf_step, whose products start from each frame's X);
// XLA there, no Pallas kernel. Raw interleaved u8 IQ frames (F, 2N) ->
// dequantize (u8 - 127) -> [times window[n] in FP32] -> length-N DFT ->
// per valid frame f < n_valid, one of
//
//   power    |X|^2 in fftshifted bin order, row f of an (F, N) f32 output;
//   complex  X in natural bin order, row f of an (F, N) complex64 output.
//
// Rows at or past n_valid are not written (the output is torch.empty).
//
// The kernel is K1's group kernel (fused_psd_regs.cuh) with the cuts
// kRegsFrames and kRegsFramesComplex: the same load (the next frame's
// bytes by cp.async into a two-slot ring), dequantization, window and
// register transform, on K1's grid rule over its own occupancy; after the
// transform each frame's row is staged by bin through the lane's exchange
// buffer (regs_frame_store) and stored coalesced. What bounds it on the
// card is the store: 4N (power) or 8N (complex) bytes a frame against 2N
// read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;

template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_regs_kernel<LOG2N, WINDOWED, CUT>,
                     RegsShape<LOG2N>::SMEM_BYTES, device, done);
}

template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t launch(const void* raw, const void* twiddle, const void* window,
                   void* out, int F, int group, int n_valid, int device,
                   cudaStream_t stream) {
  const cudaError_t e = prepare<LOG2N, WINDOWED, CUT>(device);
  if (e != cudaSuccess) return e;
  const int blocks = (F + group - 1) / group;
  psd_regs_kernel<LOG2N, WINDOWED, CUT>
      <<<blocks, RegsShape<LOG2N>::THREADS, RegsShape<LOG2N>::SMEM_BYTES,
         stream>>>(static_cast<const uint8_t*>(raw),
                   static_cast<const float2*>(twiddle),
                   static_cast<const float*>(window),
                   static_cast<float*>(out), F, group, blocks, n_valid,
                   nullptr);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_any(const void* raw, const void* twiddle,
                       const void* window, void* out, int F, int group,
                       int n_valid, int complex_out, int device,
                       cudaStream_t stream) {
  if (window == nullptr) {
    return complex_out
               ? launch<LOG2N, false, kRegsFramesComplex>(
                     raw, twiddle, window, out, F, group, n_valid, device,
                     stream)
               : launch<LOG2N, false, kRegsFrames>(raw, twiddle, window, out,
                                                   F, group, n_valid, device,
                                                   stream);
  }
  return complex_out
             ? launch<LOG2N, true, kRegsFramesComplex>(
                   raw, twiddle, window, out, F, group, n_valid, device,
                   stream)
             : launch<LOG2N, true, kRegsFrames>(raw, twiddle, window, out, F,
                                                group, n_valid, device,
                                                stream);
}

template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t attributes(int device, int* attrs) {
  const cudaError_t e = prepare<LOG2N, WINDOWED, CUT>(device);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_regs_kernel<LOG2N, WINDOWED, CUT>,
                           RegsShape<LOG2N>::THREADS,
                           RegsShape<LOG2N>::SMEM_BYTES, attrs);
}

template <int LOG2N>
cudaError_t attributes_any(int windowed, int complex_out, int device,
                           int* attrs) {
  if (windowed) {
    return complex_out ? attributes<LOG2N, true, kRegsFramesComplex>(device,
                                                                     attrs)
                       : attributes<LOG2N, true, kRegsFrames>(device, attrs);
  }
  return complex_out ? attributes<LOG2N, false, kRegsFramesComplex>(device,
                                                                    attrs)
                     : attributes<LOG2N, false, kRegsFrames>(device, attrs);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; window: (N,) f32, or null;
// out: (F, N) f32 (complex_out = 0: |X|^2, fftshifted) or (F, N, 2) f32
// (complex_out = 1: X, natural order), rows f < n_valid written; group:
// frames a block. Returns a cudaError_t (0 on success); does not
// synchronise.
int rpf_fused_psd_frames(const void* raw, const void* twiddle,
                         const void* window, void* out, int device, int log2n,
                         int F, int group, int n_valid, int complex_out,
                         void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_any<L>(raw, twiddle, window, out, F, group, n_valid,         \
                      complex_out, device, st);                             \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// What the kernel gets at N = 2^log2n (windowed, complex_out as above) on
// `device`: attrs[0..5] as fused_psd.cu's rpf_fused_psd_attributes.
// Launches nothing.
int rpf_fused_psd_frames_attributes(int log2n, int windowed, int complex_out,
                                    int device, int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = attributes_any<L>(windowed, complex_out, device, attrs);             \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
