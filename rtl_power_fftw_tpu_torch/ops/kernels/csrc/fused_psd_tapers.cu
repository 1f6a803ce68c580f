// Thomson multitaper device step for NVIDIA Hopper (sm_90a).
//
// Replaces the device step of rtl_power_fftw_tpu/models/multitaper.py
// (_mt_core, 60-133; XLA there, no Pallas kernel): raw interleaved u8 IQ
// frames (F, 2N) -> dequantize (u8 - 127) -> times taper k (row k of a
// (K, N) float32 table) -> length-N DFT -> |X|^2 -> drop frames f >=
// n_valid -> the sum over frames and tapers, divided by K in float32 (the
// mean eigenspectrum, summed over frames), as an (N,) float32 vector of
// bins in natural (unshifted) order.
//
// The design is K2's (fused_psd.cu) with a taper axis on the grid: block
// (g, k) is psd_regs_kernel<LOG2N, true, kRegsTapers> of
// fused_psd_regs.cuh, K2's group kernel with row k of the table as its
// window, over frames [g * group, (g + 1) * group); it writes partial row
// k * G + g. est_sum_kernel (fused_psd_est.cuh, kEstTapers) sums all K * G
// rows in float64 and divides by K. Each frame is read K times, once by
// each taper's block (from L2 after the first); the table is read once a
// block into registers, as K2's window is.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kMaxTapers = 32;

template <int LOG2N>
cudaError_t prepare(int device, int* smem) {
  static std::atomic<unsigned long long> done{0};
  *smem = RegsShape<LOG2N>::SMEM_BYTES;
  return opt_in_smem(psd_regs_kernel<LOG2N, true, kRegsTapers>, *smem,
                     device, done);
}

template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* tapers, void* partial, int F, int group,
                          int blocks, int K, int n_valid, int device,
                          cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N>(device, &smem);
  if (e != cudaSuccess) return e;
  psd_regs_kernel<LOG2N, true, kRegsTapers>
      <<<dim3(blocks, K), RegsShape<LOG2N>::THREADS, smem, stream>>>(
          static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float*>(tapers), static_cast<float*>(partial), F,
          group, blocks, n_valid, nullptr);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t attributes(int device, int* attrs) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N>(device, &smem);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_regs_kernel<LOG2N, true, kRegsTapers>,
                           RegsShape<LOG2N>::THREADS, smem, attrs);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; tapers: (K, N) f32, 1 <= K <=
// 32; partial: (K * ceil(F / group), N) f32 scratch; out: (N,) f32.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_tapers(const void* raw, const void* twiddle,
                         const void* tapers, void* partial, void* out,
                         int device, int log2n, int F, int group, int K,
                         int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      K < 1 || K > kMaxTapers || n_valid < 0 || n_valid > F ||
      tapers == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_groups<L>(raw, twiddle, tapers, partial, F, group, blocks,   \
                         K, n_valid, device, st);                           \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  est_sum_kernel<kEstTapers><<<N / kSumBins, kSumBins * kSumLanes, 0, st>>>(
      static_cast<const float*>(partial), K * blocks, N, K, 0.0f,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// What the first pass gets at N = 2^log2n on `device`: attrs[0..5] as
// fused_psd.cu's rpf_fused_psd_attributes. Launches nothing.
int rpf_fused_psd_tapers_attributes(int log2n, int device, int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = attributes<L>(device, attrs);                                        \
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
