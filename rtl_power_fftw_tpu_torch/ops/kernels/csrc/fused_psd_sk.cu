// Spectral-kurtosis device step for NVIDIA Hopper (sm_90a): both spectral
// moments of raw u8 IQ frames in one pass.
//
// Replaces the device step of rtl_power_fftw_tpu/models/kurtosis.py
// (_sk_step, 46-93; XLA there, no Pallas kernel): raw interleaved u8 IQ
// frames (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in FP32] ->
// length-N DFT -> |X|^2 -> drop frames f >= n_valid -> s1 = the sum over
// frames of |X|^2 and s2 = the sum of |X|^4, each an (N,) float32 vector of
// bins in natural (unshifted) order. With sigma > 0 (--sk-excise) it also
// gates the block on its own SK (fused_psd_est.cuh, kEstSkGate) and gives
// s1 * keep and n_valid * keep.
//
// The design is K1/K2's (fused_psd.cu): the first pass is their group
// kernel, psd_regs_kernel<LOG2N, WINDOWED, kRegsSk> of
// fused_psd_regs.cuh, which keeps a second f32 register sum, of p * p,
// beside each sum of p = |X|^2 and writes it to a second plane of partial
// rows; the second pass is est_sum_kernel, psd_sum.cuh's float64 row sum
// over both planes. The wrapper (fused_psd_sk.py) gives it K1's grid
// (fused_psd.k1_group from K1's own occupancy), so its s1 is K1's (K2's)
// output bit for bit on the same frames, n_valid and chunk: the same
// frames a block, the same f32 sums in the same order, the same row sum.
//
// What it costs over K1: R more f32 registers a thread held across the
// frames (the |X|^4 sums), one FMA a bin and frame, and a second plane of
// partial rows to write and read. The build's attributes, as chip_smoke.py
// prints them (nvcc 12.9, NVIDIA H100 80GB HBM3, 700.00 W): at N = 2048,
// 172 registers unwindowed and 170 windowed, 1 block/SM, where K1 has 80
// registers and 3 blocks/SM and K2 128 and 2; at N = 256, 80 and 102
// registers; at N = 16384, where the 1024-thread block holds a thread to
// 64 registers, a 264 and a 336 B stack frame of spills (K1's 200, K2's
// 264). Occupancy does not change the grid: the wrapper takes K1's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;

template <int LOG2N, bool WINDOWED>
cudaError_t prepare(int device, int* smem) {
  static std::atomic<unsigned long long> done{0};
  *smem = RegsShape<LOG2N>::SMEM_BYTES;
  return opt_in_smem(psd_regs_kernel<LOG2N, WINDOWED, kRegsSk>, *smem,
                     device, done);
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int blocks, int n_valid, int device,
                          cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N, WINDOWED>(device, &smem);
  if (e != cudaSuccess) return e;
  psd_regs_kernel<LOG2N, WINDOWED, kRegsSk>
      <<<blocks, RegsShape<LOG2N>::THREADS, smem, stream>>>(
          static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float*>(window), static_cast<float*>(partial), F,
          group, blocks, n_valid, nullptr);
  return cudaGetLastError();
}

template <int LOG2N, bool WINDOWED>
cudaError_t attributes(int device, int* attrs) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N, WINDOWED>(device, &smem);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_regs_kernel<LOG2N, WINDOWED, kRegsSk>,
                           RegsShape<LOG2N>::THREADS, smem, attrs);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; window: (N,) f32, or null;
// partial: (2 * ceil(F / group), N) f32 scratch; out: (2, N) f32 (s1, s2),
// or with two_sigma > 0 (4, N) (s1, s2, s1 * keep, n_valid * keep).
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk(const void* raw, const void* twiddle, const void* window,
                     void* partial, void* out, int device, int log2n, int F,
                     int group, int n_valid, float two_sigma, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F || !(two_sigma >= 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = window == nullptr                                                   \
            ? launch_groups<L, false>(raw, twiddle, window, partial, F,     \
                                      group, blocks, n_valid, device, st)   \
            : launch_groups<L, true>(raw, twiddle, window, partial, F,      \
                                     group, blocks, n_valid, device, st);   \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  const dim3 grid(N / kSumBins);
  const float* p = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  if (two_sigma > 0.0f) {
    est_sum_kernel<kEstSkGate><<<grid, kSumBins * kSumLanes, 0, st>>>(
        p, blocks, N, n_valid, two_sigma, o);
  } else {
    est_sum_kernel<kEstSk><<<grid, kSumBins * kSumLanes, 0, st>>>(
        p, blocks, N, n_valid, two_sigma, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the first pass gets at N = 2^log2n, windowed or not, on `device`:
// attrs[0..5] as fused_psd.cu's rpf_fused_psd_attributes. Launches
// nothing.
int rpf_fused_psd_sk_attributes(int log2n, int windowed, int device,
                                int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = windowed ? attributes<L, true>(device, attrs)                        \
                 : attributes<L, false>(device, attrs);                      \
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
