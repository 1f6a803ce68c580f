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
// rpf_fused_psd_sk_streams does this for S streams of F frames, (S*F, 2N)
// with an (S,) count array on the device, and gives each stream its own
// rows, (S, 2, N) or with the gate (S, 4, N): the first pass is the same
// kernel with S folded into its grid as K4 folds it into K1's (block g
// serves stream g / G_s; fused_psd_regs.cuh reads the stream's count when
// it runs), so each stream's s1 is K4's row for it; the second pass is
// est_streams_kernel (fused_psd_est.cuh), which gates each stream on its
// own block and its own M = n_valid[s] before any sum over streams (the
// JAX package's ShardedSkStep, kurtosis.py:293-302). On the grid one
// stream's call gets (the same group), a stream's rows are that call's
// bits.
//
// The design is K1/K2's (fused_psd.cu): the first pass is their group
// kernel, psd_regs_kernel<LOG2N, WINDOWED, CUT> of fused_psd_regs.cuh,
// which sums p = |X|^2 exactly as K1 does and beside it p * p, and writes
// the second sums to a second plane of partial rows; the second pass is
// est_sum_kernel, psd_sum.cuh's float64 row sum over both planes. The
// wrapper (fused_psd_sk.py) gives it K1's grid (fused_psd.k1_group from
// K1's own occupancy), so its s1 is K1's (K2's) output bit for bit on the
// same frames, n_valid and chunk: the same frames a block, the same f32
// sums in the same order, the same row sum.
//
// Two cuts of the template. kRegsSkPlane (the route up to 8192 bins) keeps
// the |X|^4 sums in a shared-memory plane of LANES x N f32, each thread's
// own slots updated in place, so a thread holds K1's registers and the
// block runs at K1's (K2's) occupancy, which K1's grid was sized for; the
// plane costs one shared load and store a bin and frame, conflict-free.
// kRegsSk (the cut kRegsSkPlane was redesigned from, the control, and the
// route at 16384 bins, where the 64 KB plane does not fit beside the
// exchange buffer and the ring) keeps them in R more f32 registers:
// 168-172 registers at 512-4096 bins and 1 block an SM (nvcc 12.9, NVIDIA
// H100 80GB HBM3, 700.00 W), where K1 has 80 and 3 and K2 128 and 2, so
// K1's grid runs in several waves; at 16384, where the 1024-thread block
// holds a thread to 64 registers, 488-556 B of spill. Both give the same
// s2 bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kMaxSmem = 232448;   // the 227 KB a Hopper block may use

// The first pass's shared memory: K1's, and kRegsSkPlane's plane.
template <int LOG2N, int CUT>
constexpr int sk_smem_bytes() {
  return RegsShape<LOG2N>::SMEM_BYTES +
         (CUT == kRegsSkPlane ? RegsShape<LOG2N>::PLANE_BYTES : 0);
}

template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_regs_kernel<LOG2N, WINDOWED, CUT>,
                     sk_smem_bytes<LOG2N, CUT>(), device, done);
}

// Blocks serve streams of G_s blocks each (counts: (S,) on the device, or
// null for one stream of n_valid frames).
template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int blocks, int G_s, int n_valid,
                          const void* counts, int device,
                          cudaStream_t stream) {
  if constexpr (sk_smem_bytes<LOG2N, CUT>() > kMaxSmem) {
    return cudaErrorInvalidValue;   // the plane does not fit at this N
  } else {
    const cudaError_t e = prepare<LOG2N, WINDOWED, CUT>(device);
    if (e != cudaSuccess) return e;
    psd_regs_kernel<LOG2N, WINDOWED, CUT>
        <<<blocks, RegsShape<LOG2N>::THREADS, sk_smem_bytes<LOG2N, CUT>(),
           stream>>>(static_cast<const uint8_t*>(raw),
                     static_cast<const float2*>(twiddle),
                     static_cast<const float*>(window),
                     static_cast<float*>(partial), F, group, G_s, n_valid,
                     static_cast<const int*>(counts));
    return cudaGetLastError();
  }
}

template <int LOG2N, bool WINDOWED, int CUT>
cudaError_t attributes(int device, int* attrs) {
  if constexpr (sk_smem_bytes<LOG2N, CUT>() > kMaxSmem) {
    return cudaErrorInvalidValue;
  } else {
    const cudaError_t e = prepare<LOG2N, WINDOWED, CUT>(device);
    if (e != cudaSuccess) return e;
    return kernel_attributes(psd_regs_kernel<LOG2N, WINDOWED, CUT>,
                             RegsShape<LOG2N>::THREADS,
                             sk_smem_bytes<LOG2N, CUT>(), attrs);
  }
}

// The first pass of either entry: the plane cut or kRegsSk, windowed or
// not, on `blocks` blocks of G_s a stream.
cudaError_t launch_first(const void* raw, const void* twiddle,
                         const void* window, void* partial, int log2n, int F,
                         int group, int blocks, int G_s, int n_valid,
                         const void* counts, int plane, int device,
                         cudaStream_t st) {
  cudaError_t e = cudaErrorInvalidValue;
#define RPF_LAUNCH(L, W, CUT)                                               \
  launch_groups<L, W, CUT>(raw, twiddle, window, partial, F, group, blocks, \
                           G_s, n_valid, counts, device, st)
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    if (plane) {                                                            \
      e = window == nullptr ? RPF_LAUNCH(L, false, kRegsSkPlane)            \
                            : RPF_LAUNCH(L, true, kRegsSkPlane);            \
    } else {                                                                \
      e = window == nullptr ? RPF_LAUNCH(L, false, kRegsSk)                 \
                            : RPF_LAUNCH(L, true, kRegsSk);                 \
    }                                                                       \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: break;
  }
#undef RPF_CASE
#undef RPF_LAUNCH
  return e;
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; window: (N,) f32, or null;
// partial: (2 * ceil(F / group), N) f32 scratch; out: (2, N) f32 (s1, s2),
// or with two_sigma > 0 (4, N) (s1, s2, s1 * keep, n_valid * keep); plane:
// the first pass is kRegsSkPlane (N <= 8192), else kRegsSk. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk(const void* raw, const void* twiddle, const void* window,
                     void* partial, void* out, int device, int log2n, int F,
                     int group, int n_valid, float two_sigma, int plane,
                     void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F || !(two_sigma >= 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = launch_first(raw, twiddle, window, partial, log2n, F, group, blocks,
                   blocks, n_valid, nullptr, plane, device, st);
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

// S streams of F frames. raw: (S*F, 2N) u8, 16-byte aligned, stream s in
// rows [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read when the
// kernels run (a count outside [0, F] acts as its nearest bound); G_s =
// ceil(F / group) blocks a stream; partial: (2 * S * G_s, N) f32 scratch;
// out: (S, 2, N) f32, or with two_sigma > 0 (S, 4, N), each stream gated
// on its own moments and count. Other arguments as rpf_fused_psd_sk.
int rpf_fused_psd_sk_streams(const void* raw, const void* twiddle,
                             const void* window, const void* n_valid,
                             void* partial, void* out, int device, int log2n,
                             int S, int F, int group, float two_sigma,
                             int plane, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || F <= 0 ||
      group <= 0 || n_valid == nullptr || !(two_sigma >= 0.0f) ||
      2LL * S * ((F + group - 1) / group) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G_s = (F + group - 1) / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = launch_first(raw, twiddle, window, partial, log2n, F, group, S * G_s,
                   G_s, 0, n_valid, plane, device, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  e = two_sigma > 0.0f
          ? launch_est_streams<kEstSkGate>(partial, S, G_s, 1, N, n_valid, F,
                                           0, two_sigma, out, st)
          : launch_est_streams<kEstSk>(partial, S, G_s, 1, N, n_valid, F, 0,
                                       two_sigma, out, st);
  return static_cast<int>(e);
}

// What the first pass (plane: kRegsSkPlane, else kRegsSk) gets at N =
// 2^log2n, windowed or not, on `device`: attrs[0..5] as fused_psd.cu's
// rpf_fused_psd_attributes. Launches nothing.
int rpf_fused_psd_sk_attributes(int log2n, int windowed, int plane,
                                int device, int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    if (plane) {                                                             \
      e = windowed ? attributes<L, true, kRegsSkPlane>(device, attrs)        \
                   : attributes<L, false, kRegsSkPlane>(device, attrs);      \
    } else {                                                                 \
      e = windowed ? attributes<L, true, kRegsSk>(device, attrs)             \
                   : attributes<L, false, kRegsSk>(device, attrs);           \
    }                                                                        \
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
