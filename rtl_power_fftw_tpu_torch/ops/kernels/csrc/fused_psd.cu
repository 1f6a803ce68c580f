// Fused averaged-PSD device step for NVIDIA Hopper (sm_90a).
//
// Replaces rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn
// (353-470, pallas_call 435) at default precision: single-stream
// unwindowed (K1) and windowed (K2), and the streams variant of either
// (K4, streams=S>1). It computes the same function: raw interleaved u8 IQ
// frames (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in FP32] ->
// length-N DFT -> |X|^2 -> drop frames f >= n_valid -> sum over frames, as
// an (N,) float32 vector of bins in natural (unshifted) order. K4 takes S
// streams of F frames each, (S*F, 2N), with a count n_valid[s] per stream,
// and gives one such vector per stream, (S, N).
//
// What bounds it on an H100. The transform needs ~4 N log2(N) FP32 flops
// a frame (split radix) against the 2N bytes read from device memory (~21
// flop/byte at N = 2048; at F = 4096, ~5.3 us of FP32 work at 67 TFLOP/s
// and ~5 us of device memory at 3.35 TB/s, the H100 SXM's peaks at
// 700 W), so neither
// the memory nor the FP32 rate is the first limit: the traffic through
// shared memory and the barriers around it are. An in-place
// radix-2 FFT in shared memory (fft_radix2.cuh, the kernel this one
// replaced, kept as the probes' control in fused_psd_probe.cu) moves
// 32 bytes of shared memory a butterfly, ~360 KB a frame at 2048, with a
// block barrier after each of its log2(N) stages.
//
// What the design does about it (the group kernel: fused_psd_regs.cuh,
// its transform fft_regs.cuh):
//  * the transform is in registers: each thread holds 16 complex values
//    (8 at N = 64) and does radix-16 (or smaller) butterflies on them;
//    shared memory carries only the exchange between passes, 2-4 passes
//    by the pass plan (2048 = 16*16*8: two exchanges, ~64 KB a frame, and
//    three barriers), in buffers padded one float2 per 16 so that no pass
//    collides on banks;
//  * the next frame is in flight: cp.async copies its raw bytes, 16 B a
//    thread, into a second ring slot in shared memory while the current
//    frame is transformed; a thread reads its samples from the ring as
//    u16 pairs and dequantizes them exactly in registers (u8 - 127 by
//    float bits, no conversion instruction); the window (K2) is held in
//    registers for the whole block;
//  * |X|^2 is summed in f32 registers for each of the thread's output
//    slots across its frames; the slot -> bin map (the pass plan's digit
//    reversal) is applied once a block, when the partial row is written;
//  * fewer, longer blocks: the wrapper gives each block as many frames as
//    put the grid within the blocks the card holds resident (one wave),
//    so the second pass reads a quarter of the partial rows it read
//    before at N = 2048, F = 4096;
//  * twiddles between passes come from one table (pass_twiddles in
//    fused_psd.py) computed on the host in float64 and rounded once to
//    float32; the radix-16 constants likewise (no fast-math, no __sinf);
//  * no float atomics: block g writes the f32 sum of its frames to
//    partial row g (its lanes added in a fixed order), and a second kernel
//    (psd_sum.cuh) sums the G rows of each bin in a fixed order in
//    float64, so the result is the same on every run;
//  * streams (K4) are a different split of the same grid, not another
//    kernel: block g serves stream g / G_s and its frames never cross a
//    stream (the wrapper takes a group that divides F), so stream s owns
//    partial rows [s*G_s, (s+1)*G_s) and the sum pass gives it its own
//    row of the output. The per-stream counts are an (S,) device array
//    each block reads once, since --streams has no upper bound.
//
// Eligibility (Hopper facts): power-of-two N with 64 <= N <= 16384. A lane
// holds its padded complex f32 frame and two raw ring slots in shared
// memory, 12.5 N bytes: 200 KB at 16384, which needs the opt-in above
// 48 KB (cudaFuncSetAttribute) and fits the 227 KB a block may use;
// larger N go to the two-pass four-step of fused_psd_large.cu.
//
// Tensor-core forms (the DFT as matrix products, as the TPU kernel does)
// are in fused_psd_fast.cu for the relaxed tier.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_regs.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;

// Opts the kernel into its dynamic shared memory where that is above the
// 48 KB default: once per device (bit d of a mask for device d < 64; a
// device beyond that sets it every call), so that a launch costs no
// driver call for it. Two threads may both set it; that is harmless.
template <int LOG2N, bool WINDOWED>
cudaError_t prepare(int device, int* smem) {
  *smem = RegsShape<LOG2N>::SMEM_BYTES;
  if (*smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      psd_regs_kernel<LOG2N, WINDOWED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int G_s, int blocks, int n_valid,
                          const void* stream_n_valid, int device,
                          cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N, WINDOWED>(device, &smem);
  if (e != cudaSuccess) return e;
  psd_regs_kernel<LOG2N, WINDOWED>
      <<<blocks, RegsShape<LOG2N>::THREADS, smem, stream>>>(
          static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float*>(window), static_cast<float*>(partial), F,
          group, G_s, n_valid, static_cast<const int*>(stream_n_valid));
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* window, void* partial, int F,
                          int group, int G_s, int blocks, int n_valid,
                          const void* stream_n_valid, int device,
                          cudaStream_t stream) {
  return window == nullptr
             ? launch_groups<LOG2N, false>(raw, twiddle, window, partial, F,
                                           group, G_s, blocks, n_valid,
                                           stream_n_valid, device, stream)
             : launch_groups<LOG2N, true>(raw, twiddle, window, partial, F,
                                          group, G_s, blocks, n_valid,
                                          stream_n_valid, device, stream);
}

// What the group kernel gets on the current device: registers and spill
// bytes a thread, static and dynamic shared bytes a block, threads a
// block, and the blocks that reside on one SM.
template <int LOG2N, bool WINDOWED>
cudaError_t attributes(int device, int* attrs) {
  int smem = 0;
  cudaError_t e = prepare<LOG2N, WINDOWED>(device, &smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&fa, psd_regs_kernel<LOG2N, WINDOWED>);
  }
  if (e != cudaSuccess) return e;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = smem;
  attrs[4] = RegsShape<LOG2N>::THREADS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], psd_regs_kernel<LOG2N, WINDOWED>, RegsShape<LOG2N>::THREADS,
      smem);
}

// Both passes for S streams of F frames, G_s blocks per stream.
int launch_both(const void* raw, const void* twiddle, const void* window,
                const void* stream_n_valid, void* partial, void* out,
                int device, int log2n, int S, int F, int group, int G_s,
                int n_valid, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = S * G_s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_groups<L>(raw, twiddle, window, partial, F, group, G_s,      \
                         blocks, n_valid, stream_n_valid, device, st);      \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G_s, 1 << log2n, out, st, S));
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; window: (N,) f32, or null for
// K1; partial: (ceil(F / group), N) f32 scratch; out: (N,) f32. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd(const void* raw, const void* twiddle, const void* window,
                  void* partial, void* out, int device, int log2n, int F,
                  int group, int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_both(raw, twiddle, window, nullptr, partial, out, device,
                     log2n, 1, F, group, (F + group - 1) / group, n_valid,
                     stream);
}

// K4: S streams of F frames. raw: (S*F, 2N) u8, 16-byte aligned, stream s
// in rows [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read by the
// kernel when it runs (a count outside [0, F] acts as its nearest bound);
// group must divide F; partial: (S*F/group, N) f32 scratch; out: (S, N)
// f32. Other arguments as rpf_fused_psd.
int rpf_fused_psd_streams(const void* raw, const void* twiddle,
                          const void* window, const void* n_valid,
                          void* partial, void* out, int device, int log2n,
                          int S, int F, int group, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || F <= 0 ||
      group <= 0 || F % group != 0 || n_valid == nullptr ||
      static_cast<long long>(S) * (F / group) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_both(raw, twiddle, window, n_valid, partial, out, device,
                     log2n, S, F, group, F / group, 0, stream);
}

// Writes what the group kernel gets at N = 2^log2n, windowed or not, on
// `device` into attrs[0..5]: registers and local (spill) bytes a thread,
// static and dynamic shared bytes a block, threads a block, and the blocks
// that reside on one SM. Launches nothing.
int rpf_fused_psd_attributes(int log2n, int windowed, int device,
                             int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
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
