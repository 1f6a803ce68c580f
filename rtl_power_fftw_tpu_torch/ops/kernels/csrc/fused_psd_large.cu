// Large-N fused averaged-PSD device step for NVIDIA Hopper (sm_90a).
//
// Replaces, for powers of two 32768 <= N <= 2^22:
//  * rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn at
//    default precision, unwindowed (K1) and windowed (K2), which the JAX
//    package takes up to N = 65536 (fused_psd_available) and fused_psd.cu
//    takes only up to 16384;
//  * probes/big_kernel.py's module-level `call` (P15), the 1M-point PSD of
//    BASELINE config 3: a three-level bf16-split DFT with f32 twiddles of
//    (F, 2^20) u16 frames, |X|^2, frames >= n_valid masked, summed.
// It computes what fused_psd.cu computes: raw interleaved u8 IQ frames
// (F, 2N) -> (u8 - 127) [times window[n] in FP32] -> length-N DFT in FP32
// -> |X|^2 -> drop frames f >= n_valid -> sum over frames -> (N,) f32,
// bins in natural (unshifted) order. The TPU forms split every product
// into bf16 terms because the TPU's matrix unit has no FP32; the H100's
// CUDA cores do, so the transform here is a plain FP32 FFT.
//
// Design: a four-step FFT over device memory. N = N1 * N2 with N1 =
// 2^floor(log2 N / 2) and N2 = N / N1 (128 x 256 at 32768, 1024 x 1024 at
// 2^20, 2048 x 2048 at 2^22); sample n = n1 * N2 + n2, bin k = k1 + N1 k2:
//  * pass A (large_pass_a): a block takes a tile of C adjacent columns n2
//    of each of its frames (2C bytes per row, rows 2 N2 bytes apart:
//    32-byte segments at C = 16), dequantizes and windows them, runs the
//    C column DFTs of length N1 in shared memory, multiplies by the
//    inter-stage twiddle W_N^(n2 k1) and writes complex f32 rows
//    scratch[f][k1][n2] (C adjacent columns: 128-byte runs). The window
//    values of the tile sit in registers across the block's frames, as
//    in K2;
//  * pass B (large_pass_b): a block takes R adjacent rows k1 (R * N2
//    contiguous complex values) of each of its frames, runs their
//    length-N2 DFTs in shared memory and accumulates |X|^2 over the
//    frames in registers. A thread's accumulators are the slots (r, i)
//    with r = e % R, so a warp writes bin k1 + N1 k2 of its partial row
//    in runs of R adjacent bins (32 bytes at R = 8), not one 4-byte
//    store per N1-strided bin;
//  * psd_sum.cuh sums the partial rows in a fixed float64 order, as K1.
// Both transforms are fft_radix2.cuh's dif_radix2, the butterfly of K1,
// with its float64-computed, once-rounded per-stage tables (one for N1,
// one for N2). Shared-memory rows are padded (N1 + 1 and N2 + 2 complex
// values) so the column stores of pass A and the strided accumulator
// reads of pass B hit distinct banks.
//
// The inter-stage twiddle W_N^m, m = n2 k1 < N, is the f32 rounding of a
// float64 value: the product of two float64 table entries W_N^(m mod N2)
// and W_N^(N2 floor(m / N2)), taken in FP64 on the device (four FP64
// multiply-adds per element) and rounded once. The tables hold N1 + N2
// double2 values (32 KB at 2^20, L1-resident), where a full f32 table
// would add 8 MB of reads per frame and an f32 sincosf(2 pi m / N) would
// lose ~log2(N) bits of the angle.
//
// What bounds it on an H100. The function itself reads 2N bytes per frame
// for ~5 N log2(N) FP32 flops, which puts its least time on the FP32
// cores. This form also writes and reads back 8N bytes of complex scratch
// per frame between the passes (~18N bytes in all: ~5.6 flop/byte at
// 2^20, under the ~20 flop/byte at which 3.35 TB/s stops feeding the FP32
// cores), so the scratch round trip, and the shared-memory traffic and
// per-stage barriers of the radix-2 stages as in K1, bound it. A
// single-pass form at 32768-65536 (a frame spread over the distributed
// shared memory of a thread-block cluster) and TMA/wgmma forms are later
// work.
//
// Parallelism at small F (config 3 runs F = 8): blocks come from column
// and row tiles, not frames: N2 / C pass-A blocks and N1 / R pass-B
// blocks per group of frames. Frames >= n_valid are neither transformed
// nor written, and their scratch is never read. No float atomics: the
// result is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 15;
constexpr int kMaxLog2N = 22;
constexpr int kMaxThreads = 512;

__host__ __device__ constexpr int min_int(int a, int b) {
  return a < b ? a : b;
}

// The split and the tiles of one N; kept in step with large_tiles() in
// fused_psd_large.py.
template <int LOG2N>
struct Large {
  static constexpr int N = 1 << LOG2N;
  static constexpr int LOG2N1 = LOG2N / 2;
  static constexpr int LOG2N2 = LOG2N - LOG2N1;
  static constexpr int N1 = 1 << LOG2N1;
  static constexpr int N2 = 1 << LOG2N2;
  // Pass A: C adjacent columns per block; column c at x[c * STRIDE_A + n1].
  static constexpr int C = N1 <= 1024 ? 16 : 8;
  static constexpr int STRIDE_A = N1 + 1;
  static constexpr int THREADS_A = min_int(kMaxThreads, N1 * C / 2);
  static constexpr int WORDS_A = N1 * C / 2 / THREADS_A;  // IQ words/thread
  static constexpr int OUT_A = N1 * C / THREADS_A;        // values/thread
  static constexpr int TILES_A = N2 / C;
  static constexpr int SMEM_A = C * STRIDE_A * 8;
  // Pass B: R adjacent rows per block; row r at x[r * STRIDE_B + n2].
  static constexpr int R = N2 <= 1024 ? 8 : 4;
  static constexpr int STRIDE_B = N2 + 2;
  static constexpr int THREADS_B = min_int(kMaxThreads, N2 * R / 2);
  static constexpr int PER_B = N2 * R / THREADS_B;        // bins/thread
  static constexpr int TILES_B = N1 / R;
  static constexpr int SMEM_B = R * STRIDE_B * 8;
};

// Pass A. Block b serves column tile b mod TILES_A (columns [c0, c0 + C))
// of frames [j * group, min((j + 1) * group, F, n_valid)), j = b /
// TILES_A. Word q of a tile row-block is word q % (C/2) of row q / (C/2):
// samples n1 N2 + c0 + 2w and + 1, frame word (n1 N2 + c0) / 2 + w.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(Large<LOG2N>::THREADS_A)
large_pass_a(const uint32_t* __restrict__ raw,     // (F, N/2) words
             const float2* __restrict__ twiddle,   // (N1 - 1,) per stage
             const double2* __restrict__ inter,    // (N2 + N1,)
             const float2* __restrict__ window,    // (N/2,) pairs or null
             float2* __restrict__ scratch,         // (F, N1, N2)
             int F, int group, int n_valid) {
  using L = Large<LOG2N>;
  constexpr int WPR = L::C / 2;                     // words per tile row
  extern __shared__ float2 x[];                     // (C, STRIDE_A)
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const int f0 = (blockIdx.x / L::TILES_A) * group;
  const int f1 = min(f0 + group, min(F, n_valid));

  float2 win[WINDOWED ? L::WORDS_A : 1];
  if constexpr (WINDOWED) {
#pragma unroll
    for (int r = 0; r < L::WORDS_A; ++r) {
      const int q = tid + r * L::THREADS_A;
      win[r] = __ldg(window + (((q / WPR) << L::LOG2N2) + c0) / 2 + q % WPR);
    }
  }

  for (int f = f0; f < f1; ++f) {
    const uint32_t* frame = raw + static_cast<size_t>(f) * (L::N / 2);
#pragma unroll
    for (int r = 0; r < L::WORDS_A; ++r) {
      const int q = tid + r * L::THREADS_A;
      const int n1 = q / WPR;
      const int w = q % WPR;
      // Bytes (re, im, re, im) of samples 2w and 2w + 1 of the tile row.
      const uint32_t v = __ldg(frame + ((n1 << L::LOG2N2) + c0) / 2 + w);
      float2 s0 = make_float2(
          static_cast<float>(static_cast<int>(v & 0xFFu) - 127),
          static_cast<float>(static_cast<int>((v >> 8) & 0xFFu) - 127));
      float2 s1 = make_float2(
          static_cast<float>(static_cast<int>((v >> 16) & 0xFFu) - 127),
          static_cast<float>(static_cast<int>(v >> 24) - 127));
      if constexpr (WINDOWED) {
        s0.x = __fmul_rn(s0.x, win[r].x);
        s0.y = __fmul_rn(s0.y, win[r].x);
        s1.x = __fmul_rn(s1.x, win[r].y);
        s1.y = __fmul_rn(s1.y, win[r].y);
      }
      x[(2 * w) * L::STRIDE_A + n1] = s0;
      x[(2 * w + 1) * L::STRIDE_A + n1] = s1;
    }
    __syncthreads();

    dif_radix2<L::LOG2N1, L::THREADS_A, L::C, L::STRIDE_A>(x, twiddle, tid);

    // Slot i of column c holds Y[k1 = bit_reverse(i)][n2 = c0 + c]; lanes
    // take adjacent columns of one k1, so their stores are C-long runs.
    float2* out = scratch + static_cast<size_t>(f) * L::N;
#pragma unroll 4
    for (int r = 0; r < L::OUT_A; ++r) {
      const int e = tid + r * L::THREADS_A;
      const int c = e % L::C;
      const int k1 = e / L::C;
      const float2 y = x[c * L::STRIDE_A + bit_reverse<L::LOG2N1>(k1)];
      const int n2 = c0 + c;
      const int m = n2 * k1;                        // < N
      const double2 lo = __ldg(inter + (m & (L::N2 - 1)));
      const double2 hi = __ldg(inter + L::N2 + (m >> L::LOG2N2));
      const float wr = __double2float_rn(lo.x * hi.x - lo.y * hi.y);
      const float wi = __double2float_rn(lo.x * hi.y + lo.y * hi.x);
      out[(k1 << L::LOG2N2) + n2] =
          make_float2(y.x * wr - y.y * wi, y.x * wi + y.y * wr);
    }
    __syncthreads();   // the next frame's load overwrites x
  }
}

// Pass B. Block b serves rows [k0, k0 + R), k0 = (b mod TILES_B) * R, of
// frames [g * group, min((g + 1) * group, F, n_valid)), g = b / TILES_B,
// and writes the f32 sum of their |X|^2 to those rows' bins of partial
// row g (zeros where it has no frame).
template <int LOG2N>
__global__ void __launch_bounds__(Large<LOG2N>::THREADS_B)
large_pass_b(const float2* __restrict__ scratch,  // (F, N1, N2)
             const float2* __restrict__ twiddle,  // (N2 - 1,) per stage
             float* __restrict__ partial,         // (ceil(F / group), N)
             int F, int group, int n_valid) {
  using L = Large<LOG2N>;
  extern __shared__ float2 x[];                    // (R, STRIDE_B)
  const int tid = threadIdx.x;
  const int k0 = (blockIdx.x % L::TILES_B) * L::R;
  const int g = blockIdx.x / L::TILES_B;
  const int f0 = g * group;
  const int f1 = min(f0 + group, min(F, n_valid));

  float acc[L::PER_B];
#pragma unroll
  for (int i = 0; i < L::PER_B; ++i) acc[i] = 0.0f;

  for (int f = f0; f < f1; ++f) {
    const float2* rows = scratch + static_cast<size_t>(f) * L::N
                         + (static_cast<size_t>(k0) << L::LOG2N2);
#pragma unroll
    for (int r = 0; r < L::PER_B; ++r) {
      const int e = tid + r * L::THREADS_B;
      x[(e >> L::LOG2N2) * L::STRIDE_B + (e & (L::N2 - 1))] = rows[e];
    }
    __syncthreads();

    dif_radix2<L::LOG2N2, L::THREADS_B, L::R, L::STRIDE_B>(x, twiddle, tid);

    // Slot i of row r holds X[k0 + r + N1 * bit_reverse(i)].
#pragma unroll
    for (int r = 0; r < L::PER_B; ++r) {
      const int e = tid + r * L::THREADS_B;
      const float2 X = x[(e % L::R) * L::STRIDE_B + e / L::R];
      acc[r] += X.x * X.x + X.y * X.y;
    }
    __syncthreads();   // the next frame's load overwrites x
  }

  float* row = partial + static_cast<size_t>(g) * L::N;
#pragma unroll
  for (int r = 0; r < L::PER_B; ++r) {
    const int e = tid + r * L::THREADS_B;
    row[k0 + e % L::R + (bit_reverse<L::LOG2N2>(e / L::R) << L::LOG2N1)] =
        acc[r];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch_pass_a(const void* raw, const float2* twiddle,
                          const void* inter, const void* window,
                          void* scratch, int F, int group, int n_valid,
                          int groups, cudaStream_t st) {
  using L = Large<LOG2N>;
  const cudaError_t e = allow_smem(large_pass_a<LOG2N, WINDOWED>, L::SMEM_A);
  if (e != cudaSuccess) return e;
  large_pass_a<LOG2N, WINDOWED>
      <<<groups * L::TILES_A, L::THREADS_A, L::SMEM_A, st>>>(
          static_cast<const uint32_t*>(raw), twiddle,
          static_cast<const double2*>(inter),
          static_cast<const float2*>(window), static_cast<float2*>(scratch),
          F, group, n_valid);
  return cudaGetLastError();
}

// Pass A, pass B and the row sum on `st`.
template <int LOG2N>
cudaError_t launch_large(const void* raw, const void* twiddle,
                         const void* inter, const void* window, void* scratch,
                         void* partial, void* out, int F, int group,
                         int n_valid, cudaStream_t st) {
  using L = Large<LOG2N>;
  const int groups = (F + group - 1) / group;
  const float2* tw_a = static_cast<const float2*>(twiddle);
  const float2* tw_b = tw_a + (L::N1 - 1);
  cudaError_t e =
      window == nullptr
          ? launch_pass_a<LOG2N, false>(raw, tw_a, inter, window, scratch, F,
                                        group, n_valid, groups, st)
          : launch_pass_a<LOG2N, true>(raw, tw_a, inter, window, scratch, F,
                                       group, n_valid, groups, st);
  if (e != cudaSuccess) return e;
  e = allow_smem(large_pass_b<LOG2N>, L::SMEM_B);
  if (e != cudaSuccess) return e;
  large_pass_b<LOG2N><<<groups * L::TILES_B, L::THREADS_B, L::SMEM_B, st>>>(
      static_cast<const float2*>(scratch), tw_b, static_cast<float*>(partial),
      F, group, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_psd_sum(partial, groups, L::N, out, st);
}

}  // namespace

extern "C" {

// Launches pass A, pass B and the row sum on `stream`. raw: (F, 2N) u8,
// 4-byte aligned; twiddle: (N1 - 1 + N2 - 1, 2) f32, the per-stage table
// of N1 and then that of N2; inter: (N2 + N1, 2) f64, W_N^l for l < N2 and
// then W_N^(N2 h) for h < N1; window: (N,) f32, 8-byte aligned, or null
// for K1; scratch: (F, N, 2) f32; partial: (ceil(F / group), N) f32; out:
// (N,) f32. Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_large(const void* raw, const void* twiddle,
                        const void* inter, const void* window, void* scratch,
                        void* partial, void* out, int device, int log2n,
                        int F, int group, int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                        \
  case L:                                                                  \
    e = launch_large<L>(raw, twiddle, inter, window, scratch, partial, out, \
                        F, group, n_valid, st);                            \
    break;
  switch (log2n) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
