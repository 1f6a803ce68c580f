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
// Form: a four-step FFT over device memory. N = N1 * N2 with N1 =
// 2^floor(log2 N / 2) and N2 = N / N1 (128 x 256 at 32768, 1024 x 1024 at
// 2^20, 2048 x 2048 at 2^22); sample n = n1 * N2 + n2, bin k = k1 + N1 k2.
// Pass A transforms the columns n2 (length N1) and writes them times the
// inter-stage twiddle W_N^(n2 k1) to a complex f32 scratch (the control:
// scratch[f][k1][n2]; the register passes: batch-major, below); pass B
// transforms the rows k1 (length N2) and sums |X|^2 over frames.
//
// The inter-stage twiddle W_N^m, m = n2 k1 < N, is the f32 rounding of a
// float64 value: the product of two float64 table entries W_N^(m mod N2)
// and W_N^(N2 floor(m / N2)) (inter_tables), rounded once. The register
// passes read it from an f32 table made on the host once per N
// (fused_psd_large.regs_inter_twiddle, in scratch's order): 8N bytes,
// read as pass A's stores are written and held in L2 across the frames
// of a tile. The control forms it on the device from the float64 tables
// (four FP64 multiply-adds an element), whose two gathers a warp makes
// touch up to 32 lines each; an f32 sincosf(2 pi m / N) would lose
// ~log2(N) bits of the angle.
//
// What bounds it on an H100. The function reads 2N bytes per frame for
// ~5 N log2(N) FP32 flops (~9.8 us at 2^20, F = 8, on the FP32 cores).
// This two-pass form also writes and reads back 8N bytes of complex
// scratch per frame: at 2^20, F = 8, 64 MB each way, ~38 us at 3.35 TB/s,
// with the input ~45 us: the floor of the form, and so its first limit.
//
// The passes (large_regs_a, large_regs_b), what they do about it:
//  * transforms in registers (fft_regs.cuh's radix-16 passes and its
//    pass plan): a thread holds 16 values of one column (pass A) or row
//    (pass B) transform; values cross shared memory once between passes
//    (two exchanges at N1 = 1024 = 16*16*4), not once per radix-2 stage;
//  * several transforms a block: pass A runs the C columns of its tile as
//    C / B batches of B columns on B * N1 / 16 threads (256; 128 at
//    N1 = 128), pass B the B2 = 256 / (N2 / 16) adjacent rows of its tile
//    on 256 threads, so that a block needs <= 101 KB of shared memory and
//    2 blocks (pass A at N1 = 1024: 3) reside on an SM (the control's
//    single 131 KB block of pass A at 2^20 was the one to beat);
//  * the next frame in flight: pass A copies its next frame's tile (N1
//    rows of 2C bytes, rows 2 N2 bytes apart) into the other slot of a
//    two-slot ring by cp.async, 16 B a thread, while the current frame is
//    transformed, as fused_psd_regs.cuh does for K1; pass B has the copy
//    engine move its next frame's scratch runs (cp.async.bulk, one a run,
//    counted on an mbarrier) into its one-slot ring as soon as the
//    current frame's rows are in registers, so that they land while it
//    is transformed (at 2^20 the bulk copies took pass B below the
//    16-byte cp.async form's time, at 2^22, whose runs are 32 bytes,
//    above it: chip_smoke.py's times);
//  * column tiles of whole 32-byte sectors where that leaves the SM's
//    registers to bind: C = 16 columns (2C = 32 B a row) up to N1 = 512;
//    at N1 >= 1024 C = 8, 16 B rows (the neighbouring tile's block reads
//    the sector's other half, from L2), since 16 columns' two ring slots
//    (64 KB at 1024) leave 2 blocks an SM and 8 columns' leave 3 (80
//    registers, no spill), which ran pass A faster at 2^20 on an H100;
//  * whole lines to and from scratch: pass A stages each batch's outputs
//    through the exchange by (column, k1) and writes scratch batch-major
//    (value (k1, n2) at ((n2 / B) N1 + k1) B + n2 mod B), so a warp
//    stores 256 adjacent bytes and reads the inter-stage twiddles, kept
//    in the same order, likewise; pass B's B2 rows of a frame are then
//    N2 / B runs of B2 B values (128 B at 2^20), which its bulk copies
//    move whole into the ring, B values apart (none at B = 16);
//  * no bank conflicts: pass A's thread map puts V columns side by side
//    in a half-warp, and its exchange places column c's element e at
//    c * XS + ((pad(e) or e) ^ ((XMUL * c) mod 16)), a layout (col_shape
//    below) under which every pass, the staging's writes by k1 and its
//    reads in scratch order fall on distinct banks for each half-warp;
//    pass B's rows are K1's lanes (pad_index, N2 + N2/16 a row), and the
//    gaps between its ring's runs put the runs a half-warp reads on
//    different banks. Pass A's ring's 16-byte halves of a 32-byte row swap
//    every fourth row (its u16 reads bank-free at N1 <= 256, 2-way at 512
//    and above). Each
//    claim is checked by a bank model in tests/test_torch_fused_psd_large_
//    regs.py;
//  * grids of their own (fused_psd_large.py: large_group): pass A sums
//    nothing, so its frames a block are the fewest that keep its grid
//    within the blocks the card holds at once (3 frames of 8 at 2^20:
//    384 blocks of 396);
//    pass B's frames a block set the partial rows;
//  * no row sum where it adds nothing: one partial row (2^20 and 2^22 at
//    F = 8) is written to `out` by pass B itself; 2..8 rows go through
//    psd_rows_sum (4 bins a thread, rows added in order in float64 from
//    0.0: psd_sum_kernel's order at G <= kSumLanes, so the same bits);
//    more rows through psd_sum.cuh. No float atomics: the result is the
//    same on every run.
// Frames >= n_valid are neither transformed nor written, and their scratch
// is never read.
//
// The control. The radix-2 passes this file shipped before (large_pass_a,
// large_pass_b: fft_radix2.cuh's dif_radix2 in shared memory, one frame
// at a time, on fused_psd_large.frames_per_block's grid, and psd_sum.cuh)
// stay, launched by rpf_fused_psd_large_radix2 as before, for
// chip_smoke.py to time the redesign against (fused_psd_probe.
// large_radix2_psd); they are never on a session's path.
//
// The streams entry (rpf_fused_psd_large_streams, "L-S"): S streams of F
// frames, (S*F, 2N), with an (S,) count array on the device, one output
// row per stream. large_streams_a and large_streams_b
// (fused_psd_large_streams.cuh, which the CLI estimators' forms of these
// passes, fused_psd_large_est.cu, share) are the register passes with S
// on their grids' y axis: block (x, s) serves tile x mod
// TILES of stream s's frames [j group, min((j + 1) group, n_valid[s])),
// j = x / TILES, G_s = ceil(F / group) groups a stream, so no block
// crosses a stream (large_streams.cuh: streams_block); a count is read
// from device memory when the block runs (one outside [0, F] acts as its
// nearest bound). Pass B writes partial row s G_s + j; stream s's G_s rows are added as a one-stream
// call adds its rows (streams_rows_sum, the order of psd_rows_sum, or
// psd_sum.cuh), so row s is the one-stream call's output on the same
// frames, count and groups, bit for bit.
//
// Later work: a single-pass form at 32768-65536 (a frame spread over a
// thread-block cluster's distributed shared memory), tensor-map TMA and
// wgmma forms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_radix2.cuh"
#include "fft_regs.cuh"
#include "fused_psd_large_regs.cuh"
#include "fused_psd_large_streams.cuh"
#include "fused_psd_regs.cuh"
#include "large_streams.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 15;
constexpr int kMaxLog2N = 22;
constexpr int kMaxThreads = 512;

__host__ __device__ constexpr int min_int(int a, int b) {
  return a < b ? a : b;
}

// --- The control: the radix-2 passes ---

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

// Pass A unwindowed (0), windowed (1), and pass B (2).
template <int LOG2N, int WHICH>
const void* regs_kernel() {
  if constexpr (WHICH == 0) {
    return reinterpret_cast<const void*>(large_regs_a<LOG2N, false>);
  } else if constexpr (WHICH == 1) {
    return reinterpret_cast<const void*>(large_regs_a<LOG2N, true>);
  } else {
    return reinterpret_cast<const void*>(large_regs_b<LOG2N>);
  }
}

template <int LOG2N, int WHICH>
constexpr int regs_smem() {
  return WHICH == 2 ? LargeRegs<LOG2N>::SMEM_B : LargeRegs<LOG2N>::SMEM_A;
}

template <int LOG2N, int WHICH>
constexpr int regs_threads() {
  return WHICH == 2 ? LargeRegs<LOG2N>::THREADS_B
                    : LargeRegs<LOG2N>::THREADS_A;
}

// Opts the pass into its dynamic shared memory (and the largest carveout)
// where that is above the 48 KB default: once per device (bit d of a mask
// for device d < 64; a device beyond that sets it every call), so that a
// launch costs no driver call for it. Two threads may both set it; that
// is harmless.
template <int LOG2N, int WHICH>
cudaError_t prepare_regs(int device) {
  constexpr int smem = regs_smem<LOG2N, WHICH>();
  if constexpr (smem <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static std::atomic<unsigned long long> done{0};
    const unsigned long long bit = device < 64 ? 1ull << device : 0;
    if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
      return cudaSuccess;
    }
    cudaError_t e = cudaFuncSetAttribute(
        regs_kernel<LOG2N, WHICH>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(regs_kernel<LOG2N, WHICH>(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    }
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return e;
  }
}

// Pass A, pass B and, for 2 or more partial rows, their sum, on `st`.
template <int LOG2N>
cudaError_t launch_regs(const void* raw, const void* twiddle,
                        const void* inter, const void* window, void* scratch,
                        void* partial, void* out, int F, int group_a,
                        int group_b, int n_valid, int device,
                        cudaStream_t st) {
  using L = LargeRegs<LOG2N>;
  using P1 = RegsPlan<L::LOG2N1>;
  const float2* tw_a = static_cast<const float2*>(twiddle);
  const float2* tw_b = tw_a + P1::twiddle_offset(P1::PASSES - 1);
  const int blocks_a = (F + group_a - 1) / group_a * L::TILES_A;
  const int groups_b = (F + group_b - 1) / group_b;
  cudaError_t e;
  if (window == nullptr) {
    e = prepare_regs<LOG2N, 0>(device);
    if (e != cudaSuccess) return e;
    large_regs_a<LOG2N, false><<<blocks_a, L::THREADS_A, L::SMEM_A, st>>>(
        static_cast<const uint8_t*>(raw), tw_a,
        static_cast<const float2*>(inter), nullptr,
        static_cast<float2*>(scratch), F, group_a, n_valid);
  } else {
    e = prepare_regs<LOG2N, 1>(device);
    if (e != cudaSuccess) return e;
    large_regs_a<LOG2N, true><<<blocks_a, L::THREADS_A, L::SMEM_A, st>>>(
        static_cast<const uint8_t*>(raw), tw_a,
        static_cast<const float2*>(inter),
        static_cast<const float*>(window), static_cast<float2*>(scratch), F,
        group_a, n_valid);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = prepare_regs<LOG2N, 2>(device);
  if (e != cudaSuccess) return e;
  float* rows = static_cast<float*>(groups_b == 1 ? out : partial);
  large_regs_b<LOG2N>
      <<<groups_b * L::TILES_B, L::THREADS_B, L::SMEM_B, st>>>(
          static_cast<const float2*>(scratch), tw_b, rows, F, group_b,
          n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups_b == 1) return e;
  if (groups_b <= kSumLanes) {
    const int n4 = L::N / 4;
    psd_rows_sum<<<(n4 + 255) / 256, 256, 0, st>>>(
        static_cast<const float4*>(partial), groups_b, n4,
        static_cast<float4*>(out));
    return cudaGetLastError();
  }
  return launch_psd_sum(partial, groups_b, L::N, out, st);
}

// What a pass gets on the current device: registers and spill bytes a
// thread, static and dynamic shared bytes a block, threads a block, and
// the blocks that reside on one SM.
template <int LOG2N, int WHICH>
cudaError_t regs_attributes(int device, int* attrs) {
  cudaError_t e = prepare_regs<LOG2N, WHICH>(device);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, regs_kernel<LOG2N, WHICH>());
  if (e != cudaSuccess) return e;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = regs_smem<LOG2N, WHICH>();
  attrs[4] = regs_threads<LOG2N, WHICH>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], regs_kernel<LOG2N, WHICH>(), regs_threads<LOG2N, WHICH>(),
      regs_smem<LOG2N, WHICH>());
}

// Pass A unwindowed (0), windowed (1), pass B (2) of the streams entry.
template <int LOG2N, int WHICH>
const void* streams_kernel() {
  if constexpr (WHICH == 0) {
    return reinterpret_cast<const void*>(large_streams_a<LOG2N, false>);
  } else if constexpr (WHICH == 1) {
    return reinterpret_cast<const void*>(large_streams_a<LOG2N, true>);
  } else {
    return reinterpret_cast<const void*>(large_streams_b<LOG2N>);
  }
}

// prepare_regs for the streams passes.
template <int LOG2N, int WHICH>
cudaError_t prepare_streams(int device) {
  constexpr int smem = regs_smem<LOG2N, WHICH>();
  if constexpr (smem <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static std::atomic<unsigned long long> done{0};
    const unsigned long long bit = device < 64 ? 1ull << device : 0;
    if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
      return cudaSuccess;
    }
    cudaError_t e = cudaFuncSetAttribute(
        streams_kernel<LOG2N, WHICH>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(streams_kernel<LOG2N, WHICH>(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    }
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return e;
  }
}

// Both streams passes and, for 2 or more partial rows a stream, each
// stream's sum, on `st`.
template <int LOG2N>
cudaError_t launch_streams(const void* raw, const void* twiddle,
                           const void* inter, const void* window,
                           const int* counts, void* scratch, void* partial,
                           void* out, int S, int F, int group_a, int group_b,
                           int device, cudaStream_t st) {
  using L = LargeRegs<LOG2N>;
  using P1 = RegsPlan<L::LOG2N1>;
  const float2* tw_a = static_cast<const float2*>(twiddle);
  const float2* tw_b = tw_a + P1::twiddle_offset(P1::PASSES - 1);
  const int g_a = (F + group_a - 1) / group_a;
  const int g_b = (F + group_b - 1) / group_b;
  cudaError_t e;
  if (window == nullptr) {
    e = prepare_streams<LOG2N, 0>(device);
    if (e != cudaSuccess) return e;
    large_streams_a<LOG2N, false>
        <<<dim3(g_a * L::TILES_A, S), L::THREADS_A, L::SMEM_A, st>>>(
            static_cast<const uint8_t*>(raw), tw_a,
            static_cast<const float2*>(inter), nullptr,
            static_cast<float2*>(scratch), F, group_a, g_a, counts);
  } else {
    e = prepare_streams<LOG2N, 1>(device);
    if (e != cudaSuccess) return e;
    large_streams_a<LOG2N, true>
        <<<dim3(g_a * L::TILES_A, S), L::THREADS_A, L::SMEM_A, st>>>(
            static_cast<const uint8_t*>(raw), tw_a,
            static_cast<const float2*>(inter),
            static_cast<const float*>(window), static_cast<float2*>(scratch),
            F, group_a, g_a, counts);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = prepare_streams<LOG2N, 2>(device);
  if (e != cudaSuccess) return e;
  float* rows = static_cast<float*>(g_b == 1 ? out : partial);
  large_streams_b<LOG2N>
      <<<dim3(g_b * L::TILES_B, S), L::THREADS_B, L::SMEM_B, st>>>(
          static_cast<const float2*>(scratch), tw_b, rows, F, group_b, g_b,
          counts);
  e = cudaGetLastError();
  if (e != cudaSuccess || g_b == 1) return e;
  return launch_rows_sum(partial, S, g_b, L::N, out, st);
}

}  // namespace

extern "C" {

// Launches pass A, pass B and, for 2 or more partial rows, their sum on
// `stream`. raw: (F, 2N) u8, 16-byte aligned; twiddle: pass_twiddles(N1)
// then pass_twiddles(N2), (rows, 2) f32; inter: (N, 2) f32, the
// inter-stage twiddle W_N^(k1 n2) in scratch's batch-major order
// (fused_psd_large.regs_inter_twiddle); window: (N,) f32, 4-byte
// aligned, or null for K1; scratch: (F, N, 2) f32, batch-major; partial:
// (ceil(F / group_b), N) f32, 16-byte aligned (unused for one row); out:
// (N,) f32, 16-byte aligned. group_a and group_b: frames a block of pass A
// and of pass B. Returns a cudaError_t (0 on success); does not
// synchronise.
int rpf_fused_psd_large(const void* raw, const void* twiddle,
                        const void* inter, const void* window, void* scratch,
                        void* partial, void* out, int device, int log2n,
                        int F, int group_a, int group_b, int n_valid,
                        void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group_a <= 0 ||
      group_b <= 0 || n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_regs<L>(raw, twiddle, inter, window, scratch, partial, out,   \
                       F, group_a, group_b, n_valid, device, st);           \
    break;
  switch (log2n) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// The streams entry: S streams of F frames. raw: (S*F, 2N) u8, 16-byte
// aligned, stream s in frames [s F, s F + F); counts: (S,) int32 on the
// device, each stream's valid frames (read when the passes run); scratch:
// (S*F, N, 2) f32; partial: (S * ceil(F / group_b), N) f32 (unused for one
// row a stream); out: (S, N) f32. The other arguments as
// rpf_fused_psd_large's. Returns a cudaError_t (0 on success); does not
// synchronise.
int rpf_fused_psd_large_streams(const void* raw, const void* twiddle,
                                const void* inter, const void* window,
                                const void* counts, void* scratch,
                                void* partial, void* out, int device,
                                int log2n, int S, int F, int group_a,
                                int group_b, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || S > kMaxGridY ||
      F <= 0 ||
      group_a <= 0 || group_b <= 0 || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* n_valid = static_cast<const int*>(counts);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = launch_streams<L>(raw, twiddle, inter, window, n_valid, scratch,     \
                          partial, out, S, F, group_a, group_b, device, st); \
    break;
  switch (log2n) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// Writes what a pass gets at N = 2^log2n on `device` into attrs[0..5]
// (which: 0 pass A, 1 pass A windowed, 2 pass B): registers and local
// (spill) bytes a thread, static and dynamic shared bytes a block, threads
// a block, and the blocks that reside on one SM. Launches nothing.
int rpf_fused_psd_large_attributes(int log2n, int which, int device,
                                   int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || which < 0 || which > 2 ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = which == 0   ? regs_attributes<L, 0>(device, attrs)                  \
        : which == 1 ? regs_attributes<L, 1>(device, attrs)                  \
                     : regs_attributes<L, 2>(device, attrs);                 \
    break;
  switch (log2n) {
    RPF_CASE(15) RPF_CASE(16) RPF_CASE(17) RPF_CASE(18) RPF_CASE(19)
    RPF_CASE(20) RPF_CASE(21) RPF_CASE(22)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// The control: the radix-2 passes and the row sum as this file launched
// them before the register passes. raw: (F, 2N) u8, 4-byte aligned;
// twiddle: (N1 - 1 + N2 - 1, 2) f32, the per-stage table of N1 and then
// that of N2; inter: (N2 + N1, 2) f64, W_N^l for l < N2 and then
// W_N^(N2 h) for h < N1; window: (N,) f32, 8-byte aligned, or null
// for K1; scratch: (F, N, 2) f32; partial: (ceil(F / group), N) f32; out:
// (N,) f32. Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_large_radix2(const void* raw, const void* twiddle,
                               const void* inter, const void* window,
                               void* scratch, void* partial, void* out,
                               int device, int log2n, int F, int group,
                               int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
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
