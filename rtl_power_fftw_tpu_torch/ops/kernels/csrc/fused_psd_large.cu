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
// Later work: a single-pass form at 32768-65536 (a frame spread over a
// thread-block cluster's distributed shared memory), tensor-map TMA and
// wgmma forms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_radix2.cuh"
#include "fft_regs.cuh"
#include "fused_psd_regs.cuh"
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

// --- The register-transform passes ---

// Pass A's layout at N1 = 2^log2n1, field f: 0 B (columns transformed at
// once), 1 C (columns a tile), 2 V (columns side by side in a half-warp),
// 3 PAD (1: pad_index(e), 0: e), 4 XS (float2 slots a column of the
// exchange), 5 XMUL (the column's XOR on the low 4 bits). Read in this
// form by tests/test_torch_fused_psd_large_regs.py, which holds every
// row to bank-free exchanges and the XOR to a bijection inside XS.
__host__ __device__ constexpr int col_shape(int log2n1, int f) {
  constexpr int table[5][6] = {
      {16, 16, 16, 0, 128, 1},    // 128
      {16, 16, 16, 0, 256, 1},    // 256
      {8, 16, 1, 1, 544, 2},      // 512
      {4, 8, 1, 1, 1088, 4},      // 1024
      {2, 8, 1, 1, 2176, 8},      // 2048
  };
  return table[log2n1 - 7][f];
}

// Pass B's float row stride of its last step, the partial row's bins
// through shared memory, at N2 = 2^log2n2 (256 .. 2048).
__host__ __device__ constexpr int row_sum_stride(int log2n2) {
  constexpr int table[4] = {273, 546, 1092, 2176};
  return table[log2n2 - 8];
}

// The shapes of both passes at N; kept in step with regs_layout() in
// fused_psd_large.py.
template <int LOG2N>
struct LargeRegs {
  static constexpr int N = 1 << LOG2N;
  static constexpr int LOG2N1 = LOG2N / 2;
  static constexpr int LOG2N2 = LOG2N - LOG2N1;
  static constexpr int N1 = 1 << LOG2N1;
  static constexpr int N2 = 1 << LOG2N2;
  // Pass A.
  static constexpr int B = col_shape(LOG2N1, 0);
  static constexpr int C = col_shape(LOG2N1, 1);
  static constexpr int V = col_shape(LOG2N1, 2);
  static constexpr bool PAD = col_shape(LOG2N1, 3) != 0;
  static constexpr int XS = col_shape(LOG2N1, 4);
  static constexpr int XMUL = col_shape(LOG2N1, 5);
  static constexpr int TF1 = N1 / 16;            // threads a column
  static constexpr int THREADS_A = B * TF1;
  static constexpr int SUBS = C / B;             // batches a tile
  static constexpr int TILES_A = N2 / C;
  static constexpr int ROW_BYTES = 2 * C;        // a tile row of the ring
  static constexpr int PARTS = ROW_BYTES / 16;   // 16-byte copies a row
  static constexpr int SLOT_A = N1 * ROW_BYTES;
  static constexpr int COPIES_A = SLOT_A / 16 / THREADS_A;
  static constexpr int XBYTES_A = B * XS * 8;
  static constexpr int SMEM_A = XBYTES_A + 2 * SLOT_A;
  // Stores a thread issues at once at the end of a batch: all 16 from
  // N1 = 1024 (their twiddle loads in flight together), 4 below, where
  // 16 spill.
  static constexpr int STORE_UNROLL = LOG2N1 >= 10 ? 16 : 4;
  // Blocks an SM is to hold: 3 at N1 = 1024 (80 registers, no spill,
  // 67.6 KB), 2 elsewhere (at N1 = 256 and 512 a cap of 85 registers
  // spills).
  static constexpr int MIN_BLOCKS_A = LOG2N1 == 10 ? 3 : 2;
  // Pass B.
  static constexpr int TF2 = N2 / 16;            // threads a row
  static constexpr int THREADS_B = 256;
  static constexpr int B2 = THREADS_B / TF2;     // rows a block
  static constexpr int TILES_B = N1 / B2;
  static constexpr int XS2 = N2 + N2 / 16;      // an exchange row, float2
  static constexpr int XBYTES_B = B2 * XS2 * 8;
  static constexpr int RUN = B2 * B;             // a scratch run, float2
  static constexpr int RUNS = N2 / B;            // runs a frame's tile
  // The ring keeps a frame's runs as they are, run g at g * GS: a gap of
  // B values after each (none at B = 16) puts the runs a half-warp reads
  // on different banks.
  static constexpr int GS = RUN + (B == 16 ? 0 : B);
  static constexpr int SLOT_B = RUNS * GS * 8;
  static constexpr int SMEM_B = XBYTES_B + SLOT_B + 8;   // + an mbarrier
  static constexpr int XSR = row_sum_stride(LOG2N2);

  static_assert(RegsPlan<LOG2N1>::R == 16 && RegsPlan<LOG2N2>::R == 16,
                "a thread holds 16 values of a transform");
  static_assert(RegsPlan<LOG2N1>::PASSES >= 2,
                "a ring slot is rewritten only after the barrier that ends "
                "a batch's first pass");
  static_assert(V * (16 / V) == 16 && B % V == 0 && C % B == 0,
                "a half-warp is V columns of 16 / V threads");
  static_assert(SLOT_A % (16 * THREADS_A) == 0 &&
                (B2 * N2 * 8) % (16 * THREADS_B) == 0,
                "a tile splits into 16-byte copies evenly");
  static_assert(B % 2 == 0, "a 16-byte copy stays in one scratch run");
  static_assert(XBYTES_A % 16 == 0 && XBYTES_B % 16 == 0 &&
                SLOT_B % 16 == 0 && (GS * 8) % 16 == 0 && RUN * 8 % 16 == 0,
                "bulk copies move 16-byte aligned runs");
  static_assert(B2 * XSR <= 2 * B2 * XS2, "the bins fit the exchange");
};

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that expects `bytes` of bulk copies before the phase ends.
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

// Pass A's thread map: thread tid serves column col_of(tid) of a batch and
// is thread row_of(tid) of that column's transform. A half-warp is V
// adjacent columns of 16 / V adjacent threads.
template <int LOG2N>
__device__ __forceinline__ int col_of(int tid) {
  using L = LargeRegs<LOG2N>;
  return tid % L::V + L::V * ((tid >> 4) % (L::B / L::V));
}

template <int LOG2N>
__device__ __forceinline__ int row_of(int tid) {
  using L = LargeRegs<LOG2N>;
  constexpr int T = 16 / L::V;
  return (tid / L::V) % T + T * ((tid >> 4) / (L::B / L::V));
}

// Exchange slot of element e of batch column c.
template <int LOG2N>
__device__ __forceinline__ int col_index(int c, int e) {
  using L = LargeRegs<LOG2N>;
  const int p = L::PAD ? pad_index(e) : e;
  return c * L::XS + (p ^ ((L::XMUL * c) & 15));
}

// The ring's 16-byte half `part` of tile row `row`: the halves of every
// fourth row swap.
template <int LOG2N>
__device__ __forceinline__ int ring_offset(int row, int part) {
  using L = LargeRegs<LOG2N>;
  const int swap = L::PARTS == 2 ? (row >> 2) & 1 : 0;
  return row * L::ROW_BYTES + ((part ^ swap) << 4);
}

// regs_pass (fft_regs.cuh) for pass A's batch column c: pass J >= 1 of the
// column's length-N1 transform on its thread t, the exchange at
// col_index.
template <int LOG2N, int J>
__device__ __forceinline__ void col_pass(float2 (&v)[16], float2* x,
                                         const float2* __restrict__ twiddle,
                                         int t, int c) {
  using L = LargeRegs<LOG2N>;
  using P = RegsPlan<L::LOG2N1>;
  constexpr int RJ = pass_radix(L::LOG2N1, J);
  constexpr int SP = P::span(J);
  constexpr int S = SP / RJ;
  constexpr int BITS = log2_of(RJ);
  constexpr bool LAST = J == P::PASSES - 1;
#pragma unroll
  for (int i = 0; i < 16 / RJ; ++i) {
    const int b = t + i * P::TF;
    const int n2 = b % S;
    const int base = (b / S) * SP + n2;
#pragma unroll
    for (int n1 = 0; n1 < RJ; ++n1) {
      v[i * RJ + n1] = x[col_index<LOG2N>(c, base + n1 * S)];
    }
    dif_regs<RJ>(v, i * RJ);
    if constexpr (!LAST) {
      const float2* tw = twiddle + P::twiddle_offset(J) + n2;
#pragma unroll
      for (int r = 0; r < RJ; ++r) {
        const int k1 = rev_bits(r, BITS);
        float2 y = v[i * RJ + r];
        if (k1 != 0) {
          const float2 w = __ldg(tw + k1 * S);
          y = cmul(y, w.x, w.y);
        }
        x[col_index<LOG2N>(c, base + k1 * S)] = y;
      }
    }
  }
}

// Element of slot k of thread t after the last pass of a length-2^LOG2M
// register transform (its bin is pass_bin<LOG2M> of it).
template <int LOG2M>
__device__ __forceinline__ int last_element(int t, int k) {
  using P = RegsPlan<LOG2M>;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(LOG2M, LAST);
  constexpr int SL = P::span(LAST) / RL;
  const int b = t + (k / RL) * P::TF;
  return (b / SL) * P::span(LAST) + (b % SL) +
         rev_bits(k % RL, log2_of(RL)) * SL;
}

// Pass 0 of a length-2^LOG2M register transform from v: the radix-16
// butterfly of thread t and its outputs, times their twiddles, to
// x[index(t + k1 * TF)].
template <int LOG2M, typename Index>
__device__ __forceinline__ void first_pass(float2 (&v)[16], float2* x,
                                           const float2* __restrict__ twiddle,
                                           int t, Index index) {
  constexpr int TF = RegsPlan<LOG2M>::TF;
  dif_regs<16>(v, 0);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int k1 = rev_bits(r, 4);
    float2 y = v[r];
    if (k1 != 0) {
      const float2 w = __ldg(twiddle + k1 * TF + t);
      y = cmul(y, w.x, w.y);
    }
    x[index(t + k1 * TF)] = y;
  }
}

// Batch s of pass A's tile (columns s * B + c of its C) on thread (c, t):
// load and dequantize [and window] the column's 16 samples t + k * TF1
// from the ring, transform, and store them times the inter-stage twiddle.
// Scratch is batch-major: value (k1, n2) of a frame at
// ((n2 / B) * N1 + k1) * B + n2 % B, so that a batch writes one run of
// B * N1 values and pass B's rows k0 .. k0 + B2 - 1 of B columns are runs
// of B2 * B values.
// The window's values come from device memory (L2) with the samples: a
// block reads its tile of it once a frame (held in registers across the
// frames, 16 to 64 values a thread, it spilled).
template <int LOG2N, bool WINDOWED>
__device__ __forceinline__ void regs_a_batch(
    int s, const uint8_t* tile, const float* __restrict__ window, float2* x,
    const float2* __restrict__ twiddle, const float2* __restrict__ inter,
    float2* __restrict__ out, int c, int t, int c0) {
  using L = LargeRegs<LOG2N>;
  using P = RegsPlan<L::LOG2N1>;
  constexpr int TF = L::TF1;
  if (s > 0) __syncthreads();   // x is free (last pass of batch s - 1)
  const int col = s * L::B + c;
  const int byte = 2 * col;
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int row = t + k * TF;
    const unsigned u = *reinterpret_cast<const uint16_t*>(
        tile + ring_offset<LOG2N>(row, byte >> 4) + (byte & 15));
    float re = dequant_byte(u & 0xFFu);
    float im = dequant_byte(u >> 8);
    if constexpr (WINDOWED) {
      const float w = __ldg(window + (row << L::LOG2N2) + c0 + col);
      re = __fmul_rn(re, w);
      im = __fmul_rn(im, w);
    }
    v[k] = make_float2(re, im);
  }
  first_pass<L::LOG2N1>(v, x, twiddle, t,
                        [c](int e) { return col_index<LOG2N>(c, e); });
  __syncthreads();
  col_pass<LOG2N, 1>(v, x, twiddle, t, c);
  if constexpr (P::PASSES > 2) {
    __syncthreads();
    col_pass<LOG2N, 2>(v, x, twiddle, t, c);
  }
  // Slot k holds Y[k1][n2], k1 = pass_bin of its element: to x by
  // (column, k1), then to the batch's run of scratch, k1-major, so that a
  // warp stores (and reads the twiddles of) 32 adjacent values.
  __syncthreads();   // every thread's last pass has read x
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    x[col_index<LOG2N>(
        c, pass_bin<L::LOG2N1>(last_element<L::LOG2N1>(t, k)))] = v[k];
  }
  __syncthreads();
  const int run = (c0 / L::B + s) * L::N1 * L::B;
#pragma unroll(L::STORE_UNROLL)
  for (int j = 0; j < 16; ++j) {
    const int e = threadIdx.x + j * L::THREADS_A;   // k1 = e / B, e % B
    const float2 y = x[col_index<LOG2N>(e % L::B, e / L::B)];
    const float2 w = __ldg(inter + run + e);
    out[run + e] = cmul(y, w.x, w.y);
  }
}

// Pass A. Block b serves column tile b mod TILES_A (columns [c0, c0 + C))
// of frames [j * group, min((j + 1) * group, F, n_valid)), j = b /
// TILES_A: for each frame, its C / B batches of B columns, each a
// register transform of length N1 (pass_twiddles(N1) between passes),
// times the inter-stage twiddle, to scratch[f][k1][n2].
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_A,
                                  LargeRegs<LOG2N>::MIN_BLOCKS_A)
large_regs_a(const uint8_t* __restrict__ raw,      // (F, 2N), 16 B aligned
             const float2* __restrict__ twiddle,   // pass_twiddles(N1)
             const float2* __restrict__ inter,     // W_N^(k1 n2), as scratch
             const float* __restrict__ window,     // (N,) or null
             float2* __restrict__ scratch,         // (F, N), batch-major
             int F, int group, int n_valid) {
  using L = LargeRegs<LOG2N>;
  constexpr int TF = L::TF1;
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2N>(tid);
  const int t = row_of<LOG2N>(tid);
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const int f0 = (blockIdx.x / L::TILES_A) * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);

  // Frame i of the block's tile into ring slot i & 1 (an empty group past
  // its last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src =
          raw + static_cast<size_t>(f0 + i) * 2 * L::N + 2 * c0;
      uint8_t* dst = ring + (i & 1) * L::SLOT_A;
#pragma unroll
      for (int j = 0; j < L::COPIES_A; ++j) {
        const int q = tid + j * L::THREADS_A;
        const int row = q / L::PARTS;
        const int part = q % L::PARTS;
        cp_async16(dst + ring_offset<LOG2N>(row, part),
                   src + static_cast<size_t>(row) * 2 * L::N2 + 16 * part);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const uint8_t* tile = ring + (i & 1) * L::SLOT_A;
    float2* out = scratch + static_cast<size_t>(f0 + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      regs_a_batch<LOG2N, WINDOWED>(s, tile, window, x, twiddle, inter, out,
                                    c, t, c0);
    }
  }
  cp_async_wait<0>();
}

// Pass B. Block b serves rows [k0, k0 + B2), k0 = (b mod TILES_B) * B2, of
// frames [g * group, min((g + 1) * group, F, n_valid)), g = b / TILES_B:
// each row a register transform of length N2 (pass_twiddles(N2)), |X|^2
// summed over the frames in f32 registers, written to those rows' bins
// of row g of `rows` (zeros where it has no frame).
template <int LOG2N>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_B, 2)
large_regs_b(const float2* __restrict__ scratch,   // (F, N), batch-major
             const float2* __restrict__ twiddle,   // pass_twiddles(N2)
             float* __restrict__ rows,             // (ceil(F / group), N)
             int F, int group, int n_valid) {
  using L = LargeRegs<LOG2N>;
  using P = RegsPlan<L::LOG2N2>;
  constexpr int TF = L::TF2;
  extern __shared__ float4 large_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_B;
  const int tid = threadIdx.x;
  const int r = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(large_smem) + r * L::XS2;
  const int k0 = (blockIdx.x % L::TILES_B) * L::B2;
  const int g = blockIdx.x / L::TILES_B;
  const int f0 = g * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;

  // Frame i's B2 rows into the ring: its N2 / B runs of B2 * B values,
  // one bulk copy each, counted on the ring's mbarrier (phase i mod 2;
  // thread 0 arms it for a frame's bytes before a barrier that comes
  // before any of that frame's copies).
  constexpr int kFrameBytes = L::RUNS * L::RUN * 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L::SLOT_B);
  const float2* ring2 = reinterpret_cast<const float2*>(ring);
  auto prefetch = [&](int i) {
    if (i < frames) {
      const float2* src = scratch + static_cast<size_t>(f0 + i) * L::N +
                          k0 * L::B;
      float2* dst = reinterpret_cast<float2*>(ring);
      for (int run = tid; run < L::RUNS; run += L::THREADS_B) {
        bulk_copy(dst + run * L::GS,
                  src + static_cast<size_t>(run) * L::N1 * L::B, L::RUN * 8,
                  bar);
      }
    }
  };

  if (tid == 0) {
    mbarrier_init(bar, 1);
    if (frames > 0) mbarrier_expect(bar, kFrameBytes);
  }
  __syncthreads();
  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    mbarrier_wait(bar, i & 1);   // frame i's runs have landed
    __syncthreads();             // x is free (last pass of frame i - 1)
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int n2 = t + k * TF;
      v[k] = ring2[(n2 / L::B) * L::GS + r * L::B + n2 % L::B];
    }
    if (tid == 0 && i + 1 < frames) mbarrier_expect(bar, kFrameBytes);
    // The ring's reads (generic proxy) before the copy engine's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();             // every row is in registers
    prefetch(i + 1);             // frame i + 1 lands while i is transformed
    first_pass<L::LOG2N2>(v, x, twiddle, t,
                          [](int e) { return pad_index(e); });
    __syncthreads();
    regs_pass<L::LOG2N2, 1>(v, x, twiddle, t);
    if constexpr (P::PASSES > 2) {
      __syncthreads();
      regs_pass<L::LOG2N2, 2>(v, x, twiddle, t);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
  }
  __syncthreads();   // every row is done with the exchange

  // Bin k0 + r + N1 k2 through shared memory, so that a warp writes runs
  // of B2 adjacent bins.
  float* by_bin = reinterpret_cast<float*>(large_smem);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int k2 = pass_bin<L::LOG2N2>(last_element<L::LOG2N2>(t, k));
    by_bin[r * L::XSR + pad_index(k2)] = acc[k];
  }
  __syncthreads();
  float* out = rows + static_cast<size_t>(g) * L::N;
#pragma unroll 4
  for (int j = tid; j < L::B2 * L::N2; j += L::THREADS_B) {
    const int rr = j % L::B2;
    const int k2 = j / L::B2;
    out[k0 + rr + (k2 << L::LOG2N1)] = by_bin[rr * L::XSR + pad_index(k2)];
  }
}

// The sum of G = 2..kSumLanes partial rows: out[bin] = the f32 rounding
// of ((0.0 + row_0) + row_1) + ... in float64, 4 bins a thread. That is
// psd_sum_kernel's order at G <= kSumLanes (lane l takes row l alone; the
// lanes past G add 0.0), so the same bits.
__global__ void __launch_bounds__(256)
psd_rows_sum(const float4* __restrict__ partial, int G, int N4,
             float4* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= N4) return;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  for (int g = 0; g < G; ++g) {
    const float4 p = partial[static_cast<size_t>(g) * N4 + i];
    a0 += static_cast<double>(p.x);
    a1 += static_cast<double>(p.y);
    a2 += static_cast<double>(p.z);
    a3 += static_cast<double>(p.w);
  }
  out[i] = make_float4(static_cast<float>(a0), static_cast<float>(a1),
                       static_cast<float>(a2), static_cast<float>(a3));
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
