// The register passes of the large kernel (fused_psd_large.cu), which the
// large chirp-Z kernel (fused_psd_chirp_large.cu) runs too: pass A's
// column transforms and pass B's row transforms in registers
// (fft_regs.cuh), their layouts, thread maps and rings. What each pass
// does, and why, is stated at the top of fused_psd_large.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_regs.cuh"
#include "fused_psd_regs.cuh"
#include "psd_rows_sum.cuh"
#include "psd_sum.cuh"

namespace {

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

// The outputs of pass 0's radix-16 butterfly of thread t (v[r]: output
// rev_bits(r)), times their twiddles, to x[index(t + k1 * TF)].
template <int LOG2M, typename Index>
__device__ __forceinline__ void first_store(float2 (&v)[16], float2* x,
                                            const float2* __restrict__ twiddle,
                                            int t, Index index) {
  constexpr int TF = RegsPlan<LOG2M>::TF;
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

// Pass 0 of a length-2^LOG2M register transform from v: the radix-16
// butterfly of thread t and its outputs, times their twiddles, to
// x[index(t + k1 * TF)].
template <int LOG2M, typename Index>
__device__ __forceinline__ void first_pass(float2 (&v)[16], float2* x,
                                           const float2* __restrict__ twiddle,
                                           int t, Index index) {
  dif_regs<16>(v, 0);
  first_store<LOG2M>(v, x, twiddle, t, index);
}

// Pass A's batch s after its pass 0 (which wrote x): the column's other
// passes on thread (c, t), then its outputs times the inter-stage twiddle
// to the batch's run of scratch.
template <int LOG2N>
__device__ __forceinline__ void regs_a_rest(
    int s, float2 (&v)[16], float2* x, const float2* __restrict__ twiddle,
    const float2* __restrict__ inter, float2* __restrict__ out, int c, int t,
    int c0) {
  using L = LargeRegs<LOG2N>;
  using P = RegsPlan<L::LOG2N1>;
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
  regs_a_rest<LOG2N>(s, v, x, twiddle, inter, out, c, t, c0);
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

// Pass B's ring slot of row r's value n2: the frame's runs as they are,
// run n2 / B at (n2 / B) * GS.
template <int LOG2N>
__device__ __forceinline__ int run_slot(int r, int n2) {
  using L = LargeRegs<LOG2N>;
  return (n2 / L::B) * L::GS + r * L::B + n2 % L::B;
}

// Pass B's B2 rows of a frame (src: the frame's scratch at row k0's first
// run) into the ring: its N2 / B runs of B2 * B values, one bulk copy each,
// counted on `bar`.
template <int LOG2N>
__device__ __forceinline__ void copy_runs(uint8_t* ring, const float2* src,
                                          uint64_t* bar, int tid) {
  using L = LargeRegs<LOG2N>;
  float2* dst = reinterpret_cast<float2*>(ring);
  for (int run = tid; run < L::RUNS; run += L::THREADS_B) {
    bulk_copy(dst + run * L::GS,
              src + static_cast<size_t>(run) * L::N1 * L::B, L::RUN * 8,
              bar);
  }
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
      copy_runs<LOG2N>(ring,
                       scratch + static_cast<size_t>(f0 + i) * L::N +
                           k0 * L::B,
                       bar, tid);
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
      v[k] = ring2[run_slot<LOG2N>(r, n2)];
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

}  // namespace
