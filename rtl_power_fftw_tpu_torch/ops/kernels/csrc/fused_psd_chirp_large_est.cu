// The CLI estimators' device steps at the large chirp-Z bin counts, for
// NVIDIA Hopper (sm_90a): spectral kurtosis (SK-BL), the multitaper
// (MT-BL) and the polyphase filterbank (PFB-BL) on BL's three register
// passes (fused_psd_chirp_large.cu), at the even N from 8194 to 2^21 that
// neither the power-of-two kernels nor the mixed-radix ones take (9998,
// 16382, 20002, 99998, 2097150 among them; the session routes the even
// 7-smooth N above 16384 to neither), and SK-BL at any even N there under
// --fft-backend bluestein (10000, 16384 and 32768 too). Each form takes
// S >= 1 streams of F frames, (S*F, 2N), with an (S,) count array on the
// device; the one-stream steps call it at S = 1.
//
// They replace no Pallas kernel: the JAX package computes these estimators
// in XLA at every N (rtl_power_fftw_tpu/models/kurtosis.py:_sk_step 46-93,
// multitaper.py:_mt_core 60-133, pfb.py:_pfb_core 48-89, and their sharded
// steps; at these N its transform is ops/dft.py:bluestein_psd_partial 1069
// and, under bluestein, dft_power_bluestein 1060). The function of each is
// the one its chirp-Z form at N <= 8192 computes (fused_psd_chirp_est.cu):
//
//   SK-BL   s1 = sum over valid frames of |X|^2 and s2 = sum of |X|^4,
//           (S, 2, N); with two_sigma > 0 (--sk-excise) also each stream's
//           gate on its own SK, s1 * keep and n_valid * keep, (S, 4, N);
//   MT-BL   the sum over valid frames of the mean over K tapers of
//           |DFT(x * taper_k)|^2, (S, N);
//   PFB-BL  the sum over output frames j < n_valid of |DFT(S_j)|^2, S_j[n]
//           = sum over p = 0 .. P-1, in that order from zero, of h[p, n] *
//           x_{j+p}[n] (each product and sum rounded on its own) over each
//           stream's virtual array of P - 1 history rows and F frames; each
//           stream's next history written to history_out on the stream.
//
// Each changes BL only where its function differs. The passes are BL's
// streams passes (fused_psd_chirp_large_regs.cuh: chirp_streams_a/b/c,
// the stream on the grid's y axis, the counts read on the card) but for:
//
//   SK-BL   pass C: chirp_sk_c keeps a sum of |z|^4 beside each sum of
//           |z|^2 (acc2[16] beside acc[16]; the |z|^2 sums are BL's own
//           expression, so on BL's grid s1 is BL's rows bit for bit) and
//           writes it to a second plane of partial rows, (2, S G_s, row);
//           est_streams_kernel (fused_psd_est.cuh) adds each stream's rows
//           in psd_sum.cuh's order, with the gate of --sk-excise;
//   MT-BL   a taper loop: passes A (windowed by taper row k of the (K, N)
//           table), B and C once a taper over one (S F, M) scratch, which
//           the next taper's pass A overwrites (64 MB at F = 256, M =
//           2^15, 256 MB at F = 8, M = 2^22, where the taper on the grid
//           would take 7 times that at K = 7); taper k's pass C writes
//           partial row (k S + s) G_s + j, and est_streams_kernel
//           <kEstTapers> sums each stream's K G_s rows and divides by K.
//           Each frame is read K times, as MT-B reads it;
//   PFB-BL  a pre-pass, pfb_sums_kernel (pfb_sums.cuh), forms every
//           polyphase sum (n1 < M1 / 2, n < N) in one streaming pass over
//           the stream's virtual rows and writes it into the scratch where
//           pass A writes that value; pass A, chirp_pfb_sums_a, reads its
//           batch's sums from there in place of the ring, then the product
//           with the chirp a[n]. The next histories are
//           launch_pfb_history's (pfb_history.cuh: its wide kernel for the
//           rows of 2N >= 64 KB, M >= 2^16). Its first form, chirp_pfb_a
//           (the sums in pass A's load: the own row from the ring, the
//           older rows and h through L1/L2, a sample at a time), stays as
//           the control, rpf_fused_psd_pfb_chirp_large_control.
//
// The passes are generic in log2 M and instantiated at BL's M = 2^15 ..
// 2^22 (M = chirp_size(N): 2^15 for N in (8192, 16384], 2^22 for N in
// (2^20, 2^21]); the entries dispatch on log2 M (at_log2m), and each M's
// passes opt into their shared memory apart. The grid is BL's own (the
// wrapper takes BL's residency), so SK-BL's s1 at S = 1 is BL's output and
// each stream's rows are the S = 1 form's on the same groups.
//
// What bounds them on an H100: BL's bound (the frames' 2 bytes a sample;
// the form moves 8M bytes of scratch a frame four times, which the bound
// of the function does not count), times K passes for MT-BL, and for
// PFB-BL plus h (4 P N bytes) and the history once, and the pre-pass's
// sums, 8N bytes a frame written and read back.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "device.cuh"
#include "fused_psd_chirp_large_regs.cuh"
#include "fused_psd_est.cuh"
#include "large_streams.cuh"
#include "pfb_history.cuh"
#include "pfb_sums.cuh"
#include "psd_sum.cuh"

namespace {

// The M = 2^log2m instantiated here: BL's own, 2^15 .. 2^22.
constexpr int kEstMinLog2M = 15;
constexpr int kEstMaxLog2M = 22;

// PFB-BL's sample n of output frame j: sum over p < P, in order from zero,
// of h[p, n] times virtual row j + p (row r < P - 1 of `history`, else
// frame r - (P - 1) of `frames`), the last row's value `own` from the
// ring; each product and sum rounded on its own, as frame_ring.cuh's
// pfb_sample adds them.
__device__ __forceinline__ float2 pfb_sum(unsigned own,
                                          const uint8_t* __restrict__ frames,
                                          const uint8_t* __restrict__ history,
                                          const float* __restrict__ h, int j,
                                          int P, int bins, int n) {
  float re = 0.0f;
  float im = 0.0f;
  for (int p = 0; p < P; ++p) {
    unsigned u = own;
    if (p < P - 1) {
      const int r = j + p;
      const uint8_t* row =
          r < P - 1 ? history + static_cast<size_t>(r) * 2 * bins
                    : frames + static_cast<size_t>(r - (P - 1)) * 2 * bins;
      u = __ldg(reinterpret_cast<const uint16_t*>(row) + n);
    }
    const float hv = __ldg(h + static_cast<size_t>(p) * bins + n);
    re = __fadd_rn(re, __fmul_rn(dequant_byte(u & 0xFFu), hv));
    im = __fadd_rn(im, __fmul_rn(dequant_byte(u >> 8), hv));
  }
  return make_float2(re, im);
}

// chirp_a_batch with PFB-BL's load: batch s of output frame j on thread
// (c, t), the polyphase sums of the column's samples n = (t + k TF1) M2 +
// c0 + s B + c, k < 8, times a[n], 0 where n >= bins; then BL's pass 0
// and regs_a_rest.
template <int LOG2M>
__device__ __forceinline__ void chirp_pfb_batch(
    int s, const uint8_t* tile, const uint8_t* __restrict__ frames,
    const uint8_t* __restrict__ history, const float* __restrict__ h, int j,
    int taps, const float2* __restrict__ chirp, float2* x,
    const float2* __restrict__ twiddle, const float2* __restrict__ inter,
    float2* __restrict__ out, int c, int t, int c0, int bins) {
  using L = LargeRegs<LOG2M>;
  constexpr int TF = L::TF1;
  if (s > 0) __syncthreads();   // x is free (last pass of batch s - 1)
  const int col = s * L::B + c;
  const int byte = 2 * col;
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int row = t + k * TF;
    const int n = (row << L::LOG2N2) + c0 + col;
    float2 y = make_float2(0.0f, 0.0f);
    if (n < bins) {
      const unsigned own = *reinterpret_cast<const uint16_t*>(
          tile + ring_offset<LOG2M>(row, byte >> 4) + (byte & 15));
      y = cmulf(pfb_sum(own, frames, history, h, j, taps, bins, n),
                __ldg(chirp + k * L::THREADS_A + threadIdx.x));
    }
    v[k] = y;
  }
  dif_stage_half_zero<16>(v);
  dif_regs<16, 4>(v, 0);
  first_store<L::LOG2N1>(v, x, twiddle, t,
                         [c](int e) { return col_index<LOG2M>(c, e); });
  regs_a_rest<LOG2M>(s, v, x, twiddle, inter, out, c, t, c0);
}

// PFB-BL's pass A: chirp_streams_a with chirp_pfb_batch. Block (x, s) as
// streams_block; frame i of the block is output frame j = f0 + i of
// stream s, whose own row the ring holds; `history` is (S, P - 1, 2 bins)
// (null at P = 1), stream s's rows at s (P - 1) 2 bins.
template <int LOG2M>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_A,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_A)
chirp_pfb_a(const uint8_t* __restrict__ raw,       // (S*F, 2 bins)
            const uint8_t* __restrict__ history,   // (S, P-1, 2 bins)
            const float* __restrict__ h,           // (P, bins)
            const float2* __restrict__ twiddle,    // pass_twiddles(M1)
            const float2* __restrict__ inter,      // W_M^(k1 n2)
            const float2* __restrict__ chirp,      // a, the threads' order
            float2* __restrict__ scratch,          // (S*F, M)
            int bins, int width, int F, int group, int G_s,
            const int* __restrict__ counts, int taps) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2M>(tid);
  const int t = row_of<LOG2M>(tid);
  const int tile = blockIdx.x % L::TILES_A;
  const int c0 = tile * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  const int stream = blockIdx.y;
  const int j0 = first - stream * F;
  const uint8_t* own_frames = raw + static_cast<size_t>(stream) * F * 2 * bins;
  const uint8_t* rows =
      taps > 1 ? history + static_cast<size_t>(stream) * (taps - 1) * 2 * bins
               : nullptr;
  // The tile's rows with a sample, copied as chirp_streams_a copies them.
  const int ring_rows = min(CR::ROWS_A, (bins - c0 + L::N2 - 1) >> L::LOG2N2);
  const int lw = width == 16 ? 4 : width == 8 ? 3 : 2;
  const int lp = log2_of(L::ROW_BYTES) - lw;
  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src =
          raw + static_cast<size_t>(first + i) * 2 * bins + 2 * c0;
      uint8_t* dst = ring + (i & 1) * CR::SLOT_A;
      for (int q = tid; q < (ring_rows << lp); q += L::THREADS_A) {
        const int row = q >> lp;
        const int byte = (q - (row << lp)) << lw;
        if ((row << L::LOG2N2) + c0 + (byte >> 1) < bins) {
          copy_piece(dst + ring_offset<LOG2M>(row, byte >> 4) + (byte & 15),
                     src + (static_cast<size_t>(row) << (L::LOG2N2 + 1)) +
                         byte,
                     width);
        }
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const uint8_t* slot = ring + (i & 1) * CR::SLOT_A;
    float2* out = scratch + static_cast<size_t>(first + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      chirp_pfb_batch<LOG2M>(
          s, slot, own_frames, rows, h, j0 + i, taps,
          chirp + (tile * L::SUBS + s) * CR::CHIRP_A, x, twiddle, inter, out,
          c, t, c0, bins);
    }
  }
  cp_async_wait<0>();
}

// PFB-BL's pass A: chirp_streams_a whose batch takes the column's 8
// polyphase sums (rows n1 < M1 / 2, 0 where n >= bins) from the scratch,
// where pfb_sums_kernel wrote them in the threads' order in the place
// this batch writes its run (value k of thread tid at k THREADS_A + tid:
// the run's first half), in place of the raw frame: copied as they lie
// into a ring of two slots by cp.async, the next batch's while this one
// is transformed, as large_pfb_sums_a copies them; times a[n]; then BL's
// pass 0 and regs_a_rest. Two blocks an SM.
template <int LOG2M>
__global__ void __launch_bounds__(LargeRegs<LOG2M>::THREADS_A, 2)
chirp_pfb_sums_a(const float2* __restrict__ twiddle,   // pass_twiddles(M1)
                 const float2* __restrict__ inter,     // W_M^(k1 n2)
                 const float2* __restrict__ chirp,     // a, threads' order
                 float2* scratch,   // (S*F, M): the sums in, pass A out
                 int bins, int F, int group, int G_s,
                 const int* __restrict__ counts) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  constexpr int TF = L::TF1;
  constexpr int RUN = L::N1 * L::B;       // a batch's run of scratch
  constexpr int HALF = 8 * L::THREADS_A;  // its sums, 8 a thread
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  float2* ring = x + L::XBYTES_A / 8;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2M>(tid);
  const int t = row_of<LOG2M>(tid);
  const int tile = blockIdx.x % L::TILES_A;
  const int c0 = tile * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int batches = blk.frames * L::SUBS;
  auto run_of = [&](int q) {
    return scratch + static_cast<size_t>(blk.first + q / L::SUBS) * L::N +
           (c0 / L::B + q % L::SUBS) * RUN;
  };
  auto prefetch = [&](int q) {
    if (q < batches) {
      sums_prefetch(ring + (q & 1) * HALF, run_of(q), HALF, tid,
                    L::THREADS_A);
    }
    cp_async_commit();
  };
  prefetch(0);
  for (int q = 0; q < batches; ++q) {
    prefetch(q + 1);
    cp_async_wait<1>();   // this thread's copies of batch q have landed
    __syncthreads();      // everyone's; x is free (batch q - 1's stores)
    const int s = q % L::SUBS;
    const int col = s * L::B + c;
    const float2* slot = ring + (q & 1) * HALF + tid;
    const float2* a = chirp + (tile * L::SUBS + s) * CR::CHIRP_A;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int row = t + k * TF;
      const int n = (row << L::LOG2N2) + c0 + col;
      float2 y = make_float2(0.0f, 0.0f);
      if (n < bins) {
        y = cmulf(slot[k * L::THREADS_A], __ldg(a + k * L::THREADS_A + tid));
      }
      v[k] = y;
    }
    dif_stage_half_zero<16>(v);
    dif_regs<16, 4>(v, 0);
    first_store<L::LOG2N1>(v, x, twiddle, t,
                           [c](int e) { return col_index<LOG2M>(c, e); });
    regs_a_rest<LOG2M>(s, v, x, twiddle, inter,
                       scratch + static_cast<size_t>(blk.first +
                                                     q / L::SUBS) * L::N,
                       c, t, c0);
  }
  cp_async_wait<0>();
}

// Shared memory of chirp_pfb_sums_a: the exchange and two slots of a
// batch's sums.
template <int LOG2M>
constexpr int sums_a_smem() {
  return LargeRegs<LOG2M>::XBYTES_A + 2 * 8 * LargeRegs<LOG2M>::THREADS_A * 8;
}

// SK-BL's pass C: chirp_streams_c with a sum of |z|^4 beside each sum of
// |z|^2 (the latter BL's expression), the s1 row to partial row s G_s +
// x / TILES_C of `rows` and the s2 row to row (S + s) G_s + x / TILES_C.
template <int LOG2M>
__global__ void __launch_bounds__(ChirpRegs<LOG2M>::THREADS_C,
                                  ChirpRegs<LOG2M>::MIN_BLOCKS_C)
chirp_sk_c(const float2* __restrict__ scratch,   // (S*F, M)
           const float2* __restrict__ twiddle,   // pass_twiddles(M1)
           float* __restrict__ rows,             // (2, S*G_s, row)
           int bins, int row, int F, int group, int G_s,
           const int* __restrict__ counts) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P = RegsPlan<L::LOG2N1>;
  constexpr int TF = L::TF1;
  extern __shared__ float4 large_smem[];
  float2* xb = reinterpret_cast<float2*>(large_smem);
  const int tid = threadIdx.x;
  const int c = col_of<LOG2M>(tid);
  const int t = row_of<LOG2M>(tid);
  const int batch = blockIdx.x % CR::TILES_C;
  const StreamsBlock blk = streams_block(CR::TILES_C, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  const auto index = [c](int e) { return col_index<LOG2M>(c, e); };

  // Frame i's batch into buffer i & 1, in the exchange's layout.
  auto prefetch = [&](int i) {
    if (i < frames) {
      const float2* src = scratch +
                          static_cast<size_t>(first + i) * L::N +
                          static_cast<size_t>(batch) * L::N1 * L::B;
      float2* dst = xb + (i & 1) * CR::XFLOATS_C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = tid + j * CR::THREADS_C;
        cp_async_ca<8>(dst + col_index<LOG2M>(e % L::B, e / L::B), src + e);
      }
    }
    cp_async_commit();
  };

  float acc[16];
  float acc2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    acc[k] = 0.0f;
    acc2[k] = 0.0f;
  }
  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    cp_async_wait<0>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; frame i - 1's buffer is free
    prefetch(i + 1);
    float2* x = xb + (i & 1) * CR::XFLOATS_C;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x[index(t + k * TF)];
    // Pass 0 writes the thread's own elements: no barrier before it.
    first_pass<L::LOG2N1>(v, x, twiddle, t, index);
    __syncthreads();
    col_pass<LOG2M, 1>(v, x, twiddle, t, c);
    if constexpr (P::PASSES > 2) {
      __syncthreads();
      col_pass<LOG2M, 2>(v, x, twiddle, t, c);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float pw = v[k].x * v[k].x + v[k].y * v[k].y;
      acc[k] += pw;
      acc2[k] += pw * pw;
    }
  }
  cp_async_wait<0>();
  float* out = rows + static_cast<size_t>(blk.rest) * row;
  float* out2 =
      rows + (static_cast<size_t>(gridDim.y) * G_s + blk.rest) * row;
  const int m2 = batch * L::B + c;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int m1 = pass_bin<L::LOG2N1>(last_element<L::LOG2N1>(t, k));
    const int m = m2 + (m1 << L::LOG2N2);
    if (m < bins) {
      out[m] = acc[k];
      out2[m] = acc2[k];
    }
  }
}

// The passes of this library, as the attributes entry numbers them: BL-S's
// pass A unwindowed (0) and windowed (1), pass B (2), pass C (3), and the
// forms' own SK pass C (4), PFB pass A (5), the PFB's pre-pass at the tap
// classes 4 (6) and 32 (7), and the control's PFB pass A (8).
constexpr int kPasses = 9;
constexpr int kPfbPassA = 5;
constexpr int kPfbControlA = 8;

template <int LOG2M>
const void* pass_kernel(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(chirp_streams_a<LOG2M, false>);
    case 1: return reinterpret_cast<const void*>(chirp_streams_a<LOG2M, true>);
    case 2: return reinterpret_cast<const void*>(chirp_streams_b<LOG2M>);
    case 3: return reinterpret_cast<const void*>(chirp_streams_c<LOG2M>);
    case 4: return reinterpret_cast<const void*>(chirp_sk_c<LOG2M>);
    case 5: return reinterpret_cast<const void*>(chirp_pfb_sums_a<LOG2M>);
    case 6: return sums_kernel<4>();
    case 7: return sums_kernel<32>();
    default: return reinterpret_cast<const void*>(chirp_pfb_a<LOG2M>);
  }
}

template <int LOG2M>
constexpr int pass_smem(int which) {
  using CR = ChirpRegs<LOG2M>;
  return which == 2 ? CR::SMEM_B
         : which == 3 || which == 4 ? CR::SMEM_C
         : which == kPfbPassA       ? sums_a_smem<LOG2M>()
         : which == 6 || which == 7 ? 0
                                    : CR::SMEM_A;
}

template <int LOG2M>
constexpr int pass_threads(int which) {
  return which == 2 ? LargeRegs<LOG2M>::THREADS_B
         : which == 6 || which == 7 ? kSumsThreads
                                    : LargeRegs<LOG2M>::THREADS_A;
}

// The devices (a bit each) on which a pass at M = 2^LOG2M is opted into
// its shared memory.
template <int LOG2M>
std::atomic<unsigned long long> pass_done[kPasses];

template <int LOG2M>
cudaError_t prepare(int which, int device) {
  return opt_in_smem(pass_kernel<LOG2M>(which), pass_smem<LOG2M>(which),
                     device, pass_done<LOG2M>[which]);
}

// A form's launch: S streams of F frames, frames a block of passes A, B
// and C, the counts on the card, the buffers and BL's tables.
struct Launch {
  const uint8_t* raw;
  const float2* twiddle;   // pass_twiddles(M1) then pass_twiddles(M2)
  const float2* inter;
  const float2* chirp;
  const float2* spectrum;
  const int* counts;
  float2* scratch;
  int bins, width, S, F, group_a, group_b, group_c;
  cudaStream_t st;

  int g_a() const { return (F + group_a - 1) / group_a; }
  int g_b() const { return (F + group_b - 1) / group_b; }
  int g_c() const { return (F + group_c - 1) / group_c; }
  int row() const { return (bins + kSumBins - 1) / kSumBins * kSumBins; }
};

// Pass A as BL-S runs it (windowed by `window` where given), on `l.st`.
template <int LOG2M>
cudaError_t launch_a(const Launch& l, const float* window, int device) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  const cudaError_t e = prepare<LOG2M>(window ? 1 : 0, device);
  if (e != cudaSuccess) return e;
  const dim3 grid(l.g_a() * L::TILES_A, l.S);
  if (window) {
    chirp_streams_a<LOG2M, true><<<grid, L::THREADS_A, CR::SMEM_A, l.st>>>(
        l.raw, l.twiddle, l.inter, window, l.chirp, l.scratch, l.bins,
        l.width, l.F, l.group_a, l.g_a(), l.counts);
  } else {
    chirp_streams_a<LOG2M, false><<<grid, L::THREADS_A, CR::SMEM_A, l.st>>>(
        l.raw, l.twiddle, l.inter, nullptr, l.chirp, l.scratch, l.bins,
        l.width, l.F, l.group_a, l.g_a(), l.counts);
  }
  return cudaGetLastError();
}

// Pass B as BL-S runs it, on `l.st`.
template <int LOG2M>
cudaError_t launch_b(const Launch& l, int device) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  using P1 = RegsPlan<L::LOG2N1>;
  const cudaError_t e = prepare<LOG2M>(2, device);
  if (e != cudaSuccess) return e;
  chirp_streams_b<LOG2M>
      <<<dim3(l.g_b() * L::TILES_B, l.S), L::THREADS_B, CR::SMEM_B, l.st>>>(
          l.scratch, l.twiddle + P1::twiddle_offset(P1::PASSES - 1),
          l.spectrum, l.inter, l.F, l.group_b, l.g_b(), l.counts);
  return cudaGetLastError();
}

// Pass C as BL-S runs it, each stream's partial rows to `rows`, on `l.st`.
template <int LOG2M>
cudaError_t launch_c(const Launch& l, float* rows, int device) {
  using CR = ChirpRegs<LOG2M>;
  const cudaError_t e = prepare<LOG2M>(3, device);
  if (e != cudaSuccess) return e;
  chirp_streams_c<LOG2M>
      <<<dim3(l.g_c() * CR::TILES_C, l.S), CR::THREADS_C, CR::SMEM_C,
         l.st>>>(l.scratch, l.twiddle, rows, l.bins, l.row(), l.F,
                 l.group_c, l.g_c(), l.counts);
  return cudaGetLastError();
}

template <int LOG2M>
cudaError_t launch_sk(const Launch& l, const float* window, float* partial,
                      float* out, float two_sigma, int device) {
  using CR = ChirpRegs<LOG2M>;
  cudaError_t e = launch_a<LOG2M>(l, window, device);
  if (e == cudaSuccess) e = launch_b<LOG2M>(l, device);
  if (e == cudaSuccess) e = prepare<LOG2M>(4, device);
  if (e != cudaSuccess) return e;
  chirp_sk_c<LOG2M>
      <<<dim3(l.g_c() * CR::TILES_C, l.S), CR::THREADS_C, CR::SMEM_C,
         l.st>>>(l.scratch, l.twiddle, partial, l.bins, l.row(), l.F,
                 l.group_c, l.g_c(), l.counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return two_sigma > 0.0f
             ? launch_est_streams<kEstSkGate>(partial, l.S, l.g_c(), 1,
                                              l.row(), l.counts, l.F, 0,
                                              two_sigma, out, l.st)
             : launch_est_streams<kEstSk>(partial, l.S, l.g_c(), 1, l.row(),
                                          l.counts, l.F, 0, two_sigma, out,
                                          l.st);
}

template <int LOG2M>
cudaError_t launch_tapers(const Launch& l, const float* tapers, int K,
                          float* partial, float* out, int device) {
  const size_t plane = static_cast<size_t>(l.S) * l.g_c() * l.row();
  for (int k = 0; k < K; ++k) {
    cudaError_t e = launch_a<LOG2M>(
        l, tapers + static_cast<size_t>(k) * l.bins, device);
    if (e == cudaSuccess) e = launch_b<LOG2M>(l, device);
    if (e == cudaSuccess) e = launch_c<LOG2M>(l, partial + k * plane, device);
    if (e != cudaSuccess) return e;
  }
  return launch_est_streams<kEstTapers>(partial, l.S, l.g_c(), K, l.row(),
                                        l.counts, l.F, K, 0.0f, out, l.st);
}

// PFB-BL: the pre-pass and chirp_pfb_sums_a, or with `load` the first
// form's chirp_pfb_a (the sums in its load); then passes B and C and the
// sum.
template <int LOG2M>
cudaError_t launch_pfb(const Launch& l, const uint8_t* history,
                       const float* h, int P, float* partial, float* out,
                       int device, bool load) {
  using L = LargeRegs<LOG2M>;
  using CR = ChirpRegs<LOG2M>;
  const dim3 grid(l.g_a() * L::TILES_A, l.S);
  cudaError_t e = prepare<LOG2M>(load ? kPfbControlA : kPfbPassA, device);
  if (e != cudaSuccess) return e;
  if (load) {
    chirp_pfb_a<LOG2M><<<grid, L::THREADS_A, CR::SMEM_A, l.st>>>(
        l.raw, history, h, l.twiddle, l.inter, l.chirp, l.scratch, l.bins,
        l.width, l.F, l.group_a, l.g_a(), l.counts, P);
  } else {
    const SumsShape shape{l.bins,        L::LOG2N2,     L::LOG2N1,
                          log2_of(L::B), log2_of(L::V), CR::ROWS_A,
                          L::N};
    e = launch_pfb_sums(l.raw, history, h, l.scratch, shape, l.S, l.F, P,
                        l.counts, l.st);
    if (e != cudaSuccess) return e;
    chirp_pfb_sums_a<LOG2M><<<grid, L::THREADS_A, sums_a_smem<LOG2M>(),
                              l.st>>>(
        l.twiddle, l.inter, l.chirp, l.scratch, l.bins, l.F, l.group_a,
        l.g_a(), l.counts);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_b<LOG2M>(l, device);
  if (e == cudaSuccess) {
    e = launch_c<LOG2M>(l, l.g_c() == 1 ? out : partial, device);
  }
  if (e != cudaSuccess || l.g_c() == 1) return e;
  return launch_rows_sum(partial, l.S, l.g_c(), l.row(), out, l.st);
}

// The checks every entry makes of a launch at M = 2^log2m.
bool launch_ok(const Launch& l, int log2m) {
  const int M = 1 << log2m;
  return log2m >= kEstMinLog2M && log2m <= kEstMaxLog2M && l.S > 0 && l.S <= kMaxGridY && l.F > 0 &&
         l.group_a > 0 && l.group_b > 0 && l.group_c > 0 && l.bins >= 2 &&
         l.bins % 2 == 0 && 2 * l.bins <= M && 4 * l.bins > M &&
         (l.width == 4 || l.width == 8 || l.width == 16) &&
         (2 * l.bins) % l.width == 0 && l.raw != nullptr &&
         reinterpret_cast<uintptr_t>(l.raw) % l.width == 0 &&
         l.twiddle != nullptr && l.inter != nullptr && l.chirp != nullptr &&
         l.spectrum != nullptr && l.counts != nullptr && l.scratch != nullptr;
}

// fn(std::integral_constant<int, log2m>) for an instantiated log2m.
template <typename Fn>
cudaError_t at_log2m(int log2m, Fn fn) {
  switch (log2m) {
    case 15: return fn(std::integral_constant<int, 15>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 17: return fn(std::integral_constant<int, 17>{});
    case 18: return fn(std::integral_constant<int, 18>{});
    case 19: return fn(std::integral_constant<int, 19>{});
    case 20: return fn(std::integral_constant<int, 20>{});
    case 21: return fn(std::integral_constant<int, 21>{});
    case 22: return fn(std::integral_constant<int, 22>{});
    default: return cudaErrorInvalidValue;
  }
}

Launch make_launch(const void* raw, const void* twiddle, const void* inter,
                   const void* chirp, const void* spectrum,
                   const void* counts, void* scratch, int bins, int width,
                   int S, int F, int group_a, int group_b, int group_c,
                   void* stream) {
  return {static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float2*>(inter),
          static_cast<const float2*>(chirp),
          static_cast<const float2*>(spectrum),
          static_cast<const int*>(counts),
          static_cast<float2*>(scratch),
          bins, width, S, F, group_a, group_b, group_c,
          static_cast<cudaStream_t>(stream)};
}

// PFB-BL's entry: the pre-pass and pass A on its sums, which the card
// measured faster than the first form at every M and P
// (probes/large_estimator_builds.py, route sweep), or with `control` the
// first form.
int pfb_entry(const void* raw, const void* history, const void* twiddle,
              const void* inter, const void* h, const void* chirp,
              const void* spectrum, const void* counts, void* scratch,
              void* partial, void* out, void* history_out, int device,
              int log2m, int bins, int width, int S, int F, int group_a,
              int group_b, int group_c, int P, int fresh, void* stream,
              bool control) {
  const Launch l = make_launch(raw, twiddle, inter, chirp, spectrum, counts,
                               scratch, bins, width, S, F, group_a, group_b,
                               group_c, stream);
  if (!launch_ok(l, log2m) || P < 1 || P > 32 || h == nullptr ||
      out == nullptr ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out ||
                 reinterpret_cast<uintptr_t>(history) % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(history_out) % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess && fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * 2 * bins, l.st);
  }
  if (e == cudaSuccess) {
    e = at_log2m(log2m, [&](auto m) {
      return launch_pfb<decltype(m)::value>(
          l, static_cast<const uint8_t*>(history),
          static_cast<const float*>(h), P, static_cast<float*>(partial),
          static_cast<float*>(out), device, control);
    });
  }
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             counts, S, F, P, 2 * bins,
                                             l.st));
}

}  // namespace

extern "C" {

// SK-BL: launches passes A, B, SK's pass C and the sum on `stream`. raw:
// (S*F, 2N) u8, stream s in rows [s F, s F + F), `width`-byte aligned (4,
// 8 or 16, dividing 2N: fused_psd_mixed.copy_width); twiddle:
// pass_twiddles(M1) then pass_twiddles(M2); inter, chirp, spectrum: BL's
// tables (rpf_fused_psd_chirp_large); window: (N,) f32, or null; counts:
// (S,) int32 on the device, each stream's valid frames (read when the
// passes run; a count outside [0, F] acts as its nearest bound); scratch:
// (S*F, M) complex64; partial: (2, S * ceil(F / group_c), row) f32; out:
// (S, 2, row) f32 (s1, s2 of each stream), or with two_sigma > 0 (S, 4,
// row), each stream gated on its own moments and count; row = N rounded
// up to 32; M = 2^log2m = chirp_size(N), 15..22. Returns
// a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk_chirp_large(const void* raw, const void* twiddle,
                                 const void* inter, const void* window,
                                 const void* chirp, const void* spectrum,
                                 const void* counts, void* scratch,
                                 void* partial, void* out, int device,
                                 int log2m, int bins, int width, int S, int F,
                                 int group_a, int group_b, int group_c,
                                 float two_sigma, void* stream) {
  const Launch l = make_launch(raw, twiddle, inter, chirp, spectrum, counts,
                               scratch, bins, width, S, F, group_a, group_b,
                               group_c, stream);
  if (!launch_ok(l, log2m) || !(two_sigma >= 0.0f) || partial == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2m(log2m, [&](auto m) {
      return launch_sk<decltype(m)::value>(
          l, static_cast<const float*>(window), static_cast<float*>(partial),
          static_cast<float*>(out), two_sigma, device);
    });
  }
  return static_cast<int>(e);
}

// MT-BL: tapers: (K, N) f32, 1 <= K <= 32, shared by the streams; partial:
// (K, S * ceil(F / group_c), row) f32; out: (S, row) f32. Other arguments
// as rpf_fused_psd_sk_chirp_large.
int rpf_fused_psd_tapers_chirp_large(const void* raw, const void* twiddle,
                                     const void* inter, const void* tapers,
                                     const void* chirp, const void* spectrum,
                                     const void* counts, void* scratch,
                                     void* partial, void* out, int device,
                                     int log2m, int bins, int width, int S,
                                     int F, int group_a, int group_b,
                                     int group_c, int K, void* stream) {
  const Launch l = make_launch(raw, twiddle, inter, chirp, spectrum, counts,
                               scratch, bins, width, S, F, group_a, group_b,
                               group_c, stream);
  if (!launch_ok(l, log2m) || K < 1 || K > 32 || tapers == nullptr ||
      partial == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2m(log2m, [&](auto m) {
      return launch_tapers<decltype(m)::value>(
          l, static_cast<const float*>(tapers), K,
          static_cast<float*>(partial), static_cast<float*>(out), device);
    });
  }
  return static_cast<int>(e);
}

// PFB-BL: history, history_out: (S, P - 1, 2N) u8, distinct, 4-byte
// aligned (null when P = 1), stream s's rows together; h: (P, N) f32, 1 <=
// P <= 32; partial: (S * ceil(F / group_c), row) f32 (unused for one row
// a stream); out: (S, row) f32; fresh: set every stream's history to byte
// 127 first. After the sum, each stream's next history (rows n_valid[s] ..
// n_valid[s] + P - 2 of its virtual array) is written to history_out on
// the stream (pfb_history.cuh). The sums by the pre-pass, then pass A over
// them. Other arguments as rpf_fused_psd_sk_chirp_large.
int rpf_fused_psd_pfb_chirp_large(const void* raw, const void* history,
                                  const void* twiddle, const void* inter,
                                  const void* h, const void* chirp,
                                  const void* spectrum, const void* counts,
                                  void* scratch, void* partial, void* out,
                                  void* history_out, int device, int log2m,
                                  int bins, int width, int S, int F,
                                  int group_a, int group_b, int group_c,
                                  int P, int fresh, void* stream) {
  return pfb_entry(raw, history, twiddle, inter, h, chirp, spectrum, counts,
                   scratch, partial, out, history_out, device, log2m, bins,
                   width, S, F, group_a, group_b, group_c, P, fresh, stream,
                   false);
}

// The control of rpf_fused_psd_pfb_chirp_large, the same arguments:
// PFB-BL's first form, the sums in pass A's load (chirp_pfb_a).
int rpf_fused_psd_pfb_chirp_large_control(
    const void* raw, const void* history, const void* twiddle,
    const void* inter, const void* h, const void* chirp, const void* spectrum,
    const void* counts, void* scratch, void* partial, void* out,
    void* history_out, int device, int log2m, int bins, int width, int S,
    int F, int group_a, int group_b, int group_c, int P, int fresh,
    void* stream) {
  return pfb_entry(raw, history, twiddle, inter, h, chirp, spectrum, counts,
                   scratch, partial, out, history_out, device, log2m, bins,
                   width, S, F, group_a, group_b, group_c, P, fresh, stream,
                   true);
}

// Writes what a pass gets at M = 2^log2m on `device` into attrs[0..5]
// (which: 0 pass A, 1 pass A windowed, 2 pass B, 3 pass C, 4 SK's pass C,
// 5 the PFB's pass A, 6 and 7 its pre-pass at P <= 4 and P <= 32, 8 the
// control's PFB pass A): registers and local (spill) bytes a thread, static
// and dynamic shared bytes a block, threads a block, and the blocks that
// reside on one SM. Launches nothing.
int rpf_fused_psd_chirp_large_est_attributes(int log2m, int which,
                                             int device, int* attrs) {
  if (log2m < kEstMinLog2M || log2m > kEstMaxLog2M || which < 0 ||
      which >= kPasses || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2m(log2m, [&](auto m) {
      constexpr int L = decltype(m)::value;
      cudaError_t r = prepare<L>(which, device);
      if (r == cudaSuccess) {
        r = kernel_attributes(pass_kernel<L>(which), pass_threads<L>(which),
                              pass_smem<L>(which), attrs);
      }
      return r;
    });
  }
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
