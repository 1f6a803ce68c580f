// The CLI estimators' device steps at the chirp-Z bin counts, for NVIDIA
// Hopper (sm_90a): spectral kurtosis (SK-B), the multitaper (MT-B) and the
// polyphase filterbank (PFB-B) at the even N up to 8192 that neither the
// power-of-two kernels nor the mixed-radix kernel take (998, 4094, 8188,
// 22 among them), and SK-B at any even N up to 8192 under
// --fft-backend bluestein.
//
// They replace no Pallas kernel: the JAX package computes these estimators
// in XLA at every N (rtl_power_fftw_tpu/models/kurtosis.py:_sk_step 46-93,
// multitaper.py:_mt_core 60-133, pfb.py:_pfb_core 48-89; under bluestein
// ops/dft.py:dft_power_bluestein 1060). Here they are forms of the chirp-Z
// group kernel psd_chirp_kernel (fused_psd_chirp.cuh), the function of
// each the one fused_psd_sk.cu, fused_psd_tapers.cu and fused_psd_pfb.cu
// compute at the powers of two:
//
//   SK-B    s1 = sum over valid frames of |X|^2 and s2 = sum of |X|^4, (2, N);
//           with two_sigma > 0 (--sk-excise) also the block's gate on its
//           own SK, s1 * keep and n_valid * keep (fused_psd_est.cuh);
//   MT-B    the sum over valid frames of the mean over K tapers of
//           |DFT(x * taper_k)|^2, (N,);
//   PFB-B   the sum over output frames j < n_valid of |DFT(S_j)|^2, S_j[n] =
//           sum over p = 0 .. P-1, in that order from zero, of h[p, n] *
//           x_{j+p}[n] (each product and sum rounded on its own) over one
//           virtual array of P - 1 history rows and the step's F rows; the
//           next history (rows n_valid .. n_valid + P - 2 of it) written to
//           history_out on the stream, as rpf_fused_psd_pfb does.
//
// psd_chirp_est_kernel<LOG2M, WINDOWED, CUT> is psd_chirp_kernel's body
// (pass 0 from the ring slot times the chirp a[s], the forward register
// passes, the turn by B / M, the transposed passes, the |X|^2 sums of the
// thread's half of pass 0's outputs in registers, the lanes' sums by bin
// in shared memory) with the cut's differences in three places:
//
//   pass 0's samples  kChirpTapers windows by row blockIdx.y of a (K, N)
//                     taper table; kChirpPfb's are the polyphase sums
//                     (pfb_sample: the ring slot holds frame j's own row,
//                     virtual row j + P - 1, the P - 1 rows before it are
//                     read through L1/L2 from the history or the frames),
//                     each before its product with a[s], as _pfb_core
//                     transforms S_j;
//   the sums          kChirpSk keeps a sum of |X|^4 beside each sum of
//                     |X|^2 (add_half_power_sk), in R / 2 more registers;
//                     the |X|^2 sums are add_half_power's expression, so on
//                     the grid the chirp-Z kernel runs (the wrapper gives it
//                     that grid) s1 is fused_psd_bluestein's output bit for
//                     bit;
//   the write-out     kChirpSk's |X|^4 sums by bin go to a second (LANES,
//                     row) plane after the first, in the exchange buffers'
//                     room (8 row <= 8.5 M bytes a lane, as M >= 2N - 1;
//                     the rings are past them), and block g writes its s2
//                     row to partial row gridDim.x + g; kChirpTapers' block
//                     (g, k) writes partial row k * gridDim.x + g, which
//                     est_sum_kernel<kEstTapers> sums and divides by K.
//
// psd_chirp_kernel itself is untouched, so that the chirp-Z kernel's SASS
// stays as sass_digest.json holds it. The launch bound is B's own
// (ChirpShape: three 256-thread blocks an SM, at most 85 registers), so the
// grid the wrapper takes from B's residency is one wave for these kernels
// too; SK-B's second array then spills a few more bytes than B
// (chip_smoke.py prints registers, spill and blocks an SM at each M).
//
// The streams forms (SK-B-S, MT-B-S, PFB-B-S: the --streams steps) run S
// streams of F frames, (S*F, 2N), with an (S,) count array read on the
// device: psd_chirp_est_streams_kernel is psd_chirp_est_kernel's body with
// the stream folded into the grid's x axis as psd_chirp_kernel folds it
// (block g serves stream g / G_s, that stream's frames, count and PFB
// history rows), a kernel of its own so that the single-stream forms keep
// their SASS; the second passes as fused_psd_mixed_est.cu's streams
// forms', so each stream's rows are the single-stream form's on the same
// groups and SK-B-S's s1 is rpf_fused_psd_chirp_streams's row, bit for
// bit.
//
// What bounds them on an H100: B's bound (the frames' 2 bytes a sample,
// and the FP32 work of two M-point transforms a frame, ~34 flop/byte at
// 998 bins: operations), times K transforms for MT-B (the frames read once
// a taper, through L2) and plus the P - 1 older rows and h for PFB-B (L1/L2
// traffic: the function's bytes are the frames once). First held back, as
// B is, by the exchanges through shared memory and their barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "device.cuh"
#include "fused_psd_chirp.cuh"
#include "fused_psd_est.cuh"
#include "pfb_history.cuh"
#include "psd_sum.cuh"

namespace {

enum : int { kChirpSk = 1, kChirpTapers = 2, kChirpPfb = 3 };

// The most dynamic shared memory a Hopper block may use.
constexpr int kChirpMaxSmem = 232448;

// add_half_power with a sum of |X|^4 beside each sum of |X|^2 (the same
// expression for the latter, so its bits are add_half_power's).
template <int R, int K = 0>
__device__ __forceinline__ void add_half_power_sk(float (&acc)[R / 2],
                                                  float (&acc2)[R / 2],
                                                  const float2 (&v)[R]) {
  if constexpr (K < R / 2) {
    constexpr int r = rev_bits(K, log2_of(R));
    const float pw = norm2(v[r]);
    acc[K] += pw;
    acc2[K] += pw * pw;
    add_half_power_sk<R, K + 1>(acc, acc2, v);
  }
}

// Block g (and taper blockIdx.y for kChirpTapers) sums its cut's function
// over frames [g*group, min((g+1)*group, F, n_valid)) into its partial
// rows. `window`: the (N,) window or null (kChirpSk), the (K, N) tapers
// (kChirpTapers) or the (P, N) prototype h (kChirpPfb); `history`: the
// PFB's (P - 1, 2N) rows (taps = P), else null.
template <int LOG2M, bool WINDOWED, int CUT>
__global__ void __launch_bounds__(ChirpShape<LOG2M>::THREADS,
                                  ChirpShape<LOG2M>::MIN_BLOCKS)
psd_chirp_est_kernel(const uint8_t* __restrict__ raw,      // (F, 2N)
                     const float2* __restrict__ twiddle,   // pass_twiddles(M)
                     const float* __restrict__ window,
                     const float2* __restrict__ chirp,     // (N,) a
                     const float2* __restrict__ spectrum,  // (M,) B / M
                     const uint8_t* __restrict__ history,
                     float* __restrict__ partial,
                     int bins, int row, int width, int F, int group,
                     int n_valid, int taps) {
  static_assert(CUT != kChirpTapers || WINDOWED, "a taper is a window");
  static_assert(CUT != kChirpPfb || !WINDOWED, "h is no window");
  using P = RegsPlan<LOG2M>;
  using C = ChirpShape<LOG2M>;
  constexpr int R = P::R, TF = P::TF, HALF = C::HALF;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(LOG2M, LAST);
  constexpr int BL = log2_of(RL);
  static_assert(P::PASSES >= 2, "the turn is the last pass's butterfly, "
                "and a ring slot is rewritten only after the barrier that "
                "ends pass 0");
  extern __shared__ float4 chirp_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  const int slot = ring_slot(bins);
  float2* x = reinterpret_cast<float2*>(chirp_smem) + lane * C::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(chirp_smem) +
                  C::LANES * C::XSTRIDE * 8 + lane * ring_bytes(bins);
  if constexpr (CUT == kChirpTapers) window += blockIdx.y * bins;

  // The window (the block's taper) at the thread's samples, held in
  // registers where a thread has registers to spare (below 1024 threads).
  constexpr bool HOLD = WINDOWED && C::THREADS < 1024;
  float win[HOLD ? HALF : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const int s = t + k * TF;
      win[k] = s < bins ? __ldg(window + s) : 0.0f;
    }
  }
  float acc[HALF];
  float acc2[CUT == kChirpSk ? HALF : 1];   // kChirpSk: the sums of |X|^4
#pragma unroll
  for (int k = 0; k < HALF; ++k) acc[k] = 0.0f;
  if constexpr (CUT == kChirpSk) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) acc2[k] = 0.0f;
  }

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int iters = (max(f1 - f0, 0) + C::LANES - 1) / C::LANES;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + C::LANES * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot,
                raw + static_cast<size_t>(f) * 2 * bins, 2 * bins, width, t,
                TF);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (pass 0 of frame i-1)
    const int f = f0 + lane + C::LANES * i;
    const bool active = f < f1;
    float2 v[R];
    if (active) {
      const uint16_t* iq =
          reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const int s = t + k * TF;
        float2 y = make_float2(0.0f, 0.0f);
        if (s < bins) {
          if constexpr (CUT == kChirpPfb) {
            y = cmulf(pfb_sample(iq, raw, history, window, f, taps, bins, s),
                      __ldg(chirp + s));
          } else {
            float w = 0.0f;
            if constexpr (HOLD) {
              w = win[k];
            } else if constexpr (WINDOWED) {
              w = __ldg(window + s);
            }
            y = cmulf(ring_sample<WINDOWED>(iq, s, w), __ldg(chirp + s));
          }
        }
        v[k] = y;
      }
      // Pass 0 from registers: butterfly t, outputs to t + k1 * TF.
      dif_stage_half_zero<R>(v);
      dif_regs<R, R / 4>(v, 0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k1 = rev_bits(r, log2_of(R));
        float2 y = v[r];
        if (k1 != 0) {
          const float2 w = __ldg(twiddle + k1 * TF + t);
          y = cmul(y, w.x, w.y);
        }
        x[pad_index(t + k1 * TF)] = y;
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      // The last forward pass leaves output rev_bits(r) of butterfly
      // b = t + i2*TF in v[i2*RL + r]: element b*RL + rev_bits(r).
      regs_pass<LOG2M, LAST>(v, x, twiddle, t);
#pragma unroll
      for (int i2 = 0; i2 < R / RL; ++i2) {
        const int base = (t + i2 * TF) * RL;
        float2 u[RL];
        turn_inputs<RL>(u, v, i2 * RL, spectrum + base);
        dif_regs<RL>(u, 0);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          x[pad_index(base + rev_bits(r, BL))] = u[r];
        }
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass_t<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass_t<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      regs_pass_t<LOG2M, 0>(v, x, twiddle, t);
      if constexpr (CUT == kChirpSk) {
        add_half_power_sk<R>(acc, acc2, v);
      } else {
        add_half_power<R>(acc, v);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin (kChirpSk: the |X|^4 sums in a second plane
  // after them), then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(chirp_smem);   // (LANES, row)
  float* by_bin2 = by_bin + C::LANES * row;               // kChirpSk's
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const int bin = t + k * TF;
    if (bin < bins) {
      by_bin[lane * row + bin] = acc[k];
      if constexpr (CUT == kChirpSk) by_bin2[lane * row + bin] = acc2[k];
    }
  }
  __syncthreads();
  const size_t prow = static_cast<size_t>(
      CUT == kChirpTapers ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x);
  float* out = partial + prow * row;
  float* out2 = partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * row;
  for (int q = tid; q < row; q += C::THREADS) {
    float sum = 0.0f;
    float sum2 = 0.0f;
    if (q < bins) {
      sum = by_bin[q];
#pragma unroll
      for (int l = 1; l < C::LANES; ++l) sum += by_bin[l * row + q];
      if constexpr (CUT == kChirpSk) {
        sum2 = by_bin2[q];
#pragma unroll
        for (int l = 1; l < C::LANES; ++l) sum2 += by_bin2[l * row + q];
      }
    }
    out[q] = sum;
    if constexpr (CUT == kChirpSk) out2[q] = sum2;
  }
}

// The streams forms: begin (each repeats psd_chirp_est_kernel's body line
// for line with the stream resolved from the block, so that the
// single-stream kernels above keep their SASS).

// psd_chirp_est_kernel over S streams of F frames, the stream folded into
// the grid's x axis as psd_chirp_kernel folds it: block g (taper
// blockIdx.y for kChirpTapers) serves stream s = g / G_s and sums its
// cut's function over that stream's frames [j*group, min((j+1)*group, F,
// counts[s])), j = g - s*G_s, into the partial rows the single-stream form
// writes at block g of a grid of S*G_s: kChirpSk s1 at row g and s2 at row
// S*G_s + g, kChirpTapers row y*S*G_s + g (= (y*S + s)*G_s + j, the order
// est_streams_kernel reads), kChirpPfb row g. `history`: the PFB's (S, P -
// 1, 2N) rows (taps = P), stream s's at s*(P - 1)*2N, else null.
template <int LOG2M, bool WINDOWED, int CUT>
__global__ void __launch_bounds__(ChirpShape<LOG2M>::THREADS,
                                  ChirpShape<LOG2M>::MIN_BLOCKS)
psd_chirp_est_streams_kernel(
    const uint8_t* __restrict__ raw,      // (S*F, 2N)
    const float2* __restrict__ twiddle,   // pass_twiddles(M)
    const float* __restrict__ window,
    const float2* __restrict__ chirp,     // (N,) a
    const float2* __restrict__ spectrum,  // (M,) B / M
    const uint8_t* __restrict__ history,  // (S, P-1, 2N) or null
    float* __restrict__ partial, int bins, int row, int width, int F,
    int group, int blocks_per_stream, const int* __restrict__ counts,
    int taps) {
  static_assert(CUT != kChirpTapers || WINDOWED, "a taper is a window");
  static_assert(CUT != kChirpPfb || !WINDOWED, "h is no window");
  using P = RegsPlan<LOG2M>;
  using C = ChirpShape<LOG2M>;
  constexpr int R = P::R, TF = P::TF, HALF = C::HALF;
  constexpr int LAST = P::PASSES - 1;
  constexpr int RL = pass_radix(LOG2M, LAST);
  constexpr int BL = log2_of(RL);
  static_assert(P::PASSES >= 2, "the turn is the last pass's butterfly, "
                "and a ring slot is rewritten only after the barrier that "
                "ends pass 0");
  extern __shared__ float4 chirp_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  const int slot = ring_slot(bins);
  float2* x = reinterpret_cast<float2*>(chirp_smem) + lane * C::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(chirp_smem) +
                  C::LANES * C::XSTRIDE * 8 + lane * ring_bytes(bins);
  if constexpr (CUT == kChirpTapers) window += blockIdx.y * bins;

  // The window (the block's taper) at the thread's samples, held in
  // registers where a thread has registers to spare (below 1024 threads).
  constexpr bool HOLD = WINDOWED && C::THREADS < 1024;
  float win[HOLD ? HALF : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const int s = t + k * TF;
      win[k] = s < bins ? __ldg(window + s) : 0.0f;
    }
  }
  float acc[HALF];
  float acc2[CUT == kChirpSk ? HALF : 1];   // kChirpSk: the sums of |X|^4
#pragma unroll
  for (int k = 0; k < HALF; ++k) acc[k] = 0.0f;
  if constexpr (CUT == kChirpSk) {
#pragma unroll
    for (int k = 0; k < HALF; ++k) acc2[k] = 0.0f;
  }

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = __ldg(counts + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + C::LANES - 1) / C::LANES;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * bins;
  const uint8_t* rows =
      CUT == kChirpPfb && taps > 1
          ? history + static_cast<size_t>(stream) * (taps - 1) * 2 * bins
          : nullptr;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + C::LANES * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot,
                frames + static_cast<size_t>(f) * 2 * bins, 2 * bins, width,
                t, TF);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (pass 0 of frame i-1)
    const int f = f0 + lane + C::LANES * i;
    const bool active = f < f1;
    float2 v[R];
    if (active) {
      const uint16_t* iq =
          reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const int s = t + k * TF;
        float2 y = make_float2(0.0f, 0.0f);
        if (s < bins) {
          if constexpr (CUT == kChirpPfb) {
            y = cmulf(pfb_sample(iq, frames, rows, window, f, taps, bins,
                                 s),
                      __ldg(chirp + s));
          } else {
            float w = 0.0f;
            if constexpr (HOLD) {
              w = win[k];
            } else if constexpr (WINDOWED) {
              w = __ldg(window + s);
            }
            y = cmulf(ring_sample<WINDOWED>(iq, s, w), __ldg(chirp + s));
          }
        }
        v[k] = y;
      }
      // Pass 0 from registers: butterfly t, outputs to t + k1 * TF.
      dif_stage_half_zero<R>(v);
      dif_regs<R, R / 4>(v, 0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k1 = rev_bits(r, log2_of(R));
        float2 y = v[r];
        if (k1 != 0) {
          const float2 w = __ldg(twiddle + k1 * TF + t);
          y = cmul(y, w.x, w.y);
        }
        x[pad_index(t + k1 * TF)] = y;
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      // The last forward pass leaves output rev_bits(r) of butterfly
      // b = t + i2*TF in v[i2*RL + r]: element b*RL + rev_bits(r).
      regs_pass<LOG2M, LAST>(v, x, twiddle, t);
#pragma unroll
      for (int i2 = 0; i2 < R / RL; ++i2) {
        const int base = (t + i2 * TF) * RL;
        float2 u[RL];
        turn_inputs<RL>(u, v, i2 * RL, spectrum + base);
        dif_regs<RL>(u, 0);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          x[pad_index(base + rev_bits(r, BL))] = u[r];
        }
      }
    }
    __syncthreads();
    if constexpr (P::PASSES > 3) {
      if (active) regs_pass_t<LOG2M, 2>(v, x, twiddle, t);
      __syncthreads();
    }
    if constexpr (P::PASSES > 2) {
      if (active) regs_pass_t<LOG2M, 1>(v, x, twiddle, t);
      __syncthreads();
    }
    if (active) {
      regs_pass_t<LOG2M, 0>(v, x, twiddle, t);
      if constexpr (CUT == kChirpSk) {
        add_half_power_sk<R>(acc, acc2, v);
      } else {
        add_half_power<R>(acc, v);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin (kChirpSk: the |X|^4 sums in a second plane
  // after them), then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(chirp_smem);   // (LANES, row)
  float* by_bin2 = by_bin + C::LANES * row;               // kChirpSk's
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const int bin = t + k * TF;
    if (bin < bins) {
      by_bin[lane * row + bin] = acc[k];
      if constexpr (CUT == kChirpSk) by_bin2[lane * row + bin] = acc2[k];
    }
  }
  __syncthreads();
  const size_t prow = static_cast<size_t>(
      CUT == kChirpTapers ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x);
  float* out = partial + prow * row;
  float* out2 = partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * row;
  for (int q = tid; q < row; q += C::THREADS) {
    float sum = 0.0f;
    float sum2 = 0.0f;
    if (q < bins) {
      sum = by_bin[q];
#pragma unroll
      for (int l = 1; l < C::LANES; ++l) sum += by_bin[l * row + q];
      if constexpr (CUT == kChirpSk) {
        sum2 = by_bin2[q];
#pragma unroll
        for (int l = 1; l < C::LANES; ++l) sum2 += by_bin2[l * row + q];
      }
    }
    out[q] = sum;
    if constexpr (CUT == kChirpSk) out2[q] = sum2;
  }
}

// The streams forms: end.

using EstKernel = void (*)(const uint8_t*, const float2*, const float*,
                           const float2*, const float2*, const uint8_t*,
                           float*, int, int, int, int, int, int, int);
using StreamsKernel = void (*)(const uint8_t*, const float2*, const float*,
                               const float2*, const float2*, const uint8_t*,
                               float*, int, int, int, int, int, int,
                               const int*, int);

// A cut's single-stream form, or its streams form (STREAMS), with its
// block's threads and shared bytes at N = bins.
template <bool STREAMS>
struct FormInfo {
  std::conditional_t<STREAMS, StreamsKernel, EstKernel> kernel;
  int threads;
  int (*smem)(int bins);
};
using EstInfo = FormInfo<false>;
using StreamsInfo = FormInfo<true>;

template <bool STREAMS, int LOG2M, bool WINDOWED, int CUT>
FormInfo<STREAMS> est_info() {
  if constexpr (STREAMS) {
    return {psd_chirp_est_streams_kernel<LOG2M, WINDOWED, CUT>,
            ChirpShape<LOG2M>::THREADS, chirp_smem_bytes<LOG2M>};
  } else {
    return {psd_chirp_est_kernel<LOG2M, WINDOWED, CUT>,
            ChirpShape<LOG2M>::THREADS, chirp_smem_bytes<LOG2M>};
  }
}

template <bool STREAMS, bool WINDOWED, int CUT>
FormInfo<STREAMS> est_of(int log2m) {
  switch (log2m) {
    case 6: return est_info<STREAMS, 6, WINDOWED, CUT>();
    case 7: return est_info<STREAMS, 7, WINDOWED, CUT>();
    case 8: return est_info<STREAMS, 8, WINDOWED, CUT>();
    case 9: return est_info<STREAMS, 9, WINDOWED, CUT>();
    case 10: return est_info<STREAMS, 10, WINDOWED, CUT>();
    case 11: return est_info<STREAMS, 11, WINDOWED, CUT>();
    case 12: return est_info<STREAMS, 12, WINDOWED, CUT>();
    case 13: return est_info<STREAMS, 13, WINDOWED, CUT>();
    default: return est_info<STREAMS, 14, WINDOWED, CUT>();
  }
}

// The kernel of `cut` (SK windowed or not, the tapers windowed, the PFB
// not; its streams form where STREAMS) at M = 2^log2m, N = bins; a null
// kernel where there is none.
template <bool STREAMS>
FormInfo<STREAMS> est_pick(int cut, bool windowed, int log2m, int bins) {
  if (!chirp_size_ok(log2m, bins)) return {nullptr, 0, nullptr};
  if (cut == kChirpSk) {
    return windowed ? est_of<STREAMS, true, kChirpSk>(log2m)
                    : est_of<STREAMS, false, kChirpSk>(log2m);
  }
  if (cut == kChirpTapers && windowed) {
    return est_of<STREAMS, true, kChirpTapers>(log2m);
  }
  if (cut == kChirpPfb && !windowed) {
    return est_of<STREAMS, false, kChirpPfb>(log2m);
  }
  return {nullptr, 0, nullptr};
}

std::atomic<unsigned long long>
    est_done[2][3][2][kRegsMaxLog2N - kRegsMinLog2N + 1];

// The kernel of `cut` with its shared bytes on `device`, opted into all of
// kChirpMaxSmem where they are above the 48 KB default (once per device: a
// later N of the same M may take more than this one).
template <bool STREAMS>
cudaError_t est_prepare(int cut, bool windowed, int log2m, int bins,
                        int device, FormInfo<STREAMS>* info, int* smem) {
  *info = est_pick<STREAMS>(cut, windowed, log2m, bins);
  if (info->kernel == nullptr) return cudaErrorInvalidValue;
  *smem = info->smem(bins);
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = opt_in_smem(
        info->kernel, *smem <= 48 * 1024 ? *smem : kChirpMaxSmem, device,
        est_done[STREAMS][cut - 1][windowed][log2m - kRegsMinLog2N]);
  }
  return e;
}

// The first pass of a cut on a grid of ceil(F / group) x `rows_y` blocks.
cudaError_t launch_est(int cut, const void* raw, const void* twiddle,
                       const void* window, const void* chirp,
                       const void* spectrum, const void* history,
                       void* partial, int device, int log2m, int bins, int F,
                       int group, int n_valid, int taps, int rows_y,
                       int width, cudaStream_t st) {
  const bool windowed = cut == kChirpTapers || (cut == kChirpSk && window);
  if (!width_ok(raw, bins, width) || twiddle == nullptr ||
      chirp == nullptr || spectrum == nullptr || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F || (cut != kChirpSk && window == nullptr)) {
    return cudaErrorInvalidValue;
  }
  EstInfo info;
  int smem = 0;
  const cudaError_t e =
      est_prepare(cut, windowed, log2m, bins, device, &info, &smem);
  if (e != cudaSuccess) return e;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  info.kernel<<<dim3((F + group - 1) / group, rows_y), info.threads, smem,
                st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float*>(window), static_cast<const float2*>(chirp),
      static_cast<const float2*>(spectrum),
      static_cast<const uint8_t*>(history), static_cast<float*>(partial),
      bins, row, width, F, group, n_valid, taps);
  return cudaGetLastError();
}

// The first pass of a cut's streams form on a grid of S * G_s x `rows_y`
// blocks, G_s = F / group.
cudaError_t launch_est_streams_first(int cut, const void* raw,
                                     const void* twiddle, const void* window,
                                     const void* chirp, const void* spectrum,
                                     const void* history, const void* counts,
                                     void* partial, int device, int log2m,
                                     int bins, int S, int F, int group,
                                     int taps, int rows_y, int width,
                                     cudaStream_t st) {
  const bool windowed = cut == kChirpTapers || (cut == kChirpSk && window);
  if (!width_ok(raw, bins, width) || twiddle == nullptr ||
      chirp == nullptr || spectrum == nullptr ||
      !streams_args_ok(S, F, group, counts) ||
      (cut != kChirpSk && window == nullptr)) {
    return cudaErrorInvalidValue;
  }
  StreamsInfo info;
  int smem = 0;
  const cudaError_t e =
      est_prepare(cut, windowed, log2m, bins, device, &info, &smem);
  if (e != cudaSuccess) return e;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  const int G_s = F / group;
  info.kernel<<<dim3(S * G_s, rows_y), info.threads, smem, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float*>(window), static_cast<const float2*>(chirp),
      static_cast<const float2*>(spectrum),
      static_cast<const uint8_t*>(history), static_cast<float*>(partial),
      bins, row, width, F, group, G_s, static_cast<const int*>(counts),
      taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// SK-B: launches both passes on `stream`. raw: (F, 2N) u8, `width`-byte
// aligned (the ring's copy width, as rpf_fused_psd_chirp); twiddle:
// pass_twiddles(M); window: (N,) f32, or null; chirp: (N,) complex64 a;
// spectrum: (M,) complex64 B / M in the element order of M's register plan;
// partial: (2 * ceil(F / group), row) f32 scratch; out: (2, row) f32 (s1,
// s2), or with two_sigma > 0 (4, row) (s1, s2, s1 * keep, n_valid * keep);
// row = N rounded up to 32; M = 2^log2m as rpf_fused_psd_chirp takes it.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk_chirp(const void* raw, const void* twiddle,
                           const void* window, const void* chirp,
                           const void* spectrum, void* partial, void* out,
                           int device, int log2m, int bins, int F, int group,
                           int n_valid, float two_sigma, int width,
                           void* stream) {
  if (!(two_sigma >= 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_est(kChirpSk, raw, twiddle, window, chirp, spectrum,
                             nullptr, partial, device, log2m, bins, F, group,
                             n_valid, 1, 1, width, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  const float* part = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  if (two_sigma > 0.0f) {
    est_sum_kernel<kEstSkGate><<<row / kSumBins, kSumBins * kSumLanes, 0,
                                 st>>>(part, blocks, row, n_valid, two_sigma,
                                       o);
  } else {
    est_sum_kernel<kEstSk><<<row / kSumBins, kSumBins * kSumLanes, 0, st>>>(
        part, blocks, row, n_valid, two_sigma, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// MT-B: tapers: (K, N) f32, 1 <= K <= 32; partial: (K * ceil(F / group),
// row) f32 scratch; out: (row,) f32. Other arguments as
// rpf_fused_psd_sk_chirp.
int rpf_fused_psd_tapers_chirp(const void* raw, const void* twiddle,
                               const void* tapers, const void* chirp,
                               const void* spectrum, void* partial, void* out,
                               int device, int log2m, int bins, int F,
                               int group, int K, int n_valid, int width,
                               void* stream) {
  if (K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_est(kChirpTapers, raw, twiddle, tapers, chirp,
                             spectrum, nullptr, partial, device, log2m, bins,
                             F, group, n_valid, 1, K, width, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  est_sum_kernel<kEstTapers><<<row / kSumBins, kSumBins * kSumLanes, 0,
                               st>>>(static_cast<const float*>(partial),
                                     K * blocks, row, K, 0.0f,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// PFB-B: history, history_out: (P - 1, 2N) u8, distinct (null when P = 1);
// h: (P, N) f32, 1 <= P <= 32; partial: (ceil(F / group), row) f32
// scratch; out: (row,) f32; fresh: set the history to byte 127 first.
// After the sum, the next history (rows n_valid .. n_valid + P - 2 of the
// virtual array) is copied into history_out on the stream. Other
// arguments as rpf_fused_psd_sk_chirp.
int rpf_fused_psd_pfb_chirp(const void* raw, const void* history,
                            const void* twiddle, const void* h,
                            const void* chirp, const void* spectrum,
                            void* partial, void* out, void* history_out,
                            int device, int log2m, int bins, int F, int group,
                            int n_valid, int P, int fresh, int width,
                            void* stream) {
  if (P < 1 || P > 32 || !chirp_size_ok(log2m, bins) ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out)) ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t row_bytes = static_cast<size_t>(2) * bins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127, (P - 1) * row_bytes,
                        st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_est(kChirpPfb, raw, twiddle, h, chirp, spectrum, history,
                 partial, device, log2m, bins, F, group, n_valid, P, 1, width,
                 st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  e = launch_psd_sum(partial, (F + group - 1) / group, row, out, st);
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  // The next history: rows n_valid .. n_valid + P - 2 of the virtual array,
  // `kept` of them from the old history and the rest from the frames.
  const int kept = n_valid < P - 1 ? P - 1 - n_valid : 0;
  const int taken = P - 1 - kept;
  uint8_t* dst = static_cast<uint8_t*>(history_out);
  if (kept > 0) {
    e = cudaMemcpyAsync(dst,
                        static_cast<const uint8_t*>(history) +
                            static_cast<size_t>(n_valid) * row_bytes,
                        kept * row_bytes, cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (taken > 0) {
    e = cudaMemcpyAsync(dst + kept * row_bytes,
                        static_cast<const uint8_t*>(raw) +
                            static_cast<size_t>(n_valid - taken) * row_bytes,
                        taken * row_bytes, cudaMemcpyDeviceToDevice, st);
  }
  return static_cast<int>(e);
}

// SK-B-S: S streams of F frames. raw: (S*F, 2N) u8, stream s in rows
// [s*F, (s+1)*F), `width`-byte aligned; n_valid: (S,) int32 on the
// device, read by the kernels when they run (a count outside [0, F] acts
// as its nearest bound); group must divide F (G_s = F / group blocks a
// stream); partial: (2 * S * G_s, row) f32 scratch; out: (S, 2, row) f32
// (s1, s2 of each stream), or with two_sigma > 0 (S, 4, row), each stream
// gated on its own moments and count. Other arguments as
// rpf_fused_psd_sk_chirp.
int rpf_fused_psd_sk_chirp_streams(const void* raw, const void* twiddle,
                                   const void* window, const void* chirp,
                                   const void* spectrum, const void* n_valid,
                                   void* partial, void* out, int device,
                                   int log2m, int bins, int S, int F,
                                   int group, float two_sigma, int width,
                                   void* stream) {
  if (!(two_sigma >= 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_est_streams_first(
      kChirpSk, raw, twiddle, window, chirp, spectrum, nullptr, n_valid,
      partial, device, log2m, bins, S, F, group, 1, 1, width, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G_s = F / group;
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  e = two_sigma > 0.0f
          ? launch_est_streams<kEstSkGate>(partial, S, G_s, 1, row, n_valid,
                                           F, 0, two_sigma, out, st)
          : launch_est_streams<kEstSk>(partial, S, G_s, 1, row, n_valid, F,
                                       0, two_sigma, out, st);
  return static_cast<int>(e);
}

// MT-B-S: tapers: (K, N) f32, 1 <= K <= 32, shared by the streams;
// partial: (K * S * G_s, row) f32 scratch; out: (S, row) f32. Other
// arguments as rpf_fused_psd_sk_chirp_streams.
int rpf_fused_psd_tapers_chirp_streams(const void* raw, const void* twiddle,
                                       const void* tapers, const void* chirp,
                                       const void* spectrum,
                                       const void* n_valid, void* partial,
                                       void* out, int device, int log2m,
                                       int bins, int S, int F, int group,
                                       int K, int width, void* stream) {
  if (K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_est_streams_first(
      kChirpTapers, raw, twiddle, tapers, chirp, spectrum, nullptr, n_valid,
      partial, device, log2m, bins, S, F, group, 1, K, width, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  return static_cast<int>(launch_est_streams<kEstTapers>(
      partial, S, F / group, K, row, n_valid, F, K, 0.0f, out, st));
}

// PFB-B-S: history, history_out: (S, P - 1, 2N) u8, distinct, 4-byte
// aligned (null when P = 1), stream s's rows together; h: (P, N) f32, 1
// <= P <= 32; partial: (S * G_s, row) f32 scratch; out: (S, row) f32;
// fresh: set every stream's history to byte 127 first. After the sum,
// each stream's next history (rows n_valid[s] .. n_valid[s] + P - 2 of its
// virtual array) is written to history_out on the stream
// (pfb_history.cuh). Other arguments as rpf_fused_psd_sk_chirp_streams.
int rpf_fused_psd_pfb_chirp_streams(const void* raw, const void* history,
                                    const void* twiddle, const void* h,
                                    const void* chirp, const void* spectrum,
                                    const void* n_valid, void* partial,
                                    void* out, void* history_out, int device,
                                    int log2m, int bins, int S, int F,
                                    int group, int P, int fresh, int width,
                                    void* stream) {
  if (P < 1 || P > 32 || S > kMaxGridY || !chirp_size_ok(log2m, bins) ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out)) ||
      !streams_args_ok(S, F, group, n_valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_bytes = 2 * bins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * row_bytes, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_est_streams_first(kChirpPfb, raw, twiddle, h, chirp, spectrum,
                               history, n_valid, partial, device, log2m,
                               bins, S, F, group, P, 1, width, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row = (bins + kSumBins - 1) / kSumBins * kSumBins;
  e = launch_psd_sum(partial, F / group, row, out, st, S);
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             n_valid, S, F, P, row_bytes,
                                             st));
}

// What the first pass of `cut` (1 SK, 2 the tapers, 3 the PFB), windowed
// or not, gets at M = 2^log2m, N = bins on `device`: attrs[0..5] as
// rpf_fused_psd_chirp_attributes. Launches nothing.
int rpf_fused_psd_chirp_est_attributes(int log2m, int bins, int cut,
                                       int windowed, int device,
                                       int* attrs) {
  if (attrs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  EstInfo info;
  int smem = 0;
  cudaError_t e =
      est_prepare(cut, windowed != 0, log2m, bins, device, &info, &smem);
  if (e == cudaSuccess) {
    e = kernel_attributes(info.kernel, info.threads, smem, attrs);
  }
  return static_cast<int>(e);
}

// What the streams form of `cut` gets, as
// rpf_fused_psd_chirp_est_attributes. Launches nothing.
int rpf_fused_psd_chirp_est_streams_attributes(int log2m, int bins, int cut,
                                               int windowed, int device,
                                               int* attrs) {
  if (attrs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  StreamsInfo info;
  int smem = 0;
  cudaError_t e =
      est_prepare(cut, windowed != 0, log2m, bins, device, &info, &smem);
  if (e == cudaSuccess) {
    e = kernel_attributes(info.kernel, info.threads, smem, attrs);
  }
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
