// The CLI estimators' device steps at the awkward bin counts, for NVIDIA
// Hopper (sm_90a): spectral kurtosis (SK-M), the multitaper (MT-M) and the
// polyphase filterbank (PFB-M) at the even 7-smooth N up to 16384 that the
// power-of-two kernels do not take (500, 2400, 12000, 16000, and 2..32).
//
// They replace no Pallas kernel: the JAX package computes these estimators
// in XLA at every N (rtl_power_fftw_tpu/models/kurtosis.py:_sk_step 46-93,
// multitaper.py:_mt_core 60-133, pfb.py:_pfb_core 48-89). The port runs them
// at the powers of two on K1's group kernel (fused_psd_sk.cu,
// fused_psd_tapers.cu, fused_psd_pfb.cu); here they are forms of the
// mixed-radix ring kernel of fused_psd_mixed.cu (fused_psd_mixed_ring.cuh),
// the function of each the one those libraries compute:
//
//   SK-M    s1 = sum over valid frames of |X|^2 and s2 = sum of |X|^4, (2, N);
//           with two_sigma > 0 (--sk-excise) also the block's gate on its
//           own SK, s1 * keep and n_valid * keep (fused_psd_est.cuh);
//   MT-M    the sum over valid frames of the mean over K tapers of
//           |DFT(x * taper_k)|^2, (N,);
//   PFB-M   the sum over output frames j < n_valid of |DFT(S_j)|^2, S_j[n] =
//           sum over p = 0 .. P-1, in that order from zero, of h[p, n] *
//           x_{j+p}[n] (each product and sum rounded on its own) over one
//           virtual array of P - 1 history rows and the step's F rows; the
//           next history (rows n_valid .. n_valid + P - 2 of it) written to
//           history_out on the stream, as rpf_fused_psd_pfb does.
//
// psd_ring_est_kernel<WINDOWED, ACC, CUT> is psd_ring_kernel's body (the
// run-time pass plan of fft_mixed.cuh in lanes of whole warps, the next
// frame by cp.async into a ring slot, the last pass's sums in registers,
// the lanes' sums read out by element_of_bin) with the cut's differences:
//
//   kRingSk      beside each last-pass |X|^2 sum, a sum of |X|^4 in as many
//                more registers (kRegsSk's form); the |X|^2 sums are
//                psd_ring_kernel's expression, so on the grid
//                fused_psd_mixed runs (the wrapper gives it that grid) s1 is
//                its output bit for bit; block g writes its s2 row to
//                partial row gridDim.x + g;
//   kRingTapers  windowed by row blockIdx.y of a (K, N) taper table; block
//                (g, k) writes partial row k * gridDim.x + g (K1's
//                kRegsTapers form); est_sum_kernel sums the K G rows and
//                divides by K;
//   kRingPfb     pass 0's samples are the polyphase sums: the ring slot
//                holds frame j's own row (virtual row j + P - 1, tap P - 1),
//                the P - 1 rows before it are read through L1/L2 from the
//                history or the slot, and h through L1.
//
// psd_ring_kernel itself is untouched, so that the mixed-radix kernel's
// SASS stays as sass_digest.json holds it, and so is every function of the
// header that it and ML run; the cuts' own pieces (ring_first_by, SK's
// last pass) are here, the PFB sample (pfb_sample, which the chirp-Z
// kernel's PFB form shares) in frame_ring.cuh.
//
// The streams forms (SK-M-S, MT-M-S, PFB-M-S: the --streams steps) run S
// streams of F frames, (S*F, 2N), with an (S,) count array read on the
// device: psd_ring_est_streams_kernel is psd_ring_est_kernel's body with
// the stream folded into the grid's x axis as psd_ring_kernel folds it
// (block g serves stream g / G_s, that stream's frames, count and PFB
// history rows), a kernel of its own so that the single-stream forms keep
// their SASS. Each stream's partial rows lie where est_streams_kernel
// (fused_psd_est.cuh) reads them, so on the same groups a stream's rows
// are the single-stream form's, and SK-M-S's s1 is
// rpf_fused_psd_mixed_streams's row, bit for bit; SK gates each stream on
// its own moments and count. The PFB's next histories come from each
// stream's own valid rows (pfb_history.cuh).
//
// What bounds them on an H100: the mixed-radix kernel's bound (the frames'
// 2 bytes a sample and the FP32 transform about equally, ~19 flop/byte at
// 2400 bins), times K transforms for MT-M (the frames read once a taper,
// through L2) and plus the P - 1 older rows and h for PFB-M (L2 traffic: the
// function's bytes are the frames once). SK-M's second register array
// lifts the large class's spill (PERF.md); a shared-memory plane as K1's SK
// keeps would not fit beside the ring above ~14000 bins. First held back,
// as M is, by the shared-memory passes and their barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_mixed.cuh"   // kMixedMaxSmem, read by the ring's header
#include "fused_psd_mixed_ring.cuh"
#include "pfb_history.cuh"
#include "psd_sum.cuh"

namespace {

enum : int { kRingSk = 1, kRingTapers = 2, kRingPfb = 3 };

// Pass 0 of one frame on lane thread t, as ring_first, with its samples
// from sample(s) (a float2 of the frame's element s before the transform).
template <int R, class Sample>
__device__ __forceinline__ void ring_first_by(Sample&& sample,
                                              const float2* __restrict__ tw,
                                              float2* xs, int n, bool copy,
                                              int rounds, int t, int tf) {
  if (copy) {
    for (int s = t; s < n; s += tf) xs[s] = sample(s);
    return;
  }
  const int S = n / R;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < S) {
      float2 v[R];
#pragma unroll
      for (int n1 = 0; n1 < R; ++n1) v[n1] = sample(b + n1 * S);
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        xs[b + k1 * S] =
            k1 == 0 ? v[0] : cmulf(v[k1], __ldg(tw + k1 * S + b));
      }
    }
  }
}

// ring_last with a sum of |X|^4 beside each sum of |X|^2 (the same
// expression for the latter, so its bits are ring_last's).
template <int R, int ACC>
__device__ __forceinline__ void ring_last_sk(const float2* xs,
                                             float (&acc)[ACC],
                                             float (&acc2)[ACC], int n,
                                             int t, int tf) {
  const int nb = n / R;
#pragma unroll
  for (int i = 0; i < ACC / R; ++i) {
    const int b = t + i * tf;
    if (b < nb) {
      float2 v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = xs[b * R + k];
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        const float pw = norm2(v[k1]);
        acc[i * R + k1] += pw;
        acc2[i * R + k1] += pw * pw;
      }
    }
  }
}

// Block g (and taper blockIdx.y for kRingTapers) sums its cut's function
// over frames [g*group, min((g+1)*group, F, n_valid)) into its partial
// rows. `window`: the (N,) window (kRingSk), the (K, N) tapers
// (kRingTapers) or the (P, N) prototype h (kRingPfb); `history`: the PFB's
// (P - 1, 2N) rows (taps = P), else null.
template <bool WINDOWED, int ACC, int CUT>
__global__ void __launch_bounds__(kRingMaxThreads, 1)
psd_ring_est_kernel(const uint8_t* __restrict__ raw,     // (F, 2N)
                    const float2* __restrict__ twiddle,  // plan_twiddles
                    const int* __restrict__ order,       // element of bin
                    const float* __restrict__ window,
                    const uint8_t* __restrict__ history,
                    float* __restrict__ partial,
                    const RingPlan p, int width, int F, int group,
                    int n_valid, int taps) {
  static_assert(CUT != kRingTapers || WINDOWED, "a taper is a window");
  static_assert(CUT != kRingPfb || !WINDOWED, "h is no window");
  extern __shared__ float4 ring_smem[];
  __shared__ int4 tab[kMixedMaxPasses];   // radix, stride, magic, twoff
  __shared__ int tab_rounds[kMixedMaxPasses];
  const int n = p.n, tf = p.tf, P = p.passes;
  const int threads = tf * p.lanes;
  const int tid = threadIdx.x;
  const int lane = tid / tf;
  const int t = tid - lane * tf;
#pragma unroll
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    if (tid == j) {
      tab[j] = make_int4(p.radix[j], p.stride[j], p.magic[j], p.twoff[j]);
      tab_rounds[j] = p.rounds[j];
    }
  }
  uint8_t* smem = reinterpret_cast<uint8_t*>(ring_smem);
  float2* xs = reinterpret_cast<float2*>(smem) + lane * n;
  uint8_t* ring = smem + round16(p.lanes * n * 8) + lane * ring_bytes(n);
  const int slot = ring_slot(n);
  if constexpr (CUT == kRingTapers) window += blockIdx.y * n;

  float acc[ACC];
  float acc2[CUT == kRingSk ? ACC : 1];   // kRingSk: the sums of |X|^4
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.0f;
  if constexpr (CUT == kRingSk) {
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc2[k] = 0.0f;
  }

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int iters = (max(f1 - f0, 0) + p.lanes - 1) / p.lanes;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + p.lanes * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot, raw + static_cast<size_t>(f) * 2 * n,
                2 * n, width, t, tf);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; xs is free (last pass of frame i-1)
    const int f = f0 + lane + p.lanes * i;
    const bool active = f < f1;
    const uint16_t* iq =
        reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
    if (active) {
      with_radix(p.radix[0], [&](auto rc) {
        constexpr int R = decltype(rc)::value;
        if constexpr (CUT == kRingPfb) {
          ring_first_by<R>(
              [&](int s) {
                return pfb_sample(iq, raw, history, window, f, taps, n, s);
              },
              twiddle, xs, n, P == 1, p.rounds[0], t, tf);
        } else {
          ring_first_by<R>(
              [&](int s) {
                return ring_sample<WINDOWED>(
                    iq, s, WINDOWED ? __ldg(window + s) : 0.0f);
              },
              twiddle, xs, n, P == 1, p.rounds[0], t, tf);
        }
      });
    }
    for (int j = 1; j < P - 1; ++j) {
      __syncthreads();
      if (active) {
        const int4 e = tab[j];
        const int rounds = tab_rounds[j];
        with_radix(e.x, [&](auto rc) {
          ring_mid<decltype(rc)::value>(xs, twiddle + e.w, e.y,
                                        static_cast<unsigned>(e.z), n,
                                        rounds, t, tf);
        });
      }
    }
    __syncthreads();
    if (active) {
      with_radix(tab[P - 1].x, [&](auto rc) {
        if constexpr (CUT == kRingSk) {
          ring_last_sk<decltype(rc)::value, ACC>(xs, acc, acc2, n, t, tf);
        } else {
          ring_last<decltype(rc)::value, ACC>(xs, acc, n, t, tf);
        }
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums at their elements (kRingSk: the |X|^4 sums after
  // them, in the exchange buffers' room), then each bin's element added
  // lane by lane in order.
  float* by_elem = reinterpret_cast<float*>(smem);   // (lanes, n)
  float* by_elem2 = by_elem + p.lanes * n;           // kRingSk's
  with_radix(tab[P - 1].x, [&](auto rc) {
    ring_gather<decltype(rc)::value, ACC>(by_elem + lane * n, acc, n, t, tf);
    if constexpr (CUT == kRingSk) {
      ring_gather<decltype(rc)::value, ACC>(by_elem2 + lane * n, acc2, n, t,
                                            tf);
    }
  });
  __syncthreads();
  const size_t row = static_cast<size_t>(
      CUT == kRingTapers ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x);
  float* out = partial + row * p.row;
  float* out2 = partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * p.row;
  for (int k = tid; k < p.row; k += threads) {
    float sum = 0.0f;
    float sum2 = 0.0f;
    if (k < n) {
      const int q = __ldg(order + k);
      sum = by_elem[q];
      for (int l = 1; l < p.lanes; ++l) sum += by_elem[l * n + q];
      if constexpr (CUT == kRingSk) {
        sum2 = by_elem2[q];
        for (int l = 1; l < p.lanes; ++l) sum2 += by_elem2[l * n + q];
      }
    }
    out[k] = sum;
    if constexpr (CUT == kRingSk) out2[k] = sum2;
  }
}

// The streams forms: begin (each repeats psd_ring_est_kernel's body line
// for line with the stream resolved from the block, so that the
// single-stream kernels above keep their SASS).

// psd_ring_est_kernel over S streams of F frames, the stream folded into
// the grid's x axis as psd_ring_kernel folds it: block g (taper
// blockIdx.y for kRingTapers) serves stream s = g / G_s and sums its cut's
// function over that stream's frames [j*group, min((j+1)*group, F,
// counts[s])), j = g - s*G_s, into the partial rows the single-stream
// form writes at block g of a grid of S*G_s: kRingSk s1 at row g and s2 at
// row S*G_s + g, kRingTapers row y*S*G_s + g (= (y*S + s)*G_s + j, the
// order est_streams_kernel reads), kRingPfb row g. `history`: the PFB's
// (S, P - 1, 2N) rows (taps = P), stream s's at s*(P - 1)*2N, else null.
template <bool WINDOWED, int ACC, int CUT>
__global__ void __launch_bounds__(kRingMaxThreads, 1)
psd_ring_est_streams_kernel(const uint8_t* __restrict__ raw,     // (S*F, 2N)
                            const float2* __restrict__ twiddle,
                            const int* __restrict__ order,
                            const float* __restrict__ window,
                            const uint8_t* __restrict__ history,
                            float* __restrict__ partial,
                            const RingPlan p, int width, int F, int group,
                            int blocks_per_stream,
                            const int* __restrict__ counts, int taps) {
  static_assert(CUT != kRingTapers || WINDOWED, "a taper is a window");
  static_assert(CUT != kRingPfb || !WINDOWED, "h is no window");
  extern __shared__ float4 ring_smem[];
  __shared__ int4 tab[kMixedMaxPasses];   // radix, stride, magic, twoff
  __shared__ int tab_rounds[kMixedMaxPasses];
  const int n = p.n, tf = p.tf, P = p.passes;
  const int threads = tf * p.lanes;
  const int tid = threadIdx.x;
  const int lane = tid / tf;
  const int t = tid - lane * tf;
#pragma unroll
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    if (tid == j) {
      tab[j] = make_int4(p.radix[j], p.stride[j], p.magic[j], p.twoff[j]);
      tab_rounds[j] = p.rounds[j];
    }
  }
  uint8_t* smem = reinterpret_cast<uint8_t*>(ring_smem);
  float2* xs = reinterpret_cast<float2*>(smem) + lane * n;
  uint8_t* ring = smem + round16(p.lanes * n * 8) + lane * ring_bytes(n);
  const int slot = ring_slot(n);
  if constexpr (CUT == kRingTapers) window += blockIdx.y * n;

  float acc[ACC];
  float acc2[CUT == kRingSk ? ACC : 1];   // kRingSk: the sums of |X|^4
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.0f;
  if constexpr (CUT == kRingSk) {
#pragma unroll
    for (int k = 0; k < ACC; ++k) acc2[k] = 0.0f;
  }

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = __ldg(counts + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + p.lanes - 1) / p.lanes;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * n;
  const uint8_t* rows =
      CUT == kRingPfb && taps > 1
          ? history + static_cast<size_t>(stream) * (taps - 1) * 2 * n
          : nullptr;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + p.lanes * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot,
                frames + static_cast<size_t>(f) * 2 * n, 2 * n, width, t,
                tf);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; xs is free (last pass of frame i-1)
    const int f = f0 + lane + p.lanes * i;
    const bool active = f < f1;
    const uint16_t* iq =
        reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
    if (active) {
      with_radix(p.radix[0], [&](auto rc) {
        constexpr int R = decltype(rc)::value;
        if constexpr (CUT == kRingPfb) {
          ring_first_by<R>(
              [&](int s) {
                return pfb_sample(iq, frames, rows, window, f, taps, n, s);
              },
              twiddle, xs, n, P == 1, p.rounds[0], t, tf);
        } else {
          ring_first_by<R>(
              [&](int s) {
                return ring_sample<WINDOWED>(
                    iq, s, WINDOWED ? __ldg(window + s) : 0.0f);
              },
              twiddle, xs, n, P == 1, p.rounds[0], t, tf);
        }
      });
    }
    for (int j = 1; j < P - 1; ++j) {
      __syncthreads();
      if (active) {
        const int4 e = tab[j];
        const int rounds = tab_rounds[j];
        with_radix(e.x, [&](auto rc) {
          ring_mid<decltype(rc)::value>(xs, twiddle + e.w, e.y,
                                        static_cast<unsigned>(e.z), n,
                                        rounds, t, tf);
        });
      }
    }
    __syncthreads();
    if (active) {
      with_radix(tab[P - 1].x, [&](auto rc) {
        if constexpr (CUT == kRingSk) {
          ring_last_sk<decltype(rc)::value, ACC>(xs, acc, acc2, n, t, tf);
        } else {
          ring_last<decltype(rc)::value, ACC>(xs, acc, n, t, tf);
        }
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums at their elements (kRingSk: the |X|^4 sums after
  // them, in the exchange buffers' room), then each bin's element added
  // lane by lane in order.
  float* by_elem = reinterpret_cast<float*>(smem);   // (lanes, n)
  float* by_elem2 = by_elem + p.lanes * n;           // kRingSk's
  with_radix(tab[P - 1].x, [&](auto rc) {
    ring_gather<decltype(rc)::value, ACC>(by_elem + lane * n, acc, n, t, tf);
    if constexpr (CUT == kRingSk) {
      ring_gather<decltype(rc)::value, ACC>(by_elem2 + lane * n, acc2, n, t,
                                            tf);
    }
  });
  __syncthreads();
  const size_t row = static_cast<size_t>(
      CUT == kRingTapers ? blockIdx.y * gridDim.x + blockIdx.x : blockIdx.x);
  float* out = partial + row * p.row;
  float* out2 = partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * p.row;
  for (int k = tid; k < p.row; k += threads) {
    float sum = 0.0f;
    float sum2 = 0.0f;
    if (k < n) {
      const int q = __ldg(order + k);
      sum = by_elem[q];
      for (int l = 1; l < p.lanes; ++l) sum += by_elem[l * n + q];
      if constexpr (CUT == kRingSk) {
        sum2 = by_elem2[q];
        for (int l = 1; l < p.lanes; ++l) sum2 += by_elem2[l * n + q];
      }
    }
    out[k] = sum;
    if constexpr (CUT == kRingSk) out2[k] = sum2;
  }
}

// The streams forms: end.

using EstKernel = void (*)(const uint8_t*, const float2*, const int*,
                           const float*, const uint8_t*, float*,
                           const RingPlan, int, int, int, int, int);
using StreamsKernel = void (*)(const uint8_t*, const float2*, const int*,
                               const float*, const uint8_t*, float*,
                               const RingPlan, int, int, int, int,
                               const int*, int);

// A cut's single-stream form, or its streams form (STREAMS).
template <bool STREAMS>
using FormKernel = std::conditional_t<STREAMS, StreamsKernel, EstKernel>;

template <bool STREAMS, bool WINDOWED, int ACC, int CUT>
FormKernel<STREAMS> form() {
  if constexpr (STREAMS) {
    return psd_ring_est_streams_kernel<WINDOWED, ACC, CUT>;
  } else {
    return psd_ring_est_kernel<WINDOWED, ACC, CUT>;
  }
}

// The instantiations, [cut - 1][windowed][class]: the classes are
// psd_ring_kernel's (kRingAccSmall, kRingAccLarge last-pass sums a
// thread); null where the cut has no such form.
template <bool STREAMS>
FormKernel<STREAMS> est_kernel(int cut, bool windowed, int index) {
  static const FormKernel<STREAMS> kernels[3][2][2] = {
      {{form<STREAMS, false, kRingAccSmall, kRingSk>(),
        form<STREAMS, false, kRingAccLarge, kRingSk>()},
       {form<STREAMS, true, kRingAccSmall, kRingSk>(),
        form<STREAMS, true, kRingAccLarge, kRingSk>()}},
      {{nullptr, nullptr},
       {form<STREAMS, true, kRingAccSmall, kRingTapers>(),
        form<STREAMS, true, kRingAccLarge, kRingTapers>()}},
      {{form<STREAMS, false, kRingAccSmall, kRingPfb>(),
        form<STREAMS, false, kRingAccLarge, kRingPfb>()},
       {nullptr, nullptr}}};
  if (cut < kRingSk || cut > kRingPfb || index < 0 || index > 1) {
    return nullptr;
  }
  return kernels[cut - 1][windowed][index];
}

std::atomic<unsigned long long> est_done[2][3][2][2];

// The plan, the kernel of the cut (its streams form where STREAMS) for it
// and its shared bytes; null where the plan is not one or the cut has no
// such form.
template <bool STREAMS>
FormKernel<STREAMS> est_pick(const int* plan, int cut, bool windowed,
                             RingPlan* p, int* smem,
                             std::atomic<unsigned long long>** done) {
  if (read_ring_plan(plan, p) != cudaSuccess) return nullptr;
  const int index = ring_pick(*p, smem);
  const FormKernel<STREAMS> kernel =
      est_kernel<STREAMS>(cut, windowed, index);
  if (kernel != nullptr) {
    *done = &est_done[STREAMS][cut - 1][windowed][index];
  }
  return kernel;
}

// Opts `kernel` into all of kRingMaxSmem where a launch of `smem` bytes is
// above the 48 KB default (once per device: a later plan of the same
// kernel may take more than this one).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, int device,
                   std::atomic<unsigned long long>& done) {
  return opt_in_smem(kernel, smem <= 48 * 1024 ? smem : kRingMaxSmem, device,
                     done);
}

// The first pass of a cut on a grid of `blocks` x `rows_y` blocks.
cudaError_t launch_est(int cut, const void* raw, const void* twiddle,
                       const void* order, const void* window,
                       const void* history, void* partial, const int* plan,
                       int device, int F, int group, int n_valid, int taps,
                       int rows_y, int width, cudaStream_t st, RingPlan* p) {
  int smem = 0;
  std::atomic<unsigned long long>* done = nullptr;
  const bool windowed = cut == kRingTapers || (cut == kRingSk && window);
  const EstKernel kernel =
      est_pick<false>(plan, cut, windowed, p, &smem, &done);
  if (kernel == nullptr || !width_ok(raw, p->n, width) || order == nullptr ||
      F <= 0 || group <= 0 || n_valid < 0 || n_valid > F ||
      (cut != kRingSk && window == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) e = opt_in(kernel, smem, device, *done);
  if (e != cudaSuccess) return e;
  const int blocks = (F + group - 1) / group;
  kernel<<<dim3(blocks, rows_y), p->tf * p->lanes, smem, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const int*>(order), static_cast<const float*>(window),
      static_cast<const uint8_t*>(history), static_cast<float*>(partial), *p,
      width, F, group, n_valid, taps);
  return cudaGetLastError();
}

// The first pass of a cut's streams form on a grid of S * G_s x `rows_y`
// blocks, G_s = F / group.
cudaError_t launch_est_streams_first(int cut, const void* raw,
                                     const void* twiddle, const void* order,
                                     const void* window, const void* history,
                                     const void* counts, void* partial,
                                     const int* plan, int device, int S,
                                     int F, int group, int taps, int rows_y,
                                     int width, cudaStream_t st,
                                     RingPlan* p) {
  int smem = 0;
  std::atomic<unsigned long long>* done = nullptr;
  const bool windowed = cut == kRingTapers || (cut == kRingSk && window);
  const StreamsKernel kernel =
      est_pick<true>(plan, cut, windowed, p, &smem, &done);
  if (kernel == nullptr || !width_ok(raw, p->n, width) || order == nullptr ||
      !streams_args_ok(S, F, group, counts) ||
      (cut != kRingSk && window == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) e = opt_in(kernel, smem, device, *done);
  if (e != cudaSuccess) return e;
  const int G_s = F / group;
  kernel<<<dim3(S * G_s, rows_y), p->tf * p->lanes, smem, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const int*>(order), static_cast<const float*>(window),
      static_cast<const uint8_t*>(history), static_cast<float*>(partial), *p,
      width, F, group, G_s, static_cast<const int*>(counts), taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// SK-M: launches both passes on `stream`. raw: (F, 2N) u8, `width`-byte
// aligned (the ring's copy width); twiddle, order, plan: the mixed-radix
// kernel's (plan_twiddles, element_of_bin, ring plan ints); window: (N,)
// f32, or null; partial: (2 * ceil(F / group), row) f32 scratch; out: (2,
// row) f32 (s1, s2), or with two_sigma > 0 (4, row) (s1, s2, s1 * keep,
// n_valid * keep); row = N rounded up to 32. Returns a cudaError_t (0 on
// success); does not synchronise.
int rpf_fused_psd_sk_mixed(const void* raw, const void* twiddle,
                           const void* order, const void* window,
                           void* partial, void* out, const int* plan,
                           int device, int F, int group, int n_valid,
                           float two_sigma, int width, void* stream) {
  if (!(two_sigma >= 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RingPlan p;
  cudaError_t e = launch_est(kRingSk, raw, twiddle, order, window, nullptr,
                             partial, plan, device, F, group, n_valid, 1, 1,
                             width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  const float* part = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  if (two_sigma > 0.0f) {
    est_sum_kernel<kEstSkGate><<<p.row / kSumBins, kSumBins * kSumLanes, 0,
                                 st>>>(part, blocks, p.row, n_valid,
                                       two_sigma, o);
  } else {
    est_sum_kernel<kEstSk><<<p.row / kSumBins, kSumBins * kSumLanes, 0,
                             st>>>(part, blocks, p.row, n_valid, two_sigma,
                                   o);
  }
  return static_cast<int>(cudaGetLastError());
}

// MT-M: tapers: (K, N) f32, 1 <= K <= 32; partial: (K * ceil(F / group),
// row) f32 scratch; out: (row,) f32. Other arguments as
// rpf_fused_psd_sk_mixed.
int rpf_fused_psd_tapers_mixed(const void* raw, const void* twiddle,
                               const void* order, const void* tapers,
                               void* partial, void* out, const int* plan,
                               int device, int F, int group, int K,
                               int n_valid, int width, void* stream) {
  if (K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RingPlan p;
  cudaError_t e = launch_est(kRingTapers, raw, twiddle, order, tapers,
                             nullptr, partial, plan, device, F, group,
                             n_valid, 1, K, width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (F + group - 1) / group;
  est_sum_kernel<kEstTapers><<<p.row / kSumBins, kSumBins * kSumLanes, 0,
                               st>>>(static_cast<const float*>(partial),
                                     K * blocks, p.row, K, 0.0f,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// PFB-M: history, history_out: (P - 1, 2N) u8, distinct (null when P = 1);
// h: (P, N) f32, 1 <= P <= 32; partial: (ceil(F / group), row) f32
// scratch; out: (row,) f32; fresh: set the history to byte 127 first.
// After the sum, the next history (rows n_valid .. n_valid + P - 2 of the
// virtual array) is copied into history_out on the stream. Other
// arguments as rpf_fused_psd_sk_mixed.
int rpf_fused_psd_pfb_mixed(const void* raw, const void* history,
                            const void* twiddle, const void* order,
                            const void* h, void* partial, void* out,
                            void* history_out, const int* plan, int device,
                            int F, int group, int n_valid, int P, int fresh,
                            int width, void* stream) {
  RingPlan p;
  if (P < 1 || P > 32 ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out)) ||
      read_ring_plan(plan, &p) != cudaSuccess || n_valid < 0 ||
      n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t row_bytes = static_cast<size_t>(2) * p.n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127, (P - 1) * row_bytes,
                        st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_est(kRingPfb, raw, twiddle, order, h, history, partial, plan,
                 device, F, group, n_valid, P, 1, width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_psd_sum(partial, (F + group - 1) / group, p.row, out, st);
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  // The next history: rows n_valid .. n_valid + P - 2 of the virtual array,
  // `kept` of them from the old history and the rest from the slot.
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

// SK-M-S: S streams of F frames. raw: (S*F, 2N) u8, stream s in rows
// [s*F, (s+1)*F), `width`-byte aligned; n_valid: (S,) int32 on the
// device, read by the kernels when they run (a count outside [0, F] acts
// as its nearest bound); group must divide F (G_s = F / group blocks a
// stream); partial: (2 * S * G_s, row) f32 scratch; out: (S, 2, row) f32
// (s1, s2 of each stream), or with two_sigma > 0 (S, 4, row), each stream
// gated on its own moments and count. Other arguments as
// rpf_fused_psd_sk_mixed.
int rpf_fused_psd_sk_mixed_streams(const void* raw, const void* twiddle,
                                   const void* order, const void* window,
                                   const void* n_valid, void* partial,
                                   void* out, const int* plan, int device,
                                   int S, int F, int group, float two_sigma,
                                   int width, void* stream) {
  if (!(two_sigma >= 0.0f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RingPlan p;
  cudaError_t e = launch_est_streams_first(
      kRingSk, raw, twiddle, order, window, nullptr, n_valid, partial, plan,
      device, S, F, group, 1, 1, width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G_s = F / group;
  e = two_sigma > 0.0f
          ? launch_est_streams<kEstSkGate>(partial, S, G_s, 1, p.row,
                                           n_valid, F, 0, two_sigma, out, st)
          : launch_est_streams<kEstSk>(partial, S, G_s, 1, p.row, n_valid, F,
                                       0, two_sigma, out, st);
  return static_cast<int>(e);
}

// MT-M-S: tapers: (K, N) f32, 1 <= K <= 32, shared by the streams;
// partial: (K * S * G_s, row) f32 scratch; out: (S, row) f32. Other
// arguments as rpf_fused_psd_sk_mixed_streams.
int rpf_fused_psd_tapers_mixed_streams(const void* raw, const void* twiddle,
                                       const void* order, const void* tapers,
                                       const void* n_valid, void* partial,
                                       void* out, const int* plan,
                                       int device, int S, int F, int group,
                                       int K, int width, void* stream) {
  if (K < 1 || K > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RingPlan p;
  cudaError_t e = launch_est_streams_first(
      kRingTapers, raw, twiddle, order, tapers, nullptr, n_valid, partial,
      plan, device, S, F, group, 1, K, width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_est_streams<kEstTapers>(
      partial, S, F / group, K, p.row, n_valid, F, K, 0.0f, out, st));
}

// PFB-M-S: history, history_out: (S, P - 1, 2N) u8, distinct, 4-byte
// aligned (null when P = 1), stream s's rows together; h: (P, N) f32, 1
// <= P <= 32; partial: (S * G_s, row) f32 scratch; out: (S, row) f32;
// fresh: set every stream's history to byte 127 first. After the sum,
// each stream's next history (rows n_valid[s] .. n_valid[s] + P - 2 of its
// virtual array) is written to history_out on the stream
// (pfb_history.cuh). Other arguments as rpf_fused_psd_sk_mixed_streams.
int rpf_fused_psd_pfb_mixed_streams(const void* raw, const void* history,
                                    const void* twiddle, const void* order,
                                    const void* h, const void* n_valid,
                                    void* partial, void* out,
                                    void* history_out, const int* plan,
                                    int device, int S, int F, int group,
                                    int P, int fresh, int width,
                                    void* stream) {
  RingPlan p;
  if (P < 1 || P > 32 || S > kMaxGridY ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out)) ||
      read_ring_plan(plan, &p) != cudaSuccess ||
      !streams_args_ok(S, F, group, n_valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_bytes = 2 * p.n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * row_bytes, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_est_streams_first(kRingPfb, raw, twiddle, order, h, history,
                               n_valid, partial, plan, device, S, F, group,
                               P, 1, width, st, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_psd_sum(partial, F / group, p.row, out, st, S);
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             n_valid, S, F, P, row_bytes,
                                             st));
}

// What the first pass of `cut` (1 SK, 2 the tapers, 3 the PFB), windowed
// or not, gets with the plan on `device`: attrs[0..5] as
// rpf_fused_psd_mixed_attributes. Launches nothing.
int rpf_fused_psd_mixed_est_attributes(const int* plan, int cut,
                                       int windowed, int device,
                                       int* attrs) {
  RingPlan p;
  int smem = 0;
  std::atomic<unsigned long long>* done = nullptr;
  const EstKernel kernel =
      est_pick<false>(plan, cut, windowed != 0, &p, &smem, &done);
  if (kernel == nullptr || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) e = opt_in(kernel, smem, device, *done);
  if (e == cudaSuccess) {
    e = kernel_attributes(kernel, p.tf * p.lanes, smem, attrs);
  }
  return static_cast<int>(e);
}

// What the streams form of `cut` gets, as
// rpf_fused_psd_mixed_est_attributes. Launches nothing.
int rpf_fused_psd_mixed_est_streams_attributes(const int* plan, int cut,
                                               int windowed, int device,
                                               int* attrs) {
  RingPlan p;
  int smem = 0;
  std::atomic<unsigned long long>* done = nullptr;
  const StreamsKernel kernel =
      est_pick<true>(plan, cut, windowed != 0, &p, &smem, &done);
  if (kernel == nullptr || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) e = opt_in(kernel, smem, device, *done);
  if (e == cudaSuccess) {
    e = kernel_attributes(kernel, p.tf * p.lanes, smem, attrs);
  }
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
