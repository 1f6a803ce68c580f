// The mixed-radix group kernel of fused_psd_mixed.cu:
// psd_ring_kernel<WINDOWED, ACC>, the passes of fft_mixed.cuh (radix 2, 3,
// 4, 5, 7, 8, 16, decimation in frequency) by a run-time plan
// (fused_psd_mixed.ring_shape on the host).
//
// A block is `lanes` frame lanes of tf threads, tf a multiple of 32 (whole
// warps), lanes a power of two. Lane p of block g sums the frames
// f0 + p + lanes * i of the block's [f0, min(f0 + group, F, n_valid)). Per
// frame, on thread t of a lane:
//  * the next frame is in flight: cp.async copies its bytes into the
//    lane's other ring slot (frame_ring.cuh) while this one is
//    transformed;
//  * pass 0 reads its butterflies' samples from the ring as u16 pairs,
//    dequantizes them exactly, times the window (read through L1), runs
//    the radix-R_0 butterfly in registers and writes the outputs, times
//    their twiddles, to the lane's exchange buffer;
//  * passes 1 .. P-2 in place through the buffer, one block barrier
//    between passes. Butterfly b of a pass is t + i*tf, i < rounds_j (the
//    plan's); its (block, n2) = divmod(b, S_j) takes no division: the
//    plan holds ceil(2^32 / S_j), and b / S_j = umulhi(b, that) exactly
//    for b < 2^15 and S_j < 2^14;
//  * the last pass (S = 1: butterfly b takes the elements b*R + k) adds
//    |X|^2 of its outputs to f32 registers: a thread's last-pass
//    butterflies are the same in every frame, so its rounds * R_last sums
//    (at most ACC) stay in registers across the lane's frames.
// At the end the lanes' sums go to shared memory at their elements, and
// each bin k of the row is its element (order[k], the host's
// element_of_bin: k's digits in reverse) summed lane by lane in order; the
// block writes its partial row (N rounded up to 32 floats, the rest 0) for
// psd_sum.cuh. Both classes of sums (at most kRingAccSmall, at most
// kRingAccLarge) may take 128 registers, one 512-thread block an SM: the
// small class held to 64 (two such blocks) spilled 248 B and measured
// slower at every N tried (probes/ring_layouts.py).
//
// The pass table (radix, stride, division constant, twiddle offset and
// rounds of each pass) is copied from the kernel parameter into shared
// memory once a block, so no pass indexes the parameter at run time. The
// twiddles are read through L1 (a form that held them in shared memory
// measured slower: its table cost blocks an SM). Element e of a lane's
// exchange buffer sits at e: no padding (fft_regs.cuh's float2 every 16
// elements wins at some N and loses at others, probes/ring_layouts.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_mixed.cuh"
#include "frame_ring.cuh"
#include "psd_sum.cuh"  // kSumBins

namespace {

// Threads a block may have (tf times lanes).
constexpr int kRingMaxThreads = 512;
// The last-pass sums a thread may hold: two classes of the kernel.
constexpr int kRingAccSmall = 16;
constexpr int kRingAccLarge = 36;
// Dynamic shared bytes a block may have: the 227 KB less the static pass
// table (at most 256 bytes).
constexpr int kRingMaxSmem = kMixedMaxSmem - 256;

// The plan, by value: the wrapper's ints in this order
// (fused_psd_mixed.RingLaunch.ints).
struct RingPlan {
  int n;        // N
  int row;      // a partial row: N rounded up to kSumBins
  int passes;   // P
  int tf;       // threads a frame lane, a multiple of 32
  int lanes;    // frame lanes a block
  int radix[kMixedMaxPasses];
  int stride[kMixedMaxPasses];   // S_j = L_j / R_j
  int magic[kMixedMaxPasses];    // ceil(2^32 / S_j) (bits), 0 where S_j = 1
  int twoff[kMixedMaxPasses];    // row of pass j's first twiddle
  int rounds[kMixedMaxPasses];   // ceil((N / R_j) / tf)
};
constexpr int kRingPlanInts = 5 + 5 * kMixedMaxPasses;

// Shared bytes of a block: the lanes' exchange buffers, then their rings.
__host__ __device__ inline int ring_smem_bytes(const RingPlan& p) {
  return round16(p.lanes * p.n * 8) + p.lanes * ring_bytes(p.n);
}

inline bool is_radix(int r) {
  for (int m : kMixedRadices) {
    if (r == m) return true;
  }
  return false;
}

// The plan ints into p, checked against what they must be.
inline cudaError_t read_ring_plan(const int* ints, RingPlan* p) {
  if (ints == nullptr) return cudaErrorInvalidValue;
  p->n = ints[0];
  p->row = ints[1];
  p->passes = ints[2];
  p->tf = ints[3];
  p->lanes = ints[4];
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    p->radix[j] = ints[5 + j];
    p->stride[j] = ints[5 + kMixedMaxPasses + j];
    p->magic[j] = ints[5 + 2 * kMixedMaxPasses + j];
    p->twoff[j] = ints[5 + 3 * kMixedMaxPasses + j];
    p->rounds[j] = ints[5 + 4 * kMixedMaxPasses + j];
  }
  const int P = p->passes;
  bool ok = P >= 1 && P <= kMixedMaxPasses && p->n >= 2 &&
            p->n <= 16384 && p->row % kSumBins == 0 && p->row >= p->n &&
            p->tf >= 32 && p->tf % 32 == 0 && p->lanes >= 1 &&
            p->tf * p->lanes <= kRingMaxThreads;
  int L = p->n;
  int offset = 0;
  for (int j = 0; ok && j < P; ++j) {
    const int r = p->radix[j];
    ok = is_radix(r) && L % r == 0 && p->stride[j] == L / r &&
         p->twoff[j] == offset &&
         p->rounds[j] == (p->n / r + p->tf - 1) / p->tf &&
         static_cast<unsigned>(p->magic[j]) ==
             (L / r == 1 ? 0u
                         : static_cast<unsigned>(
                               (0x100000000ull + L / r - 1) / (L / r)));
    if (j < P - 1) offset += L;
    L /= r;
  }
  ok = ok && L == 1 && p->rounds[P - 1] * p->radix[P - 1] <= kRingAccLarge;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel class for the plan (0: at most kRingAccSmall last-pass sums
// a thread, 1: at most kRingAccLarge) and its shared bytes, or -1 where the
// plan's block does not fit.
inline int ring_pick(const RingPlan& p, int* smem) {
  const bool large =
      p.rounds[p.passes - 1] * p.radix[p.passes - 1] > kRingAccSmall;
  *smem = ring_smem_bytes(p);
  return *smem > kRingMaxSmem ? -1 : large ? 1 : 0;
}

// The output permutation of dft_natural's radix-4/8/16 form, with every
// register index a constant.
template <int R, int K = 0>
__device__ __forceinline__ void unscramble(float2 (&out)[R],
                                           const float2 (&v)[R]) {
  if constexpr (K < R) {
    constexpr int r = rev_bits(K, log2_of(R));
    out[K] = v[r];
    unscramble<R, K + 1>(out, v);
  }
}

// dft_natural (fft_mixed.cuh), the same arithmetic.
template <int R>
__device__ __forceinline__ void ring_dft(float2 (&v)[R]) {
  if constexpr (R == 2 || R % 2 == 1) {
    dft_natural<R>(v);
  } else {
    dif_regs<R>(v, 0);
    float2 t[R];
    unscramble<R>(t, v);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = t[r];
  }
}

// Pass 0 of one frame from the ring on lane thread t: butterflies
// b = t + i*tf < n / R, each over the samples b + n1*S (S = n / R); output
// k1 to element b + k1*S times W_n^(b*k1). A one-pass plan (`copy`: n = R)
// writes the samples to their elements instead, for the last pass.
template <int R, bool WINDOWED>
__device__ __forceinline__ void ring_first(
    const uint16_t* iq, const float* __restrict__ window,
    const float2* __restrict__ tw,
    float2* x, int n, bool copy, int rounds, int t, int tf) {
  if (copy) {
    for (int s = t; s < n; s += tf) {
      x[s] = ring_sample<WINDOWED>(iq, s,
                                   WINDOWED ? __ldg(window + s) : 0.0f);
    }
    return;
  }
  const int S = n / R;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < S) {
      float2 v[R];
#pragma unroll
      for (int n1 = 0; n1 < R; ++n1) {
        const int s = b + n1 * S;
        v[n1] = ring_sample<WINDOWED>(
            iq, s, WINDOWED ? __ldg(window + s) : 0.0f);
      }
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        x[b + k1 * S] = k1 == 0 ? v[0] : cmulf(v[k1], __ldg(tw + k1 * S + b));
      }
    }
  }
}

// A middle pass in place on lane thread t: butterfly b = t + i*tf <
// n / R at (block, n2) = divmod(b, S) by the division constant, its
// elements block*R*S + n2 + n1*S; outputs times their twiddles (the pass's
// part of the table, row k1*S + n2).
template <int R>
__device__ __forceinline__ void ring_mid(float2* x,
                                         const float2* __restrict__ tw,
                                         int S, unsigned magic, int n,
                                         int rounds, int t, int tf) {
  const int nb = n / R;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < nb) {
      const int block = static_cast<int>(__umulhi(static_cast<unsigned>(b),
                                                  magic));
      const int n2 = b - block * S;
      const int base = block * R * S + n2;
      float2 v[R];
#pragma unroll
      for (int n1 = 0; n1 < R; ++n1) v[n1] = x[base + n1 * S];
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        x[base + k1 * S] =
            k1 == 0 ? v[0] : cmulf(v[k1], __ldg(tw + k1 * S + n2));
      }
    }
  }
}

// The last pass on lane thread t: butterfly b = t + i*tf < n / R takes
// the elements b*R + k; |.|^2 of output k1 is added to acc[i*R + k1].
template <int R, int ACC>
__device__ __forceinline__ void ring_last(const float2* x,
                                          float (&acc)[ACC], int n, int t,
                                          int tf) {
  const int nb = n / R;
#pragma unroll
  for (int i = 0; i < ACC / R; ++i) {
    const int b = t + i * tf;
    if (b < nb) {
      float2 v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = x[b * R + k];
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) acc[i * R + k1] += norm2(v[k1]);
    }
  }
}

// The sums of ring_last to their elements of the lane's row.
template <int R, int ACC>
__device__ __forceinline__ void ring_gather(float* by_elem,
                                            const float (&acc)[ACC], int n,
                                            int t, int tf) {
  const int nb = n / R;
#pragma unroll
  for (int i = 0; i < ACC / R; ++i) {
    const int b = t + i * tf;
    if (b < nb) {
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) by_elem[b * R + k1] = acc[i * R + k1];
    }
  }
}

// Pass 1 of the step: block g serves stream s = g / G_s (one stream for
// the single-stream entry) and sums |X|^2 of that stream's frames
// [j*group, min((j+1)*group, F, n_valid_s)), j = g mod G_s, into partial
// row g. n_valid_s is stream_n_valid[s] where that array is given, else
// n_valid.
template <bool WINDOWED, int ACC>
__global__ void __launch_bounds__(kRingMaxThreads, 1)
psd_ring_kernel(const uint8_t* __restrict__ raw,     // (S*F, 2N)
                const float2* __restrict__ twiddle,  // plan_twiddles
                const int* __restrict__ order,       // (N,) element of bin
                const float* __restrict__ window,    // (N,) or null
                float* __restrict__ partial,         // (S*G_s, row)
                const RingPlan p, int width, int F, int group,
                int blocks_per_stream, int n_valid,
                const int* __restrict__ stream_n_valid) {
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
  float2* x = reinterpret_cast<float2*>(smem) + lane * n;
  uint8_t* ring = smem + round16(p.lanes * n * 8) + lane * ring_bytes(n);
  const int slot = ring_slot(n);

  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.0f;

  const int stream = blockIdx.x / blocks_per_stream;
  const int nv = stream_n_valid == nullptr ? n_valid
                                           : __ldg(stream_n_valid + stream);
  const int f0 = (blockIdx.x - stream * blocks_per_stream) * group;
  const int f1 = min(f0 + group, min(F, nv));
  const int iters = (max(f1 - f0, 0) + p.lanes - 1) / p.lanes;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * n;

  // Lane frame i of the block into ring slot i & 1 (an empty group past
  // the lane's last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    const int f = f0 + lane + p.lanes * i;
    if (i < iters && f < f1) {
      ring_copy(ring + (i & 1) * slot, frames + static_cast<size_t>(f) * 2 * n,
                2 * n, width, t, tf);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < iters; ++i) {
    prefetch(i + 1);
    cp_async_wait<1>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const bool active = f0 + lane + p.lanes * i < f1;
    const uint16_t* iq =
        reinterpret_cast<const uint16_t*>(ring + (i & 1) * slot);
    if (active) {
      with_radix(p.radix[0], [&](auto rc) {
        ring_first<decltype(rc)::value, WINDOWED>(
            iq, window, twiddle, x, n, P == 1, p.rounds[0], t, tf);
      });
    }
    for (int j = 1; j < P - 1; ++j) {
      __syncthreads();
      if (active) {
        const int4 e = tab[j];
        const int rounds = tab_rounds[j];
        with_radix(e.x, [&](auto rc) {
          ring_mid<decltype(rc)::value>(x, twiddle + e.w, e.y,
                                        static_cast<unsigned>(e.z), n,
                                        rounds, t, tf);
        });
      }
    }
    __syncthreads();
    if (active) {
      with_radix(tab[P - 1].x, [&](auto rc) {
        ring_last<decltype(rc)::value, ACC>(x, acc, n, t, tf);
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums at their elements, then each bin's element added lane
  // by lane in order.
  float* by_elem = reinterpret_cast<float*>(smem);   // (lanes, n)
  with_radix(tab[P - 1].x, [&](auto rc) {
    ring_gather<decltype(rc)::value, ACC>(by_elem + lane * n, acc, n, t, tf);
  });
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * p.row;
  for (int k = tid; k < p.row; k += threads) {
    float sum = 0.0f;
    if (k < n) {
      const int q = __ldg(order + k);
      sum = by_elem[q];
      for (int l = 1; l < p.lanes; ++l) sum += by_elem[l * n + q];
    }
    out[k] = sum;
  }
}

}  // namespace
