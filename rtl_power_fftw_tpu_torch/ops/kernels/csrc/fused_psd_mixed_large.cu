// The large mixed-radix fused averaged-PSD step for NVIDIA Hopper (sm_90a),
// kernel "ML": the port's step at the even 7-smooth bin counts (every prime
// factor <= 7) from 16386 to 2^22 that are not powers of two (20000, 49152,
// 100000, 10^6). Its JAX counterpart has no Pallas kernel: the JAX package
// computes these N with XLA's FFT through its transform ladder (the fft4
// rung of rtl_power_fftw_tpu/ops/spectral.py on the CPU).
//
// The function is the large kernel's (fused_psd_large.cu): raw interleaved
// u8 IQ frames (F, 2N) -> dequantize (u8 - 127) -> [times window[n] in
// FP32] -> length-N DFT in FP32 -> |X|^2 -> drop frames f >= n_valid ->
// sum over frames, an (N,) float32 vector of bins in natural (unshifted)
// order.
//
// Form: a four-step FFT over device memory, N = N1 * N2 with both factors
// 7-smooth and N2 even (fused_psd_mixed_large.ml_split: the divisor of
// N / 2 nearest sqrt(N), so that a raw row of N2 samples is 4-byte
// aligned); sample n = n1 N2 + n2, bin k = k1 + N1 k2. The plans are
// run-time (N1 from 49 to 2025, N2 to 6250 over the 1192 N), each pass a
// radix of fft_mixed.cuh (2, 3, 4, 5, 7, 8, 16; decimation in frequency)
// by the pass table of fused_psd_mixed_ring.cuh (radix, stride, division
// constant, twiddle offset, rounds), copied into shared memory once a
// block: butterfly b's (block, n2) = divmod(b, S_j) by umulhi with the
// division constant, every other index a shift or a product. Butterflies
// run in registers (ring_dft), one block barrier a pass.
//  * Pass A (ml_cols_kernel): a block takes a tile of C columns n2
//    (fused_psd_mixed_large.cols_count: 16, 8 or 4, what two blocks an SM
//    leave room for) of its frames. Thread tid is column tid mod C and
//    thread tid / C of that column's butterflies, and the exchange holds
//    element e of column c at x[e C + c], so a half-warp's reads and
//    writes are C adjacent columns of 16 / C butterflies: on distinct
//    banks at C = 16; at C = 8 and 4 up to 4-way where those
//    butterflies' elements are not adjacent (a block boundary, the last
//    pass's stride R). The next frame's tile (N1
//    rows of 2C bytes) is copied into the other slot of a two-slot ring
//    by cp.async at the frames' copy width (frame_ring.cuh: 4, 8 or 16
//    bytes) while one is transformed; pass 0 reads its samples from the
//    ring (u8 - 127 exactly, times the window). The last pass writes its
//    outputs, bin k1 by the plan's element table, times W_N^(n2 k1) to
//    scratch in tile-major order (value (k1, n2) at ((n2 / C) N1 + k1) C +
//    n2 mod C, the twiddle table in the same order), C adjacent values a
//    store.
//  * Pass B (ml_rows_kernel<ACC>): a block is `lanes` rows k1 of tf
//    threads (whole warps), each row's N2 values at a row of a ring slot;
//    the next frame's rows (N2 / C runs of lanes * C values, whole lines)
//    copied 16 bytes a thread by cp.async into the other slot while one is
//    transformed in place; the last pass adds |X|^2 of its outputs to f32
//    registers, the same elements of the same row in every frame (at most
//    ACC a thread); at the end they go to shared memory and each bin k1 +
//    N1 k2 of the block's rows to one partial row a block (or `out` where
//    there is one row; 2..8 rows added by psd_rows_sum, more by
//    psd_sum.cuh, in float64 in a fixed order).
// Frames >= n_valid are neither transformed nor written, and their scratch
// is never read. No float atomics: the result is the same on every run.
//
// What bounds it on an H100: the function reads 2N bytes a frame for about
// 5 N log2 N FP32 flops; this two-pass form also writes and reads back 8N
// bytes of scratch a frame (at 10^6, F = 8: 64 MB each way, ~38 us at
// 3.35 TB/s), the floor of the form.
//
// The control. The first form (tile_cols_kernel and tile_power_kernel
// of fft_mixed_tile.cuh on mixed_large_split's N1 x N2: one frame at a
// time, integer division in its loop indices) stays, launched by
// rpf_fused_psd_mixed_large_control for chip_smoke.py to time the form
// above against; it is never on a session's path.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed_tile.cuh"
#include "frame_ring.cuh"
#include "fused_psd_mixed.cuh"   // kMixedMaxSmem, read by the ring's header
#include "fused_psd_mixed_large_streams.cuh"
#include "fused_psd_mixed_ring.cuh"
#include "large_streams.cuh"
#include "psd_rows_sum.cuh"
#include "psd_sum.cuh"

namespace {

// --- The control: the first form's run-time tile passes ---

using ColsKernel = void (*)(const uint8_t*, const float2*, const int*,
                            const float2*, const float*, const float2*,
                            float2*, const TilePlan, int, int, int, int, int,
                            int, int);

ColsKernel cols_kernel(bool windowed) {
  return windowed ? tile_cols_kernel<true, false>
                  : tile_cols_kernel<false, false>;
}

// Pass A unwindowed, windowed, pass B.
std::atomic<unsigned long long> ml_done[3];

const void* ml_kernel(int which) {
  return which == 0   ? reinterpret_cast<const void*>(cols_kernel(false))
         : which == 1 ? reinterpret_cast<const void*>(cols_kernel(true))
                      : reinterpret_cast<const void*>(tile_power_kernel);
}

// --- The division-free passes (their shared parts, and the streams
// passes, are fused_psd_mixed_large_streams.cuh's) ---

// Pass A. Block b serves column tile j = b mod tiles (columns [c0, c0 +
// C), c0 = j C, those below n2_len) of frames [g * group, min((g + 1) *
// group, F, n_valid)), g = b / tiles. p: N1's plan with tf = kColsThreads
// / C, lanes = C.
// Three blocks an SM (80 registers, no spill): two (128) ran 1-4% slower
// at 16464, 20000, 100000 and 10^6 and 3% faster at 49152
// (probes/large_awkward_builds.py on an H100).
template <bool WINDOWED>
__global__ void __launch_bounds__(kColsThreads, 3)
ml_cols_kernel(const uint8_t* __restrict__ raw,      // (F, 2N)
               const float2* __restrict__ twiddle,   // plan_twiddles(N1)
               const int* __restrict__ bin_of,       // (N1,) element -> bin
               const float2* __restrict__ inter,     // (N1, N2p) tile-major
               const float* __restrict__ window,     // (N,) or null
               float2* __restrict__ scratch,         // (F, N1, N2p)
               const RingPlan p, int log2c, int n2_len, int n2p, int width,
               int F, int group, int n_valid) {
  extern __shared__ float4 ml_smem[];
  __shared__ int4 tab[kMixedMaxPasses];   // radix, stride, magic, twoff
  __shared__ int tab_rounds[kMixedMaxPasses];
  const int tid = threadIdx.x;
  const int C = 1 << log2c;
  const int c = tid & (C - 1);
  const int t = tid >> log2c;
  const int n1 = p.n, tf = p.tf, P = p.passes;
#pragma unroll
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    if (tid == j) {
      tab[j] = make_int4(p.radix[j], p.stride[j], p.magic[j], p.twoff[j]);
      tab_rounds[j] = p.rounds[j];
    }
  }
  const int row_bytes = 2 * C;
  const int slot_bytes = n1 * row_bytes;
  float2* x = reinterpret_cast<float2*>(ml_smem);            // (N1, C)
  uint8_t* ring = reinterpret_cast<uint8_t*>(ml_smem) + n1 * C * 8;
  const int tiles = n2p >> log2c;
  const int tile = blockIdx.x % tiles;
  const int c0 = tile << log2c;
  const int f0 = (blockIdx.x / tiles) * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
  const bool active = c0 + c < n2_len;
  const size_t frame_bytes = static_cast<size_t>(2) * n1 * n2_len;

  // Frame i's tile into ring slot i & 1: each row's 2C bytes (those of
  // columns below n2_len) in pieces of `width` = 1 << lw bytes.
  const int lw = width == 16 ? 4 : width == 8 ? 3 : 2;
  const int lp = log2c + 1 - lw;   // pieces a row: 1 << lp (2C >= width)
  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src = raw + (f0 + i) * frame_bytes + 2 * c0;
      uint8_t* dst = ring + (i & 1) * slot_bytes;
      for (int q = tid; q < (n1 << lp); q += kColsThreads) {
        const int row = q >> lp;
        const int byte = (q - (row << lp)) << lw;
        if (c0 + (byte >> 1) < n2_len) {
          const uint8_t* from =
              src + static_cast<size_t>(row) * 2 * n2_len + byte;
          uint8_t* to = dst + row * row_bytes + byte;
          if (width == 16) {
            cp_async16(to, from);
          } else if (width == 8) {
            cp_async_ca<8>(to, from);
          } else {
            cp_async_ca<4>(to, from);
          }
        }
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    cp_async_wait<0>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; frame i - 1 is done with x and
                          // its slot (and the pass table is in place)
    prefetch(i + 1);
    const uint8_t* slot = ring + (i & 1) * slot_bytes;
    if (active) {
      with_radix(tab[0].x, [&](auto rc) {
        ml_first<decltype(rc)::value, WINDOWED>(
            slot, row_bytes, window, n2_len, c0 + c, twiddle, x + c, C, n1,
            tab_rounds[0], t, tf, c);
      });
    }
    for (int j = 1; j < P - 1; ++j) {
      __syncthreads();
      if (active) {
        const int4 e = tab[j];
        const int rounds = tab_rounds[j];
        with_radix(e.x, [&](auto rc) {
          constexpr int R = decltype(rc)::value;
          ml_mid<R>(x + c, C, twiddle + e.w, e.y,
                    static_cast<unsigned>(e.z), n1 / R, rounds, t, tf);
        });
      }
    }
    __syncthreads();
    if (active) {
      float2* out = scratch + static_cast<size_t>(f0 + i) * n1 * n2p +
                    static_cast<size_t>(tile) * n1 * C;
      with_radix(tab[P - 1].x, [&](auto rc) {
        ml_last_store<decltype(rc)::value>(
            x + c, C, bin_of, inter + static_cast<size_t>(tile) * n1 * C,
            out, n1, tab_rounds[P - 1], t, tf, c);
      });
    }
  }
  cp_async_wait<0>();
}

// Pass B. Block b serves rows [k0, k0 + lanes) (those below n1_len), k0 =
// (b mod tiles) * lanes, of frames [g * group, min((g + 1) * group, F,
// n_valid)), g = b / tiles; lane r = tid / tf is row k0 + r. p: N2's plan.
// Writes bins k1 + N1 k2 of the rows to row g of `rows`.
template <int ACC>
__global__ void __launch_bounds__(kRowsThreads, 2)
ml_rows_kernel(const float2* __restrict__ scratch,   // (F, N1, N2p)
               const float2* __restrict__ twiddle,   // plan_twiddles(N2)
               const int* __restrict__ order,        // (N2,) element of bin
               float* __restrict__ rows,             // (ceil(F / group), row)
               const RingPlan p, int n1_len, int log2c, int n2p, int F,
               int group, int n_valid) {
  extern __shared__ float4 ml_smem[];
  __shared__ int4 tab[kMixedMaxPasses];   // radix, stride, magic, twoff
  __shared__ int tab_rounds[kMixedMaxPasses];
  const int n = p.n, tf = p.tf, P = p.passes, lanes = p.lanes;
  const int tid = threadIdx.x;
  const int r = tid / tf;
  const int t = tid - r * tf;
#pragma unroll
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    if (tid == j) {
      tab[j] = make_int4(p.radix[j], p.stride[j], p.magic[j], p.twoff[j]);
      tab_rounds[j] = p.rounds[j];
    }
  }
  const int C = 1 << log2c;
  const int slot = lanes * n2p;                      // float2 a slot
  float2* ring = reinterpret_cast<float2*>(ml_smem);
  const int tiles = (n1_len + lanes - 1) / lanes;
  const int k0 = (blockIdx.x % tiles) * lanes;
  const int valid = min(lanes, n1_len - k0);
  const int g = blockIdx.x / tiles;
  const int f0 = g * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
  const bool active = r < valid;

  // Frame i's rows into slot i & 1: run h (columns [h C, h C + C)) of the
  // frame's scratch holds rows k0 .. k0 + lanes - 1 as lanes * C adjacent
  // values (row-major), copied 2 values (16 bytes) a piece to row r's
  // columns; pieces of rows past n1_len are not copied.
  const int ll = __ffs(lanes) - 1;             // lanes = 1 << ll
  const int lr = ll + log2c - 1;               // pieces a run: 1 << lr
  auto prefetch = [&](int i) {
    if (i < frames) {
      const float2* src = scratch +
                          static_cast<size_t>(f0 + i) * n1_len * n2p +
                          static_cast<size_t>(k0) * C;
      float2* dst = ring + (i & 1) * slot;
      const int pieces = (n2p >> log2c) << lr;
      for (int q = tid; q < pieces; q += tf * lanes) {
        const int h = q >> lr;
        const int e = (q - (h << lr)) * 2;          // value in the run
        const int rr = e >> log2c;
        if (rr < valid) {
          cp_async16(dst + rr * n2p + (h << log2c) + (e & (C - 1)),
                     src + static_cast<size_t>(h) * n1_len * C + e);
        }
      }
    }
    cp_async_commit();
  };

  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.0f;
  prefetch(0);
  for (int i = 0; i < frames; ++i) {
    cp_async_wait<0>();   // this thread's copies of frame i have landed
    __syncthreads();      // everyone's; frame i - 1 is done with its slot
    prefetch(i + 1);
    float2* x = ring + (i & 1) * slot + r * n2p;
    for (int j = 0; j < P - 1; ++j) {
      if (active) {
        const int4 e = tab[j];
        const int rounds = tab_rounds[j];
        with_radix(e.x, [&](auto rc) {
          constexpr int R = decltype(rc)::value;
          ml_mid<R>(x, 1, twiddle + e.w, e.y, static_cast<unsigned>(e.z),
                    n / R, rounds, t, tf);
        });
      }
      __syncthreads();
    }
    if (active) {
      with_radix(tab[P - 1].x, [&](auto rc) {
        ring_last<decltype(rc)::value, ACC>(x, acc, n, t, tf);
      });
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with the ring

  // The rows' sums at their elements, then bin k1 + N1 k2 of each row:
  // lanes adjacent bins a step of k2.
  float* by_elem = reinterpret_cast<float*>(ml_smem);   // (lanes, n)
  if (active) {
    with_radix(tab[P - 1].x, [&](auto rc) {
      ring_gather<decltype(rc)::value, ACC>(by_elem + r * n, acc, n, t, tf);
    });
  }
  __syncthreads();
  float* out = rows + static_cast<size_t>(g) * p.row;
  for (int j = tid; j < (n << ll); j += tf * lanes) {
    const int k2 = j >> ll;
    const int rr = j - (k2 << ll);
    if (rr < valid) {
      out[k0 + rr + k2 * n1_len] = by_elem[rr * n + __ldg(order + k2)];
    }
  }
}

using MlCols = void (*)(const uint8_t*, const float2*, const int*,
                        const float2*, const float*, float2*, const RingPlan,
                        int, int, int, int, int, int, int);
using MlRows = void (*)(const float2*, const float2*, const int*, float*,
                        const RingPlan, int, int, int, int, int, int);

// Pass A unwindowed (0), windowed (1), pass B with the small (2) and the
// large (3) class of sums.
const void* ml_new_kernel(int which) {
  static const MlCols cols[2] = {ml_cols_kernel<false>,
                                 ml_cols_kernel<true>};
  static const MlRows rows[2] = {ml_rows_kernel<kRingAccSmall>,
                                 ml_rows_kernel<kRingAccLarge>};
  return which < 2 ? reinterpret_cast<const void*>(cols[which])
                   : reinterpret_cast<const void*>(rows[which - 2]);
}

std::atomic<unsigned long long> ml_new_done[4];

// The streams passes, numbered as ml_new_kernel's.
const void* ml_streams_kernel(int which) {
  static const MlStreamsCols cols[2] = {ml_streams_cols<false>,
                                        ml_streams_cols<true>};
  static const MlStreamsRows rows[2] = {ml_streams_rows<kRingAccSmall>,
                                        ml_streams_rows<kRingAccLarge>};
  return which < 2 ? reinterpret_cast<const void*>(cols[which])
                   : reinterpret_cast<const void*>(rows[which - 2]);
}

std::atomic<unsigned long long> ml_streams_done[4];

}  // namespace

extern "C" {

// Launches pass A, pass B and, for 2 or more partial rows, their sum on
// `stream`. raw: (F, 2N) u8, `width`-byte aligned (4, 8 or 16, dividing
// 2 N2: fused_psd_mixed_large.ml_copy_width); tw1, tw2: plan_twiddles of
// N1's and N2's plans; bin1: (N1,) int32, the bin of each element of N1's
// plan; inter: (N1, N2p) complex64, W_N^(k1 n2) in scratch's tile-major
// order (0 at n2 >= N2); order2: (N2,) int32, element_of_bin of N2's plan;
// window: (N,) f32, or null; scratch: (F, N1, N2p) complex64; partial:
// (ceil(F / group_b), row) f32 (unused for one row); out: (row,) f32, of
// which the first N are the bins; plan1, plan2: RingLaunch ints of N1's
// plan (tf = 256 / C, lanes = C) and of N2's (tf, lanes = rows a block);
// log2c: log2 C, pass A's columns a tile; n2p: N2 rounded up to C.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_mixed_large(const void* raw, const void* tw1,
                              const void* bin1, const void* inter,
                              const void* window, const void* tw2,
                              const void* order2, void* scratch,
                              void* partial, void* out, const int* plan1,
                              const int* plan2, int device, int log2c,
                              int n2p, int width, int F, int group_a,
                              int group_b, int n_valid, void* stream) {
  RingPlan p1, p2;
  int which_b, smem_a, smem_b;
  if (!ml_launch_ok(raw, bin1, inter, order2, plan1, plan2, log2c, n2p,
                    width, F, group_a, group_b, &p1, &p2, &which_b, &smem_a,
                    &smem_b) ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_new_kernel(windowed ? 1 : 0), smem_a, device,
                    ml_new_done[windowed ? 1 : 0], kMlMaxSmem);
  }
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_new_kernel(which_b), smem_b, device,
                    ml_new_done[which_b], kMlMaxSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_a = n2p >> log2c;
  const int tiles_b = (p1.n + p2.lanes - 1) / p2.lanes;
  const int groups_b = (F + group_b - 1) / group_b;
  const MlCols cols = windowed ? ml_cols_kernel<true> : ml_cols_kernel<false>;
  cols<<<(F + group_a - 1) / group_a * tiles_a, kColsThreads, smem_a, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(tw1),
      static_cast<const int*>(bin1), static_cast<const float2*>(inter),
      static_cast<const float*>(window), static_cast<float2*>(scratch), p1,
      log2c, p2.n, n2p, width, F, group_a, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* rows = static_cast<float*>(groups_b == 1 ? out : partial);
  const MlRows pass_b = which_b == 2 ? ml_rows_kernel<kRingAccSmall>
                                     : ml_rows_kernel<kRingAccLarge>;
  pass_b<<<groups_b * tiles_b, p2.tf * p2.lanes, smem_b, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(tw2),
      static_cast<const int*>(order2), rows, p2, p1.n, log2c, n2p, F,
      group_b, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups_b == 1) return static_cast<int>(e);
  if (groups_b <= kSumLanes) {
    const int n4 = p2.row / 4;
    psd_rows_sum<<<(n4 + 255) / 256, 256, 0, st>>>(
        static_cast<const float4*>(partial), groups_b, n4,
        static_cast<float4*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_psd_sum(partial, groups_b, p2.row, out, st));
}

// The streams entry: S streams of F frames. raw: (S*F, 2N) u8, stream s
// in frames [s F, s F + F); counts: (S,) int32 on the device, each
// stream's valid frames (read when the passes run); scratch: (S*F, N1,
// N2p) complex64; partial: (S * ceil(F / group_b), row) f32 (unused for
// one row a stream); out: (S, row) f32. The other arguments as
// rpf_fused_psd_mixed_large's. Returns a cudaError_t (0 on success); does
// not synchronise.
int rpf_fused_psd_mixed_large_streams(
    const void* raw, const void* tw1, const void* bin1, const void* inter,
    const void* window, const void* tw2, const void* order2,
    const void* counts, void* scratch, void* partial, void* out,
    const int* plan1, const int* plan2, int device, int log2c, int n2p,
    int width, int S, int F, int group_a, int group_b, void* stream) {
  RingPlan p1, p2;
  int which_b, smem_a, smem_b;
  if (!ml_launch_ok(raw, bin1, inter, order2, plan1, plan2, log2c, n2p,
                    width, F, group_a, group_b, &p1, &p2, &which_b, &smem_a,
                    &smem_b) ||
      S <= 0 || S > kMaxGridY || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_streams_kernel(windowed ? 1 : 0), smem_a, device,
                    ml_streams_done[windowed ? 1 : 0], kMlMaxSmem);
  }
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_streams_kernel(which_b), smem_b, device,
                    ml_streams_done[which_b], kMlMaxSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* n_valid = static_cast<const int*>(counts);
  const int tiles_a = n2p >> log2c;
  const int tiles_b = (p1.n + p2.lanes - 1) / p2.lanes;
  const int g_a = (F + group_a - 1) / group_a;
  const int g_b = (F + group_b - 1) / group_b;
  const MlStreamsCols cols =
      windowed ? ml_streams_cols<true> : ml_streams_cols<false>;
  cols<<<dim3(g_a * tiles_a, S), kColsThreads, smem_a, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(tw1),
      static_cast<const int*>(bin1), static_cast<const float2*>(inter),
      static_cast<const float*>(window), static_cast<float2*>(scratch), p1,
      log2c, p2.n, n2p, width, F, group_a, g_a, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* rows = static_cast<float*>(g_b == 1 ? out : partial);
  const MlStreamsRows pass_b = which_b == 2
                                   ? ml_streams_rows<kRingAccSmall>
                                   : ml_streams_rows<kRingAccLarge>;
  pass_b<<<dim3(g_b * tiles_b, S), p2.tf * p2.lanes, smem_b, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(tw2),
      static_cast<const int*>(order2), rows, p2, p1.n, log2c, n2p, F,
      group_b, g_b, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess || g_b == 1) return static_cast<int>(e);
  return static_cast<int>(launch_rows_sum(partial, S, g_b, p2.row, out, st));
}

// What a pass gets with `smem` dynamic bytes and `threads` a block on
// `device` (which: 0 pass A, 1 pass A windowed, 2 pass B with the small
// class of sums, 3 with the large), into attrs[0..5]: registers and spill
// bytes a thread, static and dynamic shared bytes a block, threads a
// block, and the blocks that reside on one SM. Launches nothing.
int rpf_fused_psd_mixed_large_attributes(int which, int smem, int threads,
                                         int device, int* attrs) {
  if (which < 0 || which > 3 || smem < 0 || smem > kMlMaxSmem ||
      threads < 32 || threads > kRowsThreads || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(tile_attributes(ml_new_kernel(which), smem,
                                          device, ml_new_done[which], attrs,
                                          threads, kMlMaxSmem));
}

// The control: the first form's pass A, pass B and the row sum on
// `stream`, on mixed_large_split's N1 x N2. raw: (F, 2N) u8, 4-byte
// aligned; tw1, tw2: plan_twiddles of N1's and N2's plans, (rows, 2) f32;
// order1, order2: (N1,), (N2,) int32, element_of_bin of each plan;
// inter: (N1, N2) complex64, W_N^(k1 n2); window: (N,) f32, or null;
// scratch: (F, N) complex64; partial: (ceil(F / group_b), row) f32; out:
// (row,) f32, of which the first N are the bins (row: N rounded up to 32);
// plan1, plan2: the plans' ints (n, passes, radices). cols: columns a
// pass-A tile; rows: rows a pass-B tile; xs1, xs2: the tiles' strides.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_mixed_large_control(const void* raw, const void* tw1,
                              const void* order1, const void* inter,
                              const void* window, const void* tw2,
                              const void* order2, void* scratch,
                              void* partial, void* out, const int* plan1,
                              const int* plan2, int device, int F, int cols,
                              int xs1, int group_a, int rows, int xs2,
                              int group_b, int n_valid, void* stream) {
  TilePlan p1, p2;
  if (!read_tile_plan(plan1, &p1) || !read_tile_plan(plan2, &p2) ||
      F <= 0 || n_valid < 0 || n_valid > F || group_a <= 0 ||
      group_b <= 0 || cols < 1 || rows < 1 || xs1 < p1.n || xs2 < p2.n ||
      raw == nullptr || order1 == nullptr || order2 == nullptr ||
      reinterpret_cast<uintptr_t>(raw) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = p1.n * p2.n;
  const int row = (N + kSumBins - 1) / kSumBins * kSumBins;
  const int smem_a = tile_smem_bytes(cols, xs1, 0);
  const int smem_b = tile_smem_bytes(rows, xs2, 4 * p2.n);
  if (smem_a > kTileMaxSmem || smem_b > kTileMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool windowed = window != nullptr;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = tile_opt_in(ml_kernel(windowed ? 1 : 0), smem_a, device,
                    ml_done[windowed ? 1 : 0]);
  }
  if (e == cudaSuccess) e = tile_opt_in(ml_kernel(2), smem_b, device, ml_done[2]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_a = (p2.n + cols - 1) / cols;
  const int tiles_b = (p1.n + rows - 1) / rows;
  const int groups_b = (F + group_b - 1) / group_b;
  cols_kernel(windowed)<<<(F + group_a - 1) / group_a * tiles_a,
                          kTileThreads, smem_a, st>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float2*>(tw1),
      static_cast<const int*>(order1), static_cast<const float2*>(inter),
      static_cast<const float*>(window), nullptr,
      static_cast<float2*>(scratch), p1, p2.n, N, cols, xs1, F, group_a,
      n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_power_kernel<<<groups_b * tiles_b, kTileThreads, smem_b, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(tw2),
      static_cast<const int*>(order2), static_cast<float*>(partial), p2,
      p1.n, 1, p2.n, N, N, row, rows, xs2, F, group_b, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, groups_b, row, out, st));
}

// What a pass of the control gets with `smem` dynamic bytes on `device`
// (which: 0 pass A, 1 pass A windowed, 2 pass B), into attrs[0..5], as
// rpf_fused_psd_mixed_large_attributes. Launches nothing.
int rpf_fused_psd_mixed_large_control_attributes(int which, int smem,
                                                 int device, int* attrs) {
  if (which < 0 || which > 2 || smem < 0 || smem > kTileMaxSmem ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      tile_attributes(ml_kernel(which), smem, device, ml_done[which], attrs));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
