// The passes over device memory of the large awkward-N kernels
// (fused_psd_mixed_large.cu, "ML"; fused_psd_chirp_large.cu, "BL"): tiles
// of several short transforms at once, each a run-time mixed-radix plan of
// fft_mixed.cuh (radix 2, 3, 4, 5, 7, 8, 16; decimation in frequency).
//
// A tile is `count` transforms of length n in shared memory, transform c's
// element e at x[c * xs + pad_index(e)] (xs: tile_stride, odd, so that the
// transforms of a warp's reads by transform fall on different banks). All
// threads of the block run each pass over the tile's butterflies, one
// barrier between passes; after the last pass element q of a transform
// holds the bin whose mixed-radix digits are q's in reverse (the host's
// fused_psd_mixed.element_of_bin gives, for each bin, its element: the
// `order` tables here).
//
// Two kernels of the four-step form over a frame of n1 x n2 complex values
// (index n = n1 * n2_len + n2; a frame's scratch is row-major, (k1, n2)
// at k1 * n2_len + n2):
//  * tile_cols_kernel<WINDOWED, CHIRP>: pass A. Block b takes columns
//    [c0, c0 + count) of frames [j * group, min((j + 1) * group, F,
//    n_valid)): it reads each column's samples (u8 - 127, [x window], for
//    the chirp-Z kernel x the chirp a[n], or 0 where n >= bins), runs the
//    length-n1 transform of each and writes Y[k1][n2] x inter[k1][n2]
//    (the inter-stage twiddle table, natural order) to the frame's
//    scratch, a warp's stores by n2 adjacent;
//  * tile_power_kernel: the last pass. Block b takes transforms [t0, t0
//    + count) of the frame's T, each of length n read at element stride
//    `estride` and transform stride `tstride` from a frame of `frame`
//    complex values, over frames [g * group, min((g + 1) * group, F,
//    n_valid)); |X|^2 summed over them in shared memory, then written to
//    partial row g at bin t + T * k (k the transform's bin) where that is
//    below `bins`. ML's pass B runs it over rows (T = N1, estride 1), BL's
//    pass C over columns (T = M2, estride M2).
// No float atomics: each partial row's bins are written by one block, and
// psd_sum.cuh adds the rows in a fixed order in float64.
//
// A first form, correct and plain: its speed is measured, not tuned (the
// division of its loop indices, bank conflicts of the strided reads, one
// frame at a time with nothing in flight).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fft_mixed.cuh"
#include "frame_ring.cuh"  // ring_sample

namespace {

// Threads a block of every tile kernel.
constexpr int kTileThreads = 256;
// Dynamic shared bytes a block may have: the 227 KB of a Hopper block.
constexpr int kTileMaxSmem = 232448;
// Longest transform of a tile.
constexpr int kTileMaxN = 16384;

// A run-time plan: the wrapper's ints (fused_psd_mixed_large.tile_ints):
// n, the passes, their radices (0 past the last).
struct TilePlan {
  int n;
  int passes;
  int radix[kMixedMaxPasses];
};
constexpr int kTilePlanInts = 2 + kMixedMaxPasses;

// A pass of radix R in place on the tile, by all nt threads: butterfly
// (c, b) over transform c's elements base + n1 * S, outputs times the
// pass's twiddles (row k1 * S + n2 of `tw`) unless `tw` is null (the last
// pass).
template <int R>
__device__ __forceinline__ void tile_pass(float2* x, int xs, int count, int n,
                                          int L, const float2* __restrict__ tw,
                                          int tid, int nt) {
  const int S = L / R;
  const int nb = n / R;
  for (int w = tid; w < count * nb; w += nt) {
    const int c = w / nb;
    const int b = w - c * nb;
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
    float2* y = x + c * xs;
    float2 v[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) v[n1] = y[pad_index(base + n1 * S)];
    dft_natural<R>(v);
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      y[pad_index(base + k1 * S)] =
          (tw == nullptr || k1 == 0) ? v[k1]
                                     : cmulf(v[k1], __ldg(tw + k1 * S + n2));
    }
  }
}

// Every pass of the plan on the tile, a barrier after each. `tw`: the
// plan's twiddles (fused_psd_mixed.plan_twiddles), pass j's at the sum of
// the spans before it.
__device__ __forceinline__ void tile_transform(float2* x, int xs, int count,
                                               const TilePlan& p,
                                               const float2* __restrict__ tw,
                                               int tid, int nt) {
  int L = p.n;
  int offset = 0;
  for (int j = 0; j < p.passes; ++j) {
    const int r = p.radix[j];
    const float2* t = j == p.passes - 1 ? nullptr : tw + offset;
    with_radix(r, [&](auto rc) {
      tile_pass<decltype(rc)::value>(x, xs, count, p.n, L, t, tid, nt);
    });
    __syncthreads();
    offset += L;
    L /= r;
  }
}

// Pass A (see the top of the file). raw: (F, 2 * bins) u8; frames hold
// n1 * n2_len samples for ML (bins = n1 * n2_len) and bins < that for BL,
// whose samples n >= bins are 0. chirp: (bins,) complex64 a, for CHIRP.
template <bool WINDOWED, bool CHIRP>
__global__ void __launch_bounds__(kTileThreads)
tile_cols_kernel(const uint8_t* __restrict__ raw,
                 const float2* __restrict__ twiddle,  // plan_twiddles(n1)
                 const int* __restrict__ order,       // (n1,) element of bin
                 const float2* __restrict__ inter,    // (n1, n2_len)
                 const float* __restrict__ window,    // (bins,) or null
                 const float2* __restrict__ chirp,    // (bins,) or null
                 float2* __restrict__ scratch,        // (F, n1 * n2_len)
                 const TilePlan p, int n2_len, int bins, int count, int xs,
                 int F, int group, int n_valid) {
  extern __shared__ float4 tile_smem[];
  float2* x = reinterpret_cast<float2*>(tile_smem);
  const int n1 = p.n;
  const int frame = n1 * n2_len;
  const int tid = threadIdx.x;
  const int tiles = (n2_len + count - 1) / count;
  const int c0 = (blockIdx.x % tiles) * count;
  const int cols = min(count, n2_len - c0);
  const int f0 = (blockIdx.x / tiles) * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  for (int f = f0; f < f1; ++f) {
    const uint16_t* iq = reinterpret_cast<const uint16_t*>(
        raw + static_cast<size_t>(f) * 2 * bins);
    for (int i = tid; i < n1 * cols; i += kTileThreads) {
      const int row = i / cols;
      const int c = i - row * cols;
      const int s = row * n2_len + c0 + c;
      float2 v = make_float2(0.0f, 0.0f);
      if (!CHIRP || s < bins) {
        v = ring_sample<WINDOWED>(iq, s, WINDOWED ? __ldg(window + s) : 0.0f);
        if constexpr (CHIRP) v = cmulf(v, __ldg(chirp + s));
      }
      x[c * xs + pad_index(row)] = v;
    }
    __syncthreads();
    tile_transform(x, xs, cols, p, twiddle, tid, kTileThreads);
    float2* out = scratch + static_cast<size_t>(f) * frame;
    for (int i = tid; i < n1 * cols; i += kTileThreads) {
      const int k1 = i / cols;
      const int c = i - k1 * cols;
      const int e = k1 * n2_len + c0 + c;
      out[e] = cmulf(x[c * xs + pad_index(__ldg(order + k1))],
                     __ldg(inter + e));
    }
    __syncthreads();   // x is free for the next frame
  }
}

// The last pass (see the top of the file). src: (F, frame) complex64;
// partial: (ceil(F / group), row) f32, bins [bins, row) written 0 by the
// blocks of transform tile 0.
__global__ void __launch_bounds__(kTileThreads)
tile_power_kernel(const float2* __restrict__ src,
                  const float2* __restrict__ twiddle,  // plan_twiddles(n)
                  const int* __restrict__ order,       // (n,) element of bin
                  float* __restrict__ partial,
                  const TilePlan p, int T, int estride, int tstride,
                  int frame, int bins, int row, int count, int xs, int F,
                  int group, int n_valid) {
  extern __shared__ float4 tile_smem[];
  const int n = p.n;
  const int tid = threadIdx.x;
  float2* x = reinterpret_cast<float2*>(tile_smem);
  float* acc = reinterpret_cast<float*>(x + count * xs);   // (count, n)
  const int tiles = (T + count - 1) / count;
  const int t0 = (blockIdx.x % tiles) * count;
  const int cnt = min(count, T - t0);
  const int g = blockIdx.x / tiles;
  const int f0 = g * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  for (int i = tid; i < cnt * n; i += kTileThreads) acc[i] = 0.0f;
  // Reads go by transform where the elements are far apart (estride > 1),
  // else by element, so that a warp's loads are adjacent either way.
  const bool by_t = estride != 1;
  for (int f = f0; f < f1; ++f) {
    const float2* in = src + static_cast<size_t>(f) * frame;
    for (int i = tid; i < cnt * n; i += kTileThreads) {
      const int c = by_t ? i % cnt : i / n;
      const int e = by_t ? i / cnt : i % n;
      x[c * xs + pad_index(e)] = in[(t0 + c) * tstride + e * estride];
    }
    __syncthreads();
    tile_transform(x, xs, cnt, p, twiddle, tid, kTileThreads);
    for (int i = tid; i < cnt * n; i += kTileThreads) {
      const int c = i / n;
      acc[i] += norm2(x[c * xs + pad_index(i - c * n)]);
    }
    __syncthreads();   // x is free for the next frame
  }
  float* out = partial + static_cast<size_t>(g) * row;
  for (int i = tid; i < cnt * n; i += kTileThreads) {
    const int k = i / cnt;
    const int c = i - k * cnt;
    const int bin = t0 + c + T * k;
    if (bin < bins) out[bin] = acc[c * n + __ldg(order + k)];
  }
  if (t0 == 0) {
    for (int bin = bins + tid; bin < row; bin += kTileThreads) out[bin] = 0.0f;
  }
}

// Where a tile kernel's launch has more than the 48 KB default of dynamic
// shared memory, opts it into `max_smem` (kTileMaxSmem, less a kernel's
// static shared bytes), once per device for each slot of `done` (bit d for
// device d < 64; a device beyond that sets it every call).
inline cudaError_t tile_opt_in(const void* kernel, int smem, int device,
                               std::atomic<unsigned long long>& done,
                               int max_smem = kTileMaxSmem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  done.fetch_or(bit, std::memory_order_relaxed);
  return cudaSuccess;
}

// What a kernel of `threads` a block (a tile kernel's kTileThreads by
// default) gets with `smem` dynamic bytes on `device`, into attrs[0..5]:
// registers and spill bytes a thread, static and dynamic shared bytes a
// block, threads a block, and the blocks that reside on one SM. Launches
// nothing.
inline cudaError_t tile_attributes(const void* kernel, int smem, int device,
                                   std::atomic<unsigned long long>& done,
                                   int* attrs, int threads = kTileThreads,
                                   int max_smem = kTileMaxSmem) {
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) e = tile_opt_in(kernel, smem, device, done, max_smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) {
    attrs[0] = fa.numRegs;
    attrs[1] = static_cast<int>(fa.localSizeBytes);
    attrs[2] = static_cast<int>(fa.sharedSizeBytes);
    attrs[3] = smem;
    attrs[4] = threads;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[5], kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// The plan ints into p, checked: 1..kMixedMaxPasses passes of the kernels'
// radices whose product is n, 2 <= n <= kTileMaxN.
inline bool read_tile_plan(const int* ints, TilePlan* p) {
  if (ints == nullptr) return false;
  p->n = ints[0];
  p->passes = ints[1];
  if (p->n < 2 || p->n > kTileMaxN || p->passes < 1 ||
      p->passes > kMixedMaxPasses) {
    return false;
  }
  int L = p->n;
  for (int j = 0; j < kMixedMaxPasses; ++j) {
    const int r = ints[2 + j];
    p->radix[j] = r;
    if (j >= p->passes) continue;
    bool known = false;
    for (int m : kMixedRadices) known = known || r == m;
    if (!known || L % r != 0) return false;
    L /= r;
  }
  return L == 1;
}

// Shared bytes of a tile of `count` transforms of stride xs, with a second
// array of `extra` bytes a transform.
inline int tile_smem_bytes(int count, int xs, int extra) {
  return count * (xs * 8 + extra);
}

}  // namespace
