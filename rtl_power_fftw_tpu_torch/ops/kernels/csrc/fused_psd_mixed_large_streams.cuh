// ML's passes as both libraries that launch them compile them: the
// large mixed-radix kernel (fused_psd_mixed_large.cu, "ML") and the CLI
// estimators' forms of its passes (fused_psd_mixed_large_est.cu, SK-ML,
// MT-ML, PFB-ML). Here are the passes' shared parts (the butterfly loops
// ml_mid, ml_first and ml_last_store, the plan check read_ml_plan, the
// launch check ml_launch_ok and the shared bytes of each pass) and ML's
// streams passes ("ML-S": ml_streams_cols, ml_streams_rows, the stream on
// the grid's y axis, streams_block of large_streams.cuh), which the
// estimators' forms launch at S >= 1 streams. What they do, and why, is
// stated at the top of fused_psd_mixed_large.cu; the code is ML's own,
// moved here unchanged, so that both libraries compile it from one text.
// ML's one-stream passes (ml_cols_kernel, ml_rows_kernel) stay in
// fused_psd_mixed_large.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_mixed_tile.cuh"    // kTileMaxSmem
#include "frame_ring.cuh"
#include "fused_psd_mixed.cuh"   // kMixedMaxSmem, read by the ring's header
#include "fused_psd_mixed_ring.cuh"
#include "large_streams.cuh"
#include "psd_sum.cuh"

namespace {

// Threads a block of pass A; the most of pass B.
constexpr int kColsThreads = 256;
constexpr int kRowsThreads = 256;
// Dynamic shared bytes a block may have: the 227 KB less the static pass
// table (at most 256 bytes).
constexpr int kMlMaxSmem = kTileMaxSmem - 256;

// A pass of radix R in place, butterflies b = t + i tf < nb (i < rounds)
// of one transform whose element e is x[e * es]: (block, n2) = divmod(b, S)
// by the division constant, the elements block R S + n2 + n1 S, outputs
// times their twiddles (the pass's part of the table, row k1 S + n2).
template <int R>
__device__ __forceinline__ void ml_mid(float2* x, int es,
                                       const float2* __restrict__ tw, int S,
                                       unsigned magic, int nb, int rounds,
                                       int t, int tf) {
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
      for (int n1 = 0; n1 < R; ++n1) v[n1] = x[(base + n1 * S) * es];
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        x[(base + k1 * S) * es] =
            k1 == 0 ? v[0] : cmulf(v[k1], __ldg(tw + k1 * S + n2));
      }
    }
  }
}

// Pass A's pass 0 on column c of the tile: butterflies b = t + i tf < S =
// n1 / R over the samples b + m S of the ring slot (rows of 2C bytes),
// dequantized [and windowed: window[(b + m S) N2 + n2], n2 the column's],
// outputs k1 to element b + k1 S times W_n1^(b k1).
template <int R, bool WINDOWED>
__device__ __forceinline__ void ml_first(const uint8_t* slot, int row_bytes,
                                         const float* __restrict__ window,
                                         int n2_len, int n2,
                                         const float2* __restrict__ tw,
                                         float2* x, int es, int n1,
                                         int rounds, int t, int tf, int c) {
  const int S = n1 / R;
  const uint8_t* col = slot + 2 * c;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < S) {
      float2 v[R];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int row = b + m * S;
        v[m] = ring_sample<WINDOWED>(
            reinterpret_cast<const uint16_t*>(col + row * row_bytes), 0,
            WINDOWED ? __ldg(window + row * n2_len + n2) : 0.0f);
      }
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        x[(b + k1 * S) * es] =
            k1 == 0 ? v[0] : cmulf(v[k1], __ldg(tw + k1 * S + b));
      }
    }
  }
}

// Pass A's last pass on column c: butterfly b = t + i tf < n1 / R takes the
// elements b R + k; output k1 (element q = b R + k1, bin bin_of[q]) times
// its twiddle to the tile's run of scratch at bin * C + c.
template <int R>
__device__ __forceinline__ void ml_last_store(
    const float2* x, int es, const int* __restrict__ bin_of,
    const float2* __restrict__ inter, float2* __restrict__ out, int n1,
    int rounds, int t, int tf, int c) {
  const int nb = n1 / R;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < nb) {
      float2 v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = x[(b * R + k) * es];
      ring_dft<R>(v);
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        const int e = __ldg(bin_of + b * R + k1) * es + c;
        out[e] = cmulf(v[k1], __ldg(inter + e));
      }
    }
  }
}

// The plan ints (fused_psd_mixed.RingLaunch.ints) into p, checked: n up
// to max_n, tf a multiple of 32 or (pass A) tf * lanes = kColsThreads, the
// passes' strides, division constants, twiddle offsets and rounds what
// they must be, at least two passes.
inline bool read_ml_plan(const int* ints, int max_n, RingPlan* p) {
  if (ints == nullptr) return false;
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
  bool ok = P >= 2 && P <= kMixedMaxPasses && p->n >= 2 && p->n <= max_n &&
            p->tf >= 1 && p->lanes >= 1 && p->tf * p->lanes <= kRowsThreads &&
            (p->lanes & (p->lanes - 1)) == 0;
  int L = p->n;
  int offset = 0;
  for (int j = 0; ok && j < P; ++j) {
    const int r = p->radix[j];
    bool known = false;
    for (int m : kMixedRadices) known = known || r == m;
    ok = known && L % r == 0 && p->stride[j] == L / r &&
         p->twoff[j] == offset &&
         p->rounds[j] == (p->n / r + p->tf - 1) / p->tf &&
         static_cast<unsigned>(p->magic[j]) ==
             (L / r == 1 ? 0u
                         : static_cast<unsigned>(
                               (0x100000000ull + L / r - 1) / (L / r)));
    if (j < P - 1) offset += L;
    L /= r;
  }
  return ok && L == 1;
}


// ml_cols_kernel over S streams: block (x, s) as streams_block
// (large_streams.cuh); frame i of the block is frame first + i of the
// batch.
template <bool WINDOWED>
__global__ void __launch_bounds__(kColsThreads, 3)
ml_streams_cols(const uint8_t* __restrict__ raw,     // (S*F, 2N)
                const float2* __restrict__ twiddle,   // plan_twiddles(N1)
                const int* __restrict__ bin_of,       // (N1,) element -> bin
                const float2* __restrict__ inter,     // (N1, N2p) tile-major
                const float* __restrict__ window,     // (N,) or null
                float2* __restrict__ scratch,         // (S*F, N1, N2p)
                const RingPlan p, int log2c, int n2_len, int n2p, int width,
                int F, int group, int G_s, const int* __restrict__ counts) {
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
  // The block's frames through shared memory, read again after each
  // barrier: a count loaded from device memory and held in a register
  // across the loop spilled at this pass's 80 registers (one stream's
  // count is a kernel argument, which the compiler forms again).
  __shared__ int frames_s;
  const StreamsBlock blk = streams_block(tiles, F, group, G_s, counts);
  const int first = blk.first;
  if (tid == 0) frames_s = blk.frames;
  __syncthreads();
  const bool active = c0 + c < n2_len;
  const size_t frame_bytes = static_cast<size_t>(2) * n1 * n2_len;

  // Frame i's tile into ring slot i & 1: each row's 2C bytes (those of
  // columns below n2_len) in pieces of `width` = 1 << lw bytes.
  const int lw = width == 16 ? 4 : width == 8 ? 3 : 2;
  const int lp = log2c + 1 - lw;   // pieces a row: 1 << lp (2C >= width)
  auto prefetch = [&](int i) {
    if (i < frames_s) {
      const uint8_t* src = raw + (first + i) * frame_bytes + 2 * c0;
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
  for (int i = 0; i < frames_s; ++i) {
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
      float2* out = scratch + static_cast<size_t>(first + i) * n1 * n2p +
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

// ml_rows_kernel over S streams: block (x, s) as streams_block, its sums
// to partial row s G_s + x / tiles of `rows`.
template <int ACC>
__global__ void __launch_bounds__(kRowsThreads, 2)
ml_streams_rows(const float2* __restrict__ scratch,   // (S*F, N1, N2p)
                const float2* __restrict__ twiddle,   // plan_twiddles(N2)
                const int* __restrict__ order,        // (N2,) element of bin
                float* __restrict__ rows,             // (S*G_s, row)
                const RingPlan p, int n1_len, int log2c, int n2p, int F,
                int group, int G_s, const int* __restrict__ counts) {
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
  const StreamsBlock blk = streams_block(tiles, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
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
                          static_cast<size_t>(first + i) * n1_len * n2p +
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
  float* out = rows + static_cast<size_t>(blk.rest) * p.row;
  for (int j = tid; j < (n << ll); j += tf * lanes) {
    const int k2 = j >> ll;
    const int rr = j - (k2 << ll);
    if (rr < valid) {
      out[k0 + rr + k2 * n1_len] = by_elem[rr * n + __ldg(order + k2)];
    }
  }
}

// Shared bytes of pass A (exchange, then the ring's two slots) and pass B
// (the ring's two slots).
inline int ml_cols_smem(int n1, int log2c) {
  return n1 * (8 << log2c) + 2 * n1 * (2 << log2c);
}

inline int ml_rows_smem(int lanes, int n2p) { return 2 * lanes * n2p * 8; }

using MlStreamsCols = void (*)(const uint8_t*, const float2*, const int*,
                               const float2*, const float*, float2*,
                               const RingPlan, int, int, int, int, int, int,
                               int, const int*);
using MlStreamsRows = void (*)(const float2*, const float2*, const int*,
                               float*, const RingPlan, int, int, int, int,
                               int, int, const int*);

// The class of sums pass B takes for its plan: 2 (small) or 3 (large), or
// -1 where a thread would hold more than the large class.
int ml_rows_which(const RingPlan& p) {
  const int acc = p.rounds[p.passes - 1] * p.radix[p.passes - 1];
  return acc <= kRingAccSmall ? 2 : acc <= kRingAccLarge ? 3 : -1;
}

// The plans and the launch arguments both entries take, checked as
// rpf_fused_psd_mixed_large states them; into p1, p2 and which_b, smem_a,
// smem_b (pass B's class of sums and both passes' shared bytes).
bool ml_launch_ok(const void* raw, const void* bin1, const void* inter,
                  const void* order2, const int* plan1, const int* plan2,
                  int log2c, int n2p, int width, int F, int group_a,
                  int group_b, RingPlan* p1, RingPlan* p2, int* which_b,
                  int* smem_a, int* smem_b) {
  if (!read_ml_plan(plan1, 2048, p1) || !read_ml_plan(plan2, 16384, p2) ||
      log2c < 2 || log2c > 4 || p1->lanes != (1 << log2c) ||
      p1->tf * p1->lanes != kColsThreads || p2->n % 2 != 0 ||
      n2p % (1 << log2c) != 0 || n2p < p2->n ||
      n2p - p2->n >= (1 << log2c) || F <= 0 || group_a <= 0 ||
      group_b <= 0 || raw == nullptr || bin1 == nullptr ||
      order2 == nullptr || inter == nullptr ||
      (width != 4 && width != 8 && width != 16) || width > (2 << log2c) ||
      (2 * p2->n) % width != 0 ||
      reinterpret_cast<uintptr_t>(raw) % width != 0 ||
      p2->row % kSumBins != 0 || p2->row < p1->n * p2->n) {
    return false;
  }
  *which_b = ml_rows_which(*p2);
  *smem_a = ml_cols_smem(p1->n, log2c);
  *smem_b = ml_rows_smem(p2->lanes, n2p);
  return *which_b >= 0 && *smem_a <= kMlMaxSmem && *smem_b <= kMlMaxSmem;
}

}  // namespace
