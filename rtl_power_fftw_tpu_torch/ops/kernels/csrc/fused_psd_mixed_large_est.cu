// The CLI estimators' device steps at the large even 7-smooth bin counts,
// for NVIDIA Hopper (sm_90a): spectral kurtosis (SK-ML), the multitaper
// (MT-ML) and the polyphase filterbank (PFB-ML) on ML's two passes
// (fused_psd_mixed_large.cu), at every even 7-smooth N from 16386 to 2^22
// that is not a power of two (20000, 49152, 100000, 10^6, 4167450 among
// the 1192). Each form takes S >= 1 streams of F frames, (S*F, 2N), with
// an (S,) count array on the device; the one-stream steps call it at S = 1.
//
// They replace no Pallas kernel: the JAX package computes these estimators
// in XLA at every N (rtl_power_fftw_tpu/models/kurtosis.py:_sk_step 46-93,
// multitaper.py:_mt_core 60-133, pfb.py:_pfb_core 48-89, and their sharded
// steps; at these N its transform is XLA's FFT). The function of each is
// the one its forms at the other N compute (fused_psd_large_est.cu):
//
//   SK-ML   s1 = sum over valid frames of |X|^2 and s2 = sum of |X|^4,
//           (S, 2, N); with two_sigma > 0 (--sk-excise) also each stream's
//           gate on its own SK, s1 * keep and n_valid * keep, (S, 4, N);
//   MT-ML   the sum over valid frames of the mean over K tapers of
//           |DFT(x * taper_k)|^2, (S, N);
//   PFB-ML  the sum over output frames j < n_valid of |DFT(S_j)|^2, S_j[n]
//           = sum over p = 0 .. P-1, in that order from zero, of h[p, n] *
//           x_{j+p}[n] (each product and sum rounded on its own) over each
//           stream's virtual array of P - 1 history rows and F frames; each
//           stream's next history written to history_out on the stream.
//
// Each changes ML only where its function differs. The passes are ML's
// streams passes ("ML-S", fused_psd_mixed_large_streams.cuh:
// ml_streams_cols/rows, the stream on the grid's y axis, the counts read
// on the card) but for:
//
//   SK-ML   pass B: ml_sk_rows keeps a sum of |X|^4 beside each sum of
//           |X|^2 (ring_last_sk: the |X|^2 sums are ring_last's own
//           expression, so on ML's grid s1 is ML's output bit for bit) and
//           writes it to a second plane of partial rows, (2, S G_s, row),
//           both staged by element through shared memory as pass B stages
//           its one plane; est_streams_kernel (fused_psd_est.cuh) adds each
//           stream's rows in psd_sum.cuh's order, with the gate of
//           --sk-excise; with one group a stream and no gate pass B writes
//           the (S, 2, row) output itself, as ML's pass B writes its one
//           row. The large class of sums (kRingAccLarge, 36 a thread) holds
//           72 sums: its pass B runs one block an SM (255 registers), the
//           small class (16 and 16) two, as ML's;
//   MT-ML   a taper loop: pass A windowed by taper row k of the (K, N)
//           table, then pass B, once a taper over one (S F, N1, N2p)
//           scratch, which the next taper's pass A overwrites (~270 MB at
//           F = 8, N = 4167450; the taper on the grid would take K times
//           that); taper k's pass B writes partial row (k S + s) G_s + j,
//           and est_streams_kernel<kEstTapers> sums each stream's K G_s
//           rows and divides by K. Each frame is read K times;
//   PFB-ML  pass A: ml_pfb_cols's pass 0 forms the polyphase sums before
//           the column transform, tap by tap over a butterfly's R samples:
//           the frame's own tile from the cp.async ring (p = P - 1), the
//           P - 1 older rows from the history or the earlier frames and h
//           (P, N) through L1/L2, a half-warp's loads on its C adjacent
//           columns (2C bytes of a row, 4C bytes of h). The next histories
//           are launch_pfb_history's (pfb_history.cuh: its wide kernel for
//           rows of 2N >= 64 KB, N >= 32768).
//
// The plans are run-time, as ML's: the entries take ML's plan ints and
// tables, and its grid (the wrapper takes ML's residency), so SK-ML's s1
// at S = 1 is ML's output and each stream's rows are the S = 1 form's on
// the same groups.
//
// What bounds them on an H100: ML's bound (the frames' 2 bytes a sample;
// the form moves 8N bytes of scratch a frame each way, which the bound of
// the function does not count), times K passes for MT-ML, and plus the
// P - 1 older rows and h through L1/L2 for PFB-ML.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_mixed_large_streams.cuh"
#include "large_streams.cuh"
#include "pfb_history.cuh"
#include "psd_sum.cuh"

namespace {

// ring_last with SK's second sum: |.|^2 of output k1 added to acc[i R +
// k1] by ring_last's own expression, its square to acc2[i R + k1].
template <int R, int ACC>
__device__ __forceinline__ void ring_last_sk(const float2* x,
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
      for (int k = 0; k < R; ++k) v[k] = x[b * R + k];
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

// SK-ML's pass B: ml_streams_rows with a sum of |X|^4 beside each sum of
// |X|^2, the s1 row of block (x, s) to row r = s G_s + x / tiles of `rows`
// (at r * row_stride) and the s2 row plane_stride floats after it, each
// staged by element through shared memory as pass B stages its row:
// partial rows (2, S*G_s, row) with row_stride row and plane_stride S G_s
// row, or, with one group a stream, the (S, 2, row) output itself,
// row_stride 2 row and plane_stride row.
template <int ACC>
__global__ void __launch_bounds__(kRowsThreads, ACC == kRingAccLarge ? 1 : 2)
ml_sk_rows(const float2* __restrict__ scratch,   // (S*F, N1, N2p)
           const float2* __restrict__ twiddle,   // plan_twiddles(N2)
           const int* __restrict__ order,        // (N2,) element of bin
           float* __restrict__ rows, const RingPlan p, int n1_len, int log2c,
           int n2p, int F, int group, int G_s,
           const int* __restrict__ counts, int row_stride,
           int plane_stride) {
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

  // Frame i's rows into slot i & 1, as ml_streams_rows copies them.
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
  float acc2[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) {
    acc[k] = 0.0f;
    acc2[k] = 0.0f;
  }
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
        ring_last_sk<decltype(rc)::value, ACC>(x, acc, acc2, n, t, tf);
      });
    }
  }
  cp_async_wait<0>();

  // Each plane's sums at their elements, then bin k1 + N1 k2 of each row,
  // as ml_streams_rows writes its one plane.
  float* by_elem = reinterpret_cast<float*>(ml_smem);   // (lanes, n)
  auto write_plane = [&](const float (&a)[ACC], int plane) {
    __syncthreads();   // every lane is done with the ring (the last plane)
    if (active) {
      with_radix(tab[P - 1].x, [&](auto rc) {
        ring_gather<decltype(rc)::value, ACC>(by_elem + r * n, a, n, t, tf);
      });
    }
    __syncthreads();
    float* out = rows + static_cast<size_t>(plane) * plane_stride +
                 static_cast<size_t>(blk.rest) * row_stride;
    for (int j = tid; j < (n << ll); j += tf * lanes) {
      const int k2 = j >> ll;
      const int rr = j - (k2 << ll);
      if (rr < valid) {
        out[k0 + rr + k2 * n1_len] = by_elem[rr * n + __ldg(order + k2)];
      }
    }
  };
  write_plane(acc, 0);
  write_plane(acc2, 1);
}

// PFB-ML's pass 0 on column c of the tile (ml_first's butterflies):
// butterfly b = t + i tf < S = n1 / R takes the polyphase sums of the
// samples n = (b + m S) N2 + n2 of output frame j, tap by tap (p in order
// from zero, each product and sum rounded on its own, pfb_sample's
// arithmetic), so that a thread has R loads of a tap's row and of h in
// flight at once: the P - 1 older rows from virtual row j + p (row r <
// P - 1 of `history`, else frame r - (P - 1) of `frames`), the frame's own
// row (p = P - 1) from the ring slot (rows of 2C bytes).
template <int R>
__device__ __forceinline__ void ml_pfb_first(
    const uint8_t* slot, int row_bytes, const uint8_t* __restrict__ frames,
    const uint8_t* __restrict__ history, const float* __restrict__ h, int j,
    int taps, int bins, int n2_len, int n2, const float2* __restrict__ tw,
    float2* x, int es, int n1, int rounds, int t, int tf, int c) {
  const int S = n1 / R;
  const uint8_t* col = slot + 2 * c;
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int b = t + i * tf;
    if (b < S) {
      float2 v[R];
#pragma unroll
      for (int m = 0; m < R; ++m) v[m] = make_float2(0.0f, 0.0f);
      for (int p = 0; p < taps; ++p) {
        const float* hp = h + static_cast<size_t>(p) * bins + n2;
        if (p < taps - 1) {
          const int r = j + p;   // virtual row: history, then frames
          const uint16_t* rowp =
              reinterpret_cast<const uint16_t*>(
                  r < taps - 1
                      ? history + static_cast<size_t>(r) * 2 * bins
                      : frames + static_cast<size_t>(r - (taps - 1)) * 2 *
                                     bins) +
              n2;
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const int off = (b + m * S) * n2_len;
            const unsigned u = __ldg(rowp + off);
            const float hv = __ldg(hp + off);
            v[m].x = __fadd_rn(v[m].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
            v[m].y = __fadd_rn(v[m].y, __fmul_rn(dequant_byte(u >> 8), hv));
          }
        } else {
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const int row = b + m * S;
            const unsigned u =
                *reinterpret_cast<const uint16_t*>(col + row * row_bytes);
            const float hv = __ldg(hp + row * n2_len);
            v[m].x = __fadd_rn(v[m].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
            v[m].y = __fadd_rn(v[m].y, __fmul_rn(dequant_byte(u >> 8), hv));
          }
        }
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

// PFB-ML's pass A: ml_streams_cols with ml_pfb_first for pass 0. Block
// (x, s) as streams_block; frame i of the block is output frame j = f0 + i
// of stream s, whose own tile the ring holds; `history` is (S, P - 1, 2N)
// (null at P = 1), stream s's rows at s (P - 1) 2N.
__global__ void __launch_bounds__(kColsThreads, 3)
ml_pfb_cols(const uint8_t* __restrict__ raw,       // (S*F, 2N)
            const uint8_t* __restrict__ history,   // (S, P-1, 2N)
            const float* __restrict__ h,           // (P, N)
            const float2* __restrict__ twiddle,    // plan_twiddles(N1)
            const int* __restrict__ bin_of,        // (N1,) element -> bin
            const float2* __restrict__ inter,      // (N1, N2p) tile-major
            float2* __restrict__ scratch,          // (S*F, N1, N2p)
            const RingPlan p, int log2c, int n2_len, int n2p, int width,
            int F, int group, int G_s, const int* __restrict__ counts,
            int taps) {
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
  // The block's frames through shared memory, as ml_streams_cols reads
  // them.
  __shared__ int frames_s;
  const StreamsBlock blk = streams_block(tiles, F, group, G_s, counts);
  const int first = blk.first;
  if (tid == 0) frames_s = blk.frames;
  __syncthreads();
  const bool active = c0 + c < n2_len;
  const int bins = n1 * n2_len;
  const size_t frame_bytes = static_cast<size_t>(2) * bins;
  const int stream = blockIdx.y;
  const int j0 = first - stream * F;
  const uint8_t* own_frames = raw + static_cast<size_t>(stream) * F *
                                        frame_bytes;
  const uint8_t* older =
      taps > 1 ? history + static_cast<size_t>(stream) * (taps - 1) *
                               frame_bytes
               : nullptr;

  // Frame i's tile into ring slot i & 1, as ml_streams_cols copies it.
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
        ml_pfb_first<decltype(rc)::value>(
            slot, row_bytes, own_frames, older, h, j0 + i, taps, bins, n2_len,
            c0 + c, twiddle, x + c, C, n1, tab_rounds[0], t, tf, c);
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

using MlSkRows = void (*)(const float2*, const float2*, const int*, float*,
                          const RingPlan, int, int, int, int, int, int,
                          const int*, int, int);

// The passes of this library, as the attributes entry numbers them: ML-S's
// pass A unwindowed (0) and windowed (1), its pass B with the small (2)
// and the large (3) class of sums, the forms' own SK pass B with the small
// (4) and the large (5) class, and the PFB's pass A (6).
constexpr int kPasses = 7;

const void* pass_kernel(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(ml_streams_cols<false>);
    case 1: return reinterpret_cast<const void*>(ml_streams_cols<true>);
    case 2: return reinterpret_cast<const void*>(ml_streams_rows<kRingAccSmall>);
    case 3: return reinterpret_cast<const void*>(ml_streams_rows<kRingAccLarge>);
    case 4: return reinterpret_cast<const void*>(ml_sk_rows<kRingAccSmall>);
    case 5: return reinterpret_cast<const void*>(ml_sk_rows<kRingAccLarge>);
    default: return reinterpret_cast<const void*>(ml_pfb_cols);
  }
}

// The devices (a bit each) on which a pass is opted into the largest
// shared memory, as ML's entries opt its passes in.
std::atomic<unsigned long long> pass_done[kPasses];

cudaError_t prepare(int which, int smem, int device) {
  return tile_opt_in(pass_kernel(which), smem, device, pass_done[which],
                     kMlMaxSmem);
}

// A form's launch: S streams of F frames, frames a block of passes A and
// B, the counts on the card, ML's plans, tables and buffers.
struct Launch {
  const uint8_t* raw;
  const float2* tw1;
  const int* bin1;
  const float2* inter;
  const float2* tw2;
  const int* order2;
  const int* counts;
  float2* scratch;
  RingPlan p1, p2;
  int which_b, smem_a, smem_b;
  int log2c, n2p, width, S, F, group_a, group_b;
  cudaStream_t st;

  int g_a() const { return (F + group_a - 1) / group_a; }
  int g_b() const { return (F + group_b - 1) / group_b; }
  int tiles_a() const { return n2p >> log2c; }
  int tiles_b() const { return (p1.n + p2.lanes - 1) / p2.lanes; }
  int row() const { return p2.row; }
  int bins() const { return p1.n * p2.n; }
};

// Pass A as ML-S runs it (windowed by `window` where given), on `l.st`.
cudaError_t launch_a(const Launch& l, const float* window, int device) {
  const int which = window != nullptr ? 1 : 0;
  const cudaError_t e = prepare(which, l.smem_a, device);
  if (e != cudaSuccess) return e;
  const MlStreamsCols cols =
      window != nullptr ? ml_streams_cols<true> : ml_streams_cols<false>;
  cols<<<dim3(l.g_a() * l.tiles_a(), l.S), kColsThreads, l.smem_a, l.st>>>(
      l.raw, l.tw1, l.bin1, l.inter, window, l.scratch, l.p1, l.log2c,
      l.p2.n, l.n2p, l.width, l.F, l.group_a, l.g_a(), l.counts);
  return cudaGetLastError();
}

// Pass B as ML-S runs it, each stream's partial rows to `rows`, on `l.st`.
cudaError_t launch_b(const Launch& l, float* rows, int device) {
  const cudaError_t e = prepare(l.which_b, l.smem_b, device);
  if (e != cudaSuccess) return e;
  const MlStreamsRows pass_b = l.which_b == 2
                                   ? ml_streams_rows<kRingAccSmall>
                                   : ml_streams_rows<kRingAccLarge>;
  pass_b<<<dim3(l.g_b() * l.tiles_b(), l.S), l.p2.tf * l.p2.lanes, l.smem_b,
           l.st>>>(l.scratch, l.tw2, l.order2, rows, l.p2, l.p1.n, l.log2c,
                   l.n2p, l.F, l.group_b, l.g_b(), l.counts);
  return cudaGetLastError();
}

// SK-ML: pass A, SK's pass B and, with the gate or more than one group a
// stream, the sum of each stream's rows; else pass B writes the output
// rows itself (a float64 sum of one row from 0.0 is that row).
cudaError_t launch_sk(const Launch& l, const float* window, float* partial,
                      float* out, float two_sigma, int device) {
  cudaError_t e = launch_a(l, window, device);
  const int which = l.which_b + 2;
  if (e == cudaSuccess) e = prepare(which, l.smem_b, device);
  if (e != cudaSuccess) return e;
  const bool direct = two_sigma == 0.0f && l.g_b() == 1;
  const int row = l.row();
  const MlSkRows pass_b = which == 4 ? ml_sk_rows<kRingAccSmall>
                                     : ml_sk_rows<kRingAccLarge>;
  pass_b<<<dim3(l.g_b() * l.tiles_b(), l.S), l.p2.tf * l.p2.lanes, l.smem_b,
           l.st>>>(l.scratch, l.tw2, l.order2, direct ? out : partial, l.p2,
                   l.p1.n, l.log2c, l.n2p, l.F, l.group_b, l.g_b(), l.counts,
                   direct ? 2 * row : row, direct ? row : l.S * l.g_b() * row);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return two_sigma > 0.0f
             ? launch_est_streams<kEstSkGate>(partial, l.S, l.g_b(), 1, row,
                                              l.counts, l.F, 0, two_sigma,
                                              out, l.st)
             : launch_est_streams<kEstSk>(partial, l.S, l.g_b(), 1, row,
                                          l.counts, l.F, 0, two_sigma, out,
                                          l.st);
}

cudaError_t launch_tapers(const Launch& l, const float* tapers, int K,
                          float* partial, float* out, int device) {
  const size_t plane = static_cast<size_t>(l.S) * l.g_b() * l.row();
  for (int k = 0; k < K; ++k) {
    cudaError_t e = launch_a(
        l, tapers + static_cast<size_t>(k) * l.bins(), device);
    if (e == cudaSuccess) e = launch_b(l, partial + k * plane, device);
    if (e != cudaSuccess) return e;
  }
  return launch_est_streams<kEstTapers>(partial, l.S, l.g_b(), K, l.row(),
                                        l.counts, l.F, K, 0.0f, out, l.st);
}

cudaError_t launch_pfb(const Launch& l, const uint8_t* history,
                       const float* h, int P, float* partial, float* out,
                       int device) {
  cudaError_t e = prepare(6, l.smem_a, device);
  if (e != cudaSuccess) return e;
  ml_pfb_cols<<<dim3(l.g_a() * l.tiles_a(), l.S), kColsThreads, l.smem_a,
                l.st>>>(l.raw, history, h, l.tw1, l.bin1, l.inter,
                        l.scratch, l.p1, l.log2c, l.p2.n, l.n2p, l.width,
                        l.F, l.group_a, l.g_a(), l.counts, P);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_b(l, l.g_b() == 1 ? out : partial, device);
  if (e != cudaSuccess || l.g_b() == 1) return e;
  return launch_rows_sum(partial, l.S, l.g_b(), l.row(), out, l.st);
}

// The launch, its plans read and checked as ML's streams entry checks
// them (ml_launch_ok), and S, the counts and the scratch; false if any
// fails.
bool make_launch(const void* raw, const void* tw1, const void* bin1,
                 const void* inter, const void* tw2, const void* order2,
                 const void* counts, void* scratch, const int* plan1,
                 const int* plan2, int log2c, int n2p, int width, int S,
                 int F, int group_a, int group_b, void* stream, Launch* l) {
  *l = Launch{static_cast<const uint8_t*>(raw),
              static_cast<const float2*>(tw1),
              static_cast<const int*>(bin1),
              static_cast<const float2*>(inter),
              static_cast<const float2*>(tw2),
              static_cast<const int*>(order2),
              static_cast<const int*>(counts),
              static_cast<float2*>(scratch),
              {}, {}, 0, 0, 0,
              log2c, n2p, width, S, F, group_a, group_b,
              static_cast<cudaStream_t>(stream)};
  return ml_launch_ok(raw, bin1, inter, order2, plan1, plan2, log2c, n2p,
                      width, F, group_a, group_b, &l->p1, &l->p2,
                      &l->which_b, &l->smem_a, &l->smem_b) &&
         S > 0 && S <= kMaxGridY && counts != nullptr && scratch != nullptr &&
         tw1 != nullptr && tw2 != nullptr;
}

}  // namespace

extern "C" {

// SK-ML: launches pass A, SK's pass B and the sum on `stream`. raw: (S*F,
// 2N) u8, `width`-byte aligned (fused_psd_mixed_large.ml_copy_width),
// stream s in rows [s F, s F + F); tw1, bin1, inter, tw2, order2, plan1,
// plan2, log2c, n2p: ML's tables and plans (rpf_fused_psd_mixed_large);
// window: (N,) f32, or null; counts: (S,) int32 on the device, each
// stream's valid frames (read when the passes run; a count outside [0, F]
// acts as its nearest bound); scratch: (S*F, N1, N2p) complex64; partial:
// (2, S * ceil(F / group_b), row) f32; out: (S, 2, row) f32 (s1, s2 of
// each stream), or with two_sigma > 0 (S, 4, row), each stream gated on
// its own moments and count; row: N rounded up to kSumBins. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk_mixed_large(
    const void* raw, const void* tw1, const void* bin1, const void* inter,
    const void* window, const void* tw2, const void* order2,
    const void* counts, void* scratch, void* partial, void* out,
    const int* plan1, const int* plan2, int device, int log2c, int n2p,
    int width, int S, int F, int group_a, int group_b, float two_sigma,
    void* stream) {
  Launch l;
  if (!make_launch(raw, tw1, bin1, inter, tw2, order2, counts, scratch,
                   plan1, plan2, log2c, n2p, width, S, F, group_a, group_b,
                   stream, &l) ||
      !(two_sigma >= 0.0f) || partial == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = launch_sk(l, static_cast<const float*>(window),
                  static_cast<float*>(partial), static_cast<float*>(out),
                  two_sigma, device);
  }
  return static_cast<int>(e);
}

// MT-ML: tapers: (K, N) f32, 1 <= K <= 32, shared by the streams; partial:
// (K, S * ceil(F / group_b), row) f32; out: (S, row) f32. Other arguments
// as rpf_fused_psd_sk_mixed_large.
int rpf_fused_psd_tapers_mixed_large(
    const void* raw, const void* tw1, const void* bin1, const void* inter,
    const void* tapers, const void* tw2, const void* order2,
    const void* counts, void* scratch, void* partial, void* out,
    const int* plan1, const int* plan2, int device, int log2c, int n2p,
    int width, int S, int F, int group_a, int group_b, int K, void* stream) {
  Launch l;
  if (!make_launch(raw, tw1, bin1, inter, tw2, order2, counts, scratch,
                   plan1, plan2, log2c, n2p, width, S, F, group_a, group_b,
                   stream, &l) ||
      K < 1 || K > 32 || tapers == nullptr || partial == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = launch_tapers(l, static_cast<const float*>(tapers), K,
                      static_cast<float*>(partial), static_cast<float*>(out),
                      device);
  }
  return static_cast<int>(e);
}

// PFB-ML: history, history_out: (S, P - 1, 2N) u8, distinct, 4-byte
// aligned (null when P = 1), stream s's rows together; h: (P, N) f32, 1 <=
// P <= 32; partial: (S * ceil(F / group_b), row) f32 (unused for one row a
// stream); out: (S, row) f32; fresh: set every stream's history to byte
// 127 first. After the sum, each stream's next history (rows n_valid[s] ..
// n_valid[s] + P - 2 of its virtual array) is written to history_out on
// the stream (pfb_history.cuh). Other arguments as
// rpf_fused_psd_sk_mixed_large.
int rpf_fused_psd_pfb_mixed_large(
    const void* raw, const void* history, const void* tw1, const void* bin1,
    const void* inter, const void* h, const void* tw2, const void* order2,
    const void* counts, void* scratch, void* partial, void* out,
    void* history_out, const int* plan1, const int* plan2, int device,
    int log2c, int n2p, int width, int S, int F, int group_a, int group_b,
    int P, int fresh, void* stream) {
  Launch l;
  if (!make_launch(raw, tw1, bin1, inter, tw2, order2, counts, scratch,
                   plan1, plan2, log2c, n2p, width, S, F, group_a, group_b,
                   stream, &l) ||
      P < 1 || P > 32 || h == nullptr || out == nullptr ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out ||
                 reinterpret_cast<uintptr_t>(history) % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(history_out) % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bins = l.bins();
  cudaError_t e = use_device(device);
  if (e == cudaSuccess && fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * 2 * bins, l.st);
  }
  if (e == cudaSuccess) {
    e = launch_pfb(l, static_cast<const uint8_t*>(history),
                   static_cast<const float*>(h), P,
                   static_cast<float*>(partial), static_cast<float*>(out),
                   device);
  }
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             counts, S, F, P, 2 * bins,
                                             l.st));
}

// What a pass gets with `smem` dynamic bytes and `threads` a block on
// `device` (which: 0 pass A, 1 pass A windowed, 2 pass B with the small
// class of sums, 3 with the large, 4 SK's pass B with the small class, 5
// with the large, 6 the PFB's pass A) into attrs[0..5]: registers and
// local (spill) bytes a thread, static and dynamic shared bytes a block,
// threads a block, and the blocks that reside on one SM. Launches
// nothing.
int rpf_fused_psd_mixed_large_est_attributes(int which, int smem,
                                             int threads, int device,
                                             int* attrs) {
  if (which < 0 || which >= kPasses || smem < 0 || smem > kMlMaxSmem ||
      threads < 32 || threads > kRowsThreads || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(tile_attributes(pass_kernel(which), smem, device,
                                          pass_done[which], attrs, threads,
                                          kMlMaxSmem));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
