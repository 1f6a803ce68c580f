// Polyphase-filterbank device step for NVIDIA Hopper (sm_90a).
//
// Replaces the device step of rtl_power_fftw_tpu/models/pfb.py (_pfb_core,
// 48-89, as the session step _pfb_session_step 160-176 runs it; XLA there,
// no Pallas kernel). The input is one virtual array of F + P - 1 rows of
// raw interleaved u8 IQ, (P - 1, 2N) history rows (the last P - 1 rows the
// acquisition consumed; byte 127, zero signal, after a reset) followed by
// the (F, 2N) slot of new frames. Output frame j is
//
//   S_j[n] = sum over p = 0 .. P-1, in that order from zero, of
//            h[p, n] * x_{j+p}[n],   x = (u8 - 127) dequantized,
//
// each product and each sum rounded to float32 on its own (no FMA), then
// a length-N DFT, |X|^2, frames j >= n_valid dropped, and the sum over
// frames, an (N,) float32 vector of bins in natural order. Frame j ends at
// slot row j, so the zero rows that pad a slot past n_valid feed only the
// frames that are dropped.
//
// The design is K1's (fused_psd.cu, fused_psd_regs.cuh) with another load,
// and after it K1's own device functions: regs_transform (the register
// transform of fft_regs.cuh, lanes of TF threads), |X|^2 summed in
// registers, regs_lane_sum (the lanes added in order into one partial row
// a block), then psd_sum.cuh's float64 row sum. Two kernels share it and
// differ in the load only; on the same grid their outputs are the same
// bits.
//
// psd_pfb_ring_kernel (the route wherever its ring fits a block, rule
// fused_psd_pfb.ring_shape): block g reads virtual rows f0 .. f1 + P - 2
// (its frames' rows) once each, by cp.async, 16 B a thread, into a ring of
// 2 LANES + P - 1 row slots in shared memory: the LANES + P - 1 rows the
// lanes' current frames read and the next LANES rows in flight, each slot
// 2N + 32 bytes so that the rows of one warp's lanes (N <= 256) fall on
// other banks. With STAGE_H the (P, N) prototype h is copied beside the
// ring once a block too (where it fits and still leaves 2 blocks an SM),
// else read through L2. What bounds the PFB on the card is then the
// transform, as for K1: the rows through L2 fall from P a frame to one
// (and P - 1 a block), h from once a frame to once a block. cp.async over
// a bulk (TMA) copy: a row is only 1..2 16-byte copies a thread an
// iteration, the barrier that frees the exchange buffer also publishes
// the copied rows, and no mbarrier phase per slot is needed.
//
// psd_pfb_kernel (the kernel the ring kernel was redesigned from, the
// control, and the route where the ring does not fit: 16384 bins at P >=
// 2): a thread builds its R samples of S_j straight from device memory,
// for each p R u16 reads of row j + p of the virtual array (the history
// for rows < P - 1) and R reads of h, both through L2 (each raw row is
// fetched P times; h once a frame).
//
// After the sum, two stream-ordered copies write the history the next
// step reads into `history_out`: rows n_valid .. n_valid + P - 2 of the
// virtual array, so the rows of an old history that n_valid < P - 1 new
// frames do not push out are kept (the JAX package's
// PfbSessionStep.__call__, pfb.py:251-259). With `fresh` the history is
// first set to byte 127 on the stream (a reset).
//
// rpf_fused_psd_pfb_streams runs either kernel over S streams of F frames,
// (S*F, 2N) with an (S,) count array on the device and (S, P - 1, 2N)
// histories, two buffers swapped by the caller each step, and gives each
// stream its own row, (S, N). Block g serves stream s = g / G_s (G_s =
// ceil(F / group) blocks a stream) from that stream's slot rows, history
// and count, and writes partial row g; psd_sum.cuh's row sum then gives
// each stream its own row. The streams forms (psd_pfb_streams_kernel,
// psd_pfb_ring_streams_kernel) are the single-stream kernels with the
// stream's rows and count resolved from the block, their bodies line for
// line (the single-stream kernels stay as they were: their SASS is held to
// the earlier build's). Each stream's next history comes from its own
// valid rows, by pfb_history_kernel (pfb_history.cuh, which the awkward-N
// estimator libraries share): rows n_valid[s] .. n_valid[s] + P - 2
// of its virtual array, read from the count on the device (the JAX
// package's ShardedPfbStep, pfb.py:372-380, keeps them on the host: a
// stream with no valid frame keeps its history, one with fewer than P - 1
// shifts it). With `fresh` every stream's history is set to byte 127
// first.
//
// rpf_pfb_channelize (PFB-C) is the channelizer of the JAX package's
// pfb_channelize (models/pfb.py:401-428): the same polyphase sums over one
// (T + P - 1, 2N) array of raw rows (its first P - 1 rows the history of
// output frame 0), K1's register transform, and X itself stored, unshifted,
// as row j of a (T, N) complex64 output, through the lane's exchange buffer
// (regs_frame_store of fused_psd_regs.cuh) in place of the sum of |X|^2.
// pfb_channelize_kernel takes the ring kernel's load where its ring fits a
// block (RING; STAGE_H as the ring kernel's), else the control's, so its X
// are the ones whose |X|^2 the PFB kernels sum. It is in the fences too.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"
#include "pfb_history.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kMaxTaps = 32;
constexpr int kMaxSmem = 232448;   // the 227 KB a Hopper block may use

// A lane's exchange buffer, and the lanes' sums by bin at the end.
template <int LOG2N>
__host__ __device__ constexpr int pfb_smem_bytes() {
  return RegsShape<LOG2N>::LANES * RegsShape<LOG2N>::XSTRIDE * 8;
}

// Block g sums |DFT(S_j)|^2 over its frames j in [g * group, min((g + 1) *
// group, F, n_valid)) into partial row g; lane p of the block takes frames
// g * group + p + LANES * i.
template <int LOG2N>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_pfb_kernel(const uint8_t* __restrict__ raw,      // (F, 2N), the slot
               const uint8_t* __restrict__ history,  // (P - 1, 2N)
               const float2* __restrict__ twiddle,   // pass_twiddles(N)
               const float* __restrict__ h,          // (P, N)
               float* __restrict__ partial,          // (G, N)
               int F, int group, int n_valid, int P) {
  using Pl = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = Pl::N, R = Pl::R, TF = Pl::TF;
  static_assert(Pl::PASSES >= 2, "the transform has an exchange");
  extern __shared__ float4 pfb_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(pfb_smem) + lane * S::XSTRIDE;

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int iters = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  for (int i = 0; i < iters; ++i) {
    const int f = f0 + lane + S::LANES * i;
    const bool active = f < f1;
    float2 v[R];
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = make_float2(0.0f, 0.0f);
      for (int p = 0; p < P; ++p) {
        // Row f + p of the virtual array: history rows, then the slot's.
        const int r = f + p;
        const uint16_t* row = reinterpret_cast<const uint16_t*>(
            r < P - 1 ? history + static_cast<size_t>(r) * 2 * N
                      : raw + static_cast<size_t>(r - (P - 1)) * 2 * N);
        const float* hp = h + static_cast<size_t>(p) * N;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const unsigned u = __ldg(row + t + k * TF);
          const float hv = __ldg(hp + t + k * TF);
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
      }
    }
    __syncthreads();   // x is free: every lane is past the last pass
    regs_transform<LOG2N>(v, x, twiddle, t, active);
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
      }
    }
  }
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin, then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(pfb_smem);   // (LANES, N)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, k)] = acc[k];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(by_bin, partial + static_cast<size_t>(blockIdx.x) * N,
                       tid);
}

// A ring slot: a raw row of 2N bytes and 32 more (the banks of the next
// lane's row, N <= 256).
template <int LOG2N>
__host__ __device__ constexpr int ring_row_bytes() {
  return 2 * (1 << LOG2N) + 32;
}

// The ring kernel's shared memory at P taps: the exchange buffers, 2 LANES
// + P - 1 row slots, and with STAGE_H the (P, N) prototype.
template <int LOG2N>
int ring_smem_bytes(int P, bool stage_h) {
  return pfb_smem_bytes<LOG2N>() +
         (2 * RegsShape<LOG2N>::LANES + P - 1) * ring_row_bytes<LOG2N>() +
         (stage_h ? 4 * P * (1 << LOG2N) : 0);
}

// The same sums as psd_pfb_kernel, group g and lane p alike, from block
// g's virtual rows staged once each in a shared-memory ring. Local row q
// (virtual row f0 + q) lies in slot q mod (2 LANES + P - 1); iteration i's
// frames read rows LANES i .. LANES i + LANES + P - 2, and it copies rows
// LANES (i + 1) + P - 1 .. LANES (i + 2) + P - 2 (the next iteration's
// new ones) into the slots of rows LANES (i - 1) .. LANES i - 1, which
// iteration i - 1 read before the first barrier of its transform.
template <int LOG2N, bool STAGE_H>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_pfb_ring_kernel(const uint8_t* __restrict__ raw,      // (F, 2N), the slot
                    const uint8_t* __restrict__ history,  // (P - 1, 2N)
                    const float2* __restrict__ twiddle,   // pass_twiddles(N)
                    const float* __restrict__ h,          // (P, N)
                    float* __restrict__ partial,          // (G, N)
                    int F, int group, int n_valid, int P) {
  using Pl = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = Pl::N, R = Pl::R, TF = Pl::TF;
  constexpr int ROW = ring_row_bytes<LOG2N>();
  constexpr int PIECES = N / 8;   // 16-byte copies of a row
  static_assert(Pl::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 pfb_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(pfb_smem) + lane * S::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(pfb_smem) +
                  pfb_smem_bytes<LOG2N>();
  const int slots = 2 * S::LANES + P - 1;
  float* h_smem = reinterpret_cast<float*>(ring + slots * ROW);

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int frames = max(f1 - f0, 0);
  const int iters = (frames + S::LANES - 1) / S::LANES;
  const int rows = frames > 0 ? frames + P - 1 : 0;   // local rows read

  // Local rows [lo, min(hi, rows)) into their slots, 16 B a thread.
  auto stage = [&](int lo, int hi) {
    const int pieces = (min(hi, rows) - lo) * PIECES;
    for (int c = tid; c < pieces; c += S::THREADS) {
      const int q = lo + c / PIECES;
      const int r = f0 + q;   // its virtual row: history rows, then slot's
      const int off = 16 * (c % PIECES);
      const uint8_t* src =
          r < P - 1 ? history + static_cast<size_t>(r) * 2 * N
                    : raw + static_cast<size_t>(r - (P - 1)) * 2 * N;
      cp_async16(ring + (q % slots) * ROW + off, src + off);
    }
  };

  if constexpr (STAGE_H) {
    for (int c = tid; c < P * N / 4; c += S::THREADS) {
      cp_async16(h_smem + 4 * c, h + 4 * c);
    }
  }
  stage(0, S::LANES + P - 1);
  cp_async_commit();
  const float* hp0 = STAGE_H ? h_smem : h;
  for (int i = 0; i < iters; ++i) {
    stage(S::LANES * (i + 1) + P - 1, S::LANES * (i + 2) + P - 1);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of rows up to iteration i's
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    const bool active = f0 + lane + S::LANES * i < f1;
    float2 v[R];
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = make_float2(0.0f, 0.0f);
      int slot = (S::LANES * i + lane) % slots;   // tap 0's row
      for (int p = 0; p < P; ++p) {
        const uint16_t* row =
            reinterpret_cast<const uint16_t*>(ring + slot * ROW);
        const float* hp = hp0 + p * N;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const unsigned u = row[t + k * TF];
          const float hv = STAGE_H ? hp[t + k * TF] : __ldg(hp + t + k * TF);
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
        if (++slot == slots) slot = 0;
      }
    }
    regs_transform<LOG2N>(v, x, twiddle, t, active);
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin, then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(pfb_smem);   // (LANES, N)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, k)] = acc[k];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(by_bin, partial + static_cast<size_t>(blockIdx.x) * N,
                       tid);
}

// The streams forms: begin (probes/estimator_builds.py edits only the
// single-stream kernels, outside these fences).

// psd_pfb_kernel over S streams: block g serves stream s = g / G_s, frames
// [j * group, min((j + 1) * group, F, n_valid[s])), j = g - s * G_s, of
// its slot rows after its history; partial row g.
template <int LOG2N>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_pfb_streams_kernel(const uint8_t* __restrict__ raw,      // (S*F, 2N)
                       const uint8_t* __restrict__ history,  // (S, P-1, 2N)
                       const float2* __restrict__ twiddle,
                       const float* __restrict__ h,          // (P, N)
                       float* __restrict__ partial,          // (S*G_s, N)
                       int F, int group, int G_s,
                       const int* __restrict__ counts, int P) {
  using Pl = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = Pl::N, R = Pl::R, TF = Pl::TF;
  static_assert(Pl::PASSES >= 2, "the transform has an exchange");
  extern __shared__ float4 pfb_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(pfb_smem) + lane * S::XSTRIDE;

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;

  const int stream = blockIdx.x / G_s;
  raw += static_cast<size_t>(stream) * F * 2 * N;
  history += static_cast<size_t>(stream) * (P - 1) * 2 * N;
  const int f0 = (blockIdx.x - stream * G_s) * group;
  const int f1 = min(f0 + group, min(F, __ldg(counts + stream)));
  const int iters = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  for (int i = 0; i < iters; ++i) {
    const int f = f0 + lane + S::LANES * i;
    const bool active = f < f1;
    float2 v[R];
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = make_float2(0.0f, 0.0f);
      for (int p = 0; p < P; ++p) {
        const int r = f + p;
        const uint16_t* row = reinterpret_cast<const uint16_t*>(
            r < P - 1 ? history + static_cast<size_t>(r) * 2 * N
                      : raw + static_cast<size_t>(r - (P - 1)) * 2 * N);
        const float* hp = h + static_cast<size_t>(p) * N;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const unsigned u = __ldg(row + t + k * TF);
          const float hv = __ldg(hp + t + k * TF);
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
      }
    }
    __syncthreads();
    regs_transform<LOG2N>(v, x, twiddle, t, active);
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
      }
    }
  }
  __syncthreads();

  float* by_bin = reinterpret_cast<float*>(pfb_smem);   // (LANES, N)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, k)] = acc[k];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(by_bin, partial + static_cast<size_t>(blockIdx.x) * N,
                       tid);
}

// psd_pfb_ring_kernel over S streams, block g as psd_pfb_streams_kernel's.
template <int LOG2N, bool STAGE_H>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
psd_pfb_ring_streams_kernel(const uint8_t* __restrict__ raw,  // (S*F, 2N)
                            const uint8_t* __restrict__ history,
                            const float2* __restrict__ twiddle,
                            const float* __restrict__ h,      // (P, N)
                            float* __restrict__ partial,      // (S*G_s, N)
                            int F, int group, int G_s,
                            const int* __restrict__ counts, int P) {
  using Pl = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = Pl::N, R = Pl::R, TF = Pl::TF;
  constexpr int ROW = ring_row_bytes<LOG2N>();
  constexpr int PIECES = N / 8;   // 16-byte copies of a row
  static_assert(Pl::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 pfb_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(pfb_smem) + lane * S::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(pfb_smem) +
                  pfb_smem_bytes<LOG2N>();
  const int slots = 2 * S::LANES + P - 1;
  float* h_smem = reinterpret_cast<float*>(ring + slots * ROW);

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;

  const int stream = blockIdx.x / G_s;
  raw += static_cast<size_t>(stream) * F * 2 * N;
  history += static_cast<size_t>(stream) * (P - 1) * 2 * N;
  const int f0 = (blockIdx.x - stream * G_s) * group;
  const int f1 = min(f0 + group, min(F, __ldg(counts + stream)));
  const int frames = max(f1 - f0, 0);
  const int iters = (frames + S::LANES - 1) / S::LANES;
  const int rows = frames > 0 ? frames + P - 1 : 0;   // local rows read

  auto stage = [&](int lo, int hi) {
    const int pieces = (min(hi, rows) - lo) * PIECES;
    for (int c = tid; c < pieces; c += S::THREADS) {
      const int q = lo + c / PIECES;
      const int r = f0 + q;
      const int off = 16 * (c % PIECES);
      const uint8_t* src =
          r < P - 1 ? history + static_cast<size_t>(r) * 2 * N
                    : raw + static_cast<size_t>(r - (P - 1)) * 2 * N;
      cp_async16(ring + (q % slots) * ROW + off, src + off);
    }
  };

  if constexpr (STAGE_H) {
    for (int c = tid; c < P * N / 4; c += S::THREADS) {
      cp_async16(h_smem + 4 * c, h + 4 * c);
    }
  }
  stage(0, S::LANES + P - 1);
  cp_async_commit();
  const float* hp0 = STAGE_H ? h_smem : h;
  for (int i = 0; i < iters; ++i) {
    stage(S::LANES * (i + 1) + P - 1, S::LANES * (i + 2) + P - 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bool active = f0 + lane + S::LANES * i < f1;
    float2 v[R];
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = make_float2(0.0f, 0.0f);
      int slot = (S::LANES * i + lane) % slots;   // tap 0's row
      for (int p = 0; p < P; ++p) {
        const uint16_t* row =
            reinterpret_cast<const uint16_t*>(ring + slot * ROW);
        const float* hp = hp0 + p * N;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const unsigned u = row[t + k * TF];
          const float hv = STAGE_H ? hp[t + k * TF] : __ldg(hp + t + k * TF);
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
        if (++slot == slots) slot = 0;
      }
    }
    regs_transform<LOG2N>(v, x, twiddle, t, active);
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] += v[k].x * v[k].x + v[k].y * v[k].y;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* by_bin = reinterpret_cast<float*>(pfb_smem);   // (LANES, N)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, k)] = acc[k];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(by_bin, partial + static_cast<size_t>(blockIdx.x) * N,
                       tid);
}

// The channelizer: output frame j of the (T + P - 1, 2N) raw rows `rows`
// (block g takes frames [g * group, min((g + 1) * group, T)), lane l frames
// g * group + l + LANES * i) is X_j = DFT(sum over p of h[p] x_{j+p}),
// stored as row j of `out`. RING: block g's rows staged once each in the
// ring kernel's ring (local row q in slot q mod (2 LANES + P - 1)); else
// each thread reads its R samples of rows j .. j + P - 1 through L2.
template <int LOG2N, bool RING, bool STAGE_H>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)
pfb_channelize_kernel(const uint8_t* __restrict__ rows,     // (T + P - 1, 2N)
                      const float2* __restrict__ twiddle,  // pass_twiddles(N)
                      const float* __restrict__ h,         // (P, N)
                      float2* __restrict__ out,            // (T, N)
                      int T, int group, int P) {
  using Pl = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = Pl::N, R = Pl::R, TF = Pl::TF;
  constexpr int ROW = ring_row_bytes<LOG2N>();
  constexpr int PIECES = N / 8;   // 16-byte copies of a row
  static_assert(Pl::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 pfb_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  float2* x = reinterpret_cast<float2*>(pfb_smem) + lane * S::XSTRIDE;
  uint8_t* ring = reinterpret_cast<uint8_t*>(pfb_smem) +
                  pfb_smem_bytes<LOG2N>();
  const int slots = 2 * S::LANES + P - 1;
  float* h_smem = reinterpret_cast<float*>(ring + slots * ROW);

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, T);
  const int frames = max(f1 - f0, 0);
  const int iters = (frames + S::LANES - 1) / S::LANES;
  const int local_rows = frames > 0 ? frames + P - 1 : 0;

  // RING: local rows [lo, min(hi, local_rows)) into their slots.
  auto stage = [&](int lo, int hi) {
    if constexpr (RING) {
      const int pieces = (min(hi, local_rows) - lo) * PIECES;
      for (int c = tid; c < pieces; c += S::THREADS) {
        const int q = lo + c / PIECES;
        const int off = 16 * (c % PIECES);
        cp_async16(ring + (q % slots) * ROW + off,
                   rows + static_cast<size_t>(f0 + q) * 2 * N + off);
      }
    }
  };

  if constexpr (STAGE_H) {
    for (int c = tid; c < P * N / 4; c += S::THREADS) {
      cp_async16(h_smem + 4 * c, h + 4 * c);
    }
  }
  stage(0, S::LANES + P - 1);
  cp_async_commit();
  const float* hp0 = STAGE_H ? h_smem : h;
  for (int i = 0; i < iters; ++i) {
    stage(S::LANES * (i + 1) + P - 1, S::LANES * (i + 2) + P - 1);
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of rows up to iteration i's
    __syncthreads();      // everyone's; x is free (last store of frame i-1)
    const int f = f0 + lane + S::LANES * i;
    const bool active = f < f1;
    float2 v[R];
    if (active) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = make_float2(0.0f, 0.0f);
      int slot = (S::LANES * i + lane) % slots;   // tap 0's row
      for (int p = 0; p < P; ++p) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(
            RING ? ring + slot * ROW
                 : rows + static_cast<size_t>(f + p) * 2 * N);
        const float* hp = hp0 + p * N;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const unsigned u = RING ? row[t + k * TF] : __ldg(row + t + k * TF);
          const float hv = STAGE_H ? hp[t + k * TF] : __ldg(hp + t + k * TF);
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
        if (++slot == slots) slot = 0;
      }
    }
    regs_transform<LOG2N>(v, x, twiddle, t, active);
    regs_frame_store<LOG2N, kRegsFramesComplex>(v, x, out, f, t, active);
  }
  cp_async_wait<0>();
}

// The streams forms: end.

template <int LOG2N>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_pfb_kernel<LOG2N>, pfb_smem_bytes<LOG2N>(), device,
                     done);
}

// The ring kernel opts in to the most a block may use once; a launch asks
// for its own (P, STAGE_H) share of it.
template <int LOG2N, bool STAGE_H>
cudaError_t prepare_ring(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_pfb_ring_kernel<LOG2N, STAGE_H>, kMaxSmem, device,
                     done);
}

template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* history,
                          const void* twiddle, const void* h, void* partial,
                          int F, int group, int blocks, int n_valid, int P,
                          int ring, int stage_h, int device,
                          cudaStream_t stream) {
  constexpr int threads = RegsShape<LOG2N>::THREADS;
  const auto* r = static_cast<const uint8_t*>(raw);
  const auto* hist = static_cast<const uint8_t*>(history);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* hp = static_cast<const float*>(h);
  auto* part = static_cast<float*>(partial);
  if (!ring) {
    const cudaError_t e = prepare<LOG2N>(device);
    if (e != cudaSuccess) return e;
    psd_pfb_kernel<LOG2N><<<blocks, threads, pfb_smem_bytes<LOG2N>(),
                            stream>>>(r, hist, tw, hp, part, F, group,
                                      n_valid, P);
    return cudaGetLastError();
  }
  const int smem = ring_smem_bytes<LOG2N>(P, stage_h != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = stage_h ? prepare_ring<LOG2N, true>(device)
                                : prepare_ring<LOG2N, false>(device);
  if (e != cudaSuccess) return e;
  if (stage_h) {
    psd_pfb_ring_kernel<LOG2N, true><<<blocks, threads, smem, stream>>>(
        r, hist, tw, hp, part, F, group, n_valid, P);
  } else {
    psd_pfb_ring_kernel<LOG2N, false><<<blocks, threads, smem, stream>>>(
        r, hist, tw, hp, part, F, group, n_valid, P);
  }
  return cudaGetLastError();
}

template <int LOG2N, bool STAGE_H>
cudaError_t prepare_ring_streams(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_pfb_ring_streams_kernel<LOG2N, STAGE_H>, kMaxSmem,
                     device, done);
}

template <int LOG2N>
cudaError_t prepare_streams(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_pfb_streams_kernel<LOG2N>, pfb_smem_bytes<LOG2N>(),
                     device, done);
}

// The streams forms' first pass on S * G_s blocks.
template <int LOG2N>
cudaError_t launch_streams(const void* raw, const void* history,
                           const void* twiddle, const void* h, void* partial,
                           int F, int group, int S, int G_s,
                           const void* counts, int P, int ring, int stage_h,
                           int device, cudaStream_t stream) {
  constexpr int threads = RegsShape<LOG2N>::THREADS;
  const auto* r = static_cast<const uint8_t*>(raw);
  const auto* hist = static_cast<const uint8_t*>(history);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* hp = static_cast<const float*>(h);
  auto* part = static_cast<float*>(partial);
  const auto* nv = static_cast<const int*>(counts);
  const int blocks = S * G_s;
  if (!ring) {
    const cudaError_t e = prepare_streams<LOG2N>(device);
    if (e != cudaSuccess) return e;
    psd_pfb_streams_kernel<LOG2N><<<blocks, threads, pfb_smem_bytes<LOG2N>(),
                                    stream>>>(r, hist, tw, hp, part, F, group,
                                              G_s, nv, P);
    return cudaGetLastError();
  }
  const int smem = ring_smem_bytes<LOG2N>(P, stage_h != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = stage_h ? prepare_ring_streams<LOG2N, true>(device)
                                : prepare_ring_streams<LOG2N, false>(device);
  if (e != cudaSuccess) return e;
  if (stage_h) {
    psd_pfb_ring_streams_kernel<LOG2N, true><<<blocks, threads, smem,
                                               stream>>>(
        r, hist, tw, hp, part, F, group, G_s, nv, P);
  } else {
    psd_pfb_ring_streams_kernel<LOG2N, false><<<blocks, threads, smem,
                                                stream>>>(
        r, hist, tw, hp, part, F, group, G_s, nv, P);
  }
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t attributes(int P, int ring, int stage_h, int device,
                       int* attrs) {
  constexpr int threads = RegsShape<LOG2N>::THREADS;
  if (!ring) {
    const cudaError_t e = prepare<LOG2N>(device);
    if (e != cudaSuccess) return e;
    return kernel_attributes(psd_pfb_kernel<LOG2N>, threads,
                             pfb_smem_bytes<LOG2N>(), attrs);
  }
  const int smem = ring_smem_bytes<LOG2N>(P, stage_h != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = stage_h ? prepare_ring<LOG2N, true>(device)
                                : prepare_ring<LOG2N, false>(device);
  if (e != cudaSuccess) return e;
  return stage_h ? kernel_attributes(psd_pfb_ring_kernel<LOG2N, true>,
                                     threads, smem, attrs)
                 : kernel_attributes(psd_pfb_ring_kernel<LOG2N, false>,
                                     threads, smem, attrs);
}

// The channelizer's launch (attrs null) or its attributes (attrs given):
// the ring form where `ring` (its shared memory the ring kernel's at P
// taps), else the control's load.
template <int LOG2N, bool RING, bool STAGE_H>
cudaError_t launch_channelize(const uint8_t* rows, const float2* twiddle,
                              const float* h, float2* out, int T, int group,
                              int P, int smem, int device,
                              cudaStream_t stream, int* attrs) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t e =
      opt_in_smem(pfb_channelize_kernel<LOG2N, RING, STAGE_H>,
                  RING ? kMaxSmem : pfb_smem_bytes<LOG2N>(), device, done);
  if (e != cudaSuccess) return e;
  constexpr int threads = RegsShape<LOG2N>::THREADS;
  if (attrs != nullptr) {
    return kernel_attributes(pfb_channelize_kernel<LOG2N, RING, STAGE_H>,
                             threads, smem, attrs);
  }
  pfb_channelize_kernel<LOG2N, RING, STAGE_H>
      <<<(T + group - 1) / group, threads, smem, stream>>>(rows, twiddle, h,
                                                           out, T, group, P);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t channelize(const void* rows, const void* twiddle, const void* h,
                       void* out, int T, int group, int P, int ring,
                       int stage_h, int device, cudaStream_t stream,
                       int* attrs) {
  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* hp = static_cast<const float*>(h);
  auto* o = static_cast<float2*>(out);
  if (!ring) {
    return launch_channelize<LOG2N, false, false>(
        r, tw, hp, o, T, group, P, pfb_smem_bytes<LOG2N>(), device, stream,
        attrs);
  }
  const int smem = ring_smem_bytes<LOG2N>(P, stage_h != 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return stage_h ? launch_channelize<LOG2N, true, true>(
                       r, tw, hp, o, T, group, P, smem, device, stream, attrs)
                 : launch_channelize<LOG2N, true, false>(
                       r, tw, hp, o, T, group, P, smem, device, stream,
                       attrs);
}

}  // namespace

extern "C" {

// Launches the step on `stream`. raw: (F, 2N) u8; history, history_out:
// (P - 1, 2N) u8, distinct (null when P = 1); twiddle: pass_twiddles(N),
// (rows, 2) f32; h: (P, N) f32, 1 <= P <= 32; partial: (ceil(F / group), N)
// f32 scratch; out: (N,) f32; fresh: set the history to byte 127 first;
// ring: psd_pfb_ring_kernel (raw, history and, with stage_h, h 16-byte
// aligned; cudaErrorInvalidValue where its shared memory exceeds a
// block's), else psd_pfb_kernel (every pointer 4-byte aligned). Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_pfb(const void* raw, const void* history,
                      const void* twiddle, const void* h, void* partial,
                      void* out, void* history_out, int device, int log2n,
                      int F, int group, int n_valid, int P, int fresh,
                      int ring, int stage_h, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F || P < 1 || P > kMaxTaps ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  const size_t row_bytes = static_cast<size_t>(2) * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127, (P - 1) * row_bytes,
                        st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (F + group - 1) / group;
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_groups<L>(raw, history, twiddle, h, partial, F, group,       \
                         blocks, n_valid, P, ring, stage_h, device, st);    \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_psd_sum(partial, blocks, N, out, st);
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

// S streams of F frames. raw: (S*F, 2N) u8, stream s in rows [s*F,
// (s+1)*F); history, history_out: (S, P - 1, 2N) u8, distinct, stream s's
// rows together; n_valid: (S,) int32 on the device, read when the kernels
// run (a count outside [0, F] acts as its nearest bound); G_s = ceil(F /
// group) blocks a stream; partial: (S * G_s, N) f32 scratch; out: (S, N)
// f32; fresh: set every stream's history to byte 127 first. Other
// arguments as rpf_fused_psd_pfb.
int rpf_fused_psd_pfb_streams(const void* raw, const void* history,
                              const void* twiddle, const void* h,
                              const void* n_valid, void* partial, void* out,
                              void* history_out, int device, int log2n,
                              int S, int F, int group, int P, int fresh,
                              int ring, int stage_h, void* stream) {
  const long long G_s = group > 0 ? (F + group - 1) / group : 0;
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || F <= 0 ||
      group <= 0 || n_valid == nullptr || P < 1 || P > kMaxTaps ||
      S * G_s > 0x7fffffffLL || S > kMaxGridY ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  const int g = static_cast<int>(G_s);
  const size_t row_bytes = static_cast<size_t>(2) * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * row_bytes, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = launch_streams<L>(raw, history, twiddle, h, partial, F, group, S,   \
                          g, n_valid, P, ring, stage_h, device, st);        \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_psd_sum(partial, g, N, out, st, S);
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             n_valid, S, F, P,
                                             static_cast<int>(row_bytes), st));
}

// What the kernel (ring: the ring kernel at P taps, with stage_h h
// staged; else the control) gets at N = 2^log2n on `device`: attrs[0..5]
// as fused_psd.cu's rpf_fused_psd_attributes. Launches nothing.
int rpf_fused_psd_pfb_attributes(int log2n, int P, int ring, int stage_h,
                                 int device, int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || P < 1 || P > kMaxTaps ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = attributes<L>(P, ring, stage_h, device, attrs);                      \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// The channelizer on `stream`. rows: (T + P - 1, 2N) u8, the first P - 1
// rows output frame 0's history; twiddle: pass_twiddles(N); h: (P, N) f32,
// 1 <= P <= 32; out: (T, N) complex64 as (T, N, 2) f32, X of every output
// frame, natural bin order; group: frames a block; ring, stage_h: the form
// (as rpf_fused_psd_pfb's, the same alignment). Returns a cudaError_t (0
// on success); does not synchronise.
int rpf_pfb_channelize(const void* rows, const void* twiddle, const void* h,
                       void* out, int device, int log2n, int T, int group,
                       int P, int ring, int stage_h, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || T <= 0 || group <= 0 ||
      P < 1 || P > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = channelize<L>(rows, twiddle, h, out, T, group, P, ring, stage_h,    \
                      device, st, nullptr);                                 \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// What the channelizer's form (ring, stage_h) gets at N = 2^log2n and P
// taps on `device`: attrs[0..5] as rpf_fused_psd_pfb_attributes. Launches
// nothing.
int rpf_pfb_channelize_attributes(int log2n, int P, int ring, int stage_h,
                                  int device, int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || P < 1 || P > kMaxTaps ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = channelize<L>(nullptr, nullptr, nullptr, nullptr, 1, 1, P, ring,     \
                      stage_h, device, nullptr, attrs);                      \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
