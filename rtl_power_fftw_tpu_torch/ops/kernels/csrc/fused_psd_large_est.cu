// The CLI estimators' device steps at the large powers of two, for NVIDIA
// Hopper (sm_90a): spectral kurtosis (SK-L), the multitaper (MT-L) and the
// polyphase filterbank (PFB-L) on the large kernel's register passes
// (fused_psd_large.cu), at every power of two N from 32768 to 2^22. Each
// form takes S >= 1 streams of F frames, (S*F, 2N), with an (S,) count
// array on the device; the one-stream steps call it at S = 1.
//
// They replace no Pallas kernel: the JAX package computes these estimators
// in XLA at every N (rtl_power_fftw_tpu/models/kurtosis.py:_sk_step 46-93,
// multitaper.py:_mt_core 60-133, pfb.py:_pfb_core 48-89, and their sharded
// steps; at these N its transform is ops/dft.py:fourstep4m_psd_partial 342
// or fourstep_psd_partial 107, as tapered_batch_mode picks). The function
// of each is the one its forms at N <= 16384 compute (fused_psd_sk.cu,
// fused_psd_tapers.cu, fused_psd_pfb.cu):
//
//   SK-L    s1 = sum over valid frames of |X|^2 and s2 = sum of |X|^4,
//           (S, 2, N); with two_sigma > 0 (--sk-excise) also each stream's
//           gate on its own SK, s1 * keep and n_valid * keep, (S, 4, N);
//   MT-L    the sum over valid frames of the mean over K tapers of
//           |DFT(x * taper_k)|^2, (S, N);
//   PFB-L   the sum over output frames j < n_valid of |DFT(S_j)|^2, S_j[n]
//           = sum over p = 0 .. P-1, in that order from zero, of h[p, n] *
//           x_{j+p}[n] (each product and sum rounded on its own) over each
//           stream's virtual array of P - 1 history rows and F frames; each
//           stream's next history written to history_out on the stream.
//
// Each changes the large kernel only where its function differs. The
// passes are its streams passes ("L-S", fused_psd_large_streams.cuh:
// large_streams_a/b, the stream on the grid's y axis, the counts read on
// the card) but for:
//
//   SK-L    pass B: large_sk_b keeps a sum of |X|^4 beside each sum of
//           |X|^2 (acc2[16] beside acc[16]; the |X|^2 sums are
//           large_regs_b's own expression, so on the large kernel's grid
//           s1 is its output bit for bit) and writes it to a second plane
//           of partial rows, (2, S G_s, N), both staged by bin through the
//           exchange as pass B stages its one plane; est_streams_kernel
//           (fused_psd_est.cuh) adds each stream's rows in psd_sum.cuh's
//           order, with the gate of --sk-excise; with one group a stream
//           and no gate pass B writes the (S, 2, N) output itself, as the
//           large kernel's pass B writes its one row;
//   MT-L    a taper loop: pass A windowed by taper row k of the (K, N)
//           table and pass B, once a taper over one (S F, N) scratch,
//           which the next taper's pass A overwrites (256 MB at F = 8, N =
//           2^22, where the taper on the grid would take K times that);
//           taper k's pass B writes partial row (k S + s) G_s + j, and
//           est_streams_kernel<kEstTapers> sums each stream's K G_s rows
//           and divides by K. Each frame is read K times, as MT-BL reads
//           it;
//   PFB-L   pass A by the route table kPfbRoute (by N, frames a call and
//           taps): large_pfb_ring_a, the sums from a shared-memory ring of
//           the stream's virtual rows and h in 16-byte runs; or a
//           pre-pass, pfb_sums_kernel (pfb_sums.cuh), that forms every
//           polyphase sum in one streaming pass over the virtual rows and
//           writes it into the scratch where pass A writes that value,
//           then large_pfb_sums_a, which reads its batch's sums from there
//           in place of the ring; or the first form, large_pfb_a (the sums
//           in pass A's load: the own row from the ring, the older rows
//           and h through L1/L2), which also runs as the control,
//           rpf_fused_psd_pfb_large_control. The next histories are
//           pfb_history_wide_kernel's (pfb_history.cuh).
//
// The passes are instantiated at every log2 N from 15 to 22; the entries
// dispatch on it (at_log2n). The grid is the large kernel's own (the
// wrapper takes its residency), so SK-L's s1 at S = 1 is its output and
// each stream's rows are the S = 1 form's on the same groups.
//
// What bounds them on an H100: the large kernel's bound (the frames' 2
// bytes a sample; the form moves 8N bytes of scratch a frame twice each
// way, which the bound of the function does not count), times K passes for
// MT-L, and for PFB-L the prototype h, 4 P N bytes, once, and the
// pre-pass's sums, 8N bytes a frame written and read back (the control
// read h and the P - 1 older rows through L1/L2 a frame: at 2^22 and P =
// 4, 64 MB of h a frame against 8 MB of frames, above the 50 MB L2; the
// ring reads the older rows once a block and h once a block resident, or
// once a frame streamed).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_large_regs.cuh"
#include "fused_psd_large_streams.cuh"
#include "large_streams.cuh"
#include "pfb_history.cuh"
#include "pfb_sums.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 15;
constexpr int kMaxLog2N = 22;

// regs_a_batch with PFB-L's load: batch s of output frame j on thread (c,
// t), the polyphase sums of the column's 16 samples n = (t + k TF1) N2 +
// c0 + s B + c, the frame's own row from the ring; then pass A's passes
// and stores. Each sum is PFB-BL's pfb_sum (p in order from zero, each
// product and sum rounded on its own), taken tap by tap over the 16
// samples, so that a thread has 16 loads of a tap's row and of h in
// flight at once (a sample at a time, PFB-L's first form, waited for each
// tap's two loads in turn: probes/large_estimator_builds.py).
template <int LOG2N>
__device__ __forceinline__ void pfb_a_batch(
    int s, const uint8_t* tile, const uint8_t* __restrict__ frames,
    const uint8_t* __restrict__ history, const float* __restrict__ h, int j,
    int taps, float2* x, const float2* __restrict__ twiddle,
    const float2* __restrict__ inter, float2* __restrict__ out, int c, int t,
    int c0) {
  using L = LargeRegs<LOG2N>;
  constexpr int TF = L::TF1;
  if (s > 0) __syncthreads();   // x is free (last pass of batch s - 1)
  const int col = s * L::B + c;
  const int byte = 2 * col;
  const int n0 = c0 + col;   // sample k: (t + k TF) N2 + n0
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = make_float2(0.0f, 0.0f);
  for (int p = 0; p < taps; ++p) {
    const float* hp = h + static_cast<size_t>(p) * L::N + n0;
    if (p < taps - 1) {
      const int r = j + p;   // virtual row: history, then frames
      const uint16_t* row = reinterpret_cast<const uint16_t*>(
          r < taps - 1 ? history + static_cast<size_t>(r) * 2 * L::N
                       : frames + static_cast<size_t>(r - (taps - 1)) * 2 *
                                      L::N) + n0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int off = (t + k * TF) << L::LOG2N2;
        const unsigned u = __ldg(row + off);
        const float hv = __ldg(hp + off);
        v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
        v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int row = t + k * TF;
        const unsigned u = *reinterpret_cast<const uint16_t*>(
            tile + ring_offset<LOG2N>(row, byte >> 4) + (byte & 15));
        const float hv = __ldg(hp + (row << L::LOG2N2));
        v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
        v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
      }
    }
  }
  first_pass<L::LOG2N1>(v, x, twiddle, t,
                        [c](int e) { return col_index<LOG2N>(c, e); });
  regs_a_rest<LOG2N>(s, v, x, twiddle, inter, out, c, t, c0);
}

// PFB-L's pass A: large_streams_a with pfb_a_batch. Block (x, s) as
// streams_block; frame i of the block is output frame j = f0 + i of
// stream s, whose own row the ring holds; `history` is (S, P - 1, 2N)
// (null at P = 1), stream s's rows at s (P - 1) 2N.
template <int LOG2N>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_A,
                                  LargeRegs<LOG2N>::MIN_BLOCKS_A)
large_pfb_a(const uint8_t* __restrict__ raw,       // (S*F, 2N)
            const uint8_t* __restrict__ history,   // (S, P-1, 2N)
            const float* __restrict__ h,           // (P, N)
            const float2* __restrict__ twiddle,    // pass_twiddles(N1)
            const float2* __restrict__ inter,      // W_N^(k1 n2)
            float2* __restrict__ scratch,          // (S*F, N)
            int F, int group, int G_s, const int* __restrict__ counts,
            int taps) {
  using L = LargeRegs<LOG2N>;
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2N>(tid);
  const int t = row_of<LOG2N>(tid);
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  const int stream = blockIdx.y;
  const int j0 = first - stream * F;
  const uint8_t* own_frames = raw + static_cast<size_t>(stream) * F * 2 * L::N;
  const uint8_t* rows =
      taps > 1 ? history + static_cast<size_t>(stream) * (taps - 1) * 2 * L::N
               : nullptr;

  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src =
          raw + static_cast<size_t>(first + i) * 2 * L::N + 2 * c0;
      uint8_t* dst = ring + (i & 1) * L::SLOT_A;
#pragma unroll
      for (int q = 0; q < L::COPIES_A; ++q) {
        const int e = tid + q * L::THREADS_A;
        const int row = e / L::PARTS;
        const int part = e % L::PARTS;
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
    float2* out = scratch + static_cast<size_t>(first + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      pfb_a_batch<LOG2N>(s, tile, own_frames, rows, h, j0 + i, taps, x,
                         twiddle, inter, out, c, t, c0);
    }
  }
  cp_async_wait<0>();
}

// PFB-L's pass A: large_streams_a whose batch takes the column's 16
// polyphase sums from the scratch, where pfb_sums_kernel wrote them in the
// threads' order in the place this batch writes its run (value k of
// thread tid at k THREADS_A + tid), in place of the raw frame: a batch's
// N1 B sums are copied as they lie into a ring of two slots by cp.async
// (sums_prefetch), the next batch's while this one is transformed, and a
// warp reads 256 bytes in a row of its slot; then pass A's passes and
// stores over them. Two blocks an SM (~99 KB each).
template <int LOG2N>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_A, 2)
large_pfb_sums_a(const float2* __restrict__ twiddle,   // pass_twiddles(N1)
                 const float2* __restrict__ inter,     // W_N^(k1 n2)
                 float2* scratch,   // (S*F, N): the sums in, pass A out
                 int F, int group, int G_s, const int* __restrict__ counts) {
  using L = LargeRegs<LOG2N>;
  constexpr int RUN = L::N1 * L::B;   // a batch's sums, 16 a thread
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  float2* ring = x + L::XBYTES_A / 8;
  const int tid = threadIdx.x;
  const int c = col_of<LOG2N>(tid);
  const int t = row_of<LOG2N>(tid);
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int batches = blk.frames * L::SUBS;
  // Batch q: frame q / SUBS of the block, columns (q mod SUBS) B + c of
  // its tile; its run is read (copied) before any thread stores it.
  auto run_of = [&](int q) {
    return scratch + static_cast<size_t>(blk.first + q / L::SUBS) * L::N +
           (c0 / L::B + q % L::SUBS) * RUN;
  };
  auto prefetch = [&](int q) {
    if (q < batches) {
      sums_prefetch(ring + (q & 1) * RUN, run_of(q), RUN, tid, L::THREADS_A);
    }
    cp_async_commit();
  };
  prefetch(0);
  for (int q = 0; q < batches; ++q) {
    prefetch(q + 1);
    cp_async_wait<1>();   // this thread's copies of batch q have landed
    __syncthreads();      // everyone's; x is free (batch q - 1's stores)
    const float2* slot = ring + (q & 1) * RUN + tid;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = slot[k * L::THREADS_A];
    first_pass<L::LOG2N1>(v, x, twiddle, t,
                          [c](int e) { return col_index<LOG2N>(c, e); });
    regs_a_rest<LOG2N>(q % L::SUBS, v, x, twiddle, inter,
                       scratch + static_cast<size_t>(blk.first +
                                                     q / L::SUBS) * L::N,
                       c, t, c0);
  }
  cp_async_wait<0>();
}

// Shared memory of large_pfb_sums_a: the exchange and two slots of a
// batch's sums.
template <int LOG2N>
constexpr int sums_a_smem() {
  return LargeRegs<LOG2N>::XBYTES_A +
         2 * LargeRegs<LOG2N>::N1 * LargeRegs<LOG2N>::B * 8;
}

// 16 bytes from global to shared memory by cp.async, or, where the source
// is not 16-byte aligned (a history or h that is a view), by four 4-byte
// copies.
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src,
                                               bool wide) {
  if (wide) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; b += 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_address(static_cast<uint8_t*>(dst) + b)),
                 "l"(static_cast<const uint8_t*>(src) + b)
                 : "memory");
  }
}

// Shared memory of large_pfb_ring_a at P taps: the exchange (which holds
// the two h tiles of the streamed form while a batch forms its sums), P
// raw tile slots, and in the resident form h's (P, N1, C) slice.
template <int LOG2N>
__host__ __device__ constexpr int ring_a_smem(int taps, bool resident) {
  using L = LargeRegs<LOG2N>;
  return L::XBYTES_A + taps * L::SLOT_A +
         (resident ? taps * L::N1 * L::C * 4 : 0);
}

// PFB-L's pass A on a ring of virtual rows: large_pfb_a's sums (p in
// order from zero, each product and sum rounded on its own, tap by tap
// over a thread's 16 samples) with every operand read from shared memory.
// The block's tile of the stream's virtual rows (P - 1 history rows, then
// the frames) lies in a ring of P slots, virtual row v in slot v mod P, in
// the own row's layout (ring_offset): its first output frame j0 loads rows
// j0 .. j0 + P - 1 once, and each later frame one row, j + P, into the slot
// of row j as soon as frame j's sums are formed, so that it lands during
// frame j's transform. h enters as whole 16-byte runs of a row: RESIDENT,
// the block's (P, N1, C) slice once, beside the ring; else tap by tap, the
// batch's (N1, B) tile of tap p + 1 copied into one half of the exchange
// while tap p is summed from the other (the exchange is free until the
// batch's first pass). The ring route of rpf_fused_psd_pfb_large; its
// frames a block from its own residency (ring_group).
template <int LOG2N, bool RESIDENT>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_A,
                                  RESIDENT ? 1 : 2)
large_pfb_ring_a(const uint8_t* __restrict__ raw,       // (S*F, 2N)
                 const uint8_t* __restrict__ history,   // (S, P-1, 2N)
                 const float* __restrict__ h,           // (P, N)
                 const float2* __restrict__ twiddle,    // pass_twiddles(N1)
                 const float2* __restrict__ inter,      // W_N^(k1 n2)
                 float2* __restrict__ scratch,          // (S*F, N)
                 int F, int group, int G_s, const int* __restrict__ counts,
                 int taps) {
  using L = LargeRegs<LOG2N>;
  constexpr int TF = L::TF1;
  constexpr int HTILE = L::N1 * L::B;   // floats of a (batch, tap) h tile
  constexpr int HSTRIDE = RESIDENT ? L::C : L::B;
  static_assert(L::B % 4 == 0, "an h tile row is whole 16-byte runs");
  static_assert(2 * HTILE * 4 <= L::XBYTES_A, "two h tiles fit the exchange");
  static_assert(HTILE / 4 == 4 * L::THREADS_A, "four h runs a thread");
  extern __shared__ float4 large_smem[];
  float2* x = reinterpret_cast<float2*>(large_smem);
  float* hx = reinterpret_cast<float*>(large_smem);
  uint8_t* ring = reinterpret_cast<uint8_t*>(large_smem) + L::XBYTES_A;
  float* hres = reinterpret_cast<float*>(ring + taps * L::SLOT_A);
  const int tid = threadIdx.x;
  const int c = col_of<LOG2N>(tid);
  const int t = row_of<LOG2N>(tid);
  const int c0 = (blockIdx.x % L::TILES_A) * L::C;
  const StreamsBlock blk = streams_block(L::TILES_A, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;
  if (frames == 0) return;
  const int stream = blockIdx.y;
  const int j0 = first - stream * F;
  const uint8_t* own = raw + static_cast<size_t>(stream) * F * 2 * L::N;
  const uint8_t* old =
      taps > 1 ? history + static_cast<size_t>(stream) * (taps - 1) * 2 * L::N
               : nullptr;
  const bool old_wide = (reinterpret_cast<uintptr_t>(old) & 15) == 0;
  const bool h_wide = (reinterpret_cast<uintptr_t>(h) & 15) == 0;

  // Virtual row v's tile into slot v mod P.
  auto load_row = [&](int v) {
    const bool hist = v < taps - 1;
    const uint8_t* src =
        (hist ? old + static_cast<size_t>(v) * 2 * L::N
              : own + static_cast<size_t>(v - (taps - 1)) * 2 * L::N) +
        2 * c0;
    uint8_t* dst = ring + (v % taps) * L::SLOT_A;
#pragma unroll
    for (int q = 0; q < L::COPIES_A; ++q) {
      const int e = tid + q * L::THREADS_A;
      const int row = e / L::PARTS;
      const int part = e % L::PARTS;
      cp_async_piece(dst + ring_offset<LOG2N>(row, part),
                     src + static_cast<size_t>(row) * 2 * L::N2 + 16 * part,
                     !hist || old_wide);
    }
  };
  // Batch s's h tile of tap p into half `half` of the exchange.
  auto load_h = [&](int s, int p, int half) {
    const float* src = h + static_cast<size_t>(p) * L::N + c0 + s * L::B;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * L::THREADS_A;
      const int row = e / (L::B / 4);
      const int part = e % (L::B / 4);
      cp_async_piece(hx + half * HTILE + row * L::B + 4 * part,
                     src + static_cast<size_t>(row) * L::N2 + 4 * part,
                     h_wide);
    }
    cp_async_commit();
  };

  for (int p = 0; p < taps; ++p) load_row(j0 + p);
  if constexpr (RESIDENT) {
    for (int e = tid; e < taps * L::N1 * (L::C / 4); e += L::THREADS_A) {
      const int p = e / (L::N1 * (L::C / 4));
      const int row = (e / (L::C / 4)) % L::N1;
      const int part = e % (L::C / 4);
      cp_async_piece(hres + (p * L::N1 + row) * L::C + 4 * part,
                     h + static_cast<size_t>(p) * L::N +
                         static_cast<size_t>(row) * L::N2 + c0 + 4 * part,
                     h_wide);
    }
  }
  cp_async_commit();
  for (int i = 0; i < frames; ++i) {
    const int j = j0 + i;
    cp_async_wait<0>();   // rows j .. j + P - 1 (and h's slice) have landed
    __syncthreads();      // everyone's; x is free (last pass of frame i-1)
    float2* out = scratch + static_cast<size_t>(first + i) * L::N;
#pragma unroll 1
    for (int s = 0; s < L::SUBS; ++s) {
      if (s > 0) __syncthreads();   // x is free (last pass of batch s - 1)
      const int col = s * L::B + c;
      const int byte = 2 * col;
      float2 v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = make_float2(0.0f, 0.0f);
      if constexpr (!RESIDENT) load_h(s, 0, 0);
      for (int p = 0; p < taps; ++p) {
        const uint8_t* tile = ring + ((j + p) % taps) * L::SLOT_A;
        const float* hp;
        if constexpr (RESIDENT) {
          hp = hres + p * L::N1 * L::C + col;
        } else {
          if (p + 1 < taps) {
            load_h(s, p + 1, (p + 1) & 1);
            cp_async_wait<1>();   // tap p's tile has landed
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          hp = hx + (p & 1) * HTILE + c;
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int row = t + k * TF;
          const unsigned u = *reinterpret_cast<const uint16_t*>(
              tile + ring_offset<LOG2N>(row, byte >> 4) + (byte & 15));
          const float hv = hp[row * HSTRIDE];
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & 0xFFu), hv));
          v[k].y = __fadd_rn(v[k].y, __fmul_rn(dequant_byte(u >> 8), hv));
        }
        // Every thread has read tap p's h before tap p + 2's copy (and
        // the exchange before the first pass).
        if constexpr (!RESIDENT) __syncthreads();
      }
      if (s == L::SUBS - 1 && i + 1 < frames) {
        if constexpr (RESIDENT) __syncthreads();   // row j's slot is read
        load_row(j + taps);
        cp_async_commit();
      }
      first_pass<L::LOG2N1>(v, x, twiddle, t,
                            [c](int e) { return col_index<LOG2N>(c, e); });
      regs_a_rest<LOG2N>(s, v, x, twiddle, inter, out, c, t, c0);
    }
  }
  cp_async_wait<0>();
}

// SK-L's pass B: large_streams_b with a sum of |X|^4 beside each sum of
// |X|^2 (the latter large_regs_b's expression), the s1 row of block (x,
// s) to row r = s G_s + x / TILES_B of `rows` (at r * row_stride) and the
// s2 row plane_stride floats after it, each staged by bin through the
// exchange as pass B stages its row: partial rows (2, S*G_s, N) with
// row_stride N and plane_stride S G_s N, or, with one group a stream, the
// (S, 2, N) output itself, row_stride 2N and plane_stride N. One block an
// SM where N2 >= 512 (255 registers), where two (128) spill 216-232 B a
// thread and ran 1.17x slower at 2^20 F = 8; two below, where they spill
// nothing (probes/large_estimator_builds.py on an H100).
template <int LOG2N>
__global__ void __launch_bounds__(LargeRegs<LOG2N>::THREADS_B,
                                  LargeRegs<LOG2N>::N2 >= 512 ? 1 : 2)
large_sk_b(const float2* __restrict__ scratch,   // (S*F, N)
           const float2* __restrict__ twiddle,   // pass_twiddles(N2)
           float* __restrict__ rows,
           int F, int group, int G_s, const int* __restrict__ counts,
           int row_stride, int plane_stride) {
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
  const StreamsBlock blk = streams_block(L::TILES_B, F, group, G_s, counts);
  const int first = blk.first;
  const int frames = blk.frames;

  float acc[16];
  float acc2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    acc[k] = 0.0f;
    acc2[k] = 0.0f;
  }

  constexpr int kFrameBytes = L::RUNS * L::RUN * 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L::SLOT_B);
  const float2* ring2 = reinterpret_cast<const float2*>(ring);
  auto prefetch = [&](int i) {
    if (i < frames) {
      copy_runs<LOG2N>(ring,
                       scratch + static_cast<size_t>(first + i) * L::N +
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
    for (int k = 0; k < 16; ++k) {
      const float pw = v[k].x * v[k].x + v[k].y * v[k].y;
      acc[k] += pw;
      acc2[k] += pw * pw;
    }
  }

  // Each plane's bins k0 + r + N1 k2 through shared memory, as pass B
  // writes its row.
  float* by_bin = reinterpret_cast<float*>(large_smem);
#pragma unroll 1
  for (int plane = 0; plane < 2; ++plane) {
    __syncthreads();   // every row is done with the exchange (its reads)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int k2 = pass_bin<L::LOG2N2>(last_element<L::LOG2N2>(t, k));
      by_bin[r * L::XSR + pad_index(k2)] = plane == 0 ? acc[k] : acc2[k];
    }
    __syncthreads();
    float* out = rows + static_cast<size_t>(plane) * plane_stride +
                 static_cast<size_t>(blk.rest) * row_stride;
#pragma unroll 4
    for (int j = tid; j < L::B2 * L::N2; j += L::THREADS_B) {
      const int rr = j % L::B2;
      const int k2 = j / L::B2;
      out[k0 + rr + (k2 << L::LOG2N1)] = by_bin[rr * L::XSR + pad_index(k2)];
    }
  }
}

// The passes of this library, as the attributes entry numbers them: L-S's
// pass A unwindowed (0) and windowed (1), pass B (2), and the forms' own
// SK pass B (3), PFB pass A (4), the PFB's pre-pass at the tap classes 4
// (5) and 32 (6), the control's PFB pass A (7), and the PFB's pass A on
// the ring, h streamed (8) and h resident (9), at P = 4.
constexpr int kPasses = 10;
constexpr int kPfbPassA = 4;
constexpr int kPfbControlA = 7;
constexpr int kPfbRingA = 8;
constexpr int kPfbRingResA = 9;
// The ring's dynamic shared memory opt-in at every P: a block's most.
constexpr int kRingSmemMax = 232448;

// The ring route exists where an h tile row is whole 16-byte runs (B >= 4:
// N <= 2^21).
template <int LOG2N>
constexpr bool ring_built() {
  return LargeRegs<LOG2N>::B % 4 == 0;
}

template <int LOG2N>
const void* pass_kernel(int which) {
  if constexpr (ring_built<LOG2N>()) {
    if (which == kPfbRingA) {
      return reinterpret_cast<const void*>(large_pfb_ring_a<LOG2N, false>);
    }
    if (which == kPfbRingResA) {
      return reinterpret_cast<const void*>(large_pfb_ring_a<LOG2N, true>);
    }
  }
  switch (which) {
    case 0: return reinterpret_cast<const void*>(large_streams_a<LOG2N, false>);
    case 1: return reinterpret_cast<const void*>(large_streams_a<LOG2N, true>);
    case 2: return reinterpret_cast<const void*>(large_streams_b<LOG2N>);
    case 3: return reinterpret_cast<const void*>(large_sk_b<LOG2N>);
    case 4: return reinterpret_cast<const void*>(large_pfb_sums_a<LOG2N>);
    case 5: return sums_kernel<4>();
    case 6: return sums_kernel<32>();
    default: return reinterpret_cast<const void*>(large_pfb_a<LOG2N>);
  }
}

template <int LOG2N>
constexpr int pass_smem(int which) {
  return which == 2 || which == 3 ? LargeRegs<LOG2N>::SMEM_B
         : which == kPfbPassA     ? sums_a_smem<LOG2N>()
         : which == 5 || which == 6 ? 0
         : which == kPfbRingA       ? ring_a_smem<LOG2N>(4, false)
         : which == kPfbRingResA    ? ring_a_smem<LOG2N>(4, true)
                                    : LargeRegs<LOG2N>::SMEM_A;
}

template <int LOG2N>
constexpr int pass_threads(int which) {
  return which == 2 || which == 3 ? LargeRegs<LOG2N>::THREADS_B
         : which == 5 || which == 6 ? kSumsThreads
                                    : LargeRegs<LOG2N>::THREADS_A;
}

// The devices (a bit each) on which a pass at N = 2^LOG2N is opted into
// its shared memory and the largest carveout, as the large kernel's
// prepare_streams opts its passes in.
template <int LOG2N>
std::atomic<unsigned long long> pass_done[kPasses];

template <int LOG2N>
cudaError_t prepare(int which, int device) {
  const int smem = which == kPfbRingA || which == kPfbRingResA
                       ? kRingSmemMax
                       : pass_smem<LOG2N>(which);
  if (smem <= 48 * 1024) return cudaSuccess;
  std::atomic<unsigned long long>& done = pass_done<LOG2N>[which];
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
    return cudaSuccess;
  }
  const void* kernel = pass_kernel<LOG2N>(which);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// A form's launch: S streams of F frames, frames a block of passes A and
// B, the counts on the card, the buffers and the large kernel's tables.
struct Launch {
  const uint8_t* raw;
  const float2* twiddle;   // pass_twiddles(N1) then pass_twiddles(N2)
  const float2* inter;
  const int* counts;
  float2* scratch;
  int S, F, group_a, group_b;
  cudaStream_t st;

  int g_a() const { return (F + group_a - 1) / group_a; }
  int g_b() const { return (F + group_b - 1) / group_b; }
};

// Pass A as L-S runs it (windowed by `window` where given), on `l.st`.
template <int LOG2N>
cudaError_t launch_a(const Launch& l, const float* window, int device) {
  using L = LargeRegs<LOG2N>;
  const cudaError_t e = prepare<LOG2N>(window ? 1 : 0, device);
  if (e != cudaSuccess) return e;
  const dim3 grid(l.g_a() * L::TILES_A, l.S);
  if (window) {
    large_streams_a<LOG2N, true><<<grid, L::THREADS_A, L::SMEM_A, l.st>>>(
        l.raw, l.twiddle, l.inter, window, l.scratch, l.F, l.group_a,
        l.g_a(), l.counts);
  } else {
    large_streams_a<LOG2N, false><<<grid, L::THREADS_A, L::SMEM_A, l.st>>>(
        l.raw, l.twiddle, l.inter, nullptr, l.scratch, l.F, l.group_a,
        l.g_a(), l.counts);
  }
  return cudaGetLastError();
}

// pass_twiddles(N2), after pass_twiddles(N1) in the table.
template <int LOG2N>
const float2* twiddle_b(const Launch& l) {
  using P1 = RegsPlan<LargeRegs<LOG2N>::LOG2N1>;
  return l.twiddle + P1::twiddle_offset(P1::PASSES - 1);
}

// Pass B as L-S runs it, each stream's partial rows to `rows`, on `l.st`.
template <int LOG2N>
cudaError_t launch_b(const Launch& l, float* rows, int device) {
  using L = LargeRegs<LOG2N>;
  const cudaError_t e = prepare<LOG2N>(2, device);
  if (e != cudaSuccess) return e;
  large_streams_b<LOG2N>
      <<<dim3(l.g_b() * L::TILES_B, l.S), L::THREADS_B, L::SMEM_B, l.st>>>(
          l.scratch, twiddle_b<LOG2N>(l), rows, l.F, l.group_b, l.g_b(),
          l.counts);
  return cudaGetLastError();
}

// SK-L: pass A, SK's pass B and, with the gate or more than one group a
// stream, the sum of each stream's rows; else pass B writes the output
// rows itself (a float64 sum of one row from 0.0 is that row).
template <int LOG2N>
cudaError_t launch_sk(const Launch& l, const float* window, float* partial,
                      float* out, float two_sigma, int device) {
  using L = LargeRegs<LOG2N>;
  cudaError_t e = launch_a<LOG2N>(l, window, device);
  if (e == cudaSuccess) e = prepare<LOG2N>(3, device);
  if (e != cudaSuccess) return e;
  const bool direct = two_sigma == 0.0f && l.g_b() == 1;
  large_sk_b<LOG2N>
      <<<dim3(l.g_b() * L::TILES_B, l.S), L::THREADS_B, L::SMEM_B, l.st>>>(
          l.scratch, twiddle_b<LOG2N>(l), direct ? out : partial, l.F,
          l.group_b, l.g_b(), l.counts, direct ? 2 * L::N : L::N,
          direct ? L::N : l.S * l.g_b() * L::N);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return two_sigma > 0.0f
             ? launch_est_streams<kEstSkGate>(partial, l.S, l.g_b(), 1, L::N,
                                              l.counts, l.F, 0, two_sigma,
                                              out, l.st)
             : launch_est_streams<kEstSk>(partial, l.S, l.g_b(), 1, L::N,
                                          l.counts, l.F, 0, two_sigma, out,
                                          l.st);
}

template <int LOG2N>
cudaError_t launch_tapers(const Launch& l, const float* tapers, int K,
                          float* partial, float* out, int device) {
  using L = LargeRegs<LOG2N>;
  const size_t plane = static_cast<size_t>(l.S) * l.g_b() * L::N;
  for (int k = 0; k < K; ++k) {
    cudaError_t e = launch_a<LOG2N>(
        l, tapers + static_cast<size_t>(k) * L::N, device);
    if (e == cudaSuccess) e = launch_b<LOG2N>(l, partial + k * plane, device);
    if (e != cudaSuccess) return e;
  }
  return launch_est_streams<kEstTapers>(partial, l.S, l.g_b(), K, L::N,
                                        l.counts, l.F, K, 0.0f, out, l.st);
}

// PFB-L's routes (kPfbRoute): the pre-pass and large_pfb_sums_a; the
// first form's large_pfb_a (the sums in its load); the ring of virtual
// rows, large_pfb_ring_a, h streamed tap by tap or resident.
enum PfbRoute { kRouteSums = 0, kRouteLoad = 1, kRouteRing = 2,
                kRouteRingRes = 3 };

// Frames a block of the ring's pass A over S streams of F frames at P
// taps: the fewest for which its blocks at this P's shared memory fit the
// card at once, as fused_psd_large.large_group takes pass A's from its
// residency (the ring's rows enter a block once over its frames).
template <int LOG2N, bool RESIDENT>
cudaError_t ring_group(const Launch& l, int P, int device, int* group) {
  using L = LargeRegs<LOG2N>;
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, large_pfb_ring_a<LOG2N, RESIDENT>, L::THREADS_A,
      ring_a_smem<LOG2N>(P, RESIDENT));
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int fit = per_sm * sms / (l.S * L::TILES_A);
  *group = (l.F + (fit > 1 ? fit : 1) - 1) / (fit > 1 ? fit : 1);
  return e;
}

template <int LOG2N, bool RESIDENT>
cudaError_t launch_ring(const Launch& l, const uint8_t* history,
                        const float* h, int P, int device) {
  using L = LargeRegs<LOG2N>;
  cudaError_t e = prepare<LOG2N>(RESIDENT ? kPfbRingResA : kPfbRingA, device);
  int group = l.F;
  if (e == cudaSuccess) e = ring_group<LOG2N, RESIDENT>(l, P, device, &group);
  if (e != cudaSuccess) return e;
  const int G = (l.F + group - 1) / group;
  large_pfb_ring_a<LOG2N, RESIDENT>
      <<<dim3(G * L::TILES_A, l.S), L::THREADS_A,
         ring_a_smem<LOG2N>(P, RESIDENT), l.st>>>(
          l.raw, history, h, l.twiddle, l.inter, l.scratch, l.F, group, G,
          l.counts, P);
  return cudaGetLastError();
}

// PFB-L on a route: its pass A, then pass B and the sum.
template <int LOG2N>
cudaError_t launch_pfb(const Launch& l, const uint8_t* history,
                       const float* h, int P, float* partial, float* out,
                       int device, int route) {
  using L = LargeRegs<LOG2N>;
  const dim3 grid(l.g_a() * L::TILES_A, l.S);
  cudaError_t e = cudaSuccess;
  if (route == kRouteRing || route == kRouteRingRes) {
    // The table gives the ring only where it is built and fits at every P
    // of the class (tests/test_torch_estimators_large.py holds it).
    if constexpr (ring_built<LOG2N>()) {
      if (ring_a_smem<LOG2N>(P, route == kRouteRingRes) > kRingSmemMax) {
        return cudaErrorInvalidValue;
      }
      e = route == kRouteRing
              ? launch_ring<LOG2N, false>(l, history, h, P, device)
              : launch_ring<LOG2N, true>(l, history, h, P, device);
    } else {
      e = cudaErrorInvalidValue;
    }
  } else if (route == kRouteLoad) {
    e = prepare<LOG2N>(kPfbControlA, device);
    if (e != cudaSuccess) return e;
    large_pfb_a<LOG2N><<<grid, L::THREADS_A, L::SMEM_A, l.st>>>(
        l.raw, history, h, l.twiddle, l.inter, l.scratch, l.F, l.group_a,
        l.g_a(), l.counts, P);
    e = cudaGetLastError();
  } else {
    e = prepare<LOG2N>(kPfbPassA, device);
    if (e != cudaSuccess) return e;
    const SumsShape shape{L::N,          L::LOG2N2,     L::LOG2N1,
                          log2_of(L::B), log2_of(L::V), L::N1,
                          L::N};
    e = launch_pfb_sums(l.raw, history, h, l.scratch, shape, l.S, l.F, P,
                        l.counts, l.st);
    if (e != cudaSuccess) return e;
    large_pfb_sums_a<LOG2N><<<grid, L::THREADS_A, sums_a_smem<LOG2N>(),
                              l.st>>>(
        l.twiddle, l.inter, l.scratch, l.F, l.group_a, l.g_a(), l.counts);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    e = launch_b<LOG2N>(l, l.g_b() == 1 ? out : partial, device);
  }
  if (e != cudaSuccess || l.g_b() == 1) return e;
  return launch_rows_sum(partial, l.S, l.g_b(), L::N, out, l.st);
}

// fn(std::integral_constant<int, log2n>) for an instantiated log2n.
template <typename Fn>
cudaError_t at_log2n(int log2n, Fn fn) {
  switch (log2n) {
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

// The checks every entry makes of a launch at N = 2^log2n.
bool launch_ok(const Launch& l, int log2n) {
  return log2n >= kMinLog2N && log2n <= kMaxLog2N && l.S > 0 &&
         l.S <= kMaxGridY && l.F > 0 && l.group_a > 0 && l.group_b > 0 &&
         l.raw != nullptr && reinterpret_cast<uintptr_t>(l.raw) % 16 == 0 &&
         l.twiddle != nullptr && l.inter != nullptr && l.counts != nullptr &&
         l.scratch != nullptr;
}

Launch make_launch(const void* raw, const void* twiddle, const void* inter,
                   const void* counts, void* scratch, int S, int F,
                   int group_a, int group_b, void* stream) {
  return {static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float2*>(inter),
          static_cast<const int*>(counts),
          static_cast<float2*>(scratch),
          S, F, group_a, group_b,
          static_cast<cudaStream_t>(stream)};
}

// PFB-L's route at N = 2^log2n, P taps and S F frames a call
// (fused_psd_large_est.PFB_ROUTE mirrors it), by log2 N, few (S F <
// kPfbManyFrames) or many frames, and the tap class of P (sums_taps: 2, 4,
// 8, 16, 32), a PfbRoute: whichever took the least device time on an H100
// at 16, 64 and 256 frames up to 2^17 and at 8 to 64 above
// (probes/large_estimator_builds.py, route sweep). At N1 <= 256 and few
// frames a half-warp of the first form loads 16 adjacent columns, and a
// few taps re-read from L2 cost less than the ring's copies or the sums'
// trip through device memory; with many frames a block, or from N1 = 512,
// the ring's rows and h enter a block once. The ring routes are given
// only where every P of the class fits a block's shared memory
// (ring_a_smem) and the ring is built.
constexpr int kPfbManyFrames = 64;
constexpr unsigned char kPfbRoute[kMaxLog2N - kMinLog2N + 1][2][5] = {
    {{1, 1, 1, 1, 1}, {3, 3, 3, 0, 0}},   // 2^15
    {{1, 1, 1, 1, 1}, {1, 3, 3, 0, 0}},   // 2^16
    {{1, 1, 3, 0, 0}, {1, 3, 3, 0, 0}},   // 2^17
    {{2, 2, 0, 0, 0}, {2, 2, 0, 0, 0}},   // 2^18
    {{2, 2, 0, 0, 0}, {2, 2, 0, 0, 0}},   // 2^19
    {{3, 3, 0, 0, 0}, {3, 3, 0, 0, 0}},   // 2^20
    {{3, 3, 0, 0, 0}, {3, 3, 0, 0, 0}},   // 2^21
    {{0, 0, 0, 0, 0}, {0, 0, 0, 0, 0}},   // 2^22
};

// PFB-L's entry: by the route, or with `control` the first form.
int pfb_entry(const void* raw, const void* history, const void* twiddle,
              const void* inter, const void* h, const void* counts,
              void* scratch, void* partial, void* out, void* history_out,
              int device, int log2n, int S, int F, int group_a, int group_b,
              int P, int fresh, void* stream, bool control) {
  const Launch l = make_launch(raw, twiddle, inter, counts, scratch, S, F,
                               group_a, group_b, stream);
  if (!launch_ok(l, log2n) || P < 1 || P > 32 || h == nullptr ||
      out == nullptr ||
      (P > 1 && (history == nullptr || history_out == nullptr ||
                 history == history_out ||
                 reinterpret_cast<uintptr_t>(history) % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(history_out) % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bins = 1 << log2n;
  cudaError_t e = use_device(device);
  if (e == cudaSuccess && fresh && P > 1) {
    e = cudaMemsetAsync(const_cast<void*>(history), 127,
                        static_cast<size_t>(S) * (P - 1) * 2 * bins, l.st);
  }
  if (e == cudaSuccess) {
    e = at_log2n(log2n, [&](auto n) {
      return launch_pfb<decltype(n)::value>(
          l, static_cast<const uint8_t*>(history),
          static_cast<const float*>(h), P, static_cast<float*>(partial),
          static_cast<float*>(out), device,
          control ? kRouteLoad
                  : kPfbRoute[log2n - kMinLog2N][S * F >= kPfbManyFrames]
                             [log2_of(sums_taps(P)) - 1]);
    });
  }
  if (e != cudaSuccess || P == 1) return static_cast<int>(e);
  return static_cast<int>(launch_pfb_history(raw, history, history_out,
                                             counts, S, F, P, 2 * bins,
                                             l.st));
}

}  // namespace

extern "C" {

// SK-L: launches pass A, SK's pass B and the sum on `stream`. raw: (S*F,
// 2N) u8, 16-byte aligned, stream s in rows [s F, s F + F); twiddle:
// pass_twiddles(N1) then pass_twiddles(N2); inter: the large kernel's
// inter-stage twiddle in scratch's order (fused_psd_large.
// regs_inter_twiddle); window: (N,) f32, or null; counts: (S,) int32 on
// the device, each stream's valid frames (read when the passes run; a
// count outside [0, F] acts as its nearest bound); scratch: (S*F, N)
// complex64; partial: (2, S * ceil(F / group_b), N) f32; out: (S, 2, N)
// f32 (s1, s2 of each stream), or with two_sigma > 0 (S, 4, N), each
// stream gated on its own moments and count; N = 2^log2n, 15..22. Returns
// a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_sk_large(const void* raw, const void* twiddle,
                           const void* inter, const void* window,
                           const void* counts, void* scratch, void* partial,
                           void* out, int device, int log2n, int S, int F,
                           int group_a, int group_b, float two_sigma,
                           void* stream) {
  const Launch l = make_launch(raw, twiddle, inter, counts, scratch, S, F,
                               group_a, group_b, stream);
  if (!launch_ok(l, log2n) || !(two_sigma >= 0.0f) || partial == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2n(log2n, [&](auto n) {
      return launch_sk<decltype(n)::value>(
          l, static_cast<const float*>(window), static_cast<float*>(partial),
          static_cast<float*>(out), two_sigma, device);
    });
  }
  return static_cast<int>(e);
}

// MT-L: tapers: (K, N) f32, 1 <= K <= 32, shared by the streams; partial:
// (K, S * ceil(F / group_b), N) f32; out: (S, N) f32. Other arguments as
// rpf_fused_psd_sk_large.
int rpf_fused_psd_tapers_large(const void* raw, const void* twiddle,
                               const void* inter, const void* tapers,
                               const void* counts, void* scratch,
                               void* partial, void* out, int device,
                               int log2n, int S, int F, int group_a,
                               int group_b, int K, void* stream) {
  const Launch l = make_launch(raw, twiddle, inter, counts, scratch, S, F,
                               group_a, group_b, stream);
  if (!launch_ok(l, log2n) || K < 1 || K > 32 || tapers == nullptr ||
      partial == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2n(log2n, [&](auto n) {
      return launch_tapers<decltype(n)::value>(
          l, static_cast<const float*>(tapers), K,
          static_cast<float*>(partial), static_cast<float*>(out), device);
    });
  }
  return static_cast<int>(e);
}

// PFB-L: history, history_out: (S, P - 1, 2N) u8, distinct, 4-byte
// aligned (null when P = 1), stream s's rows together; h: (P, N) f32, 1 <=
// P <= 32; partial: (S * ceil(F / group_b), N) f32 (unused for one row a
// stream); out: (S, N) f32; fresh: set every stream's history to byte 127
// first. After the sum, each stream's next history (rows n_valid[s] ..
// n_valid[s] + P - 2 of its virtual array) is written to history_out on
// the stream (pfb_history.cuh). Pass A by the route (kPfbRoute). Other
// arguments as rpf_fused_psd_sk_large.
int rpf_fused_psd_pfb_large(const void* raw, const void* history,
                            const void* twiddle, const void* inter,
                            const void* h, const void* counts, void* scratch,
                            void* partial, void* out, void* history_out,
                            int device, int log2n, int S, int F, int group_a,
                            int group_b, int P, int fresh, void* stream) {
  return pfb_entry(raw, history, twiddle, inter, h, counts, scratch, partial,
                   out, history_out, device, log2n, S, F, group_a, group_b,
                   P, fresh, stream, false);
}

// The control of rpf_fused_psd_pfb_large, the same arguments: PFB-L's
// first form, the sums in pass A's load (large_pfb_a).
int rpf_fused_psd_pfb_large_control(const void* raw, const void* history,
                                    const void* twiddle, const void* inter,
                                    const void* h, const void* counts,
                                    void* scratch, void* partial, void* out,
                                    void* history_out, int device, int log2n,
                                    int S, int F, int group_a, int group_b,
                                    int P, int fresh, void* stream) {
  return pfb_entry(raw, history, twiddle, inter, h, counts, scratch, partial,
                   out, history_out, device, log2n, S, F, group_a, group_b,
                   P, fresh, stream, true);
}

// Writes what a pass gets at N = 2^log2n on `device` into attrs[0..5]
// (which: 0 pass A, 1 pass A windowed, 2 pass B, 3 SK's pass B, 4 the
// PFB's pass A, 5 and 6 its pre-pass at P <= 4 and P <= 32, 7 the
// control's PFB pass A, 8 and 9 the PFB's pass A on the ring at P = 4, h
// streamed and h resident, N <= 2^21): registers and local (spill) bytes a
// thread, static and dynamic shared bytes a block, threads a block, and
// the blocks that reside on one SM. Launches nothing.
int rpf_fused_psd_large_est_attributes(int log2n, int which, int device,
                                       int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || which < 0 ||
      which >= kPasses || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e == cudaSuccess) {
    e = at_log2n(log2n, [&](auto n) {
      constexpr int L = decltype(n)::value;
      if (!ring_built<L>() &&
          (which == kPfbRingA || which == kPfbRingResA)) {
        return cudaErrorInvalidValue;
      }
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
