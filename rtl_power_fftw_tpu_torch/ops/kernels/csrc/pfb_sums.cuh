// The PFB's polyphase sums as a pass of their own, for the PFB forms of
// the large kernel's register passes (fused_psd_large_est.cu: PFB-L) and
// of BL's (fused_psd_chirp_large_est.cu: PFB-BL), one stream or S.
//
// Those forms' first pass A (large_pfb_a, chirp_pfb_a, kept as the
// controls) formed each sum in its load: the frame's own row from the
// ring, the P - 1 older rows and h (P, N) gathered sample by sample in the
// column order of the transform. From N1 = 512 a half-warp is 16 threads
// of one column there, so each 2-byte row load and each 4-byte h load
// touched 16 sectors, and the older rows and h were read again for every
// output frame (h 64 MB a frame at 2^22, P = 4, above the 50 MB L2).
//
// Here one streaming kernel forms every sum first. A block is 16 rows x
// 32 columns of a frame's (n1, n2) array (n = n1 N2 + n2), two adjacent
// samples a thread, so a warp reads two 64-byte runs of each raw row and
// two 128-byte runs of each h row, over a group of a stream's frames
// (sums_frames: enough groups that the grid fills the card). Each thread
// holds h[0 .. P-1] of its samples and their P - 1 older rows (raw bytes)
// in registers and slides over its stream's virtual array (P - 1 history
// rows, then the frames) from its group's first frame: one new row a
// frame, h read once a group, eight frames' rows in flight. It writes
// S_j[n] (float2) into frame j's scratch in the order pass A's threads
// read their batch (sums_place): value k of thread tid of batch b of tile
// c0 at (c0 / B + b) N1 B + k THREADS_A + tid, which is where that batch
// writes its run, so that pass A copies a batch's sums as they lie into
// its ring (sums_prefetch) and the sums take no memory beyond the
// scratch. Where a half-warp of pass A is 16 threads of one column (B <
// 16) the block turns its sums through shared memory (a column of 16
// rows a 17-slot run, so that the stores into it conflict at most two
// ways and the loads not at all) so that a warp writes 256 bytes in a
// row.
//
// The sums' rounding is the controls': p in order from zero, each product
// and sum rounded on its own (__fmul_rn, __fadd_rn: nvcc contracts a * b
// + c into an FMA otherwise), from 0.0f; so pass A transforms the same
// values and the forms' outputs are the controls' bits.
//
// What bounds it on an H100: its bytes, the frames and the history once
// (2 bytes a sample), h once (4 P bytes) and the sums (8 bytes a sample a
// frame), which pass A reads back in place of the frames: 14 F N bytes
// more than the base kernel moves, ~170 us at 2^22, F = 8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_psd_regs.cuh"   // dequant_byte

namespace {

// A block: kSumsRows rows of kSumsCols samples, two a thread.
constexpr int kSumsRows = 16;
constexpr int kSumsCols = 32;
constexpr int kSumsThreads = kSumsRows * kSumsCols / 2;
// Frames whose own rows a thread has in flight at once.
constexpr int kSumsDepth = 8;
// The turn's float2 a column of the block (its 16 rows and a pad).
constexpr int kSumsTurn = kSumsRows + 1;
// The blocks the pre-pass's grid aims at (about two waves of 8 a SM on
// an H100's 132 SMs): its frames split into groups until it has them.
constexpr int kSumsBlocks = 2048;

// Where a form's frames and sums lie: bins samples a frame (2 bins bytes a
// raw row); the (n1, n2) array of N1 = 2^log2n1 rows of N2 = 2^log2n2
// columns (rows: those with a sample, N1 or BL's M1 / 2); pass A's batch
// of B = 2^log2b columns, V = 2^log2v of them side by side in a
// half-warp (col_shape); `frame` float2 of scratch a frame (N or M).
struct SumsShape {
  int bins;
  int log2n2;
  int log2n1;
  int log2b;
  int log2v;
  int rows;
  int frame;
};

// Where pass A's thread reads sample (n1, n2) of a frame: thread tid =
// (c mod V) + V (t mod 16/V) + 16 (c / V + (B / V)(t / (16 / V))) of
// column c = n2 mod B (col_of, row_of of fused_psd_large_regs.cuh
// inverted) holds it as value k of its batch, n1 = t + k TF1.
__host__ __device__ __forceinline__ int sums_place(const SumsShape& s,
                                                   int n1, int n2) {
  const int b = 1 << s.log2b;
  const int v = 1 << s.log2v;
  const int tf = 1 << (s.log2n1 - 4);   // TF1 = N1 / 16
  const int c = n2 & (b - 1);
  const int t = n1 & (tf - 1);
  const int k = n1 >> (s.log2n1 - 4);
  const int per = 16 >> s.log2v;        // threads of a column a half-warp
  const int tid = (c & (v - 1)) + v * (t % per) +
                  16 * ((c >> s.log2v) + (b >> s.log2v) * (t / per));
  return ((n2 >> s.log2b) << (s.log2n1 + s.log2b)) + k * b * tf + tid;
}

// The sum of one sample: p in order from zero over the window's P - 1
// older rows (byte `shift` of each packed word) and the own row, each
// product and sum rounded on its own.
template <int TAPS>
__device__ __forceinline__ float2 pfb_tap_sum(const unsigned (&win)[TAPS - 1],
                                              const float (&hv)[TAPS],
                                              unsigned own, int shift,
                                              int taps) {
  float re = 0.0f;
  float im = 0.0f;
#pragma unroll
  for (int p = 0; p < TAPS - 1; ++p) {
    if (p < taps - 1) {
      re = __fadd_rn(re, __fmul_rn(dequant_byte((win[p] >> shift) & 0xFFu),
                                   hv[p]));
      im = __fadd_rn(im,
                     __fmul_rn(dequant_byte((win[p] >> (shift + 8)) & 0xFFu),
                               hv[p]));
    }
  }
  re = __fadd_rn(re, __fmul_rn(dequant_byte((own >> shift) & 0xFFu),
                               hv[TAPS - 1]));
  im = __fadd_rn(im, __fmul_rn(dequant_byte((own >> (shift + 8)) & 0xFFu),
                               hv[TAPS - 1]));
  return make_float2(re, im);
}

// Each stream's sums S_j[n], j < n_valid[s] (the count read on the card,
// clamped to [0, F]), on grid ((rows / 16) (N2 / 32), S, ceil(F /
// group)): block (x, s, g) forms frames [g group, (g + 1) group) of
// stream s. TAPS: the tap count rounded up to the class the registers are
// sized for (P <= TAPS); h0, h1[TAPS - 1] are the own row's tap, h[P - 1].
// Two blocks an SM at least: at TAPS = 32 the registers ptxas chose
// otherwise (147) left one.
template <int TAPS>
__global__ void __launch_bounds__(kSumsThreads, 2)
pfb_sums_kernel(const uint8_t* __restrict__ raw,       // (S*F, 2 bins)
                const uint8_t* __restrict__ history,   // (S, P-1, 2 bins)
                const float* __restrict__ h,           // (P, bins)
                float2* __restrict__ sums,             // (S*F, frame)
                SumsShape shape, int F, int group, int taps,
                const int* __restrict__ counts) {
  __shared__ float2 turn[kSumsTurn * kSumsCols];
  const int cols = (1 << shape.log2n2) / kSumsCols;
  const int r0 = (blockIdx.x / cols) * kSumsRows;
  const int q0 = (blockIdx.x % cols) * kSumsCols;
  const int r = threadIdx.x / (kSumsCols / 2);
  const int q = 2 * (threadIdx.x % (kSumsCols / 2));
  const int n = ((r0 + r) << shape.log2n2) + q0 + q;   // and n + 1
  const bool valid = r0 + r < shape.rows && n < shape.bins;
  const int s = blockIdx.y;
  const int first = blockIdx.z * group;
  const int last = min(first + group, min(max(__ldg(counts + s), 0), F));
  const size_t words = static_cast<size_t>(shape.bins) / 2;   // a raw row
  const unsigned* own =
      reinterpret_cast<const unsigned*>(raw) + s * F * words + n / 2;
  const unsigned* old = reinterpret_cast<const unsigned*>(history) +
                        s * static_cast<size_t>(taps - 1) * words + n / 2;
  // Taps 0 .. P - 2 of frame `first`: virtual rows first .. first + P - 2,
  // the history's rows, then the frames'.
  unsigned win[TAPS - 1];
  float h0[TAPS];
  float h1[TAPS];
#pragma unroll
  for (int p = 0; p < TAPS - 1; ++p) {
    win[p] = 0u;
    h0[p] = 0.0f;
    h1[p] = 0.0f;
    if (valid && p < taps - 1 && first < last) {
      const int v = first + p;
      win[p] = __ldg(v < taps - 1 ? old + v * words
                                  : own + (v - (taps - 1)) * words);
      h0[p] = __ldg(h + p * static_cast<size_t>(shape.bins) + n);
      h1[p] = __ldg(h + p * static_cast<size_t>(shape.bins) + n + 1);
    }
  }
  h0[TAPS - 1] = valid ? __ldg(h + (taps - 1) * static_cast<size_t>(
                                       shape.bins) + n) : 0.0f;
  h1[TAPS - 1] = valid ? __ldg(h + (taps - 1) * static_cast<size_t>(
                                       shape.bins) + n + 1) : 0.0f;
  const bool turned = shape.log2b < 4;   // B < 16: through shared memory
  float2* out = sums + static_cast<size_t>(s) * F * shape.frame;
  // The places this thread writes: its own samples', or after the turn
  // those of samples i = threadIdx.x and i + kSumsThreads of the block, i
  // at (i mod 16, i / 16) and in turn[(i / 16) kSumsTurn + i mod 16].
  int place0, place1;
  bool write0 = valid, write1 = valid;
  if (turned) {
    const int i = threadIdx.x;
    const int rr = r0 + i % kSumsRows;
    const int c0 = q0 + i / kSumsRows;
    const int c1 = c0 + kSumsThreads / kSumsRows;
    place0 = sums_place(shape, rr, c0);
    place1 = sums_place(shape, rr, c1);
    write0 = rr < shape.rows && (rr << shape.log2n2) + c0 < shape.bins;
    write1 = rr < shape.rows && (rr << shape.log2n2) + c1 < shape.bins;
  } else {
    place0 = sums_place(shape, r0 + r, q0 + q);
    place1 = sums_place(shape, r0 + r, q0 + q + 1);
  }
  for (int j0 = first; j0 < last; j0 += kSumsDepth) {
    unsigned next[kSumsDepth];
#pragma unroll
    for (int d = 0; d < kSumsDepth; ++d) {
      next[d] = valid && j0 + d < last ? __ldg(own + (j0 + d) * words) : 0u;
    }
#pragma unroll
    for (int d = 0; d < kSumsDepth; ++d) {
      const int j = j0 + d;
      if (j >= last) break;
      const unsigned u = next[d];   // frame j: virtual row j + P - 1
      const float2 a = pfb_tap_sum<TAPS>(win, h0, u, 0, taps);
      const float2 b = pfb_tap_sum<TAPS>(win, h1, u, 16, taps);
      float2* frame = out + static_cast<size_t>(j) * shape.frame;
      if (turned) {
        constexpr int kHalf = kSumsThreads / kSumsRows * kSumsTurn;
        const int i = threadIdx.x;
        turn[q * kSumsTurn + r] = a;
        turn[(q + 1) * kSumsTurn + r] = b;
        __syncthreads();
        const int at = (i / kSumsRows) * kSumsTurn + i % kSumsRows;
        if (write0) frame[place0] = turn[at];
        if (write1) frame[place1] = turn[at + kHalf];
        __syncthreads();
      } else if (valid) {
        frame[place0] = a;
        frame[place1] = b;
      }
      // Slide: rows j + 1 .. j + P - 1, the last this frame's own.
#pragma unroll
      for (int p = 0; p < TAPS - 1; ++p) {
        win[p] = p == taps - 2 ? u : (p + 1 < TAPS - 1 ? win[p + 1] : 0u);
      }
    }
  }
}

// The register class of P taps: 2, 4, 8, 16 or 32.
__host__ __device__ constexpr int sums_taps(int P) {
  return P <= 2 ? 2 : P <= 4 ? 4 : P <= 8 ? 8 : P <= 16 ? 16 : 32;
}

// The pre-pass's frames a block over S streams of F frames: all F where
// its (rows / 16) (N2 / 32) S blocks a frame reach kSumsBlocks, else
// split into the fewest groups that do (one frame a block at most).
inline int sums_frames(const SumsShape& shape, int S, int F) {
  const int blocks =
      (shape.rows / kSumsRows) * ((1 << shape.log2n2) / kSumsCols) * S;
  const int want = (kSumsBlocks + blocks - 1) / blocks;
  const int groups = want < 1 ? 1 : want > F ? F : want;
  return (F + groups - 1) / groups;
}

// Pass A's copy of a batch's sums as they lie (`values` float2, a multiple
// of 2 threads) from the scratch into its ring slot, 16 bytes a cp.async.
__device__ __forceinline__ void sums_prefetch(float2* slot,
                                              const float2* src, int values,
                                              int tid, int threads) {
  for (int e = 2 * tid; e < values; e += 2 * threads) {
    cp_async16(slot + e, src + e);
  }
}

template <int TAPS>
const void* sums_kernel() {
  return reinterpret_cast<const void*>(pfb_sums_kernel<TAPS>);
}

// The sums of S streams of F frames, 1 <= P <= 32, on `st`.
inline cudaError_t launch_pfb_sums(const uint8_t* raw, const uint8_t* history,
                                   const float* h, float2* sums,
                                   const SumsShape& shape, int S, int F,
                                   int P, const int* counts,
                                   cudaStream_t st) {
  const int group = sums_frames(shape, S, F);
  const dim3 grid((shape.rows / kSumsRows) *
                      ((1 << shape.log2n2) / kSumsCols),
                  S, (F + group - 1) / group);
  switch (sums_taps(P)) {
    case 2:
      pfb_sums_kernel<2><<<grid, kSumsThreads, 0, st>>>(
          raw, history, h, sums, shape, F, group, P, counts);
      break;
    case 4:
      pfb_sums_kernel<4><<<grid, kSumsThreads, 0, st>>>(
          raw, history, h, sums, shape, F, group, P, counts);
      break;
    case 8:
      pfb_sums_kernel<8><<<grid, kSumsThreads, 0, st>>>(
          raw, history, h, sums, shape, F, group, P, counts);
      break;
    case 16:
      pfb_sums_kernel<16><<<grid, kSumsThreads, 0, st>>>(
          raw, history, h, sums, shape, F, group, P, counts);
      break;
    default:
      pfb_sums_kernel<32><<<grid, kSumsThreads, 0, st>>>(
          raw, history, h, sums, shape, F, group, P, counts);
      break;
  }
  return cudaGetLastError();
}

}  // namespace
