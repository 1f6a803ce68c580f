// The PFB's streams histories, shared by every library with a PFB streams
// entry (fused_psd_pfb.cu at the powers of two, fused_psd_mixed_est.cu and
// fused_psd_chirp_est.cu at the awkward bin counts): after a step of S
// streams, stream s's next (P - 1, 2N) history is rows n_valid[s] ..
// n_valid[s] + P - 2 of its virtual array (its P - 1 history rows, then
// its F slot rows), the count read from the device when the kernel runs
// and clamped to [0, F]. So a stream with no valid frame keeps its
// history and one with fewer than P - 1 shifts it, as the JAX package's
// ShardedPfbStep keeps them on the host (models/pfb.py:372-380).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Each stream's next history: block (r, s) writes row r < P - 1 of stream
// s's history_out, row n_valid[s] + r of its virtual array (history rows,
// then slot rows; the count clamped to [0, F]), 4 bytes a thread.
__global__ void __launch_bounds__(256)
pfb_history_kernel(const uint8_t* __restrict__ raw,      // (S*F, 2N)
                   const uint8_t* __restrict__ history,  // (S, P-1, 2N)
                   uint8_t* __restrict__ history_out,    // (S, P-1, 2N)
                   const int* __restrict__ counts, int F, int P,
                   int row_bytes) {
  const int r = blockIdx.x;
  const int s = blockIdx.y;
  const int nv = min(max(__ldg(counts + s), 0), F);
  const int v = nv + r;   // its row of the virtual array
  const size_t rows = static_cast<size_t>(P - 1);
  const size_t slot_row = static_cast<size_t>(s) * F + v - (P - 1);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      v < P - 1 ? history + (s * rows + v) * row_bytes
                : raw + slot_row * row_bytes);
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(history_out + (s * rows + r) * row_bytes);
  for (int i = threadIdx.x; i < row_bytes / 4; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

// Rows from this many bytes (N >= 32768) are copied by
// pfb_history_wide_kernel: pfb_history_kernel's one block a row would take
// a row of 2^21 bytes in ~260 us, a block's 4 bytes a thread at a time.
constexpr int kWideHistoryBytes = 65536;
// The words (4 bytes) a block of pfb_history_wide_kernel copies.
constexpr int kWideHistoryWords = 256 * 16;

// pfb_history_kernel's copy with each row split over blocks: block (x, r,
// s) writes words [x, x + 1) * kWideHistoryWords of row r of stream s's
// history_out, from the same row of its virtual array.
__global__ void __launch_bounds__(256)
pfb_history_wide_kernel(const uint8_t* __restrict__ raw,      // (S*F, 2N)
                        const uint8_t* __restrict__ history,  // (S, P-1, 2N)
                        uint8_t* __restrict__ history_out,    // (S, P-1, 2N)
                        const int* __restrict__ counts, int F, int P,
                        int row_bytes) {
  const int r = blockIdx.y;
  const int s = blockIdx.z;
  const int nv = min(max(__ldg(counts + s), 0), F);
  const int v = nv + r;   // its row of the virtual array
  const size_t rows = static_cast<size_t>(P - 1);
  const size_t slot_row = static_cast<size_t>(s) * F + v - (P - 1);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      v < P - 1 ? history + (s * rows + v) * row_bytes
                : raw + slot_row * row_bytes);
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(history_out + (s * rows + r) * row_bytes);
  const int end = min(row_bytes / 4,
                      static_cast<int>(blockIdx.x + 1) * kWideHistoryWords);
  for (int i = blockIdx.x * kWideHistoryWords + threadIdx.x; i < end;
       i += 256) {
    dst[i] = __ldg(src + i);
  }
}

// Launches pfb_history_kernel (rows below kWideHistoryBytes) or
// pfb_history_wide_kernel on `stream` for S streams of F frames of
// row_bytes = 2N bytes (a multiple of 4; raw, history and history_out
// 4-byte aligned) at P > 1 taps.
inline cudaError_t launch_pfb_history(const void* raw, const void* history,
                                      void* history_out, const void* counts,
                                      int S, int F, int P, int row_bytes,
                                      cudaStream_t stream) {
  if (row_bytes >= kWideHistoryBytes) {
    const int words = row_bytes / 4;
    pfb_history_wide_kernel<<<dim3((words + kWideHistoryWords - 1) /
                                       kWideHistoryWords,
                                   P - 1, S),
                              256, 0, stream>>>(
        static_cast<const uint8_t*>(raw),
        static_cast<const uint8_t*>(history),
        static_cast<uint8_t*>(history_out), static_cast<const int*>(counts),
        F, P, row_bytes);
    return cudaGetLastError();
  }
  pfb_history_kernel<<<dim3(P - 1, S), 256, 0, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(history),
      static_cast<uint8_t*>(history_out), static_cast<const int*>(counts), F,
      P, row_bytes);
  return cudaGetLastError();
}

}  // namespace
