// The frame ring of the awkward-N kernels (fused_psd_chirp.cuh,
// fused_psd_mixed_ring.cuh): while a lane transforms frame i, cp.async
// copies frame i + 1's 2N raw bytes into the lane's other ring slot.
//
// A frame of 2N bytes is 16-byte aligned only where N is a multiple of 8
// (and the data pointer is), 8-byte aligned where N is a multiple of 4, and
// only 4-byte aligned at N = 2 * odd (998, 8182). So the copy width is an
// argument, chosen by the wrapper from N and the pointer
// (fused_psd_mixed.copy_width): 16-byte copies (cp.async.cg) where both
// allow it, else 8 or 4 bytes (cp.async.ca). A slot is 2N bytes rounded up
// to 16, so every slot stays 16-byte aligned; a lane's two slots are
// followed by 32 bytes, as K1's are.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_psd_regs.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

// A ring slot of a frame of `bins` complex u8 samples.
__host__ __device__ constexpr int ring_slot(int bins) {
  return (2 * bins + 15) / 16 * 16;
}

// A lane's ring: two slots and 32 bytes.
__host__ __device__ constexpr int ring_bytes(int bins) {
  return 2 * ring_slot(bins) + 32;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The copy widths the ring takes, and the frames' alignment to them.
inline bool width_ok(const void* raw, int bins, int width) {
  return (width == 4 || width == 8 || width == 16) &&
         (2 * bins) % width == 0 &&
         reinterpret_cast<uintptr_t>(raw) % width == 0;
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem_dst,
                                            const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem_src), "n"(BYTES)
               : "memory");
}

// Thread t of nt copies its share of `bytes` (a multiple of `width`) from
// src to dst in pieces of `width` bytes (4, 8 or 16; both pointers are
// multiples of it). Commits nothing.
__device__ __forceinline__ void ring_copy(uint8_t* dst, const uint8_t* src,
                                          int bytes, int width, int t,
                                          int nt) {
  if (width == 16) {
    for (int c = 16 * t; c < bytes; c += 16 * nt) cp_async16(dst + c, src + c);
  } else if (width == 8) {
    for (int c = 8 * t; c < bytes; c += 8 * nt) {
      cp_async_ca<8>(dst + c, src + c);
    }
  } else {
    for (int c = 4 * t; c < bytes; c += 4 * nt) {
      cp_async_ca<4>(dst + c, src + c);
    }
  }
}

// Sample s of a ring slot (u16 pairs: re byte, im byte), dequantized
// exactly (u8 - 127) and, where there is a window, times its f32 value.
template <bool WINDOWED>
__device__ __forceinline__ float2 ring_sample(const uint16_t* iq, int s,
                                              float w) {
  const unsigned u = iq[s];
  float re = dequant_byte(u & 0xFFu);
  float im = dequant_byte(u >> 8);
  if constexpr (WINDOWED) {
    re = __fmul_rn(re, w);
    im = __fmul_rn(im, w);
  }
  return make_float2(re, im);
}

// Sample s of output frame j's polyphase sum: taps P - 1 .. 0 of virtual
// rows j .. j + P - 1, row j + P - 1 (frame j's own) from the ring slot
// `iq`, the others from `history` (virtual rows < P - 1) or `frames`.
__device__ __forceinline__ float2 pfb_sample(const uint16_t* iq,
                                             const uint8_t* frames,
                                             const uint8_t* history,
                                             const float* h, int j, int P,
                                             int n, int s) {
  float re = 0.0f;
  float im = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int r = j + p;
    unsigned u;
    if (p == P - 1) {
      u = iq[s];
    } else {
      const uint8_t* row =
          r < P - 1 ? history + static_cast<size_t>(r) * 2 * n
                    : frames + static_cast<size_t>(r - (P - 1)) * 2 * n;
      u = __ldg(reinterpret_cast<const uint16_t*>(row) + s);
    }
    const float hv = __ldg(h + static_cast<size_t>(p) * n + s);
    re = __fadd_rn(re, __fmul_rn(dequant_byte(u & 0xFFu), hv));
    im = __fadd_rn(im, __fmul_rn(dequant_byte(u >> 8), hv));
  }
  return make_float2(re, im);
}

}  // namespace
