// The register FFT of the fused PSD group kernel (fused_psd_regs.cuh).
//
// A length-N transform is a few passes of radix R_j <= 16 (the pass plan
// below). Each of the N / R threads of a frame holds R = R_0 complex f32
// values; a pass is R / R_j radix-R_j butterflies a thread, done in
// registers as log2(R_j) radix-2 decimation-in-frequency stages with the
// constants W_16^q. Between passes the values go once through shared
// memory (one write and one read of the frame), not once per radix-2
// stage as in fft_radix2.cuh.
//
// Decimation in frequency, in place. Pass j works on blocks of
// L_j = N / (R_0 ... R_{j-1}) elements, each as R_j interleaved
// subsequences of stride S_j = L_j / R_j: butterfly (block, n2) takes the
// elements block*L_j + n1*S_j + n2, n1 < R_j, and gives output k1 to the
// element block*L_j + k1*S_j + n2, times the twiddle W_{L_j}^(n2*k1) unless
// it is the last pass. Thread t owns butterflies b = t + i*(N/R), i <
// R / R_j, b = block*S_j + n2; in the first pass these are the samples
// t + k*(N/R). After the last pass element q holds the bin whose
// mixed-radix digits are q's in reverse (pass_bin).
//
// Shared memory holds element e at e + (e >> 4) (one float2 of padding
// per 16): every pass's reads and writes then fall on distinct banks for
// 16 consecutive threads, from N = 256 on (2-way at 64 and 128, where
// several frames share a warp).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRegsMinLog2N = 6;
constexpr int kRegsMaxLog2N = 14;
constexpr int kMaxPasses = 4;

// Radix of pass j at N = 2^log2n (0 past the last pass). The table is
// read in this form by tests/test_torch_fused_psd_regs.py.
__host__ __device__ constexpr int pass_radix(int log2n, int j) {
  constexpr int plan[kRegsMaxLog2N - kRegsMinLog2N + 1][kMaxPasses] = {
      {8, 8, 0, 0},      // 64
      {16, 8, 0, 0},     // 128
      {16, 16, 0, 0},    // 256
      {16, 16, 2, 0},    // 512
      {16, 16, 4, 0},    // 1024
      {16, 16, 8, 0},    // 2048
      {16, 16, 16, 0},   // 4096
      {16, 16, 16, 2},   // 8192
      {16, 16, 16, 4},   // 16384
  };
  return j < kMaxPasses ? plan[log2n - kRegsMinLog2N][j] : 0;
}

// W_16^q = exp(-2 pi i q / 16), q < 8, part 0 real and 1 imaginary: the
// float64 values, rounded once to float32.
__host__ __device__ constexpr float w16(int q, int part) {
  constexpr double w[8][2] = {
      {1.0, 0.0},
      {0.92387953251128674, -0.38268343236508978},
      {0.70710678118654757, -0.70710678118654757},
      {0.38268343236508978, -0.92387953251128674},
      {0.0, -1.0},
      {-0.38268343236508978, -0.92387953251128674},
      {-0.70710678118654757, -0.70710678118654757},
      {-0.92387953251128674, -0.38268343236508978},
  };
  return static_cast<float>(w[q][part]);
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

// i with its low `bits` bits in reverse order.
__host__ __device__ constexpr int rev_bits(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | rev_bits(i >> 1, bits - 1);
}

__host__ __device__ constexpr int pad_index(int e) { return e + (e >> 4); }

template <int LOG2N>
struct RegsPlan {
  static constexpr int N = 1 << LOG2N;
  static constexpr int R = pass_radix(LOG2N, 0);   // values a thread holds
  static constexpr int TF = N / R;                 // threads a frame
  static constexpr int PASSES = pass_radix(LOG2N, 1) == 0   ? 1
                                : pass_radix(LOG2N, 2) == 0 ? 2
                                : pass_radix(LOG2N, 3) == 0 ? 3
                                                            : 4;
  // Span L_j of pass j's blocks.
  __host__ __device__ static constexpr int span(int j) {
    return j == 0 ? N : span(j - 1) / pass_radix(LOG2N, j - 1);
  }
  // Offset of pass j's twiddles in pass_twiddles(N): the spans before it.
  __host__ __device__ static constexpr int twiddle_offset(int j) {
    return j == 0 ? 0 : twiddle_offset(j - 1) + span(j - 1);
  }
  static_assert(R == 8 || R == 16, "a thread holds 8 or 16 values");
};

// Bin of element q after the last pass: q's digits (radix R_0 most
// significant) in reverse, radix R_0 least significant.
template <int LOG2N>
__host__ __device__ constexpr int pass_bin(int q) {
  int bin = 0;
  int scale = 1;
  int span = 1 << LOG2N;
  for (int j = 0; j < kMaxPasses && pass_radix(LOG2N, j) != 0; ++j) {
    const int r = pass_radix(LOG2N, j);
    span /= r;
    bin += ((q / span) % r) * scale;
    scale *= r;
  }
  return bin;
}

__device__ __forceinline__ float2 cmul(float2 a, float br, float bi) {
  return make_float2(a.x * br - a.y * bi, a.x * bi + a.y * br);
}

// One radix-2 butterfly with the twiddle W_16^Q on the difference; W^0
// and W^4 = -i need no multiply.
template <int Q>
__device__ __forceinline__ void butterfly2(float2& a, float2& c) {
  const float2 d = make_float2(a.x - c.x, a.y - c.y);
  a = make_float2(a.x + c.x, a.y + c.y);
  if constexpr (Q == 0) {
    c = d;
  } else if constexpr (Q == 4) {
    c = make_float2(d.y, -d.x);
  } else {
    constexpr float wr = w16(Q, 0);
    constexpr float wi = w16(Q, 1);
    c = cmul(d, wr, wi);
  }
}

// The radix-2 stage of half-span M of a radix-RADIX DIF on v[off ..
// off + RADIX): butterfly J pairs i0 = (J / M) * 2M + J % M with i0 + M,
// the twiddle W_{2M}^(J % M) = W_16^((J % M) * 8 / M).
template <int RADIX, int M, int J = 0, int COUNT>
__device__ __forceinline__ void dif_stage(float2 (&v)[COUNT], int off) {
  if constexpr (J < RADIX / 2) {
    constexpr int k = J % M;
    constexpr int i0 = (J / M) * 2 * M + k;
    butterfly2<k * (8 / M)>(v[off + i0], v[off + i0 + M]);
    dif_stage<RADIX, M, J + 1>(v, off);
  }
}

// A radix-RADIX DFT of v[off .. off + RADIX) in registers (RADIX <= 16):
// v[off + r] then holds output rev_bits(r, log2 RADIX).
template <int RADIX, int M = RADIX / 2, int COUNT>
__device__ __forceinline__ void dif_regs(float2 (&v)[COUNT], int off) {
  if constexpr (M >= 1) {
    dif_stage<RADIX, M>(v, off);
    dif_regs<RADIX, M / 2>(v, off);
  }
}

// Pass J >= 1 of one frame on thread t: read each butterfly's R_J
// elements from x, transform them in registers, and (before the last
// pass) write them back to the same elements times their twiddles.
// Leaves the outputs in v: v[i * R_J + r] is output rev_bits(r) of
// butterfly t + i * TF.
template <int LOG2N, int J>
__device__ __forceinline__ void regs_pass(float2 (&v)[RegsPlan<LOG2N>::R],
                                          float2* x,
                                          const float2* __restrict__ twiddle,
                                          int t) {
  using P = RegsPlan<LOG2N>;
  constexpr int RJ = pass_radix(LOG2N, J);
  constexpr int L = P::span(J);
  constexpr int S = L / RJ;
  constexpr int BITS = log2_of(RJ);
  constexpr bool LAST = J == P::PASSES - 1;
#pragma unroll
  for (int i = 0; i < P::R / RJ; ++i) {
    const int b = t + i * P::TF;
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
#pragma unroll
    for (int n1 = 0; n1 < RJ; ++n1) v[i * RJ + n1] = x[pad_index(base + n1 * S)];
    dif_regs<RJ>(v, i * RJ);
    if constexpr (!LAST) {
      const float2* tw = twiddle + P::twiddle_offset(J) + n2;
#pragma unroll
      for (int r = 0; r < RJ; ++r) {
        const int k1 = rev_bits(r, BITS);
        float2 y = v[i * RJ + r];
        if (k1 != 0) {
          const float2 w = __ldg(tw + k1 * S);
          y = cmul(y, w.x, w.y);
        }
        x[pad_index(base + k1 * S)] = y;
      }
    }
  }
}

// The first radix-2 stage (half-span RADIX / 2) of dif_regs<RADIX> on v
// whose upper half is zero: v[J + RADIX/2] = v[J] W_RADIX^J and v[J] stays.
// dif_regs<RADIX, RADIX / 4> does the other stages.
template <int RADIX, int J = 0, int COUNT>
__device__ __forceinline__ void dif_stage_half_zero(float2 (&v)[COUNT]) {
  if constexpr (J < RADIX / 2) {
    constexpr int q = J * (16 / RADIX);
    if constexpr (q == 0) {
      v[J + RADIX / 2] = v[J];
    } else if constexpr (q == 4) {
      v[J + RADIX / 2] = make_float2(v[J].y, -v[J].x);
    } else {
      v[J + RADIX / 2] = cmul(v[J], w16(q, 0), w16(q, 1));
    }
    dif_stage_half_zero<RADIX, J + 1>(v);
  }
}

// Transposed pass J of one frame on thread t, J below the last pass: the
// butterflies of pass J run backwards. Each butterfly's R_J elements are
// read from x times their twiddles W_{L_J}^(n2*k) (the forward pass's
// table entries, on the input), transformed in registers, and written
// back in natural order: output k1 to element base + k1*S_J, so no
// reorder. On pass 0 (one butterfly a thread, b = t) nothing is written:
// v[r] is left holding element t + rev_bits(r)*TF. Run from the last
// pass down to pass 0 on a digit-reversed vector, these passes are the
// transpose of the forward passes, which is the DFT again (the DFT matrix
// is symmetric), with its output in natural order.
template <int LOG2N, int J>
__device__ __forceinline__ void regs_pass_t(
    float2 (&v)[RegsPlan<LOG2N>::R], float2* x,
    const float2* __restrict__ twiddle, int t) {
  using P = RegsPlan<LOG2N>;
  constexpr int RJ = pass_radix(LOG2N, J);
  constexpr int L = P::span(J);
  constexpr int S = L / RJ;
  constexpr int BITS = log2_of(RJ);
  static_assert(J < P::PASSES - 1, "the last pass has no twiddles");
#pragma unroll
  for (int i = 0; i < P::R / RJ; ++i) {
    const int b = t + i * P::TF;
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
    const float2* tw = twiddle + P::twiddle_offset(J) + n2;
#pragma unroll
    for (int k = 0; k < RJ; ++k) {
      float2 y = x[pad_index(base + k * S)];
      if (k != 0) {
        const float2 w = __ldg(tw + k * S);
        y = cmul(y, w.x, w.y);
      }
      v[i * RJ + k] = y;
    }
    dif_regs<RJ>(v, i * RJ);
    if constexpr (J != 0) {
#pragma unroll
      for (int r = 0; r < RJ; ++r) {
        x[pad_index(base + rev_bits(r, BITS) * S)] = v[i * RJ + r];
      }
    }
  }
}

}  // namespace
