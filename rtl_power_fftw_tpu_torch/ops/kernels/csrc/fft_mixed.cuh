// The mixed-radix transform of the awkward-N kernels (fused_psd_mixed.cuh):
// a length-n DFT as passes of radix 2, 3, 4, 5, 7, 8 or 16, the plan
// chosen at run time (fused_psd_mixed.mixed_plan on the host).
//
// It is fft_regs.cuh's decimation in frequency with the radices of any
// 7-smooth n: pass j works on blocks of L_j = n / (R_0 ... R_{j-1})
// elements, each as R_j interleaved subsequences of stride S_j = L_j / R_j;
// butterfly (block, n2) takes the elements block*L_j + n1*S_j + n2,
// n1 < R_j, and gives output k1 to the element block*L_j + k1*S_j + n2,
// times the twiddle W_{L_j}^(n2*k1) unless it is the last pass. After the
// last pass element q holds the bin whose mixed-radix digits are q's in
// reverse (the wrapper's digit_reversed). A butterfly's radix-R DFT runs
// in registers and leaves its outputs in natural order: radix 4, 8 and 16
// as fft_regs.cuh's radix-2 stages with a register permutation after
// them, radix 3, 5 and 7 as a direct DFT over conjugate pairs of inputs
// with the float64 cosines and sines rounded once to float32.
//
// The transposed passes (dit_*) run the same butterflies backwards: with
// the twiddle on the input and no reorder they map the digit-reversed
// order back to natural order (the DFT matrix is symmetric, so the
// transpose of the decimation in frequency is a decimation in time).
// The chirp-Z kernel runs its inverse transform so.
//
// Shared memory holds element e at e + (e >> 4), as in fft_regs.cuh.

#pragma once

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace {

// Passes a plan may have: 2 * 3^8 = 13122 takes nine.
constexpr int kMixedMaxPasses = 10;

// The radices a pass may have. Read in this form by
// tests/test_torch_fused_psd_mixed.py.
constexpr int kMixedRadices[] = {16, 8, 7, 5, 4, 3, 2};

template <int R>
struct Radix {
  static constexpr int value = R;
};

// body(Radix<r>{}) for the pass radix r; nothing for any other r.
template <class Body>
__device__ __forceinline__ void with_radix(int r, Body&& body) {
  switch (r) {
    case 2: body(Radix<2>{}); break;
    case 3: body(Radix<3>{}); break;
    case 4: body(Radix<4>{}); break;
    case 5: body(Radix<5>{}); break;
    case 7: body(Radix<7>{}); break;
    case 8: body(Radix<8>{}); break;
    case 16: body(Radix<16>{}); break;
    default: break;
  }
}

// cos and sin of 2 pi j / R, 0 < j <= (R - 1) / 2, R in {3, 5, 7}: the
// float64 values rounded once to float32.
__host__ __device__ constexpr float odd_cos(int R, int j) {
  constexpr double c3[] = {-0.5};
  constexpr double c5[] = {0.3090169943749474241, -0.8090169943749474241};
  constexpr double c7[] = {0.62348980185873353053, -0.22252093395631440429,
                           -0.90096886790241912624};
  return static_cast<float>(R == 3 ? c3[j - 1]
                            : R == 5 ? c5[j - 1]
                                     : c7[j - 1]);
}

__host__ __device__ constexpr float odd_sin(int R, int j) {
  constexpr double s3[] = {0.86602540378443864676};
  constexpr double s5[] = {0.95105651629515357212, 0.58778525229247312917};
  constexpr double s7[] = {0.78183148246802980871, 0.97492791218182360702,
                           0.43388373911755812048};
  return static_cast<float>(R == 3 ? s3[j - 1]
                            : R == 5 ? s5[j - 1]
                                     : s7[j - 1]);
}

// Term m of output k of a radix-R DFT, R odd, H = (R - 1) / 2: adds
// s_m cos(2 pi m k / R) to a and -i d_m sin(2 pi m k / R) to b, then the
// terms after it.
template <int R, int K, int M = 1, int H>
__device__ __forceinline__ void odd_terms(float2& a, float2& b,
                                          const float2 (&s)[H],
                                          const float2 (&d)[H]) {
  if constexpr (M <= H) {
    constexpr int j = (M * K) % R;
    constexpr float c = odd_cos(R, j <= H ? j : R - j);
    constexpr float sn = j <= H ? odd_sin(R, j) : -odd_sin(R, R - j);
    a.x += s[M - 1].x * c;
    a.y += s[M - 1].y * c;
    b.x += d[M - 1].y * sn;
    b.y -= d[M - 1].x * sn;
    odd_terms<R, K, M + 1>(a, b, s, d);
  }
}

// Outputs K and R - K of a radix-R DFT, R odd, and those after them:
// y[K] = a + b and y[R - K] = a - b with a = v[0] + sum_m s_m cos and
// b = -i sum_m d_m sin (the sines change sign from K to R - K).
template <int R, int K = 1, int H, int COUNT>
__device__ __forceinline__ void odd_outputs(float2 (&v)[COUNT], float2 x0,
                                            const float2 (&s)[H],
                                            const float2 (&d)[H]) {
  if constexpr (K <= H) {
    float2 a = x0;
    float2 b = make_float2(0.0f, 0.0f);
    odd_terms<R, K>(a, b, s, d);
    v[K] = make_float2(a.x + b.x, a.y + b.y);
    v[R - K] = make_float2(a.x - b.x, a.y - b.y);
    odd_outputs<R, K + 1>(v, x0, s, d);
  }
}

// A radix-R DFT of v[0 .. R) in registers, R odd, from the sums
// s_m = v[m] + v[R - m] and differences d_m = v[m] - v[R - m], m <= H:
// y[k] = v[0] + sum_m s_m cos(2 pi m k / R) - i d_m sin(2 pi m k / R).
template <int R, int COUNT>
__device__ __forceinline__ void dft_odd(float2 (&v)[COUNT]) {
  constexpr int H = (R - 1) / 2;
  float2 s[H], d[H];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    s[m - 1] = make_float2(v[m].x + v[R - m].x, v[m].y + v[R - m].y);
    d[m - 1] = make_float2(v[m].x - v[R - m].x, v[m].y - v[R - m].y);
  }
  const float2 x0 = v[0];
  float2 y0 = x0;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    y0.x += s[m].x;
    y0.y += s[m].y;
  }
  v[0] = y0;
  odd_outputs<R>(v, x0, s, d);
}

// A radix-R DFT of v[0 .. R) in registers, outputs in natural order.
template <int R, int COUNT>
__device__ __forceinline__ void dft_natural(float2 (&v)[COUNT]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = make_float2(a.x + v[1].x, a.y + v[1].y);
    v[1] = make_float2(a.x - v[1].x, a.y - v[1].y);
  } else if constexpr (R % 2 == 1) {
    dft_odd<R>(v);
  } else {
    dif_regs<R>(v, 0);
    float2 t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[rev_bits(r, log2_of(R))] = v[r];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = t[r];
  }
}

__device__ __forceinline__ float2 cmulf(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ float norm2(float2 a) {
  return a.x * a.x + a.y * a.y;
}

// Pass j of the decimation in frequency on one frame, j >= 1, on lane
// thread t of tf: butterflies t, t + tf, ... of the n / R. ``tw`` is the
// pass's part of the twiddle table (row k1 * S + n2), unread on the last
// pass; there each output's |.|^2 is added to acc at its element instead
// of being written back.
template <int R>
__device__ __forceinline__ void dif_pass(float2* x, const float2* __restrict__ tw,
                                         int n, int L, bool last, float* acc,
                                         int t, int tf) {
  const int S = L / R;
  for (int b = t; b < n / R; b += tf) {
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
    float2 v[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) v[n1] = x[pad_index(base + n1 * S)];
    dft_natural<R>(v);
    if (last) {
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) acc[base + k1 * S] += norm2(v[k1]);
    } else {
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        const float2 y = k1 == 0 ? v[k1] : cmulf(v[k1], __ldg(tw + k1 * S + n2));
        x[pad_index(base + k1 * S)] = y;
      }
    }
  }
}

// Pass j of the transposed passes, j <= P - 2: each butterfly's inputs
// times their twiddles, then its DFT, written back in place. On pass 0
// (L = n, the block the whole frame) output n1 is element b + n1 * S in
// natural order; there its |.|^2 is added to acc where it is below
// ``keep`` and nothing is written back.
template <int R>
__device__ __forceinline__ void dit_pass(float2* x, const float2* __restrict__ tw,
                                         int n, int L, bool first_pass,
                                         float* acc, int keep, int t, int tf) {
  const int S = L / R;
  for (int b = t; b < n / R; b += tf) {
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float2 e = x[pad_index(base + k * S)];
      v[k] = k == 0 ? e : cmulf(e, __ldg(tw + k * S + n2));
    }
    dft_natural<R>(v);
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const int e = base + n1 * S;
      if (first_pass) {
        if (e < keep) acc[e] += norm2(v[n1]);
      } else {
        x[pad_index(e)] = v[n1];
      }
    }
  }
}

// The chirp-Z kernel's turn between its two transforms, on the last
// pass's butterflies (no twiddles either way): the forward butterfly,
// each output times its entry of the spectrum table (in the forward
// transform's digit-reversed element order), conjugated, then the same
// butterfly again, the first of the transposed passes.
template <int R>
__device__ __forceinline__ void turn_pass(float2* x,
                                          const float2* __restrict__ spectrum,
                                          int n, int L, int t, int tf) {
  const int S = L / R;
  for (int b = t; b < n / R; b += tf) {
    const int n2 = b % S;
    const int base = (b / S) * L + n2;
    float2 v[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) v[n1] = x[pad_index(base + n1 * S)];
    dft_natural<R>(v);
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      const float2 y = cmulf(v[k1], __ldg(spectrum + base + k1 * S));
      v[k1] = make_float2(y.x, -y.y);
    }
    dft_natural<R>(v);
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) x[pad_index(base + n1 * S)] = v[n1];
  }
}

}  // namespace
