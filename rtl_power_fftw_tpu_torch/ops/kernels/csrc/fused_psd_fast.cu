// Fused averaged-PSD device step at relaxed precision, on Hopper tensor
// cores (sm_90a).
//
// Replaces rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn
// with fast=True (K3, --precision high), unwindowed and windowed. It
// computes the JAX package's fast scheme: a four-step DFT N = N1 * N2
// (input n = N2*n1 + n2, bin k = k1 + N1*k2) whose products are bf16 x
// bf16 with f32 sums:
//   stage 1  Y[n2][k1] = sum_n1 x[N2*n1 + n2] W_N1^(n1*k1). Unwindowed,
//            the dequantized integers (|x| <= 128, exact in bf16) times a
//            3-term bf16 split of the weights; windowed, a 3-term split
//            of the f32 product x*w times the 3-term weights with the
//            i + j >= 3 terms dropped. The complex product and the terms
//            are the K-stack of the JAX kernel's _constants (6*N1 or
//            12*N1 deep): block b multiplies one input plane by rows
//            b*N1 .. (b+1)*N1 of WR (real part) and WI (imaginary part);
//   twiddle  Z = Y * W_N^(n2*k1) in f32;
//   stage 2  X[k1 + N1*k2] = sum_n2 Z[n2][k1] W_N2^(n2*k2) as a Karatsuba
//            of 3 real products (zr.w2r, zi.w2i, (zr + zi).(w2r + w2i)),
//            each a 2-term split of z times a 2-term split of the weights
//            with z1*c1 dropped: z0c0 + z0c1 + z1c0;
//   output   |X|^2, frames f >= n_valid dropped, f32 sum over the block's
//            frames, and the float64 fixed-order sum of block rows that
//            K1 uses (psd_sum.cuh).
//
// The split (Hopper, not the TPU's lane rule): N1 = 2^floor(log2(N)/2),
// N2 = N / N1, so both are multiples of 16, the depth of one bf16
// mma.sync.m16n8k16: 16x16 at N = 256, 32x64 at 2048, 64x128 at 8192,
// 128x128 at 16384. Each stage is cut into N/256 work items of 16 x 16
// outputs (two m16n8 tiles); a block has min(8, N/256) warps.
//
// What bounds it on an H100. The scheme costs 12 (24 windowed) real
// products of depth N1 and 9 of depth N2 per output: N(12 N1 + 9 N2)
// MACs a frame, 3.9 MFLOP at N = 2048 against 4 KB read, so device
// memory is not the limit and the 989 TFLOP/s of the tensor cores is far
// away. What bounds this first version is the work around the products:
// every A fragment is gathered element by element from shared memory and
// split into bf16 terms in registers (8 elements x 3 planes per mma
// group), and every B fragment (the weights) is read from L1/L2 once per
// warp that uses it: ~(N2/16) * 24 N1^2 + (N1/16) * 12 N2^2 bytes a frame,
// ~200 KB at N = 2048, so L1/L2 bandwidth and the fragment gathers, not
// the mma issue rate, set the time.
//
// What the design does about it:
//  * the frame is read from device memory once, as 16-byte words, into
//    shared memory as raw IQ pairs (2N bytes); dequantization, the window
//    multiply and the input split happen in registers while the stage-1
//    A fragments are built, so no split plane is ever stored;
//  * the weights are packed on the host in the exact per-lane order of
//    the mma B fragment, so each lane fetches its two B registers with one
//    coalesced 8-byte load (32 lanes read 256 contiguous bytes);
//  * a warp keeps its A fragments for all K-stack blocks and both n8
//    tiles of an item, so each gathered element feeds 6 to 24 mma;
//  * stage 1 writes Z (8N bytes, f32 complex) to shared memory once;
//    stage 2 splits it in registers; each warp owns the same stage-2
//    items in every frame, so |X|^2 accumulates in its D fragments in
//    registers across frames and is written once per block;
//  * no float atomics, as in K1: a partial row per block and a fixed-
//    order float64 row sum, so the result is the same on every run.
//
// Shared memory per block: Z 8N + raw 2N (+ window 4N) bytes, 224 KB at
// N = 16384 windowed, within the 227 KB a block may use (opt-in above
// 48 KB). wgmma and TMA, and keeping the weights in shared memory, are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 8;
constexpr int kMaxLog2N = 14;

template <int LOG2N>
struct FastShape {
  static constexpr int N = 1 << LOG2N;
  static constexpr int N1 = 1 << (LOG2N / 2);
  static constexpr int N2 = N / N1;
  static constexpr int ITEMS = N / 256;   // 16x16 output blocks per stage
  static constexpr int WARPS = ITEMS < 8 ? ITEMS : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ITEMS_PER_WARP = ITEMS / WARPS;
};

// Stage-1 K-stack: block b multiplies input plane plane(b). Unwindowed
// planes (ar, ai); windowed (a0r, a0i, a1r, a1i, a2r, a2i), in the block
// order [a0 a0 a0 a1 a1 a2] of the weight terms [c0 c1 c2 c0 c1 c0].
template <bool WINDOWED>
struct Stage1 {
  static constexpr int BLOCKS = WINDOWED ? 12 : 6;
  static constexpr int PLANES = WINDOWED ? 6 : 2;
  __host__ __device__ static constexpr int plane(int b) {
    return !WINDOWED || b < 6 ? (b & 1) : (b < 10 ? 2 + (b & 1) : 4 + (b & 1));
  }
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Successive round-to-nearest-even bf16 terms of an f32 value, as the
// JAX kernel's split3 and its 2-term stage-2 split compute them.
__device__ __forceinline__ void split2(float x, __nv_bfloat16 (&t)[2]) {
  t[0] = __float2bfloat16_rn(x);
  t[1] = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(t[0])));
}

__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(t[0]));
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(t[1])));
}

// d += a * b on the tensor cores: a 16x16 bf16 (row major), b 16x8 bf16
// (column major), d 16x8 f32. Lane l, g = l >> 2, t = l & 3, holds
//   a[q] = A[g + 8(q & 1)][2t + 8(q >> 1) + {0, 1}]   (low half first)
//   b.x  = B[2t + {0, 1}][g],  b.y = B[2t + 8 + {0, 1}][g]
//   d[e] = D[g + 8(e >> 1)][2t + (e & 1)].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ float dequant(uint32_t byte) {
  return static_cast<float>(static_cast<int>(byte) - 127);
}

// Block g transforms frames [g*group, min((g+1)*group, F, n_valid)) one
// after another and writes the f32 sum of their |X|^2 to partial row g.
template <int LOG2N, bool WINDOWED>
__global__ void __launch_bounds__(FastShape<LOG2N>::THREADS)
psd_fast_group_kernel(const uint4* __restrict__ raw,       // (F, N/8) words
                      const float* __restrict__ window,    // (N,) or null
                      const uint2* __restrict__ w1r,       // stage-1 B frags
                      const uint2* __restrict__ w1i,
                      const float4* __restrict__ twiddle,  // (N2, N1/2)
                      const uint2* __restrict__ w2,        // 6 B-frag planes
                      float* __restrict__ partial,         // (G, N)
                      int F, int group, int n_valid) {
  using S = FastShape<LOG2N>;
  using P = Stage1<WINDOWED>;
  constexpr int N = S::N, N1 = S::N1, N2 = S::N2;
  // Stage-2 B fragment planes: w2r0, w2r1, w2i0, w2i1, w2s0, w2s1.
  constexpr int W2_PLANE = (N2 / 16) * (N2 / 8) * 32;
  extern __shared__ float4 smem[];
  float2* z = reinterpret_cast<float2*>(smem);              // (N2, N1)
  uint4* raw4 = reinterpret_cast<uint4*>(smem + N / 2);    // 2N bytes
  const uint16_t* iq = reinterpret_cast<const uint16_t*>(raw4);  // (N1, N2)
  float* win = reinterpret_cast<float*>(smem + N / 2 + N / 8);   // (N,)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if constexpr (WINDOWED) {
    for (int i = tid; i < N; i += S::THREADS) win[i] = __ldg(window + i);
  }

  // |X|^2 of this warp's stage-2 items, in D-fragment order.
  float acc[S::ITEMS_PER_WARP][2][4];
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  for (int f = f0; f < f1; ++f) {
    const uint4* frame = raw + static_cast<size_t>(f) * (N / 8);
    for (int i = tid; i < N / 8; i += S::THREADS) raw4[i] = __ldg(frame + i);
    __syncthreads();   // also orders the window copy before its first use

    // Stage 1 and twiddle: item = (16 rows n2) x (16 columns k1).
    for (int item = warp; item < S::ITEMS; item += S::WARPS) {
      const int mt = item / (N1 / 16);
      const int ng = item % (N1 / 16);
      float yr[2][4] = {}, yi[2][4] = {};
      for (int c = 0; c < N1 / 16; ++c) {
        uint32_t a[P::PLANES][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // A[row n2][col n1] = x[N2*n1 + n2]; the pair is n1, n1 + 1.
          const int n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g +
                        8 * (q & 1);
          const uint32_t v0 = iq[n], v1 = iq[n + N2];
          const float r0 = dequant(v0 & 0xFFu), i0 = dequant(v0 >> 8);
          const float r1 = dequant(v1 & 0xFFu), i1 = dequant(v1 >> 8);
          if constexpr (!WINDOWED) {
            a[0][q] = pack2(__float2bfloat16_rn(r0), __float2bfloat16_rn(r1));
            a[1][q] = pack2(__float2bfloat16_rn(i0), __float2bfloat16_rn(i1));
          } else {
            const float c0 = win[n], c1 = win[n + N2];
            __nv_bfloat16 sr0[3], sr1[3], si0[3], si1[3];
            split3(__fmul_rn(r0, c0), sr0);
            split3(__fmul_rn(r1, c1), sr1);
            split3(__fmul_rn(i0, c0), si0);
            split3(__fmul_rn(i1, c1), si1);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              a[2 * p][q] = pack2(sr0[p], sr1[p]);
              a[2 * p + 1][q] = pack2(si0[p], si1[p]);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < P::BLOCKS; ++b) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx =
                ((b * (N1 / 16) + c) * (N1 / 8) + 2 * ng + j) * 32 + lane;
            mma_bf16(yr[j], a[P::plane(b)], __ldg(w1r + idx));
            mma_bf16(yi[j], a[P::plane(b)], __ldg(w1i + idx));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n2 = 16 * mt + g + 8 * h;
          const int k1 = 16 * ng + 8 * j + 2 * t;       // even: k1, k1 + 1
          const float4 tw = __ldg(twiddle + (n2 * N1 + k1) / 2);
          const float ar = yr[j][2 * h], ai = yi[j][2 * h];
          const float br = yr[j][2 * h + 1], bi = yi[j][2 * h + 1];
          float4 o;
          o.x = __fsub_rn(__fmul_rn(ar, tw.x), __fmul_rn(ai, tw.y));
          o.y = __fadd_rn(__fmul_rn(ar, tw.y), __fmul_rn(ai, tw.x));
          o.z = __fsub_rn(__fmul_rn(br, tw.z), __fmul_rn(bi, tw.w));
          o.w = __fadd_rn(__fmul_rn(br, tw.w), __fmul_rn(bi, tw.z));
          reinterpret_cast<float4*>(z)[(n2 * N1 + k1) / 2] = o;
        }
      }
    }
    __syncthreads();

    // Stage 2: item = (16 rows k1) x (16 columns k2), the same items in
    // every frame.
#pragma unroll
    for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
      const int item = warp + i * S::WARPS;
      const int mt = item / (N2 / 16);
      const int ng = item % (N2 / 16);
      float u1[2][4] = {}, u2[2][4] = {}, u3[2][4] = {};
      for (int c = 0; c < N2 / 16; ++c) {
        uint32_t a[6][4];   // zr0, zr1, zi0, zi1, zs0, zs1
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // A[row k1][col n2] = Z[n2][k1]; the pair is n2, n2 + 1.
          const int k1 = 16 * mt + g + 8 * (q & 1);
          const int n2 = 16 * c + 2 * t + 8 * (q >> 1);
          const float2 p0 = z[n2 * N1 + k1], p1 = z[(n2 + 1) * N1 + k1];
          __nv_bfloat16 r0[2], r1[2], i0[2], i1[2], s0[2], s1[2];
          split2(p0.x, r0);
          split2(p1.x, r1);
          split2(p0.y, i0);
          split2(p1.y, i1);
          split2(__fadd_rn(p0.x, p0.y), s0);
          split2(__fadd_rn(p1.x, p1.y), s1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            a[e][q] = pack2(r0[e], r1[e]);
            a[2 + e][q] = pack2(i0[e], i1[e]);
            a[4 + e][q] = pack2(s0[e], s1[e]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2* b = w2 + (c * (N2 / 8) + 2 * ng + j) * 32 + lane;
          const uint2 br0 = __ldg(b), br1 = __ldg(b + W2_PLANE);
          const uint2 bi0 = __ldg(b + 2 * W2_PLANE), bi1 = __ldg(b + 3 * W2_PLANE);
          const uint2 bs0 = __ldg(b + 4 * W2_PLANE), bs1 = __ldg(b + 5 * W2_PLANE);
          mma_bf16(u1[j], a[0], br0);
          mma_bf16(u1[j], a[0], br1);
          mma_bf16(u1[j], a[1], br0);
          mma_bf16(u2[j], a[2], bi0);
          mma_bf16(u2[j], a[2], bi1);
          mma_bf16(u2[j], a[3], bi0);
          mma_bf16(u3[j], a[4], bs0);
          mma_bf16(u3[j], a[4], bs1);
          mma_bf16(u3[j], a[5], bs0);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xr = __fsub_rn(u1[j][e], u2[j][e]);
          const float xi = __fsub_rn(__fsub_rn(u3[j][e], u1[j][e]), u2[j][e]);
          acc[i][j][e] = __fadd_rn(
              acc[i][j][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
        }
      }
    }
    __syncthreads();   // the next frame's stage 1 overwrites z
  }

  float* row = partial + static_cast<size_t>(blockIdx.x) * N;
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
    const int item = warp + i * S::WARPS;
    const int mt = item / (N2 / 16);
    const int ng = item % (N2 / 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k1 = 16 * mt + g + 8 * (e >> 1);
        const int k2 = 16 * ng + 8 * j + 2 * t + (e & 1);
        row[k1 + N1 * k2] = acc[i][j][e];
      }
    }
  }
}

template <int LOG2N, bool WINDOWED>
cudaError_t launch_fast(const void* raw, const void* window, const void* w1r,
                        const void* w1i, const void* twiddle, const void* w2,
                        void* partial, int F, int group, int G, int n_valid,
                        cudaStream_t stream) {
  using S = FastShape<LOG2N>;
  const int smem = (WINDOWED ? 14 : 10) * S::N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psd_fast_group_kernel<LOG2N, WINDOWED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  psd_fast_group_kernel<LOG2N, WINDOWED><<<G, S::THREADS, smem, stream>>>(
      static_cast<const uint4*>(raw), static_cast<const float*>(window),
      static_cast<const uint2*>(w1r), static_cast<const uint2*>(w1i),
      static_cast<const float4*>(twiddle), static_cast<const uint2*>(w2),
      static_cast<float*>(partial), F, group, n_valid);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_fast(const void* raw, const void* window, const void* w1r,
                        const void* w1i, const void* twiddle, const void* w2,
                        void* partial, int F, int group, int G, int n_valid,
                        cudaStream_t stream) {
  return window == nullptr
             ? launch_fast<LOG2N, false>(raw, window, w1r, w1i, twiddle, w2,
                                         partial, F, group, G, n_valid, stream)
             : launch_fast<LOG2N, true>(raw, window, w1r, w1i, twiddle, w2,
                                        partial, F, group, G, n_valid, stream);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// window: (N,) f32 or null; w1r, w1i: stage-1 weights as B fragments
// ((6 or 12) * N1/16, N1/8, 32 lanes, 4 bf16); twiddle: (N2, N1, 2) f32;
// w2: (6, N2/16, N2/8, 32, 4) bf16 stage-2 B fragments; partial:
// (ceil(F / group), N) f32 scratch; out: (N,) f32. Returns a cudaError_t
// (0 on success); does not synchronise.
int rpf_fused_psd_fast(const void* raw, const void* window, const void* w1r,
                       const void* w1i, const void* twiddle, const void* w2,
                       void* partial, void* out, int device, int log2n, int F,
                       int group, int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPF_FAST_CASE(L)                                                     \
  case L:                                                                    \
    e = launch_fast<L>(raw, window, w1r, w1i, twiddle, w2, partial, F, group, \
                       G, n_valid, s);                                       \
    break;
  switch (log2n) {
    RPF_FAST_CASE(8)
    RPF_FAST_CASE(9)
    RPF_FAST_CASE(10)
    RPF_FAST_CASE(11)
    RPF_FAST_CASE(12)
    RPF_FAST_CASE(13)
    RPF_FAST_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_FAST_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G, 1 << log2n, out, s));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
