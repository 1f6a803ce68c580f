// Stage-attribution and stage-2 probes for Hopper (sm_90a): where K3's
// and K1's time goes at N = 2048, and what other forms of stage 2 cost.
//
// Replaces the TPU probes that asked where the fused kernel's time goes:
//   P1   probes/profile_pallas.py:build (pallas_call 115): K3's scheme with
//        stage 1, stage 2, the twiddle or the f32 relayout changed;
//   P18  probes/s1_lanes.py:build (151): the chain cut after stage 1, the
//        twiddle or the Z relayout, and dequantization alone;
//   P13  probes/s1_lanes2.py:build (156): the relayout apart from the
//        dequantization, and other element types for the relayout;
//   P12  probes/cast_test.py:try_cast (16): nine in-kernel relayouts;
// and the TPU probes that restructured its stage 2, each from the TPU's
// shipping 6-product scheme (here tpu6):
//   P14  probes/s2_fourmult.py:build (132): the 4-mult complex product;
//   P16  probes/s2_left.py:build (171): the dequantization offset folded
//        after stage 1 (e2), stage 2 with Z as the right operand (left);
//   P19  probes/s2_ilv.py:build (117): 2 or 4 independent frame chains;
//   P11  probes/s2_pipe.py:build (150): a 1-deep software pipeline;
// and the TPU probes that relaid and packed stage 1's operands:
//   P17  probes/s2_u32t.py:build (154): u16 pairs as u32 words before the
//        transpose, raw bytes, the offset folded after stage 1 (on tpu6);
//   P2   probes/profile_pallas.py:build_pack8 (227): stage-1 rows packed
//        128 / N1 to a lane group against block-diagonal weights;
//   P6   profile_pallas.py:build_pack8c (588): P2 with Z in (p, q) order;
//   P5   profile_pallas.py:build_s1wide (492): stage 1 as two products
//        against N-stacked weights;
// and the TPU probes that asked what Karatsuba and K-stacking are worth:
//   P3   profile_pallas.py:build_dg3dall (309): a Karatsuba stage 1 of 3
//        products, then P1 dg3d's stage 2 (Z's split planes);
//   P4   profile_pallas.py:build_s1cat (390): that stage 1 as one
//        block-diagonal product;
//   P7   profile_pallas.py:build_s1k (680): K3's K-stack in three chains
//        (reps 1; reps 3, s1k96, is K3 itself);
//   P8   profile_pallas.py:build_best (766): K3's stage 1, then a 2-term
//        4-mult stage 2;
// and the last two builds of profile_pallas.py, K3's stage 1 with another
// stage 2:
//   P9   profile_pallas.py:build_v5 (880): kar is K3 itself; left the
//        3-product 2-term stage 2 with the weights as the left operand;
//   P10  profile_pallas.py:build_v6 (1005): the 6-product stage 2, narrow
//        (tpu6 itself) or K-stacked (one product of [z0 z0 z0 z1 z1 z2] a
//        part, block-major), here from Z's 3-term split planes; with the
//        narrow order from the same planes (tpu6_zplanes) as the control.
//
// On this card the TPU probes' bf16 four-step scheme is K3
// (fused_psd_fast.cuh), so P1, P18, P13, P14, P16, P19, P11, P17, P2, P6,
// P5, P3, P4, P7, P8, P9 and P10 are instantiations of K3's template with
// compile-time variant parameters;
// K1's cuts (fused_psd.cuh) ask P1's question of the FP32 radix-2 kernel
// that K1 was until its transform moved into registers, and the same cuts
// of the register kernel (fused_psd_regs.cuh) ask it of K1 as it ships.
// rpf_radix2_psd runs that radix-2 kernel whole at N = 256, 2048, 8192
// and 16384, windowed or not: the control the register kernel is timed
// against.
// Every variant runs at the probes' N = 2048 and at K3's own split, N1 x
// N2 = 32 x 64 (the TPU probes ran 16 x 128), on raw interleaved u8 IQ
// frames, and writes an (N,) f32 output through the same float64 row sum
// (psd_sum.cuh) as the shipping kernels. Which output each variant
// writes, and its plain PyTorch version, is in fused_psd_probe.py. The
// TPU probes' tile (frames per grid step) is the frames a block sums.
//
// What bounds them: as K3 and K1 (fused_psd_fast.cu, fused_psd.cu), the
// work around the products and the shared-memory traffic, not device
// memory; the cuts exist to measure how that time splits, the stage-2
// variants whether another form or schedule of the same work moves it.
// P12's relayouts move 64 KB each way: one block, launch-bound.
//
// A call launches its kernel `iters` times back to back on the stream
// (each launch rewrites the same output), so that the slope of the time
// against `iters` is the device's time per step, not the host's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "fused_psd.cuh"
#include "fused_psd_fast.cuh"
#include "fused_psd_regs.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kLog2N = 11;   // the probes' N = 2048

// Variant codes; kept in step with fused_psd_probe.py:VARIANTS.
enum : int {
  kK3 = 0,          // P1 full: the shipping K3
  kS2x1 = 1,        // P1 s2x1
  kS1x1 = 2,        // P1 s1x1
  kNoMM = 3,        // P1 nomm
  kNoTw = 4,        // P1 notw
  kZPlanes = 5,     // P1 dg3d
  kTpu6 = 6,        // P18 full, P13 full
  kTpu6Bf16 = 7,    // P18 widedq, P13 f32tr
  kTpu6Wide32 = 8,  // P13 i32tr
  kS1Only = 9,      // P18 s1only
  kS1Tw = 10,       // P18 s1tw
  kS1TwZ = 11,      // P18 s1tw2
  kDqOnly = 12,     // P18 dqonly
  kDqWide = 13,     // P18 dqwide
  kGather = 14,     // P13 traw
  kDqLinear = 15,   // P13 dqnotr
  kDqPair32 = 16,   // P13 u32tr
  kK1 = 20,         // K1, whole
  kK1Dq = 21,       // K1, load + dequantize + store
  kK1NoFftCut = 22, // K1 without the transform
  kK1r = 23,        // K1 as it ships (the register transform), whole
  kK1rDq = 24,      // its load (cp.async ring) + dequantize
  kK1rNoFft = 25,   // it without the transform
  kTpu6Pipe = 30,   // P11 pipe
  kTpu6Ilv2 = 31,   // P19 ilv
  kTpu6Ilv4 = 32,   // P19 ilv4
  kTpu6FourMult = 33, // P14 v7
  kTpu6E2 = 34,     // P16 e2
  kTpu6Left = 35,   // P16 left
  kTpu6E2Left = 36, // P16 e2left
  kTpu6U32t = 37,   // P17 u32t
  kK3Pack = 38,     // P2 pack8
  kK3PackPQ = 39,   // P6 pack8c
  kK3S1Wide = 40,   // P5 s1wide
  kK3Dg3dAll = 41,  // P3 dg3dall
  kK3S1Cat = 42,    // P4 s1cat
  kK3S1k32 = 43,    // P7 s1k32
  kK3Best = 44,     // P8 best
  kK3Left = 45,     // P9 v5left
  kTpu6ZPlanes = 46,  // tpu6 from Z's 3-term split planes (P10's control)
  kTpu6KStack = 47, // P10 v6k
};

// The shared-memory carveout (percent of the largest) of a launch pinned to
// an occupancy: half, so that L1 keeps about as much room as the shipping
// kernels' own launches leave it.
constexpr int kPinCarveout = 50;

// Sets up `kernel` for launches of `threads` threads with `smem` bytes of
// its own dynamic shared memory and sets *dyn to the dynamic shared memory
// to launch with. blocks_per_sm = 0: as the shipping kernels launch (the
// default carveout, *dyn = smem). blocks_per_sm = b > 0: a carveout of
// kPinCarveout and the least dynamic shared memory (>= smem) with which the
// occupancy calculator lets at most b blocks reside on an SM, whatever the
// variant's registers allow; the variants of one chain then run at one
// occupancy. With attrs, also writes the launch's attributes there (see
// rpf_probe_attributes).
template <class Kernel>
cudaError_t configure(Kernel* kernel, int threads, int smem, int blocks_per_sm,
                      int* dyn, int* attrs) {
  *dyn = smem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      blocks_per_sm > 0 ? kPinCarveout : cudaSharedmemCarveoutDefault);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  int device = 0, optin = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  // The dynamic shared memory a launch may ask for: all there is when
  // pinned; else the default 48 KB (less the static), or smem past it.
  const int most = optin - static_cast<int>(fa.sharedSizeBytes);
  const int usual = 48 * 1024 - static_cast<int>(fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        blocks_per_sm > 0 ? most : smem > usual ? smem : usual);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm > 0 && blocks > blocks_per_sm) {
    // Occupancy falls as the shared memory grows: bisect in 128-byte steps
    // for the least that holds it to blocks_per_sm.
    int lo = smem, hi = most & ~127;
    while (hi - lo > 128) {
      const int mid = (lo + (hi - lo) / 2) & ~127;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, mid);
      if (e != cudaSuccess) return e;
      (blocks > blocks_per_sm ? lo : hi) = mid;
    }
    *dyn = hi;
  }
  if (attrs == nullptr) return cudaSuccess;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = *dyn;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[4], kernel,
                                                       threads, *dyn);
}

// Variant V of K3's template, `iters` times: group kernel, then row sum.
// offsets: the RAW_BYTES variants' cR, cI, in the window's place.
template <class V>
cudaError_t launch_fast_variant(const void* raw, const void* w1r,
                                const void* w1i, const void* twiddle,
                                const void* w2, const void* offsets,
                                void* partial, void* out, int F, int group,
                                int G, int n_valid, int blocks_per_sm,
                                int iters, int* attrs, cudaStream_t stream) {
  using S = FastShape<kLog2N>;
  auto* kernel = psd_fast_group_kernel<kLog2N, false, V>;
  int smem = 0;
  cudaError_t e = configure(kernel, S::THREADS,
                            FastSmem<kLog2N, false, V>::BYTES, blocks_per_sm,
                            &smem, attrs);
  for (int it = 0; it < iters && e == cudaSuccess && attrs == nullptr; ++it) {
    kernel<<<G, S::THREADS, smem, stream>>>(
        static_cast<const uint4*>(raw),
        V::RAW_BYTES ? static_cast<const float*>(offsets) : nullptr,
        static_cast<const uint2*>(w1r), static_cast<const uint2*>(w1i),
        static_cast<const float4*>(twiddle), static_cast<const uint2*>(w2),
        static_cast<float*>(partial), F, group, n_valid);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = launch_psd_sum(partial, G, 1 << kLog2N, out,
                                             stream);
  }
  return e;
}

// K1's cut CUT, `iters` times: group kernel, then row sum.
template <int CUT>
cudaError_t launch_k1_cut(const void* raw, const void* twiddle, void* partial,
                          void* out, int F, int group, int G, int n_valid,
                          int blocks_per_sm, int iters, int* attrs,
                          cudaStream_t stream) {
  using S = Shape<kLog2N>;
  auto* kernel = psd_group_kernel<kLog2N, false, CUT>;
  int smem = 0;
  cudaError_t e =
      configure(kernel, S::THREADS, static_cast<int>(sizeof(float2)) * S::N,
                blocks_per_sm, &smem, attrs);
  for (int it = 0; it < iters && e == cudaSuccess && attrs == nullptr; ++it) {
    kernel<<<G, S::THREADS, smem, stream>>>(
        static_cast<const uint32_t*>(raw),
        static_cast<const float2*>(twiddle), nullptr,
        static_cast<float*>(partial), F, group, G, n_valid, nullptr);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = launch_psd_sum(partial, G, 1 << kLog2N, out,
                                             stream);
  }
  return e;
}

// The register kernel's cut CUT, `iters` times: group kernel, then row
// sum. twiddle: pass_twiddles(N).
template <int CUT>
cudaError_t launch_k1r_cut(const void* raw, const void* twiddle,
                           void* partial, void* out, int F, int group, int G,
                           int n_valid, int blocks_per_sm, int iters,
                           int* attrs, cudaStream_t stream) {
  using S = RegsShape<kLog2N>;
  auto* kernel = psd_regs_kernel<kLog2N, false, CUT>;
  int smem = 0;
  cudaError_t e = configure(kernel, S::THREADS, S::SMEM_BYTES, blocks_per_sm,
                            &smem, attrs);
  for (int it = 0; it < iters && e == cudaSuccess && attrs == nullptr; ++it) {
    kernel<<<G, S::THREADS, smem, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<const float2*>(twiddle),
        nullptr, static_cast<float*>(partial), F, group, G, n_valid, nullptr);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = launch_psd_sum(partial, G, 1 << kLog2N, out,
                                             stream);
  }
  return e;
}

// The radix-2 kernel whole at N = 2^LOG2N, windowed or not: group kernel,
// then row sum, as fused_psd.cu launched it before the register kernel.
template <int LOG2N, bool WINDOWED>
cudaError_t launch_radix2(const void* raw, const void* twiddle,
                          const void* window, void* partial, void* out, int F,
                          int group, int G, int n_valid, cudaStream_t stream) {
  using S = Shape<LOG2N>;
  const int smem = static_cast<int>(sizeof(float2)) * S::N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        psd_group_kernel<LOG2N, WINDOWED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  psd_group_kernel<LOG2N, WINDOWED><<<G, S::THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(raw), static_cast<const float2*>(twiddle),
      static_cast<const float2*>(window), static_cast<float*>(partial), F,
      group, G, n_valid, nullptr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_psd_sum(partial, G, S::N, out, stream);
}

// Launches variant `variant` `iters` times, or, with attrs, only sets it
// up and writes its attributes.
cudaError_t launch_variant(int variant, const void* raw, const void* w1r,
                           const void* w1i, const void* twiddle,
                           const void* w2, const void* offsets, void* partial,
                           void* out, int F, int group, int G, int n_valid,
                           int blocks_per_sm, int iters, int* attrs,
                           cudaStream_t s) {
#define RPF_FAST(CODE, ...)                                                   \
  case CODE:                                                                  \
    return launch_fast_variant<FastVariant<__VA_ARGS__>>(                     \
        raw, w1r, w1i, twiddle, w2, offsets, partial, out, F, group, G,       \
        n_valid, blocks_per_sm, iters, attrs, s);
#define RPF_K1(CODE, CUT)                                                     \
  case CODE:                                                                  \
    return launch_k1_cut<CUT>(raw, twiddle, partial, out, F, group, G,        \
                              n_valid, blocks_per_sm, iters, attrs, s);
#define RPF_K1R(CODE, CUT)                                                    \
  case CODE:                                                                  \
    return launch_k1r_cut<CUT>(raw, twiddle, partial, out, F, group, G,       \
                               n_valid, blocks_per_sm, iters, attrs, s);
  switch (variant) {
    RPF_FAST(kK3, 3, 3)
    RPF_FAST(kS2x1, 3, 1)
    RPF_FAST(kS1x1, 1, 1)
    RPF_FAST(kNoMM, 0, 3, true, kCutZStore)
    RPF_FAST(kNoTw, 3, 3, false)
    RPF_FAST(kZPlanes, 3, 3, true, kCutFull, kInRaw, kS2FromPlanes)
    RPF_FAST(kTpu6, 3, 6)
    RPF_FAST(kTpu6Bf16, 3, 6, true, kCutFull, kInBf16)
    RPF_FAST(kTpu6Wide32, 3, 6, true, kCutFull, kInWide32)
    RPF_FAST(kS1Only, 3, 3, false, kCutStage1)
    RPF_FAST(kS1Tw, 3, 3, true, kCutTwiddle)
    RPF_FAST(kS1TwZ, 3, 3, true, kCutZStore)
    RPF_FAST(kDqOnly, 3, 3, false, kCutDequant, kInRaw)
    RPF_FAST(kDqWide, 3, 3, false, kCutDequant, kInBf16)
    RPF_FAST(kGather, 3, 3, false, kCutGather, kInRaw)
    RPF_FAST(kDqLinear, 3, 3, false, kCutDequant, kInLinear)
    RPF_FAST(kDqPair32, 3, 3, false, kCutDequant, kInPair32)
    RPF_FAST(kTpu6Pipe, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, true)
    RPF_FAST(kTpu6Ilv2, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 2)
    RPF_FAST(kTpu6Ilv4, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 4)
    RPF_FAST(kTpu6FourMult, 3, 6, true, kCutFull, kInRaw, kS2FromZ,
             kS2FourMult)
    RPF_FAST(kTpu6E2, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             true)
    RPF_FAST(kTpu6Left, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Left)
    RPF_FAST(kTpu6E2Left, 3, 6, true, kCutFull, kInRaw, kS2FromZ, kS2Left,
             true)
    RPF_FAST(kTpu6U32t, 3, 6, true, kCutFull, kInPair32, kS2FromZ,
             kS2Karatsuba, true)
    RPF_FAST(kK3Pack, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, false, kS1Packed)
    RPF_FAST(kK3PackPQ, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, false, kS1PackedPQ)
    RPF_FAST(kK3S1Wide, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, false, kS1Wide)
    RPF_FAST(kK3Dg3dAll, 3, 3, true, kCutFull, kInRaw, kS2FromPlanes,
             kS2Karatsuba, false, 1, false, kS1Karatsuba)
    RPF_FAST(kK3S1Cat, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, false, kS1KaratsubaCat)
    RPF_FAST(kK3S1k32, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Karatsuba,
             false, 1, false, kS1SplitK)
    RPF_FAST(kK3Best, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2FourMult)
    RPF_FAST(kK3Left, 3, 3, true, kCutFull, kInRaw, kS2FromZ, kS2Left)
    RPF_FAST(kTpu6ZPlanes, 3, 6, true, kCutFull, kInRaw, kS2FromPlanes)
    RPF_FAST(kTpu6KStack, 3, 6, true, kCutFull, kInRaw, kS2FromPlanes,
             kS2KStacked)
    RPF_K1(kK1, kK1Full)
    RPF_K1(kK1Dq, kK1Dequant)
    RPF_K1(kK1NoFftCut, kK1NoFft)
    RPF_K1R(kK1r, kRegsFull)
    RPF_K1R(kK1rDq, kRegsDequant)
    RPF_K1R(kK1rNoFft, kRegsNoFft)
    default:
      return cudaErrorInvalidValue;
  }
#undef RPF_K1R
#undef RPF_K1
#undef RPF_FAST
}

// P12: cast_test.py's shapes (T, N1, N2, P, Q) = (8, 16, 128, 8, 16); the
// input is (T * N2 * N1,) f32, 64 KB, staged whole in shared memory.
constexpr int kT = 8, kN1 = 16, kN2 = 128, kP = 8, kQ = 16;
constexpr int kRelayoutElems = kT * kN2 * kN1;
constexpr int kRelayoutThreads = 1024;
constexpr int kRelayoutCases = 9;

// The input element that element i of case CASE's output comes from,
// by the case's own shapes (cast_test.py:30-62).
template <int CASE>
__device__ __forceinline__ int relayout_source(int i) {
  if constexpr (CASE == 0) {
    // A: (T*N2, N1) -> (T*Q, P*N1), a reshape.
    return i;
  } else if constexpr (CASE == 1 || CASE == 3) {
    // B: (T*Q, P*N1) as (T, Q, P, N1), transposed (0, 3, 1, 2), merged to
    // (T*N1, N2); D: (T, Q, P, N1) -> (T, N1, Q, P), the same order.
    const int p = i % kP, q = (i / kP) % kQ, n1 = (i / (kP * kQ)) % kN1;
    const int t = i / (kP * kQ * kN1);
    return ((t * kQ + q) * kP + p) * kN1 + n1;
  } else if constexpr (CASE == 2) {
    // C: (T, N1, N2) -> swap (1, 2) -> (T*N2, N1).
    const int n1 = i % kN1, n2 = (i / kN1) % kN2, t = i / (kN1 * kN2);
    return (t * kN1 + n1) * kN2 + n2;
  } else if constexpr (CASE == 4 || CASE == 8) {
    // E: (T, Q, P, N1) -> concat_p x[:, :, p, :] -> (T, Q, P*N1); I: the
    // same through transpose (0, 2, 1, 3) and index p.
    const int col = i % (kP * kN1), p = col / kN1, n1 = col % kN1;
    const int q = (i / (kP * kN1)) % kQ, t = i / (kP * kN1 * kQ);
    return ((t * kQ + q) * kP + p) * kN1 + n1;
  } else if constexpr (CASE == 5) {
    // F: (T, Q, P*N1) -> concat_p swap(x[:, :, p*N1:(p+1)*N1], 1, 2) ->
    // (T*N1, N2).
    const int col = i % kN2, p = col / kQ, q = col % kQ;
    const int n1 = (i / kN2) % kN1, t = i / (kN2 * kN1);
    return (t * kQ + q) * (kP * kN1) + p * kN1 + n1;
  } else if constexpr (CASE == 6) {
    // G: (T, N2, N1) -> (T, Q, P, N1), a reshape.
    return i;
  } else {
    // H: (T, N2, N1) -> concat_p x[:, p::P, :] -> (T, Q, P*N1).
    const int col = i % (kP * kN1), p = col / kN1, n1 = col % kN1;
    const int q = (i / (kP * kN1)) % kQ, t = i / (kP * kN1 * kQ);
    return (t * kN2 + q * kP + p) * kN1 + n1;
  }
}

template <int CASE>
__global__ void __launch_bounds__(kRelayoutThreads)
relayout_kernel(const float4* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float4 buf4[];
  const float* buf = reinterpret_cast<const float*>(buf4);
  for (int i = threadIdx.x; i < kRelayoutElems / 4; i += kRelayoutThreads)
    buf4[i] = __ldg(in + i);
  __syncthreads();
  for (int i = threadIdx.x; i < kRelayoutElems; i += kRelayoutThreads)
    out[i] = buf[relayout_source<CASE>(i)];
}

template <int CASE>
cudaError_t launch_relayout(const void* in, void* out, int iters,
                            cudaStream_t s) {
  constexpr int smem = kRelayoutElems * 4;
  cudaError_t e = cudaFuncSetAttribute(
      relayout_kernel<CASE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int it = 0; it < iters && e == cudaSuccess; ++it) {
    relayout_kernel<CASE><<<1, kRelayoutThreads, smem, s>>>(
        static_cast<const float4*>(in), static_cast<float*>(out));
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

extern "C" {

// Runs variant `variant` (the codes above) `iters` times on `stream`, each
// time both passes. raw: (F, 2N) u8, 16-byte aligned, N = 2048; K3's
// variants take w1r, w1i, twiddle ((N2, N1, 2) f32) and w2 (6 B-fragment
// planes, or 9 for the 6-product scheme, K-stacked too; the left form's
// 9 A-fragment planes, 6 at 3 products; P6's 6 with permuted rows) as
// fused_psd_fast.py and fused_psd_probe.py pack them (the packed forms'
// w1r, w1i: the
// block-diagonal stacks; the wide form's w1r: its N-stacked weights, the
// Karatsuba forms' w1r: the 9 planes or their block-diagonal (9 N1, 3 N1)
// matrix, w1i unread in all three; P8's w2: K3's 6 planes, 4 read), and
// the e2 and u32t variants offsets ((2, N1) f32 cR, cI; else
// null); K1's cuts take
// its stage twiddles ((N - 1, 2) f32) as `twiddle` and ignore w1r, w1i,
// w2 and offsets; the register kernel's cuts likewise, with its
// pass_twiddles(N). partial: (ceil(F / group), N) f32 scratch; out:
// (N,) f32. blocks_per_sm: 0 to launch as the shipping kernels do, b > 0 to
// let at most b blocks reside on an SM (configure above). Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_probe(int variant, const void* raw, const void* w1r,
                        const void* w1i, const void* twiddle, const void* w2,
                        const void* offsets, void* partial, void* out,
                        int device, int F,
                        int group, int n_valid, int blocks_per_sm, int iters,
                        void* stream) {
  if (F <= 0 || group <= 0 || n_valid < 0 || n_valid > F || iters <= 0 ||
      blocks_per_sm < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  return static_cast<int>(launch_variant(
      variant, raw, w1r, w1i, twiddle, w2, offsets, partial, out, F, group, G,
      n_valid, blocks_per_sm, iters, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// Writes what variant `variant`'s group kernel gets at `blocks_per_sm` (as
// rpf_fused_psd_probe) into attrs[0..4]: registers per thread, local
// (spill) bytes per thread, static and dynamic shared bytes per block, and
// the blocks that reside on one SM. Launches nothing.
int rpf_probe_attributes(int variant, int blocks_per_sm, int device,
                         int* attrs) {
  if (blocks_per_sm < 0 || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_variant(variant, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, nullptr,
                                         nullptr, 1, 1, 1, 1, blocks_per_sm, 1,
                                         attrs, nullptr));
}

// The radix-2 kernel whole (fused_psd.cuh at its default cut), as
// rpf_fused_psd launched it before the register kernel: raw (F, 2N) u8,
// 4-byte aligned; twiddle its stage twiddles ((N - 1, 2) f32); window
// (N,) f32, 8-byte aligned, or null; partial (ceil(F / group), N) f32
// scratch; out (N,) f32. N = 2^log2n: 256, 2048, 8192 or 16384. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_radix2_psd(const void* raw, const void* twiddle, const void* window,
                   void* partial, void* out, int device, int log2n, int F,
                   int group, int n_valid, void* stream) {
  if (F <= 0 || group <= 0 || n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window != nullptr;
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = w ? launch_radix2<L, true>(raw, twiddle, window, partial, out, F,    \
                                   group, G, n_valid, s)                     \
          : launch_radix2<L, false>(raw, twiddle, window, partial, out, F,   \
                                    group, G, n_valid, s);                   \
    break;
  switch (log2n) {
    RPF_CASE(8) RPF_CASE(11) RPF_CASE(13) RPF_CASE(14)
    default: e = cudaErrorInvalidValue;
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

// Runs P12's relayout case `which` (0..8 = A..I) `iters` times on
// `stream`: in, out (T*N2*N1,) f32, 16-byte aligned.
int rpf_relayout_probe(int which, const void* in, void* out, int device,
                       int iters, void* stream) {
  if (which < 0 || which >= kRelayoutCases || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: e = launch_relayout<0>(in, out, iters, s); break;
    case 1: e = launch_relayout<1>(in, out, iters, s); break;
    case 2: e = launch_relayout<2>(in, out, iters, s); break;
    case 3: e = launch_relayout<3>(in, out, iters, s); break;
    case 4: e = launch_relayout<4>(in, out, iters, s); break;
    case 5: e = launch_relayout<5>(in, out, iters, s); break;
    case 6: e = launch_relayout<6>(in, out, iters, s); break;
    case 7: e = launch_relayout<7>(in, out, iters, s); break;
    default: e = launch_relayout<8>(in, out, iters, s); break;
  }
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
