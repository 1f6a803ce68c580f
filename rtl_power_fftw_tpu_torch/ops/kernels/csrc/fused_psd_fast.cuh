// K3's group kernel (fused_psd_fast.cu, --precision high) as one template.
//
// psd_fast_group_kernel<LOG2N, WINDOWED, V> is the whole of K3's first
// pass; fused_psd_fast.cu instantiates it with the default V =
// FastVariant<>, which compiles to the shipping kernel. The other values
// of V are the probes of fused_psd_probe.cu, the Hopper counterparts of
// probes/profile_pallas.py:build (P1), s1_lanes.py:build (P18),
// s1_lanes2.py:build (P13), s2_fourmult.py:build (P14), s2_left.py:build
// (P16), s2_ilv.py:build (P19), s2_pipe.py:build (P11), s2_u32t.py:build
// (P17) and profile_pallas.py:build_pack8 (P2), build_pack8c (P6),
// build_s1wide (P5), build_dg3dall (P3), build_s1cat (P4), build_s1k (P7),
// build_best (P8), build_v5 (P9) and build_v6 (P10). Each parameter is a
// compile-time constant, so a variant pays for nothing it does not run,
// and each addition is a branch that the default discards:
//
//   S1_TERMS     stage-1 weight terms: 3 (K3), 1, or 0 (no stage-1
//                products: Y is the dequantized frame in (n2, n1) order);
//   S2_PRODUCTS  stage-2 products per Karatsuba part: 3 (K3: z0c0 + z0c1 +
//                z1c0), 1 (z0c0), or 6 (the TPU's default scheme: 3-term
//                splits of z and of the weights with i + j >= 3 dropped,
//                z0c0 + z0c1 + z0c2 + z1c0 + z1c1 + z2c0, as
//                probes/s1_lanes.py:104-118; the weights then come as 9
//                B-fragment planes, not 6);
//   TWIDDLE      the inter-stage twiddle, or Z = Y;
//   CUT          where the variant stops (kCut* below);
//   INPUT        how the frame sits in shared memory for the stage-1
//                gather (kIn* below);
//   S2_SOURCE    where stage 2 takes its A fragments (kS2From* below);
//                the split planes hold 2-term splits, or 3-term ones at
//                S2_PRODUCTS = 6 (9 planes: the narrow 6-product order
//                from them is tpu6 bit for bit);
//   S2_FORM      how stage 2 multiplies (kS2Karatsuba, kS2FourMult,
//                kS2Left, kS2KStacked below; the 4-mult and left forms
//                with S2_PRODUCTS = 6 or 3 (P8's 2-term 4-mult, P9
//                v5left's 3-product left form), the K-stacked one with 6
//                from the split planes (P10 v6k);
//   RAW_BYTES    stage 1 multiplies the raw bytes 0..255 (exact in bf16)
//                and subtracts the -127 offset's image after it, per k1:
//                cR = 127 colsum(WR), cI = 127 colsum(WI), passed in the
//                window's place (P16 e2, probes/s2_left.py:51-61, 87-88;
//                the TPU's select/duplicate matmul is its way to relayout
//                the bytes and has no counterpart here). With INPUT =
//                kInPair32 (P17 u32t) each A register comes from one pair
//                word: bytes 0 and 2 are re(n1), re(n1 + 1), bytes 1 and 3
//                im; the TPU permutes its weight rows to [even n1 | odd
//                n1] only because its byte planes come out as even and odd
//                halves, and a register here holds n1, n1 + 1 in order, so
//                that permutation has no counterpart either;
//   CHAINS       frames a block takes at a time (P19): it loads 1, 2 or 4
//                frames, runs stage 1 of each into its own Z buffer,
//                syncs, then runs their stage 2 in one loop whose inner
//                loop is the chain, so one chain's gathers and splits sit
//                beside another's mma; |X|^2 still adds in frame order;
//   PIPELINE     (P11) one __syncthreads a frame: iteration i runs stage
//                1 of frame i into Z buffer i % 2 and stage 2 of frame
//                i - 1 from the other, while frame i + 1 travels through
//                registers into the other raw buffer;
//   S1_FORM      how stage 1 multiplies (kS1* below): K3's K-stack; its
//                rows packed PACK = 128 / N1 to a 128-column lane group
//                against block-diagonal weights, Z in K3's order (P2) or
//                in (p, q) order (P6) (stage1_packed); or two products
//                against N-stacked weights (P5: stage1_wide); or, inside
//                the frame loop's items, the Karatsuba of 3 products
//                (P3), its block-diagonal product (P4), both
//                (stage1_karatsuba), or the K-stack in three chains (P7:
//                stage1_split_k). Each takes K3's raw input, 3 terms and
//                twiddle and leaves Z in f32 for stage 2's own code (P6's
//                weights permuted to match); P3 leaves Z's split planes.
// The two schedules run the 6-product scheme (tpu6) through the
// tpu6_stage1 / tpu6_stage2 helpers below, the same arithmetic in the
// same order per accumulator as the frame loop's, so their output equals
// tpu6's bit for bit.
//
// A cut variant writes an output that depends on all the work it keeps,
// so that nvcc deletes none of it: the sums of |Y|^2 or |Z|^2 in (n2, k1)
// order (index n2*N1 + k1), or, for the gather and dequantization cuts,
// the block's sum of every value it gathered, written to every bin (the
// TPU probes' `consume`, probes/s1_lanes2.py:52-60). The plain PyTorch
// version of each is in ops/kernels/fused_psd_probe.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Where a variant stops.
enum : int {
  kCutFull = 0,     // the whole step: |X|^2 in bin order k1 + N1*k2
  kCutGather = 1,   // the stage-1 gather of the raw u16 elements only
  kCutDequant = 2,  // + dequantization into the bf16 A fragments
  kCutStage1 = 3,   // + stage-1 products; sums |Y|^2
  kCutTwiddle = 4,  // + twiddle; sums |Z|^2 from registers
  kCutZStore = 5,   // + Z stored to shared memory, read back once; |Z|^2
};

// How the frame sits in shared memory for the stage-1 gather.
enum : int {
  kInRaw = 0,     // raw u16 IQ pairs (2N bytes), dequantized at the gather
  kInBf16 = 1,    // dequantized at load into bf16 planes [n1][n2] (rows
                  // padded to N2 + 8), A fragments by ldmatrix.trans
  kInWide32 = 2,  // every u16 widened to 4 bytes (4N), dequantized at gather
  kInPair32 = 3,  // 4-byte words of the (n1, n1 + 1) u16 pair that one A
                  // register holds, built at load; one load per register
  kInLinear = 4,  // raw u16 read in load order, no strided gather (the
                  // wrong elements: dequantization cost only)
};

// Where stage 2 takes its A fragments.
enum : int {
  kS2FromZ = 0,       // f32 Z in shared memory, gathered and split per mma
  kS2FromPlanes = 1,  // Z's bf16 split planes [k1][n2] (rows padded to
                      // N2 + 8), written by stage 1, loaded by ldmatrix
};

// How stage 2 multiplies (the 6-product splits of z and the weights).
enum : int {
  kS2Karatsuba = 0,  // 3 real products zr.w2r, zi.w2i, zs.w2s; A = split
                     // Z rows k1, B = weights; xr = u1 - u2, xi = u3 -
                     // u1 - u2 (K3, the TPU's v6)
  kS2FourMult = 1,   // the 4-mult complex product (P14 v7): xr = zr.r -
                     // zi.i, xi = zr.i + zi.r, 6 A planes (no zs), the 6
                     // B planes r0..2, i0..2, 24 mma per (chunk, n-tile);
                     // with S2_PRODUCTS = 3 (P8 best) the 2-term splits,
                     // A planes z0r, z1r, z0i, z1i, B planes K3's r0, r1,
                     // i0, i1, z1.c1 dropped: 12 mma
  kS2Left = 2,       // Karatsuba with the operands swapped (P16 left):
                     // A = the weights as A fragments (rows k2), B = split
                     // Z (columns k1); D holds X in bin order; with
                     // S2_PRODUCTS = 3 (P9 v5left) 6 weight planes and
                     // 2-term splits of Z, c0.z0 + c1.z0 + c0.z1 a part
  kS2KStacked = 3,   // the 6-product Karatsuba with its K loop
                     // block-major (P10 v6k: one product of [z0 z0 z0 z1
                     // z1 z2] with vstack(c0 c1 c2 c0 c1 c0) a part): the
                     // term pair outer, the chunk inner, each mma loading
                     // its A plane by ldmatrix from the 9 split planes and
                     // its B fragment from tpu6's 9 weight planes
};

// How stage 1 multiplies.
enum : int {
  kS1KStack = 0,    // K3: A = [ar ai] rows n2 x columns n1, against the
                    // K-stacked (6 N1, N1) WR and WI
  kS1Packed = 1,    // P2 pack8: A rows q, columns (p, n1) of n2 = PACK q +
                    // p, against kron(I_PACK, block) of each K-stack block
  kS1PackedPQ = 2,  // P6 pack8c: kS1Packed with Z stored at row p Q + q
  kS1Wide = 3,      // P5 s1wide: ar and ai each against the N-stacked
                    // (N1, 6 N1) [w1r0 w1r1 w1r2 w1i0 w1i1 w1i2]
  kS1Karatsuba = 4, // P3 dg3dall: t1 = ar.w1r, t2 = ai.w1i, t3 = as.w1s
                    // (as = ar + ai, w1s = split(w1r + w1i)), 3 terms each
                    // from 9 (N1, N1) planes; yr = t1 - t2, yi = t3 - t1 - t2
  kS1KaratsubaCat = 5,  // P4 s1cat: the same as one product of [ar ar ar
                        // ai ai ai as as as] with the block-diagonal
                        // (9 N1, 3 N1) weights, zero blocks multiplied
  kS1SplitK = 6,    // P7 s1k32: K3's K-stack in three chains, term j's
                    // blocks [w1r_j; -w1i_j] in chain j, summed after
};

template <int S1_TERMS_ = 3, int S2_PRODUCTS_ = 3, bool TWIDDLE_ = true,
          int CUT_ = kCutFull, int INPUT_ = kInRaw,
          int S2_SOURCE_ = kS2FromZ, int S2_FORM_ = kS2Karatsuba,
          bool RAW_BYTES_ = false, int CHAINS_ = 1, bool PIPELINE_ = false,
          int S1_FORM_ = kS1KStack>
struct FastVariant {
  static constexpr int S1_TERMS = S1_TERMS_;
  static constexpr int S2_PRODUCTS = S2_PRODUCTS_;
  static constexpr bool TWIDDLE = TWIDDLE_;
  static constexpr int CUT = CUT_;
  static constexpr int INPUT = INPUT_;
  static constexpr int S2_SOURCE = S2_SOURCE_;
  static constexpr int S2_FORM = S2_FORM_;
  static constexpr bool RAW_BYTES = RAW_BYTES_;
  static constexpr int CHAINS = CHAINS_;
  static constexpr bool PIPELINE = PIPELINE_;
  static constexpr int S1_FORM = S1_FORM_;
  static constexpr bool SCHEDULED = CHAINS > 1 || PIPELINE;
  static_assert(S1_TERMS == 0 || S1_TERMS == 1 || S1_TERMS == 3, "terms");
  static_assert(S2_PRODUCTS == 1 || S2_PRODUCTS == 3 || S2_PRODUCTS == 6,
                "products");
  static_assert(S1_TERMS > 0 || (INPUT == kInRaw && CUT >= kCutStage1),
                "Y = x reads the raw frame at the D-fragment positions");
  static_assert(S2_FORM == kS2Karatsuba ||
                    (S2_FORM == kS2KStacked
                         ? S2_SOURCE == kS2FromPlanes && S2_PRODUCTS == 6
                         : S2_SOURCE == kS2FromZ && S2_PRODUCTS >= 3),
                "the 4-mult and left forms take 3- or 2-term splits of Z, "
                "the K-stacked form Z's 3-term split planes");
  static_assert(!RAW_BYTES || ((INPUT == kInRaw || INPUT == kInPair32) &&
                               S1_TERMS == 3 && CUT == kCutFull),
                "raw bytes on the raw or pair-word input path, whole step");
  static_assert(S1_FORM == kS1KStack ||
                    (S1_TERMS == 3 && TWIDDLE && CUT == kCutFull &&
                     INPUT == kInRaw &&
                     (S2_SOURCE == kS2FromZ || S1_FORM == kS1Karatsuba) &&
                     S2_FORM == kS2Karatsuba && !RAW_BYTES && !SCHEDULED),
                "another stage 1 takes K3's input and leaves Z (the "
                "Karatsuba form also Z's split planes)");
  static_assert(CHAINS == 1 || CHAINS == 2 || CHAINS == 4, "chains");
  static_assert(!SCHEDULED ||
                    (!(CHAINS > 1 && PIPELINE) && S1_TERMS == 3 &&
                     S2_PRODUCTS == 6 && TWIDDLE && CUT == kCutFull &&
                     INPUT == kInRaw && S2_SOURCE == kS2FromZ &&
                     S2_FORM == kS2Karatsuba && !RAW_BYTES),
                "a schedule of the 6-product scheme");
};

// Shared memory of one block, in float4 units: [Z f32 | input | window |
// Z split planes], each part present only where the variant uses it, the
// Z and raw parts BUFS times for a schedule (2 pipelined, else CHAINS),
// the split planes 6 (2-term splits) or 9 (3-term, S2_PRODUCTS = 6).
// The default variant gets K3's layout: Z 8N, raw 2N, window 4N bytes.
template <int LOG2N, bool WINDOWED, class V>
struct FastSmem {
  using S = FastShape<LOG2N>;
  static constexpr int N = S::N, N1 = S::N1, N2 = S::N2;
  static constexpr int ROW = N2 + 8;   // bf16 plane row: 16-byte aligned
  static constexpr int BUFS = V::PIPELINE ? 2 : V::CHAINS;
  static constexpr bool Z_F32 =
      (V::CUT == kCutFull && V::S2_SOURCE == kS2FromZ) || V::CUT == kCutZStore;
  static constexpr int IN = Z_F32 ? BUFS * N / 2 : 0;
  static constexpr int RAW4 = N / 8;   // one raw frame (a schedule's buffer)
  static constexpr int WIN =
      IN + (V::INPUT == kInWide32 ? N / 4
            : V::INPUT == kInBf16 ? 2 * N1 * ROW * 2 / 16 : BUFS * N / 8);
  static constexpr int ZP = WIN + (WINDOWED ? N / 4 : 0);
  static constexpr int ZP_PLANE = N1 * ROW;   // bf16 elements
  static constexpr int ZP_PLANES = V::S2_PRODUCTS == 6 ? 9 : 6;
  static constexpr int BYTES =
      16 * (ZP + (V::S2_SOURCE == kS2FromPlanes
                      ? ZP_PLANES * ZP_PLANE * 2 / 16 : 0));
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

// split2 or split3, by the number of terms.
template <int TERMS>
__device__ __forceinline__ void split_terms(float x,
                                            __nv_bfloat16 (&t)[TERMS]) {
  static_assert(TERMS == 2 || TERMS == 3, "terms");
  if constexpr (TERMS == 3) {
    split3(x, t);
  } else {
    split2(x, t);
  }
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

// An A fragment of four 8x8 bf16 matrices from shared memory: lane l gives
// the address of row l & 7 of matrix l >> 3. With .trans each matrix is
// stored transposed (its rows are the fragment's columns).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float dequant(uint32_t byte) {
  return static_cast<float>(static_cast<int>(byte) - 127);
}

// A stage-1 input value: the dequantized byte, or the byte itself.
template <bool RAW_BYTES>
__device__ __forceinline__ float stage1_value(uint32_t byte) {
  if constexpr (RAW_BYTES) {
    return static_cast<float>(byte);
  } else {
    return dequant(byte);
  }
}

// The two bf16 values of a packed register, added in f32.
__device__ __forceinline__ float bf16_pair_sum(uint32_t v) {
  return __fadd_rn(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}

__device__ __forceinline__ float add_norm(float acc, float re, float im) {
  return __fadd_rn(acc, __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// K3's stage-1 A fragments of chunk c for row tile mt: A[row n2][col n1]
// = x[N2 n1 + n2], the pair n1, n1 + 1, dequantized: planes ar, ai and,
// with PLANES = 3, as = ar + ai (integers of at most 256 in magnitude,
// exact in bf16).
template <int LOG2N, int PLANES>
__device__ __forceinline__ void gather_k3(const uint16_t* iq, int c, int mt,
                                          int lane, uint32_t (&a)[PLANES][4]) {
  constexpr int N2 = FastShape<LOG2N>::N2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g +
                  8 * (q & 1);
    const uint32_t v0 = iq[n], v1 = iq[n + N2];
    const float r0 = dequant(v0 & 0xFFu), i0 = dequant(v0 >> 8);
    const float r1 = dequant(v1 & 0xFFu), i1 = dequant(v1 >> 8);
    a[0][q] = pack2(__float2bfloat16_rn(r0), __float2bfloat16_rn(r1));
    a[1][q] = pack2(__float2bfloat16_rn(i0), __float2bfloat16_rn(i1));
    if constexpr (PLANES == 3) {
      a[2][q] = pack2(__float2bfloat16_rn(__fadd_rn(r0, i0)),
                      __float2bfloat16_rn(__fadd_rn(r1, i1)));
    }
  }
}

// One Karatsuba part of the 6-product stage 2: 3-term splits z0, z1, z2
// of z times the weight terms c0, c1, c2 (B planes b, b + PLANE,
// b + 2 PLANE) with i + j >= 3 dropped, in the order of
// probes/s1_lanes.py:113-118: z0c0 + z0c1 + z0c2 + z1c0 + z1c1 + z2c0.
template <int PLANE>
__device__ __forceinline__ void six_products(float (&u)[4],
                                             const uint32_t (&z0)[4],
                                             const uint32_t (&z1)[4],
                                             const uint32_t (&z2)[4],
                                             const uint2* b) {
  const uint2 c0 = __ldg(b), c1 = __ldg(b + PLANE), c2 = __ldg(b + 2 * PLANE);
  mma_bf16(u, z0, c0);
  mma_bf16(u, z0, c1);
  mma_bf16(u, z0, c2);
  mma_bf16(u, z1, c0);
  mma_bf16(u, z1, c1);
  mma_bf16(u, z2, c0);
}

// six_products with the weight terms c[0..2] already loaded (the 4-mult
// form reads each of its 6 B planes once for two parts).
__device__ __forceinline__ void six_products_loaded(float (&u)[4],
                                              const uint32_t (&z0)[4],
                                              const uint32_t (&z1)[4],
                                              const uint32_t (&z2)[4],
                                              const uint2 (&c)[3]) {
  mma_bf16(u, z0, c[0]);
  mma_bf16(u, z0, c[1]);
  mma_bf16(u, z0, c[2]);
  mma_bf16(u, z1, c[0]);
  mma_bf16(u, z1, c[1]);
  mma_bf16(u, z2, c[0]);
}

// The same with the weights as A (c0, c1, c2) and z as B (the left form,
// probes/s2_left.py:116-120, in its order).
__device__ __forceinline__ void six_products_left(float (&u)[4],
                                                  const uint32_t (&c0)[4],
                                                  const uint32_t (&c1)[4],
                                                  const uint32_t (&c2)[4],
                                                  uint2 z0, uint2 z1,
                                                  uint2 z2) {
  mma_bf16(u, c0, z0);
  mma_bf16(u, c1, z0);
  mma_bf16(u, c2, z0);
  mma_bf16(u, c0, z1);
  mma_bf16(u, c1, z1);
  mma_bf16(u, c0, z2);
}

// The 3-product left form's part (P9 v5left, probes/profile_pallas.py:838,
// in its order): 2-term weights c0, c1 as A, 2-term splits of z as B,
// c0.z0 + c1.z0 + c0.z1.
__device__ __forceinline__ void three_products_left(float (&u)[4],
                                                    const uint32_t (&c0)[4],
                                                    const uint32_t (&c1)[4],
                                                    uint2 z0, uint2 z1) {
  mma_bf16(u, c0, z0);
  mma_bf16(u, c1, z0);
  mma_bf16(u, c0, z1);
}

// Stage 2 in the left form (P16 left): X[k2][k1] = sum_n2 W2[k2][n2]
// Z[n2][k1], the 6-product Karatsuba (PRODUCTS = 3: P9 v5left's 2-term
// form), |X|^2 added to acc. Item = (32 rows k2: two m16 tiles) x (8
// columns k1: one n8 tile), so two warps, not four, gather and split each
// Z element; each warp reads twice the weights (A fragments, 16 bytes a
// lane, packed by fused_psd_probe.py:pack_a_fragments). acc[i][m] is
// m-tile m's D fragment: X at k2 = 32kh + 16m + g + 8(e >> 1), k1 = 8nt +
// 2t + (e & 1).
template <int LOG2N, int PRODUCTS>
__device__ __forceinline__ void stage2_left(
    const float2* z, const uint4* __restrict__ w2,
    float (&acc)[FastShape<LOG2N>::ITEMS_PER_WARP][2][4], int warp,
    int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N1 = S::N1, N2 = S::N2;
  static_assert(N2 >= 32 && (N2 / 32) * (N1 / 8) == S::ITEMS, "items");
  static_assert(PRODUCTS == 6 || PRODUCTS == 3, "products");
  // 3 TERMS A-fragment planes (w2r0.., w2i0.., w2s0..), each [m-tile][chunk].
  constexpr int TERMS = PRODUCTS == 6 ? 3 : 2;
  constexpr int PLANE = (N2 / 16) * (N2 / 16) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
    const int item = warp + i * S::WARPS;
    const int kh = item / (N1 / 8);
    const int k1 = 8 * (item % (N1 / 8)) + g;
    float u1[2][4] = {}, u2[2][4] = {}, u3[2][4] = {};
    for (int c = 0; c < N2 / 16; ++c) {
      // B[n2][k1] = Z[16c + n2][k1]: b.x rows 2t, 2t + 1; b.y 2t + 8, 2t + 9.
      const int n2 = 16 * c + 2 * t;
      const float2 p[4] = {z[n2 * N1 + k1], z[(n2 + 1) * N1 + k1],
                           z[(n2 + 8) * N1 + k1], z[(n2 + 9) * N1 + k1]};
      __nv_bfloat16 r[4][TERMS], im[4][TERMS], s[4][TERMS];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        split_terms<TERMS>(p[k].x, r[k]);
        split_terms<TERMS>(p[k].y, im[k]);
        split_terms<TERMS>(__fadd_rn(p[k].x, p[k].y), s[k]);
      }
      uint2 b[3 * TERMS];
#pragma unroll
      for (int e = 0; e < TERMS; ++e) {
        b[e] = make_uint2(pack2(r[0][e], r[1][e]), pack2(r[2][e], r[3][e]));
        b[TERMS + e] = make_uint2(pack2(im[0][e], im[1][e]),
                                  pack2(im[2][e], im[3][e]));
        b[2 * TERMS + e] =
            make_uint2(pack2(s[0][e], s[1][e]), pack2(s[2][e], s[3][e]));
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint4* a = w2 + ((2 * kh + m) * (N2 / 16) + c) * 32 + lane;
        uint32_t w[3 * TERMS][4];
#pragma unroll
        for (int pl = 0; pl < 3 * TERMS; ++pl) {
          const uint4 v = __ldg(a + pl * PLANE);
          w[pl][0] = v.x, w[pl][1] = v.y, w[pl][2] = v.z, w[pl][3] = v.w;
        }
        if constexpr (TERMS == 3) {
          six_products_left(u1[m], w[0], w[1], w[2], b[0], b[1], b[2]);
          six_products_left(u2[m], w[3], w[4], w[5], b[3], b[4], b[5]);
          six_products_left(u3[m], w[6], w[7], w[8], b[6], b[7], b[8]);
        } else {
          three_products_left(u1[m], w[0], w[1], b[0], b[1]);
          three_products_left(u2[m], w[2], w[3], b[2], b[3]);
          three_products_left(u3[m], w[4], w[5], b[4], b[5]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xr = __fsub_rn(u1[m][e], u2[m][e]);
        const float xi = __fsub_rn(__fsub_rn(u3[m][e], u1[m][e]), u2[m][e]);
        acc[i][m][e] = __fadd_rn(
            acc[i][m][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
      }
  }
}

// Stage 2 K-stacked (P10 v6k, probes/profile_pallas.py:938-943, 973-977):
// per Karatsuba part one product of lhs2 = [z0 z0 z0 z1 z1 z2] (rows k1,
// 6 N2 columns) with vstack(c0 c1 c2 c0 c1 c0), its K loop block-major as
// the TPU's one dot walks it: the six (z term, weight term) blocks outer,
// the N2 / 16 chunks of each inner. tpu6's 18 mma per (chunk, n-tile), in
// another order of f32 sums: each A fragment is loaded by ldmatrix from
// Z's 9 split planes zp ([k1][n2], rows of ROW bf16: zr0..2, zi0..2,
// zs0..2, written once by stage 1) for the block that uses it, so z0's
// three times and z1's twice, and each B fragment from tpu6's 9 weight
// planes w2 (w2r0..2, w2i0..2, w2s0..2) for its one mma. Items, D
// fragments and |X|^2 as the frame loop's Karatsuba stage 2.
template <int LOG2N, int ROW>
__device__ __forceinline__ void stage2_kstacked(
    const __nv_bfloat16* zp, const uint2* __restrict__ w2,
    float (&acc)[FastShape<LOG2N>::ITEMS_PER_WARP][2][4], int warp,
    int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N1 = S::N1, N2 = S::N2;
  constexpr int ZP_PLANE = N1 * ROW;
  constexpr int W2_PLANE = (N2 / 16) * (N2 / 8) * 32;
  // Matrix m = lane >> 3 of an A fragment: rows k1 = 16mt + 8(m & 1) +
  // (lane & 7), columns n2 from 16c + 8(m >> 1).
  const int m = lane >> 3;
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
    const int item = warp + i * S::WARPS;
    const int mt = item / (N2 / 16);
    const int ng = item % (N2 / 16);
    float u[3][2][4] = {};   // u1, u2, u3 (parts r, i, s) by n-tile
    const uint32_t at = shared_addr(
        zp + (16 * mt + 8 * (m & 1) + (lane & 7)) * ROW + 8 * (m >> 1));
#pragma unroll
    for (int blk = 0; blk < 6; ++blk) {
      // Block blk of [z0 z0 z0 z1 z1 z2] against [c0 c1 c2 c0 c1 c0].
      const int zt = blk < 3 ? 0 : blk < 5 ? 1 : 2;
      const int ct = blk < 3 ? blk : blk < 5 ? blk - 3 : 0;
      for (int c = 0; c < N2 / 16; ++c) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t a[4];
          ldmatrix_x4(a, at + 2 * ((3 * p + zt) * ZP_PLANE + 16 * c));
          const uint2* b = w2 + (3 * p + ct) * W2_PLANE +
                           (c * (N2 / 8) + 2 * ng) * 32 + lane;
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(u[p][j], a, __ldg(b + 32 * j));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xr = __fsub_rn(u[0][j][e], u[1][j][e]);
        const float xi = __fsub_rn(__fsub_rn(u[2][j][e], u[0][j][e]),
                                   u[1][j][e]);
        acc[i][j][e] = __fadd_rn(
            acc[i][j][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
      }
  }
}

// The schedules' stage 1 (the 6-product scheme's: raw input, 3 weight
// terms, twiddle): the frame staged at raw4 -> Z at z. The frame loop's
// arithmetic, in its order.
template <int LOG2N>
__device__ __forceinline__ void tpu6_stage1(
    const uint4* raw4, float2* z, const uint2* __restrict__ w1r,
    const uint2* __restrict__ w1i, const float4* __restrict__ twiddle,
    int warp, int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N1 = S::N1, N2 = S::N2;
  const uint16_t* iq = reinterpret_cast<const uint16_t*>(raw4);  // (N1, N2)
  const int g = lane >> 2, t = lane & 3;
  for (int item = warp; item < S::ITEMS; item += S::WARPS) {
    const int mt = item / (N1 / 16);
    const int ng = item % (N1 / 16);
    float yr[2][4] = {}, yi[2][4] = {};
    for (int c = 0; c < N1 / 16; ++c) {
      uint32_t a[2][4];
      gather_k3<LOG2N, 2>(iq, c, mt, lane, a);
#pragma unroll
      for (int b = 0; b < 6; ++b) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx =
              ((b * (N1 / 16) + c) * (N1 / 8) + 2 * ng + j) * 32 + lane;
          mma_bf16(yr[j], a[b & 1], __ldg(w1r + idx));
          mma_bf16(yi[j], a[b & 1], __ldg(w1i + idx));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n2 = 16 * mt + g + 8 * h;
        const int k1 = 16 * ng + 8 * j + 2 * t;
        const float ar = yr[j][2 * h], ai = yi[j][2 * h];
        const float br = yr[j][2 * h + 1], bi = yi[j][2 * h + 1];
        const float4 tw = __ldg(twiddle + (n2 * N1 + k1) / 2);
        float4 o;
        o.x = __fsub_rn(__fmul_rn(ar, tw.x), __fmul_rn(ai, tw.y));
        o.y = __fadd_rn(__fmul_rn(ar, tw.y), __fmul_rn(ai, tw.x));
        o.z = __fsub_rn(__fmul_rn(br, tw.z), __fmul_rn(bi, tw.w));
        o.w = __fadd_rn(__fmul_rn(br, tw.w), __fmul_rn(bi, tw.z));
        reinterpret_cast<float4*>(z)[(n2 * N1 + k1) / 2] = o;
      }
    }
  }
}

// The schedules' stage 2 (the 6-product Karatsuba from Z) of CH frames
// whose Z sit at z + ch * N (float2), |X|^2 added to acc for the first
// `live` of them in chain order. The chain is the inner loop, so the
// chains' independent gathers, splits and mma interleave; per
// accumulator the frame loop's order.
template <int LOG2N, int CH>
__device__ __forceinline__ void tpu6_stage2(
    const float2* z, const uint2* __restrict__ w2,
    float (&acc)[FastShape<LOG2N>::ITEMS_PER_WARP][2][4], int live,
    int warp, int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N = S::N, N1 = S::N1, N2 = S::N2;
  constexpr int W2_PLANE = (N2 / 16) * (N2 / 8) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
    const int item = warp + i * S::WARPS;
    const int mt = item / (N2 / 16);
    const int ng = item % (N2 / 16);
    float u1[CH][2][4] = {}, u2[CH][2][4] = {}, u3[CH][2][4] = {};
    for (int c = 0; c < N2 / 16; ++c) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const float2* zc = z + ch * N;
        uint32_t a[9][4];   // zr0..2, zi0..2, zs0..2
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k1 = 16 * mt + g + 8 * (q & 1);
          const int n2 = 16 * c + 2 * t + 8 * (q >> 1);
          const float2 p0 = zc[n2 * N1 + k1], p1 = zc[(n2 + 1) * N1 + k1];
          __nv_bfloat16 r0[3], r1[3], i0[3], i1[3], s0[3], s1[3];
          split3(p0.x, r0);
          split3(p1.x, r1);
          split3(p0.y, i0);
          split3(p1.y, i1);
          split3(__fadd_rn(p0.x, p0.y), s0);
          split3(__fadd_rn(p1.x, p1.y), s1);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            a[e][q] = pack2(r0[e], r1[e]);
            a[3 + e][q] = pack2(i0[e], i1[e]);
            a[6 + e][q] = pack2(s0[e], s1[e]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2* b = w2 + (c * (N2 / 8) + 2 * ng + j) * 32 + lane;
          six_products<W2_PLANE>(u1[ch][j], a[0], a[1], a[2], b);
          six_products<W2_PLANE>(u2[ch][j], a[3], a[4], a[5], b + 3 * W2_PLANE);
          six_products<W2_PLANE>(u3[ch][j], a[6], a[7], a[8], b + 6 * W2_PLANE);
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      if (ch >= live) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xr = __fsub_rn(u1[ch][j][e], u2[ch][j][e]);
          const float xi =
              __fsub_rn(__fsub_rn(u3[ch][j][e], u1[ch][j][e]), u2[ch][j][e]);
          acc[i][j][e] = __fadd_rn(
              acc[i][j][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
        }
      }
    }
  }
}

// The A register of two bytes, one in the low byte of each 16-bit half of
// v: their bf16 pair, low half first (exact: 0..255 needs 8 significant
// bits, bf16 has 8).
__device__ __forceinline__ uint32_t bf16_byte_pair(uint32_t v) {
  return pack2(__float2bfloat16_rn(static_cast<float>(v & 0xFFu)),
               __float2bfloat16_rn(static_cast<float>(v >> 16)));
}

// Y at (k1, k1 + 1) of one row, (ar, ai) and (br, bi), times the twiddle's
// two values tw: Z as (re, im, re, im), K3's arithmetic.
__device__ __forceinline__ float4 twiddled(float ar, float ai, float br,
                                           float bi, float4 tw) {
  return make_float4(__fsub_rn(__fmul_rn(ar, tw.x), __fmul_rn(ai, tw.y)),
                     __fadd_rn(__fmul_rn(ar, tw.y), __fmul_rn(ai, tw.x)),
                     __fsub_rn(__fmul_rn(br, tw.z), __fmul_rn(bi, tw.w)),
                     __fadd_rn(__fmul_rn(br, tw.w), __fmul_rn(bi, tw.z)));
}

// Stage 1 and twiddle with the frame's rows packed PACK = 128 / N1 to a
// 128-column lane group (P2 pack8, P6 pack8c; profile_pallas.py:182-199,
// 541-559): A row q of Q = N2 / PACK holds the columns (p, n1) of the
// samples n2 = PACK q + p, and each of K3's six K-stack blocks of WR and
// WI becomes kron(I_PACK, block), (6 PACK N1, PACK N1) B fragments a
// plane. The zero blocks are multiplied: that is the probe (the TPU paid
// for them to fill its 128-wide unit), PACK times K3's products and PACK^2
// its weight bytes, read through L1/L2 as K3's. Per accumulator the
// nonzero products come in K3's order. The twiddle is K3's (N2, N1) array
// read as (Q, PACK N1). Z goes to K3's row n2 (P2) or to row p Q + q (PQ:
// P6, whose stage-2 weight rows are permuted to match, 529-533).
template <int LOG2N, bool PQ>
__device__ __forceinline__ void stage1_packed(
    const uint16_t* iq, float2* z, const uint2* __restrict__ w1r,
    const uint2* __restrict__ w1i, const float4* __restrict__ twiddle,
    int warp, int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N1 = S::N1, N2 = S::N2;
  constexpr int PACK = 128 / N1, Q = N2 / PACK, W = PACK * N1;
  static_assert(PACK >= 1 && Q % 16 == 0 && (Q / 16) * (W / 16) == S::ITEMS,
                "16-row tiles of q, 16-column items of (p, k1)");
  const int g = lane >> 2, t = lane & 3;
  for (int item = warp; item < S::ITEMS; item += S::WARPS) {
    const int mt = item / (W / 16);
    const int ng = item % (W / 16);
    float yr[2][4] = {}, yi[2][4] = {};
    for (int c = 0; c < W / 16; ++c) {
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // A[row q][col (p, n1)] = x[N2 n1 + PACK q + p]; the pair is n1,
        // n1 + 1 of one p.
        const int col = 16 * c + 2 * t + 8 * (q >> 1);
        const int n = N2 * (col % N1) + PACK * (16 * mt + g + 8 * (q & 1)) +
                      col / N1;
        const uint32_t v0 = iq[n], v1 = iq[n + N2];
        a[0][q] = pack2(__float2bfloat16_rn(dequant(v0 & 0xFFu)),
                        __float2bfloat16_rn(dequant(v1 & 0xFFu)));
        a[1][q] = pack2(__float2bfloat16_rn(dequant(v0 >> 8)),
                        __float2bfloat16_rn(dequant(v1 >> 8)));
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx = ((b * (W / 16) + c) * (W / 8) + 2 * ng + j) * 32 + lane;
          mma_bf16(yr[j], a[b & 1], __ldg(w1r + idx));
          mma_bf16(yi[j], a[b & 1], __ldg(w1i + idx));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 16 * mt + g + 8 * h;
        const int col = 16 * ng + 8 * j + 2 * t;   // even: k1, k1 + 1 of one p
        const int p = col / N1, k1 = col % N1;
        const float4 o = twiddled(yr[j][2 * h], yi[j][2 * h], yr[j][2 * h + 1],
                                  yi[j][2 * h + 1],
                                  __ldg(twiddle + (q * W + col) / 2));
        const int row = PQ ? p * Q + q : PACK * q + p;
        reinterpret_cast<float4*>(z)[(row * N1 + k1) / 2] = o;
      }
    }
  }
}

// Stage 1 and twiddle as two products a row block (P5 s1wide,
// profile_pallas.py:444-459): K3's items, the A fragments of ar and ai
// gathered once, each against the N-stacked (N1, 6 N1) [w1r0 w1r1 w1r2
// w1i0 w1i1 w1i2] (w1: its B fragments), into six f32 accumulators a
// plane, combined after: yr = (ar.w1r0 + ar.w1r1 + ar.w1r2) - (ai.w1i0 +
// ai.w1i1 + ai.w1i2), yi = (ar.w1i0 + ...) + (ai.w1r0 + ...). K3's
// products with half its weight bytes (no negated copies) and 96
// accumulator registers against 16.
template <int LOG2N>
__device__ __forceinline__ void stage1_wide(
    const uint16_t* iq, float2* z, const uint2* __restrict__ w1,
    const float4* __restrict__ twiddle, int warp, int lane) {
  using S = FastShape<LOG2N>;
  constexpr int N1 = S::N1, N2 = S::N2;
  const int g = lane >> 2, t = lane & 3;
  for (int item = warp; item < S::ITEMS; item += S::WARPS) {
    const int mt = item / (N1 / 16);
    const int ng = item % (N1 / 16);
    float acc[2][6][2][4] = {};   // [ar, ai][weight group][n-tile][e]
    for (int c = 0; c < N1 / 16; ++c) {
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g +
                      8 * (q & 1);
        const uint32_t v0 = iq[n], v1 = iq[n + N2];
        a[0][q] = pack2(__float2bfloat16_rn(dequant(v0 & 0xFFu)),
                        __float2bfloat16_rn(dequant(v1 & 0xFFu)));
        a[1][q] = pack2(__float2bfloat16_rn(dequant(v0 >> 8)),
                        __float2bfloat16_rn(dequant(v1 >> 8)));
      }
#pragma unroll
      for (int gr = 0; gr < 6; ++gr)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // One B fragment for both planes.
          const uint2 b =
              __ldg(w1 + ((c * 6 + gr) * (N1 / 8) + 2 * ng + j) * 32 + lane);
          mma_bf16(acc[0][gr][j], a[0], b);
          mma_bf16(acc[1][gr][j], a[1], b);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float yr[4], yi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float (&r)[6][2][4] = acc[0];
        const float (&i)[6][2][4] = acc[1];
        yr[e] = __fsub_rn(
            __fadd_rn(__fadd_rn(r[0][j][e], r[1][j][e]), r[2][j][e]),
            __fadd_rn(__fadd_rn(i[3][j][e], i[4][j][e]), i[5][j][e]));
        yi[e] = __fadd_rn(
            __fadd_rn(__fadd_rn(r[3][j][e], r[4][j][e]), r[5][j][e]),
            __fadd_rn(__fadd_rn(i[0][j][e], i[1][j][e]), i[2][j][e]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n2 = 16 * mt + g + 8 * h;
        const int k1 = 16 * ng + 8 * j + 2 * t;
        reinterpret_cast<float4*>(z)[(n2 * N1 + k1) / 2] =
            twiddled(yr[2 * h], yi[2 * h], yr[2 * h + 1], yi[2 * h + 1],
                     __ldg(twiddle + (n2 * N1 + k1) / 2));
      }
    }
  }
}

// Y of the frame loop's stage-1 item (mt, ng) as the Karatsuba of 3
// products (P3 dg3dall, profile_pallas.py:267-283): t1 = ar.w1r, t2 =
// ai.w1i, t3 = as.w1s over the 3 terms of each, 9 mma per (chunk,
// n-tile) against K3's 12, from w1: the 9 (N1, N1) planes w1r0..2,
// w1i0..2, w1s0..2 as B fragments (plane p = 3 g + j). With CAT (P4
// s1cat, 331-358): one product of [ar ar ar ai ai ai as as as] with the
// block-diagonal (9 N1, 3 N1) weights (w1: its B fragments), block (b, g)
// = term b % 3 of weight g where g == b / 3 and zero elsewhere; the zero
// blocks are multiplied (27 mma), and add exact zeros between P3's
// products, which come in P3's order per accumulator, so Y is P3's bit
// for bit. yr = t1 - t2, yi = (t3 - t1) - t2.
template <int LOG2N, bool CAT>
__device__ __forceinline__ void stage1_karatsuba(
    const uint16_t* iq, const uint2* __restrict__ w1, int mt, int ng,
    int lane, float (&yr)[2][4], float (&yi)[2][4]) {
  constexpr int N1 = FastShape<LOG2N>::N1;
  float tk[3][2][4] = {};   // t1, t2, t3
  for (int c = 0; c < N1 / 16; ++c) {
    uint32_t a[3][4];
    gather_k3<LOG2N, 3>(iq, c, mt, lane, a);
    if constexpr (CAT) {
#pragma unroll
      for (int b = 0; b < 9; ++b)
#pragma unroll
        for (int gw = 0; gw < 3; ++gw)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = ((b * (N1 / 16) + c) * (3 * N1 / 8) +
                             gw * (N1 / 8) + 2 * ng + j) * 32 + lane;
            mma_bf16(tk[gw][j], a[b / 3], __ldg(w1 + idx));
          }
    } else {
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int gw = 0; gw < 3; ++gw)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = (((3 * gw + term) * (N1 / 16) + c) * (N1 / 8) +
                             2 * ng + j) * 32 + lane;
            mma_bf16(tk[gw][j], a[gw], __ldg(w1 + idx));
          }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yr[j][e] = __fsub_rn(tk[0][j][e], tk[1][j][e]);
      yi[j][e] = __fsub_rn(__fsub_rn(tk[2][j][e], tk[0][j][e]), tk[1][j][e]);
    }
}

// Y of stage-1 item (mt, ng) as K3's K-stack in three chains (P7 s1k32,
// build_s1k(reps=1), profile_pallas.py:616-617, 641-645): chain j
// multiplies [ar ai] by K3's blocks 2j, 2j + 1 ([w1r_j; -w1i_j] into yr,
// [w1i_j; w1r_j] into yi), K = 2 N1, and Y = (chain 0 + chain 1) + chain
// 2: K3's products and weights with three times its accumulators.
template <int LOG2N>
__device__ __forceinline__ void stage1_split_k(
    const uint16_t* iq, const uint2* __restrict__ w1r,
    const uint2* __restrict__ w1i, int mt, int ng, int lane,
    float (&yr)[2][4], float (&yi)[2][4]) {
  constexpr int N1 = FastShape<LOG2N>::N1;
  float cr[3][2][4] = {}, ci[3][2][4] = {};
  for (int c = 0; c < N1 / 16; ++c) {
    uint32_t a[2][4];
    gather_k3<LOG2N, 2>(iq, c, mt, lane, a);
#pragma unroll
    for (int b = 0; b < 6; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx =
            ((b * (N1 / 16) + c) * (N1 / 8) + 2 * ng + j) * 32 + lane;
        mma_bf16(cr[b / 2][j], a[b & 1], __ldg(w1r + idx));
        mma_bf16(ci[b / 2][j], a[b & 1], __ldg(w1i + idx));
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yr[j][e] = __fadd_rn(__fadd_rn(cr[0][j][e], cr[1][j][e]), cr[2][j][e]);
      yi[j][e] = __fadd_rn(__fadd_rn(ci[0][j][e], ci[1][j][e]), ci[2][j][e]);
    }
}

// Block g transforms frames [g*group, min((g+1)*group, F, n_valid)) one
// after another and writes the f32 sum of their |X|^2 to partial row g
// (a cut variant: the sums its CUT names, see the top of this file).
template <int LOG2N, bool WINDOWED, class V = FastVariant<>>
__global__ void __launch_bounds__(FastShape<LOG2N>::THREADS)
psd_fast_group_kernel(const uint4* __restrict__ raw,       // (F, N/8) words
                      const float* __restrict__ window,    // (N,) or null;
                                                           // RAW_BYTES: cR, cI
                      const uint2* __restrict__ w1r,       // stage-1 B frags
                      const uint2* __restrict__ w1i,
                      const float4* __restrict__ twiddle,  // (N2, N1/2)
                      const uint2* __restrict__ w2,        // 6 (9) weight planes
                      float* __restrict__ partial,         // (G, N)
                      int F, int group, int n_valid) {
  using S = FastShape<LOG2N>;
  using P = Stage1<WINDOWED>;
  using M = FastSmem<LOG2N, WINDOWED, V>;
  constexpr int N = S::N, N1 = S::N1, N2 = S::N2;
  static_assert(!WINDOWED || (V::INPUT == kInRaw && V::S1_TERMS == 3),
                "a window only on K3's own input path");
  static_assert(!WINDOWED || (!V::RAW_BYTES && !V::SCHEDULED),
                "the window's pointer and staging");
  static_assert(V::CUT == kCutFull || V::CUT == kCutZStore ||
                    S::ITEMS_PER_WARP == 1,
                "register-held cut sums assume one stage-1 item per warp");
  // Stage-2 B fragment planes: w2r0, w2r1, w2i0, w2i1, w2s0, w2s1 (the
  // 6-product scheme: w2r0, w2r1, w2r2, w2i0, ..., w2s2).
  constexpr int W2_PLANE = (N2 / 16) * (N2 / 8) * 32;
  constexpr int TERMS2 = V::S2_PRODUCTS == 6 ? 3 : 2;
  extern __shared__ float4 smem[];
  float2* z = reinterpret_cast<float2*>(smem);              // (N2, N1)
  uint4* raw4 = reinterpret_cast<uint4*>(smem + M::IN);    // 2N bytes
  const uint16_t* iq = reinterpret_cast<const uint16_t*>(raw4);  // (N1, N2)
  float* win = reinterpret_cast<float*>(smem + M::WIN);   // (N,)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if constexpr (WINDOWED) {
    for (int i = tid; i < N; i += S::THREADS) win[i] = __ldg(window + i);
  }

  // |X|^2 of this warp's stage-2 items, in D-fragment order (the stage-1
  // and twiddle cuts: |Y|^2 or |Z|^2 of its stage-1 item).
  float acc[S::ITEMS_PER_WARP][2][4];
#pragma unroll
  for (int i = 0; i < S::ITEMS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // The Z-store cut: |Z|^2 of the float4 words tid + r*THREADS.
  constexpr int RB = V::CUT == kCutZStore ? N / (2 * S::THREADS) : 1;
  float accz[RB][2] = {};
  // The gather and dequantization cuts: the sum of what was gathered.
  float dq_sum = 0.0f;
  uint32_t gather_sum = 0;

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  if constexpr (V::PIPELINE) {
    // Frame i + 1 travels through registers while frames i and i - 1 run.
    constexpr int LOADS = N / 8 / S::THREADS;
    static_assert(LOADS * S::THREADS == N / 8, "whole frame words a thread");
    const int nf = f1 - f0;
    if (nf > 0) {
#pragma unroll
      for (int k = 0; k < LOADS; ++k)
        raw4[tid + k * S::THREADS] = __ldg(
            raw + static_cast<size_t>(f0) * (N / 8) + tid + k * S::THREADS);
    }
    __syncthreads();
    for (int i = 0; i <= nf && nf > 0; ++i) {
      const bool ahead = i + 1 < nf;
      uint4 next[LOADS];
      if (ahead) {
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
          next[k] = __ldg(raw + static_cast<size_t>(f0 + i + 1) * (N / 8) +
                          tid + k * S::THREADS);
      }
      if (i < nf)
        tpu6_stage1<LOG2N>(raw4 + (i & 1) * M::RAW4, z + (i & 1) * N, w1r,
                           w1i, twiddle, warp, lane);
      if (i > 0)
        tpu6_stage2<LOG2N, 1>(z + ((i - 1) & 1) * N, w2, acc, 1, warp, lane);
      if (ahead) {
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
          raw4[((i + 1) & 1) * M::RAW4 + tid + k * S::THREADS] = next[k];
      }
      __syncthreads();
    }
  } else if constexpr (V::CHAINS > 1) {
    for (int f = f0; f < f1; f += V::CHAINS) {
#pragma unroll
      for (int ch = 0; ch < V::CHAINS; ++ch)
        if (f + ch < f1) {
          const uint4* frame = raw + static_cast<size_t>(f + ch) * (N / 8);
          for (int i = tid; i < N / 8; i += S::THREADS)
            raw4[ch * M::RAW4 + i] = __ldg(frame + i);
        }
      __syncthreads();
#pragma unroll
      for (int ch = 0; ch < V::CHAINS; ++ch)
        tpu6_stage1<LOG2N>(raw4 + ch * M::RAW4, z + ch * N, w1r, w1i,
                           twiddle, warp, lane);
      __syncthreads();
      tpu6_stage2<LOG2N, V::CHAINS>(z, w2, acc, f1 - f, warp, lane);
      __syncthreads();
    }
  } else {
  for (int f = f0; f < f1; ++f) {
    const uint4* frame = raw + static_cast<size_t>(f) * (N / 8);
    if constexpr (V::INPUT == kInRaw || V::INPUT == kInLinear) {
      for (int i = tid; i < N / 8; i += S::THREADS) raw4[i] = __ldg(frame + i);
    } else if constexpr (V::INPUT == kInWide32) {
      for (int i = tid; i < N / 8; i += S::THREADS) {
        const uint4 v = __ldg(frame + i);
        raw4[2 * i] = make_uint4(v.x & 0xFFFFu, v.x >> 16, v.y & 0xFFFFu,
                                 v.y >> 16);
        raw4[2 * i + 1] = make_uint4(v.z & 0xFFFFu, v.z >> 16, v.w & 0xFFFFu,
                                     v.w >> 16);
      }
    } else if constexpr (V::INPUT == kInPair32) {
      // Word (p, n2) = x[N2*2p + n2] | x[N2*(2p + 1) + n2] << 16.
      for (int i = tid; i < N / 16; i += S::THREADS) {
        const int p = i / (N2 / 8), c8 = i % (N2 / 8);
        const uint4 a = __ldg(frame + 2 * p * (N2 / 8) + c8);
        const uint4 b = __ldg(frame + (2 * p + 1) * (N2 / 8) + c8);
        uint4* dst = raw4 + (p * N2 + 8 * c8) / 4;
        dst[0] = make_uint4(__byte_perm(a.x, b.x, 0x5410),
                            __byte_perm(a.x, b.x, 0x7632),
                            __byte_perm(a.y, b.y, 0x5410),
                            __byte_perm(a.y, b.y, 0x7632));
        dst[1] = make_uint4(__byte_perm(a.z, b.z, 0x5410),
                            __byte_perm(a.z, b.z, 0x7632),
                            __byte_perm(a.w, b.w, 0x5410),
                            __byte_perm(a.w, b.w, 0x7632));
      }
    } else {  // kInBf16: planes [n1][n2] of re and im, 8 elements a store
      __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(raw4);
      for (int i = tid; i < N / 8; i += S::THREADS) {
        const uint4 v = __ldg(frame + i);
        const int n1 = (8 * i) / N2, n2 = (8 * i) % N2;
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t re[4], im[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          re[k] = pack2(__float2bfloat16_rn(dequant(w[k] & 0xFFu)),
                        __float2bfloat16_rn(dequant((w[k] >> 16) & 0xFFu)));
          im[k] = pack2(__float2bfloat16_rn(dequant((w[k] >> 8) & 0xFFu)),
                        __float2bfloat16_rn(dequant(w[k] >> 24)));
        }
        *reinterpret_cast<uint4*>(planes + n1 * M::ROW + n2) =
            make_uint4(re[0], re[1], re[2], re[3]);
        *reinterpret_cast<uint4*>(planes + (N1 + n1) * M::ROW + n2) =
            make_uint4(im[0], im[1], im[2], im[3]);
      }
    }
    __syncthreads();   // also orders the window copy before its first use

    if constexpr (V::S1_FORM == kS1Packed || V::S1_FORM == kS1PackedPQ) {
      stage1_packed<LOG2N, V::S1_FORM == kS1PackedPQ>(iq, z, w1r, w1i,
                                                      twiddle, warp, lane);
    } else if constexpr (V::S1_FORM == kS1Wide) {
      stage1_wide<LOG2N>(iq, z, w1r, twiddle, warp, lane);
    } else {
    // Stage 1 and twiddle: item = (16 rows n2) x (16 columns k1).
    for (int item = warp; item < S::ITEMS; item += S::WARPS) {
      const int mt = item / (N1 / 16);
      const int ng = item % (N1 / 16);
      float yr[2][4] = {}, yi[2][4] = {};
      if constexpr (V::S1_TERMS == 0) {
        // No products: Y[n2][k1] = x[N2*k1 + n2] at the D positions.
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n2 = 16 * mt + g + 8 * (e >> 1);
            const int n1 = 16 * ng + 8 * j + 2 * t + (e & 1);
            const uint32_t v = iq[N2 * n1 + n2];
            yr[j][e] = dequant(v & 0xFFu);
            yi[j][e] = dequant(v >> 8);
          }
      } else if constexpr (V::S1_FORM == kS1Karatsuba ||
                           V::S1_FORM == kS1KaratsubaCat) {
        stage1_karatsuba<LOG2N, V::S1_FORM == kS1KaratsubaCat>(
            iq, w1r, mt, ng, lane, yr, yi);
      } else if constexpr (V::S1_FORM == kS1SplitK) {
        stage1_split_k<LOG2N>(iq, w1r, w1i, mt, ng, lane, yr, yi);
      } else {
      for (int c = 0; c < N1 / 16; ++c) {
        uint32_t a[P::PLANES][4];
        if constexpr (V::INPUT == kInBf16) {
          // Matrix m = lane >> 3 of the fragment: rows n1 = 16c +
          // 8(m >> 1) + (lane & 7), columns n2 from 16mt + 8(m & 1).
          const int m = lane >> 3;
          const int n1 = 16 * c + 8 * (m >> 1) + (lane & 7);
          const uint32_t at = shared_addr(reinterpret_cast<const __nv_bfloat16*>(
                                  raw4) + n1 * M::ROW + 16 * mt + 8 * (m & 1));
          ldmatrix_x4_trans(a[0], at);
          ldmatrix_x4_trans(a[1], at + 2 * N1 * M::ROW);
        } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (V::INPUT == kInPair32 && V::RAW_BYTES) {
            // P17 u32t: the pair word of n1, n1 + 1 (n1 even) of row n2;
            // bytes 0 and 2 are the re plane's register, 1 and 3 the im's.
            const uint32_t w = reinterpret_cast<const uint32_t*>(raw4)[
                (8 * c + t + 4 * (q >> 1)) * N2 + 16 * mt + g + 8 * (q & 1)];
            a[0][q] = bf16_byte_pair(__byte_perm(w, 0u, 0x4240));
            a[1][q] = bf16_byte_pair(__byte_perm(w, 0u, 0x4341));
          } else {
          // A[row n2][col n1] = x[N2*n1 + n2]; the pair is n1, n1 + 1.
          const int n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g +
                        8 * (q & 1);
          uint32_t v0, v1;
          if constexpr (V::INPUT == kInPair32) {
            // The pair n1, n1 + 1 (n1 even) of row n2 in one word.
            const uint32_t w = reinterpret_cast<const uint32_t*>(raw4)[
                (8 * c + t + 4 * (q >> 1)) * N2 + 16 * mt + g + 8 * (q & 1)];
            v0 = w & 0xFFFFu;
            v1 = w >> 16;
          } else if constexpr (V::INPUT == kInLinear) {
            const int l = (((mt * (N1 / 16) + c) * 4 + q) * 32 + lane) * 2;
            v0 = iq[l];
            v1 = iq[l + 1];
          } else if constexpr (V::INPUT == kInWide32) {
            const uint32_t* iq32 = reinterpret_cast<const uint32_t*>(raw4);
            v0 = iq32[n];
            v1 = iq32[n + N2];
          } else {
          v0 = iq[n], v1 = iq[n + N2];
          }
          if constexpr (V::CUT == kCutGather) {
            gather_sum += v0 + v1;
          } else {
          const float r0 = stage1_value<V::RAW_BYTES>(v0 & 0xFFu),
                      i0 = stage1_value<V::RAW_BYTES>(v0 >> 8);
          const float r1 = stage1_value<V::RAW_BYTES>(v1 & 0xFFu),
                      i1 = stage1_value<V::RAW_BYTES>(v1 >> 8);
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
          }
        }
        }
        if constexpr (V::CUT == kCutDequant) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dq_sum = __fadd_rn(dq_sum, __fadd_rn(bf16_pair_sum(a[0][q]),
                                                 bf16_pair_sum(a[1][q])));
        } else if constexpr (V::CUT != kCutGather) {
#pragma unroll
        for (int b = 0; b < (WINDOWED ? P::BLOCKS : 2 * V::S1_TERMS); ++b) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx =
                ((b * (N1 / 16) + c) * (N1 / 8) + 2 * ng + j) * 32 + lane;
            mma_bf16(yr[j], a[P::plane(b)], __ldg(w1r + idx));
            mma_bf16(yi[j], a[P::plane(b)], __ldg(w1i + idx));
          }
        }
        }
      }
      }
      if constexpr (V::RAW_BYTES) {
        // The -127 offset's image: Y -= (cR, cI)[k1].
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k1 = 16 * ng + 8 * j + 2 * t + (e & 1);
            yr[j][e] = __fsub_rn(yr[j][e], __ldg(window + k1));
            yi[j][e] = __fsub_rn(yi[j][e], __ldg(window + N1 + k1));
          }
      }
      if constexpr (V::CUT != kCutGather && V::CUT != kCutDequant) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n2 = 16 * mt + g + 8 * h;
          const int k1 = 16 * ng + 8 * j + 2 * t;       // even: k1, k1 + 1
          const float ar = yr[j][2 * h], ai = yi[j][2 * h];
          const float br = yr[j][2 * h + 1], bi = yi[j][2 * h + 1];
          if constexpr (V::CUT == kCutStage1) {
            acc[0][j][2 * h] = add_norm(acc[0][j][2 * h], ar, ai);
            acc[0][j][2 * h + 1] = add_norm(acc[0][j][2 * h + 1], br, bi);
          } else {
          float4 o;
          if constexpr (V::TWIDDLE) {
          const float4 tw = __ldg(twiddle + (n2 * N1 + k1) / 2);
          o.x = __fsub_rn(__fmul_rn(ar, tw.x), __fmul_rn(ai, tw.y));
          o.y = __fadd_rn(__fmul_rn(ar, tw.y), __fmul_rn(ai, tw.x));
          o.z = __fsub_rn(__fmul_rn(br, tw.z), __fmul_rn(bi, tw.w));
          o.w = __fadd_rn(__fmul_rn(br, tw.w), __fmul_rn(bi, tw.z));
          } else {
            o = make_float4(ar, ai, br, bi);
          }
          if constexpr (V::CUT == kCutTwiddle) {
            acc[0][j][2 * h] = add_norm(acc[0][j][2 * h], o.x, o.y);
            acc[0][j][2 * h + 1] = add_norm(acc[0][j][2 * h + 1], o.z, o.w);
          } else if constexpr (V::S2_SOURCE == kS2FromPlanes) {
            // Planes zr0.., zi0.., zs0.. (TERMS2 each: zr0, zr1, zi0, ...,
            // or the 3-term splits tpu6's stage 2 takes of the same f32
            // values), each [k1][n2].
            __nv_bfloat16* zp = reinterpret_cast<__nv_bfloat16*>(smem + M::ZP);
            const float zr[2] = {o.x, o.z}, zi[2] = {o.y, o.w};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              __nv_bfloat16 r[TERMS2], i[TERMS2], s[TERMS2];
              split_terms<TERMS2>(zr[u], r);
              split_terms<TERMS2>(zi[u], i);
              split_terms<TERMS2>(__fadd_rn(zr[u], zi[u]), s);
              const int at = (k1 + u) * M::ROW + n2;
#pragma unroll
              for (int e = 0; e < TERMS2; ++e) {
                zp[e * M::ZP_PLANE + at] = r[e];
                zp[(TERMS2 + e) * M::ZP_PLANE + at] = i[e];
                zp[(2 * TERMS2 + e) * M::ZP_PLANE + at] = s[e];
              }
            }
          } else {
          reinterpret_cast<float4*>(z)[(n2 * N1 + k1) / 2] = o;
          }
          }
        }
      }
      }
    }
    }
    __syncthreads();

    if constexpr (V::CUT == kCutZStore) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 v = reinterpret_cast<const float4*>(z)[tid + r * S::THREADS];
        accz[r][0] = add_norm(accz[r][0], v.x, v.y);
        accz[r][1] = add_norm(accz[r][1], v.z, v.w);
      }
    } else if constexpr (V::CUT == kCutFull && V::S2_FORM == kS2Left) {
      stage2_left<LOG2N, V::S2_PRODUCTS>(
          z, reinterpret_cast<const uint4*>(w2), acc, warp, lane);
    } else if constexpr (V::CUT == kCutFull && V::S2_FORM == kS2KStacked) {
      stage2_kstacked<LOG2N, M::ROW>(
          reinterpret_cast<const __nv_bfloat16*>(smem + M::ZP), w2, acc, warp,
          lane);
    } else if constexpr (V::CUT == kCutFull) {
    // Stage 2: item = (16 rows k1) x (16 columns k2), the same items in
    // every frame.
#pragma unroll
    for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
      const int item = warp + i * S::WARPS;
      const int mt = item / (N2 / 16);
      const int ng = item % (N2 / 16);
      float u1[2][4] = {}, u2[2][4] = {}, u3[2][4] = {};
      for (int c = 0; c < N2 / 16; ++c) {
        uint32_t a[3 * TERMS2][4];   // zr0, zr1, zi0, zi1, zs0, zs1
        if constexpr (V::S2_SOURCE == kS2FromPlanes) {
          // Matrix m = lane >> 3: rows k1 = 16mt + 8(m & 1) + (lane & 7),
          // columns n2 from 16c + 8(m >> 1).
          const int m = lane >> 3;
          const uint32_t at = shared_addr(
              reinterpret_cast<const __nv_bfloat16*>(smem + M::ZP) +
              (16 * mt + 8 * (m & 1) + (lane & 7)) * M::ROW + 16 * c +
              8 * (m >> 1));
#pragma unroll
          for (int e = 0; e < 3 * TERMS2; ++e)
            ldmatrix_x4(a[e], at + 2 * e * M::ZP_PLANE);
        } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // A[row k1][col n2] = Z[n2][k1]; the pair is n2, n2 + 1.
          const int k1 = 16 * mt + g + 8 * (q & 1);
          const int n2 = 16 * c + 2 * t + 8 * (q >> 1);
          const float2 p0 = z[n2 * N1 + k1], p1 = z[(n2 + 1) * N1 + k1];
          if constexpr (TERMS2 == 2) {
          __nv_bfloat16 r0[2], r1[2], i0[2], i1[2], s0[2], s1[2];
          split2(p0.x, r0);
          split2(p1.x, r1);
          split2(p0.y, i0);
          split2(p1.y, i1);
          if constexpr (V::S2_FORM == kS2FourMult) {
            // No zs: planes z0r, z1r, z0i, z1i.
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              a[e][q] = pack2(r0[e], r1[e]);
              a[2 + e][q] = pack2(i0[e], i1[e]);
            }
          } else {
          split2(__fadd_rn(p0.x, p0.y), s0);
          split2(__fadd_rn(p1.x, p1.y), s1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            a[e][q] = pack2(r0[e], r1[e]);
            a[2 + e][q] = pack2(i0[e], i1[e]);
            a[4 + e][q] = pack2(s0[e], s1[e]);
          }
          }
          } else {
            __nv_bfloat16 r0[3], r1[3], i0[3], i1[3], s0[3], s1[3];
            split3(p0.x, r0);
            split3(p1.x, r1);
            split3(p0.y, i0);
            split3(p1.y, i1);
            if constexpr (V::S2_FORM == kS2FourMult) {
              // No zs: planes zr0..2, zi0..2.
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                a[e][q] = pack2(r0[e], r1[e]);
                a[3 + e][q] = pack2(i0[e], i1[e]);
              }
            } else {
            split3(__fadd_rn(p0.x, p0.y), s0);
            split3(__fadd_rn(p1.x, p1.y), s1);
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              a[e][q] = pack2(r0[e], r1[e]);
              a[3 + e][q] = pack2(i0[e], i1[e]);
              a[6 + e][q] = pack2(s0[e], s1[e]);
            }
            }
          }
        }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2* b = w2 + (c * (N2 / 8) + 2 * ng + j) * 32 + lane;
          if constexpr (V::S2_FORM == kS2FourMult && TERMS2 == 2) {
            // P8 best (profile_pallas.py:718-721, 743-749): lhs [z0r z0r
            // z1r z0i z0i z1i] against [r0 r1 r0 -i0 -i1 -i0] into u1
            // (xr) and [i0 i1 i0 r0 r1 r0] into u2 (xi), in that order;
            // K3's planes r0, r1, i0, i1 each read once, -i as the bf16
            // sign bits of z0i, z1i.
            const uint2 r0 = __ldg(b), r1 = __ldg(b + W2_PLANE);
            const uint2 i0 = __ldg(b + 2 * W2_PLANE),
                        i1 = __ldg(b + 3 * W2_PLANE);
            uint32_t n[2][4];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int q = 0; q < 4; ++q) n[e][q] = a[2 + e][q] ^ 0x80008000u;
            mma_bf16(u1[j], a[0], r0);
            mma_bf16(u1[j], a[0], r1);
            mma_bf16(u1[j], a[1], r0);
            mma_bf16(u1[j], n[0], i0);
            mma_bf16(u1[j], n[0], i1);
            mma_bf16(u1[j], n[1], i0);
            mma_bf16(u2[j], a[0], i0);
            mma_bf16(u2[j], a[0], i1);
            mma_bf16(u2[j], a[1], i0);
            mma_bf16(u2[j], a[2], r0);
            mma_bf16(u2[j], a[2], r1);
            mma_bf16(u2[j], a[3], r0);
          } else if constexpr (V::S2_PRODUCTS == 3) {
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
          } else if constexpr (V::S2_PRODUCTS == 1) {
            mma_bf16(u1[j], a[0], __ldg(b));
            mma_bf16(u2[j], a[TERMS2], __ldg(b + TERMS2 * W2_PLANE));
            mma_bf16(u3[j], a[2 * TERMS2], __ldg(b + 2 * TERMS2 * W2_PLANE));
          } else if constexpr (V::S2_FORM == kS2FourMult) {
            // xr = zr.r + (-zi).i in u1, xi = zr.i + zi.r in u2
            // (s2_fourmult.py:59-60 negates the weights; here the bf16
            // sign bits of zi), each of the 6 weight planes read once.
            uint2 r[3], im[3];
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              r[e] = __ldg(b + e * W2_PLANE);
              im[e] = __ldg(b + (3 + e) * W2_PLANE);
            }
            uint32_t n[3][4];
#pragma unroll
            for (int e = 0; e < 3; ++e)
#pragma unroll
              for (int q = 0; q < 4; ++q) n[e][q] = a[3 + e][q] ^ 0x80008000u;
            six_products_loaded(u1[j], a[0], a[1], a[2], r);
            six_products_loaded(u1[j], n[0], n[1], n[2], im);
            six_products_loaded(u2[j], a[0], a[1], a[2], im);
            six_products_loaded(u2[j], a[3], a[4], a[5], r);
          } else {
            six_products<W2_PLANE>(u1[j], a[0], a[1], a[2], b);
            six_products<W2_PLANE>(u2[j], a[3], a[4], a[5], b + 3 * W2_PLANE);
            six_products<W2_PLANE>(u3[j], a[6], a[7], a[8], b + 6 * W2_PLANE);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (V::S2_FORM == kS2FourMult) {
            acc[i][j][e] = add_norm(acc[i][j][e], u1[j][e], u2[j][e]);
          } else {
          const float xr = __fsub_rn(u1[j][e], u2[j][e]);
          const float xi = __fsub_rn(__fsub_rn(u3[j][e], u1[j][e]), u2[j][e]);
          acc[i][j][e] = __fadd_rn(
              acc[i][j][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
          }
        }
      }
    }
    }
    __syncthreads();   // the next frame's stage 1 overwrites z
  }
  }

  float* row = partial + static_cast<size_t>(blockIdx.x) * N;
  if constexpr (V::CUT == kCutFull && V::S2_FORM == kS2Left) {
#pragma unroll
    for (int i = 0; i < S::ITEMS_PER_WARP; ++i) {
      const int item = warp + i * S::WARPS;
      const int kh = item / (N1 / 8);
      const int k1 = 8 * (item % (N1 / 8)) + 2 * t;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k2 = 32 * kh + 16 * m + g + 8 * h;
          *reinterpret_cast<float2*>(row + k1 + N1 * k2) =
              make_float2(acc[i][m][2 * h], acc[i][m][2 * h + 1]);
        }
    }
  } else if constexpr (V::CUT == kCutFull) {
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
  } else if constexpr (V::CUT == kCutStage1 || V::CUT == kCutTwiddle) {
    // The warp's one stage-1 item, in (n2, k1) order.
    const int mt = warp / (N1 / 16);
    const int ng = warp % (N1 / 16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[(16 * mt + g + 8 * (e >> 1)) * N1 + 16 * ng + 8 * j + 2 * t +
            (e & 1)] = acc[0][j][e];
  } else if constexpr (V::CUT == kCutZStore) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      reinterpret_cast<float2*>(row)[tid + r * S::THREADS] =
          make_float2(accz[r][0], accz[r][1]);
  } else {
    // The block's sum of what it gathered, in float64, in every bin.
    double s = V::CUT == kCutGather ? static_cast<double>(gather_sum)
                                    : static_cast<double>(dq_sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    double* warp_sum = reinterpret_cast<double*>(smem);
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    double total = 0.0;
    for (int w = 0; w < S::WARPS; ++w) total += warp_sum[w];
    for (int k = tid; k < N; k += S::THREADS) row[k] = static_cast<float>(total);
  }
}

}  // namespace
