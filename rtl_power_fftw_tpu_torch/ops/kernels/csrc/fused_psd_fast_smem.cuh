// K3's group kernel for Hopper (fused_psd_fast.cu, --precision high):
// the weights resident in shared memory, Z staged once as bf16 split
// planes, the next frame in flight, about one resident wave of blocks.
//
// psd_smem_kernel<LOG2N, WINDOWED> computes what psd_fast_group_kernel
// (fused_psd_fast.cuh, kept as the control) computes, with the same split
// terms, the same bf16 products and, per frame, the same f32 sums in the
// same order: stage 1 multiplies the dequantized frame (or the 3-term
// split of the windowed frame) by the K-stacked WR and WI, chunk by chunk
// and block by block; the twiddle is applied in f32; stage 2 is the
// Karatsuba of three real products, each z0c0 + z0c1 + z1c0 of the 2-term
// splits. So a frame's |X|^2 is the control's bit for bit, and only the
// frames a block sums (and so the partial rows) differ.
//
// What it changes, against what held the control back:
//  * the weights: the control reads every B fragment from L1/L2 once per
//    warp, per frame and per mma (~200 KB a frame at N = 2048). Stage 1
//    needs only six distinct tiles a chunk, [r0; -i0; r1; -i1; r2; -i2]:
//    WI's K-stack blocks are WR's with a pair swapped and one sign
//    flipped (i_j = -(-i_j), r_j), and the windowed stack repeats terms
//    (c0 c1 c2 c0 c1 c0), so a warp loads 6 tiles a chunk where the
//    control loads 12 (24 windowed), and flips the bf16 sign bits in
//    registers (exact). Here a
//    block copies the stage weights it keeps (kSmemPlan) into shared
//    memory once, by bulk copies counted on an mbarrier, in the register-
//    major fragment order (fused_psd_fast.pack_b_ldmatrix: a tile is the
//    32 lanes' first B register, then their second), so that one
//    ldmatrix.x4 gives a lane the B fragments of two adjacent n-tiles and
//    each 8x8 matrix is 128 contiguous bytes (no bank conflict). A stage
//    whose weights do not fit beside the frame (the table's zeros) reads
//    the same order from device memory with four coalesced 4-byte loads;
//    the twiddle is read from device memory (float4, as the control);
//  * Z: stage 1 writes the 2-term splits of zr, zi and zs = zr + zi
//    once, as six bf16 planes [n2][k1] (zr0, zr1, zi0, zi1, zs0, zs1),
//    one 32-bit store per (k1, k1 + 1) pair; stage 2 loads its A fragments
//    with ldmatrix.trans and splits nothing. A plane row is N1 / ZP bf16
//    (no padding); its 16-byte chunks are XOR-swizzled by the row
//    (z_chunk), so that the 8 rows an ldmatrix matrix or a store reads or
//    writes fall on 8 different 16-byte bank groups;
//  * the next frame: cp.async copies frame i + 1's raw 2N bytes, 16 B a
//    thread, into the other slot of a two-slot ring while frame i is
//    computed (the pattern of fused_psd_regs.cuh); the window is copied
//    into shared memory once a block. Both keep the frame's rows n1 (N2
//    samples) 16 bytes apart more than their length, so that the stage-1
//    gather, whose lanes read rows 2t, 2t + 2, ... is free of bank
//    conflicts (the control's gather is 4-way conflicted);
//  * the grid: the wrapper gives each block the least divisor of the
//    chunk as its frames such that the grid fits the blocks the card holds
//    resident (fused_psd.k1_group with this kernel's occupancy), so the
//    weights are fetched once per block of several frames and the row sum
//    reads about one wave of partial rows;
//  * Z passes: at N = 16384 the six planes of a whole frame (192 KB) do
//    not fit beside the ring, so Z is built and consumed in ZP passes of
//    N1 / ZP k1 columns each (stage 1 of pass p writes k1 in
//    [p N1/ZP, (p+1) N1/ZP), stage 2 of pass p reads those rows k1): two,
//    or four beside the window.
//
// Items: as the control's, 16 x 16 outputs (two m16n8 tiles) a warp and
// a stage; a pass has ITEMS / ZP of them, IPW a warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_psd_fast.cuh"

namespace {

// By log2 N from 8: {warps a block, stage-1 weights resident, stage-2
// weights resident, Z passes}, unwindowed then windowed. Two blocks of 8
// warps an SM up to 2048 bins (where the frame's state and the resident
// weights fit 113 KB), one block of 16 warps above; from 1024 bins a
// stage's weights are resident where they fit beside the frame's Z
// planes, ring and window. Below, a block of one or two warps sums so few
// frames that copying its weights costs more than reading them from L1.
// Kept in step with fused_psd_fast.SMEM_PLAN.
constexpr int kSmemPlan[7][2][4] = {
    {{1, 0, 0, 1}, {1, 0, 0, 1}},      // 256
    {{2, 0, 0, 1}, {2, 0, 0, 1}},      // 512
    {{4, 1, 1, 1}, {4, 1, 1, 1}},      // 1024
    {{8, 1, 1, 1}, {8, 1, 1, 1}},      // 2048
    {{16, 1, 1, 1}, {16, 1, 1, 1}},    // 4096
    {{16, 1, 0, 1}, {16, 1, 0, 1}},    // 8192
    {{16, 0, 0, 2}, {16, 0, 0, 4}},    // 16384
};

// Where a cut of the kernel stops (its stage split, timed by
// chip_smoke.py): the whole step; the frame's copies and the stage-1
// gather into A fragments (their bf16 values summed, so that nothing is
// dropped); or stage 1, the twiddle and Z's planes (a word of Z read back
// a thread and frame). A cut writes those sums, not a spectrum.
enum : int { kK3Full = 0, kK3CutGather = 1, kK3CutStage1 = 2 };

// Dynamic shared memory a block may use on an H100 (227 KB).
constexpr int kMaxBlockSmem = 232448;

template <int LOG2N, bool WINDOWED>
struct SmemK3 {
  using S = FastShape<LOG2N>;
  static constexpr int N = S::N, N1 = S::N1, N2 = S::N2;
  static constexpr int ITEMS = S::ITEMS;
  static constexpr int WARPS = kSmemPlan[LOG2N - 8][WINDOWED][0];
  static constexpr int THREADS = 32 * WARPS;
  // 128 registers a thread at most: 512 threads an SM's register file.
  static constexpr int MIN_BLOCKS = 512 / THREADS;
  static constexpr bool S1_RES = kSmemPlan[LOG2N - 8][WINDOWED][1] != 0;
  static constexpr bool S2_RES = kSmemPlan[LOG2N - 8][WINDOWED][2] != 0;
  static constexpr int ZP = kSmemPlan[LOG2N - 8][WINDOWED][3];
  static constexpr int N1Z = N1 / ZP;        // k1 columns of a Z pass
  static constexpr int IPP = ITEMS / ZP;     // items of a stage a pass
  static constexpr int IPW = IPP / WARPS;    // of them a warp's
  static constexpr int ROW_CHUNKS = N1Z / 8; // 16-byte chunks a Z row
  // The stage-1 weights, [r0; -i0; r1; -i1; r2; -i2] (6 N1 x N1: the
  // unwindowed WR), and one stage-2 plane, bytes.
  static constexpr int W1_BYTES = 6 * N1 * N1 * 2;
  static constexpr int W2_BYTES = N2 * N2 * 2;
  static constexpr int ZPLANE = N2 * N1Z;    // bf16 elements a Z plane
  // A raw frame in the ring: row n1 of N2 u16 samples at n1 * RING_ROW
  // bytes, 16 bytes of padding a row, so that the stage-1 gather's lanes
  // (rows 2t apart) fall on different banks. The window likewise: row n1
  // of N2 floats at n1 * WIN_ROW floats.
  static constexpr int RING_ROW = 2 * N2 + 16;
  static constexpr int SLOT = N1 * RING_ROW;
  static constexpr int WIN_ROW = N2 + 4;
  static constexpr int COPIES = 2 * N / 16 / THREADS;  // cp.async a thread
  // Offsets in bytes: [W1 | six stage-2 planes | Z planes | ring |
  // window | mbarrier], each part present only where used.
  static constexpr int OFF_W1 = 0;
  static constexpr int OFF_W2 = OFF_W1 + (S1_RES ? W1_BYTES : 0);
  static constexpr int OFF_Z = OFF_W2 + (S2_RES ? 6 * W2_BYTES : 0);
  static constexpr int OFF_RING = OFF_Z + 6 * ZPLANE * 2;
  static constexpr int OFF_WIN = OFF_RING + 2 * SLOT;
  static constexpr int OFF_BAR = OFF_WIN + (WINDOWED ? 4 * N1 * WIN_ROW : 0);
  static constexpr int BYTES = OFF_BAR + 16;
  static constexpr int RESIDENT_BYTES = OFF_Z - OFF_W1;

  static_assert(IPP % WARPS == 0 && IPW >= 1, "whole items a warp");
  static_assert(N1Z % 16 == 0, "a Z pass holds whole k1 tiles");
  static_assert(COPIES * 16 * THREADS == 2 * N, "whole 16-byte copies");
  static_assert(BYTES <= kMaxBlockSmem, "fits a block's shared memory");
};

// The 16-byte chunk of Z-plane row n2 that holds k1 chunk c (k1 / 8): c
// XOR a function of the row, such that 8 consecutive rows land on 8
// different 16-byte bank groups for rows of 2, 4 or >= 8 chunks (32, 64,
// >= 128 bytes).
template <int ROW_CHUNKS>
__device__ __forceinline__ int z_chunk(int n2, int c) {
  constexpr int SHIFT = ROW_CHUNKS >= 8 ? 0 : ROW_CHUNKS == 4 ? 1 : 2;
  constexpr int MASK = (ROW_CHUNKS >= 8 ? 8 : ROW_CHUNKS) - 1;
  return c ^ ((n2 >> SHIFT) & MASK);
}

// bf16 element offset of (n2, k1 of the pass) in a Z plane.
template <int LOG2N, bool WINDOWED>
__device__ __forceinline__ int z_offset(int n2, int k1) {
  using K = SmemK3<LOG2N, WINDOWED>;
  return n2 * K::N1Z + z_chunk<K::ROW_CHUNKS>(n2, k1 >> 3) * 8 + (k1 & 7);
}

__device__ __forceinline__ void k3_cp_async16(void* smem_dst,
                                              const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void k3_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void k3_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void k3_mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void k3_mbarrier_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void k3_mbarrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "K3WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra K3WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device to
// shared memory by the copy engine, in pieces of at most 32 KB, counted
// on `bar`.
__device__ __forceinline__ void k3_bulk_copy(void* dst, const void* src,
                                             int bytes, uint64_t* bar) {
  for (int o = 0; o < bytes; o += 32768) {
    const int n = bytes - o < 32768 ? bytes - o : 32768;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(
            static_cast<char*>(dst) + o)),
        "l"(static_cast<const char*>(src) + o), "r"(n),
        "r"(shared_addr(bar))
        : "memory");
  }
}

// The weight term of stage-1 K-stack pair m (blocks 2m, 2m + 1): c0 c1
// c2, windowed c0 c1 c2 c0 c1 c0 (fused_psd_fast.constants).
__device__ __forceinline__ constexpr int stage1_term(int m) {
  return m < 3 ? m : (m == 4 ? 1 : 0);
}

// The B fragments of two adjacent n-tiles from their register-major words
// (x of tile 0 for the 32 lanes, y of tile 0, x of tile 1, y of tile 1):
// w[0], w[1] tile 0's b.x, b.y; w[2], w[3] tile 1's. From shared memory
// by one ldmatrix.x4 (lane l gives row l & 7 of matrix l >> 3, 16 bytes;
// lane i receives bytes 4i.. of each matrix), else by four coalesced
// loads.
template <bool SMEM>
__device__ __forceinline__ void load_b_pair(uint32_t (&w)[4],
                                            const uint32_t* tiles,
                                            int lane) {
  if constexpr (SMEM) {
    ldmatrix_x4(w, shared_addr(tiles) + (lane >> 3) * 128 + (lane & 7) * 16);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = __ldg(tiles + 32 * r + lane);
  }
}

// Stage 1 and the twiddle of one pass for a warp's items: item q of the
// pass = (16 rows n2: tile mt) x (16 columns k1: tile ng of the pass's
// columns); Z's 2-term split planes stored at zp.
template <int LOG2N, bool WINDOWED, int CUT>
__device__ __forceinline__ void smem_stage1(const uint16_t* iq,
                                            const float* win,
                                            const uint32_t* w1,
                                            const float4* __restrict__ twiddle,
                                            uint32_t* zp, int pass, int warp,
                                            int lane, float& sink) {
  using K = SmemK3<LOG2N, WINDOWED>;
  using P = Stage1<WINDOWED>;
  constexpr int N1 = K::N1, N2 = K::N2;
  constexpr int TILES1 = K::N1Z / 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int q = warp; q < K::IPP; q += K::WARPS) {
    const int mt = q / TILES1;
    const int ng = pass * TILES1 + q % TILES1;
    float yr[2][4] = {}, yi[2][4] = {};
#pragma unroll
    for (int c = 0; c < N1 / 16; ++c) {
      uint32_t a[P::PLANES][4];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        // A[row n2][col n1] = x[N2*n1 + n2]; the pair is n1, n1 + 1.
        const int n1 = 16 * c + 2 * t + 8 * (qq >> 1);
        const int n2 = 16 * mt + g + 8 * (qq & 1);
        const int n = n1 * (K::RING_ROW / 2) + n2;
        const uint32_t v0 = iq[n], v1 = iq[n + K::RING_ROW / 2];
        const float r0 = dequant(v0 & 0xFFu), i0 = dequant(v0 >> 8);
        const float r1 = dequant(v1 & 0xFFu), i1 = dequant(v1 >> 8);
        if constexpr (!WINDOWED) {
          a[0][qq] = pack2(__float2bfloat16_rn(r0), __float2bfloat16_rn(r1));
          a[1][qq] = pack2(__float2bfloat16_rn(i0), __float2bfloat16_rn(i1));
        } else {
          const int wn = n1 * K::WIN_ROW + n2;
          const float c0 = win[wn], c1 = win[wn + K::WIN_ROW];
          __nv_bfloat16 sr0[3], sr1[3], si0[3], si1[3];
          split3(__fmul_rn(r0, c0), sr0);
          split3(__fmul_rn(r1, c1), sr1);
          split3(__fmul_rn(i0, c0), si0);
          split3(__fmul_rn(i1, c1), si1);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            a[2 * p][qq] = pack2(sr0[p], sr1[p]);
            a[2 * p + 1][qq] = pack2(si0[p], si1[p]);
          }
        }
      }
      if constexpr (CUT == kK3CutGather) {
#pragma unroll
        for (int pl = 0; pl < P::PLANES; ++pl)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            sink = __fadd_rn(sink, bf16_pair_sum(a[pl][qq]));
        continue;
      }
      // The six distinct B tiles of chunk c: w[2j] = r_j, w[2j + 1] =
      // -i_j (tiles (kc, 2ng) and (kc, 2ng + 1), 64 words each).
      uint32_t w[6][4];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        load_b_pair<K::S1_RES>(
            w[k], w1 + ((k * (N1 / 16) + c) * (N1 / 8) + 2 * ng) * 64, lane);
#pragma unroll
      for (int b = 0; b < P::BLOCKS; ++b) {
        // K-stack block b = 2m + s holds weight term j = term(m): WR's
        // block is w[2j + s]; WI's is i_j = -(-i_j) (s = 0) or r_j (s = 1).
        const int j = stage1_term(b >> 1);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t* r = w[2 * j + (b & 1)];
          const uint32_t* i = w[2 * j + 1 - (b & 1)];
          const uint32_t flip = (b & 1) ? 0u : 0x80008000u;
          mma_bf16(yr[n], a[P::plane(b)], make_uint2(r[2 * n], r[2 * n + 1]));
          mma_bf16(yi[n], a[P::plane(b)],
                   make_uint2(i[2 * n] ^ flip, i[2 * n + 1] ^ flip));
        }
      }
    }
    if constexpr (CUT == kK3CutGather) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n2 = 16 * mt + g + 8 * h;
        const int k1 = 16 * ng + 8 * j + 2 * t;       // even: k1, k1 + 1
        const float ar = yr[j][2 * h], ai = yi[j][2 * h];
        const float br = yr[j][2 * h + 1], bi = yi[j][2 * h + 1];
        const float4 tw = __ldg(twiddle + (n2 * N1 + k1) / 2);
        const float zr0 = __fsub_rn(__fmul_rn(ar, tw.x), __fmul_rn(ai, tw.y));
        const float zi0 = __fadd_rn(__fmul_rn(ar, tw.y), __fmul_rn(ai, tw.x));
        const float zr1 = __fsub_rn(__fmul_rn(br, tw.z), __fmul_rn(bi, tw.w));
        const float zi1 = __fadd_rn(__fmul_rn(br, tw.w), __fmul_rn(bi, tw.z));
        __nv_bfloat16 r[2][2], im[2][2], s[2][2];
        split2(zr0, r[0]);
        split2(zr1, r[1]);
        split2(zi0, im[0]);
        split2(zi1, im[1]);
        split2(__fadd_rn(zr0, zi0), s[0]);
        split2(__fadd_rn(zr1, zi1), s[1]);
        const int at = z_offset<LOG2N, WINDOWED>(n2, k1 - pass * K::N1Z) / 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          zp[e * (K::ZPLANE / 2) + at] = pack2(r[0][e], r[1][e]);
          zp[(2 + e) * (K::ZPLANE / 2) + at] = pack2(im[0][e], im[1][e]);
          zp[(4 + e) * (K::ZPLANE / 2) + at] = pack2(s[0][e], s[1][e]);
        }
      }
    }
  }
}

// Stage 2 of one pass for a warp's items: item = (16 rows k1: tile mt of
// the pass) x (16 columns k2: tile ng), A = Z's split planes by
// ldmatrix.trans, B = the six weight planes; |X|^2 added to acc[i], the
// D fragments of the item's two n-tiles.
template <int LOG2N, bool WINDOWED>
__device__ __forceinline__ void smem_stage2(
    const __nv_bfloat16* zp, const uint32_t* w2,
    float (&acc)[SmemK3<LOG2N, WINDOWED>::IPW][2][4], int pass, int warp,
    int lane) {
  using K = SmemK3<LOG2N, WINDOWED>;
  constexpr int N2 = K::N2;
  constexpr int PLANE_WORDS = K::W2_BYTES / 4;
  const int m = lane >> 3;
#pragma unroll
  for (int i = 0; i < K::IPW; ++i) {
    const int item = pass * K::IPP + warp + i * K::WARPS;
    const int mtl = item / (N2 / 16) - pass * (K::N1Z / 16);
    const int ng = item % (N2 / 16);
    float u1[2][4] = {}, u2[2][4] = {}, u3[2][4] = {};
    // Whole when there are at most 4 chunks (N2 <= 64), so that the
    // loads of the next chunks issue ahead of this one's mma.
#pragma unroll(N2 <= 64 ? N2 / 16 : 2)
    for (int c = 0; c < N2 / 16; ++c) {
      // Matrix m: rows n2 = 16c + 8(m >> 1) + (lane & 7), columns k1 from
      // 16mtl + 8(m & 1) (stored transposed: its rows are A's columns).
      const int n2 = 16 * c + 8 * (m >> 1) + (lane & 7);
      const uint32_t at = shared_addr(
          zp + z_offset<LOG2N, WINDOWED>(n2, 16 * mtl + 8 * (m & 1)));
      uint32_t a[6][4];
#pragma unroll
      for (int e = 0; e < 6; ++e)
        ldmatrix_x4_trans(a[e], at + 2 * e * K::ZPLANE);
      uint32_t w[6][4];
      const int tile = (c * (N2 / 8) + 2 * ng) * 64;
#pragma unroll
      for (int e = 0; e < 6; ++e)
        load_b_pair<K::S2_RES>(w[e], w2 + e * PLANE_WORDS + tile, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint2 br0 = make_uint2(w[0][2 * j], w[0][2 * j + 1]);
        const uint2 br1 = make_uint2(w[1][2 * j], w[1][2 * j + 1]);
        const uint2 bi0 = make_uint2(w[2][2 * j], w[2][2 * j + 1]);
        const uint2 bi1 = make_uint2(w[3][2 * j], w[3][2 * j + 1]);
        const uint2 bs0 = make_uint2(w[4][2 * j], w[4][2 * j + 1]);
        const uint2 bs1 = make_uint2(w[5][2 * j], w[5][2 * j + 1]);
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xr = __fsub_rn(u1[j][e], u2[j][e]);
        const float xi = __fsub_rn(__fsub_rn(u3[j][e], u1[j][e]), u2[j][e]);
        acc[i][j][e] = __fadd_rn(
            acc[i][j][e], __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
      }
  }
}

// Block g transforms frames [g*group, min((g+1)*group, F, n_valid)) one
// after another and writes the f32 sum of their |X|^2 to partial row g
// (a cut: the sums its CUT names, in every bin).
template <int LOG2N, bool WINDOWED, int CUT = kK3Full>
__global__ void __launch_bounds__(SmemK3<LOG2N, WINDOWED>::THREADS,
                                  SmemK3<LOG2N, WINDOWED>::MIN_BLOCKS)
psd_smem_kernel(const uint8_t* __restrict__ raw,     // (F, 2N), 16 B aligned
                const float* __restrict__ window,    // (N,) or null
                const uint32_t* __restrict__ w1,     // register-major tiles
                const float4* __restrict__ twiddle,  // (N2, N1/2)
                const uint32_t* __restrict__ w2,     // six planes
                float* __restrict__ partial,         // (G, N)
                int F, int group, int n_valid) {
  using K = SmemK3<LOG2N, WINDOWED>;
  constexpr int N = K::N, N1 = K::N1, N2 = K::N2;
  extern __shared__ float4 k3_smem[];
  char* base = reinterpret_cast<char*>(k3_smem);
  uint32_t* zp = reinterpret_cast<uint32_t*>(base + K::OFF_Z);
  uint8_t* ring = reinterpret_cast<uint8_t*>(base + K::OFF_RING);
  float* win = reinterpret_cast<float*>(base + K::OFF_WIN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + K::OFF_BAR);
  const uint32_t* s1 =
      K::S1_RES ? reinterpret_cast<const uint32_t*>(base + K::OFF_W1) : w1;
  const uint32_t* s2 =
      K::S2_RES ? reinterpret_cast<const uint32_t*>(base + K::OFF_W2) : w2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[K::ZP][K::IPW][2][4];
#pragma unroll
  for (int p = 0; p < K::ZP; ++p)
#pragma unroll
    for (int i = 0; i < K::IPW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.0f;

  const int f0 = blockIdx.x * group;
  const int frames = max(min(f0 + group, min(F, n_valid)) - f0, 0);
  float sink = 0.0f;   // a cut's sum

  // Frame i of the block into ring slot i & 1 (an empty group past the
  // last frame, so that every thread counts the same groups).
  auto prefetch = [&](int i) {
    if (i < frames) {
      const uint8_t* src = raw + static_cast<size_t>(f0 + i) * (2 * N);
      uint8_t* dst = ring + (i & 1) * K::SLOT;
#pragma unroll
      for (int k = 0; k < K::COPIES; ++k) {
        // 16-byte piece q of the frame: row q / (N2 / 8), piece q % (N2 / 8).
        const int q = tid + k * K::THREADS;
        k3_cp_async16(dst + (q / (N2 / 8)) * K::RING_ROW + 16 * (q % (N2 / 8)),
                      src + 16 * q);
      }
    }
    k3_cp_async_commit();
  };

  if (frames > 0) {
    if constexpr (WINDOWED) {
      for (int i = tid; i < N; i += K::THREADS)
        win[(i / N2) * K::WIN_ROW + i % N2] = __ldg(window + i);
    }
    if constexpr (K::RESIDENT_BYTES > 0) {
      if (tid == 0) k3_mbarrier_init(bar);
      __syncthreads();   // the barrier is initialised before any wait
      if (tid == 0) {
        k3_mbarrier_expect(bar, K::RESIDENT_BYTES);
        if constexpr (K::S1_RES) {
          k3_bulk_copy(base + K::OFF_W1, w1, K::W1_BYTES, bar);
        }
        if constexpr (K::S2_RES) {
          k3_bulk_copy(base + K::OFF_W2, w2, 6 * K::W2_BYTES, bar);
        }
      }
    }
    prefetch(0);
    if constexpr (K::RESIDENT_BYTES > 0) k3_mbarrier_wait(bar, 0);
  }
  for (int i = 0; i < frames; ++i) {
    prefetch(i + 1);          // into the slot frame i - 1's stage 1 read
    k3_cp_async_wait<1>();    // this thread's copies of frame i landed
    __syncthreads();          // everyone's; Z is free, the window stored
    const uint16_t* iq =
        reinterpret_cast<const uint16_t*>(ring + (i & 1) * K::SLOT);
#pragma unroll
    for (int p = 0; p < K::ZP; ++p) {
      if (p > 0) __syncthreads();   // pass p - 1's stage 2 read Z
      smem_stage1<LOG2N, WINDOWED, CUT>(iq, win, s1, twiddle, zp, p, warp,
                                        lane, sink);
      __syncthreads();
      if constexpr (CUT == kK3Full) {
        smem_stage2<LOG2N, WINDOWED>(
            reinterpret_cast<const __nv_bfloat16*>(zp), s2, acc[p], p, warp,
            lane);
      } else if constexpr (CUT == kK3CutStage1) {
        sink = __fadd_rn(sink, bf16_pair_sum(zp[tid % (3 * K::ZPLANE)]));
      }
    }
  }
  k3_cp_async_wait<0>();

  float* row = partial + static_cast<size_t>(blockIdx.x) * N;
  if constexpr (CUT != kK3Full) {
    // Each thread's sum in bins tid, tid + THREADS, ...
    for (int k = tid; k < N; k += K::THREADS) row[k] = sink;
    return;
  }
#pragma unroll
  for (int p = 0; p < K::ZP; ++p)
#pragma unroll
    for (int i = 0; i < K::IPW; ++i) {
      const int item = p * K::IPP + warp + i * K::WARPS;
      const int mt = item / (N2 / 16);
      const int ng = item % (N2 / 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k1 = 16 * mt + g + 8 * (e >> 1);
          const int k2 = 16 * ng + 8 * j + 2 * t + (e & 1);
          row[k1 + N1 * k2] = acc[p][i][j][e];
        }
    }
}

}  // namespace
