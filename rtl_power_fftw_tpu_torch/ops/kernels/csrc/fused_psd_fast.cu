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
//
// The group kernel itself is the template of fused_psd_fast.cuh; this
// file instantiates its default variant (the shipping K3) at every size.
// fused_psd_probe.cu instantiates its stage-attribution variants.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_psd_fast.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kMinLog2N = 8;
constexpr int kMaxLog2N = 14;

template <int LOG2N, bool WINDOWED>
cudaError_t launch_fast(const void* raw, const void* window, const void* w1r,
                        const void* w1i, const void* twiddle, const void* w2,
                        void* partial, int F, int group, int G, int n_valid,
                        cudaStream_t stream) {
  using S = FastShape<LOG2N>;
  const int smem = FastSmem<LOG2N, WINDOWED, FastVariant<>>::BYTES;
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
