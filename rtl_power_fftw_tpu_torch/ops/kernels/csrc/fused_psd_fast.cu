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
// outputs (two m16n8 tiles); a block's warps are kSmemPlan's.
//
// What bounds it on an H100. The scheme costs 12 (24 windowed) real
// products of depth N1 and 9 of depth N2 per output: N(12 N1 + 9 N2)
// MACs a frame, 3.9 MFLOP at N = 2048 against 4 KB read, so device
// memory is not the limit and the 989 TFLOP/s of the tensor cores is far
// away (2.4 us at N = 2048, F = 400, windowed). What bounds the kernel is
// the traffic around the products: the operand fragments and the
// barriers of a frame.
//
// The kernel (psd_smem_kernel, fused_psd_fast_smem.cuh, whose note says
// what its design does about that): the stage weights resident in shared
// memory where they fit, copied once a block by bulk copies and read by
// ldmatrix; Z staged once as six bf16 split planes; the next frame's
// bytes in flight by cp.async; about one resident wave of blocks, each
// summing several frames (fused_psd.k1_group with this kernel's
// occupancy, rpf_fused_psd_fast_attributes). No float atomics: a partial
// row per block and the fixed-order float64 row sum (psd_sum.cuh), so the
// result is the same on every run.
//
// The control (rpf_fused_psd_fast_control): the kernel this one replaced,
// psd_fast_group_kernel (the template of fused_psd_fast.cuh, whose other
// values are fused_psd_probe.cu's stage-attribution variants), launched
// as it was, on the radix-2 kernel's grid (fused_psd.frames_per_block):
// every A fragment gathered element by element and split in registers,
// every B fragment read from L1/L2 once per warp, per frame and per mma
// (~200 KB a frame at N = 2048), Z in f32 in shared memory (8N bytes), no
// copy in flight. chip_smoke.py times it beside the kernel; nothing else
// launches it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_fast.cuh"
#include "fused_psd_fast_smem.cuh"
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

// Opts the kernel into its dynamic shared memory (and the largest
// carveout) where that is above the 48 KB default: once per device (bit d
// of a mask for device d < 64; a device beyond that sets it every call),
// so that a launch makes no cudaFuncSetAttribute call. Two threads may set
// it; that is harmless.
template <int LOG2N, bool WINDOWED, int CUT = kK3Full>
cudaError_t prepare_smem(int device) {
  constexpr int smem = SmemK3<LOG2N, WINDOWED>::BYTES;
  if constexpr (smem <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static std::atomic<unsigned long long> done{0};
    const unsigned long long bit = device < 64 ? 1ull << device : 0;
    if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) {
      return cudaSuccess;
    }
    cudaError_t e = cudaFuncSetAttribute(
        psd_smem_kernel<LOG2N, WINDOWED, CUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(psd_smem_kernel<LOG2N, WINDOWED, CUT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    }
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return e;
  }
}

template <int LOG2N, bool WINDOWED, int CUT = kK3Full>
cudaError_t launch_smem(const void* raw, const void* window, const void* w1,
                        const void* twiddle, const void* w2, void* partial,
                        int F, int group, int G, int n_valid, int device,
                        cudaStream_t stream) {
  using K = SmemK3<LOG2N, WINDOWED>;
  const cudaError_t e = prepare_smem<LOG2N, WINDOWED, CUT>(device);
  if (e != cudaSuccess) return e;
  psd_smem_kernel<LOG2N, WINDOWED, CUT>
      <<<G, K::THREADS, K::BYTES, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float*>(window),
      static_cast<const uint32_t*>(w1), static_cast<const float4*>(twiddle),
      static_cast<const uint32_t*>(w2),
      static_cast<float*>(partial), F, group, n_valid);
  return cudaGetLastError();
}

// What the kernel gets on the current device: registers and spill bytes a
// thread, static and dynamic shared bytes a block, threads a block, and
// the blocks that reside on one SM.
template <int LOG2N, bool WINDOWED>
cudaError_t smem_attributes(int device, int* attrs) {
  using K = SmemK3<LOG2N, WINDOWED>;
  cudaError_t e = prepare_smem<LOG2N, WINDOWED>(device);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&fa, psd_smem_kernel<LOG2N, WINDOWED>);
  }
  if (e != cudaSuccess) return e;
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = K::BYTES;
  attrs[4] = K::THREADS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], psd_smem_kernel<LOG2N, WINDOWED>, K::THREADS, K::BYTES);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`: the kernel, then the row sum. raw:
// (F, 2N) u8, 16-byte aligned (cp.async copies 16 bytes); window: (N,)
// f32, 4-byte aligned, or null; w1: the stage-1 weights [r0; -i0; r1;
// -i1; r2; -i2] (6 N1 x N1), w2: the six stage-2 planes, each as
// register-major B-fragment tiles (fused_psd_fast.pack_b_ldmatrix),
// 16-byte aligned (the bulk copies); twiddle: (N2, N1, 2) f32; partial:
// (ceil(F / group), N) f32 scratch; out: (N,) f32. Returns a cudaError_t
// (0 on success); does not synchronise.
int rpf_fused_psd_fast(const void* raw, const void* window, const void* w1,
                       const void* twiddle, const void* w2, void* partial,
                       void* out, int device, int log2n, int F, int group,
                       int n_valid, void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPF_SMEM_CASE(L)                                                     \
  case L:                                                                    \
    e = window == nullptr                                                    \
            ? launch_smem<L, false>(raw, window, w1, twiddle, w2, partial,   \
                                    F, group, G, n_valid, device, s)         \
            : launch_smem<L, true>(raw, window, w1, twiddle, w2, partial, F, \
                                   group, G, n_valid, device, s);            \
    break;
  switch (log2n) {
    RPF_SMEM_CASE(8)
    RPF_SMEM_CASE(9)
    RPF_SMEM_CASE(10)
    RPF_SMEM_CASE(11)
    RPF_SMEM_CASE(12)
    RPF_SMEM_CASE(13)
    RPF_SMEM_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_SMEM_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G, 1 << log2n, out, s));
}

// Writes what the kernel gets at N = 2^log2n, windowed or not, on
// `device` into attrs[0..5]: registers and local (spill) bytes a thread,
// static and dynamic shared bytes a block, threads a block, and the blocks
// that reside on one SM. Launches nothing.
int rpf_fused_psd_fast_attributes(int log2n, int windowed, int device,
                                  int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_SMEM_CASE(L)                                                     \
  case L:                                                                    \
    e = windowed ? smem_attributes<L, true>(device, attrs)                   \
                 : smem_attributes<L, false>(device, attrs);                 \
    break;
  switch (log2n) {
    RPF_SMEM_CASE(8)
    RPF_SMEM_CASE(9)
    RPF_SMEM_CASE(10)
    RPF_SMEM_CASE(11)
    RPF_SMEM_CASE(12)
    RPF_SMEM_CASE(13)
    RPF_SMEM_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_SMEM_CASE
  return static_cast<int>(e);
}

// A cut of the kernel at N = 2048 (its stage split): cut 1 the frame's
// copies and the stage-1 gather, cut 2 also stage 1, the twiddle and Z's
// planes (kK3Cut* in fused_psd_fast_smem.cuh), then the row sum; other
// arguments as rpf_fused_psd_fast. Writes the cut's sums, not a spectrum.
int rpf_fused_psd_fast_cut(int cut, const void* raw, const void* window,
                           const void* w1, const void* twiddle,
                           const void* w2, void* partial, void* out,
                           int device, int log2n, int F, int group,
                           int n_valid, void* stream) {
  if (log2n != 11 || (cut != kK3CutGather && cut != kK3CutStage1) || F <= 0 ||
      group <= 0 || n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = (F + group - 1) / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window != nullptr;
  if (cut == kK3CutGather) {
    e = w ? launch_smem<11, true, kK3CutGather>(raw, window, w1, twiddle, w2,
                                                partial, F, group, G,
                                                n_valid, device, s)
          : launch_smem<11, false, kK3CutGather>(raw, window, w1, twiddle,
                                                 w2, partial, F, group, G,
                                                 n_valid, device, s);
  } else {
    e = w ? launch_smem<11, true, kK3CutStage1>(raw, window, w1, twiddle, w2,
                                                partial, F, group, G,
                                                n_valid, device, s)
          : launch_smem<11, false, kK3CutStage1>(raw, window, w1, twiddle,
                                                 w2, partial, F, group, G,
                                                 n_valid, device, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G, 1 << log2n, out, s));
}

// The control: the kernel this file launched before, on its grid, with
// its launch as it was. raw: (F, 2N) u8, 16-byte aligned; window: (N,)
// f32 or null; w1r, w1i: stage-1 weights as B fragments ((6 or 12) *
// N1/16, N1/8, 32 lanes, 4 bf16); twiddle: (N2, N1, 2) f32; w2: (6,
// N2/16, N2/8, 32, 4) bf16 stage-2 B fragments; partial: (ceil(F /
// group), N) f32 scratch; out: (N,) f32. Returns a cudaError_t (0 on
// success); does not synchronise.
int rpf_fused_psd_fast_control(const void* raw, const void* window,
                               const void* w1r, const void* w1i,
                               const void* twiddle, const void* w2,
                               void* partial, void* out, int device,
                               int log2n, int F, int group, int n_valid,
                               void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      n_valid < 0 || n_valid > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
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
