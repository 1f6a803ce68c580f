// Thomson multitaper device step for NVIDIA Hopper (sm_90a).
//
// Replaces the device step of rtl_power_fftw_tpu/models/multitaper.py
// (_mt_core, 60-133; XLA there, no Pallas kernel): raw interleaved u8 IQ
// frames (F, 2N) -> dequantize (u8 - 127) -> times taper k (row k of a
// (K, N) float32 table) -> length-N DFT -> |X|^2 -> drop frames f >=
// n_valid -> the sum over frames and tapers, divided by K in float32 (the
// mean eigenspectrum, summed over frames), as an (N,) float32 vector of
// bins in natural (unshifted) order.
//
// What bounds it on the card is the K transforms a frame: a frame is
// 2N bytes and K * (4N log2 N - 6N) FP32 operations, each transform's
// passes through a lane's exchange buffer in shared memory with a barrier
// between passes (K1's register transform, fft_regs.cuh), so its time
// follows the rounds of transforms a lane runs. Two kernels compute it.
//
// psd_tapers_batch_kernel (the route where the card measured it ahead of
// the control, rule fused_psd_tapers.batch_shape: 3 <= K <= 16, 1024 <=
// N <= 4096, K N <= 32768): block (g, s) runs tapers [s * KB, min((s + 1)
// * KB, K)) of its frames [g * group, (g + 1) * group), on K2's block
// shape (LANES lanes of TF = N / R threads; lane p takes frames f0 + p +
// LANES * i); the wrapper's grid rule (fused_psd_tapers.batch_grid) gives
// each lane as many frames, covers the valid frames in one wave, and
// splits the tapers into ranges (KB < K) only where the frames alone
// leave it short. Each lane stages its frames C at a time by cp.async, 16
// B a thread, in a shared-memory ring of 2 C raw slots (2N bytes each, 32
// more a lane so that the lanes of one warp, N <= 256, read other banks):
// batch b + 1 is in flight while batch b is transformed KB times. For
// each taper k the thread loads its R values of row k once into registers
// (through L1 and L2: a table staged beside the ring measured slower),
// then for each of the batch's frames reads the frame from the ring,
// dequantizes it exactly, multiplies it by the taper (__fmul_rn, as K2
// does), runs K1's regs_transform and adds |X|^2 to its R f32 sums, which
// run over tapers and frames. A slot is rewritten only after the barrier
// that ends the first pass of the last transform that reads it. The block
// writes one partial row (regs_lane_sum), s * G + g; each frame is read
// from device memory once a taper range. cp.async over a bulk (TMA) copy:
// a lane's batch is a few 16-byte copies a thread, the barrier that frees
// the exchange buffer publishes them, and no mbarrier phase per slot is
// needed. One wave of blocks that each run all K tapers is where it gains
// on the control, whose K G blocks leave a partial last wave.
//
// The control, the kernel it was redesigned from (and the route
// elsewhere): K2's group kernel with a taper axis on the grid, block (g,
// k) psd_regs_kernel<LOG2N, true, kRegsTapers> of fused_psd_regs.cuh under
// taper row k over frames [g * group, (g + 1) * group), writing partial
// row k * G + g; each frame is read K times, once by each taper's block
// (from L2 after the first).
//
// Either way est_sum_kernel (fused_psd_est.cuh, kEstTapers) then sums the
// partial rows in float64 and divides by K. The redesign's f32 sums run
// over tapers and frames, the control's over frames, so the two differ
// in the last bits.
//
// rpf_fused_psd_tapers_streams runs either kernel over S streams of F
// frames, (S*F, 2N) with an (S,) count array on the device, and gives each
// stream its own row, (S, N); the (K, N) taper table is shared. Block
// (s * G_s + j, y) serves stream s (G_s = ceil(F / group) blocks a stream)
// and writes partial row y * S * G_s + s * G_s + j; est_streams_kernel sums
// each stream's rows in the order one stream's pass sums them. The
// control is psd_regs_kernel with S folded into its grid, as K4 folds it
// into K1's. The batch kernel's streams form,
// psd_tapers_batch_streams_kernel, is psd_tapers_batch_kernel with the
// stream's frames and count resolved from its block (the single-stream
// kernel stays as it was: its SASS is held to the earlier build's); its
// grid is sized on F (fused_psd_tapers.streams_batch_grid), not on the
// counts, which are on the device, and a block past its stream's count
// runs no batch and writes a zero row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"
#include "fused_psd_est.cuh"
#include "fused_psd_regs.cuh"

namespace {

constexpr int kMinLog2N = 6;
constexpr int kMaxLog2N = 14;
constexpr int kMaxTapers = 32;
constexpr int kMaxSmem = 232448;   // the 227 KB a Hopper block may use
// A lane's ring: 32 bytes past its 2 C slots (RegsShape's ring pad).
constexpr int kRingPad = 32;

template <int LOG2N>
cudaError_t prepare(int device, int* smem) {
  static std::atomic<unsigned long long> done{0};
  *smem = RegsShape<LOG2N>::SMEM_BYTES;
  return opt_in_smem(psd_regs_kernel<LOG2N, true, kRegsTapers>, *smem,
                     device, done);
}

// blocks = S * G_s (counts: (S,) on the device, or null for one stream of
// n_valid frames).
template <int LOG2N>
cudaError_t launch_groups(const void* raw, const void* twiddle,
                          const void* tapers, void* partial, int F, int group,
                          int blocks, int G_s, int K, int n_valid,
                          const void* counts, int device,
                          cudaStream_t stream) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N>(device, &smem);
  if (e != cudaSuccess) return e;
  psd_regs_kernel<LOG2N, true, kRegsTapers>
      <<<dim3(blocks, K), RegsShape<LOG2N>::THREADS, smem, stream>>>(
          static_cast<const uint8_t*>(raw),
          static_cast<const float2*>(twiddle),
          static_cast<const float*>(tapers), static_cast<float*>(partial), F,
          group, G_s, n_valid, static_cast<const int*>(counts));
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t attributes(int device, int* attrs) {
  int smem = 0;
  const cudaError_t e = prepare<LOG2N>(device, &smem);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_regs_kernel<LOG2N, true, kRegsTapers>,
                           RegsShape<LOG2N>::THREADS, smem, attrs);
}

// Bytes of a lane's ring at C frames a batch: 2 C slots of 2N bytes.
template <int LOG2N>
__host__ __device__ constexpr int batch_lane_bytes(int C) {
  return 4 * C * (1 << LOG2N) + kRingPad;
}

// The batch kernel's shared memory: the lanes' exchange buffers (the
// lanes' sums by bin at the end) and their rings.
template <int LOG2N>
int batch_smem_bytes(int C) {
  using S = RegsShape<LOG2N>;
  return S::RING_OFFSET + S::LANES * batch_lane_bytes<LOG2N>(C);
}

// Block (g, s) sums |DFT(x_f * taper_k)|^2 over k in [s * KB, min((s +
// 1) * KB, K)) and its frames f in [g * group, min((g + 1) * group, F,
// n_valid)) into partial row s * G + g. Lane frame i = b * C + c (frame
// f0 + lane + LANES * i) lies in ring slot (b & 1) * C + c of the lane's
// ring during batch b. A 256-thread block is held to 128 registers, so
// that two fit an SM.
template <int LOG2N>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS,
                                  RegsShape<LOG2N>::THREADS <= 256 ? 2 : 1)
psd_tapers_batch_kernel(const uint8_t* __restrict__ raw,     // (F, 2N)
                        const float2* __restrict__ twiddle,  // pass_twiddles
                        const float* __restrict__ tapers,    // (K, N)
                        float* __restrict__ partial,         // (S * G, N)
                        int F, int group, int n_valid, int K, int KB,
                        int C) {
  using P = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = P::N, R = P::R, TF = P::TF;
  static_assert(P::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 mt_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  uint8_t* smem = reinterpret_cast<uint8_t*>(mt_smem);
  float2* x = reinterpret_cast<float2*>(mt_smem) + lane * S::XSTRIDE;
  const int lane_bytes = batch_lane_bytes<LOG2N>(C);
  uint8_t* ring = smem + S::RING_OFFSET + lane * lane_bytes;
  const int k0 = blockIdx.y * KB;
  const int k1 = min(k0 + KB, K);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  const int f0 = blockIdx.x * group;
  const int f1 = min(f0 + group, min(F, n_valid));
  const int iters = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  const int batches = (iters + C - 1) / C;

  // Batch b of the lane's frames into ring half b & 1 (an empty group past
  // the last batch, so that every thread counts the same groups).
  auto stage = [&](int b) {
    if (b < batches) {
      for (int c = 0; c < C; ++c) {
        const int f = f0 + lane + S::LANES * (b * C + c);
        if (f < f1) {
          const uint8_t* src = raw + static_cast<size_t>(f) * 2 * N;
          uint8_t* dst = ring + ((b & 1) * C + c) * 2 * N;
#pragma unroll
          for (int q = 0; q < S::COPIES; ++q) {
            cp_async16(dst + 16 * (t + q * TF), src + 16 * (t + q * TF));
          }
        }
      }
    }
    cp_async_commit();
  };

  stage(0);
  for (int b = 0; b < batches; ++b) {
    stage(b + 1);
    cp_async_wait<1>();   // this thread's copies of batch b have landed
    __syncthreads();      // everyone's; x is free (batch b - 1's last pass)
    const int frames = min(C, iters - b * C);
    const uint8_t* slots = ring + (b & 1) * C * 2 * N;
    for (int k = k0; k < k1; ++k) {
      // The thread's R values of taper row k, for the batch's frames.
      float win[R];
      const float* row = tapers + static_cast<size_t>(k) * N + t;
#pragma unroll
      for (int r = 0; r < R; ++r) win[r] = __ldg(row + r * TF);
      for (int c = 0; c < frames; ++c) {
        const bool active = f0 + lane + S::LANES * (b * C + c) < f1;
        float2 v[R];
        if (active) {
          const uint16_t* iq =
              reinterpret_cast<const uint16_t*>(slots + c * 2 * N);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const unsigned u = iq[t + r * TF];
            v[r] = make_float2(__fmul_rn(dequant_byte(u & 0xFFu), win[r]),
                               __fmul_rn(dequant_byte(u >> 8), win[r]));
          }
        }
        // x is free: every lane is past the last pass of the transform
        // before (the batch's first transform: the barrier above).
        if (k > k0 || c > 0) __syncthreads();
        regs_transform<LOG2N>(v, x, twiddle, t, active);
        if (active) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] += v[r].x * v[r].x + v[r].y * v[r].y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every lane is done with its exchange buffer

  // The lanes' sums by bin, then added lane by lane in order.
  float* by_bin = reinterpret_cast<float*>(mt_smem);   // (LANES, N)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, r)] = acc[r];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(
      by_bin,
      partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * N,
      tid);
}

// The streams forms: begin (probes/estimator_builds.py edits only the
// single-stream kernels, outside these fences).

// psd_tapers_batch_kernel over S streams: block (g, y) serves stream s =
// g / G_s, its frames [j * group, min((j + 1) * group, F, n_valid[s])), j
// = g - s * G_s (the count read from device memory, a count outside [0,
// F] acting as its nearest bound), and writes partial row y * gridDim.x +
// g. The body is psd_tapers_batch_kernel's, line for line.
template <int LOG2N>
__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS,
                                  RegsShape<LOG2N>::THREADS <= 256 ? 2 : 1)
psd_tapers_batch_streams_kernel(
    const uint8_t* __restrict__ raw,     // (S*F, 2N)
    const float2* __restrict__ twiddle,  // pass_twiddles
    const float* __restrict__ tapers,    // (K, N)
    float* __restrict__ partial,         // (Q * S * G_s, N)
    int F, int group, int G_s, const int* __restrict__ counts, int K,
    int KB, int C) {
  using P = RegsPlan<LOG2N>;
  using S = RegsShape<LOG2N>;
  constexpr int N = P::N, R = P::R, TF = P::TF;
  static_assert(P::PASSES >= 2, "a ring slot is rewritten only after the "
                "barrier that ends the first pass");
  extern __shared__ float4 mt_smem[];
  const int tid = threadIdx.x;
  const int lane = tid / TF;
  const int t = tid % TF;
  uint8_t* smem = reinterpret_cast<uint8_t*>(mt_smem);
  float2* x = reinterpret_cast<float2*>(mt_smem) + lane * S::XSTRIDE;
  const int lane_bytes = batch_lane_bytes<LOG2N>(C);
  uint8_t* ring = smem + S::RING_OFFSET + lane * lane_bytes;
  const int k0 = blockIdx.y * KB;
  const int k1 = min(k0 + KB, K);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  const int stream = blockIdx.x / G_s;
  const uint8_t* frames = raw + static_cast<size_t>(stream) * F * 2 * N;
  const int f0 = (blockIdx.x - stream * G_s) * group;
  const int f1 = min(f0 + group, min(F, __ldg(counts + stream)));
  const int iters = (max(f1 - f0, 0) + S::LANES - 1) / S::LANES;
  const int batches = (iters + C - 1) / C;

  auto stage = [&](int b) {
    if (b < batches) {
      for (int c = 0; c < C; ++c) {
        const int f = f0 + lane + S::LANES * (b * C + c);
        if (f < f1) {
          const uint8_t* src = frames + static_cast<size_t>(f) * 2 * N;
          uint8_t* dst = ring + ((b & 1) * C + c) * 2 * N;
#pragma unroll
          for (int q = 0; q < S::COPIES; ++q) {
            cp_async16(dst + 16 * (t + q * TF), src + 16 * (t + q * TF));
          }
        }
      }
    }
    cp_async_commit();
  };

  stage(0);
  for (int b = 0; b < batches; ++b) {
    stage(b + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int nb = min(C, iters - b * C);
    const uint8_t* slots = ring + (b & 1) * C * 2 * N;
    for (int k = k0; k < k1; ++k) {
      float win[R];
      const float* row = tapers + static_cast<size_t>(k) * N + t;
#pragma unroll
      for (int r = 0; r < R; ++r) win[r] = __ldg(row + r * TF);
      for (int c = 0; c < nb; ++c) {
        const bool active = f0 + lane + S::LANES * (b * C + c) < f1;
        float2 v[R];
        if (active) {
          const uint16_t* iq =
              reinterpret_cast<const uint16_t*>(slots + c * 2 * N);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const unsigned u = iq[t + r * TF];
            v[r] = make_float2(__fmul_rn(dequant_byte(u & 0xFFu), win[r]),
                               __fmul_rn(dequant_byte(u >> 8), win[r]));
          }
        }
        if (k > k0 || c > 0) __syncthreads();
        regs_transform<LOG2N>(v, x, twiddle, t, active);
        if (active) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] += v[r].x * v[r].x + v[r].y * v[r].y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* by_bin = reinterpret_cast<float*>(mt_smem);   // (LANES, N)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    by_bin[lane * N + regs_slot_bin<LOG2N>(t, r)] = acc[r];
  }
  __syncthreads();
  regs_lane_sum<LOG2N>(
      by_bin,
      partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * N,
      tid);
}

// The streams forms: end.

// The batch kernel opts in to the most a block may use once; a launch
// asks for its own C's share of it.
template <int LOG2N>
cudaError_t prepare_batch(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_tapers_batch_kernel<LOG2N>, kMaxSmem, device, done);
}

template <int LOG2N>
cudaError_t prepare_batch_streams(int device) {
  static std::atomic<unsigned long long> done{0};
  return opt_in_smem(psd_tapers_batch_streams_kernel<LOG2N>, kMaxSmem, device,
                     done);
}

// The batch kernel's streams form on S * G_s x ceil(K / KB) blocks.
template <int LOG2N>
cudaError_t launch_batch_streams(const void* raw, const void* twiddle,
                                 const void* tapers, void* partial, int F,
                                 int group, int S, int G_s, const void* counts,
                                 int K, int KB, int C, int device,
                                 cudaStream_t stream) {
  const int smem = batch_smem_bytes<LOG2N>(C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = prepare_batch_streams<LOG2N>(device);
  if (e != cudaSuccess) return e;
  psd_tapers_batch_streams_kernel<LOG2N>
      <<<dim3(S * G_s, (K + KB - 1) / KB), RegsShape<LOG2N>::THREADS, smem,
         stream>>>(static_cast<const uint8_t*>(raw),
                   static_cast<const float2*>(twiddle),
                   static_cast<const float*>(tapers),
                   static_cast<float*>(partial), F, group, G_s,
                   static_cast<const int*>(counts), K, KB, C);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t launch_batch(const void* raw, const void* twiddle,
                         const void* tapers, void* partial, int F, int group,
                         int blocks, int K, int KB, int n_valid, int C,
                         int device, cudaStream_t stream) {
  const int smem = batch_smem_bytes<LOG2N>(C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = prepare_batch<LOG2N>(device);
  if (e != cudaSuccess) return e;
  psd_tapers_batch_kernel<LOG2N>
      <<<dim3(blocks, (K + KB - 1) / KB), RegsShape<LOG2N>::THREADS, smem,
         stream>>>(static_cast<const uint8_t*>(raw),
                   static_cast<const float2*>(twiddle),
                   static_cast<const float*>(tapers),
                   static_cast<float*>(partial), F, group, n_valid, K, KB, C);
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t batch_attributes(int C, int device, int* attrs) {
  const int smem = batch_smem_bytes<LOG2N>(C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = prepare_batch<LOG2N>(device);
  if (e != cudaSuccess) return e;
  return kernel_attributes(psd_tapers_batch_kernel<LOG2N>,
                           RegsShape<LOG2N>::THREADS, smem, attrs);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. raw: (F, 2N) u8, 16-byte aligned;
// twiddle: pass_twiddles(N), (rows, 2) f32; tapers: (K, N) f32, 1 <= K <=
// 32; batch: frames a lane stages a batch, C >= 1, for
// psd_tapers_batch_kernel on K / per_block taper ranges of per_block
// tapers (rounded up; cudaErrorInvalidValue where its shared memory
// exceeds a block's), or 0 for the control; partial: (ceil(K / per_block)
// * max(1, ceil(n_valid / group)), N) f32 scratch for the batch kernel,
// (K * ceil(F / group), N) for the control; out: (N,) f32. Returns a
// cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_tapers(const void* raw, const void* twiddle,
                         const void* tapers, void* partial, void* out,
                         int device, int log2n, int F, int group, int K,
                         int n_valid, int batch, int per_block,
                         void* stream) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || F <= 0 || group <= 0 ||
      K < 1 || K > kMaxTapers || n_valid < 0 || n_valid > F ||
      tapers == nullptr || batch < 0 ||
      (batch > 0 && (per_block < 1 || per_block > K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // The batch kernel's blocks cover the valid frames, the control's all F.
  const int blocks = batch ? (n_valid > 0 ? (n_valid + group - 1) / group : 1)
                           : (F + group - 1) / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = batch ? launch_batch<L>(raw, twiddle, tapers, partial, F, group,    \
                                blocks, K, per_block, n_valid, batch,       \
                                device, st)                                 \
              : launch_groups<L>(raw, twiddle, tapers, partial, F, group,   \
                                 blocks, blocks, K, n_valid, nullptr,       \
                                 device, st);                               \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = 1 << log2n;
  est_sum_kernel<kEstTapers><<<N / kSumBins, kSumBins * kSumLanes, 0, st>>>(
      static_cast<const float*>(partial),
      (batch ? (K + per_block - 1) / per_block : K) * blocks, N, K, 0.0f,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// S streams of F frames. raw: (S*F, 2N) u8, 16-byte aligned, stream s in
// rows [s*F, (s+1)*F); n_valid: (S,) int32 on the device, read when the
// kernels run (a count outside [0, F] acts as its nearest bound); G_s =
// ceil(F / group) blocks a stream; partial: (Q * S * G_s, N) f32 scratch,
// Q = ceil(K / per_block) for the batch kernel (batch > 0), K for the
// control; out: (S, N) f32. Other arguments as rpf_fused_psd_tapers.
int rpf_fused_psd_tapers_streams(const void* raw, const void* twiddle,
                                 const void* tapers, const void* n_valid,
                                 void* partial, void* out, int device,
                                 int log2n, int S, int F, int group, int K,
                                 int batch, int per_block, void* stream) {
  const long long G_s = group > 0 ? (F + group - 1) / group : 0;
  if (log2n < kMinLog2N || log2n > kMaxLog2N || S <= 0 || F <= 0 ||
      group <= 0 || K < 1 || K > kMaxTapers || tapers == nullptr ||
      n_valid == nullptr || batch < 0 ||
      (batch > 0 && (per_block < 1 || per_block > K)) ||
      S * G_s * K > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int g = static_cast<int>(G_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_CASE(L)                                                         \
  case L:                                                                   \
    e = batch ? launch_batch_streams<L>(raw, twiddle, tapers, partial, F,   \
                                        group, S, g, n_valid, K, per_block, \
                                        batch, device, st)                  \
              : launch_groups<L>(raw, twiddle, tapers, partial, F, group,   \
                                 S * g, g, K, 0, n_valid, device, st);      \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Q = batch ? (K + per_block - 1) / per_block : K;
  return static_cast<int>(launch_est_streams<kEstTapers>(
      partial, S, g, Q, 1 << log2n, n_valid, F, K, 0.0f, out, st));
}

// What the first pass gets at N = 2^log2n on `device` (batch: the batch
// kernel at C = batch frames a batch; 0: the control): attrs[0..5] as
// fused_psd.cu's rpf_fused_psd_attributes. Launches nothing.
int rpf_fused_psd_tapers_attributes(int log2n, int batch, int device,
                                    int* attrs) {
  if (log2n < kMinLog2N || log2n > kMaxLog2N || batch < 0 ||
      attrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
#define RPF_CASE(L)                                                          \
  case L:                                                                    \
    e = batch ? batch_attributes<L>(batch, device, attrs)                    \
              : attributes<L>(device, attrs);                                \
    break;
  switch (log2n) {
    RPF_CASE(6) RPF_CASE(7) RPF_CASE(8) RPF_CASE(9) RPF_CASE(10)
    RPF_CASE(11) RPF_CASE(12) RPF_CASE(13) RPF_CASE(14)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPF_CASE
  return static_cast<int>(e);
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
