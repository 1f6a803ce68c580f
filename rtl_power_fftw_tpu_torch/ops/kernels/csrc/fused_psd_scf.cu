// Spectral correlation sums for NVIDIA Hopper (sm_90a): "SCF".
//
// Replaces the products and sums of rtl_power_fftw_tpu/models/cyclo.py
// (_scf_step, 42-69; XLA there, no Pallas kernel). Its input is the (F, N)
// complex64 spectra of one step, X_m in natural bin order (the frames
// kernel's complex store, fused_psd_frames.cu); its output, for the lags
// k = k0 .. k0 + K - 1 and the valid frames m < n_valid,
//
//   S[k, f] = sum over m of X_m[(f + k) mod N] * conj(X_m[f])
//
// as (2, K, N) f32 (plane 0 the real parts, plane 1 the imaginary): the
// JAX step's jnp.roll(Xm, -k) times conj(Xm), summed within each group of
// `chunk` frames and then over the groups (its tree (g, chunk)).
//
// Pass 1, scf_group_kernel: block (bx, by, g) owns bins bx * kScfBins ..
// + kScfBins - 1, lags k0 + by * kScfLags .. + kScfLags - 1 and group g,
// frames g * chunk .. min((g + 1) * chunk, n_valid) - 1. Its 256 threads
// are kScfBins bins by 8 lag rows, each thread kScfLags / 8 lags of one
// bin, so its sums (re and im of each) stay in registers. The frames are
// taken kScfBatch at a time: the block stages the batch's X_m at its bins
// (A, kScfBins values a frame) and at its bins shifted by its first lag
// (C, kScfBins + kScfLags values a frame, the wrap mod N taken there) in
// shared memory, and each thread adds its products (each in float32, as
// the JAX step forms them) frame by frame in order, in float64: a group's
// sum of up to `chunk` products then carries the products' own error
// only, as psd_sum.cuh's row sum does for the groups. Block (bx, by, g)
// writes its sums, rounded once to float32, to partial row g, (2, K, N) of
// them. Pass 2 is psd_sum.cuh's float64 row sum over the G rows of each
// of the 2 K N values.
//
// The lags are tiled on the host too: a call covers at most
// fused_psd_scf.SLAB values of K N (the caller loops over slabs of lags),
// because K may be as large as N.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "psd_sum.cuh"

namespace {

constexpr int kScfBins = 32;    // bins a block: one warp wide
constexpr int kScfRows = 8;     // lag rows of threads a block
constexpr int kScfLags = 32;    // lags a block, kScfLags / kScfRows a thread
constexpr int kScfBatch = 16;   // frames staged at a time
constexpr int kScfThreads = kScfBins * kScfRows;
constexpr int kScfPer = kScfLags / kScfRows;
constexpr int kScfSpan = kScfBins + kScfLags;   // C's values a frame

__global__ void __launch_bounds__(kScfThreads)
scf_group_kernel(const float2* __restrict__ X,   // (F, N)
                 float* __restrict__ partial,    // (G, 2, K, N)
                 int N, int K, int k0, int chunk, int n_valid) {
  __shared__ float2 a_s[kScfBatch][kScfBins];
  __shared__ float2 c_s[kScfBatch][kScfSpan];
  const int tid = threadIdx.x;
  const int b = tid % kScfBins;
  const int row = tid / kScfBins;
  const int bin0 = blockIdx.x * kScfBins;
  const int lag0 = blockIdx.y * kScfLags;   // local lag of the block's first
  const int g = blockIdx.z;
  const int m0 = g * chunk;
  const int m1 = min(m0 + chunk, n_valid);
  // C's first bin: the block's first bin shifted by its first lag, mod N.
  const int c0 = (bin0 + (k0 + lag0) % N) % N;

  double re[kScfPer], im[kScfPer];
#pragma unroll
  for (int j = 0; j < kScfPer; ++j) re[j] = im[j] = 0.0;

  for (int mb = m0; mb < m1; mb += kScfBatch) {
    const int nb = min(kScfBatch, m1 - mb);
    __syncthreads();   // the last batch's values are read
    for (int e = tid; e < nb * kScfBins; e += kScfThreads) {
      const int m = e / kScfBins, q = e % kScfBins;
      a_s[m][q] = __ldg(X + static_cast<size_t>(mb + m) * N + bin0 + q);
    }
    for (int e = tid; e < nb * kScfSpan; e += kScfThreads) {
      const int m = e / kScfSpan, q = e % kScfSpan;
      int col = c0 + q;
      if (col >= N) col -= N;
      c_s[m][q] = __ldg(X + static_cast<size_t>(mb + m) * N + col);
    }
    __syncthreads();
    for (int m = 0; m < nb; ++m) {
      const float2 a = a_s[m][b];
#pragma unroll
      for (int j = 0; j < kScfPer; ++j) {
        const float2 c = c_s[m][b + row + kScfRows * j];
        re[j] += static_cast<double>(c.x * a.x + c.y * a.y);
        im[j] += static_cast<double>(c.y * a.x - c.x * a.y);
      }
    }
  }
  float* out = partial + static_cast<size_t>(g) * 2 * K * N;
#pragma unroll
  for (int j = 0; j < kScfPer; ++j) {
    const int k = lag0 + row + kScfRows * j;
    if (k < K) {
      out[static_cast<size_t>(k) * N + bin0 + b] = static_cast<float>(re[j]);
      out[(static_cast<size_t>(K) + k) * N + bin0 + b] =
          static_cast<float>(im[j]);
    }
  }
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. X: (F, N) complex64 as (F, N, 2) f32;
// the lags k0 .. k0 + K - 1 (0 <= k0, 1 <= K, k0 + K <= N); chunk divides
// F; partial: (F / chunk, 2, K, N) f32 scratch; out: (2, K, N) f32, the
// sums over the frames m < n_valid. N a power of two from 64 to 16384.
// Returns a cudaError_t (0 on success); does not synchronise.
int rpf_fused_psd_scf(const void* X, void* partial, void* out, int device,
                      int N, int F, int K, int k0, int chunk, int n_valid,
                      void* stream) {
  if (N < 64 || N > 16384 || (N & (N - 1)) != 0 || F <= 0 || chunk <= 0 ||
      F % chunk != 0 || K < 1 || k0 < 0 || k0 + K > N || n_valid < 0 ||
      n_valid > F || F / chunk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = F / chunk;
  const dim3 grid(N / kScfBins, (K + kScfLags - 1) / kScfLags, G);
  scf_group_kernel<<<grid, kScfThreads, 0, st>>>(
      static_cast<const float2*>(X), static_cast<float*>(partial), N, K, k0,
      chunk, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_psd_sum(partial, G, 2 * K * N, out, st));
}

// What scf_group_kernel gets on `device`: attrs[0..5] as fused_psd.cu's
// rpf_fused_psd_attributes. Launches nothing.
int rpf_fused_psd_scf_attributes(int device, int* attrs) {
  if (attrs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, scf_group_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = 0;
  attrs[4] = kScfThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &attrs[5], scf_group_kernel, kScfThreads, 0));
}

const char* rpf_cuda_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
