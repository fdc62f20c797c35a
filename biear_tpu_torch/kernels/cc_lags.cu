// Kept-lag binaural cross-correlation for Hopper (sm_90a), full f32 FMA.
//
// Replaces the TPU kernel biear_tpu/ops/window_gather.py::_cc_kernel
// (launched by _cc_pallas, entry cc_kept_lags). Contract, per batch row b:
//
//   out[b, s] = sum_m rf[b, m] * lf[b, m + s - K],   s in [0, 2K],  K <= 63,
//
// with lf taken as zero outside [0, n). Inputs are the mean-removed ears,
// (B, n) f32 row-major; the output is (B, 2K + 1) f32.
//
// What bounds it on this card: at the serving shape (B = 512, n = 16000,
// 97 lags) the work is 2 * B * n * 97 = 1.6 GFLOP of non-tensor-core f32
// against 65.5 MB of input, so the f32 FMA rate bounds it (24 us at the
// 67 TFLOP/s peak; the bytes alone take 20 us at 3.35 TB/s). The TPU design
// (a 128x256 MXU block product plus a log-step lane-roll diagonal
// extraction) exists only because of the TPU and is not carried over.
//
// Design:
//  * Pass 1, one block per (row b, chunk c of 1024 samples of m). The rf
//    chunk and the lf chunk with its lag halo are staged in shared memory,
//    read once from device memory. Warp g owns the 8 consecutive lags
//    s = 8g .. 8g+7; lane t owns the 32-sample run m = 32t .. 32t+31 of the
//    chunk. Each step loads 8 rf and 15 lf values into registers and does
//    an 8x8 outer block of FMAs (64 FMAs per 23 shared loads).
//  * Shared arrays are skewed (index i + i/32) so that the 32 lanes, whose
//    runs start 32 samples apart, hit 32 different banks.
//  * Each warp sums its lanes with a fixed xor-shuffle tree and writes one
//    partial per (b, c, lag). Pass 2 sums the chunks of a row in order:
//    deterministic, no float atomics.
//  * No tensor cores, so no TF32: the sum is plain f32 FMA, like the JAX
//    kernel's Precision.HIGHEST product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRun = 32;                         // samples of m per lane
constexpr int kChunk = kLanes * kRun;            // samples of m per block
constexpr int kLagsPerWarp = 8;
constexpr int kMaxLags = 128;                    // 2 * 63 + 1, padded to 16 warps
constexpr int kLfSpan = kChunk + kMaxLags;       // lf samples a chunk can touch

__host__ __device__ constexpr int skew(int i) { return i + (i >> 5); }

__global__ void cc_lags_partial(const float* __restrict__ lf,
                                const float* __restrict__ rf,
                                float* __restrict__ partial,
                                int n, int max_kept, int n_lags,
                                int n_chunks) {
  __shared__ float rs[skew(kChunk - 1) + 1];
  __shared__ float ls[skew(kLfSpan - 1) + 1];

  const int b = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const int64_t row = static_cast<int64_t>(b) * n;
  const int m0 = c * kChunk;

  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const int m = m0 + i;
    rs[skew(i)] = m < n ? rf[row + m] : 0.0f;
  }
  for (int j = threadIdx.x; j < kLfSpan; j += blockDim.x) {
    const int m = m0 + j - max_kept;
    ls[skew(j)] = (m >= 0 && m < n) ? lf[row + m] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  const int s0 = (threadIdx.x >> 5) * kLagsPerWarp;
  float acc[kLagsPerWarp];
#pragma unroll
  for (int j = 0; j < kLagsPerWarp; ++j) acc[j] = 0.0f;

#pragma unroll
  for (int x = 0; x < kRun; x += kLagsPerWarp) {
    const int m = lane * kRun + x;
    float r[kLagsPerWarp];
    float l[2 * kLagsPerWarp - 1];
#pragma unroll
    for (int i = 0; i < kLagsPerWarp; ++i) r[i] = rs[skew(m + i)];
#pragma unroll
    for (int k = 0; k < 2 * kLagsPerWarp - 1; ++k) l[k] = ls[skew(m + s0 + k)];
#pragma unroll
    for (int i = 0; i < kLagsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kLagsPerWarp; ++j) acc[j] = fmaf(r[i], l[i + j], acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kLagsPerWarp; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int s = s0 + j;
    if (lane == 0 && s < n_lags)
      partial[(static_cast<int64_t>(b) * n_chunks + c) * n_lags + s] = v;
  }
}

__global__ void cc_lags_reduce(const float* __restrict__ partial,
                               float* __restrict__ out, int n_lags,
                               int n_chunks) {
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  if (s >= n_lags) return;
  const float* p = partial + static_cast<int64_t>(b) * n_chunks * n_lags + s;
  float v = 0.0f;
  for (int c = 0; c < n_chunks; ++c) v += p[static_cast<int64_t>(c) * n_lags];
  out[static_cast<int64_t>(b) * n_lags + s] = v;
}

}  // namespace

extern "C" {

// Scratch floats the caller must pass as `partial`.
int64_t cc_lags_partial_floats(int batch, int n, int max_kept) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  return static_cast<int64_t>(batch) * n_chunks * (2 * max_kept + 1);
}

// Launches both passes on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess). The caller checks shapes: 0 < max_kept <= 63, n > 0.
int cc_lags_launch(const float* lf, const float* rf, float* partial,
                   float* out, int batch, int n, int max_kept,
                   void* stream) {
  if (max_kept <= 0 || 2 * max_kept + 1 > kMaxLags || n <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_lags = 2 * max_kept + 1;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int warps = (n_lags + kLagsPerWarp - 1) / kLagsPerWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cc_lags_partial<<<batch * n_chunks, warps * kLanes, 0, s>>>(
      lf, rf, partial, n, max_kept, n_lags, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_lags_reduce<<<batch, kMaxLags, 0, s>>>(partial, out, n_lags, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
