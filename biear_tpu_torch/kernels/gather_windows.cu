// Sample-granular window gather for Hopper (sm_90a): a bit-exact copy.
//
// Replaces the TPU kernel biear_tpu/ops/window_gather.py::_window_kernel
// (launched by _gather_windows_pallas, entry gather_windows), and with it
// the two variants of the same gather in tools/bench_win_kernel.py
// (kern_chunk, kern_aligned). Contract, per window x:
//
//   out[x, t] = pool[row(x) * row_len + off(x) + t],   t < 16384,
//
// row(x) = clamp(rows[x], 0, NP - 1), off(x) = clamp(offs[x], 0,
// row_len - 16384) (the clamping of lax.dynamic_slice). pool is the padded
// (NP, row_len) f32 pool; out is (X, 16384) f32, row-major.
//
// What bounds it on this card: bytes. It does no arithmetic; it reads and
// writes X * 64 KB, i.e. 201 MB at the training shape X = 1536 (0.060 ms
// at 3.35 TB/s) and 403 MB at the tool's X = 3072 (0.120 ms). The TPU
// design (a whole padded row DMA'd into VMEM, then a dynamic sublane slice
// and a lane roll across the block boundary) exists because a TPU moves
// aligned (8, 128) tiles; here any offset can be read directly.
//
// Design: one block per (window, quarter of the window). The block reads
// its 4096 samples from the unaligned offset with coalesced 4-byte loads
// (neighbouring threads on neighbouring addresses) into shared memory,
// then each thread writes four consecutive samples as one aligned 16-byte
// store. Each sample is read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16384;
constexpr int kThreads = 256;
constexpr int kChunk = 4096;                     // samples per block
constexpr int kChunks = kWin / kChunk;

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const float* __restrict__ pool,
                      const int* __restrict__ rows,
                      const int* __restrict__ offs,
                      float* __restrict__ out, int n_rows, int row_len) {
  __shared__ __align__(16) float s[kChunk];
  const int x = blockIdx.x / kChunks;
  const int c = blockIdx.x % kChunks;
  const int row = min(max(rows[x], 0), n_rows - 1);
  const int off = min(max(offs[x], 0), row_len - kWin);
  const float* src = pool + static_cast<int64_t>(row) * row_len + off
                     + c * kChunk;
#pragma unroll
  for (int k = 0; k < kChunk / kThreads; ++k)
    s[threadIdx.x + k * kThreads] = __ldg(src + threadIdx.x + k * kThreads);
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(
      out + static_cast<int64_t>(x) * kWin + c * kChunk);
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int k = 0; k < kChunk / 4 / kThreads; ++k)
    dst[threadIdx.x + k * kThreads] = s4[threadIdx.x + k * kThreads];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess). The caller checks shapes and types.
int gather_windows_launch(const float* pool, const int* rows, const int* offs,
                          float* out, int n_rows, int row_len, int n_windows,
                          void* stream) {
  if (n_rows <= 0 || row_len < kWin || n_windows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_windows_kernel<<<n_windows * kChunks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pool, rows, offs, out, n_rows, row_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
