// Sample-granular window gather for Hopper (sm_90a): a bit-exact copy, with
// L2 hints that keep the pool resident while the windows stream out.
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
// (NP, row_len) f32 pool, 16-byte aligned with row_len % 4 == 0; out is
// (X, 16384) f32, row-major.
//
// What bounds it on this card: bytes. It does no arithmetic. The least it
// must move is the windows written once (X * 64 KB) and the pool span they
// cover read once: at the training shape (X = 1536 windows on the
// synthesizer's 256-row pool) 100.7 + 17.0 MB, 0.0351 ms at 3.35 TB/s.
// Windows overlap: each pool row is read by about six of them, so a copy
// that fetches every window from device memory moves 201 MB instead. The
// pool (17.4 MB) fits in the 50 MB L2; the design keeps it there while
// the 100.7 MB of windows stream through: every pool read carries an L2
// evict_last hint and every window write an evict_first hint, so that
// device memory sees the pool about once and the windows once. The TPU
// design (a whole padded row DMA'd into VMEM, a dynamic sublane slice and
// a lane roll across the block boundary) exists because a TPU moves
// aligned (8, 128) tiles.
//
// Design, a register streaming copy: the output is cut into tiles of
// 16 KB (4096 samples), tile t being chunk t % 4 of window t / 4, so the
// tiles, in order, are the output; a grid of at most kBlocksPerSm blocks
// of 256 threads per SM walks them with a grid stride (X = 3 is 12
// tiles). A tile's samples start `shift` = 0-3 samples past a 16-byte
// boundary of the pool. Each thread loads 4 aligned 16-byte pieces of the
// tile's span and, when shift > 0, the 4 pieces after them (8 loads in
// flight; the span then ends 4 samples later, still inside the row, whose
// length is a multiple of 4), selects the 4 samples `shift` into each
// pair and
// writes them with 16-byte stores. Each sample is read once from the pool
// (through L2) and written once; the result is a bit-exact copy.
//
// Measured against it and dropped (PERF.md §6):
// the same tiles moved by bulk asynchronous copies through shared memory
// (cp.async.bulk of each span into a ring of stages, the shift into an
// out-buffer, cp.async.bulk back out), 2-5 % faster at X = 1536 and
// 3072 but 28-43 % slower at the demo's and the runner's X = 3 and 192,
// where its chain of waits per tile sets the time. A TMA tensor load
// (cp.async.bulk.tensor) at the window's own element coordinate would
// need no shift, but on the H100 such a load stops the kernel with
// cudaErrorIllegalInstruction unless the innermost coordinate times the
// element size is a multiple of 16 bytes (f32 coordinates 32 and 36 load,
// 37, 38 and -3 stop; a Triton tensor-descriptor load at 37 stops the
// same way), so it could only fetch the same aligned span.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16384;             // samples of a window
constexpr int kChunk = 4096;            // samples of a tile: 16 KB
constexpr int kChunks = kWin / kChunk;  // 4 tiles a window
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;         // the fastest measured, PERF.md §6
constexpr int kPieces = kChunk / 4 / kThreads;   // 16-byte, a thread
// L2 cache policies: what createpolicy.fractional.L2::evict_last.b64 and
// ::evict_first.b64 with fraction 1.0 return (CUTLASS's CacheHintSm90);
// as constants they spare every block that instruction's latency
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;

// the four samples that start `shift` samples into a, continuing into n
__device__ __forceinline__ float4 shifted(float4 a, float4 n, int shift) {
  switch (shift) {
    case 0: return a;
    case 1: return make_float4(a.y, a.z, a.w, n.x);
    case 2: return make_float4(a.z, a.w, n.x, n.y);
    default: return make_float4(a.w, n.x, n.y, n.z);
  }
}

__device__ __forceinline__ float4 load_pool(const float* p, uint64_t policy) {
  float4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_window(float* p, float4 v,
                                             uint64_t policy) {
  asm volatile(
      "st.global.L1::no_allocate.L2::cache_hint.v4.f32"
      " [%0], {%1, %2, %3, %4}, %5;\n"
      :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const float* __restrict__ pool,
                      const int* __restrict__ rows,
                      const int* __restrict__ offs,
                      float* __restrict__ out, int n_rows, int row_len,
                      int n_tiles) {
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int x = t / kChunks;
    const int row = min(max(__ldg(rows + x), 0), n_rows - 1);
    const int off = min(max(__ldg(offs + x), 0), row_len - kWin);
    const int64_t first = static_cast<int64_t>(row) * row_len + off
                          + (t % kChunks) * kChunk;
    const int shift = static_cast<int>(first & 3);
    const float* span = pool + (first - shift);
    float4 a[kPieces], n[kPieces];
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int k = threadIdx.x + j * kThreads;
      a[j] = load_pool(span + 4 * k, kEvictLast);
      n[j] = shift ? load_pool(span + 4 * k + 4, kEvictLast) : a[j];
    }
    float* dst = out + static_cast<int64_t>(t) * kChunk;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int k = threadIdx.x + j * kThreads;
      store_window(dst + 4 * k, shifted(a[j], n[j], shift), kEvictFirst);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` with at most kBlocksPerSm blocks per SM. Returns
// the cudaError_t of the launch (0 = cudaSuccess). The caller checks
// shapes, types and the pool's 16-byte alignment.
int gather_windows_launch(const float* pool, const int* rows, const int* offs,
                          float* out, int n_rows, int row_len, int n_windows,
                          void* stream) {
  if (n_rows <= 0 || row_len < kWin || row_len % 4 || n_windows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // SM count per device, read once
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = n_windows * kChunks;
  const int blocks = kBlocksPerSm * sms[dev];
  gather_windows_kernel<<<n_tiles < blocks ? n_tiles : blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pool, rows, offs, out, n_rows, row_len, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
