// Fused window gather + block-Toeplitz HRIR mix for Hopper (sm_90a).
//
// Replaces the TPU kernel biear_tpu/ops/window_gather.py::_mix_kernel
// (launched by _gather_mix_pallas, entry gather_mix_kb): the HRIR
// convolution of on-device anechoic synthesis under the bf16 mix policy.
// Contract, per window x, frame f < nf and column c < 256 (ear * 128 + i):
//
//   out[x, f, c] = sum_{j < ncol} bf16(win_x[128 f + j]) * kb[m(x), j, c],
//   win_x[t] = pool[row(x) * row_len + off(x) + t],
//
// with f32 sums. row(x), off(x) are clamped like lax.dynamic_slice (off so
// that the 16384-sample window stays in the row), m(x) = clamp(meas[x], 0,
// M - 1). bf16() is round-to-nearest-even (__float2bfloat16_rn, as JAX's
// astype). The product of two bf16 values is exact in f32, so only the
// order of the sums differs from the plain version. pool (NP, row_len) f32,
// kb (M, ncol, 256) bf16 with ncol % 128 == 0, out (X, nf, 256) f32.
//
// What bounds it on this card: at the training shape (X = 1536 windows,
// nf = 125, ncol = 384, a 32-entry bank) it reads ~100 MB of pool rows and
// the 6.3 MB bank and writes 196.6 MB, ~303 MB in all (0.090 ms at
// 3.35 TB/s); its 37.7 GFLOP take 0.038 ms on bf16 tensor cores. So bytes
// bound the function. This first kernel runs the products as plain f32
// FMAs, which caps it near 37.7 GFLOP / 67 TFLOP/s = 0.56 ms; tensor cores
// (mma / wgmma), grouping windows by measurement to reuse a bank tile, and
// TMA are the next steps. The TPU design (the whole bank resident in VMEM,
// a sublane-roll halo framing, an ears-major transposed store) answers TPU
// limits and is not carried over: the output here is (X, nf, 256).
//
// Design: one block of 256 threads per (window x, tile of 64 frames), for
// all 256 columns. The bank rows stream through shared memory in tiles of
// 32 rows (bf16 -> f32 on the way in, 16-byte coalesced loads); the
// matching 32 x 64 slice of the framed window is read from the pool,
// rounded to bf16 and stored transposed, so that a thread reads its 8
// frames as two 16-byte words. Each thread keeps an 8 frame x 8 column
// block of sums in registers (columns 4g..4g+3 of both ears) and does 64
// FMAs per 4 shared-memory loads. Sums run in j order: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16384;
constexpr int kCols = 256;       // 2 ears x 128 samples of a frame
constexpr int kBM = 64;          // frames per block
constexpr int kBK = 32;          // bank rows per shared tile
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
gather_mix_kb_kernel(const float* __restrict__ pool,
                     const int* __restrict__ rows,
                     const int* __restrict__ offs,
                     const int* __restrict__ meas,
                     const __nv_bfloat16* __restrict__ kb,
                     float* __restrict__ out, int n_rows, int row_len,
                     int n_meas, int ncol, int nf, int f_tiles) {
  __shared__ __align__(16) float As[kBK][kBM];      // As[j][f] = frame f, row j
  __shared__ __align__(16) float Bs[kBK][kCols];    // bank rows j, all columns

  const int x = blockIdx.x / f_tiles;
  const int f0 = (blockIdx.x % f_tiles) * kBM;
  const int row = min(max(rows[x], 0), n_rows - 1);
  const int off = min(max(offs[x], 0), row_len - kWin);
  const int m = min(max(meas[x], 0), n_meas - 1);
  const float* win = pool + static_cast<int64_t>(row) * row_len + off;
  const __nv_bfloat16* bank = kb + static_cast<int64_t>(m) * ncol * kCols;

  // thread tile: frames fg*8 .. fg*8+7, columns 4cg..4cg+3 and 128+4cg..
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fg = 2 * (warp & 3) + (lane >> 4);      // 0..7
  const int cg = 16 * (warp >> 2) + (lane & 15);    // 0..31

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int j0 = 0; j0 < ncol; j0 += kBK) {
    // window slice: As[jj][f] = bf16(win[128 (f0 + f) + j0 + jj]); frames
    // past nf read nothing (the coverage check keeps the rest in the window)
#pragma unroll
    for (int k = 0; k < kBK * kBM / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int f = e % kBM;
      const int jj = e / kBM;
      float v = 0.0f;
      if (f0 + f < nf)
        v = __bfloat162float(__float2bfloat16_rn(
            __ldg(win + 128 * (f0 + f) + j0 + jj)));
      As[jj][f] = v;
    }
    // bank rows j0 .. j0+31, eight bf16 per 16-byte load
#pragma unroll
    for (int k = 0; k < kBK * kCols / 8 / kThreads; ++k) {
      const int v = threadIdx.x + k * kThreads;
      const int jj = v / (kCols / 8);
      const int c8 = (v % (kCols / 8)) * 8;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          bank + static_cast<int64_t>(j0 + jj) * kCols + c8));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float4 lo, hi;
      float2 t;
      t = __bfloat1622float2(h[0]); lo.x = t.x; lo.y = t.y;
      t = __bfloat1622float2(h[1]); lo.z = t.x; lo.w = t.y;
      t = __bfloat1622float2(h[2]); hi.x = t.x; hi.y = t.y;
      t = __bfloat1622float2(h[3]); hi.z = t.x; hi.w = t.y;
      *reinterpret_cast<float4*>(&Bs[jj][c8]) = lo;
      *reinterpret_cast<float4*>(&Bs[jj][c8 + 4]) = hi;
    }
    __syncthreads();

#pragma unroll 8
    for (int jj = 0; jj < kBK; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[jj][fg * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[jj][fg * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[jj][4 * cg]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[jj][128 + 4 * cg]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = f0 + fg * 8 + i;
    if (f < nf) {
      float* o = out + (static_cast<int64_t>(x) * nf + f) * kCols;
      *reinterpret_cast<float4*>(o + 4 * cg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 128 + 4 * cg) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess). The caller checks shapes, types and the window
// coverage (128 (nf - 1) + ncol <= 16384).
int gather_mix_kb_launch(const float* pool, const int* rows, const int* offs,
                         const int* meas, const void* kb, float* out,
                         int n_rows, int row_len, int n_meas, int ncol,
                         int n_windows, int nf, void* stream) {
  if (n_rows <= 0 || row_len < kWin || n_meas <= 0 || ncol <= 0 ||
      ncol % 128 != 0 || n_windows <= 0 || nf <= 0 ||
      128 * (nf - 1) + ncol > kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int f_tiles = (nf + kBM - 1) / kBM;
  gather_mix_kb_kernel<<<n_windows * f_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pool, rows, offs, meas, static_cast<const __nv_bfloat16*>(kb), out,
      n_rows, row_len, n_meas, ncol, nf, f_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
