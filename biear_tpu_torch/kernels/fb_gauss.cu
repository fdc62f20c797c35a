// The adaptive filterbank's per-frame Gaussian build and contraction for
// Hopper (sm_90a), in one pass: the bf16 operands go to the tensor cores
// (mma.sync m16n8k16, f32 sums) straight from the registers they are
// computed in.
//
// Replaces no TPU kernel: the JAX filterbank (biear_tpu/ops/filterbank.py)
// is plain XLA, which fuses the build into its product on the TPU. This is
// that fusion for the port's bf16 operand policy. Contract, per row r < R
// (both ears of a frame: R = 2B), band n < N and bin f < F, with f32
// arithmetic in the order of ops/filterbank.py::_gauss_fast:
//
//   bw  = fc[n] / (Q[r, n] + EPS_Q) + EPS_BW,      s = 1 / (bw * bw),
//   t   = (-0.5 * (f_fft[f] - fc[n])^2) * s,       G = expf(t),
//   Gz2 = G * (-2 t),
//   out[r, n, c] = sum_f bf16(G)   * rhs[r, c, f],      c < 4,
//   T[r, n, c]   = sum_f bf16(Gz2) * rhs[r, c, f]       (when T is wanted),
//
// then the epilogue of _normalise: den = out3 + EPS_NORM, Y = out0 / den
// with nan_to_num, Zre = out1 / den, Zim = out2 / den, finite =
// isfinite(out0 / den), and bw. Every step is one correctly rounded
// operation (the __f*_rn intrinsics, which the compiler never contracts
// into an FMA; IEEE division; the accurate expf, no fast math, no flush to
// zero) and bf16() rounds to nearest even, so G and Gz2 are bit for bit the
// plain path's bf16 operands; the product of two bf16 values is exact in
// f32, so only the order of the f32 sums differs. No term is skipped.
// rhs (R, 4, F) bf16 may be strided (the frame loop passes a view of its
// (T, 2B, 4, F) stack): row and channel strides are arguments, bins are
// contiguous. Q (R, N) f32 with a row stride, fc (N) and f_fft (F) f32.
//
// What bounds it on this card: the arithmetic of the build. At the
// flagship's training frame (R = 1024, N = 100, F = 513) it computes 52.5 M
// Gaussian values: 52.5 M expf, one MUFU.EX2 each (12.6 us at 16 a clock
// on each of 132 SMs at 1,980 MHz), and about 14 other f32 instructions
// each (range reduction of expf, the difference, the squares, the scalings,
// the bf16 packing), 22 us on the FMA pipes. It reads 4.2 MB of rhs and
// writes 4.2 MB (1.3 + 1.3 us at 3.35 TB/s). The plain path instead
// builds and re-reads ten (R, N, F) f32 tensors a frame (3.4 GB) and runs
// the contraction as a GEMM with 4 output columns.
//
// Design:
//  * One block per row r, one warp per 16-band tile of the rhs product
//    (7 warps for N = 100; at most 8, each then takes every 8th tile). The
//    block stages its row of rhs (bf16, zero past F), f_fft, and each
//    band's fc, s and bw in shared memory: 7.7 KB at the flagship's shape.
//  * A warp walks the bins 16 at a time. Each lane computes the 8 values of
//    G (and 8 of Gz2) that its own A fragment of mma.m16n8k16 holds (bands
//    g and g + 8 of the tile, bins 2 q, 2 q + 1, 2 q + 8, 2 q + 9 of the
//    step), packs them to bf16 pairs with one cvt each, and issues one mma
//    against the step's B fragment (the 4 rhs channels as columns 0-3,
//    columns 4-7 zero) for out and one for T. Nothing of G touches memory.
//  * Four accumulators by step modulo 4, added pairwise at the end: no
//    chain of more than 9 sums (the plain path's library GEMM sums 513
//    products in one chain).
//  * Bins past F are masked to 0 in the last step; a tile whose upper 8
//    bands all lie past N computes only its lower 8.
//  * Lanes of quad position 0 and 1 hold columns 0-1 and 2-3 of a band's
//    sums; one shuffle brings them together and lane 0 of each quad writes
//    the band's outputs (T as one 16-byte store).
//  * The order of every sum is fixed: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kTile = 16;        // bands of an mma tile, bins of an mma step

struct Shared {
  __nv_bfloat16* rhs;   // [4][f_pad]
  float* f;             // [f_pad]
  float* fc;            // [n_pad]
  float* s;             // [n_pad]
  float* bw;            // [n_pad]
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// G and Gz2 of one (band, bin), in the plain path's order and roundings
__device__ __forceinline__ void gauss(float f, float fc, float s, float& g,
                                      float& gz2) {
  const float d = __fsub_rn(f, fc);
  const float t = __fmul_rn(__fmul_rn(__fmul_rn(d, d), -0.5f), s);
  g = expf(t);
  gz2 = __fmul_rn(g, __fmul_rn(t, -2.0f));
}

// One 16-bin step of one warp's tile: accumulate into acc_g (and acc_t).
// kRagged masks bins >= n_bins to 0; kHi computes the tile's upper 8
// bands (else their operands are 0).
template <bool kWithT, bool kRagged, bool kHi>
__device__ __forceinline__ void step(const Shared& sh, int f_pad, int n_bins,
                                     int k0, int g, int q, float fc_lo,
                                     float s_lo, float fc_hi, float s_hi,
                                     float (&acc_g)[4], float (&acc_t)[4]) {
  const int f0 = k0 + 2 * q;
  const float2 fa = *reinterpret_cast<const float2*>(sh.f + f0);
  const float2 fb = *reinterpret_cast<const float2*>(sh.f + f0 + 8);
  const float fv[4] = {fa.x, fa.y, fb.x, fb.y};
  uint32_t b0 = 0, b1 = 0;
  if (g < 4) {
    const __nv_bfloat16* row = sh.rhs + g * f_pad + f0;
    b0 = *reinterpret_cast<const uint32_t*>(row);
    b1 = *reinterpret_cast<const uint32_t*>(row + 8);
  }
  // [band lo/hi][bin j]
  float gv[2][4], zv[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gauss(fv[j], fc_lo, s_lo, gv[0][j], zv[0][j]);
    if (kHi) {
      gauss(fv[j], fc_hi, s_hi, gv[1][j], zv[1][j]);
    } else {
      gv[1][j] = 0.0f;
      zv[1][j] = 0.0f;
    }
    if (kRagged && f0 + (j & 1) + (j >> 1) * 8 >= n_bins) {
      gv[0][j] = gv[1][j] = zv[0][j] = zv[1][j] = 0.0f;
    }
  }
  // A fragment: {row g, bins 2q..2q+1}, {row g+8, ..}, {row g, 2q+8..},
  // {row g+8, 2q+8..}
  const uint32_t a_g[4] = {pack_bf16(gv[0][0], gv[0][1]),
                           pack_bf16(gv[1][0], gv[1][1]),
                           pack_bf16(gv[0][2], gv[0][3]),
                           pack_bf16(gv[1][2], gv[1][3])};
  mma_bf16(acc_g, a_g, b0, b1);
  if (kWithT) {
    const uint32_t a_t[4] = {pack_bf16(zv[0][0], zv[0][1]),
                             pack_bf16(zv[1][0], zv[1][1]),
                             pack_bf16(zv[0][2], zv[0][3]),
                             pack_bf16(zv[1][2], zv[1][3])};
    mma_bf16(acc_t, a_t, b0, b1);
  }
}

// All steps of one tile, four accumulators by step modulo 4.
template <bool kWithT, bool kHi>
__device__ __forceinline__ void tile_sums(const Shared& sh, int f_pad,
                                          int n_bins, int g, int q,
                                          float fc_lo, float s_lo,
                                          float fc_hi, float s_hi,
                                          float (&sum_g)[4],
                                          float (&sum_t)[4]) {
  float ag[4][4] = {}, at[4][4] = {};
  const int full = n_bins / kTile;            // steps with every bin < F
  const int steps = f_pad / kTile;
  int k = 0;
  for (; k + 4 <= full; k += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      step<kWithT, false, kHi>(sh, f_pad, n_bins, (k + u) * kTile, g, q,
                               fc_lo, s_lo, fc_hi, s_hi, ag[u], at[u]);
  }
  // the last 0-3 whole steps and the ragged one (steps - full <= 1)
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (k + u < full)
      step<kWithT, false, kHi>(sh, f_pad, n_bins, (k + u) * kTile, g, q,
                               fc_lo, s_lo, fc_hi, s_hi, ag[u], at[u]);
    else if (k + u < steps)
      step<kWithT, true, kHi>(sh, f_pad, n_bins, (k + u) * kTile, g, q,
                              fc_lo, s_lo, fc_hi, s_hi, ag[u], at[u]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum_g[i] = __fadd_rn(__fadd_rn(ag[0][i], ag[1][i]),
                         __fadd_rn(ag[2][i], ag[3][i]));
    sum_t[i] = __fadd_rn(__fadd_rn(at[0][i], at[1][i]),
                         __fadd_rn(at[2][i], at[3][i]));
  }
}

struct Out {
  float* y;
  float* zre;
  float* zim;
  float* den;
  float* bw;
  uint8_t* finite;
  float* t;        // (R, N, 4) or null
};

// one band's epilogue: the four numerators, the four T sums
__device__ __forceinline__ void write_band(const Out& o, size_t at, float bw,
                                           const float (&num)[4],
                                           const float (&tv)[4], bool with_t) {
  const float den = __fadd_rn(num[3], static_cast<float>(1e-8));
  const float y_raw = __fdiv_rn(num[0], den);
  const bool fin = isfinite(y_raw);
  o.y[at] = fin ? y_raw : 0.0f;
  o.zre[at] = __fdiv_rn(num[1], den);
  o.zim[at] = __fdiv_rn(num[2], den);
  o.den[at] = den;
  o.bw[at] = bw;
  o.finite[at] = fin ? 1 : 0;
  if (with_t)
    *reinterpret_cast<float4*>(o.t + 4 * at) =
        make_float4(tv[0], tv[1], tv[2], tv[3]);
}

template <bool kWithT>
__global__ void __launch_bounds__(kMaxWarps * 32)
fb_gauss_kernel(const float* __restrict__ q_in, int q_stride,
                const __nv_bfloat16* __restrict__ rhs, int rhs_row_stride,
                int rhs_c_stride, const float* __restrict__ fc_in,
                const float* __restrict__ f_in, Out o, int n_bands,
                int n_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f_pad = (n_bins + kTile - 1) / kTile * kTile;
  const int n_tiles = (n_bands + kTile - 1) / kTile;
  const int n_pad = n_tiles * kTile;
  Shared sh;
  sh.f = reinterpret_cast<float*>(smem);
  sh.fc = sh.f + f_pad;
  sh.s = sh.fc + n_pad;
  sh.bw = sh.s + n_pad;
  sh.rhs = reinterpret_cast<__nv_bfloat16*>(sh.bw + n_pad);

  const int r = blockIdx.x;
  const __nv_bfloat16* src = rhs + static_cast<size_t>(r) * rhs_row_stride;
  for (int i = threadIdx.x; i < 4 * f_pad; i += blockDim.x) {
    const int c = i / f_pad, f = i - c * f_pad;
    sh.rhs[i] = f < n_bins ? src[static_cast<size_t>(c) * rhs_c_stride + f]
                           : __float2bfloat16_rn(0.0f);
  }
  for (int i = threadIdx.x; i < f_pad; i += blockDim.x)
    sh.f[i] = i < n_bins ? f_in[i] : 0.0f;
  const float* q_row = q_in + static_cast<size_t>(r) * q_stride;
  for (int n = threadIdx.x; n < n_pad; n += blockDim.x) {
    float fc = 0.0f, s = 0.0f, bw = 0.0f;
    if (n < n_bands) {
      fc = fc_in[n];
      bw = __fadd_rn(__fdiv_rn(fc, __fadd_rn(q_row[n],
                                             static_cast<float>(1e-8))),
                     static_cast<float>(1e-8));
      s = __fdiv_rn(1.0f, __fmul_rn(bw, bw));
    }
    sh.fc[n] = fc;
    sh.s[n] = s;
    sh.bw[n] = bw;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  for (int tile = warp; tile < n_tiles; tile += blockDim.x >> 5) {
    const int n_lo = tile * kTile + g, n_hi = n_lo + 8;
    float sum_g[4], sum_t[4];
    if (tile * kTile + 8 < n_bands)
      tile_sums<kWithT, true>(sh, f_pad, n_bins, g, q, sh.fc[n_lo],
                              sh.s[n_lo], sh.fc[n_hi], sh.s[n_hi], sum_g,
                              sum_t);
    else
      tile_sums<kWithT, false>(sh, f_pad, n_bins, g, q, sh.fc[n_lo],
                               sh.s[n_lo], 0.0f, 0.0f, sum_g, sum_t);
    // lane q = 0 of a quad holds columns 0-1, lane q = 1 columns 2-3:
    // sum[0], sum[1] for band g, sum[2], sum[3] for band g + 8
    float up_g[4], up_t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      up_g[i] = __shfl_down_sync(0xffffffffu, sum_g[i], 1);
      up_t[i] = __shfl_down_sync(0xffffffffu, sum_t[i], 1);
    }
    if (q == 0) {
      const size_t row = static_cast<size_t>(r) * n_bands;
      if (n_lo < n_bands) {
        const float num[4] = {sum_g[0], sum_g[1], up_g[0], up_g[1]};
        const float tv[4] = {sum_t[0], sum_t[1], up_t[0], up_t[1]};
        write_band(o, row + n_lo, sh.bw[n_lo], num, tv, kWithT);
      }
      if (n_hi < n_bands) {
        const float num[4] = {sum_g[2], sum_g[3], up_g[2], up_g[3]};
        const float tv[4] = {sum_t[2], sum_t[3], up_t[2], up_t[3]};
        write_band(o, row + n_hi, sh.bw[n_hi], num, tv, kWithT);
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 = cudaSuccess). Shapes
// as above; t_out null computes no T. The caller checks types and shapes;
// this refuses sizes and strides it cannot take and a T buffer off the
// 16-byte grid.
int fb_gauss_launch(const float* q, int q_stride, const void* rhs,
                    int rhs_row_stride, int rhs_c_stride, const float* fc,
                    const float* f_fft, float* y, float* zre, float* zim,
                    float* den, float* bw, unsigned char* finite, float* t_out,
                    int rows, int n_bands, int n_bins, void* stream) {
  if (rows <= 0 || n_bands <= 0 || n_bins <= 0 || q_stride < 0 ||
      rhs_row_stride < 0 || rhs_c_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t_out != nullptr && reinterpret_cast<uintptr_t>(t_out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int f_pad = (n_bins + kTile - 1) / kTile * kTile;
  const int n_tiles = (n_bands + kTile - 1) / kTile;
  const size_t smem = (static_cast<size_t>(f_pad) + 3 * n_tiles * kTile) * 4 +
                      static_cast<size_t>(4) * f_pad * 2;
  const int warps = n_tiles < kMaxWarps ? n_tiles : kMaxWarps;
  const Out o{y, zre, zim, den, bw, finite, t_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* r16 = static_cast<const __nv_bfloat16*>(rhs);
  auto kernel = t_out != nullptr ? fb_gauss_kernel<true>
                                 : fb_gauss_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<rows, warps * 32, smem, s>>>(q, q_stride, r16, rhs_row_stride,
                                        rhs_c_stride, fc, f_fft, o, n_bands,
                                        n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
