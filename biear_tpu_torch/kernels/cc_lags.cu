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
// 67 TFLOP/s peak; the bytes alone take 20 us at 3.35 TB/s). An SM starts
// four FMA warp instructions a clock but moves only 128 bytes of shared
// memory, so the inner loop must do well over 4 FMAs per value it loads,
// and every instruction that is not an FMA costs an FMA's slot. The
// TPU design (a 128x256 MXU block product plus a log-step lane-roll
// diagonal extraction) exists only because of the TPU and is not carried
// over.
//
// Design:
//  * One block of four warps per row, one launch. The block walks the row
//    in chunks of kChunk samples and keeps its sums in registers; the
//    shuffle tree and the store run once per row. No partial buffer, no
//    second pass.
//  * An SM has four warp schedulers and a block's warps go to them in
//    turn, so a block has exactly four warps (at the serving shape, on an
//    NVIDIA H100 80GB HBM3 at 700 W, five warps of 20 lags took 0.050 ms,
//    four of 25 lags 0.045 ms).
//    Warp g owns the S + 1 lags
//    s = S g .. S g + S, with S the smallest of 8, 16, 24, 32 that covers
//    the lags: 4 S + 1 >= 2 K + 1. For K = 48, S = 24 and
//    the four warps cover the 97 lags exactly (neighbours share one lag).
//    Lane t owns the kRun consecutive samples m = 20 t .. 20 t + 19 of
//    each 640-sample pass.
//  * A sliding register window: a lane walks its run four samples a step.
//    A step loads 4 rf values and only the 4 newest lf values (two 16-byte
//    shared loads) and does 4 (S + 1) FMAs; the other lf values of its
//    (S + 4)-wide window stay in registers from the step before (the loop
//    is fully unrolled, so nothing is moved). 0.08 loaded values per FMA
//    at S = 24.
//  * kRun = 20 floats is an odd number of 16-byte words, so the 8 lanes of
//    a 16-byte load phase hit 8 different bank groups without any skew.
//  * The next chunks' rf and lf (with the lag halo) arrive by cp.async into
//    a ring of kStages buffers while this chunk is used: 16 bytes a copy
//    where K, n and the pointers are multiples of 4 floats, else 4 bytes;
//    one __syncthreads() per chunk.
//  * Each chunk's 40 terms per lane are summed from zero and then added to
//    the row's running sum, so no long chain of f32 adds builds up (one
//    chain over the whole row missed the tolerance by 4e-6). The order is
//    fixed (chunks, passes and steps in m order per lane, then a fixed
//    xor-shuffle tree): deterministic, no atomics.
//  * No tensor cores, so no TF32: plain f32 FMA, like the JAX kernel's
//    Precision.HIGHEST product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                        // one per warp scheduler
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 20;                         // samples per lane and pass
constexpr int kPass = 32 * kRun;                 // samples per warp pass
constexpr int kPasses = 2;                       // passes per chunk
constexpr int kChunk = kPass * kPasses;
constexpr int kStages = 3;

static_assert(kRun % 4 == 0 && (kRun / 4) % 2 == 1,
              "a lane's run must be an odd number of 16-byte words");

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// S = lags between the first lags of two warps (a multiple of 4, so that a
// warp's first lag is 16-byte aligned); V = floats per staging copy (4
// needs K % 4 == 0, n % 4 == 0 and 16-byte aligned rows).
template <int S, int V>
__global__ void __launch_bounds__(kThreads)
cc_lags_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
               float* __restrict__ out, int n, int max_kept, int n_lags) {
  constexpr int kLags = S + 1;                   // lags per warp
  constexpr int kWindow = S + 4;                 // lf values held per lane
  constexpr int kLfSpan = kChunk + kWarps * S;        // lf a chunk can touch
  __shared__ __align__(16) float rs[kStages][kChunk];
  __shared__ __align__(16) float ls[kStages][kLfSpan];

  const int b = blockIdx.x;
  const float* lrow = lf + static_cast<int64_t>(b) * n;
  const float* rrow = rf + static_cast<int64_t>(b) * n;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  // chunk c: rs[i] = rf[c kChunk + i], ls[j] = lf[c kChunk + j - K]
  auto stage = [&](int c) {
    if (c < n_chunks) {
      float* r = rs[c % kStages];
      float* l = ls[c % kStages];
      const int m0 = c * kChunk;
      for (int i = V * threadIdx.x; i < kChunk; i += V * kThreads) {
        if (m0 + i < n) {
          cp_async<4 * V>(r + i, rrow + m0 + i);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) r[i + v] = 0.0f;
        }
      }
      for (int j = V * threadIdx.x; j < kLfSpan; j += V * kThreads) {
        const int m = m0 + j - max_kept;
        if (m >= 0 && m < n) {
          cp_async<4 * V>(l + j, lrow + m);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) l[j + v] = 0.0f;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = warp * S;
  float tot[kLags];
#pragma unroll
  for (int j = 0; j < kLags; ++j) tot[j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();
    stage(c + kStages - 1);          // into the buffer chunk c - 1 has left
    const float* r = rs[c % kStages];
    const float* l = ls[c % kStages];
    float acc[kLags];
#pragma unroll
    for (int j = 0; j < kLags; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (c * kChunk + p * kPass >= n) break;
      const int x0 = p * kPass + lane * kRun;
      const float4* r4 = reinterpret_cast<const float4*>(r + x0);
      const float4* l4 = reinterpret_cast<const float4*>(l + x0 + s0);
      float w[kWindow];              // lf[x + s0 .. x + s0 + S + 3]
#pragma unroll
      for (int k = 0; k < kWindow / 4; ++k) {
        const float4 v = l4[k];
        w[4 * k] = v.x; w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < kRun / 4; ++t) {
        const float4 rv = r4[t];
        float4 nx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t + 1 < kRun / 4) nx = l4[kWindow / 4 + t];
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kLags; ++j)
            acc[j] = fmaf(rr[i], w[i + j], acc[j]);
#pragma unroll
        for (int k = 0; k < S; ++k) w[k] = w[k + 4];
        w[S] = nx.x; w[S + 1] = nx.y; w[S + 2] = nx.z; w[S + 3] = nx.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kLags; ++j) tot[j] += acc[j];
  }

  // a warp's last lag is its neighbour's first: the neighbour writes it
#pragma unroll
  for (int j = 0; j < kLags; ++j) {
    float v = tot[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && (j < S || warp == kWarps - 1) && s0 + j < n_lags)
      out[static_cast<int64_t>(b) * n_lags + s0 + j] = v;
  }
}

template <int S>
int launch(const float* lf, const float* rf, float* out, int batch, int n,
           int max_kept, cudaStream_t stream) {
  const int n_lags = 2 * max_kept + 1;
  const bool vec = max_kept % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(lf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rf) % 16 == 0;
  if (vec)
    cc_lags_kernel<S, 4><<<batch, kThreads, 0, stream>>>(lf, rf, out, n,
                                                        max_kept, n_lags);
  else
    cc_lags_kernel<S, 1><<<batch, kThreads, 0, stream>>>(lf, rf, out, n,
                                                        max_kept, n_lags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 = cudaSuccess). The
// caller checks shapes: 0 < max_kept <= 63, n > 0.
int cc_lags_launch(const float* lf, const float* rf, float* out, int batch,
                   int n, int max_kept, void* stream) {
  if (max_kept <= 0 || max_kept > 64 || n <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // S = the smallest multiple of 8 with kWarps * S >= 2 K
  if (max_kept <= 16) return launch<8>(lf, rf, out, batch, n, max_kept, s);
  if (max_kept <= 32) return launch<16>(lf, rf, out, batch, n, max_kept, s);
  if (max_kept <= 48) return launch<24>(lf, rf, out, batch, n, max_kept, s);
  return launch<32>(lf, rf, out, batch, n, max_kept, s);
}

}  // extern "C"
