// The dual adaptive frontend's Q-controller step for Hopper (sm_90a): one
// launch takes one frame of both ears' controllers forward.
//
// Replaces no TPU kernel: the JAX package runs the frontend as a lax.scan
// over adaptive_step whose body XLA fuses (no Pallas kernel exists for
// it). The port ran each ear's step as some 30 small kernels a frame; this
// is the port's counterpart of that fusion and the forward twin of
// frontend_bwd.cu, which reads what this writes. Contract
// (models/controller.py: controller_step, once an ear, is the same steps
// in PyTorch ops), per ear e and row b < B of the frame:
//
//   Y_ctrl = log1p(max(Y, 0)) (NaN kept), feat = [Y_ctrl, 0.2 Y_ctrl];
//   the GRU cell as the fused cell computes it: gi = feat W_ih^T, gh = h
//   W_hh^T, r = sigmoid(gi_r + gh_r + b_ih_r + b_hh_r), z likewise, n =
//   tanh(gi_n + b_ih_n + r (gh_n + b_hh_n)), hy = n + z (h - n), workspace
//   ws = [r, z, n, h, gh_n + b_hh_n];
//   a1 = hy W0^T + b0, LayerNorm 1 (mean and 1 / std kept) -> l1, d1 =
//   dropout(SiLU(l1)); a2 = d1 W4^T + b4, LayerNorm 5 -> l2, d2 likewise;
//   delta = tanh(d2 W8^T + b8); qraw = Q0 (1 + dQ delta) (relative) or Q0
//   + dQ delta (absolute); Q = clamp(qraw, q_min, q_max) (NaN kept);
//   the finite reset: a nonfinite Q anywhere in ear e's batch sets that
//   ear's Q' to Q0 and h' to 0, else Q' = Q and h' = hy; ok[e] says which.
//
// It writes Q', h' and every field of the step's saved set (feat, ws, hy,
// a1, l1, mu1, rs1, d1, a2, l2, mu2, rs2, d2, delta, qraw, ok), each
// ear-stacked (2, B, .).
//
// Every product is an f32 FMA (no TF32, no bf16); the elementwise steps
// are one correctly rounded operation each, in the order of the PyTorch
// ops (the __f*_rn intrinsics, which the compiler never contracts; IEEE
// division and square root; the accurate expf, tanhf, log1pf), so only
// the order of the products' sums differs from the composite ops'. That
// order is fixed: two launches give the same bits.
//
// What bounds it on this card: per row, 3 H (n_in + H) + 2 H^2 + N H
// multiply-adds, 171,520 at the flagship's N = 100, H = 128, n_in = 200:
// 0.18 G at its 1,024 rows a frame, 5.3 us at the card's 33.45e12 f32
// FMA/s; about 10 KB a row read and written (12 MB a frame with both
// ears' weights, 3.6 us at 3.35 TB/s). In practice the chain of five
// dependent products is bound by its latency and by each block streaming
// its ear's 690 KB of weights from L2.
//
// Design:
//  * A block of 512 threads takes RT rows of one ear (grid: row tiles x 2
//    ears). RT is 1, 2, 4 or 8, chosen by the caller from the rows it sees
//    so that both ears' blocks make about one a SM: on the H100, at the
//    flagship's 512 rows an ear, 8 rows a block (128 blocks) took 44.3 us
//    a frame, 4 rows 60.0 (and 4 rows in blocks of 256 threads, two a SM,
//    47.0 where 8 rows of 512 took 42.7); at the spirit cell's 64, 1 row
//    a block 25.3 us (32.0 in blocks of 256 threads).
//  * Each step's vectors stay in shared memory, RT rows at a time. A
//    product out[r][j] = sum_i in[r][i] W[j][i] (W row-major, as the
//    parameters are) gives each output column to a team of 8 lanes, and a
//    team CP = 2 or 3 columns at a time: each lane reads float4s of W's
//    rows in turn (the team reads 128 contiguous bytes of a row), keeps 6
//    or 8 loads in flight and CP x RT sums, and each shared-memory read of
//    the input feeds 4 CP multiply-adds (with one column a team in the
//    GRU's input product the reads of the input, not the FMAs, bound it:
//    51.2 us a frame against 42.7 at 8 rows a block). The team's sums
//    meet by a fixed shuffle tree, so every lane holds the same bits.
//    Each block starts at another column, so that the blocks do not all
//    ask L2 for the same lines at once.
//  * The products are inlined with CP fixed at each call: 4 row tiles x
//    5 products build in about 14 s (a CP chosen at run time inlined 3
//    instances a product and built in 60 s).
//  * LayerNorm's row sums are one warp a row, by a fixed shuffle tree
//    (mean, then the mean of squared deviations).
//  * The finite reset needs the whole ear: every block writes Q' and h'
//    as if kept, then counts itself done in a zeroed int32[4] (blocks
//    done and a nonfinite flag per ear); the ear's last block writes ok
//    and, where any block saw a nonfinite Q, overwrites the ear's Q' and
//    h'. No host sync, and it captures and replays (the caller zeroes the
//    counters before each launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTeam = 8;                   // lanes that share a column
constexpr int kTeams = kThreads / kTeam;
constexpr int kChunks = 8;                 // float4 loads a lane has in flight
constexpr int kPtrs = 55;
constexpr int kInts = 6;
constexpr int kFloats = 4;

struct Ear {
  const float* w_ih;   // (3H, n_in)
  const float* w_hh;   // (3H, H)
  const float* b_ih;   // (3H)
  const float* b_hh;   // (3H)
  const float* w0;     // (H, H)
  const float* b0;
  const float* g1;     // LayerNorm 1's weight (H)
  const float* be1;    // and bias
  const float* w4;     // (H, H)
  const float* b4;
  const float* g5;
  const float* be5;
  const float* w8;     // (N, H)
  const float* b8;     // (N)
  const unsigned char* keep0;  // (B, H) dropout keep-masks, or null
  const unsigned char* keep1;
};

struct Params {
  Ear ear[2];
  const float* y;      // (2, B, N) the frame's band energies
  const float* hx;     // (2, B, H) the hidden state
  const float* q0;     // (N)
  const float* dqv;    // (N)
  // outputs, (2, B, .)
  float* q_out;        // N
  float* h_out;        // H
  float* feat;         // n_in
  float* ws;           // 5 H
  float* hy;           // H
  float* a1;
  float* l1;
  float* mu1;          // 1
  float* rs1;          // 1
  float* d1;
  float* a2;
  float* l2;
  float* mu2;
  float* rs2;
  float* d2;
  float* delta;        // N
  float* qraw;         // N
  unsigned char* ok;   // (2)
  int* sync;           // (4) zeroed: blocks done per ear, nonfinite per ear
  int rows, n, h, n_in, relative;
  float q_min, q_max, keep_scale, ln_eps;
  bool vec_in, vec_h;  // float4 loads of w_ih, of the (., H) weights
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / add(1.0f, expf(-x));
}

__device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

// out[r * out_ld + j] = sum_{i < K} in[r * in_ld + i] * W[j * K + i]
// (+ bias[j], then tanh if asked) for j < M, r < RT; in and out in shared
// memory (in_ld a multiple of 4), W read through L2. A team takes CP
// columns at a time, each lane kChunks / CP float4 loads of each, and
// each shared-memory read of the input feeds 4 CP multiply-adds; a
// column's sum is the same whatever CP (each lane adds its chunks in
// order), so the caller picks the CP that fills the fewest passes over
// its M columns at the flagship's widths. The blocks start at different
// columns, so that they do not all ask L2 for the same lines at once.
// Every thread of the block calls it.
template <int RT, int CP>
__device__ void rowdot(const float* __restrict__ W, int K, int M, bool vec,
                       const float* in, int in_ld,
                       const float* __restrict__ bias, bool tanh_out,
                       float* out, int out_ld) {
  constexpr int kCh = kChunks / CP;          // 2 at CP 3
  const int rot = static_cast<int>((blockIdx.x * 2 + blockIdx.y) * 37) % M;
  const int lane = threadIdx.x % kTeam, team = threadIdx.x / kTeam;
  const int K4 = K >> 2;
  for (int s0 = 0; s0 < M; s0 += kTeams * CP) {
    int col[CP];
    bool live[CP];
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int slot = s0 + q * kTeams + team;
      live[q] = slot < M;
      col[q] = live[q] ? (slot + rot) % M : 0;
    }
    float acc[CP][RT];
#pragma unroll
    for (int q = 0; q < CP; ++q)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[q][r] = 0.0f;
    if (vec) {
      for (int c0 = lane; c0 < K4; c0 += kTeam * kCh) {
        float4 w[CP][kCh];
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const float4* wr = reinterpret_cast<const float4*>(
              W + static_cast<size_t>(col[q]) * K);
#pragma unroll
          for (int u = 0; u < kCh; ++u) {
            const int c = c0 + u * kTeam;
            w[q][u] = live[q] && c < K4 ? __ldg(wr + c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kCh; ++u) {
          const int c = c0 + u * kTeam;
          if (c < K4) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float4 a =
                  *reinterpret_cast<const float4*>(in + r * in_ld + 4 * c);
#pragma unroll
              for (int q = 0; q < CP; ++q) {
                acc[q][r] = fmaf(a.x, w[q][u].x, acc[q][r]);
                acc[q][r] = fmaf(a.y, w[q][u].y, acc[q][r]);
                acc[q][r] = fmaf(a.z, w[q][u].z, acc[q][r]);
                acc[q][r] = fmaf(a.w, w[q][u].w, acc[q][r]);
              }
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < CP; ++q) {
        if (!live[q]) continue;
        const float* wr = W + static_cast<size_t>(col[q]) * K;
        for (int i = lane; i < K; i += kTeam) {
          const float w = __ldg(wr + i);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[q][r] = fmaf(in[r * in_ld + i], w, acc[q][r]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CP; ++q) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int o = kTeam / 2; o > 0; o >>= 1)
          acc[q][r] = add(acc[q][r],
                          __shfl_xor_sync(0xffffffffu, acc[q][r], o));
      if (live[q]) {
        const int j = col[q];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (lane == r) {
            float v = acc[q][r];
            if (bias != nullptr) v = add(v, bias[j]);
            if (tanh_out) v = tanhf(v);
            out[r * out_ld + j] = v;
          }
        }
      }
    }
  }
}

// LayerNorm of a ([RT][hp] in shared memory) with weight g and bias be,
// then SiLU and dropout (keep (B, H) of the ear, or null) -> d ([RT][hp]);
// writes a, the LayerNorm's output, its mean and 1 / std and d to the
// block's rows of the outputs. stat: [RT][2] scratch. Ends synchronised.
template <int RT>
__device__ void ln_act(const Params& p, const float* __restrict__ g,
                       const float* __restrict__ be,
                       const unsigned char* __restrict__ keep, const float* a,
                       float* d, float* a_out, float* l_out, float* mu_out,
                       float* rs_out, float* d_out, float* stat, int e,
                       int b0, int nrows) {
  const int H = p.h, hp = pad4(H), B = p.rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float fh = static_cast<float>(H);
  for (int r = warp; r < nrows; r += kThreads / 32) {
    float s = 0.0f;
    for (int j = lane; j < H; j += 32) s = add(s, a[r * hp + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = add(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float mu = s / fh;
    float v = 0.0f;
    for (int j = lane; j < H; j += 32) {
      const float c = sub(a[r * hp + j], mu);
      v = add(v, mul(c, c));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
    const float rs = 1.0f / sqrtf(add(v / fh, p.ln_eps));
    if (lane == 0) {
      stat[2 * r] = mu;
      stat[2 * r + 1] = rs;
      const size_t row = static_cast<size_t>(e) * B + b0 + r;
      mu_out[row] = mu;
      rs_out[row] = rs;
    }
  }
  __syncthreads();
  const float inv_keep = 1.0f / p.keep_scale;
  for (int idx = tid; idx < RT * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    float dv = 0.0f;
    if (r < nrows) {
      const size_t at = (static_cast<size_t>(e) * B + b0 + r) * H + j;
      const float x = a[r * hp + j];
      const float l =
          add(mul(mul(sub(x, stat[2 * r]), stat[2 * r + 1]), g[j]), be[j]);
      dv = l / add(1.0f, expf(-l));
      if (keep != nullptr)
        dv = keep[static_cast<size_t>(b0 + r) * H + j] ? mul(dv, inv_keep)
                                                        : 0.0f;
      a_out[at] = x;
      l_out[at] = l;
      d_out[at] = dv;
    }
    d[r * hp + j] = dv;
  }
  __syncthreads();
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
controller_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_reset;
  const int N = p.n, H = p.h, B = p.rows, NI = p.n_in;
  const int xp = pad4(NI), hp = pad4(H), g3 = pad4(3 * H);
  float* sX = smem;              // feat, later delta
  float* sH = sX + RT * xp;      // h
  float* sGI = sH + RT * hp;     // feat W_ih^T, later a1 and a2
  float* sGH = sGI + RT * g3;    // h W_hh^T, later d1 and d2
  float* sHy = sGH + RT * g3;    // hy
  float* stat = sHy + RT * hp;   // [RT][2] mean, 1 / std

  const int e = blockIdx.y, b0 = blockIdx.x * RT;
  const int nrows = min(RT, B - b0);
  const Ear& E = p.ear[e];
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(e) * B + b0;  // in (2, B, .)

  // the features and the hidden state; rows past the batch are zeros
  for (int idx = tid; idx < RT * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    float yc = 0.0f, ym = 0.0f;
    if (r < nrows) {
      const float y = p.y[(row0 + r) * N + n];
      yc = log1pf(y != y ? y : fmaxf(y, 0.0f));
      ym = mul(0.2f, yc);
      float* f = p.feat + (row0 + r) * NI;
      f[n] = yc;
      f[N + n] = ym;
    }
    sX[r * xp + n] = yc;
    sX[r * xp + N + n] = ym;
  }
  for (int idx = tid; idx < RT * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    sH[r * hp + j] = r < nrows ? p.hx[(row0 + r) * H + j] : 0.0f;
  }
  __syncthreads();

  // the GRU cell: both products, then the fused cell's arithmetic
  // 3 columns a team at a time: 384 columns in two passes of 64 teams
  rowdot<RT, 3>(E.w_ih, NI, 3 * H, p.vec_in, sX, xp, nullptr, false, sGI,
                g3);
  rowdot<RT, 3>(E.w_hh, H, 3 * H, p.vec_h, sH, hp, nullptr, false, sGH, g3);
  __syncthreads();
  for (int idx = tid; idx < RT * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    float hyv = 0.0f;
    if (r < nrows) {
      const float* gi = sGI + r * g3;
      const float* gh = sGH + r * g3;
      const float rg =
          sigmoid(add(add(add(gi[j], gh[j]), E.b_ih[j]), E.b_hh[j]));
      const float zg = sigmoid(
          add(add(add(gi[H + j], gh[H + j]), E.b_ih[H + j]), E.b_hh[H + j]));
      const float hn = add(gh[2 * H + j], E.b_hh[2 * H + j]);
      const float ng = tanhf(add(add(gi[2 * H + j], E.b_ih[2 * H + j]),
                                 mul(rg, hn)));
      const float hx = sH[r * hp + j];
      hyv = add(ng, mul(zg, sub(hx, ng)));
      float* w = p.ws + (row0 + r) * 5 * H;
      w[j] = rg;
      w[H + j] = zg;
      w[2 * H + j] = ng;
      w[3 * H + j] = hx;
      w[4 * H + j] = hn;
      p.hy[(row0 + r) * H + j] = hyv;
    }
    sHy[r * hp + j] = hyv;
  }
  __syncthreads();

  // Linear 0, LayerNorm 1, SiLU, dropout; Linear 4, LayerNorm 5, ...
  // 2 columns a team at a time: 128 (or N = 100) columns in one pass
  rowdot<RT, 2>(E.w0, H, H, p.vec_h, sHy, hp, E.b0, false, sGI, hp);
  __syncthreads();
  ln_act<RT>(p, E.g1, E.be1, E.keep0, sGI, sGH, p.a1, p.l1, p.mu1, p.rs1,
             p.d1, stat, e, b0, nrows);
  rowdot<RT, 2>(E.w4, H, H, p.vec_h, sGH, hp, E.b4, false, sGI, hp);
  __syncthreads();
  ln_act<RT>(p, E.g5, E.be5, E.keep1, sGI, sGH, p.a2, p.l2, p.mu2, p.rs2,
             p.d2, stat, e, b0, nrows);
  // Linear 8 and tanh -> delta
  rowdot<RT, 2>(E.w8, H, N, p.vec_h, sGH, hp, E.b8, true, sX, xp);
  __syncthreads();

  // next Q and the clamp; Q' and h' written as if the ear keeps them
  int bad = 0;
  for (int idx = tid; idx < nrows * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const size_t at = (row0 + r) * N + n;
    const float d = sX[r * xp + n];
    const float dq = mul(p.dqv[n], d);
    const float qr = p.relative ? mul(p.q0[n], add(1.0f, dq))
                                : add(p.q0[n], dq);
    const float qc = qr != qr ? qr : fminf(fmaxf(qr, p.q_min), p.q_max);
    bad |= !(fabsf(qc) <= 3.402823466e38f);  // NaN or infinite
    p.delta[at] = d;
    p.qraw[at] = qr;
    p.q_out[at] = qc;
  }
  for (int idx = tid; idx < nrows * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    p.h_out[(row0 + r) * H + j] = sHy[r * hp + j];
  }
  // every thread's writes are seen device-wide before the block counts
  // itself done
  __threadfence();
  bad = __syncthreads_or(bad);

  // the finite reset, decided by the ear's last block
  if (tid == 0) {
    if (bad) atomicOr(p.sync + 2 + e, 1);
    __threadfence();
    const int done = atomicAdd(p.sync + e, 1);
    int reset = 0;
    if (done == static_cast<int>(gridDim.x) - 1) {
      __threadfence();
      const int any = atomicOr(p.sync + 2 + e, 0);
      p.ok[e] = any ? 0 : 1;
      reset = any;
    }
    s_reset = reset;
  }
  __syncthreads();
  if (s_reset) {
    for (int idx = tid; idx < B * N; idx += kThreads)
      p.q_out[static_cast<size_t>(e) * B * N + idx] = p.q0[idx % N];
    for (int idx = tid; idx < B * H; idx += kThreads)
      p.h_out[static_cast<size_t>(e) * B * H + idx] = 0.0f;
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int RT>
int launch(const Params& p, cudaStream_t stream) {
  const int xp = (p.n_in + 3) & ~3, hp = (p.h + 3) & ~3;
  const int g3 = (3 * p.h + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(RT) * (xp + 2 * hp + 2 * g3) + 2 * RT) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        controller_fwd_kernel<RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.rows + RT - 1) / RT, 2);
  controller_fwd_kernel<RT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 = cudaSuccess).
// ptrs: the kPtrs addresses in the order controller.py::dual_step_cuda
// lists them (per ear: the 14 parameters in controller.PARAM_NAMES' order,
// keep0, keep1; then Y, h, Q0, dQ; the outputs Q', h', feat, ws, hy, a1,
// l1, mu1, rs1, d1, a2, l2, mu2, rs2, d2, delta, qraw, ok; the zeroed
// int32[4]); ints: rows an ear, N, H, n_in, relative, the row tile (1, 2,
// 4 or 8); floats: q_min, q_max, 1 - dropout rate, the LayerNorms' eps.
// The caller checks devices, types, shapes and contiguity; this refuses
// what it cannot take.
int controller_fwd_launch(const uint64_t* ptrs, int n_ptrs, const int* ints,
                          int n_ints, const float* floats, int n_floats,
                          void* stream) {
  if (n_ptrs != kPtrs || n_ints != kInts || n_floats != kFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int k = 0;
  auto f = [&]() { return reinterpret_cast<const float*>(ptrs[k++]); };
  auto o = [&]() { return reinterpret_cast<float*>(ptrs[k++]); };
  auto u8 = [&]() {
    return reinterpret_cast<const unsigned char*>(ptrs[k++]);
  };
  for (int e = 0; e < 2; ++e) {
    Ear& E = p.ear[e];
    E.w_ih = f(); E.w_hh = f(); E.b_ih = f(); E.b_hh = f(); E.w0 = f();
    E.b0 = f(); E.g1 = f(); E.be1 = f(); E.w4 = f(); E.b4 = f();
    E.g5 = f(); E.be5 = f(); E.w8 = f(); E.b8 = f();
    E.keep0 = u8(); E.keep1 = u8();
  }
  p.y = f(); p.hx = f(); p.q0 = f(); p.dqv = f();
  p.q_out = o(); p.h_out = o(); p.feat = o(); p.ws = o(); p.hy = o();
  p.a1 = o(); p.l1 = o(); p.mu1 = o(); p.rs1 = o(); p.d1 = o();
  p.a2 = o(); p.l2 = o(); p.mu2 = o(); p.rs2 = o(); p.d2 = o();
  p.delta = o(); p.qraw = o();
  p.ok = reinterpret_cast<unsigned char*>(ptrs[k++]);
  p.sync = reinterpret_cast<int*>(ptrs[k++]);
  p.rows = ints[0]; p.n = ints[1]; p.h = ints[2]; p.n_in = ints[3];
  p.relative = ints[4];
  const int rt = ints[5];
  p.q_min = floats[0]; p.q_max = floats[1]; p.keep_scale = floats[2];
  p.ln_eps = floats[3];

  if (p.rows <= 0 || p.n <= 0 || p.h <= 0 || p.n_in != 2 * p.n ||
      !(p.keep_scale > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int e = 0; e < 2; ++e) {
    const Ear& E = p.ear[e];
    if (!E.w_ih || !E.w_hh || !E.b_ih || !E.b_hh || !E.w0 || !E.b0 ||
        !E.g1 || !E.be1 || !E.w4 || !E.b4 || !E.g5 || !E.be5 || !E.w8 ||
        !E.b8 || (E.keep0 == nullptr) != (E.keep1 == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!p.y || !p.hx || !p.q0 || !p.dqv || !p.q_out || !p.h_out || !p.feat ||
      !p.ws || !p.hy || !p.a1 || !p.l1 || !p.mu1 || !p.rs1 || !p.d1 ||
      !p.a2 || !p.l2 || !p.mu2 || !p.rs2 || !p.d2 || !p.delta || !p.qraw ||
      !p.ok || !p.sync)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec_h = p.h % 4 == 0;
  p.vec_in = p.n_in % 4 == 0;
  for (int e = 0; e < 2; ++e) {
    const Ear& E = p.ear[e];
    p.vec_h = p.vec_h && aligned16(E.w_hh) && aligned16(E.w0) &&
              aligned16(E.w4) && aligned16(E.w8);
    p.vec_in = p.vec_in && aligned16(E.w_ih);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 4: return launch<4>(p, s);
    case 8: return launch<8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
