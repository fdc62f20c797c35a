// The adaptive frontends' reverse recurrence for Hopper (sm_90a): one
// launch takes one frame of the Q-controllers and filterbank back, both
// ears. Two entries: frontend_bwd_launch (the dual frontend: a controller
// an ear) and single_bwd_launch (the single frontend: one controller on
// both ears' features, its Q repeated for both ears' filterbank rows).
//
// Replaces no TPU kernel: the JAX package trains the frontend as a
// lax.scan over adaptive_step (single_step) whose body and reverse pass
// XLA fuses (no Pallas kernel exists for it). Under autograd the port ran
// the same reverse pass as some 190 small kernels a frame; this is the
// port's counterpart of that fusion. Contract (models/frontend_bwd.py,
// frame_bwd_plain is the same steps in PyTorch ops), per controller, row
// b < B of frame t, with the forward's saved tensors of that frame:
//
//   controller (t < T - 1): the gradients of Q(t + 1) (gq_in) and h(t + 1)
//   (gh_in, or none) back through the finite reset (zero for the whole
//   controller where it reset), the clamp (zero outside [q_min, q_max]),
//   next Q (times Q0 dQ in relative mode, dQ in absolute), tanh, Linear 8,
//   dropout, SiLU, LayerNorm 5, Linear 4, dropout, SiLU, LayerNorm 1,
//   Linear 0 and the GRU cell (gates r, z, n; the fused cell's workspace
//   [r, z, n, h, W_hn h + b_hn]); each row's activation gradients are
//   written to grow for the weight gradients; with an input frame
//   (t > 0), also the gradient of h(t) (gh_out) and, through the GRU's
//   input columns of each ear's Y (dual: 0:N; single: 0:N left, y_right
//   on right, 2N:3N in its features), log1p and clamp, the controller's
//   gradient of Y(t);
//   filterbank (t > 0), per filterbank row: Y's gradient (the backend's
//   plus the controller's), the band phase's VJP, then the "bf16|noxg"
//   filterbank VJP: gY masked by finite, g4 = [gY, gZre, gZim] / den and
//   -(gY Y + gZre Zre + gZim Zim) / den, dQ = -fc / (Q + 1e-8)^2 / bw *
//   sum_c g4_c T_c; gq_out = dQ + the Q output's own gradient (single:
//   dQ_L + dQ_R + gQ_L + gQ_R, left to right).
//
// Every product is an f32 FMA or an f32 multiply (no TF32, no bf16); the
// elementwise steps are one correctly rounded operation each, in the
// order of the PyTorch ops (the __f*_rn intrinsics, which the compiler
// never contracts; IEEE division; the accurate expf), so only the order
// of the products' sums differs from autograd's. That order is fixed:
// two launches give the same bits.
//
// What bounds it on this card: per controller row, the data-gradient
// products are N H + 2 H^2 multiply-adds through Linear 8, 4 and 0, and
// 3 H (H + N) (dual) or 3 H (H + 2 N) (single) through the GRU's weights
// at an input frame: 133,120 at the flagship's N = 100, H = 128, 0.27
// GFLOP at its 1,024 rows a frame, 4.1 us at the card's 67 TFLOP/s f32;
// the saved tensors it reads and the gradients it writes are about 18 MB
// a frame there, 5.5 us at 3.35 TB/s. The weights (532 KB an ear) stay in
// L2 and every block reads them once. The single entry's frame at the
// published width (512 controller rows, 1,024 filterbank rows): 171,520
// multiply-adds a controller row (2.6 us) or 12.9 MB (3.9 us).
//
// Design:
//  * A block of 256 threads takes RT rows of one controller (dual grid:
//    row tiles x 2 ears; single: row tiles). RT is 1, 2, 4 or 8, chosen
//    by the caller from the rows it sees so that the blocks make about
//    two a SM: the chain of dependent products is latency-bound, and
//    resident warps hide it. A single block's row feeds two filterbank
//    rows, b and B + b, and sums their dQ.
//  * Each step's vectors stay in shared memory, RT rows at a time. A
//    product out[r][j] = sum_i in[r][i] W[i][j] streams W from L2 in
//    float4 columns: a thread owns 4 columns and a slice of i, keeps RT x
//    4 accumulators and keeps kAhead loads in flight; the slices' partial
//    sums meet in shared memory and are added in a fixed order.
//  * LayerNorm's two row sums are one warp a row, by a fixed shuffle tree.
//  * Both entries instantiate one inlined body, frame_bwd<RT, kSingle>;
//    what differs (the grid, the ears' Y columns, the two-row dQ sum) sits
//    behind if constexpr, so the dual kernel compiles as a kernel of its
//    own would (its registers at 1, 2, 4, 8 rows: 48, 64, 109, 112, no
//    spills).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 8;        // weight loads a thread keeps in flight
constexpr int kPtrsPerEar = 21;
constexpr int kPtrsShared = 19;
constexpr int kInts = 11;
constexpr int kFloats = 3;

struct Ear {
  const float* w_ih;   // (3H, n_in): only the columns of Y are read
  const float* w_hh;   // (3H, H)
  const float* w0;     // (H, H)
  const float* w4;     // (H, H)
  const float* w8;     // (N, H)
  const float* g1;     // LayerNorm 1's weight (H)
  const float* g5;     // LayerNorm 5's weight (H)
  const float* ws;     // (B, 5H) the fused GRU cell's workspace
  const float* a1;     // (B, H) LayerNorm 1's input
  const float* l1;     // (B, H) its output
  const float* mu1;    // (B) its mean
  const float* rs1;    // (B) its 1 / std
  const float* a2;
  const float* l2;
  const float* mu2;
  const float* rs2;
  const float* delta;  // (B, N) tanh's output
  const float* qraw;   // (B, N) Q before the clamp
  const unsigned char* ok;     // () whether the finite reset kept Q
  const unsigned char* keep0;  // (B, H) dropout keep-masks, or null
  const unsigned char* keep1;
};

struct Params {
  Ear ear[2];          // the single entry uses ear[0]
  // the filterbank's saved set of frame t, rows e B + b
  const float* q;      // (2B, N) the Q it filtered with
  const float* bw;     // (2B, N)
  const float* tsum;   // (2B, N, 4) T
  const float* y;
  const float* zre;
  const float* zim;
  const float* den;
  const unsigned char* finite;
  // the outputs' gradients, (2, B, T, N)
  const float* g_y;
  const float* g_q;
  const float* g_phase;
  const float* gq_in;  // (ears, B, N) gradient of Q(t + 1)
  const float* gh_in;  // (ears, B, H) gradient of h(t + 1), or null
  float* gq_out;       // (ears, B, N) gradient of Q(t)
  float* gh_out;       // (ears, B, H) gradient of h(t)
  float* grow;         // (ears, T - 1, B, 12 H + N) activation gradients
  const float* fc;
  const float* q0;
  const float* dqv;
  int rows, n, h, n_in, t, frames, with_ctrl, with_input, relative;
  int y_right;         // the single controller's column of the right Y
  float q_min, q_max, keep_scale;
  bool vec_h, vec_in;  // float4 loads of the (., H) weights, of w_ih
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

__device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

// Columns of a row of grow (frontend_bwd.py::grow_layout).
struct Cols {
  int gi, gh, a1, l1, lx1, a2, l2, lx2, a3, width;
  __device__ explicit Cols(int H, int N)
      : gi(0), gh(3 * H), a1(6 * H), l1(7 * H), lx1(8 * H), a2(9 * H),
        l2(10 * H), lx2(11 * H), a3(12 * H), width(12 * H + N) {}
};

// out[r * out_ld + j] = sum_{i < K} in[r * in_ld + i] * W[i * ldw + j],
// j < M, r < RT; in and out in shared memory, W read through L2.
template <int RT>
__device__ void matvec(const float* __restrict__ W, int ldw, int K, int M,
                       bool vec, const float* in, int in_ld, float* out,
                       int out_ld, float* red) {
  const int tid = threadIdx.x;
  const int V = vec ? 4 : 1;
  for (int c0 = 0; c0 < M; c0 += kThreads * V) {
    const int cols = min(M - c0, kThreads * V);
    const int slots = (cols + V - 1) / V;
    int span = 32;
    while (span < slots) span *= 2;
    const int groups = kThreads / span;
    const int slot = tid % span, grp = tid / span;
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[r][v] = 0.0f;
    if (slot < slots) {
      const float* wp = W + c0 + slot * V;
      int i = grp;
      if (vec) {
        for (; i + (kAhead - 1) * groups < K; i += kAhead * groups) {
          float4 w[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            w[u] = __ldg(reinterpret_cast<const float4*>(
                wp + static_cast<size_t>(i + u * groups) * ldw));
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float a = in[r * in_ld + i + u * groups];
              acc[r][0] = fmaf(a, w[u].x, acc[r][0]);
              acc[r][1] = fmaf(a, w[u].y, acc[r][1]);
              acc[r][2] = fmaf(a, w[u].z, acc[r][2]);
              acc[r][3] = fmaf(a, w[u].w, acc[r][3]);
            }
        }
        for (; i < K; i += groups) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(
              wp + static_cast<size_t>(i) * ldw));
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = in[r * in_ld + i];
            acc[r][0] = fmaf(a, w.x, acc[r][0]);
            acc[r][1] = fmaf(a, w.y, acc[r][1]);
            acc[r][2] = fmaf(a, w.z, acc[r][2]);
            acc[r][3] = fmaf(a, w.w, acc[r][3]);
          }
        }
      } else {
        for (; i + (kAhead - 1) * groups < K; i += kAhead * groups) {
          float w[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            w[u] = __ldg(wp + static_cast<size_t>(i + u * groups) * ldw);
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
#pragma unroll
            for (int r = 0; r < RT; ++r)
              acc[r][0] = fmaf(in[r * in_ld + i + u * groups], w[u],
                               acc[r][0]);
        }
        for (; i < K; i += groups) {
          const float w = __ldg(wp + static_cast<size_t>(i) * ldw);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[r][0] = fmaf(in[r * in_ld + i], w, acc[r][0]);
        }
      }
      const int ld = span * V;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float* to = red + (grp * RT + r) * ld + slot * V;
        to[0] = acc[r][0];
        if (vec) {
          to[1] = acc[r][1];
          to[2] = acc[r][2];
          to[3] = acc[r][3];
        }
      }
    }
    __syncthreads();
    const int ld = span * V;
    for (int idx = tid; idx < RT * cols; idx += kThreads) {
      const int r = idx / cols, j = idx - r * cols;
      float s = red[r * ld + j];
      for (int g = 1; g < groups; ++g) s = add(s, red[(g * RT + r) * ld + j]);
      out[r * out_ld + c0 + j] = s;
    }
    __syncthreads();
  }
}

// Through dropout (keep or null), SiLU of l and LayerNorm (input a, mean
// mu, 1 / std rs, weight gamma): gd -> ga, each [RT][hp] in shared memory;
// writes the LayerNorm's output gradient, that times x_hat and ga to the
// rows' grow. s_gx, s_xh: [RT][hp] scratch; srow: [RT][2].
template <int RT>
__device__ void act_ln_bwd(const Params& p, const unsigned char* keep,
                           const float* l, const float* a, const float* mu,
                           const float* rs, const float* gamma, int b0,
                           int nrows, const float* gd, float* ga,
                           float* grow0, int off_a, int off_l, int off_lx,
                           float* s_gx, float* s_xh, float* srow) {
  const int H = p.h, hp = pad4(H), width = 12 * H + p.n;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < RT * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    float gx = 0.0f, xh = 0.0f;
    if (r < nrows) {
      const size_t at = static_cast<size_t>(b0 + r) * H + j;
      float g = gd[r * hp + j];
      if (keep != nullptr) g = keep[at] ? g / p.keep_scale : 0.0f;
      const float x = l[at];
      const float sg = 1.0f / add(1.0f, expf(-x));
      const float gl = mul(mul(g, sg), add(1.0f, mul(x, sub(1.0f, sg))));
      xh = mul(sub(a[at], mu[b0 + r]), rs[b0 + r]);
      gx = mul(gl, gamma[j]);
      float* gr = grow0 + static_cast<size_t>(r) * width;
      gr[off_l + j] = gl;
      gr[off_lx + j] = mul(gl, xh);
    }
    s_gx[r * hp + j] = gx;
    s_xh[r * hp + j] = xh;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < RT; r += kWarps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = lane; j < H; j += 32) {
      s1 = add(s1, s_gx[r * hp + j]);
      s2 = add(s2, mul(s_gx[r * hp + j], s_xh[r * hp + j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 = add(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = add(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    if (lane == 0) {
      srow[2 * r] = s1;
      srow[2 * r + 1] = s2;
    }
  }
  __syncthreads();
  const float fh = static_cast<float>(H);
  for (int idx = tid; idx < RT * H; idx += kThreads) {
    const int r = idx / H, j = idx - r * H;
    float v = 0.0f;
    if (r < nrows) {
      v = mul(rs[b0 + r] / fh,
              sub(sub(mul(fh, s_gx[r * hp + j]),
                      mul(s_xh[r * hp + j], srow[2 * r + 1])),
                  srow[2 * r]));
      grow0[static_cast<size_t>(r) * width + off_a + j] = v;
    }
    ga[r * hp + j] = v;
  }
  __syncthreads();
}

// The band phase's and the filterbank's VJP of band n of filterbank row
// `row` (e B + b) at frame t: Y's gradient is the backend's plus, after a
// controller step, the controller's (*gc, its gradient of log1p(max(Y,
// 0)), through log1p and clamp); returns dQ(t) there, without the Q
// output's own gradient.
__device__ __forceinline__ float fb_dq(const Params& p, size_t row, int n,
                                       const float* gc) {
  const size_t at = row * p.n + n;
  const size_t go = (row * p.frames + p.t) * p.n + n;
  const float Y = p.y[at];
  float gy = p.g_y[go];
  if (p.with_ctrl) {
    const float g = Y >= 0.0f ? *gc / add(fmaxf(Y, 0.0f), 1.0f) : 0.0f;
    gy = add(gy, g);
  }
  const float zr = p.zre[at], zi = p.zim[at];
  const float s = sqrtf(add(mul(zr, zr), mul(zi, zi)));
  const float mag = s < 1e-3f ? 1e-3f : s;
  const float u = zi / mag, v = zr / mag;
  const float recip = 1.0f / add(mul(u, u), mul(v, v));
  const float gph = p.g_phase[go];
  const float gu = mul(mul(gph, v), recip), gv = mul(mul(gph, -u), recip);
  const float mm = mul(mag, mag);
  const float gmag = add(mul(-gu, zi) / mm, mul(-gv, zr) / mm);
  const float gss = (s >= 1e-3f ? gmag : 0.0f) / mul(2.0f, s);
  const float gzre = add(gv / mag, mul(2.0f, mul(gss, zr)));
  const float gzim = add(gu / mag, mul(2.0f, mul(gss, zi)));
  const float gym = p.finite[at] ? gy : 0.0f;
  const float dn = p.den[at];
  const float gden = -add(add(mul(gym, Y), mul(gzre, zr)), mul(gzim, zi)) /
                     dn;
  const float4 tv = reinterpret_cast<const float4*>(p.tsum)[at];
  const float s4 = add(add(add(mul(gym / dn, tv.x), mul(gzre / dn, tv.y)),
                           mul(gzim / dn, tv.z)),
                       mul(gden, tv.w));
  const float qe = add(p.q[at], 1e-8f);
  return mul(-p.fc[n] / mul(qe, qe) / p.bw[at], s4);
}

// One frame for a block of RT rows of one controller. Dual (kSingle
// false): the controller of ear blockIdx.y, which reads its ear's Y at
// feature columns 0:N; each row feeds its ear's filterbank row e B + b.
// Single: the shared controller (ear[0]; gq_in, gh_in, gh_out and grow
// have its B rows), which reads the left ear's Y at 0:N and the right's
// at y_right:y_right + N; each row b feeds filterbank rows b and B + b (Q
// repeated for both ears), whose dQ and the Q output's two gradients sum,
// left to right, into the row's gradient of Q(t).
template <int RT, bool kSingle>
__device__ __forceinline__ void frame_bwd(const Params& p) {
  constexpr int kYs = kSingle ? 2 : 1;  // the ears' Y a controller reads
  extern __shared__ __align__(16) float smem[];
  const int N = p.n, H = p.h, B = p.rows;
  const int np = pad4(N), hp = pad4(H), g3 = pad4(3 * H);
  float* sN = smem;                     // [kYs][RT][np]
  float* sH1 = sN + kYs * RT * np;
  float* sH2 = sH1 + RT * hp;
  float* sGI = sH2 + RT * hp;
  float* sGH = sGI + RT * g3;
  float* red = sGH + RT * g3;
  float* srow = red + RT * kThreads * 4;

  const int e = kSingle ? 0 : blockIdx.y, b0 = blockIdx.x * RT;
  const int nrows = min(RT, B - b0);
  const Ear& E = p.ear[e];
  const int tid = threadIdx.x;

  if (p.with_ctrl) {
    const Cols col(H, N);
    float* grow0 = p.grow + (static_cast<size_t>(e * (p.frames - 1) + p.t) *
                                 B + b0) * col.width;
    const bool ok = *E.ok != 0;
    // the finite reset, the clamp, next Q and tanh -> Linear 8's output
    for (int idx = tid; idx < RT * N; idx += kThreads) {
      const int r = idx / N, n = idx - r * N;
      float ga3 = 0.0f;
      if (r < nrows) {
        const size_t at = static_cast<size_t>(b0 + r) * N + n;
        float g = ok ? p.gq_in[static_cast<size_t>(e) * B * N + at] : 0.0f;
        const float qr = E.qraw[at];
        if (!(qr >= p.q_min && qr <= p.q_max)) g = 0.0f;
        const float gd = p.relative ? mul(mul(g, p.q0[n]), p.dqv[n])
                                    : mul(g, p.dqv[n]);
        const float d = E.delta[at];
        ga3 = mul(gd, sub(1.0f, mul(d, d)));
        grow0[static_cast<size_t>(r) * col.width + col.a3 + n] = ga3;
      }
      sN[r * np + n] = ga3;
    }
    __syncthreads();
    matvec<RT>(E.w8, H, N, H, p.vec_h, sN, np, sH1, hp, red);
    act_ln_bwd<RT>(p, E.keep1, E.l2, E.a2, E.mu2, E.rs2, E.g5, b0, nrows,
                   sH1, sH2, grow0, col.a2, col.l2, col.lx2, sGI, sGH, srow);
    matvec<RT>(E.w4, H, H, H, p.vec_h, sH2, hp, sH1, hp, red);
    act_ln_bwd<RT>(p, E.keep0, E.l1, E.a1, E.mu1, E.rs1, E.g1, b0, nrows,
                   sH1, sH2, grow0, col.a1, col.l1, col.lx1, sGI, sGH, srow);
    matvec<RT>(E.w0, H, H, H, p.vec_h, sH2, hp, sH1, hp, red);
    // the GRU cell, as the fused cell's backward
    for (int idx = tid; idx < RT * H; idx += kThreads) {
      const int r = idx / H, j = idx - r * H;
      float grg = 0.0f, gig = 0.0f, gin = 0.0f, ghn = 0.0f, ghx = 0.0f;
      if (r < nrows) {
        float go = sH1[r * hp + j];
        if (ok && p.gh_in != nullptr)
          go = add(go, p.gh_in[(static_cast<size_t>(e) * B + b0 + r) * H +
                               j]);
        const float* w = E.ws + static_cast<size_t>(b0 + r) * 5 * H;
        const float rg = w[j], ig = w[H + j], ng = w[2 * H + j];
        const float hx = w[3 * H + j], hn = w[4 * H + j];
        gig = mul(mul(mul(go, sub(hx, ng)), sub(1.0f, ig)), ig);
        ghx = mul(go, ig);
        gin = mul(mul(go, sub(1.0f, ig)), sub(1.0f, mul(ng, ng)));
        ghn = mul(gin, rg);
        grg = mul(mul(mul(gin, hn), sub(1.0f, rg)), rg);
        float* gr = grow0 + static_cast<size_t>(r) * col.width;
        gr[col.gi + j] = grg;
        gr[col.gi + H + j] = gig;
        gr[col.gi + 2 * H + j] = gin;
        gr[col.gh + j] = grg;
        gr[col.gh + H + j] = gig;
        gr[col.gh + 2 * H + j] = ghn;
      }
      sGI[r * g3 + j] = grg;
      sGI[r * g3 + H + j] = gig;
      sGI[r * g3 + 2 * H + j] = gin;
      sGH[r * g3 + j] = grg;
      sGH[r * g3 + H + j] = gig;
      sGH[r * g3 + 2 * H + j] = ghn;
      sH2[r * hp + j] = ghx;
    }
    __syncthreads();
    if (p.with_input) {
      matvec<RT>(E.w_hh, H, 3 * H, H, p.vec_h, sGH, g3, sH1, hp, red);
      for (int idx = tid; idx < nrows * H; idx += kThreads) {
        const int r = idx / H, j = idx - r * H;
        p.gh_out[(static_cast<size_t>(e) * B + b0 + r) * H + j] =
            add(sH2[r * hp + j], sH1[r * hp + j]);
      }
      // the controller's gradient of its input log1p(max(Y, 0)) of each
      // ear it reads -> sN
#pragma unroll
      for (int k = 0; k < kYs; ++k)
        matvec<RT>(E.w_ih + k * p.y_right, p.n_in, 3 * H, N, p.vec_in, sGI,
                   g3, sN + k * RT * np, np, red);
    }
  }
  if (!p.with_input) return;

  // Y's gradient, the band phase's and the filterbank's VJP -> dQ(t)
  for (int idx = tid; idx < nrows * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const size_t b = static_cast<size_t>(b0 + r);
    if constexpr (kSingle) {
      const size_t bR = static_cast<size_t>(B) + b;
      const float dq = add(fb_dq(p, b, n, sN + r * np + n),
                           fb_dq(p, bR, n, sN + (RT + r) * np + n));
      p.gq_out[b * N + n] =
          add(add(dq, p.g_q[(b * p.frames + p.t) * N + n]),
              p.g_q[(bR * p.frames + p.t) * N + n]);
    } else {
      const size_t row = static_cast<size_t>(e) * B + b;
      p.gq_out[row * N + n] = add(fb_dq(p, row, n, sN + r * np + n),
                                  p.g_q[(row * p.frames + p.t) * N + n]);
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
frontend_bwd_kernel(const __grid_constant__ Params p) {
  frame_bwd<RT, false>(p);
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
single_bwd_kernel(const __grid_constant__ Params p) {
  frame_bwd<RT, true>(p);
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int RT, bool kSingle>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kYs = kSingle ? 2 : 1;
  const int np = (p.n + 3) & ~3, hp = (p.h + 3) & ~3;
  const int g3 = (3 * p.h + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(RT) * (kYs * np + 2 * hp + 2 * g3) +
       static_cast<size_t>(RT) * kThreads * 4 + 2 * RT) * sizeof(float);
  const auto kernel =
      kSingle ? single_bwd_kernel<RT> : frontend_bwd_kernel<RT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.rows + RT - 1) / RT, kSingle ? 1 : 2);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Reads one launch's arguments for `ears` controllers (2: the dual
// entry, 1: the single), refuses what the kernel cannot take and launches.
int parse_and_launch(const uint64_t* ptrs, int n_ptrs, const int* ints,
                     int n_ints, const float* floats, int n_floats,
                     void* stream, int ears) {
  if (n_ptrs != kPtrsPerEar * ears + kPtrsShared || n_ints != kInts ||
      n_floats != kFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int k = 0;
  auto f = [&]() { return reinterpret_cast<const float*>(ptrs[k++]); };
  auto u8 = [&]() {
    return reinterpret_cast<const unsigned char*>(ptrs[k++]);
  };
  for (int e = 0; e < ears; ++e) {
    Ear& E = p.ear[e];
    E.w_ih = f(); E.w_hh = f(); E.w0 = f(); E.w4 = f(); E.w8 = f();
    E.g1 = f(); E.g5 = f(); E.ws = f(); E.a1 = f(); E.l1 = f();
    E.mu1 = f(); E.rs1 = f(); E.a2 = f(); E.l2 = f(); E.mu2 = f();
    E.rs2 = f(); E.delta = f(); E.qraw = f(); E.ok = u8(); E.keep0 = u8();
    E.keep1 = u8();
  }
  p.q = f(); p.bw = f(); p.tsum = f(); p.y = f(); p.zre = f(); p.zim = f();
  p.den = f(); p.finite = u8();
  p.g_y = f(); p.g_q = f(); p.g_phase = f();
  p.gq_in = f(); p.gh_in = f();
  p.gq_out = reinterpret_cast<float*>(ptrs[k++]);
  p.gh_out = reinterpret_cast<float*>(ptrs[k++]);
  p.grow = reinterpret_cast<float*>(ptrs[k++]);
  p.fc = f(); p.q0 = f(); p.dqv = f();
  p.rows = ints[0]; p.n = ints[1]; p.h = ints[2]; p.n_in = ints[3];
  p.t = ints[4]; p.frames = ints[5]; p.with_ctrl = ints[6];
  p.with_input = ints[7]; p.relative = ints[8];
  const int rt = ints[9];
  p.y_right = ints[10];
  p.q_min = floats[0]; p.q_max = floats[1]; p.keep_scale = floats[2];

  // the dual's controllers read their ear's Y at columns 0:N, the single's
  // the left's there and the right's at y_right:y_right + N
  const bool n_in_fits = ears == 2
      ? p.n_in >= p.n && p.y_right == 0
      : p.y_right >= p.n && p.y_right + p.n <= p.n_in;
  if (p.rows <= 0 || p.n <= 0 || p.h <= 0 || !n_in_fits ||
      p.frames <= 0 || p.t < 0 || p.t >= p.frames ||
      (p.with_ctrl && p.t >= p.frames - 1) || (p.with_input && p.t == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!p.g_y || !p.g_q || !p.g_phase)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int e = 0; e < ears && p.with_ctrl; ++e) {
    const Ear& E = p.ear[e];
    if (!E.w_ih || !E.w_hh || !E.w0 || !E.w4 || !E.w8 || !E.g1 || !E.g5 ||
        !E.ws || !E.a1 || !E.l1 || !E.mu1 || !E.rs1 || !E.a2 || !E.l2 ||
        !E.mu2 || !E.rs2 || !E.delta || !E.qraw || !E.ok ||
        (E.keep0 == nullptr) != (E.keep1 == nullptr) || !p.gq_in ||
        !p.grow || !p.q0 || !p.dqv)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.with_input &&
      (!p.q || !p.bw || !p.tsum || !p.y || !p.zre || !p.zim || !p.den ||
       !p.finite || !p.gq_out || !p.fc || (p.with_ctrl && !p.gh_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.with_input && !aligned16(p.tsum))
    return static_cast<int>(cudaErrorMisalignedAddress);
  p.vec_h = p.h % 4 == 0;
  p.vec_in = p.n % 4 == 0 && p.n_in % 4 == 0 && p.y_right % 4 == 0;
  for (int e = 0; e < ears; ++e) {
    const Ear& E = p.ear[e];
    p.vec_h = p.vec_h && aligned16(E.w_hh) && aligned16(E.w0) &&
              aligned16(E.w4) && aligned16(E.w8);
    p.vec_in = p.vec_in && aligned16(E.w_ih);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ears * 16 + rt) {
    case 33: return launch<1, false>(p, s);
    case 34: return launch<2, false>(p, s);
    case 36: return launch<4, false>(p, s);
    case 40: return launch<8, false>(p, s);
    case 17: return launch<1, true>(p, s);
    case 18: return launch<2, true>(p, s);
    case 20: return launch<4, true>(p, s);
    case 24: return launch<8, true>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One launch of the dual frontend's frame on `stream`; returns its
// cudaError_t (0 = cudaSuccess). ptrs: the 61 addresses in the order
// frontend_bwd.py::frame_bwd_cuda lists them (per ear: w_ih, w_hh, w0, w4,
// w8, g1, g5, ws, a1, l1, mu1, rs1, a2, l2, mu2, rs2, delta, qraw, ok,
// keep0, keep1; then q, bw, T, Y, Zre, Zim, den, finite; g_y, g_q,
// g_phase; gq_in, gh_in, gq_out, gh_out, grow; fc, Q0, dQ); ints: rows a
// ear, N, H, n_in, t, T, with_ctrl, with_input, relative, the row tile (1,
// 2, 4 or 8), 0 (the single entry's y_right); floats: q_min, q_max, 1 -
// dropout rate. The caller checks
// devices, types, shapes and contiguity; this refuses what it cannot take.
int frontend_bwd_launch(const uint64_t* ptrs, int n_ptrs, const int* ints,
                        int n_ints, const float* floats, int n_floats,
                        void* stream) {
  return parse_and_launch(ptrs, n_ptrs, ints, n_ints, floats, n_floats,
                          stream, 2);
}

// One launch of the single frontend's frame: as frontend_bwd_launch with
// the one controller's 21 addresses (40 in all), its B rows (the
// filterbank's 2B) and the feature column of the right ear's Y (y_right;
// the left's is 0); gq_in, gh_in, gq_out and gh_out have the controller's
// B rows.
int single_bwd_launch(const uint64_t* ptrs, int n_ptrs, const int* ints,
                      int n_ints, const float* floats, int n_floats,
                      void* stream) {
  return parse_and_launch(ptrs, n_ptrs, ints, n_ints, floats, n_floats,
                          stream, 1);
}

}  // extern "C"
