// The frame spectra for Hopper (sm_90a): every frame's windowed DFT as
// one real FFT in f32, written straight into the form its reader takes.
//
// Replaces no TPU kernel. It is the counterpart of XLA's DFT product in
// biear_tpu/models/frontend.py: under the bf16 policy the JAX frontend
// (and the port's plain path, ops/spectra.py::dft_plain) takes the
// spectra as an f32 product of the frames against the windowed cos / sin
// bases (win x F), then stacks [mag, re, im, 1] for the filterbank.
// Contract, per row r < R, frame t < T and bin k < F = n_fft / 2 + 1:
//
//   x[n] = frames[r, t, n] * window[n],                    n < win,
//   X[k] = sum_{n < win} x[n] e^{-2 pi i k n / n_fft},
//   mag  = sqrt(re * re + im * im),
//
// which for win <= n_fft is the rFFT of the zero-padded frame (a longer
// frame folds modulo n_fft, as the product with the bases does). The
// frames are read in place from the waveform: row and frame strides are
// arguments, samples are contiguous, so the framing (hop 842 at the
// flagship's shape) happens here. n_fft is a power of two, 2 to 4096.
//
// Two output forms, one body (kRhs):
//  * rhs: the adaptive frontends' filterbank operand, both ears in one
//    launch (rows 0 to B - 1 the left ear's, B to 2B - 1 the right's),
//    (R, T, 4, F) bf16 = [mag, re, im, 1] rounded to nearest even: the
//    layout of torch.cat([stack_rhs(L), stack_rhs(R)]), whose transpose
//    is the frame loop's (T, 2B, 4, F) view;
//  * f32: (R, T, F) mag and, unless their pointers are null, re and im
//    (the fixed-Q path reads all three, AuralNet only mag).
//
// What bounds it on this card: its bytes. At the flagship's training step
// (R = 1,024 rows of both ears, T = 19, win 842, F = 513) it reads 65.5 MB
// of waveform and writes 79.8 MB of rhs: 43 us at 3.35 TB/s. The FFT is
// about 34 k operations a frame, 0.66 GFLOP a launch, 10 us at the f32
// rate. The plain path instead runs the DFT as four f32 GEMMs (33.6 GFLOP,
// about 2 ms) and then writes and re-reads the f32 spectra four times on
// the way to the bf16 stack.
//
// Design, against the bytes:
//  * One block of 64 threads a frame (R x T blocks): every sample is read
//    once from global memory and every output byte written once; nothing
//    between is stored outside shared memory.
//  * The real frame is packed into half as many complex points (even
//    samples real, odd imaginary), windowed and folded on the way in;
//    a Stockham FFT of M = n_fft / 2 points (radix 8, then 4 or 2) runs
//    between two shared buffers (2 x 4.25 KB at M = 512, a pad word every
//    16 points keeps the radix-8 scatter free of bank conflicts), and one
//    split pass turns the M points into the F bins, computes mag and
//    writes each plane with consecutive bins on consecutive lanes.
//  * Twiddles come from two tables that the host builds in float64 once a
//    device (e^{-2 pi i j / M} and e^{-2 pi i k / n_fft}, rounded to f32).
//  * Many blocks of 64 threads share an SM (8.5 KB of shared memory
//    each), so while some frames wait on their loads others run their
//    passes and stores; a version that issued a thread's loads together
//    (8-byte pairs, the loop unrolled) was only 2 % faster.
//  * Every sum has a fixed order: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;      // one frame a block
constexpr int kMaxFft = 4096;

// shared index of complex point i: a pad word pair every 16 points
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int padded(int m) { return m + (m >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-register DFTs of R points, outputs in natural order.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 s = cadd(a, b), d = csub(a, b);
  a = s;
  b = d;
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 s02 = cadd(v0, v2), d02 = csub(v0, v2);
  const float2 s13 = cadd(v1, v3), d13 = mul_mi(csub(v1, v3));
  v0 = cadd(s02, s13);
  v2 = csub(s02, s13);
  v1 = cadd(d02, d13);
  v3 = csub(d02, d13);
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    dft2(v[0], v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    // X[k] = E[k] + w^k O[k], X[k + 4] = E[k] - w^k O[k], w = e^{-i pi/4}
    constexpr float c = 0.70710678118654752f;
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    o1 = make_float2(c * (o1.x + o1.y), c * (o1.y - o1.x));
    o2 = mul_mi(o2);
    o3 = make_float2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// One Stockham pass of radix R over M points, `ns` the size of the
// sub-transforms already done: in -> out, twiddles tw[j] = e^{-2 pi i j/M}.
template <int R>
__device__ __forceinline__ void pass(const float2* in, float2* out,
                                     const float2* __restrict__ tw, int m,
                                     int ns, int tid) {
  const int stride = m / R;
  const int step = m / (ns * R);
  for (int j = tid; j < stride; j += kThreads) {
    const int k = j & (ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = in[pad(j + r * stride)];
      if (r > 0 && k > 0) v[r] = cmul(v[r], __ldg(tw + r * k * step));
    }
    dft<R>(v);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[pad(d + r * ns)] = v[r];
  }
}

struct Frames {
  const float* ear[2];
  int row_stride[2];      // elements between rows
  int frame_stride[2];    // elements between frames of a row
  int rows_per_ear;
};

struct Out {
  __nv_bfloat16* rhs;     // (R, T, 4, F), the rhs form
  float* mag;             // (R, T, F) each, the f32 form; re, im may be null
  float* re;
  float* im;
};

template <bool kRhs>
__global__ void __launch_bounds__(kThreads)
spectra_kernel(Frames fr, const float* __restrict__ window,
               const float2* __restrict__ tw,
               const float2* __restrict__ tw_split, Out o, int T, int win,
               int n_fft) {
  extern __shared__ float2 sh[];
  const int M = n_fft >> 1;
  const int F = M + 1;
  const int frame = blockIdx.x;                 // r * T + t
  const int r = frame / T;
  const int t = frame - r * T;
  const int ear = r >= fr.rows_per_ear;
  const int b = r - ear * fr.rows_per_ear;
  const float* __restrict__ x =
      fr.ear[ear] + static_cast<size_t>(b) * fr.row_stride[ear] +
      static_cast<size_t>(t) * fr.frame_stride[ear];
  const int tid = threadIdx.x;
  float2* in = sh;
  float2* out = sh + padded(M);

  // the windowed frame, folded on n_fft, packed as M complex points
  for (int m = tid; m < M; m += kThreads) {
    float ev = 0.0f, od = 0.0f;
    for (int n = 2 * m; n < win; n += n_fft) {
      ev = __fadd_rn(ev, __fmul_rn(__ldg(x + n), __ldg(window + n)));
      if (n + 1 < win)
        od = __fadd_rn(od, __fmul_rn(__ldg(x + n + 1), __ldg(window + n + 1)));
    }
    in[pad(m)] = make_float2(ev, od);
  }
  __syncthreads();

  int ns = 1;
  for (; ns * 8 <= M; ns *= 8) {
    pass<8>(in, out, tw, M, ns, tid);
    __syncthreads();
    float2* s = in; in = out; out = s;
  }
  if (ns * 4 == M) {
    pass<4>(in, out, tw, M, ns, tid);
    __syncthreads();
    in = out;
  } else if (ns * 2 == M) {
    pass<2>(in, out, tw, M, ns, tid);
    __syncthreads();
    in = out;
  }

  // in: Z, the M-point DFT of the packed frame. Split into the F bins:
  // E = (Z[k] + conj Z[M - k]) / 2, O = (Z[k] - conj Z[M - k]) / 2i,
  // X[k] = E + e^{-2 pi i k / n_fft} O.
  const size_t base = static_cast<size_t>(frame) * (kRhs ? 4 : 1) * F;
  for (int k = tid; k < F; k += kThreads) {
    const float2 a = in[pad(k & (M - 1))];
    const float2 z = in[pad((M - k) & (M - 1))];
    const float2 e = make_float2(0.5f * (a.x + z.x), 0.5f * (a.y - z.y));
    const float2 od = make_float2(0.5f * (a.y + z.y), -0.5f * (a.x - z.x));
    const float2 w = __ldg(tw_split + k);
    const float2 wo = cmul(w, od);
    const float re = e.x + wo.x;
    const float im = e.y + wo.y;
    const float mag =
        __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    if constexpr (kRhs) {
      __nv_bfloat16* row = o.rhs + base + k;
      row[0] = __float2bfloat16_rn(mag);
      row[F] = __float2bfloat16_rn(re);
      row[2 * F] = __float2bfloat16_rn(im);
      row[3 * F] = __float2bfloat16_rn(1.0f);
    } else {
      o.mag[base + k] = mag;
      if (o.re != nullptr) {
        o.re[base + k] = re;
        o.im[base + k] = im;
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 = cudaSuccess).
// `ears` 2 takes the rhs form (rhs non-null, both ears), `ears` 1 the f32
// form (mag non-null; re and im both null or both set). Frames of each ear
// are (rows_per_ear, T, win) at the given row and frame strides. window
// (win) f32, tw (n_fft / 2) and tw_split (n_fft / 2 + 1) complex f32. The
// caller checks types and shapes; this refuses sizes it cannot take.
int spectra_launch(const float* left, int left_row_stride,
                   int left_frame_stride, const float* right,
                   int right_row_stride, int right_frame_stride,
                   int rows_per_ear, int ears, int T, int win, int n_fft,
                   const float* window, const void* tw, const void* tw_split,
                   void* rhs, float* mag, float* re, float* im,
                   void* stream) {
  if (rows_per_ear <= 0 || T <= 0 || win <= 0 || n_fft < 2 ||
      n_fft > kMaxFft || (n_fft & (n_fft - 1)) != 0 || left_row_stride < 0 ||
      left_frame_stride < 0 || right_row_stride < 0 ||
      right_frame_stride < 0 || (ears != 1 && ears != 2) ||
      (ears == 2) != (rhs != nullptr) || (ears == 1 && mag == nullptr) ||
      (re == nullptr) != (im == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(ears) * rows_per_ear * T;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Frames fr{{left, ears == 2 ? right : left},
                  {left_row_stride, ears == 2 ? right_row_stride
                                              : left_row_stride},
                  {left_frame_stride, ears == 2 ? right_frame_stride
                                                : left_frame_stride},
                  rows_per_ear};
  const Out o{static_cast<__nv_bfloat16*>(rhs), mag, re, im};
  const size_t smem = 2 * sizeof(float2) * padded(n_fft / 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* t1 = static_cast<const float2*>(tw);
  const float2* t2 = static_cast<const float2*>(tw_split);
  if (ears == 2)
    spectra_kernel<true><<<static_cast<int>(blocks), kThreads, smem, s>>>(
        fr, window, t1, t2, o, T, win, n_fft);
  else
    spectra_kernel<false><<<static_cast<int>(blocks), kThreads, smem, s>>>(
        fr, window, t1, t2, o, T, win, n_fft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
