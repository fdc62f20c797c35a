// Masked Adam with per-group clipping and the step's gradient telemetry
// for Hopper (sm_90a), over every leaf of the model at once.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel here. Its
// counterpart is XLA's fusion of the optax update and the telemetry inside
// the jitted train step (biear_tpu/train/loop.py::_train_step_core, with
// optim.py's clipped Adam and loop.py's _group_norms and _grad_histograms).
// The port's plain version, train/loop.py::plain_update (group_norms,
// grad_histograms, optim.py Adam._update), dispatches one PyTorch op per
// leaf and per stage: 5,396 device kernels a step for the flagship's 216
// leaves and 5,850 for AuralNet's 246, 10.5 and 11.6 ms replayed in a
// graph on an H100 (700 W). This file does the same work in three
// launches, 0.053 and 0.062 ms there.
//
// Contract (train/fused_update.py builds the leaf tables):
//
//   leaf_stats  per (leaf, tile) work item, one block each: the tile's
//               sum of g^2, max |g| (NaN if any), count of nonfinite
//               values, its element count and, for each of the 17 float32
//               edges of loop.GRAD_HIST_EDGES, the count of |g| strictly
//               above it: one partial row of 21 words; the first tile's
//               block writes the leaf's (first tile, end tile, table row,
//               flags). Bucket k of the 18 is then "edges strictly below
//               |g|": zeros and NaN in bucket 0, +-inf in bucket 17, as
//               the plain version's comparison sums.
//   finalize    one block. Phase A reduces each leaf's partial rows in tile
//               order into its table row: maxima (rows, 2) [fb, backend],
//               then sums (rows, 22) [sq fb, sq backend, nonfinite fb,
//               nonfinite backend, 18 buckets]; a leaf that its rank does
//               not count under a model axis (loop._counted) adds no
//               squares and no buckets. Phase B reduces the rows per group
//               in a fixed order and writes, in place: the metric scalars
//               [grad_fb_norm, grad_fb_absmax, grad_fb_finite,
//               grad_backend_norm, grad_backend_absmax,
//               grad_backend_finite, skipped], the first n_hist table rows'
//               buckets (grad_hist), ok = finite loss and both groups
//               finite, each optimizer group's clip factor from its
//               group's norm (the reported one: one norm), and the bias
//               corrections from count + 1, which it advances where ok.
//               Without a model axis both phases run in one launch; with
//               one, Mesh.model_max_ / model_sum_ run on the table between
//               a phase-A and a phase-B launch.
//   adam        per (leaf, tile) work item of the leaves of updated groups;
//               where !ok it returns without writing. Otherwise, in the
//               plain version's order and roundings: u = g * factor + wd *
//               p; m = B1 m + (1 - B1) u; v = B2 v + (1 - B2) u^2;
//               p += ((m / bc1) / (sqrt(v / bc2) + eps)) * (-lr) *
//               lr_scale, with lr_scale a float or read from the device.
//
// Why three launches: adam needs the global clip norm of its group and ok,
// which depend on every leaf, before any leaf is written, and blocks of one
// grid cannot wait for each other. leaf_stats therefore writes partial rows
// and finalize, one block, reduces them in a fixed order: no float atomics,
// so the same inputs give the same bits from call to call, eager or
// replayed in a graph.
//
// What bounds it on this card: bytes. leaf_stats reads g; adam reads g, p,
// m, v and writes p, m, v: 32 bytes a parameter, 52.3 MB for the
// flagship's 1,634,780 parameters (15.6 us at 3.35 TB/s) and 66.7 MB for
// AuralNet's 2,084,256 (19.9 us). g (6.5 / 8.3 MB) is read twice, the
// second time mostly from the 50 MB L2. The per-item arithmetic (17
// compares, a few FMAs) is far below the FMA rate. finalize reads 21 words
// per tile (about 50 KB) and runs on one SM for a few microseconds.
//
// Design:
//  * Leaf tables by value: each launch takes a LeafTable of up to
//    kMaxLeaves leaves (pointers, sizes, first tiles, rows, flags; 12 KB,
//    within the 32 KB of kernel parameters that CUDA 12.1+ allows on
//    sm_70+) as a __grid_constant__ parameter, read in place from the
//    parameter bank. A graph node keeps its parameters, so a captured step
//    copies nothing from the host at replay. A model with more leaves
//    launches leaf_stats and adam once per table of kMaxLeaves.
//  * A block finds its leaf by a binary search over the table's first
//    tiles (uniform over the block); a tile is kTile = 4096 elements, 16
//    per thread of 256, as float4 where the pointers are 16-byte aligned.
//  * Deterministic sums: fixed shuffle trees, then the warps in order;
//    finalize gives each leaf one warp, lanes striding over its tiles.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLeaves = 256;
constexpr int kMaxGroups = 4;
constexpr int kEdges = 17;
constexpr int kBuckets = 18;
constexpr int kTile = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPartial = 21;        // sq, max, nonfinite, count, gt[17]
constexpr int kSumCols = 22;        // sq fb, sq be, nf fb, nf be, buckets
constexpr int kMetrics = 7;
constexpr int kFinalThreads = 1024;
constexpr int kFinalWarps = kFinalThreads / 32;

// flags of a leaf (LeafTable::meta)
constexpr int kBackend = 1;         // telemetry group: backend, else fb
constexpr int kCounted = 2;         // counted in the sums (loop._counted)
constexpr int kAlignedG = 4;        // g 16-byte aligned
constexpr int kAlignedAll = 8;      // g, p, m and v 16-byte aligned
constexpr int kGroupShift = 8;      // optimizer group + 1 (0: no update)

struct LeafTable {
  int n_leaves;                     // leaves in this table
  int leaf0;                        // global index of its first leaf
  int tile0;                        // global index of its first tile
  int n_tiles;                      // its tiles (the grid)
  int tile[kMaxLeaves];             // first tile of each leaf, ascending
  int n[kMaxLeaves];                // elements
  int row[kMaxLeaves];              // finalize's table row
  int meta[kMaxLeaves];             // flags above
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
};

struct Edges {
  float e[kEdges];
};

struct FinalArgs {
  int mode;                         // bit 0: phase A, bit 1: phase B
  int n_leaves, n_rows, n_hist, n_groups;
  float b1, b2;
  const float* partials;
  const int4* linfo;                // per leaf: first, end tile, row, flags
  float* table;                     // (rows, 2) maxima, then (rows, 22)
  const float* loss;
  float* out;                       // kMetrics scalars, then (n_hist, 18)
  float* coef;                      // ok, then factor, bc1, bc2 per group
  float clip[kMaxGroups];
  int tg[kMaxGroups];               // the telemetry group of each group
  int* count[kMaxGroups];
};

struct AdamArgs {
  const float* coef;
  const float* lr_scale;            // a 0-dim device tensor, or null
  float lr_scale_value;             // used when lr_scale is null
  float wd, eps, b1, b2, c1, c2;    // c1 = 1 - B1, c2 = 1 - B2 (host f64)
  float neg_lr[kMaxGroups];
};

// max that keeps a NaN, as torch's max reduction
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int find_leaf(const LeafTable& t, int b) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Stats {
  float sq, mx;
  unsigned nf, cnt, gt[kEdges];

  __device__ __forceinline__ void zero() {
    sq = 0.f; mx = 0.f; nf = 0u; cnt = 0u;
#pragma unroll
    for (int k = 0; k < kEdges; ++k) gt[k] = 0u;
  }
  __device__ __forceinline__ void add(const Stats& o) {
    sq += o.sq; mx = nanmax(o.mx, mx); nf += o.nf; cnt += o.cnt;
#pragma unroll
    for (int k = 0; k < kEdges; ++k) gt[k] += o.gt[k];
  }
  __device__ __forceinline__ void shfl_down(int off) {
    Stats o;
    o.sq = __shfl_down_sync(0xffffffffu, sq, off);
    o.mx = __shfl_down_sync(0xffffffffu, mx, off);
    o.nf = __shfl_down_sync(0xffffffffu, nf, off);
    o.cnt = __shfl_down_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int k = 0; k < kEdges; ++k)
      o.gt[k] = __shfl_down_sync(0xffffffffu, gt[k], off);
    add(o);
  }
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) shfl_down(off);
  }
};

__device__ __forceinline__ void take(Stats& s, const Edges& e, float x) {
  const float a = fabsf(x);
  s.sq = __fmaf_rn(a, a, s.sq);
  s.mx = nanmax(a, s.mx);
  s.nf += isfinite(x) ? 0u : 1u;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) s.gt[k] += a > e.e[k] ? 1u : 0u;
}

__global__ void __launch_bounds__(kThreads)
fused_update_stats_kernel(const __grid_constant__ LeafTable t,
                          const __grid_constant__ Edges e,
                          float* __restrict__ partials,
                          int4* __restrict__ linfo) {
  const int b = blockIdx.x;
  const int l = find_leaf(t, b);
  const int first = t.tile[l];
  const int n = t.n[l];
  const int start = (b - first) * kTile;
  const int end = min(n, start + kTile);
  const float* __restrict__ g = t.g[l];

  Stats s;
  s.zero();
  if (t.meta[l] & kAlignedG) {
    const int vend = start + (max(end - start, 0) & ~3);
    for (int i = start + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      const float4 x = *reinterpret_cast<const float4*>(g + i);
      take(s, e, x.x); take(s, e, x.y); take(s, e, x.z); take(s, e, x.w);
    }
    for (int i = vend + threadIdx.x; i < end; i += kThreads) take(s, e, g[i]);
  } else {
    for (int i = start + threadIdx.x; i < end; i += kThreads) take(s, e, g[i]);
  }

  s.warp_reduce();
  __shared__ Stats warp_stats[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (threadIdx.x != 0) return;
  Stats total = warp_stats[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total.add(warp_stats[w]);
  total.cnt = static_cast<unsigned>(max(end - start, 0));
  float* r = partials + static_cast<size_t>(t.tile0 + b) * kPartial;
  r[0] = total.sq;
  r[1] = total.mx;
  r[2] = __uint_as_float(total.nf);
  r[3] = __uint_as_float(total.cnt);
#pragma unroll
  for (int k = 0; k < kEdges; ++k) r[4 + k] = __uint_as_float(total.gt[k]);
  if (b == first) {
    const int stop = l + 1 < t.n_leaves ? t.tile[l + 1] : t.n_tiles;
    linfo[t.leaf0 + l] = make_int4(t.tile0 + first, t.tile0 + stop, t.row[l],
                                   t.meta[l]);
  }
}

// The leaf's partial rows in tile order -> its table row (phase A).
__device__ void leaf_row(const FinalArgs& a, int l, int lane) {
  const int4 info = a.linfo[l];
  Stats s;
  s.zero();
  for (int t = info.x + lane; t < info.y; t += 32) {
    const float* r = a.partials + static_cast<size_t>(t) * kPartial;
    Stats o;
    o.sq = r[0];
    o.mx = r[1];
    o.nf = __float_as_uint(r[2]);
    o.cnt = __float_as_uint(r[3]);
#pragma unroll
    for (int k = 0; k < kEdges; ++k) o.gt[k] = __float_as_uint(r[4 + k]);
    s.add(o);
  }
  s.warp_reduce();
  if (lane != 0) return;
  const int row = info.z, be = info.w & kBackend ? 1 : 0;
  const bool counted = info.w & kCounted;
  float* tmax = a.table + 2 * row;
  float* tsum = a.table + 2 * a.n_rows + static_cast<size_t>(row) * kSumCols;
  tmax[be] = s.mx;
  tmax[1 - be] = 0.f;
  tsum[be] = counted ? s.sq : 0.f;
  tsum[1 - be] = 0.f;
  tsum[2 + be] = static_cast<float>(s.nf);
  tsum[3 - be] = 0.f;
  // the plain version's float32 differences: n - gt[0], gt[k-1] - gt[k],
  // gt[16]
  float h[kBuckets];
  h[0] = static_cast<float>(s.cnt) - static_cast<float>(s.gt[0]);
#pragma unroll
  for (int k = 1; k < kEdges; ++k)
    h[k] = static_cast<float>(s.gt[k - 1]) - static_cast<float>(s.gt[k]);
  h[kEdges] = static_cast<float>(s.gt[kEdges - 1]);
#pragma unroll
  for (int k = 0; k < kBuckets; ++k) tsum[4 + k] = counted ? h[k] : 0.f;
}

__global__ void __launch_bounds__(kFinalThreads)
fused_update_finalize_kernel(const __grid_constant__ FinalArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (a.mode & 1) {
    for (int l = warp; l < a.n_leaves; l += kFinalWarps) leaf_row(a, l, lane);
  }
  if (!(a.mode & 2)) return;
  __syncthreads();

  // per group: squares, maxima, nonfinite counts over the rows, in order
  const float* tmax = a.table;
  const float* tsum = a.table + 2 * a.n_rows;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // sq x2, max x2, nf x2
  for (int r = threadIdx.x; r < a.n_rows; r += kFinalThreads) {
    const float* s = tsum + static_cast<size_t>(r) * kSumCols;
    v[0] += s[0]; v[1] += s[1];
    v[2] = nanmax(tmax[2 * r], v[2]); v[3] = nanmax(tmax[2 * r + 1], v[3]);
    v[4] += s[2]; v[5] += s[3];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float o[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k] = __shfl_down_sync(0xffffffffu, v[k], off);
    v[0] += o[0]; v[1] += o[1]; v[2] = nanmax(o[2], v[2]);
    v[3] = nanmax(o[3], v[3]); v[4] += o[4]; v[5] += o[5];
  }
  __shared__ float part[kFinalWarps][6];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) part[warp][k] = v[k];
  }
  for (int i = threadIdx.x; i < a.n_hist * kBuckets; i += kFinalThreads)
    a.out[kMetrics + i] =
        tsum[static_cast<size_t>(i / kBuckets) * kSumCols + 4 + i % kBuckets];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kFinalWarps; ++w) {
    v[0] += part[w][0]; v[1] += part[w][1];
    v[2] = nanmax(part[w][2], v[2]); v[3] = nanmax(part[w][3], v[3]);
    v[4] += part[w][4]; v[5] += part[w][5];
  }
  const float norm_fb = __fsqrt_rn(v[0]), norm_be = __fsqrt_rn(v[1]);
  const float finite_fb = v[4] == 0.f ? 1.f : 0.f;
  const float finite_be = v[5] == 0.f ? 1.f : 0.f;
  a.out[0] = norm_fb; a.out[1] = v[2]; a.out[2] = finite_fb;
  a.out[3] = norm_be; a.out[4] = v[3]; a.out[5] = finite_be;
  const bool ok = isfinite(*a.loss) && finite_fb > 0.f && finite_be > 0.f;
  a.out[6] = ok ? 0.f : 1.f;
  a.coef[0] = ok ? 1.f : 0.f;
  for (int g = 0; g < a.n_groups; ++g) {
    const float nrm = a.tg[g] ? norm_be : norm_fb;
    // torch: where(norm < clip, 1, clip / norm), clip / norm as
    // reciprocal(norm) * clip
    a.coef[1 + 3 * g] = nrm < a.clip[g]
        ? 1.f : __fmul_rn(__frcp_rn(nrm), a.clip[g]);
    const int c = *a.count[g] + 1;
    a.coef[2 + 3 * g] = __fsub_rn(1.f, powf(a.b1, static_cast<float>(c)));
    a.coef[3 + 3 * g] = __fsub_rn(1.f, powf(a.b2, static_cast<float>(c)));
    if (ok) *a.count[g] = c;
  }
}

struct Coef {
  float factor, bc1, bc2, neg_lr, lr_scale;
};

__device__ __forceinline__ void adam_one(const AdamArgs& a, const Coef& c,
                                         float g, float& p, float& m,
                                         float& v) {
  float u = __fmul_rn(g, c.factor);
  u = __fmaf_rn(a.wd, p, u);
  m = __fmaf_rn(a.c1, u, __fmul_rn(m, a.b1));
  v = __fmaf_rn(a.c2, __fmul_rn(u, u), __fmul_rn(v, a.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), a.eps);
  float step = __fdiv_rn(__fdiv_rn(m, c.bc1), den);
  step = __fmul_rn(__fmul_rn(step, c.neg_lr), c.lr_scale);
  p = __fadd_rn(p, step);
}

__global__ void __launch_bounds__(kThreads)
fused_update_adam_kernel(const __grid_constant__ LeafTable t,
                         const __grid_constant__ AdamArgs a) {
  const int b = blockIdx.x;
  const int l = find_leaf(t, b);
  const int meta = t.meta[l];
  const int grp = (meta >> kGroupShift) - 1;
  if (grp < 0 || a.coef[0] == 0.f) return;
  Coef c;
  c.factor = a.coef[1 + 3 * grp];
  c.bc1 = a.coef[2 + 3 * grp];
  c.bc2 = a.coef[3 + 3 * grp];
  c.neg_lr = a.neg_lr[grp];
  c.lr_scale = a.lr_scale ? *a.lr_scale : a.lr_scale_value;
  const int start = (b - t.tile[l]) * kTile;
  const int end = min(t.n[l], start + kTile);
  const float* __restrict__ g = t.g[l];
  float* __restrict__ p = t.p[l];
  float* __restrict__ m = t.m[l];
  float* __restrict__ v = t.v[l];
  int i0 = start + threadIdx.x;
  if (meta & kAlignedAll) {
    const int vend = start + (max(end - start, 0) & ~3);
#pragma unroll 4
    for (int i = start + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      const float4 g4 = *reinterpret_cast<const float4*>(g + i);
      float4 p4 = *reinterpret_cast<const float4*>(p + i);
      float4 m4 = *reinterpret_cast<const float4*>(m + i);
      float4 v4 = *reinterpret_cast<const float4*>(v + i);
      adam_one(a, c, g4.x, p4.x, m4.x, v4.x);
      adam_one(a, c, g4.y, p4.y, m4.y, v4.y);
      adam_one(a, c, g4.z, p4.z, m4.z, v4.z);
      adam_one(a, c, g4.w, p4.w, m4.w, v4.w);
      *reinterpret_cast<float4*>(p + i) = p4;
      *reinterpret_cast<float4*>(m + i) = m4;
      *reinterpret_cast<float4*>(v + i) = v4;
    }
    i0 = vend + threadIdx.x;
  }
  for (int i = i0; i < end; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(a, c, g[i], pi, mi, vi);
    p[i] = pi; m[i] = mi; v[i] = vi;
  }
}

}  // namespace

extern "C" {

// sizeof(LeafTable): the wrapper packs its tables to this size.
int fused_update_table_bytes(void) {
  return static_cast<int>(sizeof(LeafTable));
}

// Each launcher returns its cudaError_t (0 = cudaSuccess). The wrapper
// checks devices, types, contiguity and sizes; `table` is a packed
// LeafTable, `edges` 17 host floats, the other host arrays n_groups long.

int fused_update_stats_launch(const void* table, const float* edges,
                              float* partials, int* linfo, void* stream) {
  LeafTable t;
  memcpy(&t, table, sizeof t);
  if (t.n_leaves <= 0 || t.n_leaves > kMaxLeaves || t.n_tiles <= 0 ||
      reinterpret_cast<uintptr_t>(linfo) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Edges e;
  memcpy(e.e, edges, sizeof e.e);
  fused_update_stats_kernel<<<t.n_tiles, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      t, e, partials, reinterpret_cast<int4*>(linfo));
  return static_cast<int>(cudaGetLastError());
}

int fused_update_finalize_launch(int mode, int n_leaves, int n_rows,
                                 int n_hist, int n_groups, float b1,
                                 float b2, const float* partials,
                                 const int* linfo, float* table,
                                 const float* loss, float* out, float* coef,
                                 const float* clip, const int* tg,
                                 int* const* count, void* stream) {
  if (mode < 1 || mode > 3 || n_leaves < 0 || n_rows < 0 || n_hist < 0 ||
      n_hist > n_rows || n_groups < 0 || n_groups > kMaxGroups ||
      reinterpret_cast<uintptr_t>(linfo) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  FinalArgs a;
  memset(&a, 0, sizeof a);
  a.mode = mode;
  a.n_leaves = n_leaves;
  a.n_rows = n_rows;
  a.n_hist = n_hist;
  a.n_groups = n_groups;
  a.b1 = b1;
  a.b2 = b2;
  a.partials = partials;
  a.linfo = reinterpret_cast<const int4*>(linfo);
  a.table = table;
  a.loss = loss;
  a.out = out;
  a.coef = coef;
  for (int g = 0; g < n_groups; ++g) {
    if (tg[g] < 0 || tg[g] > 1) return static_cast<int>(cudaErrorInvalidValue);
    a.clip[g] = clip[g];
    a.tg[g] = tg[g];
    a.count[g] = count[g];
  }
  fused_update_finalize_kernel<<<1, kFinalThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int fused_update_adam_launch(const void* table, const float* coef,
                             const float* lr_scale, float lr_scale_value,
                             float wd, float eps, float b1, float b2,
                             float c1, float c2, const float* neg_lr,
                             int n_groups, void* stream) {
  LeafTable t;
  memcpy(&t, table, sizeof t);
  if (t.n_leaves <= 0 || t.n_leaves > kMaxLeaves || t.n_tiles <= 0 ||
      n_groups < 0 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamArgs a;
  memset(&a, 0, sizeof a);
  a.coef = coef;
  a.lr_scale = lr_scale;
  a.lr_scale_value = lr_scale_value;
  a.wd = wd;
  a.eps = eps;
  a.b1 = b1;
  a.b2 = b2;
  a.c1 = c1;
  a.c2 = c2;
  for (int g = 0; g < n_groups; ++g) a.neg_lr[g] = neg_lr[g];
  fused_update_adam_kernel<<<t.n_tiles, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(t, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
