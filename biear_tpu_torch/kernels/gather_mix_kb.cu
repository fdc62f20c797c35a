// Fused window gather + block-Toeplitz HRIR mix for Hopper (sm_90a), on
// the bf16 tensor cores (wgmma).
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
// M - 1). bf16() is round-to-nearest-even (__floats2bfloat162_rn, as JAX's
// astype). The product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs from the plain version. pool (NP, row_len)
// f32, kb (M, ncol, 256) bf16 with ncol % 128 == 0, out (X, nf, 256) f32.
//
// What bounds it on this card: bytes. At the training shape (X = 1536
// windows, nf = 125, ncol = 384, a 32-entry bank) it must read the pool
// spans its windows cover and the 6.3 MB bank and write 196.6 MB: about
// 220 MB, 0.066 ms at 3.35 TB/s. Its 37.7 GFLOP take 0.038 ms on the bf16
// tensor cores (989 TFLOP/s), but 0.56 ms as f32 FMAs: the products have to
// run on the tensor cores or they, not the bytes, set the time. The TPU
// design (the whole bank resident in VMEM, a sublane-roll halo framing, an
// ears-major transposed store) answers TPU limits and is not carried over.
//
// Design:
//  * The framed window is Toeplitz: frame f is samples 128 f .. 128 f +
//    ncol, so with blk[i] = samples 128 i .. 128 i + 127,
//      out[f] = sum_k blk[f + k] @ kb[128 k : 128 k + 128].
//    The block keeps ONE unframed copy of its window in shared memory as
//    bf16, rounded once. It is read from the pool with aligned 16-byte
//    loads (the window starts 0..3 samples into the first; eight loads a
//    thread are in flight before the first is used). Row f of a 16-wide K
//    slice starts at sample 128 f + k0, 16-byte aligned, so ldmatrix reads
//    the A fragments straight from it; each 128-sample block is padded by
//    16 bytes, which puts the 8 rows of an ldmatrix phase on 8 different
//    bank groups.
//  * One block covers all frames of its window (rows 0..127, two
//    warpgroups of 64 rows) and the 128 columns of one ear, so an ear's
//    bank slice is read once per window, and two blocks fit an SM. Each
//    warpgroup runs wgmma.m64n128k16 (bf16 in, f32 out) with A from
//    registers and B from shared memory: 64 accumulators a thread.
//  * The bank streams through a ring of kStages shared-memory tiles of 64
//    rows, filled by cp.async (16 bytes a thread, coalesced) in wgmma's
//    N-major 128-byte-swizzled layout, so the copy of tile t + 2 runs
//    under the products of tile t, and the products of tile t start
//    before those of tile t - 1 have retired. The bank's size is not
//    limited.
//  * Frames >= nf are computed on clamped rows and masked at the store;
//    a warpgroup whose 64 rows all lie past nf skips its products.
//  * The epilogue goes through the shared memory the main loop has left:
//    each warp writes whole 512-byte rows, 16 bytes a lane.
//  * The sums run in a fixed order (tiles in j order, one accumulator per
//    output): two launches on the same inputs give the same bits.
//
// Measured against this design and dropped (PERF.md has the readings): one
// block per window with all 256 columns (128 accumulators a thread, one
// block an SM), stores straight from the registers, four warpgroups a
// block, 128-row tiles, a persistent block per SM that prefetches the next
// window, and the two ears of a window as a cluster that shares one
// staged window through distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16384;
constexpr int kCols = 256;            // 2 ears x 128 samples of a frame
constexpr int kThreads = 256;         // two warpgroups x 64 frames
constexpr int kBlkBytes = 272;        // a 128-sample bf16 block + 16 B pad
constexpr int kTileRows = 64;         // bank rows per ring tile
constexpr int kStages = 4;            // tiles in the ring
constexpr int kAhead = kStages - 2;   // tiles requested ahead of the products
constexpr int kSlabBytes = kTileRows * 128;   // 64 columns of a tile, bf16
constexpr int kTileBytes = 2 * kSlabBytes;    // 64 rows x 128 columns
constexpr int kStageRowFloats = 136;  // epilogue staging row: 128 + 8 pad

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// B operand descriptor: N-major (trans-b = 1), 128-byte swizzle. A 64-column
// slab is 64 rows x 128 bytes; slabs lie kSlabBytes apart (leading byte
// offset), groups of 8 rows 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>(kSlabBytes >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

// The first n4 * 4 samples of a window, rounded to bf16 into the padded
// block layout at `dst`. `src4` is the 16-byte aligned address at or below
// the window's start and A the window's offset from it (0..3 samples): a
// thread reads two aligned 16-byte words and keeps the four samples that
// start A into the first.
template <int A>
__device__ __forceinline__ void stage_window(const float4* __restrict__ src4,
                                             uint8_t* dst, int n4) {
  constexpr int kInFlight = 8;          // loads of a thread in flight at once
  for (int q0 = threadIdx.x; q0 < n4; q0 += kInFlight * kThreads) {
    float4 lo[kInFlight], hi[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int q = q0 + u * kThreads;
      if (q < n4) {
        lo[u] = __ldg(src4 + q);
        hi[u] = A ? __ldg(src4 + q + 1) : lo[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int q = q0 + u * kThreads;
      if (q < n4) {
        const float v[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                            hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[A], v[A + 1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[A + 2], v[A + 3]);
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&p0);
        w.y = *reinterpret_cast<const uint32_t*>(&p1);
        *reinterpret_cast<uint2*>(dst + (q >> 5) * kBlkBytes + (q & 31) * 8) =
            w;
      }
    }
  }
}

#define MIX_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MIX_D16(i) MIX_D4(i), MIX_D4(i + 4), MIX_D4(i + 8), MIX_D4(i + 12)

// d (64 x 128, f32) += a (64 x 16 bf16, registers) * b (16 x 128 bf16, smem)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,   %1,   %2,   %3,   %4,   %5,   %6,   %7,   "
      " %8,   %9,   %10,  %11,  %12,  %13,  %14,  %15,  "
      " %16,  %17,  %18,  %19,  %20,  %21,  %22,  %23,  "
      " %24,  %25,  %26,  %27,  %28,  %29,  %30,  %31,  "
      " %32,  %33,  %34,  %35,  %36,  %37,  %38,  %39,  "
      " %40,  %41,  %42,  %43,  %44,  %45,  %46,  %47,  "
      " %48,  %49,  %50,  %51,  %52,  %53,  %54,  %55,  "
      " %56,  %57,  %58,  %59,  %60,  %61,  %62,  %63},"
      "{%64,  %65,  %66,  %67},"
      " %68,"
      " p,    1,    1,    1;\n"
      "}\n"
      : MIX_D16(0), MIX_D16(16), MIX_D16(32), MIX_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 2)
gather_mix_kb_kernel(const float* __restrict__ pool,
                     const int* __restrict__ rows,
                     const int* __restrict__ offs,
                     const int* __restrict__ meas,
                     const __nv_bfloat16* __restrict__ kb,
                     float* __restrict__ out, int n_rows, int row_len,
                     int n_meas, int ncol, int nf) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: 1024-byte aligned slabs
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t winb = ring + kStages * kTileBytes;
  uint8_t* const gen_ring = smem_raw + (ring - smem_u32(smem_raw));
  uint8_t* const gen_win = gen_ring + kStages * kTileBytes;

  const int x = blockIdx.x >> 1;
  const int c0 = (blockIdx.x & 1) * 128;        // this block's ear
  const int row = min(max(rows[x], 0), n_rows - 1);
  const int off = min(max(offs[x], 0), row_len - kWin);
  const int m = min(max(meas[x], 0), n_meas - 1);
  const float* win = pool + static_cast<int64_t>(row) * row_len + off;
  const __nv_bfloat16* bank =
      kb + static_cast<int64_t>(m) * ncol * kCols + c0;
  const int nblk = nf + ncol / 128 - 1;         // window blocks in use, <= 128
  const int n_tiles = ncol / kTileRows;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const uint32_t slot = ring + (t % kStages) * kTileBytes;
      const __nv_bfloat16* src =
          bank + static_cast<int64_t>(t) * kTileRows * kCols;
#pragma unroll
      for (int i = 0; i < kTileRows * 16 / kThreads; ++i) {
        const int q = threadIdx.x + i * kThreads;   // 16-byte chunk of the tile
        const int r = q >> 4;
        const int cc = q & 15;
        cp_async16(slot + (cc >> 3) * kSlabBytes + r * 128
                       + (((cc & 7) ^ (r & 7)) << 4),
                   src + r * kCols + cc * 8);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) load_tile(s);

  // the window, unframed, rounded to bf16 once (rows are multiples of 4
  // samples and the pool is 16-byte aligned: the misalignment is off % 4)
  const float4* src4 = reinterpret_cast<const float4*>(win - (off & 3));
  switch (off & 3) {
    case 0: stage_window<0>(src4, gen_win, nblk * 32); break;
    case 1: stage_window<1>(src4, gen_win, nblk * 32); break;
    case 2: stage_window<2>(src4, gen_win, nblk * 32); break;
    default: stage_window<3>(src4, gen_win, nblk * 32); break;
  }

  const int wg = threadIdx.x >> 7;              // which 64 frames
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const bool active = 64 * wg < nf;
  // ldmatrix row of this lane: frame a_row, K offset 8 for lanes 16..31
  const int a_row = 64 * wg + 16 * warp + (lane & 15);
  const uint32_t a_col = (lane >> 4) * 16;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // One step of the main loop: wait for tile t, ask for tile t + kAhead,
  // start tile t's products and retire those of tile t - 1. The products
  // of two tiles are in flight at once, so the tensor cores do not drain
  // at a tile's end; the A fragments alternate between two register sets
  // (the loop handles two tiles a turn; ncol / 64 is even). The copy goes
  // into the slot of tile t - 2, which every warp has retired before it
  // passed this step's barrier.
  auto step = [&](int t, uint32_t (&a)[kTileRows / 16][4]) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead - 1) : "memory");
    // the ring was written through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_tile(t + kAhead);
    if (active) {
      // tile t starts at bank row 64 t: window block t / 2 past the
      // frame's own, 64 (t % 2) samples into it
      const int blk = min(a_row + (t >> 1), nblk - 1);
      const uint32_t a_addr = winb + blk * kBlkBytes + (t & 1) * 128 + a_col;
      const uint32_t slot = ring + (t % kStages) * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        ldmatrix_x4(a[kk], a_addr + kk * 32);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        wgmma_m64n128k16(acc, a[kk], b_desc(slot + kk * 2048));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
  };
  uint32_t a_even[kTileRows / 16][4], a_odd[kTileRows / 16][4];
  for (int t = 0; t < n_tiles; t += 2) {
    step(t, a_even);
    step(t + 1, a_odd);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // epilogue. Accumulator 4 j + {0, 1} is (row g, columns 8 j + 2 q + {0,
  // 1}), 4 j + {2, 3} the same columns of row g + 8, with g = lane / 4 and
  // q = lane % 4 inside the warp's 16 rows. Each warp stages its 16 rows x
  // 128 columns in the shared memory the main loop has left, then writes
  // whole rows, 16 bytes a lane.
  __syncthreads();
  float* const st = reinterpret_cast<float*>(gen_ring)
                    + (threadIdx.x >> 5) * 16 * kStageRowFloats;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(st + (lane >> 2) * kStageRowFloats + c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(st + ((lane >> 2) + 8) * kStageRowFloats + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  const int r0 = 64 * wg + 16 * warp;
  float* const o = out + static_cast<int64_t>(x) * nf * kCols + c0;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if (r0 + r < nf)
      *reinterpret_cast<float4*>(o + (r0 + r) * kCols + 4 * lane) =
          *reinterpret_cast<const float4*>(st + r * kStageRowFloats
                                           + 4 * lane);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess). The caller checks shapes, types, the window coverage
// (128 (nf - 1) + ncol <= 16384) and the 16-byte alignment of pool and kb.
int gather_mix_kb_launch(const float* pool, const int* rows, const int* offs,
                         const int* meas, const void* kb, float* out,
                         int n_rows, int row_len, int n_meas, int ncol,
                         int n_windows, int nf, void* stream) {
  if (n_rows <= 0 || row_len < kWin || n_meas <= 0 || ncol <= 0 ||
      ncol % 128 != 0 || n_windows <= 0 || nf <= 0 ||
      128 * (nf - 1) + ncol > kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pool) % 16 ||
      reinterpret_cast<uintptr_t>(kb) % 16 || row_len % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the ring and the window (all 128 blocks at most), or the epilogue's 8
  // warps x 16 staged rows if that is more, and room to align the ring
  constexpr int kMainLoop = kStages * kTileBytes + 128 * kBlkBytes;
  constexpr int kEpilogue = 8 * 16 * kStageRowFloats * 4;
  constexpr int kSmem = (kMainLoop > kEpilogue ? kMainLoop : kEpilogue) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      gather_mix_kb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_mix_kb_kernel<<<2 * n_windows, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      pool, rows, offs, meas, static_cast<const __nv_bfloat16*>(kb), out,
      n_rows, row_len, n_meas, ncol, nf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
