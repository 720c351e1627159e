// Grouped (batched) matmul for Hopper (sm_90a): out[g] = x[g] @ w[g].
//
// Replaces two Pallas TPU kernels of the JAX package, which compute the
// same function on different shapes:
//   block_diag_matmul  src/repro/kernels/block_diag_matmul.py
//                      (_bdm_kernel, pallas_call at :50): the semantic
//                      split's per-branch product [Bb, T, d] @ [Bb, d, e]
//   moe_gmm            src/repro/kernels/moe_gmm.py
//                      (_gmm_kernel, pallas_call at :41): the per-expert
//                      product over the capacity-padded dispatch buffer
//                      [E, C, d] @ [E, d, f]
//
// What it computes is the TPU kernels': the contraction is walked in slabs
// and summed in f32, and the result is cast once to x's dtype.
//
// Layout.  x [G, M, K] and w [G, K, N] are read through their group and row
// strides (the last dim dense); out is a dense [G, M, N].  Any M, K, N and
// G: ragged edges are masked (or zero-filled by the copy engine).
//
// Four paths; the caller picks one from dtype, shape and alignment alone
// (``_gemm_launch.path_for``), before the launch.
//
//   wgmma (bf16, M > 32, pointers and strides 16-byte aligned).
//     Bound: at prefill sizes by bf16 tensor-core arithmetic (989 TFLOP/s),
//     at the MoE capacity (C 171) by the bytes of the expert weights.
//     Design: one producer warp issues TMA copies of 64-deep K slabs of x
//     ([BM, 64], K-major) and w ([64, 128], N-major) through 3-D tensor maps
//     [G, M, K] / [G, K, N] with a 128-byte swizzle into a 4-stage ring in
//     shared memory, tracked by full/empty mbarriers; the copy engine's
//     out-of-bounds zero fill covers ragged M, N, K.  NC = 1-3 consumer
//     warpgroups each own 64 output rows of a (64 NC) x 128 tile and run
//     wgmma.mma_async m64n128k16 (bf16 -> f32, B through the transpose
//     bit) on the staged slabs.  NC = 3 covers the MoE capacity's 171 rows
//     in one CTA, so each expert's weight tile is read from device memory
//     once.  The epilogue casts once to bf16 and masks the ragged edge.
//   tiled (f32 with M > 32, and any other bf16 call with M > 32).
//     Bound: CUDA-core f32 arithmetic (67 TFLOP/s); bf16 is widened to f32
//     on its way to shared memory and runs the same f32 FMAs.  Design:
//     (64 MH) x 128 outputs per CTA of 256 threads, 16-deep slabs
//     double-buffered in shared memory (the next slab's loads are in
//     flight in registers while the current one is consumed); each thread
//     holds 4 MH x 8 outputs in two row and two column quads 64 apart, so
//     neighbouring threads read neighbouring float4s.  MH = 2 for
//     prefill-sized M, 1 where 64-row tiles waste less padding.  f32 stays
//     here: tensor cores would mean TF32 and change the reference's
//     numerics.
//   The decode-sized tiles (M <= 32) are bound by the bytes of w: a few
//   rows reuse each weight element a few times, and one projection has
//   only N / 128 column tiles per group, too few to keep every SM's loads
//   in flight.  So both split the contraction over the CTAs of a
//   thread-block cluster (at most 8, the portable size) and merge the
//   splits inside the launch: each CTA leaves its f32 tile in shared
//   memory, and after a cluster barrier each rank adds a slice of the tile
//   over ranks 0, 1, ... in order through distributed shared memory
//   (deterministic) and writes it once, cast.  One launch per call, no
//   workspace.  Both fill a 4-stage ring of slabs by cp.async, so three
//   slabs are in flight while one is multiplied; ragged M, N and K are
//   zero-filled by the copies (a partial 16-byte chunk copies its valid
//   bytes).  The column-tile width and the cluster size come from
//   ``_gemm_launch.skinny_plan``: narrower tiles where wide ones leave too
//   few CTAs for a long contraction (a deeper ring instead, 8 stages,
//   measured slower: its shared memory left fewer clusters resident).
//   mma_skinny (bf16, M <= 32, pointers and strides 16-byte aligned).
//     mma.sync m16n8k16 (bf16 -> f32) with the operands swapped: w's
//     output columns are the m16 side and x's rows the n8 side, so 8 rows
//     waste no tensor-core rows (BN = 8, 16 or 32 rows, BC = 128 or 64
//     columns, 4 warps of BC / 4 columns).  64-deep slabs of w ([64, BC],
//     N-major rows padded by 16 bytes: no bank conflicts) and of x ([BN,
//     64]) go by 16-byte copies.  The A fragments come from the raw w rows
//     through ldmatrix.trans, the B fragments from x rows through
//     ldmatrix: no widened copy.  A bf16 x bf16 product is exact in f32,
//     so this computes what f32 FMAs would, up to summation order.
//   skinny (f32 with M <= 32, and bf16 the copies cannot take).
//     CUDA-core f32 FMAs (no TF32: that would change the reference's
//     numerics); 8 rows x BC = 128, 64 or 32 columns per CTA of 2 BC
//     threads, one row and 4 columns per thread, 32-deep slabs staged as
//     loaded and widened as read.  f32 goes by 16-byte copies where the
//     pointer and strides allow it, 4-byte copies otherwise; bf16 (rows
//     not 16-byte aligned) by plain loads, 8-byte vectors where aligned.
// The tiled path's loads are 4-element vectors where the pointer and
// strides allow it (the caller says so), scalars otherwise.  When the
// output tiles alone cannot fill the card the tiled and wgmma paths also
// split the contraction over CTAs: each split writes f32 partial sums to
// a workspace [S, G, M, N] and a second kernel adds them in order
// (deterministic) and casts.
//
// The ragged entry (``grouped_matmul_ragged_launch``): out [R, N] = rows
// offsets[g] .. offsets[g + 1] of x [R, K] times w[g] for each of G groups
// of w [G, K, N], the rows at or past offsets[G] written as zeros.  It
// runs the MoE FFN's expert product on the kept assignments compacted by
// expert (``models/moe.py``): R is static (every assignment of the call),
// the offsets are on the device and no host reads them, so every CTA
// reads its own.  Bound by the bytes of the experts that were chosen (an
// expert no row chose costs nothing) at decode sizes, by them or by the
// arithmetic at prefill sizes.  Two tilings, picked on the host from the
// dtype and R alone (``_gemm_launch.ragged_path_for``), one launch each,
// no split-K and no workspace:
//   decode-sized R: one CTA per (group, column tile), plus a row of CTAs
//     for the zero tail.  The CTA reads its two offsets and returns before
//     any weight load when its segment is empty; otherwise it runs the
//     segment's rows 8 at a time through the decode-sized tiles above
//     (``mma_skinny``'s ``mma.sync`` tile in bf16, ``skinny``'s FMAs in
//     f32), each pass streaming w[g]'s column tile through the cp.async
//     ring.
//   prefill-sized R: a static count of row-tile slots, ceil(R / BM) + G +
//     1, times the column tiles.  Each CTA walks the offsets (a block-wide
//     scan of the groups' tile counts) to map its slot to (group, row
//     block), or to the zero tail, or to nothing past the last tile; then
//     runs the wgmma tile (bf16: TMA over x from the block's first row,
//     the epilogue masking rows past the segment) or the tiled FMAs (f32).
#include <cooperative_groups.h>
#include <cuda.h>          // CUtensorMap (no driver call is linked)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements, as loaded (one 16-byte f32 or 8-byte bf16
// vector).  A slab's loads land in these raw registers and are widened to
// f32 only on their way to shared memory, after the current slab's
// products: a conversion at load time would wait for the load there.
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

// p[0..3], of which the first ``n`` are in range (the rest 0; n <= 0: p
// is not dereferenced).  ``vec``: p is 4-element aligned, so a full quad
// is one vector load.
template <typename T>
__device__ __forceinline__ Quad<T> load4(const T* p, int n, bool vec) {
  Quad<T> q;
  if (vec && n >= 4) {
    q = *reinterpret_cast<const Quad<T>*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) q.v[i] = p[i];
      else store_as(&q.v[i], 0.f);
    }
  }
  return q;
}

// The output tile's epilogue: one element, to the final output or to this
// split's partial sums.
template <typename T>
__device__ __forceinline__ void emit(T* out, float* partial, int split,
                                     int G, int g, int M, int N, int row,
                                     int col, float acc) {
  const long long i = ((long long)g * M + row) * N + col;
  if (partial)
    partial[(long long)split * G * M * N + i] = acc;
  else
    store_as(out + i, acc);
}

// ------------------------------------------------------ the ragged entry
// A row tile of the ragged entry's walk: rows [row0, min(row0 + BM,
// row_end)) of group g, whose segment ends at row_end; g = G is the zero
// tail [offsets[G], R), g = -1 a slot past the last tile.
struct Seg {
  int g, row0, row_end;
};

// The ``slot``-th BM-row tile of the walk over group 0's rows, group 1's,
// ..., then the zero tail: a block-wide inclusive scan of the groups' tile
// counts (ceil(rows / BM)), blockDim.x of them a pass.  Every thread of
// the block calls it and gets the same answer.  Offsets are clamped to
// [0, R]; a group whose offsets decrease has no tile.
__device__ Seg ragged_tile(const int* __restrict__ offsets, int G, int R,
                           int BM, int slot) {
  __shared__ int warp_sum[32];
  __shared__ Seg found;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  if (tid == 0) found.g = -1;
  int carry = 0;
  for (int base = 0; base <= G; base += blockDim.x) {
    const int gi = base + tid;
    int lo = 0, hi = 0;
    if (gi <= G) {
      lo = min(max(offsets[gi], 0), R);
      hi = gi < G ? min(max(offsets[gi + 1], 0), R) : R;
    }
    const int n = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int start = carry + incl - n, total = carry;
    for (int i = 0; i < n_warps; ++i) {
      if (i < warp) start += warp_sum[i];
      total += warp_sum[i];
    }
    if (n > 0 && slot >= start && slot < start + n)
      found = Seg{gi, lo + (slot - start) * BM, hi};
    carry = total;
    __syncthreads();     // warp_sum is rewritten by the next pass; found
  }
  return found;
}

// Zeros over rows [r0, r1) x columns [c0, c0 + cols) of a dense [*, N]
// out, by every thread of the block.
template <typename T>
__device__ __forceinline__ void zero_rows(T* out, int r0, int r1, int c0,
                                          int cols, int N) {
  cols = min(cols, N - c0);
  if (r1 <= r0 || cols <= 0) return;
  const long long n = (long long)(r1 - r0) * cols;
  for (long long v = threadIdx.x; v < n; v += blockDim.x)
    store_as(out + (long long)(r0 + v / cols) * N + c0 + v % cols, 0.f);
}

// RAGGED: the ragged entry's prefill-sized f32 tiling (G groups of w, x
// and out [M = R rows], blockIdx.y the slot of ``ragged_tile``, one
// split); otherwise the grouped GEMM's tiled path.
template <typename T, int MH, bool RAGGED>
__global__ void __launch_bounds__(THREADS) gemm_tiled_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    float* __restrict__ partial, int splits, int k_per_split, int G, int M,
    int K, int N, long long sxg, long long sxm, long long swg, long long swk,
    bool vec_x, bool vec_w, const int* __restrict__ offsets) {
  constexpr int BM = 64 * MH, BN = 128, BK = 16, PAD = 4;
  // x slab: BM rows x BK, 4-element chunks, MH per thread; w slab: BK rows
  // x BN, 2 chunks per thread
  static_assert(BM * BK / 4 == MH * THREADS && BK * BN / 4 == 2 * THREADS,
                "loader");
  __shared__ __align__(16) float As[2][BK][BM + PAD];   // transposed x slab
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int col0 = blockIdx.x * BN;
  // g: w's group; og: x's and out's (0 on the ragged entry, whose rows are
  // global); rows at or past row_end are masked
  int g, split, row0, row_end, og;
  if constexpr (RAGGED) {
    const Seg s = ragged_tile(offsets, G, M, BM, blockIdx.y);
    if (s.g < 0) return;
    if (s.g == G) {
      zero_rows(out, s.row0, min(s.row0 + BM, s.row_end), col0, BN, N);
      return;
    }
    g = s.g, split = 0, row0 = s.row0, row_end = s.row_end, og = 0;
  } else {
    g = blockIdx.z / splits, split = blockIdx.z % splits;
    row0 = blockIdx.y * BM, row_end = M, og = g;
  }
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xg = x + og * sxg;
  const T* wg = w + g * swg;

  Quad<T> ra[MH], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      const int c = tid + i * THREADS, row = row0 + c / 4;
      const int k = k0 + (c % 4) * 4;
      ra[i] = load4(xg + row * sxm + k, row < row_end ? k_end - k : 0,
                    vec_x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS, k = k0 + c / 32;
      const int col = col0 + (c % 32) * 4;
      rb[i] = load4(wg + k * swk + col, k < k_end ? N - col : 0, vec_w);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      const int c = tid + i * THREADS, r = c / 4, kk = (c % 4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][kk + e][r] = to_f32(ra[i].v[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][c / 32][(c % 32) * 4]) =
          make_float4(to_f32(rb[i].v[0]), to_f32(rb[i].v[1]),
                      to_f32(rb[i].v[2]), to_f32(rb[i].v[3]));
    }
  };

  float acc[4 * MH][8];
#pragma unroll
  for (int i = 0; i < 4 * MH; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(k_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const bool more = k0 + BK < k_end;
    if (more) load(k0 + BK);          // in flight while this slab is used
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4 * MH], b[8];
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        const float4 t =
            *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4 + 64 * h]);
        a[4 * h] = t.x; a[4 * h + 1] = t.y; a[4 * h + 2] = t.z;
        a[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4 + 64 * c]);
        b[4 * c] = t.x; b[4 * c + 1] = t.y; b[4 * c + 2] = t.z;
        b[4 * c + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * MH; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 4 * MH; ++i) {
    const int row = row0 + ty * 4 + 64 * (i / 4) + i % 4;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (col < N)
        emit(out, partial, split, G, og, M, N, row, col, acc[i][j]);
    }
  }
}

// out[i] = sum over splits s (in order) of partial[s * n + i], cast.
template <typename T>
__global__ void __launch_bounds__(THREADS) splitk_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ out, long long n,
    int splits) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * n + i];
    store_as(out + i, s);
  }
}

template <typename T>
int launch_typed(int tile_m, const void* x_, const void* w_, void* out_,
                 float* partial, int splits, int k_per_split, int G, int M,
                 int K, int N, long long sxg, long long sxm, long long swg,
                 long long swk, bool vec_x, bool vec_w, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  T* out = static_cast<T*>(out_);
  float* part = splits > 1 ? partial : nullptr;
  const dim3 grid((N + 127) / 128, (M + tile_m - 1) / tile_m, G * splits);
#define GM_ARGS x, w, out, part, splits, k_per_split, G, M, K, N, sxg, sxm, \
                swg, swk, vec_x, vec_w, nullptr
  if (tile_m == 64)
    gemm_tiled_kernel<T, 1, false><<<grid, THREADS, 0, st>>>(GM_ARGS);
  else if (tile_m == 128)
    gemm_tiled_kernel<T, 2, false><<<grid, THREADS, 0, st>>>(GM_ARGS);
  else
    return -3;
#undef GM_ARGS
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)G * M * N;
  const int blocks = static_cast<int>(
      n / THREADS + 1 < 4096 ? n / THREADS + 1 : 4096);
  splitk_reduce_kernel<T><<<blocks, THREADS, 0, st>>>(partial, out, n,
                                                       splits);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ wgmma path
constexpr int TC_BN = 128, TC_BK = 64, TC_STAGES = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA copy of the box at (c0, c1, c2) of ``map`` into ``dst``; its
// bytes complete a transaction on ``bar``.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d[0..63] += A (64 x 16, K-major, from ``da``) @ B (16 x 128, N-major
// through the transpose bit, from ``db``): one warpgroup, bf16 -> f32.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int NC>
__host__ __device__ constexpr int tc_stage_bytes() {
  return 64 * NC * TC_BK * 2 + TC_BK * TC_BN * 2;
}

template <int NC>
__host__ __device__ constexpr int tc_smem_bytes() {
  // the ring, its 2 x STAGES mbarriers, and slack to align the ring to the
  // 1024-byte period of the 128-byte swizzle
  return TC_STAGES * tc_stage_bytes<NC>() + 2 * TC_STAGES * 8 + 1024;
}

// (64 NC) x 128 outputs of group g per CTA; warpgroup 0 is the producer
// (one thread issues every copy), warpgroups 1..NC consume.  Slab s of a
// stage holds x rows [m0, m0 + 64 NC) x K [k0, k0 + 64) as 64 NC rows of
// 128 bytes, then w K rows [k0, k0 + 64) x N [n0, n0 + 128) as two
// 64-column halves of 64 rows of 128 bytes; both swizzled by the copy
// engine in 1024-byte atoms of 8 rows.  RAGGED: the ragged entry's
// prefill-sized bf16 tiling (as gemm_tiled_kernel's; x's map [1, M, K],
// the tile's copies from its first row, rows past the segment masked).
template <int NC, bool RAGGED>
__global__ void __launch_bounds__(128 * (NC + 1), 1) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,
    const __grid_constant__ CUtensorMap tmap_w,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int splits,
    int k_per_split, int G, int M, int K, int N,
    const int* __restrict__ offsets) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * TC_BK * 2;
  constexpr int HALF_B = TC_BK * 64 * 2;            // one 64-column half
  constexpr int STAGE = tc_stage_bytes<NC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * STAGE);
  uint64_t* empty = full + TC_STAGES;

  const int n0 = blockIdx.x * TC_BN;
  // g: w's group; og: x's and out's (0 on the ragged entry); rows at or
  // past row_end are masked
  int g, split, m0, row_end, og;
  if constexpr (RAGGED) {
    const Seg s = ragged_tile(offsets, G, M, BM, blockIdx.y);
    if (s.g < 0) return;
    if (s.g == G) {
      zero_rows(out, s.row0, min(s.row0 + BM, s.row_end), n0, TC_BN, N);
      return;
    }
    g = s.g, split = 0, m0 = s.row0, row_end = s.row_end, og = 0;
  } else {
    g = blockIdx.z / splits, split = blockIdx.z % splits;
    m0 = blockIdx.y * BM, row_end = M, og = g;
  }
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_slabs = (k_end - k_begin + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (t != 0) return;
    for (int i = 0; i < n_slabs; ++i) {
      const int s = i % TC_STAGES;
      if (i >= TC_STAGES) mbar_wait(&empty[s], ((i / TC_STAGES) - 1) & 1);
      uint8_t* a = smem + s * STAGE;
      const int k0 = k_begin + i * TC_BK;
      mbar_expect_tx(&full[s], STAGE);
      tma_load_3d(a, &tmap_x, &full[s], k0, m0, og);
      tma_load_3d(a + A_BYTES, &tmap_w, &full[s], n0, k0, g);
      tma_load_3d(a + A_BYTES + HALF_B, &tmap_w, &full[s], n0 + 64, k0, g);
    }
    return;
  }

  const int c = wg - 1;                 // this warpgroup's 64-row slice
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int i = 0; i < n_slabs; ++i) {
    const int s = i % TC_STAGES;
    mbar_wait(&full[s], (i / TC_STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + c * 64 * 128;
    const uint8_t* b = smem + s * STAGE + A_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      // A: K-major, the k-step 32 bytes along the swizzled row (SBO: 8
      // rows of 128 bytes); B: N-major, the k-step 16 rows of 128 bytes
      // (LBO: the next 64-column half, SBO: 8 rows)
      wgmma_m64n128k16(d, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 2048, HALF_B, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    mbar_arrive(&empty[s]);
  }

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1) of n-tile j
  const int warp = t / 32, lane = t % 32;
  const int row_a = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= row_end || col >= N) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      const long long i = ((long long)og * M + row) * N + col;
      if (partial) {
        float* p = partial + (long long)split * G * M * N + i;
        p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      } else if (col + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + i) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        out[i] = __float2bfloat16(v0);
        if (col + 1 < N) out[i + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null if the driver does not have it.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 3-D map of (inner, mid, outer) with byte strides of mid and outer,
// boxes of (64, box_mid, 1), 128-byte swizzle, zero fill out of bounds.
bool encode_map(CUtensorMap* map, const void* base, long long inner,
                long long mid, long long outer, long long stride_mid,
                long long stride_outer, int box_mid) {
  auto enc = tensor_map_encoder();
  if (!enc) return false;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                        (cuuint64_t)outer};
  cuuint64_t strides[2] = {(cuuint64_t)stride_mid * 2,
                           (cuuint64_t)stride_outer * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)box_mid, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ragged entry: x [M, K] (one group in its map), w's G groups, the
// grid's y the ``ragged_tile`` slots, one split.
template <int NC, bool RAGGED>
int launch_wgmma(const void* x, const void* w, void* out, float* partial,
                 int splits, int k_per_split, int G, int M, int K, int N,
                 long long sxg, long long sxm, long long swg, long long swk,
                 cudaStream_t st, const int* offsets = nullptr) {
  constexpr int BM = 64 * NC;
  CUtensorMap mx, mw;
  if (!encode_map(&mx, x, K, M, RAGGED ? 1 : G, sxm, sxg, BM) ||
      !encode_map(&mw, w, N, K, G, swk, swg, TC_BK))
    return -4;
  constexpr int smem = tc_smem_bytes<NC>();
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        gemm_wgmma_kernel<NC, RAGGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* part = splits > 1 ? partial : nullptr;
  const dim3 grid((N + TC_BN - 1) / TC_BN,
                  RAGGED ? (M + BM - 1) / BM + G + 1 : (M + BM - 1) / BM,
                  RAGGED ? 1 : G * splits);
  gemm_wgmma_kernel<NC, RAGGED><<<grid, 128 * (NC + 1), smem, st>>>(
      mx, mw, o, part, splits, k_per_split, G, M, K, N, offsets);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)G * M * N;
  const int blocks = static_cast<int>(
      n / THREADS + 1 < 4096 ? n / THREADS + 1 : 4096);
  splitk_reduce_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
      partial, o, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------- decode-sized paths
constexpr int SK_MAX_SPLITS = 8;   // CTAs of a cluster (the portable limit)
constexpr int SK_BK = 64;          // mma_skinny: contraction rows per stage
constexpr int SK_STAGES = 4;       // ring stages of both decode tiles
constexpr int SK_THREADS = 128;    // mma_skinny: 4 warps

// 16 bytes global -> shared, asynchronously: the first ``bytes`` (0-16)
// from ``src``, the rest zero (0: src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16 bf16, row-major fragment) @ b (16 x 8 bf16,
// column-major fragment b0, b1).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes in range of an 8-element bf16 chunk with ``elems`` elements left.
__device__ __forceinline__ int chunk_bytes(int elems) {
  return elems <= 0 ? 0 : (elems >= 8 ? 16 : 2 * elems);
}

// Four outputs at p, the first ``n`` in range; ``vec``: p is 4-element
// aligned, so a full quad is one store.
__device__ __forceinline__ void store4(float* p, float4 v, int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) p[i] = e[i];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int n,
                                       bool vec) {
  if (vec && n >= 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) p[i] = __float2bfloat16(e[i]);
}

// The split-K merge and the tile's one write.  Every CTA of the cluster
// (gridDim.x of them; rank = blockIdx.x = its slice of the contraction)
// holds its f32 tile Cs [BN][CLD] (row: x row, column: output column).
// Rank r takes the r-th share of the tile's 4-column quads, adds each
// over ranks 0, 1, ... in order (every rank's partials loaded before any
// is added: the remote loads are in flight together) and writes it, cast
// to T.  One split: the CTA writes its own tile.
template <typename T, int BN, int BC, int CLD, int NT>
__device__ __forceinline__ void merge_and_store(const float* Cs,
                                                T* __restrict__ out, int g,
                                                int M, int N, int row0,
                                                int col0) {
  const int splits = gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rank = splits > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  constexpr int QPR = BC / 4, QUADS = BN * QPR;
  const int per = (QUADS + splits - 1) / splits;
  const int v_end = min(QUADS, (rank + 1) * per);
  const bool vec = (N & 3) == 0;
  for (int v = rank * per + static_cast<int>(threadIdx.x); v < v_end;
       v += NT) {
    const int r = v / QPR, c = (v % QPR) * 4;
    const int row = row0 + r, col = col0 + c;
    if (row >= M || col >= N) continue;
    float4 p[SK_MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < SK_MAX_SPLITS; ++s)
      if (s < splits)
        p[s] = *reinterpret_cast<const float4*>(
            (splits > 1 ? cluster.map_shared_rank(Cs, s) : Cs) + r * CLD +
            c);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < SK_MAX_SPLITS; ++s) {
      if (s < splits) {
        sum.x += p[s].x;
        sum.y += p[s].y;
        sum.z += p[s].z;
        sum.w += p[s].w;
      }
    }
    store4(out + ((long long)g * M + row) * N + col, sum, N - col, vec);
  }
  if (splits > 1) cluster.sync();  // peers' tiles stay until read
}

// Dynamic shared memory of a mma_skinny CTA, in bytes: SK_STAGES ring
// stages, each a w slab (SK_BK rows of BC bf16, padded by 16 bytes: the
// 8 rows an ldmatrix reads fall in distinct banks) and an x slab (BN rows
// of SK_BK bf16, padded the same).  After the walk the ring holds the f32
// output tile [BN][CLD].
template <int BN, int BC>
struct SkinnySmem {
  static constexpr int WLD = BC * 2 + 16;      // w row stride, bytes
  static constexpr int XLD = SK_BK * 2 + 16;   // x row stride, bytes
  static constexpr int CLD = BC + 4;           // f32 output row stride
  static constexpr int W = SK_BK * WLD;
  static constexpr int STAGE = W + BN * XLD;
  static constexpr int BYTES = SK_STAGES * STAGE;
  static_assert(BN * CLD * 4 <= BYTES, "output tile fits the ring");
  static_assert(W % 16 == 0 && STAGE % 16 == 0, "16-byte copies");
};

// One BN x BC output tile of the mma.sync decode tile: x rows [row0,
// min(row0 + BN, M)) read from xg (row stride sxm) times w's columns
// [col0, col0 + BC) read from wg (row stride swk) over the contraction
// rows [k_begin, k_end), merged over the cluster's CTAs (gridDim.x) and
// written to out's group g ([*, M, N] dense).  Warp w owns output columns
// [w BC / 4, (w + 1) BC / 4): MI m16 tiles (the A side: w's columns) by NI
// n8 tiles (the B side: x's rows).  SK_STAGES - 1 slabs are in flight
// while one is multiplied.  Leaves the ring free (the caller may reuse it
// after a barrier).
template <int BN, int BC>
__device__ __forceinline__ void skinny_mma_tile(
    uint8_t* smem, const __nv_bfloat16* __restrict__ xg,
    const __nv_bfloat16* __restrict__ wg, __nv_bfloat16* __restrict__ out,
    int g, int M, int N, int row0, int col0, int k_begin, int k_end,
    long long sxm, long long swk) {
  using L = SkinnySmem<BN, BC>;
  constexpr int MI = BC / 4 / 16;   // m16 tiles per warp
  constexpr int NI = BN / 8;        // n8 tiles per warp
  static_assert(MI >= 1 && (NI == 1 || NI % 2 == 0), "warp tile");
  const int n_slabs =
      k_end > k_begin ? (k_end - k_begin + SK_BK - 1) / SK_BK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the copies of slab ``i`` into stage ``i % SK_STAGES``: w rows [k0, k0
  // + 64) x columns [col0, col0 + BC), x rows [row0, row0 + BN) x [k0, k0
  // + 64); whatever lies past k_end, N or M is zero
  auto issue = [&](int i) {
    uint8_t* st = smem + (i % SK_STAGES) * L::STAGE;
    const int k0 = k_begin + i * SK_BK;
    constexpr int WCH = BC / 8;              // 16-byte chunks per w row
    for (int v = tid; v < SK_BK * WCH; v += SK_THREADS) {
      const int r = v / WCH, ch = v % WCH, col = col0 + ch * 8;
      const int bytes = k0 + r < k_end ? chunk_bytes(N - col) : 0;
      cp_async16(st + r * L::WLD + ch * 16,
                 bytes ? wg + (k0 + r) * swk + col : wg, bytes);
    }
    constexpr int XCH = SK_BK / 8;
    for (int v = tid; v < BN * XCH; v += SK_THREADS) {
      const int r = v / XCH, ch = v % XCH, k = k0 + ch * 8;
      const int bytes = row0 + r < M ? chunk_bytes(k_end - k) : 0;
      cp_async16(st + L::W + r * L::XLD + ch * 16,
                 bytes ? xg + (row0 + r) * sxm + k : xg, bytes);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
  const int lm = lane / 8, lr = lane % 8;
  const int gid = lane / 4, tig = lane % 4;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < n_slabs) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<SK_STAGES - 2>();   // this thread's copies of slab i
    __syncthreads();                  // everyone's; slab i - 1 consumed
    if (i + SK_STAGES - 1 < n_slabs) issue(i + SK_STAGES - 1);
    cp_async_commit();
    const uint8_t* ws = smem + (i % SK_STAGES) * L::STAGE;
    const uint8_t* xs = ws + L::W;
    const int steps = (min(SK_BK, k_end - k_begin - i * SK_BK) + 15) / 16;
    for (int kk = 0; kk < steps; ++kk) {
      // A: matrix j of the x4 is w rows k 8 (j / 2).. x columns 8 (j % 2)..
      // of this m16 tile, read transposed (a0..a3 of the row-major
      // fragment); B: x rows of each n8 tile at k lo / k hi (b0, b1)
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int a = 0; a < MI; ++a)
        ldmatrix_x4_trans(af[a], ws + (kk * 16 + (lm >> 1) * 8 + lr) * L::WLD +
                                     (warp * MI * 16 + a * 16 + (lm & 1) * 8) *
                                         2);
      if constexpr (NI == 1) {
        ldmatrix_x2(bf[0], xs + lr * L::XLD + (kk * 16 + (lm & 1) * 8) * 2);
      } else {
#pragma unroll
        for (int b = 0; b < NI; b += 2) {
          uint32_t r4[4];
          ldmatrix_x4(r4, xs + ((b + (lm >> 1)) * 8 + lr) * L::XLD +
                              (kk * 16 + (lm & 1) * 8) * 2);
          bf[b][0] = r4[0];
          bf[b][1] = r4[1];
          bf[b + 1][0] = r4[2];
          bf[b + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int b = 0; b < NI; ++b)
          mma_bf16(acc[a][b], af[a], bf[b][0], bf[b][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the output tile

  // ---- this CTA's f32 tile -> shared [BN][CLD]: accumulator row gid (+ 8)
  // is output column gid (+ 8) of the m16 tile, its columns 2 tig (+ 1)
  // are x rows of the n8 tile
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b) {
      const int c = warp * MI * 16 + a * 16 + gid, r = b * 8 + 2 * tig;
      Cs[r * L::CLD + c] = acc[a][b][0];
      Cs[(r + 1) * L::CLD + c] = acc[a][b][1];
      Cs[r * L::CLD + c + 8] = acc[a][b][2];
      Cs[(r + 1) * L::CLD + c + 8] = acc[a][b][3];
    }
  merge_and_store<__nv_bfloat16, BN, BC, L::CLD, SK_THREADS>(Cs, out, g, M,
                                                             N, row0, col0);
}

// BN x rows x BC output columns of group g per CTA; gridDim.x = the
// slices of the contraction (the CTAs of one cluster), y = column tiles,
// z = G x row tiles.
template <int BN, int BC>
__global__ void __launch_bounds__(SK_THREADS) gemm_skinny_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int per_split, int M, int K, int N,
    long long sxg, long long sxm, long long swg, long long swk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_tiles = (M + BN - 1) / BN;
  const int g = blockIdx.z / row_tiles, row0 = (blockIdx.z % row_tiles) * BN;
  const int k_begin = blockIdx.x * per_split;
  skinny_mma_tile<BN, BC>(smem, x + g * sxg, w + g * swg, out, g, M, N, row0,
                          blockIdx.y * BC, k_begin,
                          min(K, k_begin + per_split), sxm, swk);
}

// The CUDA-core decode tile: FMA_BM x rows x BC output columns per CTA
// of 2 BC threads (x row tid / (BC / 4), output columns 4 (tid % (BC / 4))
// .. + 3), BC = 128, 64 or 32.  FMA_BK-deep slabs of w ([FMA_BK, BC])
// and x ([FMA_BM, FMA_BK]) are kept as loaded (f32 or bf16) in a ring of
// SK_STAGES stages.
constexpr int FMA_BM = 8, FMA_BK = 32;

template <typename T, int BC>
struct FmaSmem {
  static constexpr int W = FMA_BK * BC * sizeof(T);
  static constexpr int STAGE = W + FMA_BM * FMA_BK * sizeof(T);
  static constexpr int BYTES = SK_STAGES * STAGE;
  static constexpr int CLD = BC + 4;          // f32 output row stride
  static_assert(FMA_BM * CLD * 4 <= BYTES, "output tile fits the ring");
  static_assert(W % 16 == 0 && STAGE % 16 == 0, "16-byte copies");
};

// 4 bytes global -> shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Elements src[0..3] -> shared dst, the first ``n`` in range (the rest 0;
// n <= 0: src is not read, ``base`` stands in).  f32 goes by cp.async: one
// 16-byte copy when ``vec`` (src 16-byte aligned), else four 4-byte copies.
// bf16 (only the calls mma_skinny cannot take come here, their rows not
// 16-byte aligned) is loaded and stored: an 8-byte vector where ``vec``.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       const float* base, int n, bool vec) {
  if (vec) {
    cp_async16(dst, n > 0 ? src : base, 4 * max(0, min(n, 4)));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + e, e < n ? src + e : base, e < n);
  }
}
__device__ __forceinline__ void stage4(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src,
                                       const __nv_bfloat16*, int n,
                                       bool vec) {
  *reinterpret_cast<Quad<__nv_bfloat16>*>(dst) = load4(src, n, vec);
}

// Four consecutive staged elements, widened to f32.
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One FMA_BM x BC output tile of the CUDA-core decode tile, as
// skinny_mma_tile's (2 BC threads).
template <typename T, int BC>
__device__ __forceinline__ void skinny_fma_tile(
    uint8_t* smem, const T* __restrict__ xg, const T* __restrict__ wg,
    T* __restrict__ out, int g, int M, int N, int row0, int col0,
    int k_begin, int k_end, long long sxm, long long swk, bool vec_x,
    bool vec_w) {
  using L = FmaSmem<T, BC>;
  constexpr int BK = FMA_BK;
  constexpr int NT = 2 * BC, QPR = BC / 4;        // threads, quads a row
  constexpr int W_QUADS = BK * QPR;                // 4 per thread
  constexpr int X_QUADS = FMA_BM * BK / 4;         // threads 0..63
  static_assert(W_QUADS % NT == 0 && X_QUADS <= NT, "loader");
  const int n_slabs = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x, tx = tid % QPR, ty = tid / QPR;

  // slab ``i`` into stage ``i % SK_STAGES``; past k_end, N or M is zero
  auto issue = [&](int i) {
    T* ws = reinterpret_cast<T*>(smem + (i % SK_STAGES) * L::STAGE);
    T* xs = reinterpret_cast<T*>(smem + (i % SK_STAGES) * L::STAGE + L::W);
    const int k0 = k_begin + i * BK;
#pragma unroll
    for (int j = 0; j < W_QUADS / NT; ++j) {
      const int v = tid + j * NT, r = v / QPR, c = (v % QPR) * 4;
      const int col = col0 + c;
      stage4(ws + r * BC + c, wg + (k0 + r) * swk + col, wg,
             k0 + r < k_end ? N - col : 0, vec_w);
    }
    if (tid < X_QUADS) {
      const int r = tid / (BK / 4), c = (tid % (BK / 4)) * 4;
      const int k = k0 + c;
      stage4(xs + r * BK + c, xg + (row0 + r) * sxm + k, xg,
             row0 + r < M ? k_end - k : 0, vec_x);
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < n_slabs) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<SK_STAGES - 2>();    // this thread's copies of slab i
    __syncthreads();                   // everyone's; slab i - 1 consumed
    if (i + SK_STAGES - 1 < n_slabs) issue(i + SK_STAGES - 1);
    cp_async_commit();
    const uint8_t* st = smem + (i % SK_STAGES) * L::STAGE;
    const T* ws = reinterpret_cast<const T*>(st);
    const T* xs = reinterpret_cast<const T*>(st + L::W);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a = to_f32(xs[ty * BK + kk]);  // a broadcast
      const float4 b = widen4(ws + kk * BC + tx * 4);
      acc[0] = fmaf(a, b.x, acc[0]);
      acc[1] = fmaf(a, b.y, acc[1]);
      acc[2] = fmaf(a, b.z, acc[2]);
      acc[3] = fmaf(a, b.w, acc[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the output tile

  float* Cs = reinterpret_cast<float*>(smem);
  *reinterpret_cast<float4*>(Cs + ty * L::CLD + tx * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  merge_and_store<T, FMA_BM, BC, L::CLD, NT>(Cs, out, g, M, N, row0, col0);
}

// Grid as gemm_skinny_mma_kernel's, with FMA_BM x BC tiles.
template <typename T, int BC>
__global__ void __launch_bounds__(2 * BC) gemm_skinny_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int per_split, int M, int K, int N, long long sxg, long long sxm,
    long long swg, long long swk, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_tiles = (M + FMA_BM - 1) / FMA_BM;
  const int g = blockIdx.z / row_tiles;
  const int row0 = (blockIdx.z % row_tiles) * FMA_BM;
  const int k_begin = blockIdx.x * per_split;
  skinny_fma_tile<T, BC>(smem, x + g * sxg, w + g * swg, out, g, M, N, row0,
                         blockIdx.y * BC, k_begin, min(K, k_begin + per_split),
                         sxm, swk, vec_x, vec_w);
}

// The ragged entry's decode-sized tiling: blockIdx.z = group g (G: the
// zero tail), y = column tile of RG_BC; the segment's rows RG_BN at a time
// (each pass streams w[g]'s column tile again), one CTA a cluster.  x and
// out are [R, *] (R rows), their rows global.  MMA: bf16 on the mma.sync
// tile, else T's CUDA-core tile.
constexpr int RG_BN = 8, RG_BC = 128;

template <typename T, bool MMA>
__global__ void __launch_bounds__(MMA ? SK_THREADS : 2 * RG_BC)
    gemm_ragged_skinny_kernel(const T* __restrict__ x,
                              const T* __restrict__ w, T* __restrict__ out,
                              const int* __restrict__ offsets, int G, int R,
                              int K, int N, long long sxm, long long swg,
                              long long swk, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.z, col0 = blockIdx.y * RG_BC;
  if (g == G) {
    zero_rows(out, min(max(offsets[G], 0), R), R, col0, RG_BC, N);
    return;
  }
  const int lo = min(max(offsets[g], 0), R);
  const int hi = min(max(offsets[g + 1], 0), R);
  const T* wg = w + g * swg;
  for (int row0 = lo; row0 < hi; row0 += RG_BN) {
    if constexpr (MMA)
      skinny_mma_tile<RG_BN, RG_BC>(smem, x, wg, out, 0, hi, N, row0, col0,
                                    0, K, sxm, swk);
    else
      skinny_fma_tile<T, RG_BC>(smem, x, wg, out, 0, hi, N, row0, col0, 0,
                                K, sxm, swk, vec_x, vec_w);
    __syncthreads();                  // the next pass refills the ring
  }
}

// One launch of ``kern`` with ``splits`` CTAs along x in a cluster.
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), dim3 grid, int threads, int smem,
                   int splits, cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, args...);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int BC>
int launch_skinny_mma(const void* x, const void* w, void* out, int splits,
                      int per_split, int G, int M, int K, int N,
                      long long sxg, long long sxm, long long swg,
                      long long swk, cudaStream_t st) {
  using L = SkinnySmem<BN, BC>;
  auto kern = gemm_skinny_mma_kernel<BN, BC>;
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  const dim3 grid(splits, (N + BC - 1) / BC, G * ((M + BN - 1) / BN));
  return launch_cluster(kern, grid, SK_THREADS, L::BYTES, splits, st,
                        static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(w),
                        static_cast<__nv_bfloat16*>(out), per_split, M, K, N,
                        sxg, sxm, swg, swk);
}

template <typename T, int BC>
int launch_skinny_fma(const void* x, const void* w, void* out, int splits,
                      int per_split, int G, int M, int K, int N,
                      long long sxg, long long sxm, long long swg,
                      long long swk, bool vec_x, bool vec_w,
                      cudaStream_t st) {
  using L = FmaSmem<T, BC>;
  auto kern = gemm_skinny_fma_kernel<T, BC>;
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  const dim3 grid(splits, (N + BC - 1) / BC, G * ((M + FMA_BM - 1) / FMA_BM));
  return launch_cluster(kern, grid, 2 * BC, L::BYTES, splits, st,
                        static_cast<const T*>(x), static_cast<const T*>(w),
                        static_cast<T*>(out), per_split, M, K, N, sxg, sxm,
                        swg, swk, vec_x, vec_w);
}

template <typename T, bool MMA>
int launch_ragged_skinny(const void* x, const void* w, void* out,
                         const int* offsets, int G, int R, int K, int N,
                         long long sxm, long long swg, long long swk,
                         bool vec_x, bool vec_w, cudaStream_t st) {
  constexpr int smem = MMA ? SkinnySmem<RG_BN, RG_BC>::BYTES
                           : FmaSmem<T, RG_BC>::BYTES;
  auto kern = gemm_ragged_skinny_kernel<T, MMA>;
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  const dim3 grid(1, (N + RG_BC - 1) / RG_BC, G + 1);
  return launch_cluster(kern, grid, MMA ? SK_THREADS : 2 * RG_BC, smem, 1,
                        st, static_cast<const T*>(x), static_cast<const T*>(w),
                        static_cast<T*>(out), offsets, G, R, K, N, sxm, swg,
                        swk, vec_x, vec_w);
}

template <int MH>
int launch_ragged_tiled(const void* x, const void* w, void* out,
                        const int* offsets, int G, int R, int K, int N,
                        long long sxm, long long swg, long long swk,
                        bool vec_x, bool vec_w, cudaStream_t st) {
  constexpr int BM = 64 * MH;
  const dim3 grid((N + 127) / 128, (R + BM - 1) / BM + G + 1, 1);
  gemm_tiled_kernel<float, MH, true><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), nullptr, 1, K, G, R, K, N, 0, sxm, swg, swk,
      vec_x, vec_w, offsets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [G, M, N] dense = x [G, M, K] @ w [G, K, N] in ``dtype`` (0 f32, 1
// bf16); x and w through (group, row) strides in elements, the last dim
// dense.  ``tile_m``: 64 or 128 (tiled) output rows per CTA.
// ``splits`` > 1 splits the contraction into slices of ``k_per_split``
// (a multiple of the tile's slab depth, every slice non-empty) through the
// f32 workspace ``partial`` [splits, G, M, N].  ``vec_x`` / ``vec_w``: the
// pointer and strides are 4-element aligned.  Returns cudaGetLastError()
// after the launches, -2 for an unsupported dtype, -3 for an unknown tile.
extern "C" int grouped_matmul_launch(int dtype, int tile_m, const void* x,
                                     const void* w, void* out,
                                     float* partial, int splits,
                                     int k_per_split, int G, int M, int K,
                                     int N, long long sxg, long long sxm,
                                     long long swg, long long swk, int vec_x,
                                     int vec_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_typed<float>(tile_m, x, w, out, partial, splits,
                               k_per_split, G, M, K, N, sxg, sxm, swg, swk,
                               vec_x != 0, vec_w != 0, st);
  if (dtype == BF16)
    return launch_typed<__nv_bfloat16>(tile_m, x, w, out, partial, splits,
                                       k_per_split, G, M, K, N, sxg, sxm,
                                       swg, swk, vec_x != 0, vec_w != 0, st);
  return -2;
}

// The bf16 tensor-core path: out [G, M, N] dense = x [G, M, K] @ w [G, K, N],
// both bf16, through (group, row) strides in elements (the last dim dense;
// pointers and strides 16-byte aligned, K >= 1).  ``consumers`` (1-3)
// consumer warpgroups of 64 rows each per CTA.  ``splits`` and
// ``k_per_split`` (a multiple of 64) as for grouped_matmul_launch.  Returns
// cudaGetLastError() after the launches, -3 for an unknown consumer
// count, -4 when the tensor maps cannot be encoded, -5 when the current
// device cannot be read.
extern "C" int grouped_matmul_wgmma_launch(
    int consumers, const void* x, const void* w, void* out, float* partial,
    int splits, int k_per_split, int G, int M, int K, int N, long long sxg,
    long long sxm, long long swg, long long swk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TC_ARGS x, w, out, partial, splits, k_per_split, G, M, K, N, sxg, \
                sxm, swg, swk, st
  switch (consumers) {
    case 1: return launch_wgmma<1, false>(TC_ARGS);
    case 2: return launch_wgmma<2, false>(TC_ARGS);
    case 3: return launch_wgmma<3, false>(TC_ARGS);
    default: return -3;
  }
#undef TC_ARGS
}


// The decode-sized paths' fixed arguments, as _gemm_launch.py's
// _SkinnyArgs lays them out: one struct per call shape, built once on the
// host, so a call passes five pointers.
struct SkinnyArgs {
  int dtype;       // 0 f32, 1 bf16
  int mma;         // 1: mma_skinny (bf16); 0: skinny (CUDA-core FMAs)
  int rows, cols;  // x rows x output columns per CTA
  int splits;      // CTAs of a cluster (1-8), slices of the contraction
  int per_split;   // contraction rows per slice, a multiple of 16
  int G, M, K, N;
  long long sxg, sxm, swg, swk;
  int vec_x, vec_w;
};

// The decode-sized paths (M <= 32): out [G, M, N] dense = x [G, M, K] @ w
// [G, K, N] through (group, row) strides in elements, the last dim dense.
// mma_skinny: bf16, pointers and strides 16-byte aligned, ``rows`` 8, 16
// or 32.  skinny: f32 or bf16, rows 8, ``vec_x`` / ``vec_w`` as for
// grouped_matmul_launch.  ``cols`` 128 or 64 (skinny also 32).
// ``splits`` CTAs of a
// cluster each take ``per_split`` contraction rows (every slice
// non-empty) and merge inside the launch.  One launch, no workspace.
// Returns cudaGetLastError() after it (or the launch's own error), -2 for
// an unsupported dtype, -3 for an unknown tile or split count, -5 when the
// current device cannot be read.
extern "C" int grouped_matmul_skinny_launch(const SkinnyArgs* a,
                                            const void* x, const void* w,
                                            void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->splits < 1 || a->splits > SK_MAX_SPLITS || a->per_split % 16 ||
      (a->cols != 32 && a->cols != 64 && a->cols != 128) ||
      (a->mma && a->cols == 32))
    return -3;
  const bool wide = a->cols == 128, narrow = a->cols == 32;
#define SK_ARGS x, w, out, a->splits, a->per_split, a->G, a->M, a->K, a->N, \
                a->sxg, a->sxm, a->swg, a->swk
#define SK_MMA(BN)                                                  \
  (wide ? launch_skinny_mma<BN, 128>(SK_ARGS, st)                   \
        : launch_skinny_mma<BN, 64>(SK_ARGS, st))
#define SK_FMA_AT(T, BC) \
  launch_skinny_fma<T, BC>(SK_ARGS, a->vec_x != 0, a->vec_w != 0, st)
#define SK_FMA(T)                           \
  (wide ? SK_FMA_AT(T, 128)                 \
        : narrow ? SK_FMA_AT(T, 32) : SK_FMA_AT(T, 64))
  if (a->mma) {
    if (a->dtype != BF16) return -2;
    switch (a->rows) {
      case 8: return SK_MMA(8);
      case 16: return SK_MMA(16);
      case 32: return SK_MMA(32);
      default: return -3;
    }
  }
  if (a->rows != FMA_BM) return -3;
  if (a->dtype == F32) return SK_FMA(float);
  if (a->dtype == BF16) return SK_FMA(__nv_bfloat16);
  return -2;
#undef SK_FMA
#undef SK_FMA_AT
#undef SK_MMA
#undef SK_ARGS
}


// The ragged entry (see the head of this file): out [R, N] dense; rows
// offsets[g] .. offsets[g + 1] of x [R, K] (row stride ``sxm``) times w[g]
// of w [G, K, N] (group and row strides ``swg``, ``swk``; last dims
// dense), rows at or past offsets[G] zero; ``offsets`` [G + 1] int32 on
// the device, non-decreasing from 0 to at most R.  ``tiling`` 0:
// decode-sized (bf16 on mma.sync, f32 on FMAs; ``tile`` unused); 1:
// prefill-sized, ``tile`` the consumer warpgroups of the bf16 wgmma tile
// (1-3) or the rows of the f32 tile (64 or 128).  bf16 needs its pointers
// and strides 16-byte aligned; ``vec_x`` / ``vec_w`` as for
// grouped_matmul_launch (f32).  One launch.  Returns cudaGetLastError()
// after it (or the launch's own error), -2 for an unsupported dtype, -3
// for an unknown tiling or tile, -4 / -5 as grouped_matmul_wgmma_launch.
extern "C" int grouped_matmul_ragged_launch(
    int dtype, int tiling, int tile, const void* x, const void* w,
    const int* offsets, void* out, int G, int R, int K, int N,
    long long sxm, long long swg, long long swk, int vec_x, int vec_w,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return -2;
  const bool bf = dtype == BF16, vx = vec_x != 0, vw = vec_w != 0;
#define RG_ARGS x, w, out, offsets, G, R, K, N, sxm, swg, swk, vx, vw, st
  if (tiling == 0)
    return bf ? launch_ragged_skinny<__nv_bfloat16, true>(RG_ARGS)
              : launch_ragged_skinny<float, false>(RG_ARGS);
#undef RG_ARGS
  if (tiling != 1) return -3;
#define RG_TC x, w, out, nullptr, 1, K, G, R, K, N, (long long)R * sxm, sxm, \
              swg, swk, st, offsets
  if (bf) {
    switch (tile) {
      case 1: return launch_wgmma<1, true>(RG_TC);
      case 2: return launch_wgmma<2, true>(RG_TC);
      case 3: return launch_wgmma<3, true>(RG_TC);
      default: return -3;
    }
  }
#undef RG_TC
  switch (tile) {
    case 64:
      return launch_ragged_tiled<1>(x, w, out, offsets, G, R, K, N, sxm, swg,
                                    swk, vx, vw, st);
    case 128:
      return launch_ragged_tiled<2>(x, w, out, offsets, G, R, K, N, sxm, swg,
                                    swk, vx, vw, st);
    default:
      return -3;
  }
}
