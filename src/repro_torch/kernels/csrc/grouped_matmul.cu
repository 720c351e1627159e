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
// Three paths; the caller picks one from dtype, shape and alignment alone
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
//   skinny (M <= 32, both dtypes).
//     Bound: the bytes of w (8 decode rows).  Design: 8 x 128 outputs per
//     CTA, 32-deep slabs, one row and 4 columns per thread.
// Loads of the two CUDA-core paths are 4-element vectors where the pointer
// and strides allow it (the caller says so), scalars otherwise.  When the
// output tiles alone cannot fill the card the contraction is also split
// over CTAs (every path): each split writes f32 partial sums to a workspace
// [S, G, M, N] and a second kernel adds them in order (deterministic) and
// casts.
#include <cuda.h>          // CUtensorMap (no driver call is linked)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int MH>
__global__ void __launch_bounds__(THREADS) gemm_tiled_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    float* __restrict__ partial, int splits, int k_per_split, int G, int M,
    int K, int N, long long sxg, long long sxm, long long swg, long long swk,
    bool vec_x, bool vec_w) {
  constexpr int BM = 64 * MH, BN = 128, BK = 16, PAD = 4;
  // x slab: BM rows x BK, 4-element chunks, MH per thread; w slab: BK rows
  // x BN, 2 chunks per thread
  static_assert(BM * BK / 4 == MH * THREADS && BK * BN / 4 == 2 * THREADS,
                "loader");
  __shared__ __align__(16) float As[2][BK][BM + PAD];   // transposed x slab
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int g = blockIdx.z / splits, split = blockIdx.z % splits;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xg = x + g * sxg;
  const T* wg = w + g * swg;

  Quad<T> ra[MH], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      const int c = tid + i * THREADS, row = row0 + c / 4;
      const int k = k0 + (c % 4) * 4;
      ra[i] = load4(xg + row * sxm + k, row < M ? k_end - k : 0, vec_x);
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
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (col < N) emit(out, partial, split, G, g, M, N, row, col, acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gemm_skinny_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    float* __restrict__ partial, int splits, int k_per_split, int G, int M,
    int K, int N, long long sxg, long long sxm, long long swg, long long swk,
    bool vec_x, bool vec_w) {
  constexpr int BM = 8, BN = 128, BK = 32;
  constexpr int A_CHUNKS = BM * BK / 4;            // 64: threads 0..63
  constexpr int B_PER_THREAD = BK * BN / 4 / THREADS;
  static_assert(A_CHUNKS <= THREADS && B_PER_THREAD * THREADS * 4 == BK * BN,
                "loader");
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int g = blockIdx.z / splits, split = blockIdx.z % splits;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const T* xg = x + g * sxg;
  const T* wg = w + g * swg;

  Quad<T> ra, rb[B_PER_THREAD];
  auto load = [&](int k0) {
    if (tid < A_CHUNKS) {
      const int row = row0 + tid / (BK / 4), k = k0 + (tid % (BK / 4)) * 4;
      ra = load4(xg + row * sxm + k, row < M ? k_end - k : 0, vec_x);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int c = tid + i * THREADS, k = k0 + c / 32;
      const int col = col0 + (c % 32) * 4;
      rb[i] = load4(wg + k * swk + col, k < k_end ? N - col : 0, vec_w);
    }
  };
  auto store = [&](int buf) {
    if (tid < A_CHUNKS) {
      const int r = tid / (BK / 4), kk = (tid % (BK / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][kk + e][r] = to_f32(ra.v[e]);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][c / 32][(c % 32) * 4]) =
          make_float4(to_f32(rb[i].v[0]), to_f32(rb[i].v[1]),
                      to_f32(rb[i].v[2]), to_f32(rb[i].v[3]));
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  load(k_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const bool more = k0 + BK < k_end;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a = As[buf][kk][ty];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      acc[0] = fmaf(a, b.x, acc[0]);
      acc[1] = fmaf(a, b.y, acc[1]);
      acc[2] = fmaf(a, b.z, acc[2]);
      acc[3] = fmaf(a, b.w, acc[3]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const int row = row0 + ty;
  if (row >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tx * 4 + j;
    if (col < N) emit(out, partial, split, G, g, M, N, row, col, acc[j]);
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
                swg, swk, vec_x, vec_w
  if (tile_m == 8)
    gemm_skinny_kernel<T><<<grid, THREADS, 0, st>>>(GM_ARGS);
  else if (tile_m == 64)
    gemm_tiled_kernel<T, 1><<<grid, THREADS, 0, st>>>(GM_ARGS);
  else if (tile_m == 128)
    gemm_tiled_kernel<T, 2><<<grid, THREADS, 0, st>>>(GM_ARGS);
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
// engine in 1024-byte atoms of 8 rows.
template <int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,
    const __grid_constant__ CUtensorMap tmap_w,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int splits,
    int k_per_split, int G, int M, int K, int N) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * TC_BK * 2;
  constexpr int HALF_B = TC_BK * 64 * 2;            // one 64-column half
  constexpr int STAGE = tc_stage_bytes<NC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * STAGE);
  uint64_t* empty = full + TC_STAGES;

  const int g = blockIdx.z / splits, split = blockIdx.z % splits;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
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
      tma_load_3d(a, &tmap_x, &full[s], k0, m0, g);
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
      if (row >= M || col >= N) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      const long long i = ((long long)g * M + row) * N + col;
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

template <int NC>
int launch_wgmma(const void* x, const void* w, void* out, float* partial,
                 int splits, int k_per_split, int G, int M, int K, int N,
                 long long sxg, long long sxm, long long swg, long long swk,
                 cudaStream_t st) {
  CUtensorMap mx, mw;
  if (!encode_map(&mx, x, K, M, G, sxm, sxg, 64 * NC) ||
      !encode_map(&mw, w, N, K, G, swk, swg, TC_BK))
    return -4;
  constexpr int smem = tc_smem_bytes<NC>();
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        gemm_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* part = splits > 1 ? partial : nullptr;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + 64 * NC - 1) / (64 * NC),
                  G * splits);
  gemm_wgmma_kernel<NC><<<grid, 128 * (NC + 1), smem, st>>>(
      mx, mw, o, part, splits, k_per_split, G, M, K, N);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)G * M * N;
  const int blocks = static_cast<int>(
      n / THREADS + 1 < 4096 ? n / THREADS + 1 : 4096);
  splitk_reduce_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
      partial, o, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [G, M, N] dense = x [G, M, K] @ w [G, K, N] in ``dtype`` (0 f32, 1
// bf16); x and w through (group, row) strides in elements, the last dim
// dense.  ``tile_m``: 8 (skinny), 64 or 128 (tiled) output rows per CTA.
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
    case 1: return launch_wgmma<1>(TC_ARGS);
    case 2: return launch_wgmma<2>(TC_ARGS);
    case 3: return launch_wgmma<3>(TC_ARGS);
    default: return -3;
  }
#undef TC_ARGS
}
