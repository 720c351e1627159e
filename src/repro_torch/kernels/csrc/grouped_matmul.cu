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
// and summed in f32, and the result is cast once to x's dtype.  f32 inputs
// are multiplied in full f32 on the CUDA cores (no TF32), bf16 inputs are
// widened to f32 on their way to shared memory.
//
// Layout.  x [G, M, K] and w [G, K, N] are read through their group and row
// strides (the last dim dense); out is a dense [G, M, N].  Any M, K, N and
// G: ragged edges are masked.  Loads are 4-element vectors where the
// pointer and strides allow it (the caller says so), scalars otherwise.
//
// Tiles.  Every thread holds a register tile of outputs and takes
// f32 products of shared-memory operands.
//   - tiled:  (64 MH) x 128 outputs per CTA of 256 threads, 16-deep slabs
//             double-buffered in shared memory (the next slab's loads are
//             in flight in registers while the current one is consumed);
//             each thread holds 4 MH x 8 outputs in two row and two
//             column quads 64 apart, so neighbouring threads read
//             neighbouring float4s (no bank conflicts).  MH = 2 for
//             prefill-sized M, 1 where 64-row tiles waste less padding
//             (MoE capacity 171: 192 rows instead of 256).
//   - skinny: 8 x 128 outputs per CTA, 32-deep slabs: decode-sized M
//             (<= 32 rows, in tiles of 8), one row and 4 columns per
//             thread.
// When the output tiles alone cannot fill the card the contraction is
// also split over CTAs: each split writes f32 partial sums to a workspace
// [S, G, M, N] and a second kernel adds them in order (deterministic) and
// casts.
//
// Bound.  At prefill-sized M the products are bound by arithmetic: f32 on
// CUDA cores (67 TFLOP/s), and bf16 here too, since it runs the same f32
// FMAs (tensor cores would give 989 TFLOP/s: mma.sync / wgmma tiles are
// later work).  At decode-sized M (8 lanes) and for the MoE weights in bf16
// the bytes of w bound it: the skinny tile and the split-K keep many loads
// in flight; cp.async / TMA pipelining is later work.
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
