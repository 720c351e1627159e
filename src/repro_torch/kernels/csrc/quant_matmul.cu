// Blockwise-scaled int8 / int4 weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   quant_matmul   src/repro/kernels/quant_matmul.py
//                  (_qmm_kernel, pallas_call at :152)
//
// out[g] = x[g] @ dequant(q[g], scales[g]) for every branch g, where x is
// [G, T, D] (f32 or bf16), q holds int8 codes [G, D, E] (int8) or two 4-bit
// codes per byte [G, D/2, E] (int4), and scales are f32 [G, D/group, E].
// int4 packs within a group: the low nibble of stored row gi*group/2 + p is
// contraction row gi*group + p, its high nibble row gi*group + group/2 + p.
//
// What it computes is the TPU kernel's: the contraction is walked one group
// at a time; each group's product is taken on the integer codes in f32 and
// scaled once by the group's per-column scale into an f32 accumulator, so
// the weight is never dequantized to memory.  Codes from -127 to 127 are
// exact in f32 (and in bf16), and f32 x is multiplied in full f32 on the
// CUDA cores (no TF32).  The output is cast to x's dtype.
//
// Grid.  One CTA per (tile of BE output columns, tile of BT rows, branch x
// split of the groups).  A CTA walks its split's groups and stages a slab of
// KS contraction rows at a time in shared memory:
// the codes as f32 (int4 unpacked in registers on the way) and the matching
// x columns, then every thread adds its RT x CT outputs' slab products.
// Rows and columns past T and E are masked, so any T (1, ragged) and any E
// work; any group size works (int4 needs an even one).
//
// Bound.  At decode (T = 8 lanes) the kernel reads every code byte once and
// does 2 * T flops per byte: it is bound by device-memory bytes, and one
// projection has too few output tiles to fill 132 SMs (64 tiles of
// BT = 8 x BE = 32 at E = 2048).  So decode-sized calls also split the
// groups over CTAs (the caller picks the split count): each split writes its
// f32 partial sums to a workspace [S, G, T, E], and a second kernel adds the
// S partials in order (deterministic) and casts.  At a 1024-row prefill
// the kernel is bound by its f32 CUDA-core arithmetic (64 x 64 tiles, 16
// outputs per thread).  Tensor-core tiles (bf16 x bf16 -> f32 mma / wgmma:
// the codes are exact in bf16), wider code loads and cp.async/TMA
// pipelining are later work.
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

// Sign-extended low / high nibble of a packed int4 byte.
__device__ __forceinline__ int lo_nibble(int8_t v) {
  return static_cast<int>(static_cast<int8_t>(
             static_cast<uint8_t>(static_cast<uint8_t>(v) << 4))) >> 4;
}
__device__ __forceinline__ int hi_nibble(int8_t v) {
  return static_cast<int>(v) >> 4;
}

// BT x BE output tile per CTA, KS contraction rows per shared-memory slab,
// RT x CT outputs per thread (rows ty + i * TY, columns tx + j * TX).
template <typename XT, bool INT4, int BT, int BE, int KS, int RT, int CT>
__global__ void __launch_bounds__(THREADS) quant_matmul_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, XT* __restrict__ out,
    float* __restrict__ partial, int splits, int G, int T, int D, int E,
    int group) {
  constexpr int TX = BE / CT;
  constexpr int TY = BT / RT;
  constexpr int SLAB = INT4 ? KS / 2 : KS;   // stored code rows per slab
  static_assert(TX * TY == THREADS && BE % CT == 0 && BT % RT == 0, "tile");
  static_assert(KS % 2 == 0, "an int4 slab pairs low and high nibbles");

  __shared__ float xs[BT][KS + 1];
  __shared__ float ws[KS][BE];

  const int g = blockIdx.z / splits, split = blockIdx.z % splits;
  const int col0 = blockIdx.x * BE;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n_groups = D / group;
  const int per_split = (n_groups + splits - 1) / splits;
  const int g_end = min(n_groups, (split + 1) * per_split);
  const int span = INT4 ? group / 2 : group;  // stored code rows per group
  const XT* xg = x + (long long)g * T * D;
  const int8_t* qg = q + (long long)g * n_groups * span * E;
  const float* sg = scales + (long long)g * n_groups * E;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (int gi = split * per_split; gi < g_end; ++gi) {
    float part[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) part[i][j] = 0.f;

    for (int p0 = 0; p0 < span; p0 += SLAB) {
      const int n = min(SLAB, span - p0);
      // ---- codes -> ws as f32.  int4: slab row r holds the low nibbles of
      // stored row p0 + r, slab row SLAB + r its high nibbles.
      for (int i = tid; i < SLAB * BE; i += THREADS) {
        const int r = i / BE, c = i % BE, col = col0 + c;
        float lo = 0.f, hi = 0.f;
        if (r < n && col < E) {
          const int8_t v = qg[(long long)(gi * span + p0 + r) * E + col];
          if constexpr (INT4) {
            lo = static_cast<float>(lo_nibble(v));
            hi = static_cast<float>(hi_nibble(v));
          } else {
            lo = static_cast<float>(v);
          }
        }
        ws[r][c] = lo;
        if constexpr (INT4) ws[SLAB + r][c] = hi;
      }
      // ---- the matching x columns -> xs (slab column k <-> ws row k)
      for (int i = tid; i < BT * KS; i += THREADS) {
        const int rr = i / KS, k = i % KS, row = row0 + rr;
        const int r = INT4 ? k % SLAB : k;
        float v = 0.f;
        if (r < n && row < T) {
          int d = gi * group + p0 + r;
          if (INT4 && k >= SLAB) d += group / 2;
          v = to_f32(xg[(long long)row * D + d]);
        }
        xs[rr][k] = v;
      }
      __syncthreads();

      // ---- this slab's products on the integer codes
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        float xv[RT], wv[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) xv[i] = xs[ty + i * TY][k];
#pragma unroll
        for (int j = 0; j < CT; ++j) wv[j] = ws[k][tx + j * TX];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            part[i][j] = fmaf(xv[i], wv[j], part[i][j]);
      }
      __syncthreads();   // the next slab overwrites xs / ws
    }

    // ---- scale the group's product once into the accumulator
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = col0 + tx + j * TX;
      const float sc = col < E ? sg[(long long)gi * E + col] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][j] += part[i][j] * sc;
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + ty + i * TY;
    if (row >= T) continue;
    const long long base = ((long long)g * T + row) * E;
    float* p = partial ? partial + (long long)split * G * T * E + base
                       : nullptr;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int col = col0 + tx + j * TX;
      if (col >= E) continue;
      if (p) p[col] = acc[i][j];
      else store_as(out + base + col, acc[i][j]);
    }
  }
}

// out[i] = sum over splits s (in order) of partial[s * n + i], cast.
template <typename XT>
__global__ void __launch_bounds__(THREADS) splitk_reduce_kernel(
    const float* __restrict__ partial, XT* __restrict__ out, long long n,
    int splits) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * n + i];
    store_as(out + i, s);
  }
}

template <typename XT, bool INT4, int BT, int BE, int KS, int RT, int CT>
int launch_tile(const void* x, const void* q, const float* scales, void* out,
                float* partial, int splits, int G, int T, int D, int E,
                int group, cudaStream_t stream) {
  const dim3 grid((E + BE - 1) / BE, (T + BT - 1) / BT, G * splits);
  quant_matmul_kernel<XT, INT4, BT, BE, KS, RT, CT>
      <<<grid, THREADS, 0, stream>>>(
          static_cast<const XT*>(x), static_cast<const int8_t*>(q), scales,
          static_cast<XT*>(out), splits > 1 ? partial : nullptr, splits, G, T,
          D, E, group);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)G * T * E;
  const int blocks = static_cast<int>(
      n / THREADS + 1 < 4096 ? n / THREADS + 1 : 4096);
  splitk_reduce_kernel<XT><<<blocks, THREADS, 0, stream>>>(
      partial, static_cast<XT*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool INT4>
int launch_typed(const void* x, const void* q, const float* scales, void* out,
                 float* partial, int splits, int G, int T, int D, int E,
                 int group, cudaStream_t stream) {
  // decode-sized T (<= 32): narrow tiles and split groups for more
  // CTAs, a whole 128-row group per slab; prefill-sized T: 64 x 64 tiles,
  // 16 outputs per thread, no split.
  if (T <= 32)
    return launch_tile<XT, INT4, 8, 32, 128, 1, 1>(
        x, q, scales, out, partial, splits, G, T, D, E, group, stream);
  if (splits != 1) return -3;
  return launch_tile<XT, INT4, 64, 64, 32, 4, 4>(
      x, q, scales, out, partial, 1, G, T, D, E, group, stream);
}

}  // namespace

// x/out [G, T, D] / [G, T, E] in x_dtype (0 f32, 1 bf16); q int8 codes
// [G, D, E] (bits 8) or packed [G, D/2, E] (bits 4); scales f32
// [G, D/group, E]; all contiguous.  ``splits`` > 1 (only for T <= 32, every
// split non-empty) splits the groups over CTAs through the f32 workspace
// ``partial`` [splits, G, T, E].  Returns cudaGetLastError() after the
// launches, -2 for an unsupported dtype / bit width, -3 for a split at
// prefill-sized T.
extern "C" int quant_matmul_launch(int x_dtype, int bits, const void* x,
                                   const void* q, const float* scales,
                                   void* out, float* partial, int splits,
                                   int G, int T, int D, int E, int group,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QM_ARGS x, q, scales, out, partial, splits, G, T, D, E, group, st
  if (x_dtype == F32 && bits == 8) return launch_typed<float, false>(QM_ARGS);
  if (x_dtype == F32 && bits == 4) return launch_typed<float, true>(QM_ARGS);
  if (x_dtype == BF16 && bits == 8)
    return launch_typed<__nv_bfloat16, false>(QM_ARGS);
  if (x_dtype == BF16 && bits == 4)
    return launch_typed<__nv_bfloat16, true>(QM_ARGS);
#undef QM_ARGS
  return -2;
}
