// Paged GQA attention through a block table, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   paged_decode_attention   src/repro/kernels/paged_decode_attention.py
//                            (_paged_kernel, pallas_call at :130)
//   paged_prefill_attention  src/repro/kernels/paged_prefill_attention.py
//                            (_chunk_kernel, pallas_call at :132)
//
// Both are one kernel here.  A decode step is a prefill chunk of one token
// whose query sits at position ``length - 1``: the key rule ``kpos <= qpos``
// then equals the decode mask ``kpos < length``, and a length-0 pad row
// (qpos = -1) walks no key and writes acc / max(l, 1e-20) = 0.
//
// Layout.  The pools stay in the reference layout [P, bs, K, hd] (token
// stride K*hd, scale stride K), read through strides: no per-call transpose
// of the pool.  A leading branch dim (the semantic split's branches, each
// with its own pool) is a stride, so one launch serves every branch.  q and
// out are [G, B, C, H, hd]; block tables [B, NB] and positions are shared by
// the branches.
//
// Grid.  One CTA per (lane, kv head, branch x tile of query rows).  The rows
// of a CTA are the rep = H/K query heads of its kv head times the chunk
// positions, so each K/V token is read once per kv head and row tile.  A CTA
// reads its own block ids from the table (TPU scalar prefetch supplied them)
// and walks logical positions [0, min(NB*bs, max qpos + 1)) in tiles of
// TILE tokens with f32 online-softmax state (max, sum, acc) per row.  Head
// dims 32, 64 and 128 are instantiated; TILE is 32 tokens, or 16 where the
// static shared-memory arrays would pass 48 KB (prefill at head dim 128).
//
// Bound.  Decode reads every live K/V byte once per step and does ~4 flops
// per byte of bf16 K/V: it is bound by device-memory bytes.  The design
// reads each token row with 16-byte vector loads (dequantizing int8 in
// registers with the slot's f32 scale) and keeps scores, probabilities and
// the accumulator on chip.  Prefill chunks of 128 queries are bound by the
// CUDA-core f32 arithmetic of this simple tiling; tensor-core (wgmma) tiles,
// TMA, split-K over long caches and CUDA graphs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr int STATIC_SMEM = 48 * 1024;   // the static shared-memory limit

// Static shared memory of one CTA (the arrays declared in the kernel).
__host__ __device__ constexpr int smem_bytes(int hd, int rows, int tile) {
  return 4 * (rows * (hd + 1) + tile * (hd + 1) + tile * hd +
              rows * (tile + 1) + rows + 1);
}

// Key/value tokens per smem tile: 32, or 16 where 32 would not fit the
// static limit (prefill's 32 query rows at head dim 128: 53.8 KB vs 35.3).
__host__ __device__ constexpr int tile_for(int hd, int rows) {
  return smem_bytes(hd, rows, 32) <= STATIC_SMEM ? 32 : 16;
}

enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ROWS query rows per CTA; THREADS / ROWS threads share a row (a power of
// two <= 32, so a row's threads are one aligned segment of a warp); TILE
// key/value tokens per shared-memory tile.
template <typename QT, typename KVT, int HD, int ROWS, int TILE>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ qpos_src, int qpos_offset, QT* __restrict__ out,
    int B, int C, int H, int K, int bs, int NB, int n_row_tiles,
    long long pool_gstride, long long scale_gstride, float scale,
    float softcap) {
  constexpr int TPR = THREADS / ROWS;   // threads per query row
  constexpr int TPT = TILE / TPR;       // scores per thread per tile
  constexpr int DPT = HD / TPR;         // accumulator dims per thread
  constexpr int VEC = 16 / sizeof(KVT); // elements per 16-byte load
  constexpr int VPR = HD / VEC;         // 16-byte loads per token row
  static_assert(TPR <= 32 && 32 % TPR == 0, "row threads must tile a warp");
  static_assert(TILE % TPR == 0 && HD % TPR == 0 && HD % VEC == 0, "shape");
  static_assert(smem_bytes(HD, ROWS, TILE) <= STATIC_SMEM, "static smem");

  __shared__ float Qs[ROWS][HD + 1];
  __shared__ float Ks[TILE][HD + 1];
  __shared__ float Vs[TILE][HD];
  __shared__ float Ps[ROWS][TILE + 1];
  __shared__ int qpos_s[ROWS];
  __shared__ int kv_len_s;

  const int rep = H / K;
  const int n_rows = rep * C;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = blockIdx.z / n_row_tiles;
  const int row0 = (blockIdx.z % n_row_tiles) * ROWS;
  const int tid = threadIdx.x;

  // query rows (row = c * rep + r -> head kvh * rep + r), pre-scaled
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int rl = i / HD, d = i % HD, row = row0 + rl;
    float val = 0.f;
    if (row < n_rows) {
      const int c = row / rep, h = kvh * rep + row % rep;
      val = to_f32(q[(((long long)g * B + b) * C + c) * H * HD +
                     (long long)h * HD + d]) * scale;
    }
    Qs[rl][d] = val;
  }
  if (tid < ROWS) {
    const int row = row0 + tid;
    qpos_s[tid] = row < n_rows ? qpos_src[b * C + row / rep] + qpos_offset
                               : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int m = -1;
    for (int i = 0; i < ROWS; ++i) m = max(m, qpos_s[i]);
    kv_len_s = min(m + 1, NB * bs);   // clip the walk to the table
  }
  __syncthreads();

  const int kv_len = kv_len_s;
  const int rl = tid / TPR, lane = tid % TPR;
  const int my_qpos = qpos_s[rl];
  const int* table = block_tables + (long long)b * NB;
  const KVT* kp = k_pool + g * pool_gstride;
  const KVT* vp = v_pool + g * pool_gstride;
  const float* ksc = k_scale ? k_scale + g * scale_gstride : nullptr;
  const float* vsc = v_scale ? v_scale + g * scale_gstride : nullptr;

  float m_run = NEG_INF, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < kv_len; t0 += TILE) {
    // ---- K/V tile -> smem as f32 (int8 dequantized with the slot scale)
    for (int v = tid; v < TILE * VPR; v += THREADS) {
      const int t = v / VPR, d0 = (v % VPR) * VEC, kpos = t0 + t;
      float kf[VEC], vf[VEC];
      if (kpos < kv_len) {
        const long long slot = (long long)table[kpos / bs] * bs + kpos % bs;
        const long long base = (slot * K + kvh) * HD + d0;
        const uint4 kr = *reinterpret_cast<const uint4*>(kp + base);
        const uint4 vr = *reinterpret_cast<const uint4*>(vp + base);
        const KVT* ke = reinterpret_cast<const KVT*>(&kr);
        const KVT* ve = reinterpret_cast<const KVT*>(&vr);
        const float ks = ksc ? ksc[slot * K + kvh] : 1.f;
        const float vs = vsc ? vsc[slot * K + kvh] : 1.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[e] = to_f32(ke[e]) * ks;
          vf[e] = to_f32(ve[e]) * vs;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[t][d0 + e] = kf[e];
        Vs[t][d0 + e] = vf[e];
      }
    }
    __syncthreads();

    // ---- scores of this row over the tile, online-softmax update
    float s[TPT];
    float mloc = NEG_INF;
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int t = lane + i * TPR, kpos = t0 + t;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += Qs[rl][d] * Ks[t][d];
      if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
      const bool ok = kpos <= my_qpos && kpos < kv_len;
      s[i] = dot;
      if (ok) mloc = fmaxf(mloc, dot);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o, TPR));
    const float m_new = fmaxf(m_run, mloc);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int t = lane + i * TPR, kpos = t0 + t;
      const bool ok = kpos <= my_qpos && kpos < kv_len;
      const float p = ok ? expf(s[i] - m_new) : 0.f;
      Ps[rl][t] = p;
      lsum += p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o, TPR);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();   // a row's probabilities come from its own warp

    // ---- acc = acc * alpha + P V
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + j * TPR;
      float a = acc[j] * alpha;
#pragma unroll 8
      for (int t = 0; t < TILE; ++t) a += Ps[rl][t] * Vs[t][d];
      acc[j] = a;
    }
    __syncthreads();  // the next tile overwrites Ks / Vs
  }

  const int row = row0 + rl;
  if (row < n_rows) {
    const int c = row / rep, h = kvh * rep + row % rep;
    QT* o = out + (((long long)g * B + b) * C + c) * H * HD +
            (long long)h * HD;
    const float denom = fmaxf(l_run, 1e-20f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) store_as(o + lane + j * TPR, acc[j] / denom);
  }
}

template <typename QT, typename KVT, int ROWS>
int launch_typed(int hd, dim3 grid, cudaStream_t stream, const void* q,
                 const void* k_pool, const void* v_pool, const float* k_scale,
                 const float* v_scale, const int* block_tables,
                 const int* qpos_src, int qpos_offset, void* out, int B, int C,
                 int H, int K, int bs, int NB, int n_row_tiles,
                 long long pool_gstride, long long scale_gstride, float scale,
                 float softcap) {
#define PA_LAUNCH(HDV)                                                       \
  paged_attention_kernel<QT, KVT, HDV, ROWS, tile_for(HDV, ROWS)>           \
      <<<grid, THREADS, 0, stream>>>(                                        \
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),            \
      static_cast<const KVT*>(v_pool), k_scale, v_scale, block_tables,       \
      qpos_src, qpos_offset, static_cast<QT*>(out), B, C, H, K, bs, NB,      \
      n_row_tiles, pool_gstride, scale_gstride, scale, softcap)
  switch (hd) {
    case 32: PA_LAUNCH(32); break;
    case 64: PA_LAUNCH(64); break;
    case 128: PA_LAUNCH(128); break;
    default: return -1;
  }
#undef PA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <int ROWS>
int launch(int q_dtype, int kv_dtype, int hd, const void* q,
           const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int* block_tables, const int* qpos_src,
           int qpos_offset, void* out, int G, int B, int C, int H, int K,
           int bs, int NB, long long pool_gstride, long long scale_gstride,
           float scale, float softcap, void* stream) {
  const int n_rows = (H / K) * C;
  const int n_row_tiles = (n_rows + ROWS - 1) / ROWS;
  const dim3 grid(B, K, G * n_row_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                              \
  hd, grid, st, q, k_pool, v_pool, k_scale, v_scale, block_tables, qpos_src, \
      qpos_offset, out, B, C, H, K, bs, NB, n_row_tiles, pool_gstride,       \
      scale_gstride, scale, softcap
  if (q_dtype == F32 && kv_dtype == F32)
    return launch_typed<float, float, ROWS>(PA_ARGS);
  if (q_dtype == BF16 && kv_dtype == BF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16, ROWS>(PA_ARGS);
  if (q_dtype == F32 && kv_dtype == I8)
    return launch_typed<float, int8_t, ROWS>(PA_ARGS);
  if (q_dtype == BF16 && kv_dtype == I8)
    return launch_typed<__nv_bfloat16, int8_t, ROWS>(PA_ARGS);
#undef PA_ARGS
  return -2;
}

}  // namespace

// Decode: q/out [G, B, H, hd]; lengths [B]; four query rows per CTA (one
// warp per row: a GQA group of up to four heads shares one CTA).
// Returns cudaGetLastError() after the launch, or -1 / -2 for an
// unsupported head dim / dtype pair.
extern "C" int paged_decode_attention_launch(
    int q_dtype, int kv_dtype, int hd, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale, const float* v_scale,
    const int* block_tables, const int* lengths, void* out, int G, int B,
    int H, int K, int bs, int NB, long long pool_gstride,
    long long scale_gstride, float scale, float softcap, void* stream) {
  return launch<4>(q_dtype, kv_dtype, hd, q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, lengths, -1, out, G, B, 1, H, K, bs,
                   NB, pool_gstride, scale_gstride, scale, softcap, stream);
}

// Prefill: q/out [G, B, C, H, hd]; positions [B, C]; 32 query rows per CTA.
extern "C" int paged_prefill_attention_launch(
    int q_dtype, int kv_dtype, int hd, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale, const float* v_scale,
    const int* block_tables, const int* positions, void* out, int G, int B,
    int C, int H, int K, int bs, int NB, long long pool_gstride,
    long long scale_gstride, float scale, float softcap, void* stream) {
  return launch<32>(q_dtype, kv_dtype, hd, q, k_pool, v_pool, k_scale,
                    v_scale, block_tables, positions, 0, out, G, B, C, H, K,
                    bs, NB, pool_gstride, scale_gstride, scale, softcap,
                    stream);
}
