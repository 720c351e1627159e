// Paged GQA attention through a block table, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   paged_decode_attention   src/repro/kernels/paged_decode_attention.py
//                            (_paged_kernel, pallas_call at :130)
//   paged_prefill_attention  src/repro/kernels/paged_prefill_attention.py
//                            (_chunk_kernel, pallas_call at :132)
//
// Layout (every path).  The pools stay in the reference layout
// [P, bs, K, hd] (token stride K*hd, scale stride K), read through strides:
// no per-call transpose of the pool.  A leading branch dim (the semantic
// split's branches, each with its own pool) is a stride, so one launch
// serves every branch.  q and out are [G, B, (C,) H, hd]; block tables
// [B, NB] and positions or lengths are shared by the branches.  A CTA
// reads its own block ids from the table (TPU scalar prefetch supplied
// them) and keeps f32 online-softmax state (max, sum, acc) per query row;
// softcap comes before the mask, and a row with no valid key writes
// acc / max(l, 1e-20) = 0.  Head dims 32, 64 and 128 are instantiated.
//
// Three kernels, picked by the entry points from q's dtype alone:
//
//   paged_decode_split_kernel (decode, CUDA cores; path decode_split):
//   every decode step, f32 or bf16 q over pools in q's dtype or int8.  One
//   query per lane at ~1 flop per byte of bf16 K/V: bound by the bytes of
//   the live K/V, which it reads once.  The rep <= 4 query heads of a kv
//   head give the tensor cores nothing to do, so the design is about
//   bytes in flight (decode_attention.cu's, carried through the table):
//   a CTA takes HG kv heads of one lane and RT query heads of each, so no
//   warp holds an empty row at rep = 1 and a token's K (V) row for the HG
//   heads is one contiguous read of HG * hd elements, spread as 16-byte
//   (int8: 8-byte) loads over HG * hd / VEC lanes.  The lane's live length
//   is cut into pieces over the CTAs of a thread-block cluster; inside a
//   CTA, token groups keep their own state over the tokens they visit,
//   four or eight tokens' loads in flight, block ids staged once per block in shared
//   memory, slots past the length never read.  int8 codes are scaled in
//   registers (the K scale on the score, the V scale on p).  Token groups
//   merge by warp shuffles and then in shared memory; pieces merge after a
//   cluster barrier, each rank combining a slice of the outputs over ranks
//   0, 1, ... in order through distributed shared memory (deterministic,
//   one launch).  A length-0 lane reads nothing and writes 0.
//
//   paged_attention_kernel (f32-q prefill, CUDA cores; prefill_simt): 32
//   query rows per CTA (the rep = H/K query heads of its kv head times the
//   chunk positions, so each K/V token is read once per kv head and row
//   tile), walking logical positions [0, min(NB*bs, max qpos + 1)) with
//   the key rule kpos <= qpos.  K/V tiles of 32 tokens (16 where the static
//   shared-memory arrays would pass 48 KB) are read with 16-byte vector
//   loads, dequantized (int8, with the slot's f32 scale) into f32 shared
//   memory and consumed by scalar f32 dot products.  It stays on CUDA
//   cores: tensor cores would mean TF32 and change the reference's
//   numerics.
//
//   paged_prefill_mma_kernel (tensor cores): the bf16-q prefill, over bf16
//   or int8 pools.  A 128-token chunk does ~32 flops per K/V byte per row
//   tile, so CUDA-core f32 arithmetic bounded the CUDA-core kernel at ~90x the
//   byte bound; this one runs the two products on bf16 tensor cores
//   (mma.sync m16n8k16, f32 accumulation) and is bound by the K/V bytes
//   and the softmax.  64 query rows per CTA, one warp per 16 rows.  K/V
//   tiles of 64 tokens are gathered through the block table with 16-byte
//   cp.async copies (zero fill past the walk) into a 2-stage ring in
//   dynamic shared memory, so the next tile's copies overlap this tile's
//   math; rows are padded by 16 bytes so ldmatrix reads are free of bank
//   conflicts.  Q fragments stay in registers for the whole walk.  S =
//   QK^T stays in registers (K through ldmatrix), is scaled, softcapped
//   and masked there; the online softmax keeps f32 m, l and acc per row
//   (quad shuffles); P is rounded to bf16 in registers and fed straight
//   back as the A operand of P.V (V through ldmatrix.trans).  int8 pools:
//   the codes are exact in bf16, so each tile's codes are widened to bf16
//   codes in shared memory and go to the tensor cores as they are; the K
//   scale of each slot multiplies its score column, and the V scale of
//   each slot multiplies its column of P before the rounding to bf16.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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
    const int* __restrict__ qpos_src, QT* __restrict__ out,
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
    qpos_s[tid] = row < n_rows ? qpos_src[b * C + row / rep] : -1;
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
                 const int* qpos_src, void* out, int B, int C,
                 int H, int K, int bs, int NB, int n_row_tiles,
                 long long pool_gstride, long long scale_gstride, float scale,
                 float softcap) {
#define PA_LAUNCH(HDV)                                                       \
  paged_attention_kernel<QT, KVT, HDV, ROWS, tile_for(HDV, ROWS)>           \
      <<<grid, THREADS, 0, stream>>>(                                        \
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),            \
      static_cast<const KVT*>(v_pool), k_scale, v_scale, block_tables,       \
      qpos_src, static_cast<QT*>(out), B, C, H, K, bs, NB,                   \
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

constexpr int SIMT_ROWS = 32;   // query rows per CTA of the f32-q prefill

// f32-q prefill on the CUDA cores, over f32 or int8 pools.
int prefill_simt(int kv_dtype, int hd, const void* q, const void* k_pool,
                 const void* v_pool, const float* k_scale,
                 const float* v_scale, const int* block_tables,
                 const int* positions, void* out, int G, int B, int C, int H,
                 int K, int bs, int NB, long long pool_gstride,
                 long long scale_gstride, float scale, float softcap,
                 void* stream) {
  const int n_rows = (H / K) * C;
  const int n_row_tiles = (n_rows + SIMT_ROWS - 1) / SIMT_ROWS;
  const dim3 grid(B, K, G * n_row_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                              \
  hd, grid, st, q, k_pool, v_pool, k_scale, v_scale, block_tables, positions, \
      out, B, C, H, K, bs, NB, n_row_tiles, pool_gstride, scale_gstride,     \
      scale, softcap
  if (kv_dtype == F32)
    return launch_typed<float, float, SIMT_ROWS>(PA_ARGS);
  if (kv_dtype == I8)
    return launch_typed<float, int8_t, SIMT_ROWS>(PA_ARGS);
#undef PA_ARGS
  return -2;
}


// ------------------------------------------------ tensor-core prefill
constexpr int MMA_ROWS = 64;    // query rows per CTA (4 warps x 16)
constexpr int MMA_TILE = 64;    // key/value tokens per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Dynamic shared memory of one CTA, in bytes from its start: Q (bf16,
// rows padded by 16 bytes), two stages of the staged K and V tiles (as
// they are in the pool: bf16, or int8 codes plus the slots' f32 K and V
// scales), for int8 the K and V tiles widened to bf16, and the rows'
// positions.
template <typename KVT, int HD>
struct PrefillSmem {
  static constexpr bool Q8 = sizeof(KVT) == 1;
  static constexpr int LD = HD + 8;                  // bf16 row stride
  static constexpr int ROW_RAW = Q8 ? HD + 16 : 2 * LD;   // staged row bytes
  static constexpr int Q_BYTES = MMA_ROWS * LD * 2;
  static constexpr int TILE_BF = MMA_TILE * LD * 2;
  static constexpr int TILE_RAW = MMA_TILE * ROW_RAW;
  static constexpr int SCALES = Q8 ? 2 * MMA_TILE * 4 : 0;
  static constexpr int STAGE = 2 * TILE_RAW + SCALES;
  static constexpr int CONV = Q8 ? 2 * TILE_BF : 0;
  static constexpr int QPOS = Q_BYTES + 2 * STAGE + CONV;
  static constexpr int BYTES = QPOS + MMA_ROWS * 4;
};

template <typename KVT, int HD>
__global__ void __launch_bounds__(THREADS) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ positions, __nv_bfloat16* __restrict__ out,
    int B, int C, int H, int K, int bs, int NB, int n_row_tiles,
    long long pool_gstride, long long scale_gstride, float scale,
    float softcap) {
  using L = PrefillSmem<KVT, HD>;
  constexpr bool Q8 = L::Q8;
  constexpr int LD = L::LD;
  constexpr int CPR = HD * (int)sizeof(KVT) / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(KVT);       // elements per chunk
  static_assert(THREADS == 128 && MMA_ROWS == 64 && MMA_TILE == 64, "tiles");
  static_assert(HD % 16 == 0 && L::Q_BYTES % 16 == 0 && L::STAGE % 16 == 0,
                "alignment");
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* stages = smem + L::Q_BYTES;
  __nv_bfloat16* conv =
      reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::STAGE);
  int* qpos_s = reinterpret_cast<int*>(smem + L::QPOS);
  __shared__ int kv_len_s;

  const int rep = H / K;
  const int n_rows = rep * C;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = blockIdx.z / n_row_tiles;
  const int row0 = (blockIdx.z % n_row_tiles) * MMA_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // query rows (row = c * rep + r -> head kvh * rep + r), as given: the
  // f32 scores are scaled
  for (int i = tid; i < MMA_ROWS * HD; i += THREADS) {
    const int rl = i / HD, d = i % HD, row = row0 + rl;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (row < n_rows) {
      const int c = row / rep, h = kvh * rep + row % rep;
      v = q[(((long long)g * B + b) * C + c) * H * HD + (long long)h * HD +
            d];
    }
    Qs[rl * LD + d] = v;
  }
  if (tid < MMA_ROWS) {
    const int row = row0 + tid;
    qpos_s[tid] = row < n_rows ? positions[b * C + row / rep] : -1;
  }
  __syncthreads();
  if (tid < 32) {
    int m = max(qpos_s[tid], qpos_s[tid + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) kv_len_s = min(m + 1, NB * bs);   // clip to the table
  }
  __syncthreads();

  const int kv_len = kv_len_s;
  const int n_tiles = (kv_len + MMA_TILE - 1) / MMA_TILE;
  const int* table = block_tables + (long long)b * NB;
  const KVT* kp = k_pool + g * pool_gstride;
  const KVT* vp = v_pool + g * pool_gstride;

  // the copies of tile ``it`` into stage it % 2, as one cp.async group
  auto issue = [&](int it) {
    uint8_t* st = stages + (it & 1) * L::STAGE;
    const int t0 = it * MMA_TILE;
    for (int v = tid; v < MMA_TILE * CPR; v += THREADS) {
      const int t = v / CPR, ch = v % CPR, kpos = t0 + t;
      const bool ok = kpos < kv_len;
      long long off = 0;
      if (ok) {
        const long long slot =
            (long long)table[kpos / bs] * bs + kpos % bs;
        off = (slot * K + kvh) * HD + ch * EPC;
      }
      uint8_t* dst = st + t * L::ROW_RAW + ch * 16;
      cp_async16(dst, kp + off, ok);
      cp_async16(dst + L::TILE_RAW, vp + off, ok);
    }
    if constexpr (Q8) {
      if (tid < MMA_TILE) {
        const int kpos = t0 + tid;
        const bool ok = kpos < kv_len;
        long long si = 0;
        if (ok)
          si = ((long long)table[kpos / bs] * bs + kpos % bs) * K + kvh;
        float* sc = reinterpret_cast<float*>(st + 2 * L::TILE_RAW);
        cp_async4(sc + tid, k_scale + g * scale_gstride + si, ok);
        cp_async4(sc + MMA_TILE + tid, v_scale + g * scale_gstride + si, ok);
      }
    }
    cp_async_commit();
  };

  // this warp's 16 query rows as A fragments, for the whole walk
  uint32_t qf[HD / 16][4];
  {
    const int mi = lane / 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * LD +
                              kk * 16 + (mi >> 1) * 8);
  }
  // fragment rows of this thread: r and r + 8 of the warp's 16
  const int qp[2] = {qpos_s[warp * 16 + lane / 4],
                     qpos_s[warp * 16 + lane / 4 + 8]};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  if (n_tiles > 0) issue(0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue(it + 1);          // in flight while this tile is consumed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint8_t* st = stages + (it & 1) * L::STAGE;
    const __nv_bfloat16* Kt;
    const __nv_bfloat16* Vt;
    const float* ks_t = nullptr;
    const float* vs_t = nullptr;
    if constexpr (Q8) {
      // widen the codes to bf16 (exact), 16 codes per thread and step
      for (int v = tid; v < 2 * MMA_TILE * (HD / 16); v += THREADS) {
        const int kv = v / (MMA_TILE * (HD / 16));
        const int r = v % (MMA_TILE * (HD / 16));
        const int t = r / (HD / 16), ch = r % (HD / 16);
        const int4 raw = *reinterpret_cast<const int4*>(
            st + kv * L::TILE_RAW + t * L::ROW_RAW + ch * 16);
        const int8_t* c8 = reinterpret_cast<const int8_t*>(&raw);
        uint32_t wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wv[e] = pack_bf16(static_cast<float>(c8[2 * e]),
                            static_cast<float>(c8[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(
            conv + kv * MMA_TILE * LD + t * LD + ch * 16);
        dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      __syncthreads();
      Kt = conv;
      Vt = conv + MMA_TILE * LD;
      ks_t = reinterpret_cast<const float*>(st + 2 * L::TILE_RAW);
      vs_t = ks_t + MMA_TILE;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(st);
      Vt = reinterpret_cast<const __nv_bfloat16*>(st + L::TILE_RAW);
    }

    // ---- S = Q K^T: 16 rows x 64 tokens per warp, in registers
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const int mi = lane / 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Kt + (nt * 16 + (mi >> 1) * 8 + lane % 8) * LD +
                              kk * 16 + (mi & 1) * 8);
          mma_bf16(s[2 * nt], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * nt + 1], qf[kk], kb[2], kb[3]);
        }
      }
    }

    // ---- scale, K scale, softcap, mask; online softmax per row
    const int t0 = it * MMA_TILE;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * (lane % 4) + (e & 1), kpos = t0 + tok;
        float x = s[j][e] * scale;
        if constexpr (Q8) x *= ks_t[tok];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = kpos <= qp[e >> 1] && kpos < kv_len;
        x = ok ? x : __uint_as_float(0xff800000u);   // -inf: p = 0
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mx[h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_run[h], m);       // finite: >= NEG_INF
      alpha[h] = exp2f((m_run[h] - m_new) * LOG2E);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // P, rounded to bf16 as the A fragments of P V (int8: times the V
    // scale of its slot first); l sums the unrounded, unscaled P
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f((s[j][e] - m_run[e >> 1]) * LOG2E);
        l_run[e >> 1] += p[e];
        if constexpr (Q8) p[e] *= vs_t[8 * j + 2 * (lane % 4) + (e & 1)];
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // ---- acc += P V (V through ldmatrix.trans)
    {
      const int mi = lane / 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nd = 0; nd < HD / 16; ++nd) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, Vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD +
                                    nd * 16 + (mi >> 1) * 8);
          mma_bf16(o[2 * nd], pa[kk], vb[0], vb[1]);
          mma_bf16(o[2 * nd + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // the next copies overwrite this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * h;
    if (row >= n_rows) continue;
    const int c = row / rep, hh = kvh * rep + row % rep;
    __nv_bfloat16* op = out + (((long long)g * B + b) * C + c) * H * HD +
                        (long long)hh * HD + 2 * (lane % 4);
    const float inv = 1.f / fmaxf(l_run[h], 1e-20f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

template <typename KVT, int HD>
int launch_prefill_mma(dim3 grid, cudaStream_t st, const void* q,
                       const void* k_pool, const void* v_pool,
                       const float* k_scale, const float* v_scale,
                       const int* block_tables, const int* positions,
                       void* out, int B, int C, int H, int K, int bs, int NB,
                       int n_row_tiles, long long pool_gstride,
                       long long scale_gstride, float scale, float softcap) {
  constexpr int smem = PrefillSmem<KVT, HD>::BYTES;
  // once per instantiation and device
  static unsigned long long configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        paged_prefill_mma_kernel<KVT, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  paged_prefill_mma_kernel<KVT, HD><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, block_tables,
      positions, static_cast<__nv_bfloat16*>(out), B, C, H, K, bs, NB,
      n_row_tiles, pool_gstride, scale_gstride, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// bf16-q prefill on the tensor cores, over bf16 or int8 pools.
int prefill_mma(int kv_dtype, int hd, const void* q, const void* k_pool,
                const void* v_pool, const float* k_scale,
                const float* v_scale, const int* block_tables,
                const int* positions, void* out, int G, int B, int C, int H,
                int K, int bs, int NB, long long pool_gstride,
                long long scale_gstride, float scale, float softcap,
                void* stream) {
  const int n_row_tiles = ((H / K) * C + MMA_ROWS - 1) / MMA_ROWS;
  const dim3 grid(B, K, G * n_row_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PM_ARGS                                                            \
  grid, st, q, k_pool, v_pool, k_scale, v_scale, block_tables, positions,  \
      out, B, C, H, K, bs, NB, n_row_tiles, pool_gstride, scale_gstride,   \
      scale, softcap
#define PM_HD(KVT)                                         \
  switch (hd) {                                            \
    case 32: return launch_prefill_mma<KVT, 32>(PM_ARGS);   \
    case 64: return launch_prefill_mma<KVT, 64>(PM_ARGS);   \
    case 128: return launch_prefill_mma<KVT, 128>(PM_ARGS); \
    default: return -1;                                    \
  }
  if (kv_dtype == BF16) PM_HD(__nv_bfloat16)
  if (kv_dtype == I8) PM_HD(int8_t)
#undef PM_HD
#undef PM_ARGS
  return -2;
}

// ------------------------------------------------------- split decode
constexpr int DS_WARPS = 4;   // eight lengthen the merges more than the walk
constexpr int DS_THREADS = 32 * DS_WARPS;
constexpr int DS_ROWS = 8;         // query rows per CTA, at most
constexpr int DS_WINDOW = 64;      // block ids staged in shared memory at once
constexpr int DS_MAX_PIECES = 8;   // CTAs of a cluster (the portable limit)

// One load of VEC pool elements: 16 bytes of f32 or bf16, 8 of int8 codes
// (16 codes per lane would halve the CTAs without shortening a CTA's walk).
template <typename KVT>
struct KvLoad {
  static constexpr int VEC = sizeof(KVT) == 4 ? 4 : 8;
  using type = typename std::conditional<sizeof(KVT) == 1, uint2,
                                         uint4>::type;
};

template <typename KVT, int VEC, typename R>
__device__ __forceinline__ void widen(const R& r, float (&f)[VEC]) {
  const KVT* e = reinterpret_cast<const KVT*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
}

// Online-softmax state (m, l, acc) merged with another one, in f32.
template <int VEC>
__device__ __forceinline__ void merge_state(float& m, float& l,
                                            float (&acc)[VEC], float mo,
                                            float lo, const float (&ao)[VEC]) {
  const float mn = fmaxf(m, mo);
  const float c = expf(m - mn), co = expf(mo - mn);
  l = l * c + lo * co;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = acc[e] * c + ao[e] * co;
  m = mn;
}

// Grid: x = pieces of the lanes' length (the CTAs of one cluster), y = kv
// head groups x query-head groups, z = branch x lane.  A CTA takes HG kv
// heads of its lane and RT query heads of each (HG * RT <= 8 rows): a
// token's K (and V) row for the HG heads is HG * hd contiguous elements,
// read as one VEC-element load (KvLoad) by each of LPT = HG * hd / VEC
// lanes, so a warp holds 32 / LPT token groups and the CTA's four warps
// NG = 4 * 32 / LPT.  Each group keeps its own online-softmax state over
// the tokens it visits (base + u * NG + group), U tokens' loads in flight
// (8, or 4 for RT >= 4 to bound the registers).
template <typename QT, typename KVT, int HD, int RT>
__global__ void __launch_bounds__(DS_THREADS) paged_decode_split_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int B, int H,
    int K, int bs, int NB, int HG, int piece, long long pool_gstride,
    long long scale_gstride, float scale, float softcap) {
  constexpr int VEC = KvLoad<KVT>::VEC;
  using LoadT = typename KvLoad<KVT>::type;
  constexpr int CPH = HD / VEC;    // lanes per head row
  constexpr int U = RT <= 2 ? 8 : 4;   // tokens per group in flight
  static_assert(CPH <= 32 && 32 % CPH == 0 && RT <= DS_ROWS, "shape");

  __shared__ float sm_m[DS_WARPS][DS_ROWS], sm_l[DS_WARPS][DS_ROWS];
  __shared__ float sm_acc[DS_WARPS][DS_ROWS][HD];
  __shared__ float pc_m[DS_ROWS], pc_l[DS_ROWS];
  __shared__ float pc_acc[DS_ROWS][HD];
  __shared__ int blk_s[DS_WINDOW];

  const int pieces = gridDim.x, pi = blockIdx.x;
  const int rep = H / K, rgroups = rep / RT;
  const int kv0 = (blockIdx.y / rgroups) * HG;
  const int r0 = (blockIdx.y % rgroups) * RT;
  const int b = blockIdx.z % B, g = blockIdx.z / B;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lpt = HG * CPH;        // lanes per token (a power of two)
  const int tpw = 32 / lpt;        // token groups per warp
  const int ng = DS_WARPS * tpw;
  const int sub = lane % lpt, gid = warp * tpw + lane / lpt;
  const int hl = sub / CPH, d0 = (sub % CPH) * VEC;
  const int kvh = kv0 + hl;
  const int len = min(max(lengths[b], 0), NB * bs);
  const int t_begin = pi * piece, t_end = min(len, t_begin + piece);
  const KVT* kp = k_pool + g * pool_gstride;
  const KVT* vp = v_pool + g * pool_gstride;
  const float* ksc = k_scale ? k_scale + g * scale_gstride : nullptr;
  const float* vsc = v_scale ? v_scale + g * scale_gstride : nullptr;
  const int* table = block_tables + (long long)b * NB;

  float qv[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const QT* qr = q + (((long long)g * B + b) * H + kvh * rep + r0 + r) * HD +
                   d0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[r][e] = to_f32(qr[e]) * scale;
  }
  float m[RT], l[RT], acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // The trip counts are the same for every thread (shuffles below take
  // the whole warp); a token past the window's end is masked.
  for (int w0 = t_begin; w0 < t_end; w0 += DS_WINDOW * bs) {
    const int w1 = min(t_end, w0 + DS_WINDOW * bs);
    __syncthreads();               // the previous window's ids are read
    for (int i = tid; i < (w1 - w0 + bs - 1) / bs; i += DS_THREADS)
      blk_s[i] = table[w0 / bs + i];
    __syncthreads();
    for (int base = w0; base < w1; base += ng * U) {
      LoadT kr[U], vr[U];
      float ks[U], vs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + u * ng + gid;
        ks[u] = vs[u] = 1.f;
        if (t < w1) {
          const long long slot =
              (long long)blk_s[(t - w0) / bs] * bs + t % bs;
          const long long off = (slot * K + kvh) * HD + d0;
          kr[u] = *reinterpret_cast<const LoadT*>(kp + off);
          vr[u] = *reinterpret_cast<const LoadT*>(vp + off);
          if (ksc) {
            ks[u] = ksc[slot * K + kvh];
            vs[u] = vsc[slot * K + kvh];
          }
        } else {
          kr[u] = vr[u] = LoadT{};
        }
      }
      float s[U][RT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        widen<KVT, VEC>(kr[u], kf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
          for (int o = CPH / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          dot *= ks[u];
          if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
          s[u][r] = base + u * ng + gid < w1 ? dot : NEG_INF;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
        const float alpha = expf(m[r] - mx);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (base + u * ng + gid >= w1) continue;
          const float p = expf(s[u][r] - mx);
          const float pv = p * vs[u];
          float vf[VEC];
          widen<KVT, VEC>(vr[u], vf);
          l[r] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
        }
        m[r] = mx;
      }
    }
  }

  // ---- merge the warp's token groups (butterfly: every lane ends with the
  // same state), then the warps in order
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    for (int o = lpt; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      float ao[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      merge_state<VEC>(m[r], l[r], acc[r], mo, lo, ao);
    }
    if (lane < lpt) {
      const int row = hl * RT + r;
      if (d0 == 0) {
        sm_m[warp][row] = m[r];
        sm_l[warp][row] = l[r];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][row][d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  const int rows = HG * RT;
  for (int i = tid; i < rows * HD; i += DS_THREADS) {
    const int row = i / HD, d = i % HD;
    float mx = NEG_INF, ls = 0.f, a = 0.f;
    for (int w = 0; w < DS_WARPS; ++w) {
      const float mw = sm_m[w][row];
      const float mn = fmaxf(mx, mw);
      const float c = expf(mx - mn), cw = expf(mw - mn);
      ls = ls * c + sm_l[w][row] * cw;
      a = a * c + sm_acc[w][row][d] * cw;
      mx = mn;
    }
    pc_acc[row][d] = a;
    if (d == 0) {
      pc_m[row] = mx;
      pc_l[row] = ls;
    }
  }

  // ---- merge the pieces in rank order (one CTA: its own state) and write;
  // each rank takes a slice of the rows x HD outputs
  cg::cluster_group cluster = cg::this_cluster();
  if (pieces > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rank = pieces > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int total = rows * HD, per = (total + pieces - 1) / pieces;
  const int i_end = min(total, (rank + 1) * per);
  for (int i = rank * per + tid; i < i_end; i += DS_THREADS) {
    const int row = i / HD, d = i % HD;
    // every piece's state loaded before any is merged (unrolled and
    // predicated: the remote loads are in flight together), then merged in
    // rank order
    float mp[DS_MAX_PIECES], lp[DS_MAX_PIECES], ap[DS_MAX_PIECES];
#pragma unroll
    for (int p = 0; p < DS_MAX_PIECES; ++p) {
      if (p < pieces) {
        const float* pm = pieces > 1 ? cluster.map_shared_rank(pc_m, p) : pc_m;
        const float* pl = pieces > 1 ? cluster.map_shared_rank(pc_l, p) : pc_l;
        const float* pa = pieces > 1
            ? cluster.map_shared_rank(&pc_acc[0][0], p) : &pc_acc[0][0];
        mp[p] = pm[row];
        lp[p] = pl[row];
        ap[p] = pa[row * HD + d];
      }
    }
    float mx = NEG_INF, ls = 0.f, a = 0.f;
#pragma unroll
    for (int p = 0; p < DS_MAX_PIECES; ++p) {
      if (p < pieces) {
        const float mn = fmaxf(mx, mp[p]);
        const float c = expf(mx - mn), cp = expf(mp[p] - mn);
        ls = ls * c + lp[p] * cp;
        a = a * c + ap[p] * cp;
        mx = mn;
      }
    }
    const int h = (kv0 + row / RT) * rep + r0 + row % RT;
    store_as(out + (((long long)g * B + b) * H + h) * HD + d,
             a / fmaxf(ls, 1e-20f));
  }
  if (pieces > 1) cluster.sync();  // peers' states stay until read
}

template <typename QT, typename KVT, int HD, int RT>
int launch_decode_split(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* block_tables, const int* lengths,
                        void* out, int G, int B, int H, int K, int bs,
                        int NB, int HG, int pieces, int piece,
                        long long pool_gstride, long long scale_gstride,
                        float scale, float softcap, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pieces, (K / HG) * (H / K / RT), G * B);
  cfg.blockDim = dim3(DS_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pieces;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(
      &cfg, paged_decode_split_kernel<QT, KVT, HD, RT>,
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, block_tables,
      lengths, static_cast<QT*>(out), B, H, K, bs, NB, HG, piece,
      pool_gstride, scale_gstride, scale, softcap);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT>
int decode_split_typed(int hd, int rt, const void* q, const void* k_pool,
                       const void* v_pool, const float* k_scale,
                       const float* v_scale, const int* block_tables,
                       const int* lengths, void* out, int G, int B, int H,
                       int K, int bs, int NB, int HG, int pieces, int piece,
                       long long pool_gstride, long long scale_gstride,
                       float scale, float softcap, cudaStream_t st) {
#define DS_ARGS q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, \
                out, G, B, H, K, bs, NB, HG, pieces, piece, pool_gstride,   \
                scale_gstride, scale, softcap, st
#define DS_RT(HDV)                                                       \
  switch (rt) {                                                          \
    case 1: return launch_decode_split<QT, KVT, HDV, 1>(DS_ARGS);        \
    case 2: return launch_decode_split<QT, KVT, HDV, 2>(DS_ARGS);        \
    case 4: return launch_decode_split<QT, KVT, HDV, 4>(DS_ARGS);        \
    case 8: return launch_decode_split<QT, KVT, HDV, 8>(DS_ARGS);        \
    default: return -3;                                                  \
  }
  switch (hd) {
    case 32: DS_RT(32)
    case 64: DS_RT(64)
    case 128: DS_RT(128)
  }
#undef DS_RT
#undef DS_ARGS
  return -1;
}

}  // namespace

// Decode (path decode_split): q/out [G, B, H, hd]; lengths [B].  A CTA
// takes ``hg`` kv heads (a power of two dividing K) and ``rt`` query heads
// of each (1, 2, 4 or 8 dividing H / K; hg * rt <= 8); the lanes' lengths
// are cut into ``pieces`` (<= 8, the CTAs of one cluster) of ``piece``
// tokens (a multiple of bs), merged inside the launch.  Returns
// cudaGetLastError() after the launch, -1 / -2 / -3 for an unsupported
// head dim / dtype pair / head grouping or piece count.
extern "C" int paged_decode_attention_launch(
    int q_dtype, int kv_dtype, int hd, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale, const float* v_scale,
    const int* block_tables, const int* lengths, void* out, int G, int B,
    int H, int K, int bs, int NB, int hg, int rt, int pieces, int piece,
    long long pool_gstride, long long scale_gstride, float scale,
    float softcap, void* stream) {
  if (pieces < 1 || pieces > DS_MAX_PIECES || hg < 1 || hg * rt > DS_ROWS ||
      K % hg || (H / K) % rt || piece % bs)
    return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_ARGS hd, rt, q, k_pool, v_pool, k_scale, v_scale, block_tables,  \
                lengths, out, G, B, H, K, bs, NB, hg, pieces, piece,        \
                pool_gstride, scale_gstride, scale, softcap, st
  if (q_dtype == F32 && kv_dtype == F32)
    return decode_split_typed<float, float>(DS_ARGS);
  if (q_dtype == F32 && kv_dtype == I8)
    return decode_split_typed<float, int8_t>(DS_ARGS);
  if (q_dtype == BF16 && kv_dtype == BF16)
    return decode_split_typed<__nv_bfloat16, __nv_bfloat16>(DS_ARGS);
  if (q_dtype == BF16 && kv_dtype == I8)
    return decode_split_typed<__nv_bfloat16, int8_t>(DS_ARGS);
#undef DS_ARGS
  return -2;
}

// Prefill: q/out [G, B, C, H, hd]; positions [B, C].  bf16 q takes the
// tensor-core kernel (64 query rows per CTA, bf16 or int8 pools); f32 q the
// CUDA-core kernel (32 rows per CTA, f32 or int8 pools).  Returns
// cudaGetLastError() after the launch, -1 / -2 for an unsupported head dim
// / dtype pair, or -5 when the current device cannot be read.
extern "C" int paged_prefill_attention_launch(
    int q_dtype, int kv_dtype, int hd, const void* q, const void* k_pool,
    const void* v_pool, const float* k_scale, const float* v_scale,
    const int* block_tables, const int* positions, void* out, int G, int B,
    int C, int H, int K, int bs, int NB, long long pool_gstride,
    long long scale_gstride, float scale, float softcap, void* stream) {
  if (q_dtype == BF16)
    return prefill_mma(kv_dtype, hd, q, k_pool, v_pool, k_scale, v_scale,
                       block_tables, positions, out, G, B, C, H, K, bs, NB,
                       pool_gstride, scale_gstride, scale, softcap, stream);
  if (q_dtype == F32)
    return prefill_simt(kv_dtype, hd, q, k_pool, v_pool, k_scale, v_scale,
                        block_tables, positions, out, G, B, C, H, K, bs, NB,
                        pool_gstride, scale_gstride, scale, softcap, stream);
  return -2;
}
