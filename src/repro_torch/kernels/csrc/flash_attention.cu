// Full-sequence (flash) GQA attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention  src/repro/kernels/flash_attention.py
//                    (_attn_kernel :25, pallas_call :93)
//
// What it computes: out = softmax(mask(cap(q k^T / sqrt(hd)))) v per (batch,
// head), accumulated in f32 and written in q's type.  Queries sit at the END
// of the key range (query i has position Sk - Sq + i); the causal rule is
// kpos <= qpos, the sliding window keeps kpos > qpos - window, and the
// softcap is cap * tanh(s / cap).  GQA: query head h reads kv head
// h / (H / KH).  Any Sq <= Sk: ragged edges are masked here, so neither
// length has to divide a tile.
//
// Layout.  q [N, Sq, H, hd], k/v [N, Sk, KH, hd] are read in place through
// their batch, sequence and head strides (the head dim is dense): no
// transpose copies like the TPU wrapper's (flash_attention.py:86-88).  N is
// the batch with any leading dims folded in (the semantic split's branches
// times the batch), so one launch serves every branch.  out is a dense
// [N, Sq, H, hd].
//
// Grid.  One CTA per (query tile of 64 rows, head, batch): the TPU kernel's
// grid, with its whole-Sk VMEM block replaced by a loop over key tiles of BK
// tokens staged in shared memory.  Query tiles are scheduled latest first, so
// the longest causal walks start first.  A tile walks only the key tiles that
// hold an unmasked key for one of its rows: up to the causal frontier of its
// last row (the TPU kernel's n_k_eff) and, with a window, from the window
// start of its first row.  Online softmax state (max, sum, acc) per row lives
// in registers.
//
// Threads.  128 threads as a 16 x 8 grid; thread (ty, tx) owns query rows
// 4ty..4ty+3.  For the scores it owns key columns tx + 8j (register tile 4 x
// BK/8, read as float4 along hd from row-padded shared tiles, conflict-free
// for K); for the output it owns dims 4tx + 32jj .. +3 (register tile 4 x
// hd/8).  A row's eight threads are eight adjacent lanes of one warp, so the
// row max and sum are three shuffles and P passes from scores to the PV
// product through shared memory under a warp barrier.
//
// Bound.  At the main path's shape (B 2, S 2048, H = K = 32, hd 64, f32,
// causal) the work is ~3.4e10 flops against ~67 MB of q, k, v and out: at
// 67 TFLOP/s f32 outside the tensor cores the arithmetic bound (~0.51 ms)
// is ~13x the byte bound (~0.04 ms at 3.35 TB/s).  This kernel runs on CUDA
// cores in f32 (bf16 inputs are widened on load); its design answer to the
// arithmetic bound is register tiling (~10 FMAs per shared-memory vector
// load) and skipping masked key tiles.  Tensor-core (mma/wgmma) tiles, TMA
// and a backward kernel are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 64;                 // query rows per CTA
constexpr float NEG_INF = -1e30f;

// Key tokens per shared-memory tile: 64, or 32 at head dim 128 (two CTAs
// then fit one SM's shared memory).
__host__ __device__ constexpr int key_tile(int hd) { return hd >= 128 ? 32 : 64; }

// Dynamic shared memory of one CTA: Q [BQ][hd+4], K [BK][hd+4], V [BK][hd],
// P [BQ][BK+4] in f32 (row pads keep float4 rows aligned and spread banks).
__host__ __device__ constexpr int smem_bytes(int hd) {
  return 4 * (BQ * (hd + 4) + key_tile(hd) * (hd + 4) + key_tile(hd) * hd +
              BQ * (key_tile(hd) + 4));
}

enum Dtype { F32 = 0, BF16 = 1 };

// 16 bytes of T at p (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KH, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, float softcap) {
  constexpr int BK = key_tile(HD);
  constexpr int QS = HD + 4;           // row stride of Q and K tiles
  constexpr int PS = BK + 4;           // row stride of the P tile
  constexpr int CPT = BK / 8;          // score columns per thread
  constexpr int DPT = HD / 32;         // float4 output groups per thread
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = HD / VEC;        // 16-byte loads per row
  static_assert(HD % 32 == 0 && BK % 8 == 0 && BK % 4 == 0, "shape");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * HD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest query tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qt * BQ;
  const int q_off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

  // ---- Q tile -> smem in f32, pre-scaled (rows past Sq are zero)
  const T* qb = q + b * qsb + (long long)h * qsh;
  for (int i = tid; i < BQ * LPR; i += THREADS) {
    const int r = i / LPR, d0 = (i % LPR) * VEC;
    float f[VEC];
    if (q0 + r < Sq) {
      load16(qb + (long long)(q0 + r) * qss + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r * QS + d0 + e] = f[e] * scale;
  }

  // ---- the key tiles holding an unmasked key for some row of this tile
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_off + last_row + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  int qpos[4];
  float m_run[4], l_run[4], acc[4][4 * DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_off + q0 + ty * 4 + i;
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DPT; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + b * ksb + (long long)kvh * ksh;
  const T* vb = v + b * vsb + (long long)kvh * vsh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // Q is staged / the last tile's K, V reads are done
    for (int i = tid; i < BK * LPR; i += THREADS) {
      const int t = i / LPR, d0 = (i % LPR) * VEC;
      float kf[VEC], vf[VEC];
      if (k0 + t < Sk) {
        load16(kb + (long long)(k0 + t) * kss + d0, kf);
        load16(vb + (long long)(k0 + t) * vss + d0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[t * QS + d0 + e] = kf[e];
        Vs[t * HD + d0 + e] = vf[e];
      }
    }
    __syncthreads();

    // ---- scores: s[i][j] = q[4ty+i] . k[tx+8j]
    float s[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // ---- softcap, masks, online-softmax update; P -> smem
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[CPT];
      float mloc = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos[i]) &&
                (window <= 0 || kpos > qpos[i] - window);
        s[i][j] = x;
        if (ok[j]) mloc = fmaxf(mloc, x);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o, 8));
      const float m_new = fmaxf(m_run[i], mloc);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PS + tx + 8 * j] = p;
        lsum += p;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o, 8);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + lsum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // a row's P comes from the eight lanes that read it

    // ---- acc[i][.] += P[4ty+i][t] * V[t][4tx + 32jj ..]
#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PS + t]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(t + tt) * HD + tx * 4 + 32 * jj]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = tt == 0 ? pa[i].x : tt == 1 ? pa[i].y
                          : tt == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  // ---- out = acc / max(l, 1e-20), dense [N, Sq, H, hd]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* o = out + ((b * Sq + row) * H + h) * (long long)HD;
    const float denom = fmaxf(l_run[i], 1e-20f);
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_as(o + tx * 4 + 32 * jj + e, acc[i][4 * jj + e] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int N,
              int Sq, int Sk, int H, int KH, const long long* qst,
              const long long* kst, const long long* vst, int causal,
              int window, float scale, float softcap, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  constexpr int SMEM = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, N);
  kern<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, qst[0],
      qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2], causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(int hd, const void* q, const void* k, const void* v,
                 void* out, int N, int Sq, int Sk, int H, int KH,
                 const long long* qst, const long long* kst,
                 const long long* vst, int causal, int window, float scale,
                 float softcap, cudaStream_t stream) {
#define FA_LAUNCH(HDV)                                                    \
  return launch_hd<T, HDV>(q, k, v, out, N, Sq, Sk, H, KH, qst, kst, vst, \
                           causal, window, scale, softcap, stream)
  switch (hd) {
    case 32: FA_LAUNCH(32);
    case 64: FA_LAUNCH(64);
    case 128: FA_LAUNCH(128);
    default: return -1;
  }
#undef FA_LAUNCH
}

}  // namespace

// q [N, Sq, H, hd], k/v [N, Sk, KH, hd] with element strides (batch, seq,
// head) in q_strides / k_strides / v_strides and a dense head dim; out a
// dense [N, Sq, H, hd] of the same type.  Returns cudaGetLastError() after
// the launch, or -1 / -2 for an unsupported head dim / dtype.
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* out,
    int N, int Sq, int Sk, int H, int KH, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale,
    float softcap, void* stream) {
  const long long qst[3] = {qsb, qss, qsh};
  const long long kst[3] = {ksb, kss, ksh};
  const long long vst[3] = {vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_typed<float>(hd, q, k, v, out, N, Sq, Sk, H, KH, qst, kst,
                               vst, causal, window, scale, softcap, st);
  if (dtype == BF16)
    return launch_typed<__nv_bfloat16>(hd, q, k, v, out, N, Sq, Sk, H, KH,
                                       qst, kst, vst, causal, window, scale,
                                       softcap, st);
  return -2;
}
