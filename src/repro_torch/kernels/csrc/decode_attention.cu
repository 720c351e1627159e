// Single-token GQA decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   decode_attention   src/repro/kernels/decode_attention.py
//                      (_decode_kernel, pallas_call at :74)
//
// out[b, h] = softmax_t(cap(q[b, h] . k[b, t, h / rep] / sqrt(hd))) v[...]
// over the valid slots t < length[b], with cap(s) = c tanh(s / c) when a
// softcap c is set (applied before the mask, as the TPU kernel does).  The
// softmax state (max, sum, accumulator) is f32.  A row with length 0 reads
// nothing and returns 0, as the TPU kernel's acc / max(l, 1e-20) does.
//
// Layout.  q [B, H, hd] and k/v [B, L, K, hd] are read through their
// strides (the head dim dense, rows 16-byte aligned); out is a dense
// [B, H, hd].  Head dims 32, 64 and 128; f32 or bf16.
//
// Grid.  One CTA per (split of the cache, group of RT query heads of one kv
// head, lane).  The RT heads of a group ride together, so each K/V row is
// read once per group (RT = rep = H / K for the usual GQA ratios).  A split
// covers CHUNK slots and stops at the lane's length: splits past it exit at
// once, so ragged lengths cost what they read.  Inside a CTA, LPT = hd /
// VEC lanes share a token row (one 16-byte load each), a warp holds 32 /
// LPT token groups and each group keeps its own online-softmax state over
// the slots it visits, U slots' loads in flight at a time; the CTA's
// groups are merged in shared memory.  With one split the CTA writes the
// output; otherwise each split writes its (max, sum, accumulator) to an
// f32 workspace and a second kernel merges the splits of each (lane, head)
// in order.
//
// Log-sum-exp.  When ``lse`` is given, each (lane, head) row also writes
// the f32 log-sum-exp of its valid scores, lse = m + log(l) (-inf for a
// row with no valid slot), and the output is f32, so that partial results
// over slabs of one cache (flash-decoding over a length-sharded cache)
// merge exactly before any rounding:
// out = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M).
//
// Bound.  Every valid K/V byte is read once; at ~1 flop per byte of bf16
// the kernel is bound by device-memory bytes.  Splitting the cache gives
// every SM loads to keep in flight even at 8 lanes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 4;                  // slots per group in flight together
constexpr float NEG_INF = -1e30f;
// the log-sum-exp of a row with no valid slot
__device__ __forceinline__ float empty_lse() {
  return __int_as_float(0xff800000);
}

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// Element i of the output: f32 when the log-sum-exp is asked for (a
// partial that is merged before any rounding), else T.
template <typename T>
__device__ __forceinline__ void put(void* out, long long i, float x,
                                    const float* lse) {
  if (lse != nullptr)
    static_cast<float*>(out)[i] = x;
  else
    store_as(static_cast<T*>(out) + i, x);
}

// The VEC elements of one 16-byte load as f32.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4& r, float (&f)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
}

template <typename T, int HD, int RT>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, void* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    float* __restrict__ lse, int H, int KH, int L, int chunk, int splits,
    long long sqb, long long sqh,
    long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, float scale, float softcap) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPT = HD / VEC;         // lanes per token row
  constexpr int TPW = 32 / LPT;         // token groups per warp
  constexpr int NG = THREADS / 32 * TPW;
  static_assert(HD % VEC == 0 && LPT <= 32 && 32 % LPT == 0, "head dim");

  __shared__ float sm_m[NG][RT], sm_l[NG][RT];
  __shared__ float sm_acc[NG][RT][HD];

  const int split = blockIdx.x, b = blockIdx.z;
  const int rep = H / KH, groups = rep / RT;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * rep + (blockIdx.y % groups) * RT;
  const int len = min(max(length[b], 0), L);
  const int t_begin = split * chunk;
  const int t_end = min(len, t_begin + chunk);
  const int tid = threadIdx.x;

  if (t_begin >= t_end) {
    // Nothing to read.  With one split this CTA owns the output (a
    // length-0 row: 0); with several, the merge pass skips this split.
    if (splits == 1) {
      for (int i = tid; i < RT * HD; i += THREADS)
        put<T>(out, ((long long)b * H + h0 + i / HD) * HD + i % HD, 0.f, lse);
      if (lse != nullptr && tid < RT) lse[(long long)b * H + h0 + tid] =
          empty_lse();
    }
    return;
  }

  const int lane = tid & 31, sub = lane % LPT;
  const int gid = (tid >> 5) * TPW + lane / LPT;
  const int d0 = sub * VEC;

  float qv[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + b * sqb + (long long)(h0 + r) * sqh + d0);
    widen<T, VEC>(raw, qv[r]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[r][e] *= scale;
  }
  float m[RT], l[RT], acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }
  const T* kb = k + b * skb + kvh * skh + d0;
  const T* vb = v + b * svb + kvh * svh + d0;

  // The trip count is the same for every thread (shuffles below take the
  // whole warp); a slot past t_end is masked.
  for (int base = t_begin; base < t_end; base += NG * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * NG + gid;
      if (t < t_end) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + t * skl);
        vr[u] = *reinterpret_cast<const uint4*>(vb + t * svl);
      } else {
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][RT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      widen<T, VEC>(kr[u], kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
        s[u][r] = base + u * NG + gid < t_end ? dot : NEG_INF;
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
        if (base + u * NG + gid >= t_end) continue;
        const float p = expf(s[u][r] - mx);
        float vf[VEC];
        widen<T, VEC>(vr[u], vf);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
      m[r] = mx;
    }
  }

  // ---- merge the CTA's token groups
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (sub == 0) {
      sm_m[gid][r] = m[r];
      sm_l[gid][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[gid][r][d0 + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < RT * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float mx = NEG_INF;
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_m[g][r]);
    float ls = 0.f, a = 0.f;
    for (int g = 0; g < NG; ++g) {
      const float c = expf(sm_m[g][r] - mx);
      ls += sm_l[g][r] * c;
      a += sm_acc[g][r][d] * c;
    }
    const long long row = (long long)b * H + h0 + r;
    if (splits == 1) {
      put<T>(out, row * HD + d, a / fmaxf(ls, 1e-20f), lse);
      if (lse != nullptr && d == 0)
        lse[row] = ls > 0.f ? mx + logf(ls) : empty_lse();
    } else {
      ws_acc[(row * splits + split) * HD + d] = a;
      if (d == 0) {
        ws_ml[(row * splits + split) * 2] = mx;
        ws_ml[(row * splits + split) * 2 + 1] = ls;
      }
    }
  }
}

// Merge the splits of each (lane, head): grid (H, B), one thread per dim.
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_merge_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    const int* __restrict__ length, void* __restrict__ out,
    float* __restrict__ lse, int H, int HD, int L, int chunk, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = min(max(length[b], 0), L);
  const int n_eff = (len + chunk - 1) / chunk;  // splits that wrote
  const long long row = (long long)b * H + h;
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float mx = NEG_INF, ls = 0.f, a = 0.f;
    for (int s = 0; s < n_eff; ++s) {
      const float ms = ws_ml[(row * splits + s) * 2];
      const float m_new = fmaxf(mx, ms);
      const float c_old = expf(mx - m_new), c_new = expf(ms - m_new);
      ls = ls * c_old + ws_ml[(row * splits + s) * 2 + 1] * c_new;
      a = a * c_old + ws_acc[(row * splits + s) * HD + d] * c_new;
      mx = m_new;
    }
    put<T>(out, row * HD + d, a / fmaxf(ls, 1e-20f), lse);
    if (lse != nullptr && d == 0)
      lse[row] = ls > 0.f ? mx + logf(ls) : empty_lse();
  }
}

template <typename T, int HD, int RT>
int launch_rt(const void* q, const void* k, const void* v, const int* length,
              void* out, float* ws_acc, float* ws_ml, float* lse, int B,
              int H, int KH, int L, int chunk, int splits,
              const long long* st, float scale, float softcap,
              cudaStream_t stream) {
  const dim3 grid(splits, KH * (H / KH / RT), B);
  decode_attention_kernel<T, HD, RT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, out, ws_acc, ws_ml,
      lse, H, KH, L, chunk, splits, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale, softcap);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || splits == 1) return rc;
  decode_merge_kernel<T><<<dim3(H, B), THREADS, 0, stream>>>(
      ws_acc, ws_ml, length, out, lse, H, HD, L, chunk,
      splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(int rt, const void* q, const void* k, const void* v,
              const int* length, void* out, float* ws_acc, float* ws_ml,
              float* lse, int B, int H, int KH, int L, int chunk, int splits,
              const long long* st, float scale, float softcap,
              cudaStream_t stream) {
#define DA_ARGS q, k, v, length, out, ws_acc, ws_ml, lse, B, H, KH, L, \
                chunk, splits, st, scale, softcap, stream
  switch (rt) {
    case 1: return launch_rt<T, HD, 1>(DA_ARGS);
    case 2: return launch_rt<T, HD, 2>(DA_ARGS);
    case 4: return launch_rt<T, HD, 4>(DA_ARGS);
    case 8: return launch_rt<T, HD, 8>(DA_ARGS);
  }
#undef DA_ARGS
  return -3;
}

template <typename T>
int launch_typed(int hd, int rt, const void* q, const void* k, const void* v,
                 const int* length, void* out, float* ws_acc, float* ws_ml,
                 float* lse, int B, int H, int KH, int L, int chunk,
                 int splits, const long long* st, float scale, float softcap,
                 cudaStream_t stream) {
#define DA_ARGS rt, q, k, v, length, out, ws_acc, ws_ml, lse, B, H, KH, L, \
                chunk, splits, st, scale, softcap, stream
  switch (hd) {
    case 32: return launch_hd<T, 32>(DA_ARGS);
    case 64: return launch_hd<T, 64>(DA_ARGS);
    case 128: return launch_hd<T, 128>(DA_ARGS);
  }
#undef DA_ARGS
  return -3;
}

}  // namespace

// q [B, H, hd], k/v [B, L, KH, hd] in ``dtype`` (0 f32, 1 bf16) through
// the strides ``st`` = (q: b, h; k: b, l, kh; v: b, l, kh) in elements;
// ``length`` int32 [B]; out dense [B, H, hd].  ``rt`` query heads per CTA
// (1, 2, 4 or 8, dividing H / KH); ``splits`` CTAs of ``chunk`` slots along
// L, merged through the f32 workspaces ``ws_acc`` [B, H, splits, hd] and
// ``ws_ml`` [B, H, splits, 2] when splits > 1; ``lse`` (nullable) f32
// [B, H] receives each row's log-sum-exp, and out is then f32.  Returns
// cudaGetLastError() after the launches, -2 for an unsupported dtype, -3
// for an unsupported head dim or head group.
extern "C" int decode_attention_launch(int dtype, int hd, int rt,
                                       const void* q, const void* k,
                                       const void* v, const int* length,
                                       void* out, float* ws_acc,
                                       float* ws_ml, float* lse, int B,
                                       int H, int KH, int L, int chunk,
                                       int splits,
                                       long long sqb, long long sqh,
                                       long long skb, long long skl,
                                       long long skh, long long svb,
                                       long long svl, long long svh,
                                       float scale, float softcap,
                                       void* stream) {
  const long long st[8] = {sqb, sqh, skb, skl, skh, svb, svl, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_typed<float>(hd, rt, q, k, v, length, out, ws_acc, ws_ml,
                               lse, B, H, KH, L, chunk, splits, st, scale,
                               softcap, s);
  if (dtype == BF16)
    return launch_typed<__nv_bfloat16>(hd, rt, q, k, v, length, out, ws_acc,
                                       ws_ml, lse, B, H, KH, L, chunk, splits,
                                       st, scale, softcap, s);
  return -2;
}
