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
// softcap is cap * tanh(s / cap), taken after the 1/sqrt(hd) scale.  GQA:
// query head h reads kv head h / (H / KH).  Any Sq <= Sk: ragged edges are
// masked here, so neither length has to divide a tile.
//
// Layout.  q [N, Sq, H, hd], k/v [N, Sk, KH, hd] are read in place through
// their batch, sequence and head strides (the head dim is dense): no
// transpose copies like the TPU wrapper's (flash_attention.py:86-88).  N is
// the batch with any leading dims folded in (the semantic split's branches
// times the batch), so one launch serves every branch.  out is a dense
// [N, Sq, H, hd].
//
// The walk (both paths; _flash_launch.flash_plan is its Python mirror).
// One CTA per (head, batch, query tile), the query tiles scheduled latest
// first (the slowest grid dim, reversed), so the longest causal walks start
// first.  A tile walks, in order, the 64-token key tiles that hold an
// unmasked key for one of its rows: up to the causal frontier of its last
// row, from the window start of its first row.  A key tile needs a mask
// only if it crosses Sk, the causal frontier of the tile's first row or the
// window edge of its last; the others take an unmasked branch.  A warp (a
// warpgroup under wgmma) skips a masked tile that holds no unmasked key for
// any of its rows, and one whose rows all lie past Sq skips every tile.
// K/V tiles arrive through a cp.async ring (zero fill past Sk; rows past Sq
// are zero queries), one CTA barrier per tile: after it, the next tile's
// copy is issued into the stage every warp has finished with, and runs
// under this tile's math.  Online-softmax state per row (max and sum in
// f32, in the log2 domain) lives in registers.
//
// bf16: tensor cores, bound by them at the main path's shape (B 2, S 2048,
// H = K = 32, hd 64, causal: ~3.4e10 flops against ~67 MB, 0.035 ms at
// 989 TFLOP/s against 0.020 ms for the bytes).  So S and P never leave
// registers, the copies overlap the math, and the exponentials of one warp
// run beside another's products.  Row max and sum by quad shuffles; P
// rounded to bf16 is the A operand of P V; the row sum is over the
// unrounded P.  One kernel per head dim, chosen here from hd alone (the
// faster on the card where both fit; PERF.md has the comparison):
// - flash_attention_kernel_wgmma (hd 64, 128): two warpgroups of 64 rows;
//   S = Q K^T and P V by wgmma.mma_async, Q, K and V read by the tensor
//   cores from 128-byte-swizzled shared memory, P from registers.
// - flash_attention_kernel_mma (hd 32): mma.sync m16n8k16 on 4 warps of 32
//   query rows (two m16 tiles, so each K and V fragment read by ldmatrix
//   feeds two mma), V through ldmatrix.trans.
// A 3-stage ring (2 under wgmma at hd 128, where 3 would leave one CTA per
// SM).
//
// f32 (flash_attention_kernel_simt): CUDA cores, f32 arithmetic (tensor
// cores would mean TF32, a precision decision), bound by f32 operations
// (0.51 ms at 67 TFLOP/s on the main shape).  128 query rows per CTA of 8
// warps, 16 rows a warp; a thread owns 4 rows x 8 keys of the scores and
// 4 rows x hd/8 dims of the output.  A warp's 128-bit shared load takes two
// wavefronts at best (8 or fewer distinct addresses) and four beyond, so
// every load here has at most 8, and a 4-deep step of the scores issues 12
// loads (24 wavefronts) for 128 FMAs per thread: the FMA pipe, not shared
// memory, sets the pace.  P goes through shared memory in four passes of
// 16 keys (a warp's own rows, under __syncwarp), which keeps the CTA at
// 108 KB at hd 64: two CTAs of 8 warps per SM.  A 2-stage ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;                  // key tokens per tile, both paths
constexpr int BQ = 128;                 // query rows per CTA, every kernel
constexpr float NEG_INF = -1e30f;       // running-max floor: never NaN
constexpr float LOG2E = 1.4426950408889634f;

enum Dtype { F32 = 0, BF16 = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, H, KH;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float scale, softcap;
};

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

// The key tiles [kt_begin, kt_end) a query tile walks; qa / qb are the
// positions of its first and last row (rows past Sq excluded).
struct Walk {
  int kt_begin, kt_end, qa, qb;
};

__device__ __forceinline__ Walk walk_of(const Args& a, int q0, int rows) {
  const int q_off = a.Sk - a.Sq;
  Walk w;
  w.qa = q_off + q0;
  w.qb = q_off + min(q0 + rows, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, w.qb + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, w.qa - a.window + 1) : 0;
  w.kt_begin = k_begin / BK;
  w.kt_end = (k_end + BK - 1) / BK;
  return w;
}

// True when the tile at key k0 holds a masked (query, key) pair for rows
// qa..qb: it crosses Sk, the causal frontier of the first row or the
// window edge of the last.
__device__ __forceinline__ bool tile_masked(const Args& a, int k0, int qa,
                                            int qb) {
  return k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qa) ||
         (a.window > 0 && k0 <= qb - a.window);
}

// True when no key of the tile at k0 is unmasked for rows qa..qb.
__device__ __forceinline__ bool tile_dead(const Args& a, int k0, int qa,
                                          int qb) {
  return (a.causal && k0 > qb) ||
         (a.window > 0 && k0 + BK - 1 <= qa - a.window);
}

__device__ __forceinline__ bool key_ok(const Args& a, int kpos, int qpos) {
  return kpos < a.Sk && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// The score the softmax sees, in the log2 domain, as x * c: without a
// softcap x is the raw q.k and c = log2(e) / sqrt(hd), so the max runs on
// raw scores and p = 2^(x c - m) is one FFMA and one ex2; with a softcap
// x = cap log2(e) tanh(q.k / (sqrt(hd) cap)) and c = 1.
struct Logit {
  float mul, cap_mul, c;
  bool cap;
  __device__ __forceinline__ explicit Logit(const Args& a)
      : mul(a.scale / a.softcap),
        cap_mul(a.softcap * LOG2E),
        c(a.softcap > 0.f ? 1.f : a.scale * LOG2E),
        cap(a.softcap > 0.f) {}
  // x from the raw score, with a softcap (without one x is the score)
  __device__ __forceinline__ float capped(float s) const {
    return cap_mul * tanhf(s * mul);
  }
};

// 2^x (ex2.approx: 2 ulp, -inf -> 0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one m16 tile's scores s (the mma C layout: element e
// of s[j] is row lane/4 + 8 (e >> 1), token 8j + 2 (lane % 4) + (e & 1)):
// softcap, mask (MASK), the rows' max by quad shuffles, the running max and
// sum updated; returns P rounded to bf16 as the A fragments of P V (pa) and
// the factors (alpha) that rescale the rows' accumulators.  l sums the
// unrounded P.
template <bool MASK>
__device__ __forceinline__ void softmax16(
    const Args& a, float (&s)[BK / 8][4], int k0, const int (&qp)[2],
    int lane, float (&m_run)[2], float (&l_run)[2],
    uint32_t (&pa)[BK / 16][4], float (&alpha)[2]) {
  const Logit logit(a);
  if (logit.cap) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = logit.capped(s[j][e]);
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK) {
        const int kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        if (!key_ok(a, kpos, qp[e >> 1]))
          s[j][e] = __uint_as_float(0xff800000u);
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[r], m * logit.c);  // finite: >= NEG_INF
    alpha[r] = exp2_fast(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_fast(fmaf(s[j][e], logit.c, neg_m[e >> 1]));
      l_run[e >> 1] += p[e];
    }
    pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// ------------------------------------------------------ bf16: tensor cores
// hd 32 only (wgmma takes hd 64 and 128).  A CTA of 4 warps, each owning
// MT = 2 m16 tiles (32 query rows): every K and V fragment a warp reads
// from shared memory feeds two mma, which halves the shared-memory reads
// per mma (faster on the card than 4 or 8 warps of one m16 tile, 255
// registers against 128).
//
// Dynamic shared memory of one CTA, in bf16 elements: Q, then the ring's
// 3 stages of K and V (rows padded by 16 bytes).
constexpr int MMA_WARPS = 4;
constexpr int MT = 2;                        // m16 tiles per warp

template <int HD>
struct MmaSmem {
  static constexpr int STAGES = 3;
  static constexpr int LD = HD + 8;          // bf16 row stride
  static constexpr int ROWS = BQ;
  static_assert(16 * MT * MMA_WARPS == BQ, "a warp's rows");
  static constexpr int Q_ELEMS = ROWS * LD;
  static constexpr int TILE = BK * LD;
  static constexpr int STAGE = 2 * TILE;     // K then V
  static constexpr int BYTES = 2 * (Q_ELEMS + STAGES * STAGE);
};

// One key tile for one warp: S = Q K^T (Q's fragments read from shared
// memory each tile, which leaves their registers to the accumulators),
// online softmax, O += P V.  Element e of s[t][j]: row lane/4 + 8 (e >> 1)
// of m tile t, token 8j + 2 (lane % 4) + (e & 1).
template <int HD, bool MASK>
__device__ __forceinline__ void mma_tile(
    const Args& a, const __nv_bfloat16* Qw, const __nv_bfloat16* Kt,
    const __nv_bfloat16* Vt, int LD, int k0, const int (&qp)[MT][2],
    int lane, float (&m_run)[MT][2], float (&l_run)[MT][2],
    float (&o)[MT][HD / 8][4]) {
  const int mi = lane / 8;
  float s[MT][BK / 8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[t][j][0] = s[t][j][1] = s[t][j][2] = s[t][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t qf[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
      ldmatrix_x4(qf[t], Qw + (16 * t + (mi & 1) * 8 + lane % 8) * LD +
                             kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, Kt + (nt * 16 + (mi >> 1) * 8 + lane % 8) * LD +
                          kk * 16 + (mi & 1) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_bf16(s[t][2 * nt], qf[t], kb[0], kb[1]);
        mma_bf16(s[t][2 * nt + 1], qf[t], kb[2], kb[3]);
      }
    }
  }
  uint32_t pa[MT][BK / 16][4];   // P rounded to bf16: the A fragments of P V
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    float alpha[2];
    softmax16<MASK>(a, s[t], k0, qp[t], lane, m_run[t], l_run[t], pa[t],
                    alpha);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[t][j][0] *= alpha[0];
      o[t][j][1] *= alpha[0];
      o[t][j][2] *= alpha[1];
      o[t][j][3] *= alpha[1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int nd = 0; nd < HD / 16; ++nd) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, Vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD +
                                nd * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_bf16(o[t][2 * nd], pa[t][kk], vb[0], vb[1]);
        mma_bf16(o[t][2 * nd + 1], pa[t][kk], vb[2], vb[3]);
      }
    }
  }
}

// Two CTAs per SM (255 registers a thread).
template <int HD>
__global__ void __launch_bounds__(32 * MMA_WARPS, 2)
    flash_attention_kernel_mma(const Args a) {
  using L = MmaSmem<HD>;
  constexpr int STAGES = L::STAGES;
  constexpr int LD = L::LD;
  constexpr int ROWS = L::ROWS;
  constexpr int WROWS = 16 * MT;            // query rows per warp
  constexpr int THREADS = 32 * MMA_WARPS;
  constexpr int CPR = HD / 8;               // 16-byte chunks per row
  static_assert(HD % 16 == 0 && (L::Q_ELEMS * 2) % 16 == 0 &&
                    (L::STAGE * 2) % 16 == 0,
                "alignment");
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stages = Qs + L::Q_ELEMS;

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;   // latest first
  const int kvh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Walk w = walk_of(a, q0, ROWS);
  const int n_tiles = w.kt_end - w.kt_begin;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.qsb + (long long)h * a.qsh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.ksb + (long long)kvh * a.ksh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.vsb + (long long)kvh * a.vsh;

  // Q rows (zero past Sq), in the first copy group
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, ch = i % CPR;
    const bool ok = q0 + r < a.Sq;
    cp_async16(Qs + r * LD + ch * 8,
               qb + (ok ? (long long)(q0 + r) * a.qss : 0) + ch * 8, ok);
  }
  // the copies of walk step it into stage it % STAGES, one group
  auto issue = [&](int it) {
    if (it < n_tiles) {
      __nv_bfloat16* st = stages + (it % STAGES) * L::STAGE;
      const int k0 = (w.kt_begin + it) * BK;
      for (int i = tid; i < BK * CPR; i += THREADS) {
        const int t = i / CPR, ch = i % CPR;
        const bool ok = k0 + t < a.Sk;
        const long long row = ok ? k0 + t : 0;
        cp_async16(st + t * LD + ch * 8, kb + row * a.kss + ch * 8, ok);
        cp_async16(st + L::TILE + t * LD + ch * 8, vb + row * a.vss + ch * 8,
                   ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);

  const int row_w = q0 + warp * WROWS;        // this warp's first row
  const bool idle = row_w >= a.Sq;            // every row past Sq
  const int qa_w = a.Sk - a.Sq + row_w;       // its first and last position
  const int qb_w = qa_w + WROWS - 1;
  const __nv_bfloat16* Qw = Qs + warp * WROWS * LD;
  int qp[MT][2];
  float o[MT][HD / 8][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qp[t][r] = qa_w + 16 * t + lane / 4 + 8 * r;
      m_run[t][r] = NEG_INF;
      l_run[t][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      o[t][j][0] = o[t][j][1] = o[t][j][2] = o[t][j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();   // step it (and Q) landed
    __syncthreads();               // ... for every thread; step it - 1 is
                                   // done with, so its stage refills
    issue(it + STAGES - 1);
    if (idle) continue;
    const __nv_bfloat16* Kt = stages + (it % STAGES) * L::STAGE;
    const __nv_bfloat16* Vt = Kt + L::TILE;
    const int k0 = (w.kt_begin + it) * BK;
    if (!tile_masked(a, k0, w.qa, w.qb)) {
      mma_tile<HD, false>(a, Qw, Kt, Vt, LD, k0, qp, lane, m_run, l_run,
                              o);
    } else if (!tile_dead(a, k0, qa_w, qb_w)) {
      mma_tile<HD, true>(a, Qw, Kt, Vt, LD, k0, qp, lane, m_run, l_run,
                             o);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[t][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row_w + 16 * t + lane / 4 + 8 * r;
      if (row >= a.Sq) continue;
      __nv_bfloat16* op = out + ((b * a.Sq + row) * a.H + h) * (long long)HD +
                          2 * (lane % 4);
      const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
            o[t][j][2 * r] * inv, o[t][j][2 * r + 1] * inv);
    }
  }
}

// ------------------------------------------------- bf16: warpgroup mma
// hd 64 and 128.  Two warpgroups of 64 query rows; S = Q K^T by
// wgmma.mma_async m64n64k16 with Q and K read by the tensor cores straight
// from shared memory (K-major), P V (m64n{hd}k16) with P from registers
// (the S accumulator's layout is the A fragments', as for mma.sync) and V
// N-major through the transpose bit: no ldmatrix at all.  Q and the ring's
// K and V tiles are kept as hd/64 blocks of 64 columns, each of rows of 128
// bytes in 1024-byte atoms of the 128-byte swizzle (16-byte chunk c of row
// r at c ^ (r & 7)), written by cp.async.
constexpr int WG_ROWS = BQ;                  // two warpgroups of 64
constexpr int WG_THREADS = 256;

// 3 stages; 2 at hd 128, so that two CTAs fit an SM.
template <int HD>
struct WgSmem {                              // in bytes
  static constexpr int STAGES = HD >= 128 ? 2 : 3;
  static constexpr int Q_BLOCK = WG_ROWS * 128;   // 64 columns of Q
  static constexpr int KV_BLOCK = BK * 128;       // 64 columns of K or V
  static constexpr int TILE = HD / 64 * KV_BLOCK;
  static constexpr int Q = HD / 64 * Q_BLOCK;
  // Q, the ring, and slack to align it all to the swizzle's 1024 bytes
  static constexpr int BYTES = Q + STAGES * 2 * TILE + 1024;
};

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define WG_D32(B)                                                            \
  "+f"(d[B + 0]), "+f"(d[B + 1]), "+f"(d[B + 2]), "+f"(d[B + 3]),           \
      "+f"(d[B + 4]), "+f"(d[B + 5]), "+f"(d[B + 6]), "+f"(d[B + 7]),       \
      "+f"(d[B + 8]), "+f"(d[B + 9]), "+f"(d[B + 10]), "+f"(d[B + 11]),     \
      "+f"(d[B + 12]), "+f"(d[B + 13]), "+f"(d[B + 14]), "+f"(d[B + 15]),   \
      "+f"(d[B + 16]), "+f"(d[B + 17]), "+f"(d[B + 18]), "+f"(d[B + 19]),   \
      "+f"(d[B + 20]), "+f"(d[B + 21]), "+f"(d[B + 22]), "+f"(d[B + 23]),   \
      "+f"(d[B + 24]), "+f"(d[B + 25]), "+f"(d[B + 26]), "+f"(d[B + 27]),   \
      "+f"(d[B + 28]), "+f"(d[B + 29]), "+f"(d[B + 30]), "+f"(d[B + 31])
#define WG_D32_TEXT                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define WG_D64_TEXT                                                          \
  WG_D32_TEXT ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
              "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
              "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d = (acc ? d : 0) + A (64 x 16, K-major, desc da) @ B (16 x 64, K-major,
// desc db): one warpgroup, bf16 -> f32.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32_TEXT
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A (64 x 16 from registers: each warp its 16 rows as mma.sync A
// fragments) @ B (16 x N, N-major through the transpose bit, desc db).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32_TEXT
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "wgmma n");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64_TEXT
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D32(0), WG_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
#undef WG_D32
#undef WG_D32_TEXT
#undef WG_D64_TEXT

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// One key tile for one warpgroup.
template <int HD, bool MASK>
__device__ __forceinline__ void wgmma_tile(
    const Args& a, const uint8_t* Qg, const uint8_t* Kt, const uint8_t* Vt,
    int k0, const int (&qp)[2], int lane, float (&m_run)[2],
    float (&l_run)[2], float (&o)[HD / 8][4]) {
  using L = WgSmem<HD>;
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {   // k step: 32 bytes along a row
    const int blk = kk / 4, col = kk % 4 * 32;
    wgmma_ss(&s[0][0], sw128_desc(Qg + blk * L::Q_BLOCK + col, 16, 1024),
             sw128_desc(Kt + blk * L::KV_BLOCK + col, 16, 1024), kk);
  }
  wgmma_wait();
  fence_acc(s);
  uint32_t pa[BK / 16][4];
  float alpha[2];
  softmax16<MASK>(a, s, k0, qp, lane, m_run, l_run, pa, alpha);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
  fence_acc(o);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  // k step: 16 rows of V (LBO: the next 64-column block)
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<HD>(&o[0][0], pa[kk],
                 sw128_desc(Vt + kk * 2048, L::KV_BLOCK, 1024));
  wgmma_wait();
  fence_acc(o);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 2)
    flash_attention_kernel_wgmma(const Args a) {
  using L = WgSmem<HD>;
  constexpr int WG_STAGES = L::STAGES;
  constexpr int CPR = HD / 8;               // 16-byte chunks per row
  extern __shared__ uint8_t wg_raw[];
  uint8_t* Qs = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  uint8_t* stages = Qs + L::Q;

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_ROWS;   // latest first
  const int kvh = h / (a.H / a.KH);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const Walk w = walk_of(a, q0, WG_ROWS);
  const int n_tiles = w.kt_end - w.kt_begin;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.qsb + (long long)h * a.qsh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.ksb + (long long)kvh * a.ksh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.vsb + (long long)kvh * a.vsh;

  // 16-byte chunk ch of row r: block ch / 8, swizzled chunk in the block
  auto at = [](int r, int ch, int block_bytes) {
    return ch / 8 * block_bytes + r * 128 + 16 * ((ch % 8) ^ (r & 7));
  };
  for (int i = tid; i < WG_ROWS * CPR; i += WG_THREADS) {
    const int r = i / CPR, ch = i % CPR;
    const bool ok = q0 + r < a.Sq;
    cp_async16(Qs + at(r, ch, L::Q_BLOCK),
               qb + (ok ? (long long)(q0 + r) * a.qss : 0) + ch * 8, ok);
  }
  auto issue = [&](int it) {
    if (it < n_tiles) {
      uint8_t* st = stages + (it % WG_STAGES) * 2 * L::TILE;
      const int k0 = (w.kt_begin + it) * BK;
      for (int i = tid; i < BK * CPR; i += WG_THREADS) {
        const int t = i / CPR, ch = i % CPR;
        const bool ok = k0 + t < a.Sk;
        const long long row = ok ? k0 + t : 0;
        const int off = at(t, ch, L::KV_BLOCK);
        cp_async16(st + off, kb + row * a.kss + ch * 8, ok);
        cp_async16(st + L::TILE + off, vb + row * a.vss + ch * 8, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < WG_STAGES - 1; ++it) issue(it);

  const int row_g = q0 + wg * 64;              // this warpgroup's first row
  const bool idle = row_g >= a.Sq;
  const int qa_g = a.Sk - a.Sq + row_g;
  const int qp[2] = {qa_g + warp * 16 + lane / 4,
                     qa_g + warp * 16 + lane / 4 + 8};
  const uint8_t* Qg = Qs + wg * 64 * 128;
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<WG_STAGES - 2>();   // step it (and Q) landed
    // the tensor cores read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();                  // step it - 1 is done with, so its
    issue(it + WG_STAGES - 1);        // stage refills under this math
    if (idle) continue;
    const uint8_t* Kt = stages + (it % WG_STAGES) * 2 * L::TILE;
    const int k0 = (w.kt_begin + it) * BK;
    if (!tile_masked(a, k0, w.qa, w.qb)) {
      wgmma_tile<HD, false>(a, Qg, Kt, Kt + L::TILE, k0, qp, lane, m_run,
                            l_run, o);
    } else if (!tile_dead(a, k0, qa_g, qa_g + 63)) {
      wgmma_tile<HD, true>(a, Qg, Kt, Kt + L::TILE, k0, qp, lane, m_run,
                           l_run, o);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_g + warp * 16 + lane / 4 + 8 * r;
    if (row >= a.Sq) continue;
    __nv_bfloat16* op = out + ((b * a.Sq + row) * a.H + h) * (long long)HD +
                        2 * (lane % 4);
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// --------------------------------------------------------- f32: CUDA cores
// 8 warps, 16 query rows each.  A warp's lanes are 4 row groups (rg = lane
// / 8) x 8 column lanes (cl = lane % 8): a thread owns rows rg + 4j (j < 4)
// of its warp's 16, keys cl + 8i (i < 8) of the tile, and dims 4 cl + 32u
// .. +3 (u < hd/32) of the output.  Each shared load then has at most 8
// distinct 16-byte addresses (two wavefronts), and a 4-deep step of the
// scores issues 12 loads (24 wavefronts) for 128 FMAs.
constexpr int SIMT_WARPS = 8;
constexpr int SIMT_THREADS = 32 * SIMT_WARPS;
constexpr int SIMT_ROWS = BQ;                // query rows per CTA
static_assert(16 * SIMT_WARPS == BQ, "a warp's rows");
constexpr int PQ = 16;                       // keys per P pass
constexpr int PS = PQ + 8;                   // P row stride: conflict-free

// Dynamic shared memory of one CTA, in floats: Q, two stages of K and V
// (Q's and K's 16-byte chunk c of row r at c ^ (r & 7)), each warp's P
// pass.  108 KB at hd 64: two CTAs of 8 warps per SM.
template <int HD>
struct SimtSmem {
  static constexpr int Q = SIMT_ROWS * HD;
  static constexpr int TILE = BK * HD;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int P = SIMT_WARPS * 16 * PS;
  static constexpr int BYTES = 4 * (Q + 2 * STAGE + P);
};

// One key tile for one warp (the layout above): scores, online softmax,
// then O += P V in four passes of 16 keys through the warp's P rows.
template <int HD, bool MASK>
__device__ __forceinline__ void simt_tile(
    const Args& a, const float* Qw, const float* Kt, const float* Vt,
    float* Pw, int k0, int qa_w, int rg, int cl, float (&m_run)[4],
    float (&l_run)[4], float (&acc)[4][HD / 8]) {
  constexpr int U = HD / 32;                 // float4 groups per thread
  float s[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) s[j][i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < HD / 4; ++c) {
    float4 qv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rg + 4 * j;              // (r & 7) == (4j + rg) & 7
      qv[j] = *reinterpret_cast<const float4*>(Qw + r * HD +
                                               4 * (c ^ (r & 7)));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = cl + 8 * i;              // t & 7 == cl
      const float4 kv =
          *reinterpret_cast<const float4*>(Kt + t * HD + 4 * (c ^ cl));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[j][i];
        x = fmaf(qv[j].x, kv.x, x);
        x = fmaf(qv[j].y, kv.y, x);
        x = fmaf(qv[j].z, kv.z, x);
        x = fmaf(qv[j].w, kv.w, x);
        s[j][i] = x;
      }
    }
  }
  const Logit logit(a);
  if (logit.cap) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[j][i] = logit.capped(s[j][i]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float m = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = s[j][i];
      if constexpr (MASK) {
        if (!key_ok(a, k0 + cl + 8 * i, qa_w + rg + 4 * j))
          x = __uint_as_float(0xff800000u);
      }
      s[j][i] = x;
      m = fmaxf(m, x);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)    // the row's 8 lanes
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float m_new = fmaxf(m_run[j], m * logit.c);  // finite: >= NEG_INF
    const float alpha = exp2_fast(m_run[j] - m_new);
    m_run[j] = m_new;
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[j][i] = exp2_fast(fmaf(s[j][i], logit.c, -m_new));
      l += s[j][i];
    }
    l_run[j] = l_run[j] * alpha + l;         // this lane's keys only
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) acc[j][d] *= alpha;
  }
#pragma unroll
  for (int pass = 0; pass < BK / PQ; ++pass) {
    __syncwarp();                            // the last pass's reads done
#pragma unroll
    for (int j = 0; j < 4; ++j) {            // keys cl, cl + 8 of the pass
      Pw[(rg + 4 * j) * PS + cl] = s[j][2 * pass];
      Pw[(rg + 4 * j) * PS + cl + 8] = s[j][2 * pass + 1];
    }
    __syncwarp();
    const float* vp = Vt + pass * PQ * HD + 4 * cl;
#pragma unroll
    for (int t4 = 0; t4 < PQ; t4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pv[j] = *reinterpret_cast<const float4*>(Pw + (rg + 4 * j) * PS + t4);
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vp + (t4 + u4) * HD + 32 * u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = u4 == 0 ? pv[j].x : u4 == 1 ? pv[j].y
                          : u4 == 2 ? pv[j].z : pv[j].w;
            acc[j][4 * u + 0] = fmaf(p, vv.x, acc[j][4 * u + 0]);
            acc[j][4 * u + 1] = fmaf(p, vv.y, acc[j][4 * u + 1]);
            acc[j][4 * u + 2] = fmaf(p, vv.z, acc[j][4 * u + 2]);
            acc[j][4 * u + 3] = fmaf(p, vv.w, acc[j][4 * u + 3]);
          }
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS, HD <= 64 ? 2 : 1)
    flash_attention_kernel_simt(const Args a) {
  using L = SimtSmem<HD>;
  constexpr int CPR = HD / 4;                // 16-byte chunks per row
  static_assert(HD % 32 == 0 && CPR >= 8, "head dim");
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* stages = Qs + L::Q;
  float* Ps = stages + 2 * L::STAGE;

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * SIMT_ROWS;   // latest first
  const int kvh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cl = lane % 8;
  const Walk w = walk_of(a, q0, SIMT_ROWS);
  const int n_tiles = w.kt_end - w.kt_begin;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb +
                    (long long)h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb +
                    (long long)kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb +
                    (long long)kvh * a.vsh;

  for (int i = tid; i < SIMT_ROWS * CPR; i += SIMT_THREADS) {
    const int r = i / CPR, ch = i % CPR;
    const bool ok = q0 + r < a.Sq;
    cp_async16(Qs + r * HD + 4 * (ch ^ (r & 7)),
               qb + (ok ? (long long)(q0 + r) * a.qss : 0) + 4 * ch, ok);
  }
  // the copies of walk step it into stage it % 2, one group
  auto issue = [&](int it) {
    if (it < n_tiles) {
      float* st = stages + (it & 1) * L::STAGE;
      const int k0 = (w.kt_begin + it) * BK;
      for (int i = tid; i < BK * CPR; i += SIMT_THREADS) {
        const int t = i / CPR, ch = i % CPR;
        const bool ok = k0 + t < a.Sk;
        const long long row = ok ? k0 + t : 0;
        cp_async16(st + t * HD + 4 * (ch ^ (t & 7)),
                   kb + row * a.kss + 4 * ch, ok);
        cp_async16(st + L::TILE + t * HD + 4 * ch, vb + row * a.vss + 4 * ch,
                   ok);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int row_w = q0 + warp * 16;
  const bool idle = row_w >= a.Sq;
  const int qa_w = a.Sk - a.Sq + row_w;
  const float* Qw = Qs + warp * 16 * HD;
  float* Pw = Ps + warp * 16 * PS;
  float m_run[4], l_run[4], acc[4][HD / 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m_run[j] = NEG_INF;
    l_run[j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) acc[j][d] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();      // step it (and Q) landed
    __syncthreads();         // ... for every thread; step it - 1 is done
    issue(it + 1);           // with, so its stage refills under this math
    if (idle) continue;
    const float* Kt = stages + (it & 1) * L::STAGE;
    const float* Vt = Kt + L::TILE;
    const int k0 = (w.kt_begin + it) * BK;
    if (!tile_masked(a, k0, w.qa, w.qb)) {
      simt_tile<HD, false>(a, Qw, Kt, Vt, Pw, k0, qa_w, rg, cl, m_run, l_run,
                           acc);
    } else if (!tile_dead(a, k0, qa_w, qa_w + 15)) {
      simt_tile<HD, true>(a, Qw, Kt, Vt, Pw, k0, qa_w, rg, cl, m_run, l_run,
                          acc);
    }
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float l = l_run[j];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = row_w + rg + 4 * j;
    if (row >= a.Sq) continue;
    float* op = out + ((b * a.Sq + row) * a.H + h) * (long long)HD + 4 * cl;
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int u = 0; u < HD / 32; ++u)
      *reinterpret_cast<float4*>(op + 32 * u) =
          make_float4(acc[j][4 * u] * inv, acc[j][4 * u + 1] * inv,
                      acc[j][4 * u + 2] * inv, acc[j][4 * u + 3] * inv);
  }
}

// ----------------------------------------------------------------- launch
// Sets the kernel's dynamic shared memory once per device, then launches.
template <typename K>
int launch(K kern, int smem, dim3 grid, int threads, const Args& a,
           cudaStream_t st, unsigned long long& configured) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -5;
  if (!(configured >> dev & 1ull)) {
    cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured |= 1ull << dev;
  }
  kern<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const Args& a, int N, cudaStream_t st) {
  static unsigned long long configured = 0;
  constexpr int ROWS = MmaSmem<HD>::ROWS;
  const dim3 grid(a.H, N, (a.Sq + ROWS - 1) / ROWS);
  return launch(flash_attention_kernel_mma<HD>, MmaSmem<HD>::BYTES, grid,
                32 * MMA_WARPS, a, st, configured);
}

template <int HD>
int launch_simt(const Args& a, int N, cudaStream_t st) {
  static unsigned long long configured = 0;
  const dim3 grid(a.H, N, (a.Sq + SIMT_ROWS - 1) / SIMT_ROWS);
  return launch(flash_attention_kernel_simt<HD>, SimtSmem<HD>::BYTES, grid,
                SIMT_THREADS, a, st, configured);
}

template <int HD>
int launch_wgmma(const Args& a, int N, cudaStream_t st) {
  static unsigned long long configured = 0;
  const dim3 grid(a.H, N, (a.Sq + WG_ROWS - 1) / WG_ROWS);
  return launch(flash_attention_kernel_wgmma<HD>, WgSmem<HD>::BYTES, grid,
                WG_THREADS, a, st, configured);
}

// bf16: mma.sync at hd 32, wgmma at hd 64 and 128 (the 128-byte rows of
// its swizzle need 64 columns)
template <int HD>
int launch_hd(int dtype, const Args& a, int N, cudaStream_t st) {
  if (dtype == F32) return launch_simt<HD>(a, N, st);
  if (dtype != BF16) return -2;
  if constexpr (HD == 32) {
    return launch_mma<HD>(a, N, st);
  } else {
    return launch_wgmma<HD>(a, N, st);
  }
}

}  // namespace

// q [N, Sq, H, hd], k/v [N, Sk, KH, hd] with element strides (batch, seq,
// head) in q_strides / k_strides / v_strides and a dense head dim; out a
// dense [N, Sq, H, hd] of the same type.  f32 runs on the CUDA cores, bf16
// on the tensor cores (launch_hd).  Returns cudaGetLastError() after the
// launch, or -1 / -2 for an unsupported head dim / dtype.
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k,
    const void* v, void* out, int N, int Sq, int Sk, int H, int KH,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, float scale, float softcap,
    void* stream) {
  const Args a{q,   k,   v,   out, Sq,  Sk,  H,   KH,     qsb,    qss, qsh,
               ksb, kss, ksh, vsb, vss, vsh, causal, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, a, N, st);
    case 64: return launch_hd<64>(dtype, a, N, st);
    case 128: return launch_hd<128>(dtype, a, N, st);
    default: return -1;
  }
}
