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
// at a time; each group's product is taken on the integer codes with f32
// accumulation and scaled once by the group's per-column scale into an f32
// accumulator, so the weight is never dequantized to memory.  Codes from
// -127 to 127 are exact in bf16 and in f32.  The output is cast to x's
// dtype.  Three paths, chosen by the caller before the launch
// (``_quant_launch.path_for``):
//
//   mma_skinny / mma_tile (bf16 x, tensor cores): qmm_mma_kernel.  A bf16 x
//   bf16 product is exact in f32, so mma.sync m16n8k16 with f32
//   accumulation computes what f32 FMAs on the codes did, up to summation
//   order.  The operands are swapped: the codes are the A side (output
//   columns E are the m16 dimension) and x the B side (rows T are the n8
//   dimension), so a decode call of 8 rows wastes no tensor-core rows.  A
//   CTA owns 128 output columns x BN rows and walks its groups through a
//   ring of shared-memory stages, one group per stage, filled by 16-byte
//   cp.async copies (code rows of 128 contiguous bytes, x rows, the
//   group's scale row): the next groups' copies are in flight while this
//   one is multiplied.  The codes go to the A fragments without a widened
//   copy: ldmatrix.trans reads the raw int8 rows as 16-bit pairs (code rows
//   padded by 16 bytes: no bank conflicts), which hands each thread the
//   codes of two neighbouring columns at its two contraction rows, and the
//   thread widens them to bf16 in registers; so a tile's mma rows are its
//   columns in a fixed permutation, undone in the epilogue.  int4: the low
//   nibbles of 16 stored rows are the k16 step of rows p, the high nibbles
//   the step of rows group/2 + p.  The group's k16 steps sum into fresh
//   fragments, which are scaled by their columns' scales into the
//   accumulator fragments.
//     mma_skinny (T <= 32; BN = 8, 16 or 32; 4 warps of 32 columns): bound
//     by the code bytes (2 T flops per byte).  One projection has only
//     E / 128 column tiles, so the groups are split over the CTAs of a
//     thread-block cluster (at most 8) to keep every SM's copies in flight;
//     the splits merge inside the launch: each CTA leaves its f32 tile in
//     shared memory, and after a cluster barrier each rank adds a slice of
//     the tile over ranks 0, 1, ... in order through distributed shared
//     memory (deterministic) and writes it, coalesced.  One launch per call.
//     mma_tile (T > 32; BN = 128, or 64 where 128-row tiles would leave
//     half the SMs idle; 8 warps of 32 x BN / 2): bound by tensor-core
//     operations at a 1024-row prefill; no split (one CTA per tile).
//   Both need group <= 128 and a multiple of 16 (int8) or 32 (int4: 16
//   stored rows per step), E % 16 == 0, D % 8 == 0 and 16-byte-aligned
//   pointers (what 16-byte cp.async needs).
//
//   simt (f32 x, and bf16 x the copies cannot take): quant_matmul_kernel on
//   the CUDA cores, f32 FMAs (no TF32).  A CTA stages a slab of KS
//   contraction rows at a time (codes widened to f32, int4 unpacked in
//   registers) and every thread adds its RT x CT outputs' slab products;
//   rows and columns past T and E are masked, so any shape works.
//   Decode-sized calls split the groups over CTAs into an f32 workspace and
//   a second kernel adds the splits in order (two launches); a 1024-row
//   prefill uses 64 x 64 tiles.
#include <cooperative_groups.h>
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

// ------------------------------------------------ tensor-core paths
constexpr int MMA_BM = 128;      // output columns per CTA
constexpr int MAX_GROUP = 128;   // contraction rows of a group, at most
constexpr int MAX_SPLITS = 8;    // CTAs of a cluster (the portable limit)

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
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
__device__ __forceinline__ uint32_t pack_bf16(int lo, int hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// Dynamic shared memory of one CTA, in bytes: STAGES ring stages, each a
// group's raw code rows (MAX_GROUP rows of 128 bytes, padded by 16 so
// ldmatrix reads them without bank conflicts), its x columns (BN rows of
// MAX_GROUP bf16, padded by 16 bytes) and its scale row (128 f32).  After
// the walk the ring holds the f32 output tile [BN][CLD].
template <int BN, int STAGES>
struct QmmSmem {
  static constexpr int RLD = MMA_BM + 16;         // code row stride, bytes
  static constexpr int XLD = MAX_GROUP + 8;       // bf16 x row stride
  static constexpr int CLD = MMA_BM + 4;          // f32 output row stride
  static constexpr int RAW = MAX_GROUP * RLD;
  static constexpr int XS = BN * XLD * 2;
  static constexpr int SC = MMA_BM * 4;
  static constexpr int STAGE = RAW + XS + SC;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(BN * CLD * 4 <= BYTES, "output tile fits the ring");
  static_assert(RAW % 16 == 0 && XS % 16 == 0 && STAGE % 16 == 0, "align");
};

// A fragments of two m16 tiles from one ldmatrix.x4.trans of raw code rows
// read as 16-bit pairs: register j of the load holds, for thread (gid, tig),
// the codes of columns 2 gid and 2 gid + 1 at contraction rows 2 tig and
// 2 tig + 1 (bytes 0, 1 and 2, 3).  So the tile's mma rows are a fixed
// permutation of its 16 columns (row gid <-> column 2 gid, row gid + 8 <->
// column 2 gid + 1), which the epilogue undoes; no widened copy of the
// codes is ever stored.  int8: one k16 step; int4: the low nibbles give the
// step of rows p and the high nibbles the step of rows group/2 + p.
template <bool INT4>
__device__ __forceinline__ void codes_to_frag(uint32_t r, uint32_t& even,
                                              uint32_t& odd, uint32_t& even_hi,
                                              uint32_t& odd_hi) {
  const int8_t b0 = static_cast<int8_t>(r), b1 = static_cast<int8_t>(r >> 8);
  const int8_t b2 = static_cast<int8_t>(r >> 16);
  const int8_t b3 = static_cast<int8_t>(r >> 24);
  if constexpr (INT4) {
    even = pack_bf16(lo_nibble(b0), lo_nibble(b2));
    odd = pack_bf16(lo_nibble(b1), lo_nibble(b3));
    even_hi = pack_bf16(hi_nibble(b0), hi_nibble(b2));
    odd_hi = pack_bf16(hi_nibble(b1), hi_nibble(b3));
  } else {
    even = pack_bf16(b0, b2);
    odd = pack_bf16(b1, b3);
  }
}

// BN output rows x 128 output columns per CTA; WM x WN warps, each owning
// (128 / WM) columns x (BN / WN) rows.  gridDim.x = splits of the groups
// (the CTAs of one cluster), y = column tiles, z = G x row tiles.
template <bool INT4, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN) qmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
    int T, int D, int E, int group, int per_split) {
  using L = QmmSmem<BN, STAGES>;
  constexpr int NT = 32 * WM * WN;
  constexpr int MI = MMA_BM / WM / 16;   // m16 tiles per warp
  constexpr int NI = BN / WN / 8;        // n8 tiles per warp
  static_assert(MI % 2 == 0 && (NI == 1 || NI % 2 == 0), "warp tile");
  extern __shared__ __align__(16) uint8_t smem[];

  const int splits = gridDim.x, split = blockIdx.x;
  const int col0 = blockIdx.y * MMA_BM;
  const int row_tiles = (T + BN - 1) / BN;
  const int g = blockIdx.z / row_tiles, row0 = (blockIdx.z % row_tiles) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_groups = D / group;
  const int span = INT4 ? group / 2 : group;   // stored code rows per group
  const int gi0 = split * per_split;
  const int n_local = max(0, min(n_groups, gi0 + per_split) - gi0);
  const __nv_bfloat16* xg = x + (long long)g * T * D;
  const int8_t* qg = q + (long long)g * n_groups * span * E;
  const float* sg = scales + (long long)g * n_groups * E;

  // the copies of local group ``i`` into stage ``i % STAGES``
  auto issue = [&](int i) {
    uint8_t* st = smem + (i % STAGES) * L::STAGE;
    const int gi = gi0 + i;
    for (int v = tid; v < span * (MMA_BM / 16); v += NT) {
      const int r = v / (MMA_BM / 16), ch = v % (MMA_BM / 16);
      const int col = col0 + ch * 16;
      const bool ok = col < E;             // E % 16 == 0: all in or all out
      cp_async16(st + r * L::RLD + ch * 16,
                 qg + (long long)(gi * span + r) * E + (ok ? col : 0), ok);
    }
    // x: 16-byte chunk ch of rows rr, rr + NT / 16, ... (group / 8 <= 16
    // chunks per row; no division by the runtime group)
    constexpr int XCH = MAX_GROUP / 8;
    const int ch = tid % XCH;
    if (ch < group / 8)
      for (int rr = tid / XCH; rr < BN; rr += NT / XCH) {
        const int row = row0 + rr;
        const bool ok = row < T;
        cp_async16(st + L::RAW + rr * L::XLD * 2 + ch * 16,
                   xg + (long long)(ok ? row : 0) * D + gi * group + ch * 8,
                   ok);
      }
    if (tid < MMA_BM / 4) {
      const int col = col0 + tid * 4;
      const bool ok = col < E;
      cp_async16(st + L::RAW + L::XS + tid * 16,
                 sg + (long long)gi * E + (ok ? col : 0), ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int wm = warp % WM, wn = warp / WM;
  const int lm = lane / 8, lr = lane % 8;
  const int gid = lane / 4, tig = lane % 4;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_local) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_local; ++i) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of group i landed
    __syncthreads();               // everyone's; group i - 1 fully consumed
    if (i + STAGES - 1 < n_local) issue(i + STAGES - 1);
    cp_async_commit();
    const uint8_t* st = smem + (i % STAGES) * L::STAGE;
    const __nv_bfloat16* Xs =
        reinterpret_cast<const __nv_bfloat16*>(st + L::RAW);

    // B fragments (x rows) of the k16 step at x column ``k0``
    auto load_b = [&](uint32_t (&bf)[NI][2], int k0) {
      if constexpr (NI == 1) {
        ldmatrix_x2(bf[0], Xs + (wn * 8 + lr) * L::XLD + k0 + (lm & 1) * 8);
      } else {
#pragma unroll
        for (int b = 0; b < NI; b += 2) {
          uint32_t r4[4];
          ldmatrix_x4(r4, Xs + (wn * NI * 8 + b * 8 + (lm >> 1) * 8 + lr) *
                                   L::XLD + k0 + (lm & 1) * 8);
          bf[b][0] = r4[0];
          bf[b][1] = r4[1];
          bf[b + 1][0] = r4[2];
          bf[b + 1][1] = r4[3];
        }
      }
    };

    // ---- the group's product on the codes, in fresh fragments: 16 stored
    // code rows per step (int4: two k16 steps)
    float part[MI][NI][4];
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
        part[a][b][0] = part[a][b][1] = part[a][b][2] = part[a][b][3] = 0.f;
#pragma unroll 2
    for (int p0 = 0; p0 < span; p0 += 16) {
      uint32_t af[MI][4], ah[MI][4];
#pragma unroll
      for (int a = 0; a < MI; a += 2) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, st + (p0 + (lm & 1) * 8 + lr) * L::RLD +
                                  wm * (MI * 16) + a * 16 + (lm >> 1) * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          codes_to_frag<INT4>(r4[2 * j], af[a + j][0], af[a + j][1],
                              ah[a + j][0], ah[a + j][1]);
          codes_to_frag<INT4>(r4[2 * j + 1], af[a + j][2], af[a + j][3],
                              ah[a + j][2], ah[a + j][3]);
        }
      }
      uint32_t bf[NI][2];
      load_b(bf, p0);
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int b = 0; b < NI; ++b)
          mma_bf16(part[a][b], af[a], bf[b][0], bf[b][1]);
      if constexpr (INT4) {
        load_b(bf, span + p0);
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int b = 0; b < NI; ++b)
            mma_bf16(part[a][b], ah[a], bf[b][0], bf[b][1]);
      }
    }

    // ---- scaled once by each column's scale into the accumulator (mma
    // row gid is column 2 gid of its tile, row gid + 8 column 2 gid + 1)
    const float* sc = reinterpret_cast<const float*>(st + L::RAW + L::XS);
#pragma unroll
    for (int a = 0; a < MI; ++a) {
      const int m = wm * (MI * 16) + a * 16 + 2 * gid;
      const float s0 = sc[m], s1 = sc[m + 1];
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        acc[a][b][0] += part[a][b][0] * s0;
        acc[a][b][1] += part[a][b][1] * s0;
        acc[a][b][2] += part[a][b][2] * s1;
        acc[a][b][3] += part[a][b][3] * s1;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free for the output tile

  // ---- this CTA's f32 tile -> shared [BN][CLD] (row = x row, col = E)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b) {
      const int m = wm * (MI * 16) + a * 16 + 2 * gid;
      const int n = wn * (NI * 8) + b * 8 + 2 * tig;
      Cs[n * L::CLD + m] = acc[a][b][0];
      Cs[(n + 1) * L::CLD + m] = acc[a][b][1];
      Cs[n * L::CLD + m + 1] = acc[a][b][2];
      Cs[(n + 1) * L::CLD + m + 1] = acc[a][b][3];
    }

  // ---- merge the splits in rank order (one CTA: its own tile) and write
  // 4 columns per thread; each rank takes a slice of the tile
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rank = splits > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  constexpr int QUADS = BN * (MMA_BM / 4);
  const int per = (QUADS + splits - 1) / splits;
  const int v_end = min(QUADS, (rank + 1) * per);
  for (int v = rank * per + tid; v < v_end; v += NT) {
    const int n = v / (MMA_BM / 4), m = (v % (MMA_BM / 4)) * 4;
    // every rank's partials loaded before any is added (unrolled and
    // predicated: the remote loads are in flight together), then summed
    // in rank order
    float4 p[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits)
        p[r] = *reinterpret_cast<const float4*>(
            (splits > 1 ? cluster.map_shared_rank(Cs, r) : Cs) + n * L::CLD +
            m);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < splits) {
        s.x += p[r].x;
        s.y += p[r].y;
        s.z += p[r].z;
        s.w += p[r].w;
      }
    }
    const int row = row0 + n, col = col0 + m;
    if (row < T && col < E)        // E % 16 == 0: all four columns
      *reinterpret_cast<uint2*>(out + ((long long)g * T + row) * E + col) =
          make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  }
  if (splits > 1) cluster.sync();  // peers' tiles stay until read
}

template <bool INT4, int BN, int WM, int WN, int STAGES>
int launch_mma(const void* x, const void* q, const float* scales, void* out,
               int splits, int per_split, int G, int T, int D, int E,
               int group, cudaStream_t stream) {
  using L = QmmSmem<BN, STAGES>;
  auto kern = qmm_mma_kernel<INT4, BN, WM, WN, STAGES>;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (E + MMA_BM - 1) / MMA_BM,
                     G * ((T + BN - 1) / BN));
  cfg.blockDim = dim3(32 * WM * WN);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(q), scales, static_cast<__nv_bfloat16*>(out),
      T, D, E, group, per_split);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int launch_mma_bits(int tile_rows, const void* x, const void* q,
                    const float* scales, void* out, int splits,
                    int per_split, int G, int T, int D, int E, int group,
                    cudaStream_t st) {
#define QMMA_ARGS x, q, scales, out, splits, per_split, G, T, D, E, group, st
  switch (tile_rows) {
    case 8: return launch_mma<INT4, 8, 4, 1, 4>(QMMA_ARGS);
    case 16: return launch_mma<INT4, 16, 4, 1, 4>(QMMA_ARGS);
    case 32: return launch_mma<INT4, 32, 4, 1, 4>(QMMA_ARGS);
    case 64:
      if (splits != 1) return -3;
      return launch_mma<INT4, 64, 4, 2, 3>(QMMA_ARGS);
    case 128:
      if (splits != 1) return -3;
      return launch_mma<INT4, 128, 4, 2, 4>(QMMA_ARGS);
  }
#undef QMMA_ARGS
  return -4;
}

}  // namespace

// simt path.  x/out [G, T, D] / [G, T, E] in x_dtype (0 f32, 1 bf16); q
// int8 codes [G, D, E] (bits 8) or packed [G, D/2, E] (bits 4); scales f32
// [G, D/group, E]; all contiguous.  ``splits`` > 1 (only for T <= 32,
// every split non-empty) splits the groups over CTAs through the f32
// workspace ``partial`` [splits, G, T, E] and a second launch.  Returns
// cudaGetLastError() after the launches, -2 for an unsupported dtype / bit
// width, -3 for a split at prefill-sized T.
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

// mma_skinny / mma_tile paths: bf16 x and out, the same layouts, with 16 <=
// group <= 128, group % 16 == 0, E % 16 == 0, D % 8 == 0 and 16-byte-aligned
// pointers (the caller checks).  ``tile_rows`` 8, 16 or 32 (mma_skinny,
// ``splits`` <= 8 CTAs of a cluster, ``per_split`` groups each, every split
// non-empty) or 128 (mma_tile, one split).  One launch.  Returns
// cudaGetLastError() after it, -2 for a bit width, -3 for a split of the
// 128-row tile, -4 for a tile, -5 when the device cannot be read.
extern "C" int quant_matmul_mma_launch(int bits, int tile_rows, const void* x,
                                       const void* q, const float* scales,
                                       void* out, int splits, int per_split,
                                       int G, int T, int D, int E, int group,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS || group % (bits == 4 ? 32 : 16) ||
      group > MAX_GROUP)
    return -3;
#define QMMA_ARGS tile_rows, x, q, scales, out, splits, per_split, G, T, D, \
                  E, group, st
  if (bits == 8) return launch_mma_bits<false>(QMMA_ARGS);
  if (bits == 4) return launch_mma_bits<true>(QMMA_ARGS);
#undef QMMA_ARGS
  return -2;
}

