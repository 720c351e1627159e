// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   ssm_scan   src/repro/kernels/ssm_scan.py (_scan_kernel, pallas_call at
//              :52): a, b [B, S, D, N] -> h [B, S, D, N], the state in f32
//              from h_{-1} = 0, each h_t cast to a's dtype.
//
// The TPU kernel walks time in chunks resident in VMEM and carries the
// [D, N] state in scratch across a sequential grid axis.  Here every
// (batch, d, n) recurrence is independent, so one thread owns VEC
// neighbouring recurrences along the contiguous D*N axis, keeps their
// state in f32 registers and walks S: at every step a warp reads and
// writes contiguous 16-byte (f32) or 8-byte (bf16) vectors.  The loads of
// U steps are issued together before the U dependent updates, so each
// thread has U steps of a and b in flight.  Any S; offsets are 64-bit (a
// full-width Mamba mixer's tensor holds 5.4e8 elements).
//
// Arithmetic.  Each step is a rounded f32 multiply then a rounded f32 add
// (no fused multiply-add), as the plain PyTorch loop computes it, so the
// kernel and its plain version agree bit for bit.
//
// Bound.  One read of a and b and one write of h: about 2 flops per 12
// bytes of f32, so device-memory bytes bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 8;          // time steps whose loads are in flight together

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC consecutive elements as one aligned vector load / store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
    int Bn, int S, long long DN) {
  using V = Vec<T, VEC>;
  const long long lanes = DN / VEC;     // vectors per time step
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= Bn * lanes) return;
  const long long bi = i / lanes;
  const long long base = bi * S * DN + (i % lanes) * VEC;

  float st[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) st[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += U) {
    V av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const long long off = base + (long long)(t0 + u) * DN;
        av[u] = *reinterpret_cast<const V*>(a + off);
        bv[u] = *reinterpret_cast<const V*>(b + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        V hv;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          st[e] = __fadd_rn(__fmul_rn(to_f32(av[u].v[e]), st[e]),
                            to_f32(bv[u].v[e]));
          store_as(&hv.v[e], st[e]);
        }
        *reinterpret_cast<V*>(h + base + (long long)(t0 + u) * DN) = hv;
      }
    }
  }
}

template <typename T, int VEC>
int launch_vec(const void* a, const void* b, void* h, int Bn, int S,
               long long DN, cudaStream_t st) {
  const long long threads = (long long)Bn * (DN / VEC);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -3;
  ssm_scan_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      Bn, S, DN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(int vec, const void* a, const void* b, void* h, int Bn,
                 int S, long long DN, cudaStream_t st) {
  if (vec == 4) return launch_vec<T, 4>(a, b, h, Bn, S, DN, st);
  if (vec == 1) return launch_vec<T, 1>(a, b, h, Bn, S, DN, st);
  return -3;
}

}  // namespace

// a, b, h contiguous [Bn, S, DN] in ``dtype`` (0 f32, 1 bf16); ``vec`` 4
// (DN % 4 == 0 and the pointers 4-element aligned) or 1.  Returns
// cudaGetLastError() after the launch, -2 for an unsupported dtype, -3 for
// an unsupported vector width or a grid too large.
extern "C" int ssm_scan_launch(int dtype, int vec, const void* a,
                               const void* b, void* h, int Bn, int S,
                               long long DN, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return launch_typed<float>(vec, a, b, h, Bn, S, DN, st);
  if (dtype == BF16)
    return launch_typed<__nv_bfloat16>(vec, a, b, h, Bn, S, DN, st);
  return -2;
}
