// Eq. 7 server aggregation for Hopper (sm_90a): out[p] = sum_m scale[m] * updates[m, p].
//
// Replaces the Pallas TPU kernel `weighted_aggregate`
// (src/repro/kernels/weighted_aggregate.py, `_agg_kernel`).  Semantics of
// record: `repro_torch.kernels.ref.weighted_aggregate`.
//
// Each thread owns VEC neighbouring columns and walks the M rows in order,
// accumulating in f32; neighbouring threads read neighbouring addresses, so
// every row is read as one coalesced sweep.  VEC = 4 uses 16-byte loads for
// f32 and 8-byte loads (4 values) for bf16; it needs P % 4 == 0 so that every
// row starts 16-byte aligned, and the wrapper falls back to VEC = 1 (4- or
// 2-byte coalesced loads) for ragged P.  The M scales are read once into
// shared memory.  No atomics: each output has one owner, and the sum runs
// m = 0..M-1 with the product rounded before the add (no FMA contraction),
// the same rounding as the plain version's `sum(scale[:, None] * x, 0)`.
//
// What bounds it on the H100: memory.  M*P*sizeof(dtype) bytes in, 4*P out,
// 2*M*P flops; at 3.35 TB/s the card needs M*P*sizeof/3.35e12 s for the
// reads, far above the flop time.  The design reads each update element
// exactly once with wide coalesced loads.  At the Fig. 3 size (20 x 5674)
// the launch is latency bound (454 KB of input).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&x)[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

template <typename T, int VEC>
__global__ void weighted_aggregate_kernel(const T* __restrict__ upd, const float* __restrict__ scale,
                                          float* __restrict__ out, int m, long long p) {
  extern __shared__ float s_scale[];
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_scale[i] = scale[i];
  __syncthreads();

  const long long col = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= p) return;
  if constexpr (VEC == 4) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < m; ++r) {
      float x[4];
      load4<T>(upd + static_cast<long long>(r) * p + col, x);
      const float sc = s_scale[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(sc, x[k]));
    }
    *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    float acc = 0.0f;
    for (int r = 0; r < m; ++r)
      acc = __fadd_rn(acc, __fmul_rn(s_scale[r], to_f32(upd[static_cast<long long>(r) * p + col])));
    out[col] = acc;
  }
}

template <typename T>
int launch(const void* upd, const float* scale, float* out, int m, long long p, int vec,
           cudaStream_t s) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  const long long per_block = static_cast<long long>(kThreads) * vec;
  const long long blocks = (p + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) {
    weighted_aggregate_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const T*>(upd), scale, out, m, p);
  } else {
    weighted_aggregate_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const T*>(upd), scale, out, m, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  vec: 4 (P % 4 == 0, 16-byte aligned base) or 1.
extern "C" int weighted_aggregate_launch(const void* upd, const float* scale, float* out, int m,
                                         long long p, int dtype, int vec, void* stream) {
  if (m <= 0 || p <= 0 || (vec != 1 && vec != 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(upd, scale, out, m, p, vec, s);
  if (dtype == 1) return launch<__nv_bfloat16>(upd, scale, out, m, p, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
