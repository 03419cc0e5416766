// Eq. 7 server aggregation for Hopper (sm_90a): out[p] = sum_m scale[m] * updates[m, p],
// for one run or for a batch of B runs at once (out[b, p] = sum_m scale[b, m] * updates[b, m, p]).
//
// Replaces the Pallas TPU kernel `weighted_aggregate`
// (src/repro/kernels/weighted_aggregate.py, `_agg_kernel`).  Semantics of
// record: `repro_torch.kernels.ref.weighted_aggregate`.
//
// Each thread owns VEC neighbouring columns and walks the M rows in order,
// accumulating in f32; neighbouring threads read neighbouring addresses, so
// every row is read as one coalesced sweep.  The launcher picks VEC from the
// alignment every row shares: VEC = 4 (16-byte f32 / 8-byte bf16 loads) when
// P % 4 == 0 and the base is aligned to that width, VEC = 2 (8-byte f32 /
// 4-byte bf16 loads) when P is even and the base is aligned to that width,
// VEC = 1 otherwise.  The Fig. 3 shape (P = 5674 = 2 mod 4) takes VEC = 2:
// its f32 rows start 8-byte aligned (4 * 5674 = 8 mod 16), so 8-byte loads
// cover every row whole, with no per-row head or tail; a warp's 8-byte loads
// are 256 contiguous bytes, whole sectors, the same traffic as 16-byte ones.
//
// The rows go in chunks of kChunk = 16: a chunk's loads of updates and its
// scales (broadcast, read-only path) are issued together into registers,
// then added in row order, so a thread waits about one memory latency a
// chunk instead of one a row.  No shared memory and no barrier.  No atomics: each output has one
// owner, and the sum runs m = 0..M-1 with the product rounded before the add
// (no FMA contraction), the rounding of `acc = acc + scale[m] * x[m]`; the
// result is deterministic.
//
// What bounds it on the H100: memory.  M*P*sizeof(dtype) bytes in, 4*P out,
// 2*M*P flops; at 3.35 TB/s the card needs M*P*sizeof/3.35e12 s for the
// reads, far above the flop time.  The design reads each update element
// exactly once with wide coalesced loads.  At the Fig. 3 size (20 x 5674,
// 454 KB) the call is bound by launch latency: the launcher shrinks the
// block (256 threads down to 32) until the grid has at least two blocks an
// SM or one warp a block, so the load latency is spread over the SMs.
//
// A batch of runs is one launch: the grid's y index is the run, whose block
// offsets its pointers to its own (M, P) rows, (M,) scales and (P,) output
// and then does exactly what a single-run block does (the same row-order
// sum, the same load width), so row b of a batch is bit for bit the
// single-run kernel's result on run b.  The load width must suit every
// run's rows: the launcher checks each run's base (base + b * M * P
// elements), not only the first.  The block shrinks until the whole grid
// (blocks a run x B) spreads over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr int kChunk = 16;                     // rows whose loads go out together
constexpr long long kSpreadBlocks = 2 * 132;   // two blocks on each of the H100's 132 SMs

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&x)[VEC]);

template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load<float, 2>(const float* p, float (&x)[2]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  x[0] = v.x; x[1] = v.y;
}

template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float (&x)[1]) { x[0] = __ldg(p); }

template <>
__device__ __forceinline__ void load<__nv_bfloat16, 4>(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

template <>
__device__ __forceinline__ void load<__nv_bfloat16, 2>(const __nv_bfloat16* p, float (&x)[2]) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p));
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  x[0] = __low2float(b); x[1] = __high2float(b);
}

template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(const __nv_bfloat16* p, float (&x)[1]) {
  x[0] = __bfloat162float(p[0]);
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&acc)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
    p[0] = acc[0];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
weighted_aggregate_kernel(const T* __restrict__ upd, const float* __restrict__ scale,
                          float* __restrict__ out, int m, long long p) {
  const long long run = blockIdx.y;            // 0 for a single run
  upd += run * m * p;
  scale += run * m;
  out += run * p;
  const long long col = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= p) return;
  const T* src = upd + col;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  for (int r0 = 0; r0 < m; r0 += kChunk) {
    float x[kChunk][VEC];
    float s[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {           // the chunk's loads, all in flight together
      if (r0 + k < m) {
        load<T, VEC>(src + static_cast<long long>(r0 + k) * p, x[k]);
        s[k] = __ldg(scale + r0 + k);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {           // then the adds, in row order
      if (r0 + k < m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(s[k], x[k][v]));
      }
    }
  }
  store<VEC>(out + col, acc);
}

template <typename T, int VEC>
void run(const void* upd, const float* scale, float* out, int m, long long p, dim3 grid,
         int threads, cudaStream_t s) {
  weighted_aggregate_kernel<T, VEC><<<grid, threads, 0, s>>>(static_cast<const T*>(upd), scale,
                                                              out, m, p);
}

// Every run's rows start at base + r * stride bytes, r < runs: all aligned
// to `width` bytes iff the base is and (with more than one run) the stride.
bool runs_aligned(std::uintptr_t base, long long stride, int runs, std::size_t width) {
  return base % width == 0 && (runs == 1 || stride % static_cast<long long>(width) == 0);
}

template <typename T>
int launch(const void* upd, const float* scale, float* out, int runs, int m, long long p,
           cudaStream_t s) {
  const auto base = reinterpret_cast<std::uintptr_t>(upd);
  const long long stride = static_cast<long long>(m) * p * static_cast<long long>(sizeof(T));
  int vec = 1;
  if (p % 4 == 0 && runs_aligned(base, stride, runs, 4 * sizeof(T))) {
    vec = 4;
  } else if (p % 2 == 0 && runs_aligned(base, stride, runs, 2 * sizeof(T))) {
    vec = 2;
  }
  const long long owners = (p + vec - 1) / vec;
  int threads = kMaxThreads;
  while (threads > kMinThreads && (owners + threads - 1) / threads * runs < kSpreadBlocks) {
    threads /= 2;
  }
  const long long blocks = (owners + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(runs));
  if (vec == 4) {
    run<T, 4>(upd, scale, out, m, p, grid, threads, s);
  } else if (vec == 2) {
    run<T, 2>(upd, scale, out, m, p, grid, threads, s);
  } else {
    run<T, 1>(upd, scale, out, m, p, grid, threads, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* upd, const float* scale, float* out, int runs, int m, long long p,
             int dtype, void* stream) {
  if (runs <= 0 || runs > 65535 || m <= 0 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(upd, scale, out, runs, m, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(upd, scale, out, runs, m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  The load width is chosen here from P and the
// base pointer's alignment.
extern "C" int weighted_aggregate_launch(const void* upd, const float* scale, float* out, int m,
                                         long long p, int dtype, void* stream) {
  return dispatch(upd, scale, out, 1, m, p, dtype, stream);
}

// A batch of `runs` runs (at most 65535): upd (runs, M, P), scale (runs, M),
// out (runs, P), one launch.
extern "C" int weighted_aggregate_batch_launch(const void* upd, const float* scale, float* out,
                                               int runs, int m, long long p, int dtype,
                                               void* stream) {
  return dispatch(upd, scale, out, runs, m, p, dtype, stream);
}
