// Masked per-coordinate trimmed mean / coordinate median for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `robust_trimmed`
// (src/repro/kernels/robust_agg.py, `_trim_kernel`).  Semantics of record:
// `repro_torch.kernels.ref.robust_trimmed`.
//
// Per parameter coordinate p, over the M client rows: a participating row's
// rank is the count of participating rows j strictly below it, ties broken
// by row index, with the reference's own predicate
//   (x_j < x_i) | (x_j == x_i & j < i)
// (so a NaN row, which compares false with everything, has rank 0 and
// beats nobody, as in the reference).  Rows of rank in [k, n - k) are kept,
// summed in row order in f32 and divided by max(n - 2k, 1): k = 0 is the
// masked mean, k = floor((n-1)/2) the median.  n and k are read from two
// one-float device tensors, as the Pallas kernel reads `nk_ref`, so the
// caller never waits on the device for them.  No participants: all zeros.
//
// Layout: one thread per coordinate, 128 threads a block.  The block stages
// its M x 128 tile in shared memory as [M][blockDim] (bf16 widened on
// load): row r of the tile is one coalesced 512-byte (f32) read of row r of
// `updates`, and thread t reads column t of every row, so the M^2 rank
// tests hit no bank conflicts.  The participation flags sit in shared
// memory and broadcast.  M is at most kMaxM = 64 (32 KB of tile).
//
// What bounds it on the H100: operations.  M^2 * P pair tests, each a
// compare, a compare, a select and an add on the FP32/INT lanes (there is
// no tensor-core form of a rank count), against M * P * sizeof(dtype)
// bytes read once: at M = 64 that is ~64 pair tests, ~256 lane ops, per
// byte, far above the card's ~20 FP32 ops per byte of HBM bandwidth.  At
// the Fig. 3 size (M = 20, P = 5674: 2.3e6 pair tests, 0.45 MB) the launch
// is bound by launch latency.  The design keeps every operand on chip
// after one read and does no sort.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void robust_trimmed_kernel(const T* __restrict__ upd, const float* __restrict__ mask,
                                      const float* __restrict__ n_ptr,
                                      const float* __restrict__ k_ptr, float* __restrict__ out,
                                      int m, long long p) {
  extern __shared__ float tile[];  // [m][blockDim.x]
  __shared__ int part[kMaxM];
  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += blockDim.x) part[i] = mask[i] > 0.5f ? 1 : 0;
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const bool live = col < p;
  for (int r = 0; r < m; ++r)
    tile[r * blockDim.x + tid] = live ? to_f32(upd[static_cast<long long>(r) * p + col]) : 0.0f;
  __syncthreads();
  if (!live) return;

  const float n = *n_ptr;
  const float k = fmaxf(*k_ptr, 0.0f);
  const float hi = __fsub_rn(n, k);
  float acc = 0.0f;
  for (int i = 0; i < m; ++i) {
    if (!part[i]) continue;
    const float xi = tile[i * blockDim.x + tid];
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const float xj = tile[j * blockDim.x + tid];
      rank += part[j] & static_cast<int>((xj < xi) | ((xj == xi) & (j < i)));
    }
    const float rf = static_cast<float>(rank);
    if (rf >= k && rf < hi) acc = __fadd_rn(acc, xi);
  }
  out[col] = __fdiv_rn(acc, fmaxf(__fsub_rn(n, __fmul_rn(2.0f, k)), 1.0f));
}

template <typename T>
int launch(const void* upd, const float* mask, const float* n, const float* k, float* out, int m,
           long long p, cudaStream_t s) {
  const long long blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(m) * kThreads * sizeof(float);
  robust_trimmed_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(upd), mask, n, k, out, m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  n, k: device pointers to one f32 each.
extern "C" int robust_trimmed_launch(const void* upd, const float* mask, const float* n,
                                     const float* k, float* out, int m, long long p, int dtype,
                                     void* stream) {
  if (m <= 0 || m > kMaxM || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(upd, mask, n, k, out, m, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(upd, mask, n, k, out, m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
