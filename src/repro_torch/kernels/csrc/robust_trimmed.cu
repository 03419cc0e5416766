// Masked per-coordinate trimmed mean / coordinate median for Hopper (sm_90a),
// for one run or for a batch of B runs in one launch.
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
// Layout: one thread per coordinate; its M values sit in registers (`key`,
// a compile-time bucket MB of 8, 16, 32 or 64 slots).  The participation
// bits come from two warp ballots over the mask, and every row's load is
// issued before any is used (slots past M re-read row M - 1), so a thread
// waits one memory latency, not one a row.  The rank loop reads no memory:
// - a row that does not participate, and a slot past M, is held as NaN in
//   `key`: NaN beats nobody and is beaten by nobody under the predicate;
// - with the loop order fixing a < b, the predicate is one compare:
//   row a beats row b iff key_a <= key_b, row b beats row a iff
//   key_b < key_a.  Exact for NaN, +-inf and +-0 (-0 == +0 is a tie);
// - between two rows that are not NaN exactly one beats the other, so one
//   compare serves both: rank_b gains [key_a <= key_b] and rank_a, which
//   starts at the count of not-NaN rows after it, loses it.  `set.le.f32`
//   is one FSET.BF (1.0 or 0.0) on the ALU pipe, the two f32 adds go to the
//   FMA pipe: three instructions per unordered pair.  (`set.le.s32` with
//   integer adds compiled to FSETP + SEL + adds, all on the ALU pipe, and
//   was slower.)  Counts are f32, exact up to 2^24.
// - the pairs go in blocks of kRows = 8 rows: a runtime loop over block ib
//   plays its rows against each other and against every later block that
//   holds rows, with every register index a compile-time constant (ib is
//   the same in every thread, so its tests are uniform branches).  That
//   keeps the 64-slot body a few thousand SASS instructions (phase 1 of
//   `chip_smoke.py` prints the count) where the full 64 x 63 unroll is
//   more than twice as long, at more registers, and no faster.
// A participating NaN row gets rank 0 at the end, as in the reference.  The
// kept sum adds `key` (the real value of a participating row) in row order,
// so the median (at most two kept values) is bitwise the plain version's.
//
// What bounds it on the H100: operations.  At least one lane instruction
// per ordered pair, M^2 * P (there is no tensor-core form of a rank count),
// against M * P * sizeof(dtype) bytes read once: at M = 64 that is 16
// instructions per f32 byte, above the card's ~10 lane instructions per
// byte of HBM bandwidth.  At the Fig. 3 size (M = 20, P = 5674: 0.45 MB)
// the call is bound by its host cost; the launcher shrinks the block (128
// threads down to 32) until the grid has at least two blocks an SM or one
// warp a block.
//
// A batch of runs is one launch: the grid's y index is the run, whose block
// offsets its pointers to its own (M, P) rows, (M,) mask, n, k and (P,)
// output (n and k are (B,) device arrays) and then does exactly what a
// single-run block does, so row b is bit for bit the single-run kernel's
// result on run b.  The ballots read the block's own run's mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr long long kSpreadBlocks = 2 * 132;   // two blocks on each of the H100's 132 SMs
constexpr int kMaxM = 64;
constexpr int kRows = 8;             // rows a block of the rank loop

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 1.0f when a <= b, else 0.0f (0.0f when either is NaN): one FSET.BF
__device__ __forceinline__ float set_le(float a, float b) {
  float d;
  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename T, int MB>
__global__ void __launch_bounds__(kMaxThreads)
robust_trimmed_kernel(const T* __restrict__ upd, const float* __restrict__ mask,
                      const float* __restrict__ n_ptr, const float* __restrict__ k_ptr,
                      float* __restrict__ out, int m, long long p) {
  const long long run = blockIdx.y;            // 0 for a single run
  upd += run * m * p;
  mask += run * m;
  n_ptr += run;
  k_ptr += run;
  out += run * p;
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Participation bits, the same in every thread: lane l reads the mask of
  // rows l and l + 32, and two ballots gather them (no per-row mask load).
  const int lane = threadIdx.x & 31;
  const bool in_lo = lane < m && __ldg(mask + lane) > 0.5f;
  unsigned long long part = __ballot_sync(0xffffffffu, in_lo);
  if constexpr (MB > 32) {
    const bool in_hi = lane + 32 < m && __ldg(mask + lane + 32) > 0.5f;
    part |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, in_hi)) << 32;
  }
  if (col >= p) return;
  const float nan = __int_as_float(0x7fffffff);

  // Every load is issued before any is used: slots past M re-read row M - 1
  // (an L1 hit) instead of branching, then non-participants become NaN.
  float key[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) {
    key[r] = to_f32(upd[static_cast<long long>(min(r, m - 1)) * p + col]);
  }
#pragma unroll
  for (int r = 0; r < MB; ++r) key[r] = (part >> r) & 1ull ? key[r] : nan;

  float rank[MB];
  float later = 0.0f;                   // not-NaN rows after r
#pragma unroll
  for (int r = MB - 1; r >= 0; --r) {
    rank[r] = later;
    later += key[r] == key[r] ? 1.0f : 0.0f;
  }
  // Block ib's rows play a against themselves and against every later block
  // (b > a), so each unordered pair is met once.
  const int nb = (m + kRows - 1) / kRows;
#pragma unroll 1
  for (int ib = 0; ib < nb; ++ib) {
    float ka[kRows];
    float ra[kRows];
#pragma unroll
    for (int g = 0; g < MB / kRows; ++g) {
      if (g == ib) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) ka[i] = key[g * kRows + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) ra[i] = 0.0f;
#pragma unroll
    for (int b = 1; b < kRows; ++b) {
#pragma unroll
      for (int a = 0; a < b; ++a) {
        const float s = set_le(ka[a], ka[b]);   // 1: row a beats row b
        ra[b] += s;
        ra[a] -= s;
      }
    }
#pragma unroll
    for (int g = 1; g < MB / kRows; ++g) {
      if (g > ib && g < nb) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
#pragma unroll
          for (int a = 0; a < kRows; ++a) {
            const float s = set_le(ka[a], key[g * kRows + j]);
            rank[g * kRows + j] += s;
            ra[a] -= s;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MB / kRows; ++g) {
      if (g == ib) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) rank[g * kRows + i] += ra[i];
      }
    }
  }

  const float n = __ldg(n_ptr);
  const float k = fmaxf(__ldg(k_ptr), 0.0f);
  const float hi = __fsub_rn(n, k);
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < MB; ++r) {
    const float rf = key[r] == key[r] ? rank[r] : 0.0f;
    if (((part >> r) & 1ull) && rf >= k && rf < hi) acc = __fadd_rn(acc, key[r]);
  }
  out[col] = __fdiv_rn(acc, fmaxf(__fsub_rn(n, __fmul_rn(2.0f, k)), 1.0f));
}

template <typename T, int MB>
void run(const void* upd, const float* mask, const float* n, const float* k, float* out, int m,
         long long p, dim3 grid, int threads, cudaStream_t s) {
  robust_trimmed_kernel<T, MB><<<grid, threads, 0, s>>>(static_cast<const T*>(upd), mask, n, k,
                                                     out, m, p);
}

template <typename T>
int launch(const void* upd, const float* mask, const float* n, const float* k, float* out,
           int runs, int m, long long p, cudaStream_t s) {
  int threads = kMaxThreads;
  while (threads > kMinThreads && (p + threads - 1) / threads * runs < kSpreadBlocks) {
    threads /= 2;
  }
  const long long blocks = (p + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(runs));
  if (m <= 8) {
    run<T, 8>(upd, mask, n, k, out, m, p, grid, threads, s);
  } else if (m <= 16) {
    run<T, 16>(upd, mask, n, k, out, m, p, grid, threads, s);
  } else if (m <= 32) {
    run<T, 32>(upd, mask, n, k, out, m, p, grid, threads, s);
  } else {
    run<T, kMaxM>(upd, mask, n, k, out, m, p, grid, threads, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* upd, const float* mask, const float* n, const float* k, float* out,
             int runs, int m, long long p, int dtype, void* stream) {
  if (runs <= 0 || runs > 65535 || m <= 0 || m > kMaxM || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(upd, mask, n, k, out, runs, m, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(upd, mask, n, k, out, runs, m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  n, k: device pointers to one f32 each.
extern "C" int robust_trimmed_launch(const void* upd, const float* mask, const float* n,
                                     const float* k, float* out, int m, long long p, int dtype,
                                     void* stream) {
  return dispatch(upd, mask, n, k, out, 1, m, p, dtype, stream);
}

// A batch of `runs` runs (at most 65535): upd (runs, M, P), mask (runs, M),
// n and k (runs,) f32 on the device, out (runs, P), one launch.
extern "C" int robust_trimmed_batch_launch(const void* upd, const float* mask, const float* n,
                                           const float* k, float* out, int runs, int m,
                                           long long p, int dtype, void* stream) {
  return dispatch(upd, mask, n, k, out, runs, m, p, dtype, stream);
}
