// Fused streaming GLR detector step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `glr_step` (src/repro/kernels/glr_step.py,
// `_glr_step_math`); the scheduler service's tenant form, in place on its
// slot state, is glr_step_tenants.cu.  Semantics of record:
// `repro_torch.kernels.ref.glr_step`.
//
// Per row (one channel of one tenant) of the (R, H) prefix ring:
//   1. masked append at slot w = counts mod H: the evicted cum[w] becomes
//      `base` once the ring is full, `total += r`, cum[w] = total;
//   2. the sup over split positions s_j = n - ((w2 - j) mod H) of the
//      two-sided Bernoulli-KL GLR statistic, read straight from the carried
//      prefixes (P = cum - base, W = total - base); -inf where no split is
//      valid (n < 2).  GEOM keeps only splits where s or n - s is a power
//      of two, as the Pallas kernel masks its dense pass.
//
// Layout: one thread block per row, threads stride over the H slots, a
// warp-shuffle + shared-memory max reduction gives the row's statistic.
// A leading tenant axis (G, N, H) is just G*N rows, so one launch serves
// every tenant.  Input and output rings are distinct buffers, so the
// append has no read/write race: every thread reads the old cum[w] from
// the input and writes slot w of the output as total2 on scheduled rows.
//
// What bounds it on the H100: at the paper's sizes (N = 5..30 rows,
// H = 256..1024) the ring is 5-120 KB, i.e. about 2*R*H*4 bytes of traffic
// that the card moves in well under a microsecond; the launch is bound by
// launch latency, not by bytes or by the ~30 flops per slot.  The design
// keeps it to a single launch per detection round (append + test fused).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "glr_kl.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

__device__ __forceinline__ int pos_mod(int x, int h) { return ((x % h) + h) % h; }

template <bool GEOM>
__global__ void glr_step_kernel(const float* __restrict__ cum, const float* __restrict__ total,
                                const float* __restrict__ base, const int* __restrict__ counts,
                                const float* __restrict__ r_vec, const bool* __restrict__ sched,
                                float* __restrict__ cum_out, float* __restrict__ total_out,
                                float* __restrict__ base_out, float* __restrict__ stat_out, int h) {
  const int row = blockIdx.x;
  const float* c_in = cum + static_cast<size_t>(row) * h;
  float* c_out = cum_out + static_cast<size_t>(row) * h;

  // append (every thread derives the row scalars; they broadcast from L1)
  const int cnt = counts[row];
  const bool sch = sched[row];
  const int w = pos_mod(cnt, h);
  const float evict = c_in[w];
  const float base2 = (sch && cnt >= h) ? evict : base[row];
  const float total2 = sch ? total[row] + r_vec[row] : total[row];

  // statistic over the post-append window
  const int c2 = cnt + (sch ? 1 : 0);
  const int n = min(c2, h);
  const int w2 = pos_mod(c2 - 1, h);
  const float n_f = static_cast<float>(n);
  const float W = total2 - base2;
  const float mu_all = glr::window_mean(W, n_f);

  float best = -CUDART_INF_F;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float cj = (sch && j == w) ? total2 : c_in[j];
    c_out[j] = cj;
    const int s = n - pos_mod(w2 - j, h);
    bool valid = s >= 1 && s <= n - 1;
    if (GEOM) valid = valid && (is_pow2(s) || is_pow2(n - s));
    if (valid) {
      best = fmaxf(best, glr::split_stat(__fsub_rn(cj, base2), W, static_cast<float>(s), n_f, mu_all));
    }
  }

  // block max: warp shuffles, then one value per warp through shared memory
  __shared__ float warp_best[32];
  const float m = glr::block_max(best, warp_best);
  if (threadIdx.x == 0) {
    total_out[row] = total2;
    base_out[row] = base2;
    stat_out[row] = m;
  }
}

}  // namespace

extern "C" int glr_step_launch(const float* cum, const float* total, const float* base,
                               const int* counts, const float* r_vec, const bool* sched,
                               float* cum_out, float* total_out, float* base_out, float* stat_out,
                               int rows, int h, int geometric, void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((h + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geometric) {
    glr_step_kernel<true><<<rows, threads, 0, s>>>(cum, total, base, counts, r_vec, sched, cum_out,
                                                   total_out, base_out, stat_out, h);
  } else {
    glr_step_kernel<false><<<rows, threads, 0, s>>>(cum, total, base, counts, r_vec, sched, cum_out,
                                                    total_out, base_out, stat_out, h);
  }
  return static_cast<int>(cudaGetLastError());
}
