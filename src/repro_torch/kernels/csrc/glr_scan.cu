// Recompute GLR detector for Hopper (sm_90a): the statistic of every
// channel from its raw (N, H) reward history.
//
// Replaces the Pallas TPU kernel `glr_scan` (src/repro/kernels/glr_scan.py,
// `_glr_kernel`).  Semantics of record: `repro_torch.kernels.ref.glr_scan`.
//
// Per row (one channel): the history masked to its first n = counts[row]
// samples, its inclusive prefix sum, and the sup over s = 1..n-1 of
//   s*kl(P_s/s, W/n) + (n-s)*kl((W-P_s)/(n-s), W/n)
// (W the window total), -inf where n < 2.  The split term is the one of
// `glr_kl.cuh`, shared with `glr_step.cu`, so on {0, 1} rewards the
// recompute and the streaming detector give the same bits.
//
// Layout: one thread block per row.  The prefix is a block-wide inclusive
// scan taken in chunks of blockDim samples with a carried offset: a warp
// scan by shuffles, the warp totals scanned by warp 0 through shared
// memory.  The window total is needed before any split can be tested, so
// the row is scanned twice: once for W, once for the statistics (the two
// scans add in the same order, so their prefixes agree bit for bit and W
// is the last prefix).  A warp-shuffle block max starting from -inf ends it.
// The scan adds in f64 and rounds each prefix (and W) to f32 once.  On
// {0, 1} rewards every prefix is an exact integer whatever the order of
// the adds, so the bits are those of an f32 scan; on real-valued ones a
// prefix is within about half an ulp of the exact sum, where an f32 scan
// in the block's order (not the plain version's sequential `cumsum`)
// drifted by several ulps, and the split term amplifies that drift.
//
// The scheduler service's tenant form (`glr_scan_tenants_launch`) runs the
// same row on the B named slots of its (R, N, H) history, in place: one
// block a (slot, channel) row, -inf where the slot's detect flag is off.
// Semantics of record: `ref.glr_scan_tenants`.  At the serving shape
// (B = 64, N = 16, H = 256) it reads at most 1 MB and evaluates some
// 2.6e5 splits (~8.4 MFLOP): a launch-bound call.
//
// What bounds it on the H100: at the paper's sizes (N = 5..30 rows,
// H = 256..1024) the history is 5-120 KB and the work some 40 flops per
// split; the launch is bound by launch latency.  At (1000, 1000) the
// ~4e7 flops take ~0.6 us of the card's f32 rate and the 4 MB ~1.2 us of
// its bandwidth.  The design keeps one launch per detection round and no
// padding of N or H (the TPU kernel padded rows to 8 and H to 128 lanes).
#include <cuda_runtime.h>

#include "glr_kl.cuh"

namespace {

constexpr int kMaxThreads = 256;

// inclusive scan of one value per thread across the block, in f64;
// `warp_tot` holds 32 doubles of shared memory.  Returns this thread's
// prefix and writes the block's total to *block_total (every thread).
__device__ __forceinline__ double block_inclusive_scan(double v, double* warp_tot,
                                                       double* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = __dadd_rn(v, up);
  }
  __syncthreads();  // warp_tot may still be read from the previous chunk
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < warps ? warp_tot[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = __dadd_rn(t, up);
    }
    if (lane < warps) warp_tot[lane] = t;  // inclusive scan of the warp totals
  }
  __syncthreads();
  *block_total = warp_tot[warps - 1];
  return warp > 0 ? __dadd_rn(v, warp_tot[warp - 1]) : v;
}

// The statistic of one channel row `x` of `h` samples, of which the first
// `n` count; every thread of the block gets it.
__device__ __forceinline__ float row_stat(const float* __restrict__ x, int n, int h,
                                          double* warp_tot, float* warp_best) {
  const float n_f = static_cast<float>(n);

  // pass 1: the window total W (the carry after the last chunk)
  double carry = 0.0;
  for (int c0 = 0; c0 < h; c0 += blockDim.x) {
    const int idx = c0 + threadIdx.x;
    double chunk_total;
    block_inclusive_scan((idx < h && idx < n) ? x[idx] : 0.0f, warp_tot, &chunk_total);
    carry = __dadd_rn(carry, chunk_total);
  }
  const float W = __double2float_rn(carry);
  const float mu_all = glr::window_mean(W, n_f);

  // pass 2: the same scan again, each prefix tested as a split
  float best = -__int_as_float(0x7f800000);  // -inf
  carry = 0.0;
  for (int c0 = 0; c0 < h; c0 += blockDim.x) {
    const int idx = c0 + threadIdx.x;
    double chunk_total;
    const double pre = block_inclusive_scan((idx < h && idx < n) ? x[idx] : 0.0f, warp_tot,
                                            &chunk_total);
    const float P = __double2float_rn(__dadd_rn(carry, pre));
    carry = __dadd_rn(carry, chunk_total);
    const int s = idx + 1;
    if (idx < h && s <= n - 1) {
      best = fmaxf(best, glr::split_stat(P, W, static_cast<float>(s), n_f, mu_all));
    }
  }
  return glr::block_max(best, warp_best);
}

__global__ void glr_scan_kernel(const float* __restrict__ hist, const int* __restrict__ counts,
                                float* __restrict__ stat_out, int h) {
  __shared__ double warp_tot[32];
  __shared__ float warp_best[32];
  const int row = blockIdx.x;
  const float m = row_stat(hist + static_cast<size_t>(row) * h, counts[row], h, warp_tot,
                           warp_best);
  if (threadIdx.x == 0) stat_out[row] = m;
}

// The scheduler service's form: block b * N + c takes channel c of the
// history of slot slots[b], read in place from the (R, N, H) slot tensor.
// A row whose detect flag is off writes -inf and reads nothing (the whole
// block leaves before the first barrier).
__global__ void glr_scan_tenants_kernel(const float* __restrict__ hist,
                                        const int* __restrict__ slots,
                                        const bool* __restrict__ detect,
                                        const int* __restrict__ counts,
                                        float* __restrict__ stat_out, int n_chan, int h) {
  __shared__ double warp_tot[32];
  __shared__ float warp_best[32];
  const int row = blockIdx.x;
  const int b = row / n_chan, c = row - b * n_chan;
  if (!detect[b]) {
    if (threadIdx.x == 0) stat_out[row] = -__int_as_float(0x7f800000);
    return;
  }
  const float* x = hist + (static_cast<size_t>(slots[b]) * n_chan + c) * h;
  const float m = row_stat(x, counts[row], h, warp_tot, warp_best);
  if (threadIdx.x == 0) stat_out[row] = m;
}

}  // namespace

extern "C" int glr_scan_launch(const float* hist, const int* counts, float* stat_out, int rows,
                               int h, void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((h + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  glr_scan_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(hist, counts, stat_out, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glr_scan_tenants_launch(const float* hist, const int* slots, const bool* detect,
                                       const int* counts, float* stat_out, int b, int n_chan,
                                       int h, void* stream) {
  if (b <= 0 || n_chan <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((h + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  glr_scan_tenants_kernel<<<b * n_chan, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, slots, detect, counts, stat_out, n_chan, h);
  return static_cast<int>(cudaGetLastError());
}
