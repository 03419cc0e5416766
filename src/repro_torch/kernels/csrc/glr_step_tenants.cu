// The streaming GLR detector step of the scheduler service, over the
// tenant slots, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `glr_step_tenants`
// (src/repro/kernels/glr_step.py:183, `pallas_call` at :210, the math of
// `_glr_step_math`).  Semantics of record:
// `repro_torch.kernels.ref.glr_step_tenants`.
//
// The server keeps every tenant's detector state in slot tensors: the
// prefix rings cum (R, N, H) and the totals total/base (R, N).  A serve
// step names B slots; for the live ones (`live[b]`), per channel c:
//   1. masked append at ring position w = counts[b, c] mod H: the evicted
//      cum[slot, c, w] becomes `base` once the ring is full, `total += r`,
//      and cum[slot, c, w] = total.  The state is updated IN PLACE, one
//      float of the ring a scheduled channel; total/base change only on
//      scheduled channels.  A row that is not live is never touched, and
//      live slots are unique (the server defers a tenant's second request
//      to the next step), so no two warps write one row;
//   2. on a detection row (`detect[b]`, which implies live), the sup over
//      split positions of the two-sided Bernoulli-KL GLR statistic over the
//      post-append window, read straight from the prefixes; -inf where no
//      split is valid (n < 2), on rows that do not detect and on rows that
//      are not live.  GEOM keeps only splits where s or n - s is a power of
//      two, as the Pallas kernel masks its dense pass.
// The split term is `glr::split_stat` of glr_kl.cuh, every operation
// rounded on its own, so a served tenant's statistics equal, bit for bit,
// those of glr_step.cu and regret_scan.cu on the same prefixes.
//
// What bounds it on the H100.  The JAX step gathers the tenants' rings,
// runs the functional kernel on copies and scatters them back: about six
// ring-sized transfers a step, and a statistic on every row.  Here a ring
// is read only on its tenant's detection round (with detector_stride = 5
// about one live row in five), once, and one float is written: the bytes
// are (detecting rows x N x H x 4) + live rows x N x 17.  At the full
// window every detecting row evaluates ~H splits of four logf and six
// correctly rounded divisions each, so on rows that detect, instruction
// issue (the special-function unit among it), not bytes, sets the floor.
// The design: one warp per (tenant, channel) row, several rows a block so
// the grid spreads over the 132 SMs; 16-byte loads where H % 4 == 0 and
// the ring is 16-byte aligned (scalar loads otherwise), a lane's loads of
// a chunk all issued before any is used; the row max by warp shuffles (no
// shared memory, no barrier); no integer remainder per slot: w2 - j lies
// in (-H, H), so the split position is one compare and one add.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "glr_kl.cuh"

namespace {

constexpr int kMaxWarps = 8;       // rows (warps) a block at most
constexpr int kLoads = 4;          // loads a lane issues together (float4 or float)
constexpr int kSpreadRows = 2 * 132;   // rows at which a block takes a second warp
constexpr int kMinBlocks = 4;      // full blocks resident on an SM: at most 64 registers a thread

__device__ __forceinline__ bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

__device__ __forceinline__ int pos_mod(int x, int h) { return ((x % h) + h) % h; }

// one ring position j holding prefix cj: fold its split into the running max
template <bool GEOM>
__device__ __forceinline__ void fold(float& best, int j, float cj, bool sch, int w, float total2,
                                     float base2, int w2, int h, int n, float W, float n_f,
                                     float mu_all) {
  if (sch && j == w) cj = total2;              // the appended sample
  int d = w2 - j;                              // in (-h, h)
  d += d < 0 ? h : 0;
  const int s = n - d;
  bool valid = s >= 1 && s <= n - 1;
  if (GEOM) valid = valid && (is_pow2(s) || is_pow2(n - s));
  if (valid) {
    best = fmaxf(best, glr::split_stat(__fsub_rn(cj, base2), W, static_cast<float>(s), n_f, mu_all));
  }
}

template <bool GEOM, int VEC>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    glr_step_tenants_kernel(float* __restrict__ cum, float* __restrict__ total,
                            float* __restrict__ base, const int* __restrict__ slots,
                            const bool* __restrict__ live, const bool* __restrict__ detect,
                            const int* __restrict__ counts, const float* __restrict__ r_vec,
                            const bool* __restrict__ sched, float* __restrict__ stats, int rows,
                            int n_chan, int n_slots, int h) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);   // b * N + c
  if (row >= rows) return;
  const int b = row / n_chan;
  const int slot = slots[b];
  if (!live[b] || slot < 0 || slot >= n_slots) {
    if (lane == 0) stats[row] = -CUDART_INF_F;
    return;
  }
  const size_t srow = static_cast<size_t>(slot) * n_chan + (row - b * n_chan);
  float* ring = cum + srow * h;
  const int cnt = counts[row];
  const bool sch = sched[row];
  const int w = pos_mod(cnt, h);

  if (!detect[b]) {                            // the append alone, by one lane
    if (lane == 0) {
      stats[row] = -CUDART_INF_F;
      if (sch) {
        const float total2 = __fadd_rn(total[srow], r_vec[row]);
        if (cnt >= h) base[srow] = ring[w];
        ring[w] = total2;
        total[srow] = total2;
      }
    }
    return;
  }

  const float tot = total[srow], bas = base[srow];
  const float evict = ring[w];
  const float base2 = (sch && cnt >= h) ? evict : bas;
  const float total2 = sch ? __fadd_rn(tot, r_vec[row]) : tot;
  const int c2 = cnt + (sch ? 1 : 0);
  const int n = min(c2, h);
  const int w2 = pos_mod(c2 - 1, h);
  const float n_f = static_cast<float>(n);
  const float W = __fsub_rn(total2, base2);
  const float mu_all = glr::window_mean(W, n_f);

  float best = -CUDART_INF_F;
  if (VEC == 4) {
    const float4* ring4 = reinterpret_cast<const float4*>(ring);
    const int nvec = h >> 2;
    for (int i0 = 0; i0 < nvec; i0 += 32 * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + 32 * k + lane;
        v[k] = i < nvec ? ring4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + 32 * k + lane;
        if (i < nvec) {
          const int j = 4 * i;
          fold<GEOM>(best, j, v[k].x, sch, w, total2, base2, w2, h, n, W, n_f, mu_all);
          fold<GEOM>(best, j + 1, v[k].y, sch, w, total2, base2, w2, h, n, W, n_f, mu_all);
          fold<GEOM>(best, j + 2, v[k].z, sch, w, total2, base2, w2, h, n, W, n_f, mu_all);
          fold<GEOM>(best, j + 3, v[k].w, sch, w, total2, base2, w2, h, n, W, n_f, mu_all);
        }
      }
    }
  } else {
    for (int j0 = 0; j0 < h; j0 += 32 * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int j = j0 + 32 * k + lane;
        v[k] = j < h ? ring[j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int j = j0 + 32 * k + lane;
        if (j < h) fold<GEOM>(best, j, v[k], sch, w, total2, base2, w2, h, n, W, n_f, mu_all);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  __syncwarp();   // every lane's read of ring[w] is done before lane 0 writes it
  if (lane == 0) {
    stats[row] = best;
    if (sch) {
      ring[w] = total2;
      total[srow] = total2;
      base[srow] = base2;
    }
  }
}

template <bool GEOM, int VEC>
void launch(int blocks, int threads, cudaStream_t s, float* cum, float* total, float* base,
            const int* slots, const bool* live, const bool* detect, const int* counts,
            const float* r_vec, const bool* sched, float* stats, int rows, int n_chan, int n_slots,
            int h) {
  glr_step_tenants_kernel<GEOM, VEC><<<blocks, threads, 0, s>>>(
      cum, total, base, slots, live, detect, counts, r_vec, sched, stats, rows, n_chan, n_slots, h);
}

}  // namespace

// b rows of n_chan channels over n_slots slots of an (n_slots, n_chan, h)
// ring.  Returns cudaGetLastError() after the launch.
extern "C" int glr_step_tenants_launch(float* cum, float* total, float* base, const int* slots,
                                       const bool* live, const bool* detect, const int* counts,
                                       const float* r_vec, const bool* sched, float* stats, int b,
                                       int n_chan, int n_slots, int h, int geometric,
                                       void* stream) {
  if (b <= 0 || n_chan <= 0 || n_slots <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(b) * n_chan;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  long long warps = (rows + kSpreadRows - 1) / kSpreadRows;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int threads = static_cast<int>(32 * warps);
  const int blocks = static_cast<int>((rows + warps - 1) / warps);
  const bool vec4 = h % 4 == 0 && reinterpret_cast<uintptr_t>(cum) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  if (geometric) {
    if (vec4) launch<true, 4>(blocks, threads, s, cum, total, base, slots, live, detect, counts, r_vec, sched, stats, r, n_chan, n_slots, h);
    else launch<true, 1>(blocks, threads, s, cum, total, base, slots, live, detect, counts, r_vec, sched, stats, r, n_chan, n_slots, h);
  } else {
    if (vec4) launch<false, 4>(blocks, threads, s, cum, total, base, slots, live, detect, counts, r_vec, sched, stats, r, n_chan, n_slots, h);
    else launch<false, 1>(blocks, threads, s, cum, total, base, slots, live, detect, counts, r_vec, sched, stats, r, n_chan, n_slots, h);
  }
  return static_cast<int>(cudaGetLastError());
}
