// GLR-CUCB's Fig. 2 AoI-regret harness for Hopper (sm_90a): every round of
// a batch of runs in one launch, one thread block a run.
//
// Replaces, on this path, the Pallas TPU kernels `glr_step`
// (src/repro/kernels/glr_step.py:163) and `glr_scan`
// (src/repro/kernels/glr_scan.py:70) inside the JAX harness's `lax.scan`
// over the horizon (src/repro/core/regret.py:118), and the per-round work
// around them: the channel draw, GLR-CUCB's Eq.-30 selection, forced
// exploration and rotation, the mean/count update, the detector and the
// restart, the policy's and the oracle's AoI, and the regret, variance and
// success sums.  Semantics of record: the per-round loop
// `repro_torch.core.regret._simulate_rounds` (GLR-CUCB's `select`/`update`,
// `oracle_assign`, `update_aoi`, `aoi_variance`), which is this kernel's
// plain version.
//
// The run axis.  Block b runs run b of B: it reads its run's env (segment
// means and breaks, or its table), uniforms, hyper-parameters and initial
// state at its own offset, and writes its own outputs.  An operand the runs
// share (one env, one uniform stream, one hyper-parameter set, the initial
// state) has stride 0: every block reads the same copy and none writes it.
// The JAX engine's counterpart is `vmap` over the run axis, which lowers
// GLR-CUCB's detector to one `glr_step_tenants` launch over the batch
// (src/repro/kernels/glr_step.py:230-254).  The blocks never talk: B runs
// take ceil(B / blocks in flight) times one run's chain.
//
// Layout.  The (N, H) f32 ring lives in shared memory for the whole
// horizon: the carried prefix sums `cum` (streaming detector) or the reward
// history (recompute detector, kept as a ring with a per-row head so that
// "shift left when full" costs O(1) a round; unrolled to the chronological
// layout at write-back).  Warp 0 runs every round, lane i owning channel i
// and client i: the channel's mean, count, total and base, the client's two
// AoIs, and tau, restarts and the running sums, all in registers; the two
// stable ranks (the selection's top-M, the oracle's most-starved clients)
// compare each lane's value with the others' through shared memory.  Warp 0
// needs no block barrier on a round without detection.  On a detection
// round (t % stride == 0) it publishes the M scheduled rows' window
// parameters, and the whole block evaluates their split statistics
// (`glr::split_stat` of glr_kl.cuh, the term of glr_step.cu and
// glr_scan.cu): streaming reads the carried prefixes; recompute first
// rebuilds each row's chronological prefix by a block scan (chunk sums,
// their scan, then a warp scan per chunk).  A row's maximum is gathered
// with an order-preserving integer atomic max in shared memory; warp 0 then
// applies the threshold and restarts.  Round t+1's uniforms (and table row)
// are loaded while round t computes; the schedule row and the curves are
// plain stores, never read back.
//
// Same bits as the per-round route on the card: every expression is
// rounded op by op in the order torch evaluates it (`__fmul_rn`,
// `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`, `logf`; no contraction to FMA,
// no fast math).  torch's `1.0 / x` is `reciprocal(x) * 1.0`; its CUDA
// `mean` is `sum * (1 / M)`.  Channel states are {0, 1}, so every count,
// prefix, AoI and per-round sum is an exact integer in f32 (while below
// 2^24), and the order of those sums does not matter; the variance's sum of
// squared deviations is taken in warp-butterfly order (equal for M <= 2,
// otherwise within a few ulps of torch's reduction).  A restart zeroes mu,
// counts, total and base of every channel, sets tau = t and leaves the
// streaming ring's stale slots in place (as `GLRCUCB.update` does); the
// recompute history's zeroing is applied at write-back: after a restart in
// this launch, positions at or past a row's window are written as 0.
//
// Roofline for one Fig. 2 run (N = 5, M = 2, H = 1024, stride 5,
// T = 20000) on the H100: operations, 4000 detection rounds x 2 rows x
// 1024 splits x 32 flops = 2.6e8 at 67 TFLOP/s = 3.9 us at most (the
// smoke counts the splits a run really evaluates); bytes, the (T, 2, N)
// uniforms, the (T, M) int64 schedule, two (T,) curves and the state once
// in and once out, about 1.3 MB at 3.35 TB/s = 0.4 us.  Neither bounds it:
// each round depends on the one before (the selection reads the counts,
// the detector the ring), so a run is a chain of ~20000 warp-latency-bound
// steps on one SM: one warp issues them, and a detection round's splits
// are spread over the block's 32 warps.  What fills the card is more runs,
// one block each (envs x seeds x hyper-parameters of the batched engine):
// `__launch_bounds__(kThreads, 1)` and the ring's shared memory set how
// many blocks an SM holds (`regret_scan_occupancy` asks the runtime).
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "glr_kl.cuh"

namespace {

constexpr int kThreads = 1024;  // 32 warps share a detection round's splits
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  // the initial GLRCUCBState (ring: `cum` streaming, `hist` recompute) and hp;
  // each operand is the run's at its offset, or shared (stride 0)
  const float* mu0;
  const float* counts0;
  const int* tau0;
  const float* ring0;
  const int* restarts0;
  const float* total0;
  const float* base0;
  const float* gamma;
  const float* delta;
  const float* min_samples;
  // the env: segment means (S, N) and breaks (S-1,), or the table (T_tab, N)
  const float* means;
  const long long* breaks;
  const float* table;
  const float* u;  // (T, 2, N) a run: [t][0] the channel draw, [t][1] the policy's
  // outputs, one set a run
  long long* schedule;  // (T, M)
  float* regret_curve;  // (T,) or null
  float* var_curve;     // (T,) or null
  float* scalars;       // cum regret, cum policy variance, cum oracle variance, successes
  float* aoi_pi;
  float* aoi_star;
  float* mu_out;
  float* counts_out;
  int* tau_out;
  float* ring_out;
  int* restarts_out;
  float* total_out;
  float* base_out;
  unsigned long long* splits;  // GLR splits evaluated in the run
  int T, N, M, H, n_seg, stride, period;
  int T_tab;                              // table rows a run
  int state_b, env_b, u_b, hp_b;          // 1: the operand has a run axis; 0: shared
};

// a detection round's scheduled rows, published by warp 0
struct Rows {
  int ch[32];         // the row's channel
  int n[32];          // window length
  int pos[32];        // streaming: newest ring slot; recompute: the ring's head
  float base[32];     // streaming: prefix just before the window
  float W[32];        // window total
  float mu[32];       // window mean
  unsigned best[32];  // the row's max statistic, as order-preserving bits
};

__device__ __forceinline__ bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// float -> unsigned whose integer order is the float order (-0 < +0)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = __fadd_rn(v, up);
  }
  return v;
}

// beta(n, delta) = (1 + 1/n) log(3 n sqrt(n) / delta), as glr_threshold
// evaluates it; nf = max(n, 1)
__device__ __forceinline__ float glr_threshold(float nf, float delta) {
  const float lead = __fadd_rn(1.0f, __fdiv_rn(1.0f, nf));
  return __fmul_rn(lead, logf(__fdiv_rn(__fmul_rn(__fmul_rn(3.0f, nf), __fsqrt_rn(nf)), delta)));
}

template <bool RECOMPUTE, bool GEOM, bool TABLE>
__global__ void __launch_bounds__(kThreads, 1) regret_scan_kernel(const Args a) {
  // this block's run, and the offsets of its operands (0 where shared)
  const size_t run = blockIdx.x;
  const size_t rs = a.state_b ? run : 0, re = a.env_b ? run : 0;
  const size_t ru = a.u_b ? run : 0, rh = a.hp_b ? run : 0;
  extern __shared__ float ring[];  // (N, H), then (recompute) the chunk sums and prefixes
  __shared__ Rows rows;
  __shared__ float keys_s[32];  // the round's selection keys, then the oracle's AoIs
  __shared__ int top_s[32];
  __shared__ int head_s[32];
  __shared__ int window_s[32];
  __shared__ int restarted_s;
  __shared__ unsigned long long split_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M, H = a.H, T = a.T;
  const int C = (H + 31) / 32;  // 32-slot chunks of a row
  const size_t NH = static_cast<size_t>(N) * H;
  float* csum = ring + NH;                            // (M, C) chunk sums (recompute)
  float* cpre = csum + static_cast<size_t>(M) * C;    // (M, C) their exclusive prefixes
  const float* u = a.u + ru * T * 2 * N;
  const float* table = TABLE ? a.table + re * a.T_tab * N : nullptr;
  const float* means = TABLE ? nullptr : a.means + re * a.n_seg * N;
  const long long* breaks = TABLE ? nullptr : a.breaks + re * (a.n_seg - 1);
  long long* schedule = a.schedule + run * T * M;
  float* regret_curve = a.regret_curve != nullptr ? a.regret_curve + run * T : nullptr;
  float* var_curve = a.var_curve != nullptr ? a.var_curve + run * T : nullptr;

  for (size_t k = tid; k < NH; k += kThreads) ring[k] = a.ring0[rs * NH + k];
  if (tid == 0) split_total = 0ull;

  // warp 0's state: lane i owns channel i (i < N) and client i (i < M)
  const bool ch_lane = lane < N, cl_lane = lane < M;
  float mu = 0.0f, cnt = 0.0f, total = 0.0f, base = 0.0f;
  int head = 0;   // recompute: the ring's chronological start
  int wslot = 0;  // streaming: the ring slot of the next append, counts mod H
  float aoi_pi = 1.0f, aoi_star = 1.0f;  // init_aoi
  int tau = 0, restarts = 0;
  bool restarted = false;
  float cum_regret = 0.0f, cum_var_pi = 0.0f, cum_var_star = 0.0f, successes = 0.0f;
  float gamma = 0.0f, delta = 0.0f, min_samples = 0.0f;
  int seg = 0;
  long long next_break = LLONG_MAX;
  float mu_seg = 0.0f, ue = 0.0f, us = 0.0f, tmu = 0.0f;
  if (warp == 0) {
    if (ch_lane) {
      mu = a.mu0[rs * N + lane];
      cnt = a.counts0[rs * N + lane];
      total = a.total0[rs * N + lane];
      base = a.base0[rs * N + lane];
      wslot = static_cast<int>(cnt) % H;
    }
    tau = a.tau0[rs];
    restarts = a.restarts0[rs];
    gamma = a.gamma[rh];
    delta = a.delta[rh];
    min_samples = a.min_samples[rh];
    if (!TABLE) {
      if (a.n_seg > 1) next_break = breaks[0];
      if (ch_lane) mu_seg = means[lane];
    }
    if (T > 0 && ch_lane) {
      ue = u[lane];
      us = u[N + lane];
      if (TABLE) tmu = table[lane];
    }
  }
  // delta = +inf makes every threshold -inf, so a scheduled row fires on
  // -inf statistics too, as the per-round route's comparison does
  const bool delta_inf = isinf(delta) && delta > 0.0f;
  const float inv_m = __fdiv_rn(1.0f, static_cast<float>(M));  // torch's CUDA mean: sum * (1/M)
  unsigned long long my_splits = 0ull;
  int detect_in = 0;  // rounds to the next detection round: t mod stride == 0
  int t_mod_m = 0;    // t mod M
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const bool detect = detect_in == 0;
    detect_in = detect ? a.stride - 1 : detect_in - 1;
    // warp 0's values of this round, carried across the detection barrier
    int row = -1, ch = 0;
    float rw = 0.0f;
    bool good = false;

    if (warp == 0) {
      // round t+1's inputs, in flight while round t computes
      float ue_n = 0.0f, us_n = 0.0f, tmu_n = 0.0f;
      if (t + 1 < T && ch_lane) {
        const float* un = u + static_cast<size_t>(t + 1) * 2 * N;
        ue_n = un[lane];
        us_n = un[N + lane];
        if (TABLE) tmu_n = table[static_cast<size_t>(t + 1) * N + lane];
      }

      // the channel states: u < mu(t); segments: searchsorted(breaks, t, right=True)
      float mu_env;
      if (TABLE) {
        mu_env = tmu;
      } else {
        while (static_cast<long long>(t) >= next_break) {
          ++seg;
          next_break = seg < a.n_seg - 1 ? breaks[seg] : LLONG_MAX;
          if (ch_lane) mu_seg = means[static_cast<size_t>(seg) * N + lane];
        }
        mu_env = mu_seg;
      }
      good = ch_lane && ue < mu_env;
      const float st = good ? 1.0f : 0.0f;

      // Eq. 30 UCB and the selection key (GLRCUCB.ucb / select), op by op
      const float since = fmaxf(__int2float_rn(t - tau), 2.0f);
      const float bonus = __fsqrt_rn(__fdiv_rn(__fmul_rn(logf(since), 3.0f),
                                               __fmul_rn(fmaxf(cnt, 1.0f), 2.0f)));
      const float ucb = cnt > 0.0f ? __fadd_rn(mu, __fmul_rn(gamma, bonus)) : CUDART_INF_F;
      const float noise = cnt == 0.0f ? __fmul_rn(us, 1e6f) : 0.0f;
      float key = __fadd_rn(isinf(ucb) ? 1e9f : ucb, noise);
      if (!ch_lane) key = -CUDART_INF_F;

      // top-M: the stable descending rank, argsort(-key, stable=True), over
      // the N keys broadcast through shared memory (the loads pipeline; a
      // chain of 32 shuffles took longer than the rest of the round)
      __syncwarp();  // last round's readers of keys_s and top_s are done
      keys_s[lane] = key;
      __syncwarp();
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const float kj = keys_s[j];
        rank += (kj > key || (kj == key && j < lane)) ? 1 : 0;
      }
      if (ch_lane && rank < M) top_s[rank] = lane;
      __syncwarp();

      // forced exploration: channel (t - tau) mod period takes the last slot
      int slot = -1;
      bool replace = false;
      if (a.period > 0) {
        slot = (t - tau) % a.period;
        const int rank_slot = __shfl_sync(kFull, rank, slot & 31);
        replace = slot < N && rank_slot >= M;
      }
      // rotate_assignment: client j takes top[(j + t) mod M]
      if (cl_lane) {
        const int k = lane + t_mod_m < M ? lane + t_mod_m : lane + t_mod_m - M;
        ch = (replace && k == M - 1) ? slot : top_s[k];
      }
      t_mod_m = t_mod_m + 1 == M ? 0 : t_mod_m + 1;
      rw = __shfl_sync(kFull, st, ch);
      if (ch_lane) {
        if (replace && lane == slot) row = M - 1;
        else if (rank < M && !(replace && rank == M - 1)) row = rank;
      }
      const bool sched = row >= 0;
      const float r = sched ? st : 0.0f;

      // mean / count update and the detector's append
      if (sched) {
        const float d_prev = cnt;
        mu = __fdiv_rn(__fadd_rn(__fmul_rn(mu, d_prev), r), __fadd_rn(d_prev, 1.0f));
        cnt = __fadd_rn(d_prev, 1.0f);
        const int c_prev = static_cast<int>(d_prev);
        float* row_ring = ring + static_cast<size_t>(lane) * H;
        const int newest = wslot;
        if (!RECOMPUTE) {           // ref.glr_stream_append
          const float evict = row_ring[wslot];
          if (c_prev >= H) base = evict;
          total = __fadd_rn(total, r);
          row_ring[wslot] = total;
          wslot = wslot + 1 == H ? 0 : wslot + 1;
        } else if (c_prev >= H) {   // full: shift left, i.e. overwrite the oldest
          row_ring[head] = r;
          head = head + 1 == H ? 0 : head + 1;
        } else {
          const int p = head + c_prev;
          row_ring[p >= H ? p - H : p] = r;
        }
        if (detect) {
          const int n = min(static_cast<int>(cnt), H);
          rows.ch[row] = lane;
          rows.n[row] = n;
          rows.best[row] = order_key(-CUDART_INF_F);
          if (!RECOMPUTE) {
            const float W = __fsub_rn(total, base);
            rows.pos[row] = newest;
            rows.base[row] = base;
            rows.W[row] = W;
            rows.mu[row] = glr::window_mean(W, static_cast<float>(n));
          } else {
            rows.pos[row] = head;
          }
        }
      }
      ue = ue_n;
      us = us_n;
      tmu = tmu_n;
    }

    if (detect) {
      __syncthreads();
      const int items = M * C;  // (row, 32-slot chunk) pairs, one warp each
      if (!RECOMPUTE) {
        for (int it = warp; it < items; it += kWarps) {
          const int r = it / C, j = (it - r * C) * 32 + lane, n = rows.n[r];
          float best = -CUDART_INF_F;
          if (j < H) {
            int d = rows.pos[r] - j;
            if (d < 0) d += H;
            const int s = n - d;
            bool valid = s >= 1 && s <= n - 1;
            if (GEOM) valid = valid && (is_pow2(s) || is_pow2(n - s));
            if (valid) {
              const float P = __fsub_rn(ring[static_cast<size_t>(rows.ch[r]) * H + j], rows.base[r]);
              best = glr::split_stat(P, rows.W[r], static_cast<float>(s), static_cast<float>(n),
                                     rows.mu[r]);
              ++my_splits;
            }
          }
          best = warp_max(best);
          if (lane == 0) atomicMax(&rows.best[r], order_key(best));
        }
      } else {
        // the chronological window x_k = ring[(head + k) mod H], k < n
        auto sample = [&](int r, int k) -> float {
          if (k >= rows.n[r]) return 0.0f;
          const int p = rows.pos[r] + k;
          return ring[static_cast<size_t>(rows.ch[r]) * H + (p >= H ? p - H : p)];
        };
        for (int it = warp; it < items; it += kWarps) {
          const int r = it / C;
          const float s = warp_sum(sample(r, (it - r * C) * 32 + lane));
          if (lane == 0) csum[it] = s;
        }
        __syncthreads();
        for (int r = warp; r < M; r += kWarps) {
          float carry = 0.0f;
          for (int c0 = 0; c0 < C; c0 += 32) {
            const int c = c0 + lane;
            const float v = c < C ? csum[r * C + c] : 0.0f;
            const float incl = warp_inclusive_scan(v, lane);
            const float excl = __shfl_up_sync(kFull, incl, 1);
            if (c < C) cpre[r * C + c] = __fadd_rn(carry, lane > 0 ? excl : 0.0f);
            carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
          }
          if (lane == 0) {
            rows.W[r] = carry;
            rows.mu[r] = glr::window_mean(carry, static_cast<float>(rows.n[r]));
          }
        }
        __syncthreads();
        for (int it = warp; it < items; it += kWarps) {
          const int r = it / C, k = (it - r * C) * 32 + lane, n = rows.n[r];
          const float P = __fadd_rn(cpre[it], warp_inclusive_scan(sample(r, k), lane));
          float best = -CUDART_INF_F;
          const int s = k + 1;
          if (k < H && s <= n - 1) {
            best = glr::split_stat(P, rows.W[r], static_cast<float>(s), static_cast<float>(n),
                                   rows.mu[r]);
            ++my_splits;
          }
          best = warp_max(best);
          if (lane == 0) atomicMax(&rows.best[r], order_key(best));
        }
      }
      __syncthreads();
    }

    if (warp == 0) {
      // GLRCUCB._fire and the restart (Alg. 2 line 21)
      bool fire = false;
      if (row >= 0) {
        const int nv = static_cast<int>(fminf(cnt, static_cast<float>(H)));
        if (detect) {
          const float stat = from_order_key(rows.best[row]);
          const float nf = fmaxf(static_cast<float>(nv), 1.0f);
          fire = stat >= glr_threshold(nf, delta) && static_cast<float>(nv) >= min_samples;
        } else if (delta_inf) {
          fire = static_cast<float>(nv) >= min_samples;
        }
      }
      if (__any_sync(kFull, fire)) {
        mu = cnt = total = base = 0.0f;
        wslot = 0;
        tau = t;
        ++restarts;
        restarted = true;
      }

      // the policy's AoI (Eq. 8)
      if (cl_lane) aoi_pi = rw > 0.5f ? 1.0f : __fadd_rn(aoi_pi, 1.0f);
      // the oracle: the G Good channels go to the G most-starved clients
      // (stable descending rank of aoi_star)
      const int n_good = __popc(__ballot_sync(kFull, good));
      keys_s[lane] = aoi_star;  // after the __syncwarp of the selection's top_s
      __syncwarp();
      int srank = 0;
#pragma unroll 4
      for (int j = 0; j < M; ++j) {
        const float aj = keys_s[j];
        srank += (aj > aoi_star || (aj == aoi_star && j < lane)) ? 1 : 0;
      }
      if (cl_lane) aoi_star = srank < n_good ? 1.0f : __fadd_rn(aoi_star, 1.0f);

      // regret, variances (aoi_variance: sum of squared deviations), successes.
      // The AoIs and rewards are integers, so sum(aoi_pi - aoi_star) is
      // exactly sum(aoi_pi) - sum(aoi_star) and the rewards' sum a popcount.
      const float pi_sum = warp_sum(cl_lane ? aoi_pi : 0.0f);
      const float star_sum = warp_sum(cl_lane ? aoi_star : 0.0f);
      const float d_sum = __fsub_rn(pi_sum, star_sum);
      const float r_sum = static_cast<float>(__popc(__ballot_sync(kFull, cl_lane && rw > 0.5f)));
      const float dev_pi = cl_lane ? __fsub_rn(aoi_pi, __fmul_rn(pi_sum, inv_m)) : 0.0f;
      const float dev_star = cl_lane ? __fsub_rn(aoi_star, __fmul_rn(star_sum, inv_m)) : 0.0f;
      const float var_pi = warp_sum(__fmul_rn(dev_pi, dev_pi));
      const float var_star = warp_sum(__fmul_rn(dev_star, dev_star));
      cum_regret = __fadd_rn(cum_regret, d_sum);
      cum_var_pi = __fadd_rn(cum_var_pi, var_pi);
      cum_var_star = __fadd_rn(cum_var_star, var_star);
      successes = __fadd_rn(successes, r_sum);

      if (cl_lane) schedule[static_cast<size_t>(t) * M + lane] = ch;
      if (lane == 0 && regret_curve != nullptr) {
        regret_curve[t] = cum_regret;
        var_curve[t] = cum_var_pi;
      }
    }
  }

  // write-back
  if (warp == 0) {
    if (ch_lane) {
      head_s[lane] = head;
      window_s[lane] = min(static_cast<int>(cnt), H);
      a.mu_out[run * N + lane] = mu;
      a.counts_out[run * N + lane] = cnt;
      a.total_out[run * N + lane] = total;
      a.base_out[run * N + lane] = base;
    }
    if (cl_lane) {
      a.aoi_pi[run * M + lane] = aoi_pi;
      a.aoi_star[run * M + lane] = aoi_star;
    }
    if (lane == 0) {
      restarted_s = restarted ? 1 : 0;
      a.tau_out[run] = tau;
      a.restarts_out[run] = restarts;
      a.scalars[run * 4 + 0] = cum_regret;
      a.scalars[run * 4 + 1] = cum_var_pi;
      a.scalars[run * 4 + 2] = cum_var_star;
      a.scalars[run * 4 + 3] = successes;
    }
  }
  if (my_splits) atomicAdd(&split_total, my_splits);
  __syncthreads();
  if (tid == 0) a.splits[run] = split_total;
  float* ring_out = a.ring_out + run * NH;
  if (!RECOMPUTE) {
    for (size_t k = tid; k < NH; k += kThreads) ring_out[k] = ring[k];
  } else {
    for (size_t k = tid; k < NH; k += kThreads) {
      const int i = static_cast<int>(k / H), pos = static_cast<int>(k - static_cast<size_t>(i) * H);
      const int p = head_s[i] + pos;
      const bool kept = !restarted_s || pos < window_s[i];
      ring_out[k] = kept ? ring[static_cast<size_t>(i) * H + (p >= H ? p - H : p)] : 0.0f;
    }
  }
}

size_t smem_bytes(int N, int M, int H, int recompute) {
  const size_t chunks = static_cast<size_t>(M) * ((H + 31) / 32);
  return (static_cast<size_t>(N) * H + (recompute ? 2 * chunks : 0)) * sizeof(float);
}

template <bool RECOMPUTE, bool GEOM, bool TABLE>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&regret_scan_kernel<RECOMPUTE, GEOM, TABLE>);
}

const void* pick(int recompute, int geometric, int table_form) {
  if (recompute) return table_form ? kernel_fn<true, false, true>() : kernel_fn<true, false, false>();
  if (geometric) return table_form ? kernel_fn<false, true, true>() : kernel_fn<false, true, false>();
  return table_form ? kernel_fn<false, false, true>() : kernel_fn<false, false, false>();
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int regret_scan_launch(
    const float* mu0, const float* counts0, const int* tau0, const float* ring0,
    const int* restarts0, const float* total0, const float* base0, const float* gamma,
    const float* delta, const float* min_samples, const float* means, const long long* breaks,
    const float* table, const float* u, long long* schedule, float* regret_curve,
    float* var_curve, float* scalars, float* aoi_pi, float* aoi_star, float* mu_out,
    float* counts_out, int* tau_out, float* ring_out, int* restarts_out, float* total_out,
    float* base_out, unsigned long long* splits, int T, int N, int M, int H, int n_seg, int stride,
    int period, int recompute, int geometric, int table_form, int B, int T_tab, int state_b,
    int env_b, int u_b, int hp_b, void* stream) {
  if (T < 0 || M < 1 || M > N || N > 32 || H < 1 || n_seg < 1 || stride < 1 || period < 0 ||
      B < 1 || T_tab < 0 || (recompute && geometric))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{mu0, counts0, tau0, ring0, restarts0, total0, base0, gamma, delta, min_samples,
               means, breaks, table, u, schedule, regret_curve, var_curve, scalars, aoi_pi,
               aoi_star, mu_out, counts_out, tau_out, ring_out, restarts_out, total_out, base_out,
               splits, T, N, M, H, n_seg, stride, period, T_tab, state_b != 0, env_b != 0,
               u_b != 0, hp_b != 0};
  const size_t smem = smem_bytes(N, M, H, recompute);
  const void* fn = pick(recompute, geometric, table_form);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t launched = cudaLaunchKernel(fn, dim3(B), dim3(kThreads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// blocks of the launch an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// for the template and shared memory a run of (N, M, H) takes
extern "C" int regret_scan_occupancy(int N, int M, int H, int recompute, int geometric,
                                     int table_form, int* blocks_per_sm) {
  const size_t smem = smem_bytes(N, M, H, recompute);
  const void* fn = pick(recompute, geometric, table_form);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, smem));
}
