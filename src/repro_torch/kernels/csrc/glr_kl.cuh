// The GLR split statistic shared by both detector kernels (sm_90a).
//
// `glr_step.cu` (streaming: prefixes carried in a ring) and `glr_scan.cu`
// (recompute: prefixes rebuilt by a scan) evaluate the same expression
// through these functions, and every operation is rounded on its own
// (`__fmul_rn` and friends: no FMA contraction, whatever the caller's
// context), so equal (P, W, s, n) give equal bits in both kernels.  On
// {0, 1} rewards every prefix is an exact integer, so the two detectors
// then fire on the same rounds.  Semantics of record:
// `repro_torch.kernels.ref.bernoulli_kl` and `_stream_stat_terms`.
#pragma once

namespace glr {

constexpr float kEps = 1e-6f;
constexpr float kHi = static_cast<float>(1.0 - 1e-6);  // f32(1 - 1e-6), as the reference rounds it

// KL(Ber(p) || Ber(q)), both clipped to [1e-6, 1 - 1e-6]
__device__ __forceinline__ float bernoulli_kl(float p, float q) {
  p = fminf(fmaxf(p, kEps), kHi);
  q = fminf(fmaxf(q, kEps), kHi);
  const float p1 = __fsub_rn(1.0f, p), q1 = __fsub_rn(1.0f, q);
  return __fadd_rn(__fmul_rn(p, logf(__fdiv_rn(p, q))), __fmul_rn(p1, logf(__fdiv_rn(p1, q1))));
}

// mean of a window of n samples summing to W
__device__ __forceinline__ float window_mean(float W, float n_f) { return __fdiv_rn(W, fmaxf(n_f, 1.0f)); }

// s*kl(P/s, mu) + (n-s)*kl((W-P)/max(n-s, 1), mu) for a split at s of a
// window of n samples, prefix P at the split, total W, mean mu
__device__ __forceinline__ float split_stat(float P, float W, float s_f, float n_f, float mu_all) {
  const float rest = __fsub_rn(n_f, s_f);
  const float mu_a = __fdiv_rn(P, s_f);
  const float mu_b = __fdiv_rn(__fsub_rn(W, P), fmaxf(rest, 1.0f));
  return __fadd_rn(__fmul_rn(s_f, bernoulli_kl(mu_a, mu_all)),
                   __fmul_rn(rest, bernoulli_kl(mu_b, mu_all)));
}

// block-wide max of one float per thread; blockDim.x <= 32 * 32.  Every
// thread gets the result.  `scratch` holds 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = -__int_as_float(0x7f800000);  // -inf
  for (int i = 0; i < warps; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

}  // namespace glr
