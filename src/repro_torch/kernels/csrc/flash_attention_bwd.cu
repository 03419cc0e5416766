// Blockwise (flash) grouped-query attention, backward, bf16 on Hopper's
// tensor cores (sm_90a) through mma.sync m16n8k16 and cp.async.
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// custom_vjp backward `_bwd` (src/repro/models/attention.py:147-149), which
// recomputes the attention through XLA (the Pallas kernel is forward-only;
// JAX's comment at :133-135 names a dedicated backward kernel as the faster
// form).  It takes every call the tensor-core forward takes (bf16, D % 8 ==
// 0, 8 <= D <= 256).  Semantics of record: `repro_torch.kernels.ref.
// mha_attention_bwd`.
//
// q, out, dout (B, Hq, S, D), k and v (B, Hkv, S, D), contiguous bf16; lse
// (B, Hq, S) f32, each query row's logsumexp of its scaled, masked logits
// (natural units, as the forward kernel writes it); dq, dk, dv bf16 in the
// inputs' shapes.  Query head h reads KV head h / (Hq / Hkv).  A key j is
// visible to a query i when i, j < S, j <= i (causal) and j > i - window
// (window > 0).  The FlashAttention-2 backward:
//   P = exp(scale q.k - lse), Delta = rowsum(dO * O), dV = P^T dO,
//   dS = P (dO V^T - Delta), dQ = scale dS K, dK = scale dS^T Q,
// every sum in f32, each output rounded once to bf16.
//
// Three launches, no float atomics, so two calls give the same bits:
//   1. delta: one warp a row, Delta = rowsum(dO * O) in f32 into a scratch
//      (B, Hq, S) (each lane adds its 8 columns in order, then a fixed
//      butterfly).
//   2. dK/dV: one block per (64-key tile, KV head, batch[, D half]); four
//      warps own 16 keys each, K and V stay in shared memory, and the block
//      walks the group's query heads and their visible query tiles in a
//      fixed order, Q, dO, lse and Delta double-buffered through cp.async.
//      A warp computes S^T = K Q^T and dP^T = V dO^T (16 keys x BQ queries),
//      P^T and dS^T in registers, and accumulates dV += P^T dO and dK +=
//      dS^T Q in registers: the accumulator layout of S^T is the A-operand
//      layout of the next product, so P and dS never go through shared
//      memory.
//   3. dQ: one block per (64-query tile, q head, batch), the query tiles
//      launched last-first (the longest causal rows first); four warps own
//      16 queries each, Q and dO stay in shared memory, and the block walks
//      the visible key tiles, K and V double-buffered: S, P, dP and dS as
//      above, dQ += dS K in registers.
// Whole tiles outside every row of a warp are skipped; the mask is applied
// only on tiles that cross the diagonal, the window's edge or S.
//
// Accuracy.  P and dS enter their products as one bf16 rounding each: the
// emulation of this arithmetic (tests/test_torch_flash_bwd_split.py) stays
// inside the card check, |got - want| <= 2^-6 |want| + 2^-7 max|want| per
// tensor against an f64 backward, by a wide margin, so no operand is split
// (the forward splits P for its tighter output tolerance).
//
// Head dims.  D is padded in shared memory only (zero-filled by cp.async) to
// DP = 64, 80, 96, 128 or 256 (D = 136-248 runs as 256).  Registers bound the
// tiles: a warp's f32 dK and dV for 16 keys x DH columns are DH registers a
// thread, S^T and dP^T BQ / 2 each.  DP <= 96: DH = DP, BQ = 64 (at most 96 +
// 64).  DP = 128: DH = 128, BQ = 32 (128 + 32).  DP = 256 is the hard case:
// dK and dV of 16 keys x 256 would be 256 registers a thread, so the dK/dV
// launch splits D into two halves of 128 columns (blockIdx.z), each block
// recomputing S^T and dP^T over the full D (1.4x the tile's products) and
// accumulating only its half, with BQ = 32; the dQ kernel keeps all 256
// columns (128 registers) with 32-key tiles.  Shared rows are DP + 8 bf16
// long, so the 8 rows an ldmatrix reads sit in 8 distinct bank groups.
//
// What bounds it on the H100: bf16 tensor-core operations, 10 D flops a
// visible (query, key) pair a query head (five products) against q, k, v,
// out, dO read and dq, dk, dv written once: qwen1.5-0.5b's training shape
// (8, 16/16, 2048, 64) causal, 1.72e11 flops, 0.174 ms at 989 TFLOP/s
// against 0.080 ms of bytes.  This kernel issues seven products a pair (S
// and dP in both launches; at D = 256, nine: the dK/dV halves redo S and
// dP): a ceiling of 1.4x (1.8x) the bound even at mma.sync's full rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;          // keys a dK/dV block, queries a dQ block
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) . B (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Fragment loads from a shared tile of rows ST bf16 long (lane l feeds the
// row address of matrix l / 8, row l % 8).
// A (16 x 16) at (m0, k0) of a row-major [m][k] tile
template <int ST>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int m0, int k0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4(a, smem_addr(t + (m0 + l % 8 + 8 * (i & 1)) * ST + k0 + 8 * (i >> 1)));
}
// B of two n-tiles (n0, n0 + 8) over k0..k0 + 15, from an [n][k] tile:
// {b[0], b[1]} for n0, {b[2], b[3]} for n0 + 8
template <int ST>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* t, int n0, int k0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4(b, smem_addr(t + (n0 + l % 8 + 8 * (i >> 1)) * ST + k0 + 8 * (i & 1)));
}
// the same from a [k][n] tile (transposed on the load)
template <int ST>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4_t(b, smem_addr(t + (k0 + l % 8 + 8 * (i & 1)) * ST + n0 + 8 * (i >> 1)));
}

// rows [r0, r0 + R) of one head's (S, D) matrix into a shared [R][ST] tile;
// rows past S and columns past D (up to DP) zero-filled
template <int DP, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int s, int d) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = 8 * (c % kChunks);
    const bool ok = r0 + r < s && col < d;
    cp_async16(dst + r * (DP + 8) + col, ok ? src + static_cast<long long>(r0 + r) * d + col : src,
               ok);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int s, int causal, int window) {
  return qi < s && kj < s && (!causal || kj <= qi) && (window == 0 || kj > qi - window);
}

// ---- 1. Delta = rowsum(dO * O), one warp a row ----
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int col = 8 * lane; col < d; col += 256) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * d + col);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + row * d + col);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(op[j]), g = __bfloat1622float2(gp[j]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- 2. dK and dV: one block per (64-key tile, KV head, batch, D half) ----
// DP: the head dim padded; DH: the dK/dV columns a block accumulates; BQ:
// queries a tile
template <int DP, int DH, int BQ>
struct DkdvLayout {
  static constexpr int ST = DP + 8;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kRows * ST;                    // in bf16 elements
  static constexpr int kQ = kV + kRows * ST;                    // 2 stages
  static constexpr int kDO = kQ + 2 * BQ * ST;                  // 2 stages
  static constexpr int kEnd = kDO + 2 * BQ * ST;
  static constexpr int kBytes = kEnd * 2 + 2 * 2 * BQ * 4;      // + lse2 and Delta, 2 stages
};

template <int DP, int DH, int BQ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv, int s, int d,
                int causal, int window, float scale, float scale_log2) {
  using L = DkdvLayout<DP, DH, BQ>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *sK = sm + L::kK, *sV = sm + L::kV, *sQ = sm + L::kQ, *sdO = sm + L::kDO;
  float* sL = reinterpret_cast<float*>(sm + L::kEnd);           // [2][BQ]: lse in log2 units
  float* sD = sL + 2 * BQ;                                       // [2][BQ]: Delta

  const int k0 = blockIdx.x * kRows;
  const int bkv = blockIdx.y;                                    // b * Hkv + kv head
  const int c0 = blockIdx.z * DH;                                // this block's first column
  const int group = hq / hkv, b = bkv / hkv, kvh = bkv % hkv;
  const int k_last = min(k0 + kRows, s) - 1;
  const long long kv_off = static_cast<long long>(bkv) * s * d;

  // the query tiles any key of this block sees
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(s - 1, k_last + window - 1) : s - 1;
  const int qt_lo = q_lo / BQ, n_qt = q_hi / BQ - qt_lo + 1;
  const int n_iter = group * n_qt;                               // (head, tile), head-major

  load_tile<DP, kRows>(sK, k + kv_off, k0, s, d);
  load_tile<DP, kRows>(sV, v + kv_off, k0, s, d);
  auto issue = [&](int it) {
    const int st = it & 1, qb = (qt_lo + it % n_qt) * BQ;
    const long long row0 = (static_cast<long long>(b) * hq + kvh * group + it / n_qt) * s;
    load_tile<DP, BQ>(sQ + st * BQ * ST, q + row0 * d, qb, s, d);
    load_tile<DP, BQ>(sdO + st * BQ * ST, dout + row0 * d, qb, s, d);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool ok = qb + i < s;
      sL[st * BQ + i] = ok ? lse[row0 + qb + i] * kLog2e : 0.0f;
      sD[st * BQ + i] = ok ? delta[row0 + qb + i] : 0.0f;
    }
  };
  if (n_iter > 0) issue(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kb = k0 + 16 * warp;                                 // this warp's keys
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1, qb = (qt_lo + it % n_qt) * BQ;
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16 *tQ = sQ + st * BQ * ST, *tdO = sdO + st * BQ * ST;
    const float *tL = sL + st * BQ, *tD = sD + st * BQ;
    // some key of this warp sees some query of the tile
    if (kb < s && (!causal || kb <= qb + BQ - 1) && (window == 0 || qb < kb + 15 + window)) {
      const bool masked = qb + BQ > s || kb + 16 > s || (causal && kb + 15 > qb) ||
                          (window > 0 && kb <= qb + BQ - 1 - window);
      float sc[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
      // S^T = K Q^T and dP^T = V dO^T over the full D
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<ST>(ak, sK, 16 * warp, 16 * kk);
        load_a<ST>(av, sV, 16 * warp, 16 * kk);
#pragma unroll
        for (int nn = 0; nn < BQ / 16; ++nn) {
          uint32_t bq[4], bo[4];
          load_b_nk<ST>(bq, tQ, 16 * nn, 16 * kk);
          load_b_nk<ST>(bo, tdO, 16 * nn, 16 * kk);
          mma(sc[2 * nn], ak, bq[0], bq[1]);
          mma(sc[2 * nn + 1], ak, bq[2], bq[3]);
          mma(dp[2 * nn], av, bo[0], bo[1]);
          mma(dp[2 * nn + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T, then the two products with them as bf16 A operands
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1);
          p[e] = exp2f(sc[n][e] * scale_log2 - tL[qc]);
          if (masked && !visible(qb + qc, kb + g + 8 * (e >> 1), s, causal, window)) p[e] = 0.0f;
          ds[e] = p[e] * (dp[n][e] - tD[qc]);
        }
        // C tile n holds columns 8n..8n+7 of the k-slice n / 2
        pa[n / 2][2 * (n % 2)] = pack(p[0], p[1]);
        pa[n / 2][2 * (n % 2) + 1] = pack(p[2], p[3]);
        sa[n / 2][2 * (n % 2)] = pack(ds[0], ds[1]);
        sa[n / 2][2 * (n % 2) + 1] = pack(ds[2], ds[3]);
      }
      // dV += P^T dO, dK += dS^T Q on this block's columns
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq)
#pragma unroll
        for (int nn = 0; nn < DH / 16; ++nn) {
          uint32_t bo[4], bq[4];
          load_b_kn<ST>(bo, tdO, 16 * kq, c0 + 16 * nn);
          load_b_kn<ST>(bq, tQ, 16 * kq, c0 + 16 * nn);
          mma(acc_v[2 * nn], pa[kq], bo[0], bo[1]);
          mma(acc_v[2 * nn + 1], pa[kq], bo[2], bo[3]);
          mma(acc_k[2 * nn], sa[kq], bq[0], bq[1]);
          mma(acc_k[2 * nn + 1], sa[kq], bq[2], bq[3]);
        }
    }
    __syncthreads();
  }

  // rows < S, columns < D of this block's half
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kb + g + 8 * h;
    if (kj >= s) continue;
    const long long off = kv_off + static_cast<long long>(kj) * d;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
      }
    }
  }
}

// ---- 3. dQ: one block per (64-query tile, q head, batch) ----
template <int DP, int BK>
struct DqLayout {
  static constexpr int ST = DP + 8;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kRows * ST;
  static constexpr int kK = kDO + kRows * ST;                   // 2 stages
  static constexpr int kV = kK + 2 * BK * ST;                   // 2 stages
  static constexpr int kBytes = (kV + 2 * BK * ST) * 2;
};

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int hq, int hkv, int s, int d, int causal, int window,
              float scale, float scale_log2) {
  using L = DqLayout<DP, BK>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *sQ = sm + L::kQ, *sdO = sm + L::kDO, *sK = sm + L::kK, *sV = sm + L::kV;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;          // the longest causal rows first
  const int bh = blockIdx.y;                                     // b * Hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q_last = min(q0 + kRows, s) - 1;
  const long long q_off = static_cast<long long>(bh) * s;
  const long long kv_off = static_cast<long long>(kvh) * s * d;

  // the key tiles any query of this block sees
  int kj_lo = 0, kj_hi = (s - 1) / BK;
  if (causal) kj_hi = min(kj_hi, q_last / BK);
  if (window > 0 && q0 - window + 1 > 0) kj_lo = (q0 - window + 1) / BK;
  const int n_iter = kj_hi - kj_lo + 1;

  load_tile<DP, kRows>(sQ, q + q_off * d, q0, s, d);
  load_tile<DP, kRows>(sdO, dout + q_off * d, q0, s, d);
  auto issue = [&](int it) {
    const int st = it & 1, kbase = (kj_lo + it) * BK;
    load_tile<DP, BK>(sK + st * BK * ST, k + kv_off, kbase, s, d);
    load_tile<DP, BK>(sV + st * BK * ST, v + kv_off, kbase, s, d);
  };
  if (n_iter > 0) issue(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qa = q0 + 16 * warp;                                 // this warp's queries
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + g + 8 * h;
    lse2[h] = qi < s ? lse[q_off + qi] * kLog2e : 0.0f;
    dl[h] = qi < s ? delta[q_off + qi] : 0.0f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1, kbase = (kj_lo + it) * BK;
    if (it + 1 < n_iter) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16 *tK = sK + st * BK * ST, *tV = sV + st * BK * ST;
    // some query of this warp sees some key of the tile
    if (qa < s && (!causal || kbase <= qa + 15) && (window == 0 || kbase + BK - 1 > qa - window)) {
      const bool masked = qa + 16 > s || kbase + BK > s || (causal && kbase + BK - 1 > qa) ||
                          (window > 0 && kbase <= qa + 15 - window);
      float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
      // S = Q K^T and dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t aq[4], ao[4];
        load_a<ST>(aq, sQ, 16 * warp, 16 * kk);
        load_a<ST>(ao, sdO, 16 * warp, 16 * kk);
#pragma unroll
        for (int nn = 0; nn < BK / 16; ++nn) {
          uint32_t bk[4], bv[4];
          load_b_nk<ST>(bk, tK, 16 * nn, 16 * kk);
          load_b_nk<ST>(bv, tV, 16 * nn, 16 * kk);
          mma(sc[2 * nn], aq, bk[0], bk[1]);
          mma(sc[2 * nn + 1], aq, bk[2], bk[3]);
          mma(dp[2 * nn], ao, bv[0], bv[1]);
          mma(dp[2 * nn + 1], ao, bv[2], bv[3]);
        }
      }
      uint32_t sa[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[n][e] * scale_log2 - lse2[e >> 1]);
          if (masked && !visible(qa + g + 8 * (e >> 1), kbase + 8 * n + 2 * t + (e & 1), s,
                                 causal, window))
            p = 0.0f;
          ds[e] = p * (dp[n][e] - dl[e >> 1]);
        }
        sa[n / 2][2 * (n % 2)] = pack(ds[0], ds[1]);
        sa[n / 2][2 * (n % 2) + 1] = pack(ds[2], ds[3]);
      }
      // dQ += dS K
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq)
#pragma unroll
        for (int nn = 0; nn < DP / 16; ++nn) {
          uint32_t bk[4];
          load_b_kn<ST>(bk, tK, 16 * kq, 16 * nn);
          mma(acc[2 * nn], sa[kq], bk[0], bk[1]);
          mma(acc[2 * nn + 1], sa[kq], bk[2], bk[3]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + g + 8 * h;
    if (qi >= s) continue;
    bf16* row = dq + (q_off + qi) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// ---- host side ----

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  int b, hq, hkv, s, d, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int DP>
int launch(const Args& a) {
  constexpr int DH = DP == 256 ? 128 : DP;          // dK/dV columns a block
  constexpr int kHalves = DP / DH;
  constexpr int BQ = DH <= 96 ? 64 : 32;
  constexpr int BK = DP <= 128 ? 64 : 32;
  constexpr int kDkdvBytes = DkdvLayout<DP, DH, BQ>::kBytes;
  constexpr int kDqBytes = DqLayout<DP, BK>::kBytes;
  static_assert(kDkdvBytes <= 232448 && kDqBytes <= 232448, "above the 227 KB a block can use");
  static bool attr_set = false;     // once per instantiation: above 48 KB needs the opt-in
  if (!attr_set) {
    cudaError_t err = allow_smem(bwd_dkdv_kernel<DP, DH, BQ>, kDkdvBytes);
    if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<DP, BK>, kDqBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const float scale_log2 = a.scale * kLog2e;
  const long long rows = static_cast<long long>(a.b) * a.hq * a.s;
  bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(a.o, a.dout,
                                                                               a.delta, rows, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.s + kRows - 1) / kRows;
  bwd_dkdv_kernel<DP, DH, BQ><<<dim3(tiles, a.b * a.hkv, kHalves), kThreads, kDkdvBytes,
                                a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
                                            a.hq, a.hkv, a.s, a.d, a.causal, a.window, a.scale,
                                            scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<DP, BK><<<dim3(tiles, a.b * a.hq), kThreads, kDqBytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.hq, a.hkv, a.s, a.d, a.causal, a.window,
      a.scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, out, dout, dq, dk, dv; f32 lse and the (B, Hq, S) f32 scratch
// delta; 8 <= d <= 256 with d % 8 == 0, hq % hkv == 0, b * hq <= 65535,
// 16-byte aligned pointers.  Three launches on `stream`; returns the first
// cudaError that is not cudaSuccess (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* delta, void* dq, void* dk, void* dv, int b,
                                          int hq, int hkv, int s, int d, int causal, int window,
                                          float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || d < 8 || d > 256 ||
      d % 8 != 0 || window < 0 || static_cast<long long>(b) * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q),  static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),  static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(delta),   static_cast<bf16*>(dq),
               static_cast<bf16*>(dk),       static_cast<bf16*>(dv),
               b, hq, hkv, s, d, causal, window, scale, static_cast<cudaStream_t>(stream)};
  if (d <= 64) return launch<64>(a);
  if (d <= 80) return launch<80>(a);
  if (d <= 96) return launch<96>(a);
  if (d <= 128) return launch<128>(a);
  return launch<256>(a);
}
