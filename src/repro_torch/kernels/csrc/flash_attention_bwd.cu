// Blockwise (flash) grouped-query attention, backward, bf16 on Hopper's
// tensor cores (sm_90a): wgmma for every product, TMA for every tile, a
// producer warpgroup and two consumer warpgroups.
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
// What bounds it on the H100: bf16 tensor-core operations, 10 D flops a
// visible (query, key) pair a query head (five products) against q, k, v,
// out, dO read and dq, dk, dv written once: qwen1.5-0.5b's training shape
// (8, 16/16, 2048, 64) causal, 1.72e11 flops, 0.174 ms at 989 TFLOP/s
// against 0.080 ms of bytes.  Ceiling: this kernel issues seven products a
// pair, 7/5 of the bound (S and dP are computed in both the dK/dV and the
// dQ launch, so that each launch owns its outputs), at every head dim.
//
// Three launches, no atomics, so two calls give the same bits:
//   1. stats: Delta = rowsum(dO * O) in f32 (a power of two of lanes a row,
//      each adding its columns in order, then a fixed butterfly) and lse
//      log2(e), into a (2, B Hq, S_pad) f32 scratch, S_pad = S rounded up to
//      64, rows past S zero: the dK/dV launch fetches a query tile's 64
//      values of each with one bulk copy.
//   2. dK/dV: one block per (KV head, batch, key tile), the key tiles
//      launched in order (causal: the longest columns first), all KV heads
//      of a tile before the next tile.  K and V stay in shared memory; the
//      block walks the group's query heads and their visible 64-query tiles
//      in a fixed order (head-major), Q, dO, lse and Delta streamed by TMA.
//   3. dQ: one block per (q head, batch, query tile), the query tiles
//      launched last-first (the longest causal rows first), the q heads of
//      one KV head neighbours, so their K and V tiles meet in L2.  Q and dO
//      stay in shared memory; the block walks the visible 64-key tiles, K
//      and V streamed by TMA.
// Each block owns its rows of its outputs and writes them once from
// registers; nothing is added across blocks, and every sum runs in one
// fixed order, so the result does not depend on the schedule.
//
// Design (launches 2 and 3 are one template: "resident" rows, K and V or Q
// and dO, against "streamed" 64-row tiles, Q and dO or K and V).  Thread
// 256 of a producer warpgroup issues the TMA loads: the resident tiles
// once, then the streamed tiles through a ring of stages, each with a full
// barrier (TMA bytes) and an empty barrier that the 256 consumer threads
// arrive on.  `setmaxnreg` moves registers from the producer (24 a thread)
// to the two consumer warpgroups (240).  Tiles land in shared memory in
// column blocks of W bf16 (one swizzle row): W = 64 with the 128-byte
// swizzle at D = 64, 128 and 256, W = 32 with the 64-byte swizzle at D = 96,
// W = 16 with the 32-byte swizzle at D = 80 (D padded to 80 at 72 and to 256
// at 136-248, columns past D zero-filled by the TMA unit, as rows past S).
// So hubert's D = 80 is five 16-deep k-steps and phi-3-vision's D = 96 six,
// with no product over padding, and every operand is read in place by
// wgmma: each tile serves as a K-major operand (the contraction over D)
// and as an MN-major B (the contraction over its rows), from one layout.
// A warpgroup's step on one streamed tile, its 64 rows against 64 columns:
//   X1 = R1 T1^T and X2 = R2 T2^T, wgmma m64n64k16 with both operands in
//   shared memory, two commit groups (dK/dV: S^T = K Q^T, dP^T = V dO^T;
//   dQ: S = Q K^T, dP = dO V^T).  P = exp2(X1 scale log2(e) - lse log2(e))
//   in place once X1 is done, while X2 runs: one FFMA and one SFU ex2 an
//   element; the mask in a loop of its own, only on tiles that cross the
//   diagonal, the window's edge or S (tested on every element, it cost
//   more than the products at D = 64; at D = 256 it stays in the one loop,
//   which spills nothing there), whole tiles outside every row of a
//   warpgroup skipped.  dS = P (X2 - Delta); P and dS rounded once
//   to bf16 into registers: the accumulator layout is the A-operand layout
//   of wgmma with A in registers.  Then dV += P^T dO and dK += dS^T Q (dQ:
//   dQ += dS K), wgmma m64nNk16 with A in registers and the streamed tile an
//   MN-major B, into f32 accumulators that live across the whole walk.
//   The two warpgroups run their steps independently, so one's products
//   fill the tensor cores while the other computes P and dS.  The SFU
//   bounds that elementwise part (an ex2 an element in each of launches 2
//   and 3), about as long as a tile's products at D = 64.  Carrying a
//   step's dV/dK products into the next step (a software pipeline) and
//   turn-taking between the warpgroups were tried and were slower: ptxas
//   serialised the wgmmas across the loop's branches.
// Registers a consumer thread holds (of 240): the accumulators (D / 2 each,
// two in dK/dV), X1 and X2 (32 each), P and dS in bf16 (16 each).
//   D <= 128: two warpgroups of 64 rows, a block 128 resident rows: at D =
//   128 dK/dV needs 128 + 64 + 32.  Shared memory: the resident tiles 2 x
//   128 x D x 2 bytes, 3 stages of two 64 x D tiles (and 512 bytes of lse
//   and Delta): 166 KB at D = 128.
//   D = 256 (recurrentgemma): dK and dV of 64 rows x 256 columns would be
//   256 registers a thread.  The two warpgroups split D's columns over 64
//   resident rows: warpgroup 0 computes X1 and P, warpgroup 1 X2, and they
//   trade through shared memory, P in f32 from 0 to 1 and dS as its bf16 A
//   fragments from 1 to 0, each in the accumulator's register order (no
//   new rounding: the same bits as the D <= 128 path), between two named
//   barriers; then each runs the dV/dK (dQ) products on its 128 columns
//   (128 + 32 + 32 registers).  So S and dP are still computed once a pair
//   per launch.  Shared memory: 2 x 32 KB resident, 2 stages of 64 KB, 24 KB
//   to trade: 218 KB, one block an SM.
// Filling the card: blocks of 128 rows (64 at D = 256), one an SM (384
// threads, 240 registers); at the five training shapes the dK/dV grid is
// 2,048 / 2,048 / 256 / 4,608 / 1,024 blocks and the dQ grid 2,048 / 2,048 /
// 2,560 / 4,608 / 6,144 on 132 SMs.  recurrentgemma's dK/dV (one KV head,
// B = 8, causal) is the thin one: 256 blocks of unequal work, launched
// longest first, so a block that finishes early takes a short one (the
// greedy longest-first order, within 4/3 of the best makespan).
//
// Accuracy.  P and dS enter their products as one bf16 rounding each, as in
// the mma.sync kernel this design replaced (the D = 256 trade adds none;
// ex2.approx.ftz flushes a P below 2^-126 to 0, far under any rounding):
// the emulation of this arithmetic (tests/test_torch_flash_bwd_split.py, 64
// rows a warpgroup, 64-row streamed tiles) stays inside the card check,
// |got - want| <= 2^-6 |want| + 2^-7 max|want| per tensor against an f64
// backward, by a wide margin, so no operand is split.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup: one thread loads
constexpr int kTile = 64;                    // rows of a warpgroup, rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// A head dim padded to DP in shared memory: column blocks of W bf16, each
// one swizzle row of W * 2 bytes
template <int DP>
struct Cols {
  static constexpr int W = DP % 64 == 0 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int kBlocks = DP / W;
  static constexpr int kLayout = W == 64 ? kSwizzle128 : W == 32 ? kSwizzle64 : kSwizzle32;
  static constexpr uint32_t kRowBytes = W * 2;
  static constexpr uint32_t kAtom = 8 * kRowBytes;      // 8 rows: the stride byte offset
};

// Shared memory of launch 2 (kDQ false) or 3 (kDQ true) at head dim DP
template <int DP, bool kDQ>
struct Plan {
  static constexpr bool kSplit = DP == 256;            // the warpgroups split D's columns
  static constexpr int kRows = kSplit ? 64 : 128;      // resident rows a block
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kN = kSplit ? 128 : DP;         // accumulator columns a warpgroup
  static constexpr uint32_t kResBytes = kRows * DP * 2;   // one resident tile
  static constexpr uint32_t kTileBytes = kTile * DP * 2;  // one streamed tile
  static constexpr uint32_t kStatBytes = kDQ ? 0 : 2 * kTile * 4;  // lse log2(e), Delta
  static constexpr uint32_t kRes = 0;                             // R1, R2
  static constexpr uint32_t kStr = 2 * kResBytes;                 // stage st: T1, T2
  static constexpr uint32_t kStat = kStr + 2 * kStages * kTileBytes;
  static constexpr uint32_t kXP = kStat + kStages * kStatBytes;   // split: P, f32 [32][128]
  static constexpr uint32_t kXS = kXP + (kSplit ? 32 * 128 * 4 : 0);  // split: dS, [16][128]
  static constexpr uint32_t kBar = kXS + (kSplit ? 16 * 128 * 4 : 0);  // res, full[], empty[]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;               // base aligned up to 1 KB
};

// descriptor of a K-major operand, 16 columns of the contraction over D
// (k-step kk) from row r0 of a tile of R rows
template <int DP, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  using C = Cols<DP>;
  const int col = 16 * kk;
  const uint32_t addr =
      tile + (col / C::W) * R * C::kRowBytes + r0 * C::kRowBytes + (col % C::W) * 2;
  return smem_desc(addr, 16, C::kAtom, C::kLayout);
}

// descriptor of an MN-major B: rows 16 kk .. 16 kk + 15 of a tile of R rows
// (the contraction), N over its columns from c0 (a multiple of W)
template <int DP, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c0) {
  using C = Cols<DP>;
  return smem_desc(tile + (c0 / C::W) * R * C::kRowBytes + 16 * kk * C::kRowBytes,
                   R * C::kRowBytes, C::kAtom, C::kLayout);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack_bf16(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ bool visible(int qi, int kj, int s, int causal, int window) {
  return qi < s && kj < s && (!causal || kj <= qi) && (window == 0 || kj > qi - window);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kConsumers) : "memory");
}

// X = R T^T over D (64 x 64, f32) for one warpgroup's rows, issued and committed
template <int DP, int R>
__device__ __forceinline__ void issue_x(float (&x)[32], uint32_t res, int a_row, uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<64>(x, desc_k<DP, R>(res, a_row, kk), desc_k<DP, kTile>(tile, 0, kk), kk > 0);
  wgmma_commit();
}

// Where a thread's elements of a 64 x 64 accumulator sit: rows `row` + {0,
// 8}, columns `col` + {0, 1} of every 8 (absolute positions), and the mask.
// The tile's statistics come per column from shared memory (dK/dV: lse
// log2(e) at [0, 64), Delta at [64, 128)) or per row from registers (dQ).
struct View {
  int row, col, s, causal, window;
  bool masked;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// whether accumulator element i of the thread at `v` is a visible pair
template <bool kDQ>
__device__ __forceinline__ bool visible_at(const View& v, int i) {
  const int r = v.row + 8 * ((i / 2) % 2), c = v.col + 8 * (i / 4) + (i % 2);
  return kDQ ? visible(r, c, v.s, v.causal, v.window) : visible(c, r, v.s, v.causal, v.window);
}

// P = exp2(X1 scale log2(e) - lse log2(e)) in place, 0 where not visible: the
// mask in a loop of its own, run only on tiles that need it, or (kFused, the
// D = 256 split path) tested inside the one loop, whose fewer live registers
// keep that path from spilling
template <bool kDQ, bool kFused>
__device__ __forceinline__ void probs(float (&x)[32], const View& v, const float* col_stat,
                                      const float (&row_l2)[2], float scale_log2) {
  if constexpr (kFused) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float l = kDQ ? row_l2[(i / 2) % 2] : col_stat[8 * (i / 4) + v.col % 8 + (i % 2)];
      float p = ex2(fmaf(x[i], scale_log2, -l));
      if (v.masked && !visible_at<kDQ>(v, i)) p = 0.0f;
      x[i] = p;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 l2 = make_float2(row_l2[0], row_l2[1]);
      if constexpr (!kDQ) l2 = *reinterpret_cast<const float2*>(col_stat + 8 * j + v.col % 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = kDQ ? (e < 2 ? l2.x : l2.y) : (e % 2 ? l2.y : l2.x);
        x[4 * j + e] = ex2(fmaf(x[4 * j + e], scale_log2, -l));
      }
    }
    if (v.masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible_at<kDQ>(v, i)) x[i] = 0.0f;
    }
  }
}

// dS = P (X2 - Delta) for one pair of elements (accumulator pair i = 8 kk +
// 2 r), P and dS rounded to bf16 into register r of A-fragment k-slice kk
// (P's only for dK/dV)
template <bool kDQ>
__device__ __forceinline__ void grad_pair(float p0, float p1, float x0, float x1, int kk, int r,
                                          const View& v, const float* col_stat,
                                          const float (&row_dl)[2], uint32_t (&pa)[4][4],
                                          uint32_t (&sa)[4][4]) {
  float2 dl = make_float2(row_dl[r % 2], row_dl[r % 2]);
  if constexpr (!kDQ)
    dl = *reinterpret_cast<const float2*>(col_stat + kTile + 8 * (2 * kk + r / 2) + v.col % 8);
  if constexpr (!kDQ) pa[kk][r] = pack(p0, p1);
  sa[kk][r] = pack(p0 * (x0 - dl.x), p1 * (x1 - dl.y));
}

// grad_pair over the tile, pair by pair, so that X1 and X2 die as the
// fragments fill
template <bool kDQ>
__device__ __forceinline__ void grads(const float (&x1)[32], const float (&x2)[32],
                                      const View& v, const float* col_stat,
                                      const float (&row_dl)[2], uint32_t (&pa)[4][4],
                                      uint32_t (&sa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      grad_pair<kDQ>(x1[i], x1[i + 1], x2[i], x2[i + 1], kk, r, v, col_stat, row_dl, pa, sa);
    }
}

// ---- 1. Delta = rowsum(dO * O) and lse log2(e), `lanes` lanes a row ----
// lanes: a power of two >= d / 8 (each lane adds its 8-column chunks in order,
// then a fixed butterfly), 32 / lanes neighbouring rows a warp, so that a warp
// reads whole rows in one piece
__global__ void __launch_bounds__(256)
bwd_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ stats, long long rows_pad,
                 int s, int s_pad, int d, int lanes) {
  const int lane = threadIdx.x % 32, sub = lane % lanes;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32) * (32 / lanes) + lane / lanes;
  const int i = row < rows_pad ? static_cast<int>(row % s_pad) : s;
  const long long src = row / s_pad * s + i;
  float acc = 0.0f;
  if (i < s)
    for (int col = 8 * sub; col < d; col += 8 * lanes) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + src * d + col);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + src * d + col);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(op[j]), g = __bfloat1622float2(gp[j]);
        acc = fmaf(a.x, g.x, acc);
        acc = fmaf(a.y, g.y, acc);
      }
    }
  for (int off = lanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows_pad && sub == 0) {
    stats[row] = i < s ? lse[src] * kLog2e : 0.0f;
    stats[rows_pad + row] = acc;
  }
}

// ---- 2. and 3. dK/dV (kDQ false), dQ (kDQ true) ----
// stats: launch 1's scratch, lse log2(e) at [0, half), Delta at [half, 2 half)
template <int DP, bool kDQ>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const float* __restrict__ stats, long long half, bf16* __restrict__ out_a,
           bf16* __restrict__ out_b, int hq, int hkv, int s, int s_pad, int d, int causal,
           int window, float scale, float scale_log2) {
  using L = Plan<DP, kDQ>;
  using C = Cols<DP>;
  constexpr int kR = L::kRows;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);                // the same bytes, generic
  const uint32_t res1 = base + L::kRes, res2 = res1 + L::kResBytes;
  const uint32_t bar_res = base + L::kBar, bar_full = bar_res + 8;
  const uint32_t bar_empty = bar_full + 8 * L::kStages;

  // the block's resident rows and its walk over streamed tiles
  const int group = hq / hkv;
  // streamed tile it: rows (t_lo + it % n_t) 64 of q head (b Hq + kvh group + it / n_t)
  // for dK/dV, rows (t_lo + it) 64 of KV head t_head for dQ
  int r_head, r0, t_lo, n_t, n_iter, b = 0, kvh = 0, t_head = 0;
  if constexpr (!kDQ) {
    r_head = blockIdx.x;                                         // b * Hkv + kv head
    b = r_head / hkv;
    kvh = r_head % hkv;
    r0 = blockIdx.y * kR;                                        // the longest columns first
    const int k_last = min(r0 + kR, s) - 1;
    const int q_lo = causal ? r0 : 0;
    const int q_hi = window > 0 ? min(s - 1, k_last + window - 1) : s - 1;
    t_lo = q_lo / kTile;
    n_t = q_hi / kTile - t_lo + 1;
    n_iter = group * n_t;                                        // (head, tile), head-major
  } else {
    r_head = blockIdx.x;                                         // b * Hq + h
    r0 = (gridDim.y - 1 - blockIdx.y) * kR;                      // the longest causal rows first
    const int q_last = min(r0 + kR, s) - 1;
    int hi = (s - 1) / kTile;
    if (causal) hi = min(hi, q_last / kTile);
    t_lo = window > 0 && r0 - window + 1 > 0 ? (r0 - window + 1) / kTile : 0;
    n_t = hi - t_lo + 1;
    n_iter = n_t;
    t_head = (r_head / hq) * hkv + (r_head % hq) / group;
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_res, 1);
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == kConsumers) {
      const CUtensorMap* m_r1 = kDQ ? &tm_q : &tm_k;
      const CUtensorMap* m_r2 = kDQ ? &tm_do : &tm_v;
      const CUtensorMap* m_t1 = kDQ ? &tm_k : &tm_q;
      const CUtensorMap* m_t2 = kDQ ? &tm_v : &tm_do;
      mbar_expect_tx(bar_res, 2 * L::kResBytes);
      for (int r = 0; r < kR; r += kTile)
        for (int c = 0; c < C::kBlocks; ++c) {
          const uint32_t off = c * kR * C::kRowBytes + r * C::kRowBytes;
          tma_load(res1 + off, m_r1, bar_res, c * C::W, r0 + r, r_head);
          tma_load(res2 + off, m_r2, bar_res, c * C::W, r0 + r, r_head);
        }
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_iter; ++it) {
        const int head = kDQ ? t_head : b * hq + kvh * group + it / n_t;
        const int row = (t_lo + (kDQ ? it : it % n_t)) * kTile;
        mbar_wait(bar_empty + 8 * st, phase ^ 1);   // the consumers are done with this stage
        const uint32_t full = bar_full + 8 * st, t1 = base + L::kStr + 2 * st * L::kTileBytes;
        mbar_expect_tx(full, 2 * L::kTileBytes + L::kStatBytes);
        for (int c = 0; c < C::kBlocks; ++c) {
          const uint32_t off = c * kTile * C::kRowBytes;
          tma_load(t1 + off, m_t1, full, c * C::W, row, head);
          tma_load(t1 + L::kTileBytes + off, m_t2, full, c * C::W, row, head);
        }
        if constexpr (!kDQ) {
          const uint32_t sst = base + L::kStat + st * L::kStatBytes;
          const float* src = stats + static_cast<long long>(head) * s_pad + row;
          bulk_load(sst, src, kTile * 4, full);
          bulk_load(sst + kTile * 4, src + half, kTile * 4, full);
        }
        if (++st == L::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    // the warpgroup's index broadcast from lane 0: the compiler then knows it
    // (and every branch on it) uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int rw = L::kSplit ? r0 : r0 + kTile * wg;           // this warpgroup's first row
    const int a_row = L::kSplit ? 0 : kTile * wg;              // ... within the resident tiles
    const int c_out = L::kSplit ? L::kN * wg : 0;              // its first accumulator column
    const int trow = 16 * warp + lane / 4;                     // this thread's rows: trow, +8
    const int tcol = 2 * (lane % 4);                           // its columns: tcol, +1 of every 8

    float acc[L::kN / 2], acc_v[kDQ ? 1 : L::kN / 2];         // dK (dQ), dV
#pragma unroll
    for (int i = 0; i < L::kN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (kDQ ? 1 : L::kN / 2); ++i) acc_v[i] = 0.0f;
    // dQ: the statistics of this thread's two query rows
    float row_l2[2] = {0.0f, 0.0f}, row_dl[2] = {0.0f, 0.0f};
    if constexpr (kDQ) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = rw + trow + 8 * h;
        if (qi < s) {
          row_l2[h] = stats[static_cast<long long>(r_head) * s_pad + qi];
          row_dl[h] = stats[half + static_cast<long long>(r_head) * s_pad + qi];
        }
      }
    }
    float* xp = reinterpret_cast<float*>(gbase + L::kXP);           // split: P, [32][128]
    uint32_t* xs = reinterpret_cast<uint32_t*>(gbase + L::kXS);     // split: dS, [16][128]

    mbar_wait(bar_res, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_iter; ++it) {
      const int tr = (t_lo + (kDQ ? it : it % n_t)) * kTile;   // the tile's first row
      // a warpgroup waits for every stage it passes, skipped or not, so that
      // its arrival counts toward the phase of that stage's load and no other
      mbar_wait(bar_full + 8 * st, phase);
      // rows of this warpgroup x columns of the tile: keys x queries (dK/dV),
      // queries x keys (dQ); whether some pair is visible, whether some is not
      bool any, masked;
      if constexpr (!kDQ) {
        any = rw < s && (!causal || rw <= tr + kTile - 1) &&
              (window == 0 || tr < rw + kTile - 1 + window);
        masked = tr + kTile > s || rw + kTile > s || (causal && rw + kTile - 1 > tr) ||
                 (window > 0 && rw <= tr + kTile - 1 - window);
      } else {
        any = rw < s && (!causal || tr <= rw + kTile - 1) &&
              (window == 0 || tr + kTile - 1 > rw - window);
        masked = rw + kTile > s || tr + kTile > s || (causal && tr + kTile - 1 > rw) ||
                 (window > 0 && tr <= rw + kTile - 1 - window);
      }
      if (any) {
        const uint32_t t1 = base + L::kStr + 2 * st * L::kTileBytes, t2 = t1 + L::kTileBytes;
        const float* sst = reinterpret_cast<const float*>(gbase + L::kStat + st * L::kStatBytes);
        const View view{rw + trow, tr + tcol, s, causal, window, masked};
        float x1[32], x2[32];
        uint32_t pa[4][4], sa[4][4];                            // P and dS, A fragments
        if constexpr (!L::kSplit) {
          hold(x1);
          hold(x2);
          wgmma_fence();
          issue_x<DP, kR>(x1, res1, a_row, t1);
          issue_x<DP, kR>(x2, res2, a_row, t2);
          wgmma_wait<1>();
          hold(x1);
          probs<kDQ, false>(x1, view, sst, row_l2, scale_log2);   // while X2 runs
          wgmma_wait<0>();
          hold(x2);
          grads<kDQ>(x1, x2, view, sst, row_dl, pa, sa);
        } else {
          // warpgroup 0: X1 and P, handed over in f32; warpgroup 1: X2, then
          // dS, handed back as its A fragments
          if (wg == 0) {
            hold(x1);
            wgmma_fence();
            issue_x<DP, kR>(x1, res1, a_row, t1);
            wgmma_wait<0>();
            hold(x1);
            probs<kDQ, true>(x1, view, sst, row_l2, scale_log2);
#pragma unroll
            for (int i = 0; i < 32; ++i) xp[i * 128 + t] = x1[i];
            if constexpr (!kDQ)
#pragma unroll
              for (int j = 0; j < 16; ++j) pa[j / 4][j % 4] = pack(x1[2 * j], x1[2 * j + 1]);
          } else {
            hold(x2);
            wgmma_fence();
            issue_x<DP, kR>(x2, res2, a_row, t2);
            wgmma_wait<0>();
            hold(x2);
          }
          named_sync(1);
          if (wg == 1) {
            // P read pair by pair: P, dP and both fragments at once would not fit
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int i = 8 * kk + 2 * r;
                grad_pair<kDQ>(xp[i * 128 + t], xp[(i + 1) * 128 + t], x2[i], x2[i + 1], kk, r,
                               view, sst, row_dl, pa, sa);
                xs[(4 * kk + r) * 128 + t] = sa[kk][r];
              }
          }
          named_sync(2);
          if (wg == 0)
#pragma unroll
            for (int j = 0; j < 16; ++j) sa[j / 4][j % 4] = xs[j * 128 + t];
        }
        // dV += P^T dO, dK += dS^T Q (dQ += dS K) on this warpgroup's columns
        hold(acc);
        if constexpr (!kDQ) hold(acc_v);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (!kDQ) wgmma_rs<L::kN>(acc_v, pa[kk], desc_mn<DP, kTile>(t2, kk, c_out));
          wgmma_rs<L::kN>(acc, sa[kk], desc_mn<DP, kTile>(t1, kk, c_out));
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        if constexpr (!kDQ) hold(acc_v);
        if constexpr (!kDQ) hold(pa);
        hold(sa);
      }
      mbar_arrive(bar_empty + 8 * st);
      if (++st == L::kStages) {
        st = 0;
        phase ^= 1;
      }
    }

    // epilogue: rows < S, columns < D, from registers; dK and dQ scaled
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + trow + 8 * h;
      if (row >= s) continue;
      const long long off = (static_cast<long long>(r_head) * s + row) * d;
#pragma unroll
      for (int j = 0; j < L::kN / 8; ++j) {
        const int col = c_out + 8 * j + tcol;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(out_a + off + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
          if constexpr (!kDQ)
            *reinterpret_cast<__nv_bfloat162*>(out_b + off + col) =
                __floats2bfloat162_rn(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---- host side ----

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* stats;
  bf16 *dq, *dk, *dv;
  int b, hq, hkv, s, d, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int DP>
int launch(const Args& a) {
  using C = Cols<DP>;
  using KV = Plan<DP, false>;
  using Q = Plan<DP, true>;
  static_assert(KV::kAlloc <= 232448 && Q::kAlloc <= 232448, "above the 227 KB a block can use");
  static bool attr_set = false;     // once per instantiation: above 48 KB needs the opt-in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(bwd_kernel<DP, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(KV::kAlloc));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_kernel<DP, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Q::kAlloc));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(encode, &tm_q, a.q, a.b * a.hq, a.s, a.d, kTile, C::W, C::kLayout) ||
      !make_map(encode, &tm_k, a.k, a.b * a.hkv, a.s, a.d, kTile, C::W, C::kLayout) ||
      !make_map(encode, &tm_v, a.v, a.b * a.hkv, a.s, a.d, kTile, C::W, C::kLayout) ||
      !make_map(encode, &tm_do, a.dout, a.b * a.hq, a.s, a.d, kTile, C::W, C::kLayout))
    return static_cast<int>(cudaErrorInvalidValue);

  const int s_pad = (a.s + kTile - 1) / kTile * kTile;
  const long long half = static_cast<long long>(a.b) * a.hq * s_pad;
  int lanes = 1;
  while (8 * lanes < a.d) lanes *= 2;
  const long long rows_a_block = 8 * (32 / lanes);
  bwd_stats_kernel<<<static_cast<unsigned>((half + rows_a_block - 1) / rows_a_block), 256, 0,
                     a.stream>>>(a.o, a.dout, a.lse, a.stats, half, a.s, s_pad, a.d, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = a.scale * kLog2e;
  bwd_kernel<DP, false><<<dim3(a.b * a.hkv, (a.s + KV::kRows - 1) / KV::kRows), kThreads,
                          KV::kAlloc, a.stream>>>(tm_q, tm_k, tm_v, tm_do, a.stats, half, a.dk,
                                                  a.dv, a.hq, a.hkv, a.s, s_pad, a.d, a.causal,
                                                  a.window, a.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<DP, true><<<dim3(a.b * a.hq, (a.s + Q::kRows - 1) / Q::kRows), kThreads, Q::kAlloc,
                         a.stream>>>(tm_q, tm_k, tm_v, tm_do, a.stats, half, a.dq, nullptr, a.hq,
                                     a.hkv, a.s, s_pad, a.d, a.causal, a.window, a.scale,
                                     scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, out, dout, dq, dk, dv; f32 lse and the f32 scratch `stats`
// of 2 * b * hq * s_pad floats (s_pad: s rounded up to 64); 8 <= d <= 256
// with d % 8 == 0, hq % hkv == 0, ceil(s / 64) <= 65535, 16-byte aligned
// pointers (the tensor maps and bulk copies refuse others).  Three launches
// on `stream`; returns the first cudaError that is not cudaSuccess (0 on
// success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* stats, void* dq, void* dk, void* dv, int b,
                                          int hq, int hkv, int s, int d, int causal, int window,
                                          float scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || d < 8 || d > 256 ||
      d % 8 != 0 || window < 0 || (s + kTile - 1) / kTile > 65535 ||
      static_cast<long long>(b) * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q),  static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),  static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(stats),   static_cast<bf16*>(dq),
               static_cast<bf16*>(dk),       static_cast<bf16*>(dv),
               b, hq, hkv, s, d, causal, window, scale, static_cast<cudaStream_t>(stream)};
  if (d <= 64) return launch<64>(a);
  if (d <= 80) return launch<80>(a);
  if (d <= 96) return launch<96>(a);
  if (d <= 128) return launch<128>(a);
  return launch<256>(a);
}
