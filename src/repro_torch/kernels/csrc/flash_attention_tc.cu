// Blockwise (flash) grouped-query attention, forward, bf16 on Hopper's tensor
// cores (sm_90a): wgmma for both products, TMA for every tile.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, `_flash_kernel`) for bf16 inputs
// with D % 8 == 0 and 8 <= D <= 256; every other call (f32, or bf16 with
// D % 8 != 0) takes the f32-FMA kernel of `flash_attention.cu`.  Semantics
// of record: `repro_torch.kernels.ref.mha_attention`.
//
// q (B, Hq, S, D), k and v (B, Hkv, S, D), contiguous bf16; out (B, Hq, S, D)
// bf16.  Query head h reads KV head h / (Hq / Hkv).  Logits scale * q.k in
// f32; a key is visible to a query when k < S, and k <= q (causal), and
// k > q - window (window > 0).  Online softmax with a running max m and
// normaliser l per row; the output is O / max(l, 1e-30), rounded once to
// bf16.  When `lse` is not null (the training path's forward), each row's
// logsumexp of its scaled logits goes there too, (B, Hq, S) f32 in natural
// units: (m + log2 l) ln 2 from the finalize's m and l, which are in log2
// units; the backward (flash_attention_bwd.cu) reads it.  Prefill passes
// null and writes nothing more.
//
// What bounds it on the H100: bf16 tensor-core operations.  A causal prefill
// at qwen3-32b's (4, 64/8, 2048, 128) does 2.75e11 flops of Q.K^T and P.V
// (0.278 ms at 989 TFLOP/s) against 302 MB of q, k, v and out (0.090 ms at
// 3.35 TB/s); recurrentgemma's local attention (4, 10/1, 2048, 256) does
// 8.59e10 flops (0.0869 ms) against 92 MB (0.0276 ms).  This kernel issues
// P.V twice (below), so its tensor-core work is 1.5x the algorithm's: a
// ceiling of 0.417 and 0.130 ms.
//
// Design.  One block per (128-query tile, q head, batch), the query tiles
// launched last-first so that the longest causal rows start first; the
// q heads of one KV head are neighbours in the grid, so their K and V tiles
// meet in L2 (recurrentgemma's ten q heads read one K/V stream).  Two
// consumer warpgroups own 64 query rows each (wgmma's M); one thread of a
// producer warpgroup issues TMA loads: the Q tile once, then K and V tiles
// of BK keys through a ring of 2 stages, each stage with a full barrier for
// K, one for V and an empty barrier that all 256 consumer threads arrive on.
// `setmaxnreg` moves registers from the producer (24 a thread) to the
// consumers (240): 128 x 24 + 256 x 240 is the 384 x 168 the block starts
// with (with a lone producer warp the increase never returns).
// Tiles land in shared memory with the 128-byte swizzle, in column blocks of
// 64 (one 128-byte row each): the tensor maps are of rank 3, (D, S, B * H)
// innermost first, so rows past S and columns past D are zero-filled by the
// TMA unit and never read from the next head.  D is padded to DP = 64, 128
// or 256 in shared memory only (D = 136-248 runs as 256).
//   S = Q.K^T: wgmma m64nBKk16, Q and K from shared memory, both K-major, f32
//   accumulators in registers (bf16 products are exact in f32).  The mask is
//   applied only on tiles that cross the diagonal, the window's left edge or
//   S; whole tiles outside every row of a warpgroup are skipped.  A row's
//   values sit in a quad of the accumulator layout: its max and sum are two
//   xor shuffles.  Each logit is multiplied by scale * log2(e) before the
//   mask and the max, as in the FMA kernel, so exp2f serves and the max is
//   right for a scale of any sign, 0 included.  m = -inf is guarded
//   (a row with nothing visible yet shifts by 0), so a window narrower than
//   a tile adds exp2(-inf) = 0 and a correction of 0, never NaN.
//   O += P.V: wgmma m64nDPk16; the accumulator layout of S is the A-operand
//   layout of wgmma with A in registers, so P never goes through shared
//   memory.  One bf16 rounding of P puts the output outside the card check
//   (rtol 2^-8, atol 1e-4 against the f32 plain version;
//   tests/test_torch_flash_split.py emulates both roundings), so P is split,
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both products go into the
//   one f32 accumulator; V is an MN-major B.  l sums the f32 probabilities.
//   A warpgroup runs S, the softmax and P.V of a tile in turn; the other
//   warpgroup's products fill the tensor cores meanwhile.
//   Epilogue: rows < S and columns < D only, stored from registers (a TMA
//   store would cross into the next head).
// The key tile BK follows the registers a consumer thread holds across a
// tile: O (64 x DP f32 over 128 threads, DP / 2), S (BK / 2) and the two
// bf16 halves of P (BK / 4 each), within setmaxnreg's 240.
//   DP <= 128, BK = 128: 64 + 64 + 32 + 32 = 192 at DP = 128.  Shared memory:
//     Q 32 KB, 2 stages of K and V at 32 KB each: 160 KB.
//   DP = 256, BK = 64: O alone is 128; with BK = 128 the tile would need
//     128 + 64 + 32 + 32 = 256 and spill, so the key tile halves: 128 + 32 +
//     16 + 16 = 192.  S is m64n64k16 (16 a tile), P.V one m64n256k16 for
//     each 16 keys and half of P (8 a tile).  Shared memory: Q 64 KB, a K or
//     V stage 32 KB, 2 stages of each 128 KB, 192 KB in all with the
//     barriers and 1 KB of alignment, one block an SM (3 stages would need
//     256 KB, past the 227 KB a block can use).
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;                  // queries a block
constexpr int kConsumers = 256;           // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup: one thread loads
constexpr int kRowBytes = 128;            // one swizzled row: 64 bf16 columns
constexpr int kStages = 2;                // K/V tiles in flight

template <int DP, int BK>
struct Layout {
  static constexpr int kColBlocks = DP / 64;
  static constexpr uint32_t kQBytes = kColBlocks * kBQ * kRowBytes;
  static constexpr uint32_t kTileBytes = kColBlocks * BK * kRowBytes;   // one K or V stage
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;          // q, k[], v[], empty[]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr uint32_t kAlloc = kBytes + 1024;                    // base aligned up to 1 KB
};

// S = Q . K^T (64 x BK, f32) for one warpgroup's rows, issued and committed
template <int DP, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;      // 16 columns = 32 bytes
    const uint64_t da = smem_desc(q_rows + (kk / 4) * kBQ * kRowBytes + off, 16, 1024);
    const uint64_t db = smem_desc(k_tile + (kk / 4) * BK * kRowBytes + off, 16, 1024);
    wgmma_ss<BK>(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P_hi . V + P_lo . V, issued and committed; V (BK x DP) is an MN-major B
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = smem_desc(v_tile + kk * 16 * kRowBytes, BK * kRowBytes, 1024);
    wgmma_rs<DP>(acc, p_hi[kk], db);
    wgmma_rs<DP>(acc, p_lo[kk], db);
  }
  wgmma_commit();
}

// Where this thread's logits sit: rows `row` (h = 0) and `row` + 8 (h = 1),
// columns col0 + {0, 1} of every 8; the mask and the softmax's constants.
struct RowView {
  int row, col0, s, causal, window;
  float scale_log2;
};

// mask (when `masked`), the online-softmax update of m and l, and the
// probabilities split into the two bf16 A fragments of P.V.  `corr` is the
// factor that carries O to the new row max.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], const RowView& rv, int k0,
                                        bool masked, float (&m_run)[2], float (&l_run)[2],
                                        float (&corr)[2], uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
  // scaled before the mask and the max, in log2 units: right for any sign of scale
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] *= rv.scale_log2;
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + 8 * (i / 4) + rv.col0 + (i % 2);
      const int qpos = rv.row + 8 * ((i / 2) % 2);
      bool ok = kpos < rv.s;
      if (rv.causal) ok = ok && kpos <= qpos;
      if (rv.window > 0) ok = ok && kpos > qpos - rv.window;
      if (!ok) sc[i] = -INFINITY;
    }
  }
  // a row's values sit in one quad of lanes
  float m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    m_use[h] = m_new == -INFINITY ? 0.0f : m_new;           // nothing visible yet
    corr[h] = exp2f(m_run[h] - m_use[h]);
    m_run[h] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // A-fragment register r of k-slice kk holds accumulator pair 8 kk + 2 r
      const int i = 8 * kk + 2 * r, h = r % 2;
      const float p0 = exp2f(sc[i] - m_use[h]);
      const float p1 = exp2f(sc[i + 1] - m_use[h]);
      rs[h] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][r] = pack_bf16(hi);
      p_lo[kk][r] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + rs[h];
}

// DP: the head dim padded to 64, 128 or 256; BK: keys a K/V tile
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int hq, int hkv, int s, int d, int causal,
                    int window, float scale_log2) {
  using L = Layout<DP, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages, bar_e = bar_v + 8 * kStages;

  const int bh = blockIdx.x;                              // b * Hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kBQ; // the longest causal rows first
  const int q_last = min(q_first + kBQ, s) - 1;

  // the key tiles any row of this block can see
  int kj_lo = 0, kj_hi = (s - 1) / BK;
  if (causal) kj_hi = min(kj_hi, q_last / BK);
  if (window > 0 && q_first - window + 1 > 0) kj_lo = (q_first - window + 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kColBlocks; ++c)
        tma_load(sq + c * kBQ * kRowBytes, &tm_q, bar_q, 64 * c, q_first, bh);
      int st = 0;
      uint32_t phase = 0;
      for (int kj = kj_lo; kj <= kj_hi; ++kj) {
        mbar_wait(bar_e + 8 * st, phase ^ 1);   // the consumers are done with this stage
        mbar_expect_tx(bar_k + 8 * st, L::kTileBytes);
        for (int c = 0; c < L::kColBlocks; ++c)
          tma_load(sk + st * L::kTileBytes + c * BK * kRowBytes, &tm_k, bar_k + 8 * st, 64 * c,
                   kj * BK, kvh);
        mbar_expect_tx(bar_v + 8 * st, L::kTileBytes);
        for (int c = 0; c < L::kColBlocks; ++c)
          tma_load(sv + st * L::kTileBytes + c * BK * kRowBytes, &tm_v, bar_v + 8 * st, 64 * c,
                   kj * BK, kvh);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = q_first + 64 * wg, r1 = r0 + 63;          // this warpgroup's rows
    const int row = r0 + 16 * warp + lane / 4;               // this thread's rows: row, row + 8
    const RowView rv{row, 2 * (lane % 4), s, causal, window, scale_log2};
    const uint32_t q_rows = sq + 64 * wg * kRowBytes;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};   // l: this thread's part
    float sc[BK / 2], corr[2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];

    mbar_wait(bar_q, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int kj = kj_lo; kj <= kj_hi; ++kj) {
      const int k0 = kj * BK;
      // a warpgroup waits for every stage it passes, skipped or not, so that
      // its arrival counts toward the phase of that stage's load and no other
      mbar_wait(bar_k + 8 * st, phase);
      if (r0 < s && (!causal || k0 <= min(r1, s - 1)) &&
          (window == 0 || k0 + BK - 1 > r0 - window)) {       // some row of ours sees the tile
        hold(sc);
        wgmma_fence();
        issue_qk<DP, BK>(sc, q_rows, sk + st * L::kTileBytes);
        wgmma_wait_all();
        hold(sc);
        const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > r0) ||
                            (window > 0 && k0 <= r1 - window);
        softmax<BK>(sc, rv, k0, masked, m_run, l_run, corr, p_hi, p_lo);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i / 2) % 2];
        mbar_wait(bar_v + 8 * st, phase);
        hold(acc);
        wgmma_fence();
        issue_pv<DP, BK>(acc, p_hi, p_lo, sv + st * L::kTileBytes);
        wgmma_wait_all();
        hold(acc);
        hold(p_hi);
        hold(p_lo);
      }
      mbar_arrive(bar_e + 8 * st);
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }

    // epilogue: O / max(l, 1e-30), rows < S and columns < D; the logsumexp
    float denom[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[h] = fmaxf(l, 1e-30f);
      const int qpos = row + 8 * h;
      if (lse != nullptr && lane % 4 == 0 && qpos < s)     // one lane of the row's quad
        lse[static_cast<long long>(bh) * s + qpos] = (m_run[h] + log2f(l)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      if (qpos >= s) continue;
      __nv_bfloat16* orow = o + (static_cast<long long>(bh) * s + qpos) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + rv.col0;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[4 * j + 2 * h] / denom[h], acc[4 * j + 2 * h + 1] / denom[h]);
      }
    }
  }
}

// ---- host side ----

template <int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int hq,
           int hkv, int s, int d, int causal, int window, float scale, cudaStream_t stream) {
  using L = Layout<DP, BK>;
  static_assert(L::kAlloc <= 232448, "above the 227 KB a block can use");
  static bool attr_set = false;     // once per instantiation: above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<DP, BK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(L::kAlloc));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, b * hq, s, d, kBQ) ||
      !make_map(encode, &tm_k, k, b * hkv, s, d, BK) ||
      !make_map(encode, &tm_v, v, b * hkv, s, d, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<DP, BK><<<grid, kThreads, L::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, hq, hkv, s, d, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out; 8 <= d <= 256 with d % 8 == 0, hq % hkv == 0, b * hq
// below 2^31, 16-byte aligned pointers (the tensor maps refuse others).  `lse`
// is null, or (B, Hq, S) f32 for each row's logsumexp.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                                         int b, int hq, int hkv, int s, int d, int causal,
                                         int window, float scale, void* lse, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || d < 8 || d > 256 ||
      d % 8 != 0 || window < 0 || static_cast<long long>(b) * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d <= 64) return launch<64, 128>(q, k, v, o, l, b, hq, hkv, s, d, causal, window, scale, st);
  if (d <= 128)
    return launch<128, 128>(q, k, v, o, l, b, hq, hkv, s, d, causal, window, scale, st);
  return launch<256, 64>(q, k, v, o, l, b, hq, hkv, s, d, causal, window, scale, st);
}
