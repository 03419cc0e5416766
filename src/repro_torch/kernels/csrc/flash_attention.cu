// Blockwise (flash) grouped-query attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, `_flash_kernel`) for every f32 call
// and for bf16 calls with D % 8 != 0; bf16 with D % 8 == 0 and D <= 256
// takes the tensor-core kernel of `flash_attention_tc.cu`.  Semantics of
// record: `repro_torch.kernels.ref.mha_attention`.
//
// q (B, Hq, S, D), k and v (B, Hkv, S, D), contiguous, f32 or bf16; out
// (B, Hq, S, D) in q's type.  Query head h reads KV head h / (Hq / Hkv):
// K and V are never repeated in memory.  Logits scale * q.k in f32; a key
// is visible to a query when k < S, and k <= q (causal), and k > q - window
// (window > 0).  Online softmax with a running max m and normaliser l per
// row; the output is acc / max(l, 1e-30), rounded once to q's type.
//
// Layout: one block of 256 threads per (64-query tile, q head, batch).  It
// stages its Q tile once and loops over the 64-key tiles in order, skipping
// whole tiles past the sequence end, above the diagonal (causal) and left
// of the window, as `_flash_kernel` does.  Q, K and V tiles sit in shared
// memory in the input type, their D columns zero-padded to DMAX (64, 128 or
// 256: the smallest that holds D), so any D up to 256 and any S are taken
// with no padding in device memory.  Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16 i (i < 4): for the logits the keys tx + 16 j
// (j < 4), for the output the columns 4 tx + 64 c + e.  The 16 threads of
// a row are one half-warp, so row max and row sum are four xor shuffles,
// and every thread holds its rows' m and l.  The probabilities go through
// a 64 x 64 f32 tile in shared memory to the P.V product.  Row strides are
// padded so that the column reads of K and the row reads of P hit no bank
// conflicts.
//
// Masking uses -inf with an explicit guard: a row whose visited keys are
// all masked so far (a window tile left of the row's first key) keeps
// m = -inf, its probabilities are exp(-inf) = 0 and its correction factor
// is 0, so no NaN arises, and a row with no visible key at all ends as 0.
//
// What bounds it on the H100: operations.  A causal prefill does about
// 2 B Hq S^2 D multiply-adds against (2 B Hq + 2 B Hkv) S D elements: at
// qwen3-32b's (4, 64/8, 2048, 128) 2.75e11 flops and 302 MB in bf16.  This
// first version runs the products as f32 FMAs from shared memory (each
// thread a 4 x 4 logit tile, two FMAs per loaded element at least), not
// on the tensor cores: its ceiling is the 67 TFLOP/s f32 rate, some 15x
// under the bf16 tensor-core bound.  The bf16 calls that fit `wgmma`'s
// shapes go to `flash_attention_tc.cu` instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // queries a block
constexpr int kBK = 64;             // keys a tile
constexpr int kThreads = 256;
constexpr int kPad = 4;             // Q/K row padding, elements
constexpr int kPStride = kBK + 16;  // P row stride, floats

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive shared-memory elements as f32 (16-byte aligned for f32,
// 8-byte aligned for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// rows [row0, row0 + 64) of an (S, D) slice into a [64][stride] tile, rows
// past S and columns past D as zeros
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(T* dst, int stride, const T* __restrict__ src, int row0,
                                          int s, int d) {
  const T zero = from_f32<T>(0.0f);
  for (int e = threadIdx.x; e < kBQ * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    const int row = row0 + r;
    dst[r * stride + c] = (row < s && c < d) ? src[static_cast<long long>(row) * d + c] : zero;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int hkv, int s, int d, int causal, int window,
                 float scale) {
  constexpr int kQS = DMAX + kPad;    // Q and K row stride
  constexpr int kCols = DMAX / 64;    // float4 output groups a thread owns per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBQ * kQS;
  T* vs = ks + kBK * kQS;
  float* ps = reinterpret_cast<float*>(vs + kBK * DMAX);

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qb = q + (static_cast<long long>(b) * hq + h) * s * d;
  const T* kb = k + (static_cast<long long>(b) * hkv + hk) * s * d;
  const T* vb = v + (static_cast<long long>(b) * hkv + hk) * s * d;
  T* ob = o + (static_cast<long long>(b) * hq + h) * s * d;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q_first = blockIdx.x * kBQ;
  const int q_last = min(q_first + kBQ, s) - 1;

  // the key tiles any row of this block can see
  int kj_lo = 0, kj_hi = (s - 1) / kBK;
  if (causal) kj_hi = min(kj_hi, q_last / kBK);
  if (window > 0 && q_first - window + 1 > 0) kj_lo = (q_first - window + 1) / kBK;

  load_tile<T, DMAX>(qs, kQS, qb, q_first, s, d);

  float acc[4][4 * kCols];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kj = kj_lo; kj <= kj_hi; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();                  // the previous tile's P.V is done with ks, vs, ps
    load_tile<T, DMAX>(ks, kQS, kb, k0, s, d);
    load_tile<T, DMAX>(vs, DMAX, vb, k0, s, d);
    __syncthreads();

    // logits: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DMAX; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty + 16 * i) * kQS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(ks + (tx + 16 * j) * kQS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q_first + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < s;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // nothing visible yet
      const float corr = expf(m_run[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);
        ps[row * kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * corr + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P (64 x 64) . V (64 x DMAX): rows ty + 16 i, columns 4 tx + 64 c + e
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = load4(vs + kk * DMAX + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] = fmaf(p[i], vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(p[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(p[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(p[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_first + ty + 16 * i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < d) ob[static_cast<long long>(qpos) * d + col] = from_f32<T>(acc[i][4 * c + e] / denom);
      }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int s,
           int d, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = (2 * kBQ * (DMAX + kPad) + kBK * DMAX) * sizeof(T) +
                      static_cast<size_t>(kBQ) * kPStride * sizeof(float);
  static bool attr_set = false;     // once per instantiation: above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int s,
             int d, int causal, int window, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, hq, hkv, s, d, causal, window, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, b, hq, hkv, s, d, causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, b, hq, hkv, s, d, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike).  1 <= d <= 256,
// hq % hkv == 0, b and hq at most 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int b,
                                      int hq, int hkv, int s, int d, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || d <= 0 || d > 256 ||
      window < 0 || b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, b, hq, hkv, s, d, causal, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
