// GQA attention over a paged KV pool, one query row block per thread block.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * paged_decode_attention_pallas  (src/repro/kernels/decode_attention/kernel.py,
//     _paged_kernel): one query per slot, entry point paged_decode_attention;
//   * paged_prefill_attention_pallas (same file, _paged_prefill_kernel): S
//     queries per slot at positions pos..pos+S-1, entry point
//     paged_prefill_attention.
// Both compute, for every (slot b, KV head h), the rows r = j*G + g (query j,
// group member g of the G = Hq/Hkv query heads that share KV head h) against
// the slot's pages in logical order, with an online softmax across pages in
// fp32: scores are scaled by 1/sqrt(D), softcapped (c*tanh(s/c), c > 0) and
// then masked causally per row (key position <= pos+j) and by the sliding
// window (pos+j - key < window, window > 0).  Masked scores are -3e38 and
// contribute exactly 0; the output is acc / max(l, 1e-30), written in q's
// element type.  Unmapped table entries (-1) are clamped to page 0.
//
// What bounds it on an H100: decode reads every live KV byte once for G
// multiply-adds per element (G = 6 for qwen2), far below the ~295 flop/byte
// ridge, so it is bound by the bytes of the live pages.  Prefill reuses each
// page for S*G rows: at small S it is bound by bytes, at large S (S*G beyond
// a few hundred rows in bf16) by operations.
//
// What this simple design does about it: a block loops ONLY over the live
// pages of its deepest row, min((pos + j_last) / P + 1, MP), so dead tail
// pages are never read; one block carries all G query heads of a KV head,
// so each page is read once per group, not once per query head; the TPU
// kept the whole (S*G, D) query block resident, which does not fit a
// Hopper SM at S = 256, so prefill rows are tiled across blocks
// (b, kv-head, row tile) and each tile stops at its own deepest live page.
// Each page's K and V are staged in shared memory as fp32 (rows padded by
// one word against bank conflicts), scores and the accumulator stay in
// shared memory.  No tensor cores, TMA or split-K yet: those are for the
// PRs that make it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNeg = -3.0e38f;
constexpr int kThreads = 128;
constexpr int kRowTile = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Python's floor division (a // b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// q/out: (B, S, Hq, D); pages: (N, P, Hkv, D); table: (B, MP); pos: (B,).
// grid = (B * Hkv, ceil(S*G / row_tile)), block = kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out, int S, int Hq,
                       int Hkv, int D, int P, int MP, int row_tile, int window,
                       float softcap, float scale) {
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int r0 = blockIdx.y * row_tile;
  const int nr = min(row_tile, S * G - r0);
  const int Dp = D + 1;

  extern __shared__ float smem[];
  float* qs = smem;                   // nr x Dp   query rows
  float* ks = qs + row_tile * Dp;     // P x Dp    one page of K
  float* vs = ks + P * Dp;            // P x Dp    one page of V
  float* ss = vs + P * Dp;            // nr x P    scores, then probabilities
  float* acc = ss + row_tile * P;     // nr x D    output accumulator
  float* m_s = acc + row_tile * D;    // nr        running max
  float* l_s = m_s + row_tile;        // nr        running denominator
  float* a_s = l_s + row_tile;        // nr        this page's rescale factor

  const int tid = threadIdx.x;
  const int p0 = pos[b];

  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i % D;
    const int r = r0 + rr;
    const size_t off = (((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d;
    qs[rr * Dp + d] = to_f32(q[off]);
    acc[i] = 0.f;
  }
  for (int rr = tid; rr < nr; rr += blockDim.x) {
    m_s[rr] = kNeg;
    l_s[rr] = 0.f;
  }
  // the tile's deepest row attends through page (pos + j_last) // P
  const int j_last = (r0 + nr - 1) / G;
  const int live = min(floor_div(p0 + j_last, P) + 1, MP);
  __syncthreads();

  for (int pi = 0; pi < live; ++pi) {
    const int phys = max(table[(size_t)b * MP + pi], 0);
    for (int i = tid; i < P * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)phys * P + t) * Hkv + h) * D + d;
      ks[t * Dp + d] = to_f32(k_pages[off]);
      vs[t * Dp + d] = to_f32(v_pages[off]);
    }
    __syncthreads();

    for (int i = tid; i < nr * P; i += blockDim.x) {
      const int rr = i / P, t = i % P;
      const float* qr = qs + rr * Dp;
      const float* kr = ks + t * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int qpos = p0 + (r0 + rr) / G;
      ss[i] = visible(qpos, pi * P + t, window) ? s : kNeg;
    }
    __syncthreads();

    for (int rr = tid; rr < nr; rr += blockDim.x) {
      const int qpos = p0 + (r0 + rr) / G;
      float* sr = ss + rr * P;
      float mx = kNeg;
      for (int t = 0; t < P; ++t) mx = fmaxf(mx, sr[t]);
      const float m_prev = m_s[rr];
      const float m_cur = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_cur);
      float sum = 0.f;
      for (int t = 0; t < P; ++t) {
        const float p = visible(qpos, pi * P + t, window) ? expf(sr[t] - m_cur) : 0.f;
        sr[t] = p;
        sum += p;
      }
      m_s[rr] = m_cur;
      l_s[rr] = l_s[rr] * alpha + sum;
      a_s[rr] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += blockDim.x) {
      const int rr = i / D, d = i % D;
      const float* pr = ss + rr * P;
      float o = acc[i] * a_s[rr];
      for (int t = 0; t < P; ++t) o = fmaf(pr[t], vs[t * Dp + d], o);
      acc[i] = o;
    }
    __syncthreads();  // K/V and scores are overwritten by the next page
  }

  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i % D;
    const int r = r0 + rr;
    const size_t off = (((size_t)b * S + r / G) * Hq + h * G + r % G) * D + d;
    out[off] = from_f32<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* table,
           const void* pos, void* out, int B, int S, int Hq, int Hkv, int D, int P,
           int MP, int window, float softcap, void* stream) {
  const int rows = S * (Hq / Hkv);
  const int row_tile = rows < kRowTile ? rows : kRowTile;
  const size_t smem = sizeof(float) * ((size_t)row_tile * (D + 1) + 2 * (size_t)P * (D + 1) +
                                       (size_t)row_tile * P + (size_t)row_tile * D +
                                       3 * (size_t)row_tile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * Hkv, (rows + row_tile - 1) / row_tile);
  paged_attention_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, (const int*)table,
      (const int*)pos, (T*)out, S, Hq, Hkv, D, P, MP, row_tile, window, softcap,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* k_pages, const void* v_pages,
             const void* table, const void* pos, void* out, int B, int S, int Hq, int Hkv,
             int D, int P, int MP, int window, float softcap, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, pos, out, B, S, Hq, Hkv, D, P, MP,
                         window, softcap, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, pos, out, B, S, Hq, Hkv, D,
                                 P, MP, window, softcap, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* pos, void* out, int B, int Hq, int Hkv,
                                      int D, int P, int MP, int window, float softcap,
                                      int dtype, void* stream) {
  return dispatch(dtype, q, k_pages, v_pages, table, pos, out, B, 1, Hq, Hkv, D, P, MP,
                  window, softcap, stream);
}

extern "C" int paged_prefill_attention(const void* q, const void* k_pages,
                                       const void* v_pages, const void* table,
                                       const void* pos, void* out, int B, int S, int Hq,
                                       int Hkv, int D, int P, int MP, int window,
                                       float softcap, int dtype, void* stream) {
  return dispatch(dtype, q, k_pages, v_pages, table, pos, out, B, S, Hq, Hkv, D, P, MP,
                  window, softcap, stream);
}
