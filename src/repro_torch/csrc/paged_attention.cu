// Paged decode attention for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_paged_kernel`): one decode token per row
// against a shared page pool.  Logical page i of row b lives at physical
// page table[b, i]; positions kpos <= lengths[b] are valid (`lengths` holds
// the row's decode POSITION, not a count), and logical pages that start
// past it are never read.  The H/K query heads of one KV group share one
// page stream, so each live page is read from device memory once per group.
//
// Bound on this card: the bytes of live KV (the work is 4*rep*hd flops per
// 2*hd*itemsize bytes of K/V — far below the H100's ~295 flop/byte ridge).
// Design: one thread block per (row, KV head) walks the row's live pages in
// tiles of ~32 token positions.  The block loads its own page ids from the
// table (the TPU kernel prefetched them as scalars), stages the tile's K and
// V in shared memory as fp32, scores it warp-per-(query row, token), and
// keeps the online softmax (m, l) and the accumulator in fp32 shared memory.
// Masked positions get exactly zero weight, so the trash page (physical page
// 0, which unmapped table entries point at) never leaks into the output.
// Simple and correct first: no split over pages, no TMA, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 32;  // token positions staged per tile (>= 1 page)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,          // (B, H, hd)
    const TKV* __restrict__ k_pool,    // (P, K, ps, hd)
    const TKV* __restrict__ v_pool,    // (P, K, ps, hd)
    const int* __restrict__ table,     // (B, n_pp) physical page ids
    const int* __restrict__ lengths,   // (B,) decode position per row
    TQ* __restrict__ out,              // (B, H, hd)
    int H, int K, int hd, int ps, int n_pp, int P, int tile_pages, float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int rep = H / K;
  const int head0 = kh * rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_tok = tile_pages * ps;

  extern __shared__ float smem[];
  float* qs = smem;                   // rep * hd
  float* acc = qs + rep * hd;         // rep * hd
  float* ks = acc + rep * hd;         // tile_tok * hd
  float* vs = ks + tile_tok * hd;     // tile_tok * hd
  float* sc = vs + tile_tok * hd;     // rep * tile_tok (scores, then weights)
  float* m = sc + rep * tile_tok;     // rep running max
  float* l = m + rep;                 // rep running denominator
  float* alpha = l + rep;             // rep rescale of this tile
  int* pg = reinterpret_cast<int*>(alpha + rep);  // tile_pages physical ids

  const int pos = lengths[b];
  const int n_live = pos < 0 ? 0 : min(n_pp, pos / ps + 1);

  for (int i = tid; i < rep * hd; i += kThreads) {
    qs[i] = to_f32(q[((size_t)b * H + head0) * hd + i]);
    acc[i] = 0.f;
  }
  if (tid < rep) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }

  for (int p0 = 0; p0 < n_live; p0 += tile_pages) {
    const int np = min(tile_pages, n_live - p0);
    const int ntok = np * ps;
    __syncthreads();  // the previous tile is consumed; init is visible
    if (tid < np) {
      const int phys = table[(size_t)b * n_pp + p0 + tid];
      pg[tid] = (phys < 0 || phys >= P) ? 0 : phys;  // never read out of range
    }
    __syncthreads();
    for (int i = tid; i < ntok * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int pp = t / ps;
      const size_t src = (((size_t)pg[pp] * K + kh) * ps + (t - pp * ps)) * hd + d;
      ks[i] = to_f32(k_pool[src]);
      vs[i] = to_f32(v_pool[src]);
    }
    __syncthreads();

    // scores: one warp per (query row, token), lanes split the head dim
    for (int j = warp; j < rep * ntok; j += kWarps) {
      const int r = j / ntok;
      const int t = j - r * ntok;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += qs[r * hd + d] * ks[t * hd + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int kpos = p0 * ps + t;
        sc[r * tile_tok + t] = (kpos <= pos) ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax bookkeeping: one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, sc[r * tile_tok + t]);
      mx = warp_max(mx);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float s = sc[r * tile_tok + t];
        const float p = (s <= kNegInf) ? 0.f : expf(s - m_new);
        sc[r * tile_tok + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; each (row, dim) is owned by one thread
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = sc + r * tile_tok;
      float s = acc[i] * alpha[r];
      for (int t = 0; t < ntok; ++t) s += pr[t] * vs[t * hd + d];
      acc[i] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd;
    out[((size_t)b * H + head0) * hd + i] = from_f32<TQ>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
                   const void* lengths, void* out, int B, int H, int K, int hd, int ps,
                   int n_pp, int P, float scale, cudaStream_t stream) {
  const int tile_pages = ps >= kTileTokens ? 1 : kTileTokens / ps;
  const int tile_tok = tile_pages * ps;
  const int rep = H / K;
  const size_t smem = sizeof(float) * (size_t)(2 * rep * hd + 2 * tile_tok * hd +
                                               rep * tile_tok + 3 * rep) +
                      sizeof(int) * (size_t)tile_pages;
  auto kern = paged_decode_kernel<TQ, TKV>;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, K), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), H, K, hd, ps, n_pp, P,
      tile_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok).
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths, void* out,
                                     int B, int H, int K, int hd, int ps, int n_pp, int P,
                                     float scale, int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || hd <= 0 || ps <= 0 || n_pp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = q_dtype * 2 + kv_dtype;
  switch (code) {
    case 0:
      return (int)launch<float, float>(q, k_pool, v_pool, table, lengths, out, B, H, K, hd,
                                       ps, n_pp, P, scale, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, B, H,
                                               K, hd, ps, n_pp, P, scale, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, lengths, out, B, H,
                                               K, hd, ps, n_pp, P, scale, s);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table, lengths,
                                                       out, B, H, K, hd, ps, n_pp, P, scale,
                                                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
