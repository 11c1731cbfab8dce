// Flash-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`), forward only: online-softmax
// attention over head-major q (B, H, Sq, hd) and k/v (B, K, Sk, hd), GQA-
// native (query head h reads KV head h / (H/K), no KV repeat in memory),
// causal mask kpos <= qpos aligned top-left, plus the ragged-tail mask
// kpos < Sk.  Accumulates in fp32 and returns q's dtype.
//
// Bound on this card: the causal flops (4*hd per live (q, k) pair) at the
// tensor cores' bf16 rate.  This first version computes with fp32 FMAs on
// the CUDA cores (no mma/wgmma yet), so it runs well below that bound; its
// design is the classic tiled one.  One block of 256 threads per
// (q-tile of 64 rows, head, batch row) loops over 64-row KV tiles staged in
// shared memory (fp32, K padded to dodge bank conflicts).  KV tiles wholly
// above the diagonal are skipped; the diagonal tile and the ragged tail are
// masked per position with exactly-zero weights.  Each thread owns a 4x4
// block of the score tile and a 4 x hd/16 block of the accumulator in
// registers; the running max and denominator per row live in shared memory.
// Blocks are launched heaviest-first (the last q-tiles see the most KV).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kBQ * HD + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out,  // (B, H, Sq, HD) contiguous
    int H, int K, int Sq, int Sk, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int causal, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KSTR = HD + 1;
  constexpr int SSTR = kBK + 1;
  constexpr int DPT = HD / 16;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q-tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x HD
  float* Ks = Qs + kBQ * HD;        // kBK x KSTR
  float* Vs = Ks + kBK * KSTR;      // kBK x HD
  float* Ss = Vs + kBK * HD;        // kBQ x SSTR (scores, then weights)
  float* m = Ss + kBQ * SSTR;       // running max per row
  float* l = m + kBQ;               // running denominator per row
  float* alpha = l + kBQ;           // this tile's rescale per row

  const int q0 = qt * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int qp = q0 + r;
    Qs[i] = qp < Sq ? to_f32(qb[qp * qss + d]) : 0.f;
  }
  if (tid < kBQ) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed; Q and m/l are visible
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i - c * HD;
      const int kp = k0 + c;
      const bool ok = kp < Sk;
      Ks[c * KSTR + d] = ok ? to_f32(kb[kp * kss + d]) : 0.f;
      Vs[i] = ok ? to_f32(vb[kp * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < Sk && (!causal || kp <= qp);
        Ss[r * SSTR + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // row statistics: warp w owns rows 8w..8w+7, lanes split the 64 columns
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = Ss + r * SSTR;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = (x0 <= kNegInf) ? 0.f : expf(x0 - m_new);
      const float p1 = (x1 <= kNegInf) ? 0.f : expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * SSTR + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (((size_t)b * H + h) * Sq + qp) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int K, int Sq, int Sk, const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, K, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int K, int Sq, int Sk, int hd, const long long* st, int causal,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, Sq, Sk, st, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, Sq, Sk, st, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, Sq, Sk, st, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, Sq, Sk, st, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides are in elements, in the order q(b, h, s), k(b, h, s), v(b, h, s);
// the head dim is contiguous.  dtype codes: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = ok).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int H, int K, int Sq, int Sk, int hd,
                                     long long qsb, long long qsh, long long qss,
                                     long long ksb, long long ksh, long long kss,
                                     long long vsb, long long vsh, long long vss, int causal,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, out, B, H, K, Sq, Sk, hd, st, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Sk, hd, st, causal,
                                           scale, s);
  return (int)cudaErrorInvalidValue;
}
