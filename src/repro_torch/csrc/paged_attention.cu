// Paged decode attention for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_paged_kernel`): one decode token per row
// against a shared page pool.  Logical page i of row b lives at physical
// page table[b, i] (an entry outside [0, P) reads page 0); positions
// kpos <= lengths[b] are valid (`lengths` holds the row's decode POSITION,
// not a count), and logical pages that start past it are never read.
// Online softmax in fp32, P kept in fp32, output in q's dtype.  Masked
// positions weigh exactly 0 and their K and V are never multiplied in, so
// the trash page (physical page 0, which unmapped entries point at) never
// leaks, whatever it holds.
//
// Bound on this card: the bytes of live KV.  The work is 4 * rep flops per
// 2 * itemsize bytes of K/V (rep = H/K, 1 or 2 in the served models), far
// below the H100's ~295 flop/byte ridge, so tensor cores are of no use and
// the only gain is keeping enough bytes in flight on all 132 SMs.
//
// Design: flash decoding, split over the KV length.
// - The grid is (split, KV head x head group, row): the host picks the
//   number of splits from shapes only (B, K, n_pp and the SM count, see
//   kernels/paged_attention.py:num_splits), never from `lengths`, which
//   lie on the device, so the launch needs no host sync and can be
//   captured in a graph.  A split owns `pps` consecutive logical pages; one
//   whose pages all lie past its row's position writes an empty partial
//   (m = -1e30, l = 0) without reading the pool.
// - One (page, KV head) slab of K, and one of V, is contiguous (ps x hd).
//   A producer warp brings each into shared memory with a 1-D bulk copy
//   (cp.async.bulk, completing on an mbarrier) into a ring of 2-4 stages,
//   so the split's next pages are in flight while the current one is
//   scored.  A slab whose size or address bulk copies cannot take (not a
//   multiple of 16 bytes) is copied by the producer warp's lanes instead,
//   row-padded so that the consumers' reads stay aligned.
// - Four consumer warps score the tokens of each page: a group of G lanes
//   takes one token (G = 16 at hd 128 in bf16, so a warp scores two at
//   once), each lane reading 16 bytes of the K and V rows from shared
//   memory.  The group sums its dot products with shuffles and keeps its
//   running max, sum and output accumulator in registers: no __syncthreads
//   per tile, no shared score matrix.  The rep query heads of a KV group
//   share every K/V slab read (up to 8 per block; more rep means more head
//   groups).
// - The lane groups' partials are merged in shared memory in a fixed order.
//   With one split that is the output.  Otherwise each block writes its
//   partial (m, l, acc) to an fp32 workspace, and the last block of a
//   (row, KV head, head group) to finish — found with an integer atomic
//   counter, which it resets to 0 for the next launch — merges the splits
//   in split order.  The combine adds no launch, and the fixed orders give
//   the same bits on every run (no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kMaxHeads = 8;    // query heads of one block
constexpr int kMaxSplits = 32;  // kernels/paged_attention.py:MAX_SPLITS
constexpr int kRingBytes = 64 * 1024;      // shared memory the ring aims at
constexpr float kNegInf = -1e30f;

template <typename T> struct Storage { using type = float; };
template <> struct Storage<__nv_bfloat16> { using type = unsigned short; };
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float f32_of(float x) { return x; }
__device__ __forceinline__ float f32_of(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// N consecutive elements at p (aligned to N * sizeof(T), or 16) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPiece / (int)sizeof(T);
  using R = typename Raw<kPiece>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    union {
      R r;
      typename Storage<T>::type e[kPer];
    } u;
    u.r = reinterpret_cast<const R*>(p)[c];
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[c * kPer + i] = f32_of(u.e[i]);
  }
}

__device__ __forceinline__ float load_q(const void* q, int q_bf16, size_t i) {
  return q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, int q_bf16, size_t i, float v) {
  if (q_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

struct Args {
  const void* q;         // (B, H, hd), fp32 or bf16 (q_bf16)
  const void* k_pool;    // (P, K, ps, hd)
  const void* v_pool;
  const int* table;      // (B, n_pp)
  const int* lengths;    // (B,)
  void* out;             // (B, H, hd), q's dtype
  float* ws_acc;         // (B, H, n_split, hd) partial accumulators
  float* ws_ml;          // (B, H, n_split, 2) partial (max, sum)
  int* counters;         // (B, K, n_hg) finished splits, left at 0
  int H, K, hd, ps, n_pp, P;
  int n_hg, n_split, pps, stages, ld, bulk, q_bf16;
  float scale;
};

// Merges the splits' partials of one (row, KV head, head group) in split
// order and writes the output.  The splits' weights exp(m_s - m) / l are
// computed once per query head in shared memory; empty splits (l = 0, acc
// written as 0) weigh 0.
__device__ void combine_splits(const Args& a, int b, int head0, int nh, int tid,
                               float (&sw)[kMaxHeads][kMaxSplits]) {
  const size_t bh0 = (size_t)b * a.H + head0;
  for (int i = tid; i < nh * a.n_split; i += kConsumers) {
    const int r = i / a.n_split, s = i - r * a.n_split;
    sw[r][s] = __ldcg(a.ws_ml + ((bh0 + r) * a.n_split + s) * 2);  // m_s, for now
  }
  hopper::named_barrier(1, kConsumers);
  if (tid < nh) {
    const float* ml = a.ws_ml + (bh0 + tid) * a.n_split * 2;
    float m = kNegInf, l = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      if (__ldcg(ml + 2 * s + 1) > 0.f) m = fmaxf(m, sw[tid][s]);
    for (int s = 0; s < a.n_split; ++s) {
      const float ls = __ldcg(ml + 2 * s + 1);
      const float w = ls > 0.f ? expf(sw[tid][s] - m) : 0.f;
      sw[tid][s] = w;
      l += ls * w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int s = 0; s < a.n_split; ++s) sw[tid][s] *= inv;
  }
  hopper::named_barrier(1, kConsumers);
  for (int i = tid; i < nh * a.hd; i += kConsumers) {
    const int r = i / a.hd, d = i - r * a.hd;
    const float* acc = a.ws_acc + (bh0 + r) * a.n_split * a.hd + d;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < a.n_split; ++s) o = fmaf(sw[r][s], __ldcg(acc + (size_t)s * a.hd), o);
    store_out(a.out, a.q_bf16, (bh0 + r) * a.hd + d, o);
  }
}

template <typename TKV, int R, int NPL, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(const Args a) {
  using namespace hopper;
  const int split = blockIdx.x;
  const int kh = blockIdx.y / a.n_hg;
  const int hg = blockIdx.y - kh * a.n_hg;
  const int b = blockIdx.z;
  const int rep = a.H / a.K;
  const int head0 = kh * rep + hg * R;
  const int nh = min(R, rep - hg * R);  // query heads of this group
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // the split's first page ids are loaded alongside the row's position
  const int p_begin = split * a.pps;
  const int n_own = min(a.pps, a.n_pp - p_begin);  // table entries of this split
  const int* tb = a.table + (size_t)b * a.n_pp + p_begin;
  const int phys0 = tid < n_own ? tb[tid] : 0;
  const int pos = a.lengths[b];
  const int n_live = pos < 0 ? 0 : min(a.n_pp, pos / a.ps + 1);
  const int np = min(n_live, p_begin + a.pps) - p_begin;  // pages of this split
  const size_t row_out = (size_t)b * a.H + head0;           // first (b, head)

  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int last;
  __shared__ float sw[kMaxHeads][kMaxSplits];  // the combine's split weights
  const int slab = a.ps * a.ld * (int)sizeof(TKV);  // bytes of one staged slab
  const int slab_pad = (slab + 127) & ~127;
  int* pg = reinterpret_cast<int*>(smem + (size_t)2 * a.stages * slab_pad);
  float* cs = reinterpret_cast<float*>(pg + ((a.pps + 3) & ~3));  // [part][R][ld + 2]

  if (np > 0) {
    for (int i = tid; i < np; i += kThreads) {
      const int phys = i == tid ? phys0 : tb[i];
      pg[i] = (phys < 0 || phys >= a.P) ? 0 : phys;  // never read out of range
    }
    if (tid == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&full[s], a.bulk ? 1 : 32);
        mbar_init(&empty[s], kConsumerWarps);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }

  if (warp == kConsumerWarps) {  // the producer warp
    const TKV* kp = static_cast<const TKV*>(a.k_pool);
    const TKV* vp = static_cast<const TKV*>(a.v_pool);
    for (int i = 0; i < np; ++i) {
      const int s = i % a.stages;
      if (i >= a.stages) mbar_wait(&empty[s], (i / a.stages - 1) & 1);
      const size_t src = ((size_t)pg[i] * a.K + kh) * a.ps * a.hd;
      TKV* sk = reinterpret_cast<TKV*>(smem + (size_t)2 * s * slab_pad);
      TKV* sv = reinterpret_cast<TKV*>(smem + (size_t)(2 * s + 1) * slab_pad);
      if (a.bulk) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * slab);
          bulk_load(sk, kp + src, slab, &full[s]);
          bulk_load(sv, vp + src, slab, &full[s]);
        }
      } else {  // rows padded to ld, the pad zero
        for (int j = lane; j < a.ps * a.ld; j += 32) {
          const int t = j / a.ld, d = j - t * a.ld;
          const bool in = d < a.hd;
          sk[j] = in ? kp[src + (size_t)t * a.hd + d] : TKV(0.f);
          sv[j] = in ? vp[src + (size_t)t * a.hd + d] : TKV(0.f);
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: a group of G lanes scores one token, lane li of the group
  // owning head dims [li * NPL, li * NPL + NPL); each group keeps its own
  // running max, sum and accumulator
  constexpr int kGroups = 32 / G;  // tokens a warp scores per step
  const int gi = lane / G, li = lane % G;
  const int d0 = li * NPL;
  const bool active = d0 < a.ld;
  float qr[R][NPL], acc[R][NPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      acc[r][j] = 0.f;
      qr[r][j] = (r < nh && d0 + j < a.hd)
                     ? load_q(a.q, a.q_bf16, (row_out + r) * a.hd + d0 + j)
                     : 0.f;
    }
  }

  constexpr int kStep = kConsumerWarps * kGroups;  // tokens of one step of all warps
  constexpr int kChunk = kStep >= 16 ? 1 : 16 / kStep;  // steps scored at once
  for (int i = 0; i < np; ++i) {
    const int s = i % a.stages;
    mbar_wait(&full[s], (i / a.stages) & 1);
    const TKV* sk = reinterpret_cast<const TKV*>(smem + (size_t)2 * s * slab_pad);
    const TKV* sv = reinterpret_cast<const TKV*>(smem + (size_t)(2 * s + 1) * slab_pad);
    const int kpos0 = (p_begin + i) * a.ps;
    for (int t0 = warp * kGroups + gi; t0 - gi < a.ps; t0 += kStep * kChunk) {
      float sc[kChunk][R];
      bool ok[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = t0 + c * kStep;
        ok[c] = t < a.ps && kpos0 + t <= pos;  // uniform across the lane group
        float kv[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) kv[j] = 0.f;
        if (ok[c] && active) load_vec<TKV, NPL>(sk + (size_t)t * a.ld + d0, kv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < NPL; ++j) dot = fmaf(qr[r][j], kv[j], dot);
          sc[c][r] = dot;
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = sc[c][r];
#pragma unroll
          for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          sc[c][r] = ok[c] ? x * a.scale : kNegInf;
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) mx = fmaxf(mx, sc[c][r]);
        const float alpha = expf(m[r] - mx);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < NPL; ++j) acc[r][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!ok[c]) continue;  // a masked token's V is never multiplied in
        const int t = t0 + c * kStep;
        float vv[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) vv[j] = 0.f;
        if (active) load_vec<TKV, NPL>(sv + (size_t)t * a.ld + d0, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = expf(sc[c][r] - m[r]);
          l[r] += p;
#pragma unroll
          for (int j = 0; j < NPL; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // merge the lane groups' partials in (warp, group) order
  constexpr int kParts = kConsumerWarps * kGroups;
  const int cw = a.ld + 2;
  if (np > 0) {
    const int part = warp * kGroups + gi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* c = cs + (part * R + r) * cw;
      if (active)
#pragma unroll
        for (int j = 0; j < NPL; ++j) c[d0 + j] = acc[r][j];
      if (li == 0) {
        c[a.ld] = m[r];
        c[a.ld + 1] = l[r];
      }
    }
    named_barrier(1, kConsumers);
  }
  for (int i = tid; i < nh * a.hd; i += kConsumers) {
    const int r = i / a.hd, d = i - r * a.hd;
    float mm = kNegInf, ll = 0.f, o = 0.f;
    if (np > 0) {
      for (int w = 0; w < kParts; ++w) mm = fmaxf(mm, cs[(w * R + r) * cw + a.ld]);
      for (int w = 0; w < kParts; ++w) {
        const float* c = cs + (w * R + r) * cw;
        const float e = expf(c[a.ld] - mm);
        ll += c[a.ld + 1] * e;
        o += c[d] * e;
      }
    }
    if (a.n_split == 1) {
      store_out(a.out, a.q_bf16, (row_out + r) * a.hd + d, o / fmaxf(ll, 1e-30f));
    } else {
      const size_t part = (row_out + r) * a.n_split + split;
      a.ws_acc[part * a.hd + d] = o;
      if (d == 0) {
        a.ws_ml[2 * part] = mm;
        a.ws_ml[2 * part + 1] = ll;  // 0 for an empty split
      }
    }
  }
  if (a.n_split == 1) return;

  // the last split to finish merges them all and resets the counter; the
  // barrier orders the block's partial before thread 0's fence and count
  named_barrier(1, kConsumers);
  if (tid == 0) {
    __threadfence();
    int* cnt = a.counters + ((size_t)b * a.K + kh) * a.n_hg + hg;
    last = atomicAdd(cnt, 1) == a.n_split - 1;
    if (last) {
      *cnt = 0;
      __threadfence();  // the other splits' partials, before the reads below
    }
  }
  named_barrier(1, kConsumers);
  if (!last) return;
  combine_splits(a, b, head0, nh, tid, sw);
}

template <typename TKV, int R, int NPL, int G>
cudaError_t launch_kernel(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kern = paged_decode_split_kernel<TKV, R, NPL, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// (head dims per lane, lanes per token): 16-byte reads, or 32 bytes for
// fp32 past hd 128
template <typename TKV, int R>
cudaError_t launch_r(const Args& a, int npl, int g, dim3 grid, size_t smem, cudaStream_t s) {
#define REPRO_PAGED_CASE(N, GG) \
  if (npl == N && g == GG) return launch_kernel<TKV, R, N, GG>(a, grid, smem, s);
  if constexpr (sizeof(TKV) == 2) {
    REPRO_PAGED_CASE(8, 4)
    REPRO_PAGED_CASE(8, 8)
    REPRO_PAGED_CASE(8, 16)
    REPRO_PAGED_CASE(8, 32)
  } else {
    REPRO_PAGED_CASE(4, 4)
    REPRO_PAGED_CASE(4, 8)
    REPRO_PAGED_CASE(4, 16)
    REPRO_PAGED_CASE(4, 32)
    REPRO_PAGED_CASE(8, 32)
  }
#undef REPRO_PAGED_CASE
  return cudaErrorInvalidValue;
}

template <typename TKV>
cudaError_t launch(Args a, int B, cudaStream_t s) {
  const int rep = a.H / a.K;
  const int itemsize = (int)sizeof(TKV);
  const int npl = (16 / itemsize) * (a.hd > 32 * 16 / itemsize ? 2 : 1);
  if (a.hd > 32 * npl) return cudaErrorInvalidValue;
  int g = 4;  // lanes per token: a power of two covering hd
  while (g * npl < a.hd) g *= 2;
  const int gr = rep < kMaxHeads ? rep : kMaxHeads;
  const int r = gr <= 1 ? 1 : gr <= 2 ? 2 : gr <= 4 ? 4 : 8;  // heads per block
  const bool aligned = reinterpret_cast<uintptr_t>(a.k_pool) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.v_pool) % 16 == 0;
  a.bulk = aligned && (a.ps * a.hd * itemsize) % 16 == 0 && a.hd % npl == 0;
  a.ld = a.bulk ? a.hd : (a.hd + npl - 1) / npl * npl;
  const int slab_pad = (a.ps * a.ld * itemsize + 127) & ~127;
  a.stages = kRingBytes / (2 * slab_pad);
  a.stages = a.stages < 2 ? 2 : a.stages > kMaxStages ? kMaxStages : a.stages;
  const size_t smem = (size_t)2 * a.stages * slab_pad + sizeof(int) * ((a.pps + 3) & ~3) +
                      sizeof(float) * (size_t)kConsumerWarps * (32 / g) * r * (a.ld + 2);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(a.n_split, a.K * a.n_hg, B);
  switch (r) {
    case 1: return launch_r<TKV, 1>(a, npl, g, grid, smem, s);
    case 2: return launch_r<TKV, 2>(a, npl, g, grid, smem, s);
    case 4: return launch_r<TKV, 4>(a, npl, g, grid, smem, s);
    default: return launch_r<TKV, 8>(a, npl, g, grid, smem, s);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  n_split: the splits of each
// row's pages (kernels/paged_attention.py:num_splits); with n_split > 1,
// `workspace` holds B*H*n_split*(hd + 2) floats and `counters` B*K*n_hg
// zeroed ints (n_hg = ceil(rep / 8) head groups), which the kernel leaves
// at zero.  Returns a cudaError_t (0 = ok).
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths, void* out,
                                     int B, int H, int K, int hd, int ps, int n_pp, int P,
                                     float scale, int q_dtype, int kv_dtype, int n_split,
                                     void* workspace, void* counters, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || hd <= 0 || ps <= 0 || n_pp <= 0 || P <= 0 ||
      n_split <= 0 || n_split > n_pp || n_split > kMaxSplits || q_dtype < 0 || q_dtype > 1 ||
      (n_split > 1 && (workspace == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rep = H / K;
  const int gr = rep < kMaxHeads ? rep : kMaxHeads;
  const int r = gr <= 1 ? 1 : gr <= 2 ? 2 : gr <= 4 ? 4 : 8;
  Args a{};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.ws_acc = static_cast<float*>(workspace);
  a.ws_ml = a.ws_acc == nullptr ? nullptr : a.ws_acc + (size_t)B * H * n_split * hd;
  a.counters = static_cast<int*>(counters);
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.ps = ps;
  a.n_pp = n_pp;
  a.P = P;
  a.n_hg = (rep + r - 1) / r;
  a.pps = (n_pp + n_split - 1) / n_split;
  a.n_split = (n_pp + a.pps - 1) / a.pps;
  if (a.n_split != n_split) return (int)cudaErrorInvalidValue;  // a split would own no page
  a.q_bf16 = q_dtype;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return (int)launch<float>(a, B, s);
    case 1: return (int)launch<__nv_bfloat16>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
