// Flash-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`), forward only: online-softmax
// attention over head-major q (B, H, Sq, hd) and k/v (B, K, Sk, hd), GQA-
// native (query head h reads KV head h / (H/K), no KV repeat in memory),
// causal mask kpos <= qpos aligned top-left, plus the ragged-tail mask
// kpos < Sk.  Accumulates in fp32 and returns q's dtype.  q, k and v may be
// strided views (the model passes transposes of (B, S, heads, hd)).  Where
// the caller asks (training), it also writes each query row's log-sum-exp
// of its scaled scores, which the backward (flash_attention_bwd.cu) reads
// instead of recomputing the softmax's statistics; serving asks for none.
//
// bf16, the served path (flash_fwd_wgmma_kernel).  Bound on this card by
// bytes at the prefill shapes (S = 512: reading q, k, v and writing out
// once at 3.35 TB/s takes longer than the causal flops at the tensor cores'
// rate), so every intermediate stays on chip and the tensor cores are fed
// asynchronously.  One persistent block per SM holds two consumer
// warpgroups and one producer warp, and walks work items (q tile, query
// heads, batch row) heaviest first.  The producer brings each item's Q into
// one of two buffers and its K/V tiles of 64 keys into a 3-stage ring, all
// through TMA into swizzled shared memory; every buffer has a "full"
// mbarrier (the TMA bytes landed) and an "empty" one (the consumers are done
// with it), so the next tiles, and the next item's Q, load while the current
// ones are multiplied.  Each warpgroup owns 64 query rows of an item.
// S = Q K^T is a chain of wgmma m64n64k16 from shared memory into fp32
// registers; the mask, the running max and sum and the rescale stay in
// registers (no score matrix in shared memory, no __syncthreads in the
// loop); O += P V is wgmma with P from registers and V read MN-major from
// shared memory.  P keeps fp32's precision: it is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both are multiplied into
// the same accumulator (~16 mantissa bits; one bf16 P would be off by up
// to 2^-9 of each weight, ~1e-3 on rows with few live keys).  Where H/K is
// even the two warpgroups serve two query heads of one KV head (64 rows
// each), so each K/V tile is read once for both; otherwise 128 consecutive
// rows of one head.  The output goes from registers into the warpgroup's
// Q buffer and out by TMA stores (the accumulator layout would scatter
// 4-byte stores over 8 rows per warp instruction).  TMA needs 16-byte aligned
// bases and strides: the wrapper checks them and raises.
//
// fp32, the exact path of the fp32 parity runs (flash_fwd_kernel), runs
// on the CUDA cores with fp32 FMAs, since the tensor cores' fp32 path is
// TF32, which drops mantissa bits.  One block of 256 threads per (q tile of
// 64 rows, head, batch row) stages 64-key tiles in shared memory; each
// thread owns a 4x4 block of the score tile and a 4 x hd/16 block of the
// accumulator; the running max and denominator per row live in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------------ fp32

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kBQ * HD + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,  // (B, H, Sq, HD) contiguous
    float* __restrict__ lse,  // (B, H, Sq) or null
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int qp = q0 + r;
    Qs[i] = qp < Sq ? qb[qp * qss + d] : 0.f;
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
      Ks[c * KSTR + d] = ok ? kb[kp * kss + d] : 0.f;
      Vs[i] = ok ? vb[kp * vss + d] : 0.f;
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
    if (lse != nullptr && tx == 0)  // natural log: the max is of the scaled scores
      lse[((size_t)b * H + h) * Sq + qp] = m[r] + logf(l[r]);
    float* orow = out + (((size_t)b * H + h) * Sq + qp) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int H, int K, int Sq, int Sk, const long long* st, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kern = flash_fwd_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, H, K, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

constexpr int kRowsWG = 64;  // query rows per consumer warpgroup
constexpr int kWGs = 2;      // consumer warpgroups per block
constexpr int kKeys = 64;    // keys per K/V tile
constexpr int kStages = 3;   // K/V tiles in flight
constexpr int kThreadsWG = 128 * kWGs + 32;  // + the producer warp

template <int HD>
constexpr size_t wgmma_smem() {
  return 1024 + (size_t)(2 * kWGs + 2 * kStages) * Tile<HD>::TILE;
}

// P as two bf16 A operands: hi = bf16(P), lo = bf16(P - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// The work: items (q tile, query heads, batch row), heaviest first (the
// last q tiles see the most keys).  Persistent block j of G takes items j,
// 2G-1-j, 2G+j, 4G-1-j, ... (a snake over the rounds), so every block gets
// a mix of heavy and light items and they finish together.
struct Items {
  int rows, heads, n_hg, B, n_qt, Sq, Sk, causal;
  __device__ __forceinline__ void at(int i, int& q0, int& h0, int& b) const {
    const int per = n_hg * B;
    q0 = (n_qt - 1 - i / per) * rows;
    h0 = (i % per) / B * heads;
    b = i % B;
  }
  // K/V tiles of the keys that rows [r0, r0 + n) see
  __device__ __forceinline__ int tiles(int r0, int n) const {
    const int all = (Sk + kKeys - 1) / kKeys;
    return causal ? min(all, (min(r0 + n, Sq) - 1) / kKeys + 1) : all;
  }
};

// the item of block blockIdx.x in round r of G blocks
__device__ __forceinline__ int item_of(int r, int G) {
  return r * G + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to,  // out (B, H, Sq, HD), contiguous
    float* __restrict__ lse,                 // (B, H, Sq) or null
    const Items items, int n_items, int H, int K, int swaps, float scale_log2) {
  using namespace hopper;
  using T = Tile<HD>;
  constexpr int SW = T::SW, CW = T::CW, NC = T::NC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull[2], qempty[2];
  // [buffer][wg] Q tiles (then this warpgroup's output), [stage] K and V tiles
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + 2 * kWGs * T::TILE;
  uint8_t* vs = ks + kStages * T::TILE;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWGs);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], kWGs);  // one per warpgroup, once its output is stored
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int G = gridDim.x;
  const int wg = tid / 128;
  if (wg == kWGs) {  // the producer warp: one lane issues every copy
    if (tid % 32 == 0) {
      int it = 0;  // K/V tiles issued so far
      for (int n = 0; item_of(n, G) < n_items; ++n) {
        int q0, h0, b;
        items.at(item_of(n, G), q0, h0, b);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&qempty[qb], (n / 2 - 1) & 1);
        mbar_expect_tx(&qfull[qb], kWGs * T::TILE);
        for (int w = 0; w < kWGs; ++w)
          for (int c = 0; c < NC; ++c)
            tma_qkv(qs + (qb * kWGs + w) * T::TILE + c * T::CHUNK, &tq, &qfull[qb], c * CW,
                    items.heads == 2 ? q0 : q0 + w * kRowsWG,
                    items.heads == 2 ? h0 + w : h0, b, swaps & 1);
        const int kh = h0 / (H / K);
        const int nk = items.tiles(q0, items.rows);
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[s], 2 * T::TILE);
          for (int c = 0; c < NC; ++c) {
            tma_qkv(ks + s * T::TILE + c * T::CHUNK, &tk, &full[s], c * CW, t * kKeys, kh, b,
                    (swaps >> 1) & 1);
            tma_qkv(vs + s * T::TILE + c * T::CHUNK, &tv, &full[s], c * CW, t * kKeys, kh, b,
                    (swaps >> 2) & 1);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: per item, 64 query rows of one head
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = warp * 16 + lane / 4;  // this thread's rows r and r + 8 of the 64
  int it = 0;                          // K/V tiles consumed so far
  for (int n = 0; item_of(n, G) < n_items; ++n) {
    int q0, h0, b;
    items.at(item_of(n, G), q0, h0, b);
    const int head = items.heads == 2 ? h0 + wg : h0;
    const int qr0 = items.heads == 2 ? q0 : q0 + wg * kRowsWG;
    const int row_a = qr0 + r;
    const int row_b = row_a + 8;
    const int nk = items.tiles(q0, items.rows);
    // the tiles this warpgroup multiplies; it waits on and releases all nk
    const int nk_wg = qr0 < items.Sq ? items.tiles(qr0, kRowsWG) : 0;
    const int qb = n & 1;
    uint8_t* qtile = qs + (qb * kWGs + wg) * T::TILE;
    const uint32_t q_addr = smem_addr(qtile);

    float o[NC][CW / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < CW / 2; ++k) o[c][k] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    mbar_wait(&qfull[qb], (n / 2) & 1);

    for (int t = 0; t < nk; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (t < nk_wg) {
        const uint32_t k_addr = smem_addr(ks + s * T::TILE);
        const uint32_t v_addr = smem_addr(vs + s * T::TILE);
        float sc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) sc[k] = 0.f;
        fence_regs(sc);
        wgmma_fence();
        qk_wgmma<HD>(sc, q_addr, k_addr);  // S = Q K^T, both K-major
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        const int k0 = t * kKeys;
        const bool edge = k0 + kKeys > items.Sk || (items.causal && k0 + kKeys - 1 > qr0);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          float x = sc[k] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * (k / 4) + 2 * (lane % 4) + (k % 2);
            if (kp >= items.Sk || (items.causal && kp > ((k % 4) < 2 ? row_a : row_b)))
              x = -INFINITY;
          }
          sc[k] = x;
          if ((k % 4) < 2)
            mx_a = fmaxf(mx_a, x);
          else
            mx_b = fmaxf(mx_b, x);
        }
        // every row has a live key in tile 0, so the running max is finite from then on
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        const float al_a = exp2f(m_a - mn_a);
        const float al_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t phi[4][4], plo[4][4];  // per 16 keys, the m16n8k16 A fragment
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = exp2f(sc[4 * j] - mn_a);
          const float p1 = exp2f(sc[4 * j + 1] - mn_a);
          const float p2 = exp2f(sc[4 * j + 2] - mn_b);
          const float p3 = exp2f(sc[4 * j + 3] - mn_b);
          sum_a += p0 + p1;
          sum_b += p2 + p3;
          split_bf16(p0, p1, phi[j / 2][(j % 2) * 2], plo[j / 2][(j % 2) * 2]);
          split_bf16(p2, p3, phi[j / 2][(j % 2) * 2 + 1], plo[j / 2][(j % 2) * 2 + 1]);
        }
        l_a = l_a * al_a + sum_a;  // per-thread partial sums; the quad adds them at the end
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int k = 0; k < CW / 2; ++k) o[c][k] *= (k % 4) < 2 ? al_a : al_b;
          fence_regs(o[c]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // O += P V, V MN-major
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const uint64_t dv =
                gmma_desc(v_addr + c * T::CHUNK + kk * 16 * SW, 8 * SW, 8 * SW, SW);
            pv_wgmma<CW>(o[c], phi[kk], dv);
            pv_wgmma<CW>(o[c], plo[kk], dv);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // epilogue: O / l in bf16 into this warpgroup's Q tile (free since its
    // last S = Q K^T), swizzled as TMA reads it, then one TMA store per chunk;
    // rows past Sq fall outside the tensor map and are not written.  The Q
    // buffer is released once the store has read it.
    if (nk_wg > 0) {
      const float sum_a = quad_sum(l_a);
      const float sum_b = quad_sum(l_b);
      const float inv_a = 1.f / sum_a;
      const float inv_b = 1.f / sum_b;
      if (lse != nullptr && lane % 4 == 0) {  // natural log: the max is kept in base 2
        float* row = lse + ((size_t)b * H + head) * items.Sq;
        if (row_a < items.Sq) row[row_a] = (m_a + log2f(sum_a)) * kLn2;
        if (row_b < items.Sq) row[row_b] = (m_b + log2f(sum_b)) * kLn2;
      }
      acc_to_tile<HD>(qtile, o, r, lane, inv_a, inv_b);
      fence_async_smem();
    }
    named_barrier(1 + wg, 128);
    if (tid % 128 == 0) {
      if (nk_wg > 0) {
        for (int c = 0; c < NC; ++c)
          tma_store_4d(&to, qtile + c * T::CHUNK, c * CW, qr0, head, b);
        tma_store_drain();
      }
      mbar_arrive(&qempty[qb]);
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int H, int K, int Sq, int Sk, const long long* st, int causal,
                        float scale, cudaStream_t stream) {
  if (!tma_ok(q, st[0], st[1], st[2]) || !tma_ok(k, st[3], st[4], st[5]) ||
      !tma_ok(v, st[6], st[7], st[8]))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, to;
  int sq, sk, sv;
  cudaError_t e = qkv_map(&tq, q, HD, Sq, H, B, st[0], st[1], st[2], &sq);
  if (e == cudaSuccess) e = qkv_map(&tk, k, HD, Sk, K, B, st[3], st[4], st[5], &sk);
  if (e == cudaSuccess) e = qkv_map(&tv, v, HD, Sk, K, B, st[6], st[7], st[8], &sv);
  if (e == cudaSuccess) e = dense_map(&to, out, HD, Sq, H, B);
  if (e != cudaSuccess) return e;
  e = hopper::allow_smem<flash_fwd_wgmma_kernel<HD>>(wgmma_smem<HD>());
  if (e != cudaSuccess) return e;
  const int heads = (H / K) % 2 == 0 ? 2 : 1;
  const int rows = kWGs * kRowsWG / heads;
  const int n_qt = (Sq + rows - 1) / rows;
  const Items items{rows, heads, H / heads, B, n_qt, Sq, Sk, causal};
  const int n_items = n_qt * (H / heads) * B;
  static int sms = 0;  // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int grid = sms < n_items ? sms : n_items;
  flash_fwd_wgmma_kernel<HD><<<grid, kThreadsWG, wgmma_smem<HD>(), stream>>>(
      tq, tk, tv, to, lse, items, n_items, H, K, sq | (sk << 1) | (sv << 2), scale * kLog2e);
  return cudaGetLastError();
}

template <bool BF16, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int H, int K, int Sq, int Sk, const long long* st, int causal, float scale,
                   cudaStream_t s) {
  return BF16 ? launch_bf16<HD>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s)
              : launch_f32<HD>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s);
}

template <bool BF16>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int H, int K, int Sq, int Sk, int hd, const long long* st,
                        int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<BF16, 16>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s);
    case 32: return launch<BF16, 32>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s);
    case 64: return launch<BF16, 64>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s);
    case 128: return launch<BF16, 128>(q, k, v, out, lse, B, H, K, Sq, Sk, st, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// lse, where not null, receives the log-sum-exp of each query row's scaled
// scores (natural log, fp32, (B, H, Sq) contiguous): the backward's input.
// strides are in elements, in the order q(b, h, s), k(b, h, s), v(b, h, s);
// the head dim is contiguous (bf16: 16-byte aligned bases, strides multiples
// of 8).  dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 = ok).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     float* lse, int B, int H, int K, int Sq, int Sk, int hd,
                                     long long qsb, long long qsh, long long qss,
                                     long long ksb, long long ksh, long long kss,
                                     long long vsb, long long vsh, long long vss, int causal,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<false>(q, k, v, out, lse, B, H, K, Sq, Sk, hd, st, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<true>(q, k, v, out, lse, B, H, K, Sq, Sk, hd, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
