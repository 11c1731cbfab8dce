// Flash-attention backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces no TPU kernel: the Pallas package has none for the gradient.
// JAX's `_flash_bwd` (src/repro/kernels/ops.py) recomputes its oracle in
// XLA and differentiates it, and the port did the same with its plain
// version, holding (B, H, Sq, Sk) fp32 scores, probabilities and their
// cotangents in device memory.  This kernel computes the same gradient
// from the forward's saved output O and log-sum-exp L, for the output
// cotangent dO, with every score tile kept on chip:
//   D_i = sum_d dO_id O_id,   P = exp(scale Q K^T - L)  (masked as the
//   forward masks: kpos <= qpos top-left when causal, kpos < Sk),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// GQA-native: the H/K query heads of a KV head sum into its dK and dV in
// the kernel.  Two passes in stream order, a dQ pass (which in bf16 also
// forms D from the dO and O tiles it loads) and a dK/dV pass that reads D;
// the fp32 path forms D in a pre-pass (one warp a row) and runs the dK/dV
// pass first.  No atomics: every sum runs in a fixed order, so two calls
// give the same bits (the card's checks of replicas and of SP against TP
// rely on it).
//
// bf16, the training path.  Bound by operations at the training shapes
// (B8 H16 S1,024 hd128 causal: 5 products of hd per scored pair against
// ~100 MB of q, k, v, O, dO and gradients), so the products run on the
// tensor cores fed by TMA, as the forward's do.  Two passes, as FA2 splits
// them, cost seven products against the minimal five (S and dP are
// computed in both); the fused pass (FA3) would add dQ's partial sums from
// every key block into one fp32 buffer, which needs atomics, or counters
// that make blocks wait on each other to keep a fixed order.  Two passes
// keep every sum in a fixed order with neither.
//   Registers by role: a block is two consumer warpgroups and one producer
//   warpgroup (384 threads, so ptxas plans 168 registers a thread); the
//   producer gives back all but 24 (setmaxnreg.dec) and the consumers take
//   240 (setmaxnreg.inc), which holds fp32 dK and dV of 64 keys x 128
//   (128 registers) beside S^T and dP^T (64) without spilling.
//   Products overlapped with the softmax arithmetic, inside each
//   warpgroup: the two score products are committed as separate groups, so
//   P is formed (exp2 on the SFU, mask) while dP's chain still runs; in
//   the dK/dV pass dV += P^T dO is issued before dS = P (dP - D) is formed
//   and runs under it.  The two consumer warpgroups are not synchronised
//   with each other, so one's arithmetic also runs under the other's
//   products.  (Letting a tile's dQ += dS K run on under the next tile's
//   S and dP held two of the ring's three stages a warpgroup and was
//   slower, as was a fourth stage.)
//   D in the dQ pass: its blocks load the O tiles of their rows beside Q
//   and dO, and the four lanes of a quad sum a row's 16-byte units, which
//   saves the pre-pass's read of O and dO.
//   Order: each pass launches its heaviest blocks first (under the causal
//   mask, the first key blocks and the last query blocks of every head),
//   every head's before any lighter block.
//   dK/dV pass: one block per (128 keys, KV head, batch row): two consumer
//   warpgroups of 64 keys each.  K and V of the block are loaded once; the
//   producer then walks the group's query heads and the query tiles that
//   can see these keys (causal: none wholly above the diagonal), bringing
//   each 64-row tile of Q and dO through TMA into a 3-stage ring with
//   full/empty mbarriers, and the tile's L and D rows (its first warp's
//   lanes store them beside the TMA copy, and every lane arrives on the
//   stage's barrier).  Per tile, S^T = K Q^T and dP^T = V dO^T are wgmma
//   chains with both operands K-major in swizzled shared memory; P^T and
//   dS^T stay in fp32 registers, are rounded to bf16 A operands and feed
//   dV += P^T dO and dK += dS^T Q with dO and Q read MN-major from the
//   same tiles.  dK and dV accumulate in fp32 registers and leave once
//   through shared memory and TMA stores.
//   dQ pass: one block per (128 query rows, query head, batch row): two
//   consumer warpgroups of 64 rows; Q, dO and O loaded once, K and V tiles
//   of 64 keys through a 3-stage ring; per tile S = Q K^T and dP = dO V^T,
//   then dQ += dS K, dQ in fp32 registers.
// P and dS are rounded once to bf16 for their products, as SDPA's flash
// backward rounds them.  TMA needs 16-byte aligned bases and strides: the
// wrapper checks q, k, v, makes dO contiguous, and raises on the rest.
//
// fp32, the exact path of the fp32 parity runs, on the CUDA cores (the
// tensor cores' fp32 path is TF32), in the same two passes: blocks of 256
// threads over 64 x 64 score tiles staged in shared memory, each thread a
// 4 x 4 block of the tile and a 4 x hd/16 block of its accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ D = dO . O

// D of `rows` fp32 rows of hd values, o and dout contiguous; one warp a
// row, summed in a fixed order (the fp32 path; the bf16 dQ pass forms D)
__global__ void __launch_bounds__(256) flash_bwd_dot_kernel(const float* __restrict__ o,
                                                            const float* __restrict__ dout,
                                                            float* __restrict__ dsum,
                                                            long long rows, int hd) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* a = o + row * hd;
  const float* g = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(a[d], g[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dsum[row] = s;
}

// ------------------------------------------------------------------ fp32

constexpr int kB = 64;         // rows (queries or keys) of a tile
constexpr int kThreads = 256;  // 16 x 16

template <int HD>
constexpr size_t dq_smem_floats() {  // Q, dO; K, V padded; dS; L, D
  return 2 * (size_t)kB * HD + 2 * (size_t)kB * (HD + 1) + (size_t)kB * (kB + 1) + 2 * kB;
}

template <int HD>
constexpr size_t dkv_smem_floats() {  // K, V, Q, dO padded; P, dS; L, D
  return 4 * (size_t)kB * (HD + 1) + 2 * (size_t)kB * (kB + 1) + 2 * kB;
}

// dQ for one (q tile, head, batch row)
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq,  // dout, dq (B, H, Sq, HD)
    int H, int K, int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, int causal,
    float scale) {
  constexpr int KSTR = HD + 1;
  constexpr int SSTR = kB + 1;
  constexpr int DPT = HD / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* Qs = smem;             // kB x HD
  float* Gs = Qs + kB * HD;     // dO, kB x HD
  float* Ks = Gs + kB * HD;     // kB x KSTR
  float* Vs = Ks + kB * KSTR;   // kB x KSTR
  float* Ss = Vs + kB * KSTR;   // dS, kB x SSTR
  float* Ls = Ss + kB * SSTR;   // L per row (+inf past Sq)
  float* Ds = Ls + kB;          // D per row

  const int q0 = qt * kB;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;
  for (int i = tid; i < kB * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int qp = q0 + r;
    Qs[i] = qp < Sq ? qb[qp * qss + d] : 0.f;
    Gs[i] = qp < Sq ? dout[(bh * Sq + qp) * HD + d] : 0.f;
  }
  if (tid < kB) {
    const int qp = q0 + tid;
    Ls[tid] = qp < Sq ? lse[bh * Sq + qp] : INFINITY;
    Ds[tid] = qp < Sq ? dsum[bh * Sq + qp] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, (min(q0 + kB, Sq) - 1) / kB + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile is consumed; Q, dO, L, D are visible
    for (int i = tid; i < kB * HD; i += kThreads) {
      const int c = i / HD;
      const int d = i - c * HD;
      const int kp = k0 + c;
      const bool ok = kp < Sk;
      Ks[c * KSTR + d] = ok ? kb[kp * kss + d] : 0.f;
      Vs[c * KSTR + d] = ok ? vb[kp * vss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * HD + d];
        gv[i] = Gs[(ty + 16 * i) * HD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KSTR + d];
        vv[j] = Vs[(tx + 16 * j) * KSTR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool ok = kp < Sk && (!causal || kp <= q0 + r);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ss[r * SSTR + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float kv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Ks[c * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * SSTR + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    float* row = dq + (bh * Sq + qp) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// dK and dV for one (k tile, KV head, batch row), summed over the group's
// query heads
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv,  // dk, dv (B, K, Sk, HD)
    int H, int K, int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, int causal,
    float scale) {
  constexpr int KSTR = HD + 1;
  constexpr int SSTR = kB + 1;
  constexpr int DPT = HD / 16;
  const int kt = blockIdx.x;  // causal: the first k tiles see the most queries
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / K;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* Ks = smem;             // kB x KSTR
  float* Vs = Ks + kB * KSTR;
  float* Qs = Vs + kB * KSTR;
  float* Gs = Qs + kB * KSTR;   // dO
  float* Ps = Gs + kB * KSTR;   // P^T, kB keys x SSTR
  float* Ss = Ps + kB * SSTR;   // dS^T
  float* Ls = Ss + kB * SSTR;
  float* Ds = Ls + kB;

  const int k0 = kt * kB;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;
  for (int i = tid; i < kB * HD; i += kThreads) {
    const int c = i / HD;
    const int d = i - c * HD;
    const int kp = k0 + c;
    const bool ok = kp < Sk;
    Ks[c * KSTR + d] = ok ? kb[kp * kss + d] : 0.f;
    Vs[c * KSTR + d] = ok ? vb[kp * vss + d] : 0.f;
  }

  float ak[4][DPT], av[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) ak[i][j] = av[i][j] = 0.f;

  const int n_qt = (Sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const size_t bh = (size_t)b * H + h;
    const float* qb = q + b * qsb + h * qsh;
    for (int t = causal ? k0 / kB : 0; t < n_qt; ++t) {
      const int q0 = t * kB;
      __syncthreads();  // the previous tile is consumed; K and V are visible
      for (int i = tid; i < kB * HD; i += kThreads) {
        const int r = i / HD;
        const int d = i - r * HD;
        const int qp = q0 + r;
        Qs[r * KSTR + d] = qp < Sq ? qb[qp * qss + d] : 0.f;
        Gs[r * KSTR + d] = qp < Sq ? dout[(bh * Sq + qp) * HD + d] : 0.f;
      }
      if (tid < kB) {
        const int qp = q0 + tid;
        Ls[tid] = qp < Sq ? lse[bh * Sq + qp] : INFINITY;
        Ds[tid] = qp < Sq ? dsum[bh * Sq + qp] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows keys ty + 16i, columns queries tx + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * KSTR + d];
          vv[i] = Vs[(ty + 16 * i) * KSTR + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * KSTR + d];
          gv[j] = Gs[(tx + 16 * j) * KSTR + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          // keys past Sk only reach their own rows, which are not stored;
          // queries past Sq have L = +inf, so P = 0
          const bool ok = !causal || k0 + r <= q0 + c;
          const float p = ok ? expf(s[i][j] * scale - Ls[c]) : 0.f;
          Ps[r * SSTR + c] = p;
          Ss[r * SSTR + c] = p * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kB; ++c) {
        float gv[DPT], qv[DPT];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          gv[j] = Gs[c * KSTR + tx + 16 * j];
          qv[j] = Qs[c * KSTR + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * SSTR + c];
          const float ds = Ss[(ty + 16 * i) * SSTR + c];
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            av[i][j] = fmaf(p, gv[j], av[i][j]);
            ak[i][j] = fmaf(ds, qv[j], ak[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * K + kh) * Sk + kp) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[off + tx + 16 * j] = ak[i][j] * scale;
      dv[off + tx + 16 * j] = av[i][j];
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* dsum, void* dq, void* dk, void* dv, int B,
                       int H, int K, int Sq, int Sk, const long long* st, int causal,
                       float scale, cudaStream_t stream) {
  const size_t s_dkv = sizeof(float) * dkv_smem_floats<HD>();
  const size_t s_dq = sizeof(float) * dq_smem_floats<HD>();
  const dim3 g_dkv((Sk + kB - 1) / kB, K, B), g_dq((Sq + kB - 1) / kB, H, B);
  cudaError_t e = hopper::allow_smem<flash_bwd_dkv_f32_kernel<HD>>(s_dkv);
  if (e == cudaSuccess) e = hopper::allow_smem<flash_bwd_dq_f32_kernel<HD>>(s_dq);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_f32_kernel<HD><<<g_dkv, kThreads, s_dkv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dk), static_cast<float*>(dv), H, K, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_f32_kernel<HD><<<g_dq, kThreads, s_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dq), H, K, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

constexpr int kWGs = 2;     // consumer warpgroups per block, 64 rows each
// 2^x on the SFU (ex2.approx.ftz: the masked scores' -inf gives 0, and a
// result below 2^-126 flushes to 0 where exp2f would scale it)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kStages = 3;  // tiles in flight
constexpr int kThreadsWG = 128 * (kWGs + 1);  // + the producer warpgroup
// setmaxnreg: the block launches at 168 registers a thread (65,536 / 384);
// the producer warpgroup drops to 24 and the consumers rise to 240
// (24 * 128 + 240 * 256 = 168 * 384)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// both passes: kWGs own tiles of two operands, kStages stages of two
template <int HD>
constexpr size_t wgmma_smem() {
  return 1024 + (size_t)(2 * kWGs + 2 * kStages) * Tile<HD>::TILE;
}
// the dQ pass: also the O tiles of its rows, from which it forms D
template <int HD>
constexpr size_t dq_smem() {
  return wgmma_smem<HD>() + (size_t)kWGs * Tile<HD>::TILE;
}

// sum of the products of 8 bf16 pairs, in order, onto acc
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

// the first 64-row query tile that sees key k0 (causal), else 0
__device__ __forceinline__ int first_q_tile(int k0, int causal) { return causal ? k0 / 64 : 0; }

// dK and dV of 64 * kWGs keys of one KV head and batch row (see the head
// note).  Grid (K, B, key blocks): the launch walks x fastest, so every
// (head, row)'s first key block, the one the most query tiles see under
// the causal mask, starts before any second one.  tq, tg: q and dO; tdk,
// tdv: dk and dv (B, K, Sk, HD), contiguous
template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
    const float* __restrict__ lse, const float* __restrict__ dsum, int H, int K, int Sq,
    int Sk, int causal, int swaps, float scale, float scale_log2) {
  using namespace hopper;
  using T = Tile<HD>;
  constexpr int NC = T::NC, CW = T::CW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kvfull;
  __shared__ float ls[kStages][64], ds[kStages][64];  // L·log2(e) (+inf past Sq) and D
  // [wg] K and V tiles (then dK and dV), [stage] Q and dO tiles
  uint8_t* ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* vs = ks + kWGs * T::TILE;
  uint8_t* qs = vs + kWGs * T::TILE;
  uint8_t* gs = qs + kStages * T::TILE;

  const int tid = threadIdx.x;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 64 * kWGs;
  const int group = H / K;
  const int n_qt = (Sq + 63) / 64;
  const int t0 = first_q_tile(k0, causal);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);         // every producer lane (lane 0 with the TMA bytes)
      mbar_init(&empty[s], 4 * kWGs);  // one arrival per consumer warp
    }
    mbar_init(&kvfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kWGs) {  // the producer warpgroup: its first warp works
    reg_dealloc<kProducerRegs>();
    if (tid % 128 >= 32) return;
    const int lane = tid % 32;  // lane 0 issues the copies, every lane L and D
    if (lane == 0) {
      mbar_expect_tx(&kvfull, 2 * kWGs * T::TILE);
      for (int w = 0; w < kWGs; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_qkv(ks + w * T::TILE + c * T::CHUNK, &tk, &kvfull, c * CW, k0 + 64 * w, kh, b,
                  (swaps >> 1) & 1);
          tma_qkv(vs + w * T::TILE + c * T::CHUNK, &tv, &kvfull, c * CW, k0 + 64 * w, kh, b,
                  (swaps >> 2) & 1);
        }
    }
    int it = 0;
    for (int g = 0; g < group; ++g) {
      const int h = kh * group + g;
      const size_t bh = (size_t)b * H + h;
      for (int t = t0; t < n_qt; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        for (int i = lane; i < 64; i += 32) {
          const int qp = t * 64 + i;
          ls[s][i] = qp < Sq ? lse[bh * Sq + qp] * kLog2e : INFINITY;
          ds[s][i] = qp < Sq ? dsum[bh * Sq + qp] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * T::TILE);
          for (int c = 0; c < NC; ++c) {
            tma_qkv(qs + s * T::TILE + c * T::CHUNK, &tq, &full[s], c * CW, t * 64, h, b,
                    swaps & 1);
            tma_qkv(gs + s * T::TILE + c * T::CHUNK, &tg, &full[s], c * CW, t * 64, h, b, 0);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 keys
  reg_alloc<kConsumerRegs>();
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = warp * 16 + lane / 4;  // this thread's key rows r and r + 8 of the 64
  const int kw = k0 + 64 * wg;         // the warpgroup's first key
  uint8_t* ktile = ks + wg * T::TILE;
  uint8_t* vtile = vs + wg * T::TILE;
  const uint32_t k_addr = smem_addr(ktile);
  const uint32_t v_addr = smem_addr(vtile);

  float dk[NC][CW / 2], dv[NC][CW / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) dk[c][i] = dv[c][i] = 0.f;
  mbar_wait(&kvfull, 0);

  int it = 0;
  for (int g = 0; g < group; ++g) {
    for (int t = t0; t < n_qt; ++t, ++it) {
      const int s = it % kStages;
      const int q0 = t * 64;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (kw < Sk && (!causal || q0 + 63 >= kw)) {
        const uint32_t q_addr = smem_addr(qs + s * T::TILE);
        const uint32_t g_addr = smem_addr(gs + s * T::TILE);
        // S^T and dP^T as two groups, so P is formed while dP^T runs
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        qk_wgmma<HD>(st, k_addr, q_addr);  // S^T = K Q^T
        wgmma_commit();
        qk_wgmma<HD>(dpt, v_addr, g_addr);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // element i: key row r (+8 for i % 4 >= 2), query column 8 (i / 4)
        // + 2 (lane % 4) + i % 2 of the tile; keys past Sk only reach their
        // own rows, which are not stored
        const bool edge = causal && kw + 63 > q0;
        uint32_t pa[4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          float p = fast_exp2(st[i] * scale_log2 - ls[s][c]);
          if (edge && kw + r + 8 * ((i % 4) / 2) > q0 + c) p = 0.f;
          st[i] = p;
        }
        acc_to_a(st, pa);
        wgmma_fence();
        av_wgmma<HD>(dv, pa, g_addr);  // dV += P^T dO, running while dS is formed
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in
        fence_regs(dpt);
        uint32_t da[4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          dpt[i] = st[i] * (dpt[i] - ds[s][c]);
        }
        acc_to_a(dpt, da);
        wgmma_fence();
        av_wgmma<HD>(dk, da, q_addr);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }
  }

  // epilogue: dK·scale and dV in bf16 into this warpgroup's K and V tiles
  // (no product reads them any more), then TMA stores; keys past Sk fall
  // outside the tensor maps and are not written
  if (kw < Sk) {
    acc_to_tile<HD>(ktile, dk, r, lane, scale, scale);
    acc_to_tile<HD>(vtile, dv, r, lane, 1.f, 1.f);
    fence_async_smem();
  }
  named_barrier(1 + wg, 128);
  if (tid % 128 == 0 && kw < Sk) {
    for (int c = 0; c < NC; ++c) {
      tma_store_4d(&tdk, ktile + c * T::CHUNK, c * CW, kw, kh, b);
      tma_store_4d(&tdv, vtile + c * T::CHUNK, c * CW, kw, kh, b);
    }
    tma_store_drain();
  }
}

// dQ of 64 * kWGs query rows of one head and batch row (see the head note).
// Grid (H, B, query blocks), the last query block (the most keys under the
// causal mask) launched first.  tq, tg: q and dO; tdq: dq (B, H, Sq, HD),
// contiguous
template <int HD>
__global__ void __launch_bounds__(kThreadsWG, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tdq, const __grid_constant__ CUtensorMap to,
    const float* __restrict__ lse, float* __restrict__ dsum, int H, int K, int Sq, int Sk,
    int causal, int swaps, float scale, float scale_log2) {
  using namespace hopper;
  using T = Tile<HD>;
  constexpr int NC = T::NC, CW = T::CW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qfull;
  // [wg] Q tiles (then dQ) and dO tiles, [stage] K and V tiles
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* gs = qs + kWGs * T::TILE;
  uint8_t* ks = gs + kWGs * T::TILE;
  uint8_t* vs = ks + kStages * T::TILE;
  uint8_t* os = vs + kStages * T::TILE;  // [wg] O tiles

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64 * kWGs;  // heaviest first
  const int kh = h / (H / K);
  const int n_kt = (Sk + 63) / 64;
  // K/V tiles of the keys that rows [r0, r0 + n) see
  auto tiles = [&](int r0, int n) {
    return causal ? min(n_kt, (min(r0 + n, Sq) - 1) / 64 + 1) : n_kt;
  };
  const int nk = tiles(q0, 64 * kWGs);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWGs);
    }
    mbar_init(&qfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kWGs) {  // the producer warpgroup: one lane issues every copy
    reg_dealloc<kProducerRegs>();
    if (tid % 128 == 0) {
      mbar_expect_tx(&qfull, 3 * kWGs * T::TILE);
      for (int w = 0; w < kWGs; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_qkv(qs + w * T::TILE + c * T::CHUNK, &tq, &qfull, c * CW, q0 + 64 * w, h, b,
                  swaps & 1);
          tma_qkv(gs + w * T::TILE + c * T::CHUNK, &tg, &qfull, c * CW, q0 + 64 * w, h, b, 0);
          tma_qkv(os + w * T::TILE + c * T::CHUNK, &to, &qfull, c * CW, q0 + 64 * w, h, b, 0);
        }
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::TILE);
        for (int c = 0; c < NC; ++c) {
          tma_qkv(ks + s * T::TILE + c * T::CHUNK, &tk, &full[s], c * CW, t * 64, kh, b,
                  (swaps >> 1) & 1);
          tma_qkv(vs + s * T::TILE + c * T::CHUNK, &tv, &full[s], c * CW, t * 64, kh, b,
                  (swaps >> 2) & 1);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  reg_alloc<kConsumerRegs>();
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = warp * 16 + lane / 4;  // this thread's rows r and r + 8 of the 64
  const int qw = q0 + 64 * wg;
  const int row_a = qw + r;
  const int row_b = row_a + 8;
  const int nk_wg = qw < Sq ? tiles(qw, 64) : 0;
  const size_t bh = (size_t)b * H + h;
  const float l_a = row_a < Sq ? lse[bh * Sq + row_a] * kLog2e : INFINITY;
  const float l_b = row_b < Sq ? lse[bh * Sq + row_b] * kLog2e : INFINITY;
  uint8_t* qtile = qs + wg * T::TILE;
  const uint32_t q_addr = smem_addr(qtile);
  const uint32_t g_addr = smem_addr(gs + wg * T::TILE);

  float dq[NC][CW / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) dq[c][i] = 0.f;
  mbar_wait(&qfull, 0);
  // D of rows r and r + 8 from the dO and O tiles: each lane of a quad sums
  // every fourth 16-byte unit of the row, then the quad's four sums; rows
  // past Sq read as zeros.  Written for the dK/dV pass, which runs next.
  float d_a, d_b;
  {
    const uint8_t* gtile = gs + wg * T::TILE;
    const uint8_t* otile = os + wg * T::TILE;
    float dd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      float acc = 0.f;
#pragma unroll
      for (int k = lane % 4; k < HD / 8; k += 4) {
        const int c = k / (T::SW / 16), u = k % (T::SW / 16);
        const uint32_t off = swizzle(c * T::CHUNK + row * T::SW + 16 * u, T::SW);
        acc = dot8(*reinterpret_cast<const uint4*>(gtile + off),
                   *reinterpret_cast<const uint4*>(otile + off), acc);
      }
      dd[half] = quad_sum(acc);
    }
    d_a = dd[0];
    d_b = dd[1];
    if (lane % 4 == 0) {
      if (row_a < Sq) dsum[bh * Sq + row_a] = d_a;
      if (row_b < Sq) dsum[bh * Sq + row_b] = d_b;
    }
  }

  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (t < nk_wg) {
      const uint32_t k_addr = smem_addr(ks + s * T::TILE);
      const uint32_t v_addr = smem_addr(vs + s * T::TILE);
      // S and dP as two groups, so P is formed while dP runs
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      qk_wgmma<HD>(sc, q_addr, k_addr);  // S = Q K^T
      wgmma_commit();
      qk_wgmma<HD>(dp, g_addr, v_addr);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      const int k0 = t * 64;
      const bool edge = k0 + 64 > Sk || (causal && k0 + 63 > qw);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool lo = (i % 4) < 2;
        float p = fast_exp2(sc[i] * scale_log2 - (lo ? l_a : l_b));
        if (edge) {
          const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (kp >= Sk || (causal && kp > (lo ? row_a : row_b))) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();  // dP is in
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - ((i % 4) < 2 ? d_a : d_b));
      uint32_t da[4][4];
      acc_to_a(dp, da);
      wgmma_fence();
      av_wgmma<HD>(dq, da, k_addr);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(dq[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: dQ·scale in bf16 into this warpgroup's Q tile, then TMA
  // stores; rows past Sq fall outside the tensor map
  if (nk_wg > 0) {
    acc_to_tile<HD>(qtile, dq, r, lane, scale, scale);
    fence_async_smem();
  }
  named_barrier(1 + wg, 128);
  if (tid % 128 == 0 && nk_wg > 0) {
    for (int c = 0; c < NC; ++c) tma_store_4d(&tdq, qtile + c * T::CHUNK, c * CW, qw, h, b);
    tma_store_drain();
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, int B, int H, int K, int Sq, int Sk, const long long* st,
                        int causal, float scale, cudaStream_t stream) {
  if (!tma_ok(q, st[0], st[1], st[2]) || !tma_ok(k, st[3], st[4], st[5]) ||
      !tma_ok(v, st[6], st[7], st[8]) || !tma_ok(o, 8, 8, 8) || !tma_ok(dout, 8, 8, 8) ||
      !tma_ok(dq, 8, 8, 8) || !tma_ok(dk, 8, 8, 8) || !tma_ok(dv, 8, 8, 8))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tg, to, tdq, tdk, tdv;
  int sq, sk, sv;
  cudaError_t e = qkv_map(&tq, q, HD, Sq, H, B, st[0], st[1], st[2], &sq);
  if (e == cudaSuccess) e = qkv_map(&tk, k, HD, Sk, K, B, st[3], st[4], st[5], &sk);
  if (e == cudaSuccess) e = qkv_map(&tv, v, HD, Sk, K, B, st[6], st[7], st[8], &sv);
  if (e == cudaSuccess) e = dense_map(&tg, dout, HD, Sq, H, B);
  if (e == cudaSuccess) e = dense_map(&to, o, HD, Sq, H, B);
  if (e == cudaSuccess) e = dense_map(&tdq, dq, HD, Sq, H, B);
  if (e == cudaSuccess) e = dense_map(&tdk, dk, HD, Sk, K, B);
  if (e == cudaSuccess) e = dense_map(&tdv, dv, HD, Sk, K, B);
  if (e == cudaSuccess) e = hopper::allow_smem<flash_bwd_dkv_wgmma_kernel<HD>>(wgmma_smem<HD>());
  if (e == cudaSuccess) e = hopper::allow_smem<flash_bwd_dq_wgmma_kernel<HD>>(dq_smem<HD>());
  if (e != cudaSuccess) return e;
  const int swaps = sq | (sk << 1) | (sv << 2);
  const int rows = 64 * kWGs;
  const int nkb = (Sk + rows - 1) / rows, nqb = (Sq + rows - 1) / rows;
  // the dQ pass first: it forms D, which the dK/dV pass reads
  flash_bwd_dq_wgmma_kernel<HD><<<dim3(H, B, nqb), kThreadsWG, dq_smem<HD>(), stream>>>(
      tq, tk, tv, tg, tdq, to, lse, dsum, H, K, Sq, Sk, causal, swaps, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_wgmma_kernel<HD><<<dim3(K, B, nkb), kThreadsWG, wgmma_smem<HD>(), stream>>>(
      tq, tk, tv, tg, tdk, tdv, lse, dsum, H, K, Sq, Sk, causal, swaps, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <bool BF16, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int H,
                   int K, int Sq, int Sk, const long long* st, int causal, float scale,
                   cudaStream_t s) {
  if constexpr (BF16) {  // its dQ pass forms D
    return launch_bf16<HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, K, Sq, Sk, st,
                           causal, scale, s);
  } else {
    const long long rows = (long long)B * H * Sq;
    flash_bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dsum, rows, HD);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return launch_f32<HD>(q, k, v, dout, lse, dsum, dq, dk, dv, B, H, K, Sq, Sk, st, causal,
                          scale, s);
  }
}

template <bool BF16>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, int B, int H, int K, int Sq, int Sk, const long long* st,
                        int causal, float scale, cudaStream_t s) {
  switch (hd) {
#define REPRO_HD(N)                                                                         \
  case N:                                                                                   \
    return launch<BF16, N>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, K, Sq, Sk, st, \
                           causal, scale, s);
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dq (B, H, Sq, hd), dk and dv (B, K, Sk, hd) of flash attention, all three
// new contiguous tensors, from q, k, v (strided as the forward takes them:
// strides in elements, q(b, h, s), k(b, h, s), v(b, h, s)), the forward's
// output o and the cotangent dout (both contiguous (B, H, Sq, hd)), the
// forward's log-sum-exp lse (fp32 (B, H, Sq)), and dsum, fp32 (B, H, Sq)
// scratch that receives D.  dtype codes: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = ok).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* dsum, void* dq, void* dk, void* dv, int B,
                                         int H, int K, int Sq, int Sk, int hd, long long qsb,
                                         long long qsh, long long qss, long long ksb,
                                         long long ksh, long long kss, long long vsb,
                                         long long vsh, long long vss, int causal, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<false>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, K, Sq,
                                   Sk, st, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<true>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, K, Sq,
                                  Sk, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
