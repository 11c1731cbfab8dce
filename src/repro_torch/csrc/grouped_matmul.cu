// Grouped matmul of the MoE experts for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py
// (`grouped_matmul`, body `_gmm_kernel`): y[e] = x[e] @ w[e] for the
// capacity-padded expert buffers x (E, C, d) and w (E, d, f), giving
// y (E, C, f) in x's dtype, accumulated in fp32 and rounded once.
// sizes[e] is the number of live rows of group e (the kept assignments of
// expert e; a null pointer means every group is full).  Rows >= sizes[e] are
// exactly zero in y, as in `_finalize`.
//
// Bound on this card: the bytes of the live experts' weights, at decode
// (C = 4; at most 32 of 64 groups live) and at a 4096-token prefill alike
// (346 MB of weights against ~95 GFLOP, ~0.1 ms of bf16 tensor-core time).
// So every variant reads each live expert's weights once and no other's: a
// block reads sizes[e] itself, and a tile whose first row is past the group
// writes zeros and exits without touching w[e] — an empty or dead expert
// costs no weight traffic.  Four variants, chosen by shape in the wrapper
// (grouped_matmul.py, `variant`), one entry point:
//
// skinny (bf16 or fp32, C <= 16, d and f multiples of 8, 16-byte aligned
// x and w: every decode step of the model).  At C = 4 a weight byte feeds
// at most 2 FMAs, so the tensor cores are of no use and the kernel must
// keep HBM busy.  One block per (128-column tile, expert), 256 threads;
// each thread owns 8 consecutive columns of one of 16 interleaved slices
// of d and streams its weights with 16-byte cp.async into an 8-deep ring
// of its own in shared memory (no block barrier in the stream), while x[e]
// is staged whole as fp32.  FMAs run on the CUDA cores for the live rows
// only (read on the device, rounded up to 1, 2, 4, 8, 16), and the slices
// are summed through shared memory in a fixed tree order: no float atomics,
// the same bits every run.
//
// wgmma (bf16, C >= 64, the same alignment: every prefill call of the
// model).  One block per (128-column f tile, 128-row C tile, expert) with
// two consumer warpgroups and one producer warp; two blocks fit an SM, so
// one block's prologue and epilogue overlap the other's products.  The
// producer streams 64-deep chunks of x (128 x 64, K-major) and w (64 x
// 128, MN-major) through TMA into a 3-stage ring of 128-byte-swizzled
// shared memory, guarded by full/empty mbarriers.  x's tensor map is 3-D
// over (E, C, d), so rows past C read as TMA's zeros and never cross into
// the next expert.  Each warpgroup multiplies its 64 rows with wgmma
// m64n128k16 into fp32 registers, one k chunk's group in flight while the
// previous chunk's stage is released; a warpgroup whose rows all lie past
// the group skips its products.  The epilogue writes bf16 from the
// accumulators (zeros for rows in [sizes[e], C)) into a free w stage, with
// no fp32 staging tile, and TMA stores it.
//
// wmma (bf16 otherwise: 16 < C < 64, unaligned shapes).  One block per
// (64-column f tile, 64-row C tile, expert); live tiles walk d in 64-deep
// chunks staged in shared memory, the next chunk's loads in flight in
// registers while the current one is multiplied; rows past the group are
// staged as zeros and never read.  Four warps, each a 16-row strip x 64
// columns of 16x16x16 wmma fragments with fp32 accumulators; a warp whose
// strip lies past the group skips its products.
//
// fp32 (float32 otherwise): 256 threads with a 4x4 register tile each and
// fp32 FMAs on the CUDA cores (the tensor cores' fp32 path is TF32, which
// drops mantissa bits), same tiles as wmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kTile = 64;    // rows and columns of one output tile
constexpr int kDepth = 64;   // d staged per chunk (bf16 path)
constexpr int kPad = 8;      // bf16 row padding: 16 B, keeps wmma ldm % 8 == 0
constexpr int kLd = kTile + kPad;  // 72: row stride of both bf16 stages
constexpr int kLdC = kTile + 4;    // 68: fp32 accumulator stage
constexpr int kThreadsB = 128;     // bf16: four warps
constexpr int kSegs = kTile * kDepth / 8 / kThreadsB;  // 16-byte segments a thread loads per stage
constexpr int kThreadsF = 256;     // fp32: 16 x 16 threads, 4 x 4 outputs each
constexpr int kDepthF = 16;

__device__ __forceinline__ int live_rows(const int* sizes, int e, int C) {
  if (sizes == nullptr) return C;
  return min(max(sizes[e], 0), C);
}

// Eight bf16 of one row starting at column `col`, zero past `limit` (or
// when the row is dead).  `vec`: the row is 16-byte aligned and `limit` a
// multiple of 8, so the eight are all in range or all out.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, bool ok, int col,
                                       int limit, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return v;
  if (vec) {
    if (col < limit) v = *reinterpret_cast<const uint4*>(row + col);
    return v;
  }
  union {
    uint4 u;
    unsigned short h[8];
  } t;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    t.h[i] = (col + i < limit) ? __bfloat16_as_ushort(row[col + i]) : 0;  // +0.0
  return t.u;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ void write_zero_tile(T* y, int e, int r0, int c0, int C, int f, int nthreads) {
  const int nrows = min(kTile, C - r0);
  const int ncols = min(kTile, f - c0);
  for (int i = threadIdx.x; i < nrows * kTile; i += nthreads) {
    const int r = i / kTile;
    const int c = i - r * kTile;
    if (c < ncols) store(&y[((size_t)e * C + r0 + r) * f + c0 + c], 0.f);
  }
}

__global__ void __launch_bounds__(kThreadsB) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,  // (E, C, d)
    const __nv_bfloat16* __restrict__ w,  // (E, d, f)
    const int* __restrict__ sizes,        // (E,) live rows, or null
    __nv_bfloat16* __restrict__ y,        // (E, C, f)
    int C, int d, int f, int vec) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int live = live_rows(sizes, e, C);
  if (r0 >= live) {  // the whole tile is past the group: zeros, no w[e] read
    write_zero_tile(y, e, r0, c0, C, f, kThreadsB);
    return;
  }
  const int tile_live = min(live - r0, kTile);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  __shared__ __align__(128) __nv_bfloat16 xs[kTile * kLd];    // [row][k]
  __shared__ __align__(128) __nv_bfloat16 ws[kDepth * kLd];   // [k][col]
  __shared__ __align__(128) float cs[kTile * kLdC];           // [row][col]

  const __nv_bfloat16* xe = x + ((size_t)e * C + r0) * d;
  const __nv_bfloat16* we = w + (size_t)e * d * f + c0;
  const int ncols = f - c0;  // columns of w left from this tile on

  uint4 rx[kSegs], rw[kSegs];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      const int idx = tid + i * kThreadsB;
      const int r = idx >> 3, seg = (idx & 7) * 8;  // 8 segments per 64-wide row
      rx[i] = load8(xe + (size_t)r * d, r < tile_live, k0 + seg, d, vec);
      rw[i] = load8(we + (size_t)(k0 + r) * f, k0 + r < d, seg, ncols, vec);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const bool warp_live = warp * 16 < tile_live;

  if (d > 0) fetch(0);
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      const int idx = tid + i * kThreadsB;
      const int r = idx >> 3, seg = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(&xs[r * kLd + seg]) = rx[i];
      *reinterpret_cast<uint4*>(&ws[r * kLd + seg]) = rw[i];
    }
    __syncthreads();
    if (k0 + kDepth < d) fetch(k0 + kDepth);  // in flight during the products
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[warp * 16 * kLd + kk], kLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &ws[kk * kLd + j * 16], kLd);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }
  if (warp_live) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(&cs[warp * 16 * kLdC + j * 16], acc[j], kLdC,
                              wmma::mem_row_major);
  }
  __syncthreads();
  const int nrows = min(kTile, C - r0);
  const int nc = min(kTile, ncols);
  for (int i = tid; i < nrows * kTile; i += kThreadsB) {
    const int r = i / kTile;
    const int c = i - r * kTile;
    if (c < nc) {
      const float v = r < tile_live ? cs[r * kLdC + c] : 0.f;  // `_finalize`
      y[((size_t)e * C + r0 + r) * f + c0 + c] = __float2bfloat16(v);
    }
  }
}

__global__ void __launch_bounds__(kThreadsF) gmm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ sizes, float* __restrict__ y, int C, int d, int f) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int live = live_rows(sizes, e, C);
  if (r0 >= live) {
    write_zero_tile(y, e, r0, c0, C, f, kThreadsF);
    return;
  }
  const int tile_live = min(live - r0, kTile);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16i, columns tx + 16j

  __shared__ float xs[kDepthF][kTile + 1];  // [k][row], transposed
  __shared__ float ws[kDepthF][kTile];      // [k][col]

  const float* xe = x + ((size_t)e * C + r0) * d;
  const float* we = w + (size_t)e * d * f;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kDepthF) {
    __syncthreads();
    for (int i = tid; i < kTile * kDepthF; i += kThreadsF) {
      const int r = i / kDepthF, k = i - r * kDepthF;  // coalesced along k
      xs[k][r] = (r < tile_live && k0 + k < d) ? xe[(size_t)r * d + k0 + k] : 0.f;
      const int kr = i / kTile, c = i - kr * kTile;    // coalesced along f
      ws[kr][c] = (k0 + kr < d && c0 + c < f) ? we[(size_t)(k0 + kr) * f + c0 + c] : 0.f;
    }
    __syncthreads();
    if (ty < tile_live) {
#pragma unroll
      for (int k = 0; k < kDepthF; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  const int nrows = min(kTile, C - r0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c0 + c < f)
        y[((size_t)e * C + r0 + r) * f + c0 + c] = r < tile_live ? acc[i][j] : 0.f;
    }
  }
}

// ------------------------------------------------------- skinny (C <= 16)

constexpr int kThreadsS = 256;
constexpr int kColsS = 128;                   // columns of one block: 16 groups of 8
constexpr int kGroupsS = kColsS / 8;          // threads that share a d-row
constexpr int kSlicesS = kThreadsS / kGroupsS;  // 16 interleaved slices of d

// eight consecutive values (16 bytes of bf16, 32 of fp32) as fp32
__device__ __forceinline__ void unpack8(const uint4 (&u)[1], float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const uint4 (&u)[2], float (&o)[8]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    o[4 * c] = __uint_as_float(u[c].x);
    o[4 * c + 1] = __uint_as_float(u[c].y);
    o[4 * c + 2] = __uint_as_float(u[c].z);
    o[4 * c + 3] = __uint_as_float(u[c].w);
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

constexpr int kStagesS = 8;  // d-rows of weights in flight per thread
constexpr int kRedS = kSlicesS / 2 * kColsS;  // floats per row of the slices' sums

// x[e] as fp32 (or later the slices' partial sums, whichever is larger),
// then each thread's ring of weight loads
constexpr size_t skinny_smem(int CM, int d, int itemsize) {
  return sizeof(float) * (size_t)CM * (d > kRedS ? d : kRedS) +
         (size_t)kStagesS * kThreadsS * 8 * itemsize;
}

// The weight stream of one thread: row j of its slice lands in ring stage
// j % kStagesS while rows j + 1 ... j + kStagesS - 1 are in flight; the
// first kStagesS - 1 were issued by the caller.  NR rows of x are live.
template <int NR, int CM, typename T>
__device__ __forceinline__ void stream_rows(float (&acc)[CM][8], const float* xsl, uint4* ring,
                                            const T* wc, size_t step, int nk) {
  using namespace hopper;
  constexpr int kVec = 8 * (int)sizeof(T) / 16;
  constexpr int kPerVec = 16 / (int)sizeof(T);
  for (int j = 0; j < nk; ++j) {
    const int jn = j + kStagesS - 1;
    if (jn < nk)
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        cp_async16(ring + (size_t)(jn % kStagesS) * kThreadsS * kVec + v,
                   wc + jn * step + v * kPerVec);
    cp_async_commit();
    cp_async_wait<kStagesS - 1>();  // row j has landed
    uint4 raw[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) raw[v] = ring[(size_t)(j % kStagesS) * kThreadsS * kVec + v];
    float wv[8];
    unpack8(raw, wv);
    const float* xk = xsl + (size_t)j * kSlicesS * CM;  // x[0:CM][k], k = sl + 16 j
    float xr[NR];
    if constexpr (NR == 1) {
      xr[0] = xk[0];
    } else if constexpr (NR == 2) {
      const float2 t = *reinterpret_cast<const float2*>(xk);
      xr[0] = t.x;
      xr[1] = t.y;
    } else {
#pragma unroll
      for (int r4 = 0; r4 < NR / 4; ++r4) {
        const float4 t = reinterpret_cast<const float4*>(xk)[r4];
        xr[4 * r4] = t.x;
        xr[4 * r4 + 1] = t.y;
        xr[4 * r4 + 2] = t.z;
        xr[4 * r4 + 3] = t.w;
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(xr[i], wv[c], acc[i][c]);
  }
}

// One block per (128-column tile, expert).  Each thread owns 8 consecutive
// columns and one of 16 interleaved slices of d.  It keeps kStagesS d-rows
// of its columns in flight with cp.async into a ring of its own in shared
// memory (no block barrier: a thread reads only what it copied), while x[e]
// is staged whole in shared memory as fp32, transposed to [k][row]; then it
// does 8 fp32 FMAs per live row of x and d-row (the live rows' count is
// read on the device and rounded up to 1, 2, 4, 8 or 16).  The slices are summed through shared
// memory in a fixed tree order.
template <typename T, int CM>
__global__ void __launch_bounds__(kThreadsS) gmm_skinny_kernel(
    const T* __restrict__ x,  // (E, C, d), d % 8 == 0, 16-byte aligned
    const T* __restrict__ w,  // (E, d, f), f % 8 == 0, 16-byte aligned
    const int* __restrict__ sizes, T* __restrict__ y, int C, int d, int f) {
  using namespace hopper;
  constexpr int kVec = 8 * (int)sizeof(T) / 16;  // 16-byte pieces of 8 columns
  constexpr int kPerVec = 16 / (int)sizeof(T);    // elements per piece
  const int e = blockIdx.y;
  const int c0 = blockIdx.x * kColsS;
  const int tid = threadIdx.x;
  const int cg = tid % kGroupsS, sl = tid / kGroupsS;
  const int col = c0 + 8 * cg;
  const int live = live_rows(sizes, e, C);
  T* ye = y + (size_t)e * C * f;
  if (live == 0) {  // an empty group: zeros, no w[e] read
    const float z[8] = {};
    for (int r = sl; r < C; r += kSlicesS)
      if (col < f) store8(ye + (size_t)r * f + col, z);
    return;
  }
  extern __shared__ float4 smem_s[];
  float* xs = reinterpret_cast<float*>(smem_s);  // [d][CM]; later [slice][CM][kColsS]
  uint4* ring = reinterpret_cast<uint4*>(xs + (size_t)CM * (d > kRedS ? d : kRedS)) +
                tid * kVec;  // [stage][thread][kVec]
  const bool own = col < f;
  const int nk = own && sl < d ? (d - sl + kSlicesS - 1) / kSlicesS : 0;
  const T* wc = w + (size_t)e * d * f + col + (size_t)sl * f;
  const size_t step = (size_t)kSlicesS * f;

  // the first kStagesS - 1 rows are in flight before x is staged
#pragma unroll
  for (int j = 0; j < kStagesS - 1; ++j) {
    if (j < nk)
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        cp_async16(ring + (size_t)j * kThreadsS * kVec + v, wc + j * step + v * kPerVec);
    cp_async_commit();
  }
  const T* xe = x + (size_t)e * C * d;
  const int nvec = d / kPerVec;  // 16-byte pieces per row of x
#pragma unroll 4
  for (int i = tid; i < CM * nvec; i += kThreadsS) {
    const int r = i / nvec, k = (i - r * nvec) * kPerVec;
    float v[kPerVec];
    if (r < live) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xe + (size_t)r * d + k));
      if constexpr (kVec == 1) {
        const uint4 one[1] = {u};
        unpack8(one, v);
      } else {
        v[0] = __uint_as_float(u.x);
        v[1] = __uint_as_float(u.y);
        v[2] = __uint_as_float(u.z);
        v[3] = __uint_as_float(u.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerVec; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) xs[(k + j) * CM + r] = v[j];
  }
  __syncthreads();

  float acc[CM][8];
#pragma unroll
  for (int r = 0; r < CM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  // FMAs for the live rows only (rounded up to 1, 2, 4, 8, 16)
  const float* xsl = xs + (size_t)sl * CM;
  if (live <= 1)
    stream_rows<1>(acc, xsl, ring, wc, step, nk);
  else if (live <= 2)
    stream_rows<2>(acc, xsl, ring, wc, step, nk);
  else if (CM == 4 || live <= 4)
    stream_rows<(4 < CM ? 4 : CM)>(acc, xsl, ring, wc, step, nk);
  else if (CM == 8 || live <= 8)
    stream_rows<(8 < CM ? 8 : CM)>(acc, xsl, ring, wc, step, nk);
  else
    stream_rows<CM>(acc, xsl, ring, wc, step, nk);
  cp_async_wait<0>();

  // sum the slices in halves (8 + 8, 4 + 4, 2 + 2, 1 + 1), always in this order
  float* red = xs;
#pragma unroll
  for (int half = kSlicesS / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (sl >= half && sl < 2 * half)
#pragma unroll
      for (int r = 0; r < CM; ++r) {
        float4* p = reinterpret_cast<float4*>(red + (((sl - half) * CM + r) * kGroupsS + cg) * 8);
        p[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        p[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    __syncthreads();
    if (sl < half)
#pragma unroll
      for (int r = 0; r < CM; ++r) {
        const float4* p = reinterpret_cast<const float4*>(red + ((sl * CM + r) * kGroupsS + cg) * 8);
        const float4 a = p[0], b = p[1];
        acc[r][0] += a.x; acc[r][1] += a.y; acc[r][2] += a.z; acc[r][3] += a.w;
        acc[r][4] += b.x; acc[r][5] += b.y; acc[r][6] += b.z; acc[r][7] += b.w;
      }
  }
  if (sl == 0 && own) {
#pragma unroll
    for (int r = 0; r < CM; ++r) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = r < live ? acc[r][j] : 0.f;  // `_finalize`
      if (r < C) store8(ye + (size_t)r * f + col, v);
    }
  }
}

template <typename T, int CM>
cudaError_t launch_skinny_cm(const void* x, const void* w, const int* sizes, void* y, int E,
                             int C, int d, int f, cudaStream_t s) {
  const size_t smem = skinny_smem(CM, d, (int)sizeof(T));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = gmm_skinny_kernel<T, CM>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((f + kColsS - 1) / kColsS, E);
  kern<<<grid, kThreadsS, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w), sizes,
                                     static_cast<T*>(y), C, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_skinny(const void* x, const void* w, const int* sizes, void* y, int E, int C,
                          int d, int f, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || d % 8 || f % 8 || C > 16)
    return cudaErrorInvalidValue;
  if (C <= 4) return launch_skinny_cm<T, 4>(x, w, sizes, y, E, C, d, f, s);
  if (C <= 8) return launch_skinny_cm<T, 8>(x, w, sizes, y, E, C, d, f, s);
  return launch_skinny_cm<T, 16>(x, w, sizes, y, E, C, d, f, s);
}

// ------------------------------------------------------------ wgmma (bf16)

constexpr int kRowsW = 128;                    // rows of one output tile (64 per warpgroup)
constexpr int kColsW = 128;                    // columns of one output tile
constexpr int kDepthW = 64;                    // d per stage: one 128-byte swizzle span
constexpr int kStagesW = 3;                    // x and w chunks in flight
constexpr int kThreadsW = 2 * 128 + 32;        // two consumer warpgroups + the producer warp
constexpr int kBytesA = kRowsW * kDepthW * 2;  // x chunk: 128 rows x 128 B
constexpr int kBox = 64 * 128;                 // one w box: 64 rows x 64 columns
constexpr int kBytesB = kDepthW * kColsW * 2;  // w chunk: kColsW / 64 boxes
constexpr size_t kSmemW = 1024 + (size_t)kStagesW * (kBytesA + kBytesB);

// two blocks fit an SM (registers and shared memory), so one block's
// prologue and epilogue overlap the other's products
__global__ void __launch_bounds__(kThreadsW, 2) gmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx,  // x (E, C, d): boxes of 128 rows x 64
    const __grid_constant__ CUtensorMap tw,  // w (E, d, f): boxes of 64 rows x 64 columns
    const __grid_constant__ CUtensorMap ty,  // y (E, C, f): boxes of 64 rows x 64 columns
    const int* __restrict__ sizes, __nv_bfloat16* __restrict__ y, int C, int d, int f) {
  using namespace hopper;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kRowsW;
  const int c0 = blockIdx.x * kColsW;
  const int live = live_rows(sizes, e, C);
  const int tid = threadIdx.x;
  if (r0 >= live) {  // the whole tile is past the group: zeros, no w[e] read
    const int nrows = min(kRowsW, C - r0);
    const int nseg = min(kColsW, f - c0) / 8;  // f % 8 == 0: 16-byte segments
    for (int i = tid; i < nrows * (kColsW / 8); i += kThreadsW) {
      const int r = i / (kColsW / 8), sg = i % (kColsW / 8);
      if (sg < nseg)
        *reinterpret_cast<uint4*>(&y[((size_t)e * C + r0 + r) * f + c0 + 8 * sg]) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStagesW], empty[kStagesW];
  uint8_t* as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [stage] x chunks
  uint8_t* bs = as + kStagesW * kBytesA;                                       // [stage] w chunks
  if (tid == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int nk = (d + kDepthW - 1) / kDepthW;
  const int wg = tid / 128;
  if (wg == 2) {  // the producer warp: one lane issues every copy
    if (tid % 32 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStagesW;
        if (kt >= kStagesW) mbar_wait(&empty[s], (kt / kStagesW - 1) & 1);
        mbar_expect_tx(&full[s], kBytesA + kBytesB);
        tma_load_3d(as + s * kBytesA, &tx, &full[s], kt * kDepthW, r0, e);
        for (int h = 0; h < kColsW / 64; ++h)
          tma_load_3d(bs + s * kBytesB + h * kBox, &tw, &full[s], c0 + 64 * h,
                      kt * kDepthW, e);
      }
    }
    return;
  }

  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool wg_live = r0 + 64 * wg < live;
  const uint32_t a_addr = smem_addr(as) + wg * 64 * 128;
  const uint32_t b_addr = smem_addr(bs);
  float acc[kColsW / 2];
#pragma unroll
  for (int i = 0; i < kColsW / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStagesW;
    mbar_wait(&full[s], (kt / kStagesW) & 1);
    if (wg_live) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepthW / 16; ++kk)
        wgmma_m64n128k16_ss<1>(
            acc, gmma_desc(a_addr + s * kBytesA + kk * 32, 16, 1024, 128),
            gmma_desc(b_addr + s * kBytesB + kk * 16 * 128, kBox, 1024, 128), 1);
      wgmma_commit();
      wgmma_wait<1>();  // chunk kt - 1 is done: its stage can be refilled
      fence_regs(acc);
    }
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStagesW]);
    }
  }
  if (wg_live) {
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // epilogue: once both warpgroups are done with every stage, each writes its
  // 64 x kColsW tile in bf16 (zeros for rows in [live, C)) into one w stage,
  // swizzled as TMA reads it, and stores it box by box; rows past C and
  // columns past f fall outside the tensor map and are not written
  named_barrier(1, 256);
  uint8_t* ys = bs + wg * kBytesB;  // [box][64 rows][128 B]
  const int r = 16 * warp + lane / 4;
  const bool live_a = r0 + 64 * wg + r < live;
  const bool live_b = r0 + 64 * wg + r + 8 < live;
#pragma unroll
  for (int j = 0; j < kColsW / 8; ++j) {
    const uint32_t off = (j / 8) * kBox + r * 128 + 16 * (j % 8) + 4 * (lane % 4);
    const __nv_bfloat162 va = __floats2bfloat162_rn(live_a ? acc[4 * j] : 0.f,
                                                    live_a ? acc[4 * j + 1] : 0.f);
    const __nv_bfloat162 vb = __floats2bfloat162_rn(live_b ? acc[4 * j + 2] : 0.f,
                                                    live_b ? acc[4 * j + 3] : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(ys + swizzle(off, 128)) = va;
    *reinterpret_cast<__nv_bfloat162*>(ys + swizzle(off + 8 * 128, 128)) = vb;
  }
  fence_async_smem();
  named_barrier(2 + wg, 128);
  if (tid % 128 == 0) {
    for (int h = 0; h < kColsW / 64; ++h)
      tma_store_3d(&ty, ys + h * kBox, c0 + 64 * h, r0 + 64 * wg, e);
    tma_store_drain();
  }
}

cudaError_t launch_wgmma(const void* x, const void* w, const int* sizes, void* y, int E,
                         int C, int d, int f, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || d % 8 || f % 8)
    return cudaErrorMisalignedAddress;
  CUtensorMap tx, tw, ty;
  const uint64_t xd[3] = {(uint64_t)d, (uint64_t)C, (uint64_t)E};
  const uint64_t xs[2] = {2ull * d, 2ull * d * C};
  const uint32_t xb[3] = {kDepthW, kRowsW, 1};
  const uint64_t wd[3] = {(uint64_t)f, (uint64_t)d, (uint64_t)E};
  const uint64_t ws[2] = {2ull * f, 2ull * f * d};
  const uint32_t wb[3] = {64, kDepthW, 1};
  cudaError_t err = hopper::make_map_bf16(&tx, x, 3, xd, xs, xb, 128);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&tw, w, 3, wd, ws, wb, 128);
  const uint64_t yd[3] = {(uint64_t)f, (uint64_t)C, (uint64_t)E};
  const uint64_t ys[2] = {2ull * f, 2ull * f * C};
  const uint32_t yb[3] = {64, 64, 1};
  if (err == cudaSuccess) err = hopper::make_map_bf16(&ty, y, 3, yd, ys, yb, 128);
  if (err == cudaSuccess) err = hopper::allow_smem<gmm_wgmma_kernel>(kSmemW);
  if (err != cudaSuccess) return err;
  const dim3 grid((f + kColsW - 1) / kColsW, (C + kRowsW - 1) / kRowsW, E);
  gmm_wgmma_kernel<<<grid, kThreadsW, kSmemW, s>>>(tx, tw, ty, sizes,
                                                   static_cast<__nv_bfloat16*>(y), C, d, f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 = wmma (bf16) or the fp32
// tile kernel, 1 = wmma with 16-byte loads (x and w 16-byte aligned, d and f
// multiples of 8), 2 = wgmma (bf16, the same, and C >= 64), 3 = skinny
// (either dtype, the same alignment, and C <= 16).  Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int repro_grouped_matmul(const void* x, const void* w, const int* sizes,
                                    void* y, int E, int C, int d, int f, int dtype,
                                    int mode, void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  const dim3 grid((f + kTile - 1) / kTile, (C + kTile - 1) / kTile, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 3) {
    return static_cast<int>(
        dtype == 1 ? launch_skinny<__nv_bfloat16>(x, w, sizes, y, E, C, d, f, s)
                   : launch_skinny<float>(x, w, sizes, y, E, C, d, f, s));
  } else if (dtype == 1 && mode == 2) {
    return static_cast<int>(launch_wgmma(x, w, sizes, y, E, C, d, f, s));
  } else if (dtype == 1) {
    gmm_bf16_kernel<<<grid, kThreadsB, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        sizes, static_cast<__nv_bfloat16*>(y), C, d, f, mode);
  } else {
    gmm_f32_kernel<<<grid, kThreadsF, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sizes,
        static_cast<float*>(y), C, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}
