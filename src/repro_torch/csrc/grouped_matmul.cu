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
// So the design reads each live expert's weights once and no other's:
// one thread block per (64-column f tile, 64-row C tile, expert e) reads
// sizes[e] itself, and a tile whose first row is past the group writes
// zeros and exits without touching w[e] — an empty or dead expert costs
// no weight traffic.  Live tiles walk d in 64-deep chunks staged in shared
// memory, the next chunk's loads in flight in registers while the current
// one is multiplied; rows past the group are staged as zeros and never
// read.  bf16: four warps, each a 16-row strip x 64 columns of 16x16x16
// wmma fragments with fp32 accumulators; a warp whose strip lies past the
// group skips its products.  fp32: 256 threads with a 4x4 register tile
// each and fp32 FMAs on the CUDA cores (the tensor cores' fp32 path is
// TF32, which drops mantissa bits).  Simple first: no TMA, no wgmma, no
// cp.async pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec (bf16 only): x and w are 16-byte
// aligned and d, f multiples of 8.  Launches on `stream`; returns the
// launch's cudaError_t.
extern "C" int repro_grouped_matmul(const void* x, const void* w, const int* sizes,
                                    void* y, int E, int C, int d, int f, int dtype,
                                    int vec, void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  const dim3 grid((f + kTile - 1) / kTile, (C + kTile - 1) / kTile, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    gmm_bf16_kernel<<<grid, kThreadsB, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        sizes, static_cast<__nv_bfloat16*>(y), C, d, f, vec);
  } else if (dtype == 0) {
    gmm_f32_kernel<<<grid, kThreadsF, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sizes,
        static_cast<float*>(y), C, d, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
