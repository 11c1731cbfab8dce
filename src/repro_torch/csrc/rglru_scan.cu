// RG-LRU linear recurrence for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_scan_kernel`): h_t = a_t * h_{t-1} + b_t over
// (B, S, D) from a zero state, the carry in fp32, the output in a's dtype.
// The TPU kernel carries the state across a sequential grid axis of
// sequence chunks in VMEM scratch; Hopper has no sequential grid, so a
// column's carry stays in one lane's register for the whole sequence.
//
// The same kernel runs the gradient backwards in time (`kRev`): for the
// cotangent g of h, dh_t = a_{t+1} * dh_{t+1} + g_t walked from t = S-1
// down to 0 (a_S = 0), db = dh and da_t = dh_t * h_{t-1} (h_{-1} = 0).  It
// reads a, g and h in place, each shifted by its own row offset (+1, 0,
// -1), and writes da and db: one launch is the whole gradient.
//
// Bound on this card: bytes.  The forward reads a and b and writes h (3 *
// B*S*D*itemsize bytes for 2 flops an element), the reverse reads three
// arrays and writes two (5 * B*S*D*itemsize for 3 flops).  A column is
// sequential in t, so the design spreads the columns thinly and keeps many
// time steps of each in flight:
//   * a block owns 32 features of one batch row (one 128-byte line a step
//     in fp32), so B*D/32 blocks fill the card down to B*D of 4,096;
//   * a loader warp streams tiles of 32 steps x 32 features (fp32; 64
//     steps in bf16) of every input into an 8-stage ring in shared memory
//     (full / empty mbarriers), 64 KB forward and 96 KB in reverse, so
//     tens of KB are in flight on each SM however few blocks it holds.
//     Where every row is 16-byte aligned (D * itemsize a multiple of 16:
//     every model width) a tile is one TMA box of a 3-D tensor map (D, S,
//     B), whose rows past either end read as zeros (a_S and h_{-1} in
//     reverse); otherwise (a ragged D such as 130) the loader's lanes load
//     the tile with plain loads, one feature each, and store zeros past
//     the edges themselves;
//   * a scan warp walks the ring, a lane a feature, with the carry in a
//     register.  Forward it writes each step's 32 outputs as one coalesced
//     store; in reverse, two outputs a step, it writes them into two
//     double-buffered output tiles in shared memory that leave by TMA
//     stores.  (Measured on the card: a 1-D bulk copy a row instead of a
//     box spent its time issuing 32 small copies a tile, bf16 as slow as
//     fp32; staging the forward's one output too made it slower, and the
//     reverse's two faster.)
// The arithmetic is the plain version's, in the same order: an fp32 carry,
// the multiply and the add rounded separately (__fmul_rn, __fadd_rn: no
// fused multiply-add), sequential in t, each output rounded once to the
// inputs' dtype (and in the reverse da rounded from the rounded dh, as the
// elementwise product of the two tensors rounds it).  So the fp32 kernel
// equals `ref.rglru_scan_ref` and `ref.rglru_scan_backward_ref` bit for
// bit, and a column's result does not depend on B or D: a tensor-parallel
// rank's features give the bits of the whole model.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kFeat = 32;     // features a block: a lane each
constexpr int kStages = 8;    // input tiles in the ring
constexpr int kObuf = 2;      // output tiles of each output in reverse
constexpr int kChunk = 16;    // steps whose inputs the scan warp reads at once
constexpr int kThreads = 64;  // the loader warp, then the scan warp

// time steps a tile: 4 KB of each input
template <typename T>
__host__ __device__ constexpr int rows_of() {
  return 128 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// inputs a stage holds: a and b forward; a, g and h in reverse; and the
// outputs a tile stages in shared memory: none forward; da and db in reverse
template <bool kRev>
__host__ __device__ constexpr int n_inputs() {
  return kRev ? 3 : 2;
}
template <bool kRev>
__host__ __device__ constexpr int n_outputs() {
  return kRev ? 2 : 0;
}

// the input ring, then kObuf output tiles of each staged output; + 128 to
// align
template <typename T, bool kRev>
constexpr size_t smem_bytes() {
  return 128 + (size_t)(kStages * n_inputs<kRev>() + kObuf * n_outputs<kRev>()) * rows_of<T>() *
                   kFeat * sizeof(T);
}

// the row of input j that step t reads: a_{t+1}, g_t and h_{t-1} in reverse
template <bool kRev>
__device__ __forceinline__ int row_of(int j, int t) {
  return kRev ? t + 1 - j : t;
}

// forward: x0 = a, x1 = b -> y0 = h.  reverse: x0 = a, x1 = g, x2 = h ->
// y0 = da, y1 = db.  All (B, S, D) contiguous; m0..m4 the tensor maps of
// x0, x1, x2, y0, y1 (boxes of 32 features x kRows steps; the outputs'
// only in reverse) where `tma`, else plain loads and stores.  Grid
// (ceil(D / 32), B).
template <typename T, bool kRev>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const __grid_constant__ CUtensorMap m0, const __grid_constant__ CUtensorMap m1,
    const __grid_constant__ CUtensorMap m2, const __grid_constant__ CUtensorMap m3,
    const __grid_constant__ CUtensorMap m4, const T* __restrict__ x0,
    const T* __restrict__ x1, const T* __restrict__ x2, T* __restrict__ y0,
    T* __restrict__ y1, int S, int D, int tma) {
  using namespace hopper;
  constexpr int N = n_inputs<kRev>();
  constexpr int NO = n_outputs<kRev>();
  constexpr int kRows = rows_of<T>();
  constexpr int TILE = kRows * kFeat;  // elements of one tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // [stage][input][row][feature], then [kObuf][output][row][feature];
  // 128-byte aligned for TMA
  T* ring = reinterpret_cast<T*>(smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));
  T* obuf = ring + kStages * N * TILE;

  const int lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kFeat;
  const size_t row0 = (size_t)blockIdx.y * S;  // this batch row's first step
  const int n_tiles = (S + kRows - 1) / kRows;
  const bool live = d0 + lane < D;  // lane f's feature d0 + f exists
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // every loader lane (lane 0 with the TMA bytes)
      mbar_init(&empty[s], 1);  // the scan warp's lane 0
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the loader warp
    const CUtensorMap* maps[3] = {&m0, &m1, &m2};
    const T* xs[3] = {x0, x1, x2};
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
      const int t0 = (kRev ? n_tiles - 1 - i : i) * kRows;
      T* stage = ring + (size_t)s * N * TILE;
      if (tma) {  // one box an input; rows and features past the edges read 0
        if (lane == 0) {
          mbar_expect_tx(&full[s], N * TILE * sizeof(T));
#pragma unroll
          for (int j = 0; j < N; ++j)
            tma_load_3d(stage + j * TILE, maps[j], &full[s], d0, row_of<kRev>(j, t0),
                        blockIdx.y);
        } else {
          mbar_arrive(&full[s]);
        }
      } else {  // lane f loads feature f of every row; zeros past the edges
#pragma unroll
        for (int j = 0; j < N; ++j)
          for (int r = 0; r < kRows; ++r) {
            const int t = row_of<kRev>(j, t0 + r);
            stage[j * TILE + r * kFeat + lane] =
                (live && t >= 0 && t < S) ? xs[j][(row0 + t) * D + d0 + lane] : from_f32<T>(0.f);
          }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the scan warp: lane f carries feature d0 + f.  Forward, each step's 32
  // outputs leave as one coalesced store.  In reverse (two outputs a step)
  // they go into one of two output tiles in shared memory, which leave
  // through TMA stores while the next tile is scanned (without TMA, through
  // the lanes' own stores after the tile).  A full tile's inputs are read
  // kChunk steps at a time into registers: shared loads issued after the
  // reverse's shared stores would otherwise each wait behind them.
  const bool all_live = d0 + kFeat <= D;  // warp-uniform: no lane masked
  float carry = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int t0 = (kRev ? n_tiles - 1 - i : i) * kRows;
    const int n = min(kRows, S - t0);
    T* out = obuf + (i % kObuf) * NO * TILE + lane;  // reverse: da, then db
    T* direct = y0 + (row0 + t0) * D + d0 + lane;    // h, or da
    if (kRev && tma && i >= kObuf) {  // the stores of tile i - kObuf have read it
      if (lane == 0) tma_store_wait_read<kObuf - 1>();
      __syncwarp();
    }
    mbar_wait(&full[s], (i / kStages) & 1);
    const T* in = ring + (size_t)s * N * TILE + lane;
    // one step from its inputs x (a_S and h_{-1} read as 0); forward, h goes
    // to p where `store`, in reverse da and db to row r of the output tiles
    auto step = [&](const float* x, int r, T* p, bool store) {
      carry = __fadd_rn(__fmul_rn(x[0], carry), x[1]);
      const T h = from_f32<T>(carry);  // h, or dh in reverse
      if constexpr (!kRev) {
        if (store) *p = h;
      } else {
        out[r * kFeat] = from_f32<T>(__fmul_rn(to_f32(h), x[2]));
        out[TILE + r * kFeat] = h;
      }
    };
    if (n == kRows) {
#pragma unroll
      for (int c = 0; c < kRows / kChunk; ++c) {
        const int r0 = (kRev ? kRows / kChunk - 1 - c : c) * kChunk;
        float x[kChunk][N];
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
#pragma unroll
          for (int j = 0; j < N; ++j) x[u][j] = to_f32(in[j * TILE + (r0 + u) * kFeat]);
        if (kRev) {
#pragma unroll
          for (int u = kChunk - 1; u >= 0; --u) step(x[u], r0 + u, nullptr, false);
        } else if (all_live) {
          T* p = direct + (size_t)r0 * D;
#pragma unroll
          for (int u = 0; u < kChunk; ++u, p += D) step(x[u], r0 + u, p, true);
        } else {
          T* p = direct + (size_t)r0 * D;
#pragma unroll
          for (int u = 0; u < kChunk; ++u, p += D) step(x[u], r0 + u, p, live);
        }
      }
    } else {
      for (int k = 0; k < n; ++k) {
        const int r = kRev ? n - 1 - k : k;
        float x[N];
#pragma unroll
        for (int j = 0; j < N; ++j) x[j] = to_f32(in[j * TILE + r * kFeat]);
        step(x, r, direct + (size_t)r * D, live);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this input stage is read
    if constexpr (kRev) {
      out -= lane;
      if (tma) {  // rows past S and features past D fall outside the maps
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          tma_store_3d(&m3, out, d0, t0, blockIdx.y);
          tma_store_3d(&m4, out + TILE, d0, t0, blockIdx.y);
          tma_store_commit();
        }
      } else if (live) {
        T* db = y1 + (row0 + t0) * D + d0 + lane;
        for (int r = 0; r < n; ++r) {
          direct[(size_t)r * D] = out[r * kFeat + lane];
          db[(size_t)r * D] = out[TILE + r * kFeat + lane];
        }
      }
    }
  }
  if (kRev && tma && lane == 0) tma_store_drain();
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, bool kRev>
cudaError_t launch(const void* x0, const void* x1, const void* x2, void* y0, void* y1, int B,
                   int S, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kRev>();
  cudaError_t e = hopper::allow_smem<rglru_scan_kernel<T, kRev>>(smem);
  if (e != cudaSuccess) return e;
  // TMA needs 16-byte aligned bases and row strides (D * itemsize)
  const void* ps[5] = {x0, x1, kRev ? x2 : x0, y0, kRev ? y1 : y0};
  uintptr_t bases = 0;
  for (const void* p : ps) bases |= reinterpret_cast<uintptr_t>(p);
  const int tma = bases % 16 == 0 && ((size_t)D * sizeof(T)) % 16 == 0;
  CUtensorMap maps[5];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)D * sizeof(T), (uint64_t)S * D * sizeof(T)};
    const uint32_t box[3] = {(uint32_t)kFeat, (uint32_t)rows_of<T>(), 1u};
    for (int j = 0; j < (kRev ? 5 : 2) && e == cudaSuccess; ++j)
      e = hopper::make_map(&maps[j], map_type<T>(), ps[j], 3, dims, strides, box, 0);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((D + kFeat - 1) / kFeat, B);
  rglru_scan_kernel<T, kRev><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const T*>(x0),
      static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<T*>(y0),
      static_cast<T*>(y1), S, D, tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x0, const void* x1, const void* x2, void* y0, void* y1, int B,
                     int S, int D, int reverse, cudaStream_t s) {
  return reverse ? launch<T, true>(x0, x1, x2, y0, y1, B, S, D, s)
                 : launch<T, false>(x0, x1, x2, y0, y1, B, S, D, s);
}

}  // namespace

// Forward (reverse = 0): x0 = a, x1 = b, y0 = h; x2 and y1 unused.
// Reverse (reverse = 1), the gradient for the cotangent g of h: x0 = a,
// x1 = g, x2 = h, y0 = da, y1 = db.  Every array (B, S, D) contiguous, of
// one dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok).
extern "C" int repro_rglru_scan(const void* x0, const void* x1, const void* x2, void* y0,
                                void* y1, int B, int S, int D, int dtype, int reverse,
                                void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (reverse && (x2 == nullptr || y1 == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(x0, x1, x2, y0, y1, B, S, D, reverse, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x0, x1, x2, y0, y1, B, S, D, reverse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
