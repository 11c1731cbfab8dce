// Pieces shared by the flash-attention forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu): the bf16 tile geometry of a 64-row
// operand in swizzled shared memory, the tensor maps of q, k, v (strided
// head-major views) and of contiguous (B, heads, S, hd) tensors, and the
// register-side helpers around wgmma (bf16 packing of an accumulator into
// an A operand, the P·V-shaped product, quad reductions).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A 64-row bf16 tile of HD columns as TMA writes it: chunks of SW bytes a
// row (the swizzle span), 64 rows each.
template <int HD>
struct Tile {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span (bytes per smem row)
  static constexpr int CW = SW / 2;                        // head-dim columns per chunk
  static constexpr int NC = HD / CW;                       // chunks per row
  static constexpr int CHUNK = 64 * SW;                    // one chunk of 64 rows
  static constexpr int TILE = NC * CHUNK;                  // 64 rows x HD
};

// q/k/v tensor maps are 4-D: (hd, pos, head, batch), or (hd, head, pos,
// batch) where the head stride is the smaller (the model's transposed
// views); `swap` says which, and the coordinates follow
__device__ __forceinline__ void tma_qkv(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int col, int pos, int head, int b, int swap) {
  if (swap)
    hopper::tma_load_4d(dst, map, bar, col, head, pos, b);
  else
    hopper::tma_load_4d(dst, map, bar, col, pos, head, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x CW) += A(64 x 16, registers) * B(16 x CW, smem, MN-major)
template <int CW>
__device__ __forceinline__ void pv_wgmma(float (&o)[CW / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (CW == 64)
    hopper::wgmma_m64n64k16_rs<1>(o, a, db);
  else if constexpr (CW == 32)
    hopper::wgmma_m64n32k16_rs<1>(o, a, db);
  else
    hopper::wgmma_m64n16k16_rs<1>(o, a, db);
}

// D(64 x 64) = A(64 x HD) * B(64 x HD)^T, both K-major 64-row tiles at
// shared addresses a and b (scores from q and k, or from dO and v)
template <int HD>
__device__ __forceinline__ void qk_wgmma(float (&d)[32], uint32_t a, uint32_t b) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / (T::CW / 16)) * T::CHUNK + (kk % (T::CW / 16)) * 32;
    hopper::wgmma_m64n64k16_ss<0>(d, hopper::gmma_desc(a + off, 16, 8 * T::SW, T::SW),
                                  hopper::gmma_desc(b + off, 16, 8 * T::SW, T::SW), kk > 0);
  }
}

// the m64n64 fp32 accumulator x as bf16 A operands of a product that sums
// over its 64 columns: per 16 columns, each warp's m16n8k16 A fragment
__device__ __forceinline__ void acc_to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// D(64 x HD) += A(64 x 64, registers as acc_to_a gives them) * B, B a
// 64-row tile at shared address b read MN-major (its rows summed over)
template <int HD>
__device__ __forceinline__ void av_wgmma(float (&d)[Tile<HD>::NC][Tile<HD>::CW / 2],
                                         const uint32_t (&a)[4][4], uint32_t b) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < T::NC; ++c)
      pv_wgmma<T::CW>(d[c], a[kk],
                      hopper::gmma_desc(b + c * T::CHUNK + kk * 16 * T::SW, 8 * T::SW,
                                        8 * T::SW, T::SW));
}

// the accumulator d (64 rows x HD, this thread's rows r and r + 8) times
// `mul`, in bf16, into the swizzled 64-row tile at `tile`, as TMA stores it
template <int HD>
__device__ __forceinline__ void acc_to_tile(uint8_t* tile,
                                            const float (&d)[Tile<HD>::NC][Tile<HD>::CW / 2],
                                            int r, int lane, float mul_a, float mul_b) {
  using T = Tile<HD>;
#pragma unroll
  for (int c = 0; c < T::NC; ++c)
#pragma unroll
    for (int j = 0; j < T::CW / 8; ++j) {
      const uint32_t off = c * T::CHUNK + r * T::SW + 16 * j + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(tile + hopper::swizzle(off, T::SW)) =
          pack_bf16(d[c][4 * j] * mul_a, d[c][4 * j + 1] * mul_a);
      *reinterpret_cast<uint32_t*>(tile + hopper::swizzle(off + 8 * T::SW, T::SW)) =
          pack_bf16(d[c][4 * j + 2] * mul_b, d[c][4 * j + 3] * mul_b);
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the tensor map of q, k or v: boxes of 64 positions x one swizzle span of
// the head dim; rows past S read as zeros
inline cudaError_t qkv_map(CUtensorMap* map, const void* p, int hd, int S, int heads, int B,
                           long long sb, long long sh, long long ss, int* swap) {
  const int sw = hd * 2 < 128 ? hd * 2 : 128;
  *swap = sh < ss;
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)(*swap ? heads : S),
                            (uint64_t)(*swap ? S : heads), (uint64_t)B};
  const uint64_t strides[3] = {2ull * (uint64_t)(*swap ? sh : ss),
                               2ull * (uint64_t)(*swap ? ss : sh), 2ull * (uint64_t)sb};
  const uint32_t box[4] = {(uint32_t)(sw / 2), *swap ? 1u : 64u, *swap ? 64u : 1u, 1u};
  return hopper::make_map_bf16(map, p, 4, dims, strides, box, sw);
}

// the map of a contiguous (B, heads, S, hd) tensor
inline cudaError_t dense_map(CUtensorMap* map, const void* p, int hd, int S, int heads, int B) {
  int swap = 0;
  return qkv_map(map, p, hd, S, heads, B, (long long)heads * S * hd, (long long)S * hd, hd,
                 &swap);
}

inline bool tma_ok(const void* p, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0;
}

}  // namespace flash
