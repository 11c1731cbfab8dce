// RG-LRU linear recurrence for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_scan_kernel`): h_t = a_t * h_{t-1} + b_t over
// (B, S, D) from a zero state, the carry in fp32, the output in a's dtype.
// The TPU kernel carries the state across a sequential grid axis of
// sequence chunks in VMEM scratch; Hopper has no sequential grid, so here
// one thread owns one (row, feature) column and walks the whole sequence
// with the carry in a register.
//
// Bound on this card: bytes.  Each element of a and b is read once and each
// output written once (3 * B*S*D*itemsize bytes) for 2 flops per element.
// Design: neighbouring threads own neighbouring features, so every load and
// store of a warp is one contiguous run of D.  The sequence loop is unrolled
// by kUnroll: the loads of kUnroll steps, which do not depend on the carry,
// are all issued before the first multiply-add waits on them, keeping
// 2*kUnroll loads in flight per thread.  A ragged D is masked per thread and
// any S works (a remainder loop).  The multiply and the add are rounded
// separately (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain
// PyTorch version computes them, so the two agree bit for bit.  With B*D
// columns the grid holds B*D threads: at the serving shape (B=8, D=4096)
// about 250 per SM, so this simple design is latency-bound; spreading S over
// blocks (chunked scan with a carry pass) is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const T* __restrict__ a,  // (B, S, D)
    const T* __restrict__ b,  // (B, S, D)
    T* __restrict__ h,        // (B, S, D)
    int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * S * D + d;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float carry = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = (size_t)(t + u) * D;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      hp[(size_t)(t + u) * D] = from_f32<T>(carry);
    }
  }
  for (; t < S; ++t) {
    const size_t off = (size_t)t * D;
    carry = __fadd_rn(__fmul_rn(to_f32(ap[off]), carry), to_f32(bp[off]));
    hp[off] = from_f32<T>(carry);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int D,
                   cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), S, D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (a, b and h share it).
// Returns a cudaError_t (0 = ok).
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h, int B, int S,
                                int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(a, b, h, B, S, D, s);
    case 1:
      return (int)launch<__nv_bfloat16>(a, b, h, B, S, D, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
