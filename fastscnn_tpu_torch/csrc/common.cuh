// Shared helpers for the port's kernels: bf16/f32 loads and stores, and
// the C-entry convention (every entry returns cudaGetLastError() after
// its launch so the Python wrapper can raise on a refused launch).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fastscnn {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// v rounded to T's precision and back to f32 (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// lo + (hi - lo) * w with every operation rounded on its own (no FMA
// contraction), the exact op sequence of the plain PyTorch versions.
__device__ __forceinline__ float lerp_rn(float lo, float hi, float w) {
  return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), w));
}

}  // namespace fastscnn
