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

// The unsigned type of a BYTES-wide load or store (one instruction).
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

// VEC consecutive elements of T (VEC * sizeof(T) <= 16 bytes) held as one
// raw register value: loaded with one read-only (ld.global.nc) access,
// read out as f32. The address must be aligned to VEC * sizeof(T) bytes.
// A 16-byte load also asks L2 to fetch the 256-byte block around it: the
// kernels that use it stream NHWC rows, whose next pixels the
// neighbouring threads want.
template <typename T, int VEC>
struct Pack {
  using Raw = typename RawOf<VEC * (int)sizeof(T)>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (sizeof(Raw) == 16) {
      asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
          : "l"(p));
    } else {
      raw = __ldg(reinterpret_cast<const Raw*>(p));
    }
  }
  __device__ __forceinline__ void zero() { raw = Raw{}; }
  // element i as f32 (exact: a bf16 is the top half of its f32)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return reinterpret_cast<const float*>(&raw)[i];
    } else {
      return __uint_as_float((unsigned)reinterpret_cast<const unsigned short*>(&raw)[i] << 16);
    }
  }
};

// Rounds VEC f32 values to T (as from_f32) and stores them with one access.
template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[VEC]) {
  typename Pack<T, VEC>::Raw raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<typename Pack<T, VEC>::Raw*>(p) = raw;
}

}  // namespace fastscnn
