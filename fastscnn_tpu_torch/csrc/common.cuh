// Shared helpers for the port's kernels: bf16/f32 loads and stores,
// asynchronous copies into shared memory, and the C-entry convention
// (every entry returns cudaGetLastError() after its launch so the Python
// wrapper can raise on a refused launch).
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

namespace fastscnn {

// A launch's opt-in to more than 48 KB of dynamic shared memory
// (cudaFuncSetAttribute) holds for the current device only, so a kernel
// keeps one record of it a device: the host thread's current device,
// which the Python wrappers set to the tensors' (ops/cuda/_build.launch).
constexpr int kMaxDevices = 64;

inline int current_device() {
  int device = 0;
  cudaGetDevice(&device);
  return device;
}

// One kernel's opt-in, kept as the most bytes allowed so far on each
// device: a launch that asks for no more than that sets nothing, so a
// kernel at one size sets the attribute once a device. Held as a
// function-local static, one a kernel (an instantiation at a stride). The
// allowance only grows, under a lock, so threads that launch the kernel on
// one or several cards at once never lower it under each other.
class SmemOptIn {
 public:
  cudaError_t allow(const void* kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    const int device = current_device();
    if (device >= kMaxDevices)
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (allowed_[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
    std::lock_guard<std::mutex> lock(mutex_);
    if (allowed_[device].load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) allowed_[device].store(bytes, std::memory_order_release);
    return e;
  }

 private:
  std::atomic<int> allowed_[kMaxDevices] = {};
  std::mutex mutex_;
};

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
  // the same from shared memory (one ld.shared of VEC * sizeof(T) bytes)
  __device__ __forceinline__ void load_shared(const T* p) {
    raw = *reinterpret_cast<const Raw*>(p);
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

// 8 f32 values rounded to T, stored with one 16-byte access (bf16) or two.
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    store_pack<T, 8>(p, v);
  } else {
    store_pack<T, 4>(p, reinterpret_cast<const float(&)[4]>(v[0]));
    store_pack<T, 4>(p + 4, reinterpret_cast<const float(&)[4]>(v[4]));
  }
}

// Element i of a weight or bias vector stored as f32 or bf16, as f32.
__device__ __forceinline__ float weight_at(const void* p, int bf16, int64_t i) {
  return bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// VEC f32 values from shared memory. Volatile, so that the compiler reads
// them where they are used rather than keeping all 9 x VEC taps live in
// registers for a whole walk, which would halve the blocks an SM holds.
template <int VEC>
__device__ __forceinline__ void lds_f32(const float* p, float (&v)[VEC]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[i]), "=f"(v[i + 1]), "=f"(v[i + 2]), "=f"(v[i + 3])
                   : "r"(a + 4 * i));
  } else if constexpr (VEC == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v[0]), "=f"(v[1]) : "r"(a));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(a));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// BYTES (16, 8 or 4) from global to shared memory, asynchronously;
// src_bytes 0 writes zeros and reads nothing. 16 bytes bypass L1 (.cg).
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int src_bytes) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async moves 4, 8 or 16 bytes");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

}  // namespace fastscnn
