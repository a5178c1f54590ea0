// Pointwise (1x1) convolutions on int8 activations with the requantizing
// epilogue fused, as (M, K) x (K, N) products of the NHWC activations
// flattened to rows.
//
// B7 pw_conv_a8 replaces fastscnn_tpu/ops/pallas/int8_pw.py::pw_conv_a8:
//    int8 x (exact as bf16) times bf16 effective weights, f32 sums,
//    + bias, [ReLU], -> bf16, or -> clip(round(.), +-127) int8.
// B8 pw_conv_w8a8 replaces int8_pw.py::pw_conv_w8a8:
//    int8 x times int8 weights, int32 sums, * per-channel f32 scale,
//    + bias, [ReLU], -> bf16 or int8 as above.
//
// What bounds them on an H100. On the serving path a frame runs them at 23
// (B7) or 25 (B8) sites with K from 32 to 768 and N from 48 to 768: about
// 136 MB of activations in and out but 11 G operations, so at the card's
// tensor-core rates (989 TFLOP/s bf16, 1,979 TOP/s int8) bytes and
// operations bound them about equally (~0.04 ms a frame). These first
// kernels run on the CUDA cores instead: B7 one f32 FMA per MAC (67 TFLOP/s
// peak), B8 __dp4a, four int8 MACs per instruction. So they are bound by
// their arithmetic, several times their tensor-core bound; wgmma is the
// later redesign.
//
// The design of both: one block of 256 threads per 64 x 64 output tile;
// the K dimension in chunks of 64 staged in shared memory (the activation
// tile row-major, the weight tile with K outermost); each thread keeps a
// 4 x 4 register tile of sums and reads its operands as 16-byte vectors.
// A ragged last M or N tile is masked, and a K chunk past K is zeros (the
// TPU kernel's M % 32 fallback to XLA becomes this mask).
//
// Arithmetic: B8's int32 sums are exact (|sum| <= 127 * 127 * K < 2^24 for
// K <= 768, so the int32 -> f32 conversion is exact too); then
// __fmul_rn(acc, cs) and __fadd_rn(., b), as the plain version. B7 adds
// the products k = 0..K-1 in order into one f32 sum per output. Each
// product of an int8 value and a bf16 value is exact in f32 (at most 15
// significant bits), so an FMA rounds exactly as the plain version's
// separate multiply and add, and kernel and plain version agree bit for
// bit. A zero-padded k adds 0, which leaves the sum's value unchanged.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 tile of outputs
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;

// Store the 4 x 4 epilogue values of one thread: t = acc + b, [ReLU], then
// bf16 or clip(round(t), -127, 127) int8 (rintf rounds half to even, as
// jnp.round and torch.round).
__device__ __forceinline__ void store_epilogue(void* out, float t, int64_t idx, int relu,
                                               int qout) {
  if (relu) t = fmaxf(t, 0.f);
  if (qout) {
    static_cast<int8_t*>(out)[idx] = (int8_t)fminf(fmaxf(rintf(t), -127.f), 127.f);
  } else {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(t);
  }
}

// B8: int8 x int8 -> int32 with __dp4a. xs holds the activation chunk as
// packed int32 (4 consecutive k of a row), ws the weight chunk packed the
// same way along k for each output column.
__global__ void __launch_bounds__(kThreads)
pw_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ cs, const float* __restrict__ b, void* __restrict__ out,
               int M, int K, int N, int relu, int qout) {
  constexpr int kK4 = kBK / 4;
  __shared__ __align__(16) int xs[kBM][kK4 + 4];  // +4 keeps rows 16-byte aligned, staggers banks
  __shared__ __align__(16) int ws[kK4][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kK4; i += kThreads) {
      const int r = i / kK4, k4 = i % kK4;
      const int m = m0 + r, k = k0 + 4 * k4;
      xs[r][k4] = (m < M && k < K) ? *reinterpret_cast<const int*>(x + (int64_t)m * K + k) : 0;
    }
    for (int i = threadIdx.x; i < kK4 * kBN; i += kThreads) {
      const int k4 = i / kBN, c = i % kBN;
      const int n = n0 + c, k = k0 + 4 * k4;
      int v = 0;
      if (n < N && k < K) {
        const int8_t* p = w + (int64_t)k * N + n;
        v = (int)((uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[N] << 8) |
                  ((uint32_t)(uint8_t)p[2 * N] << 16) | ((uint32_t)(uint8_t)p[3 * N] << 24));
      }
      ws[k4][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < kK4; k4 += 4) {
      int4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const int4*>(&xs[ty * 4 + i][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 bq = *reinterpret_cast<const int4*>(&ws[k4 + q][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = __dp4a(av, bq.x, acc[i][0]);
          acc[i][1] = __dp4a(av, bq.y, acc[i][1]);
          acc[i][2] = __dp4a(av, bq.z, acc[i][2]);
          acc[i][3] = __dp4a(av, bq.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        store_epilogue(out, __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), cs[n]), b[n]),
                       (int64_t)m * N + n, relu, qout);
    }
  }
}

// B7: int8 x bf16 -> f32, k in order. xs holds the activation chunk as f32
// (int8 values, exact), ws the weight chunk as f32 (bf16 values, exact).
__global__ void __launch_bounds__(kThreads)
pw_a8_kernel(const int8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ b, void* __restrict__ out, int M, int K, int N, int relu,
             int qout) {
  __shared__ __align__(16) float xs[kBM][kBK + 4];  // +4 keeps rows 16-byte aligned
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // activations: 4 int8 of a row per thread (K % 4 == 0), one float4 store
    for (int i = threadIdx.x; i < kBM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), k4 = i % (kBK / 4);
      const int m = m0 + r, k = k0 + 4 * k4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k < K) {
        const char4 q = *reinterpret_cast<const char4*>(x + (int64_t)m * K + k);
        v = make_float4((float)q.x, (float)q.y, (float)q.z, (float)q.w);
      }
      *reinterpret_cast<float4*>(&xs[r][4 * k4]) = v;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int n = n0 + c, k = k0 + kk;
      ws[kk][c] = (n < N && k < K) ? __bfloat162float(w[(int64_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&xs[ty * 4 + i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bq = *reinterpret_cast<const float4*>(&ws[kk + q][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, bq.x, acc[i][0]);
          acc[i][1] = fmaf(av, bq.y, acc[i][1]);
          acc[i][2] = fmaf(av, bq.z, acc[i][2]);
          acc[i][3] = fmaf(av, bq.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store_epilogue(out, __fadd_rn(acc[i][j], b[n]), (int64_t)m * N + n, relu, qout);
    }
  }
}

dim3 grid_for(int m, int n) { return dim3((n + kBN - 1) / kBN, (m + kBM - 1) / kBM); }

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (m, k) int8, k % 4 == 0 and 4-byte aligned rows; w (k, n) int8; cs, b
// (n) f32; out (m, n) bf16, or int8 when qout.
extern "C" int fastscnn_pw_conv_w8a8(const void* x, const void* w, const void* cs, const void* b,
                                     void* out, int m, int k, int n, int relu, int qout,
                                     void* stream) {
  if (k % 4 != 0 || (m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  pw_w8a8_kernel<<<grid_for(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(cs),
      static_cast<const float*>(b), out, m, k, n, relu, qout);
  return (int)cudaGetLastError();
}

// x (m, k) int8 as above; w (k, n) bf16; b (n) f32; out as above.
extern "C" int fastscnn_pw_conv_a8(const void* x, const void* w, const void* b, void* out, int m,
                                   int k, int n, int relu, int qout, void* stream) {
  if (k % 4 != 0 || (m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  pw_a8_kernel<<<grid_for(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), out, m, k, n, relu, qout);
  return (int)cudaGetLastError();
}
