// Depthwise 3x3 and fused depthwise-separable (DSConv) kernels for the
// LTD stem of the BN-folded serving graph, NHWC, bf16 or f32 in and out,
// f32 accumulation.
//
// B3 ds_conv3x3_pw replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    ds_conv3x3_pw_pallas:  relu(pw1x1(round(relu(dw3x3(x) + b_dw))) + b_pw)
// B4 dw_conv3x3 replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    dw_conv3x3_pallas:     [relu](dw3x3(x) [+ b])
//
// What bounds them on an H100: bytes. A tap sum is 9 FMAs per output
// element and the 1x1 is C (32 or 48) MACs per output, far below the
// ~295 operations per byte where Hopper's compute would start to bind.
// The TPU kernels' whole point is to touch device memory as little as
// possible, and B3 keeps the dw activation out of device memory entirely.
//
// The simple design here: one block per (image, output row, W tile).
// Stride-2 column taps are plain strided loads (the TPU kernel's
// pair-merged lanes existed only for Mosaic's unit-stride slices), the
// pad-1 border is handled by bounds checks rather than a padded copy of
// the input, and odd H/W (511x1023 after the stem conv's padding=0) need
// nothing special. B3 computes its tile's dw activation row into shared
// memory, rounds it to the compute dtype (as the unfused bf16 graph hands
// a bf16 tensor from the dw conv to the pw conv), then takes the C->Cout
// dot against the (C, Cout) weights staged in shared memory. Neighbouring
// threads own neighbouring channels, so global loads and stores coalesce.
// Input rows are re-read from L2 by neighbouring output rows (1.5x at
// stride 2); a multi-row cp.async/TMA ring that reads them once is the
// B5 (multirow) port.
//
// Arithmetic order: taps (di, dj) in row-major order, then + bias, each
// operation rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction);
// the pw dot runs c = 0..C-1 the same way. The plain PyTorch versions in
// ops/cuda/dw_conv.py do exactly these operations, so kernel and plain
// version agree bit for bit.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;
constexpr int kDsTileW = 64;  // output columns per B3 block

// f32 sum of the 9 taps of channel c at output (n, ho, wo); taps outside
// the input are the zero padding and are skipped.
template <typename T>
__device__ __forceinline__ float dw3x3_at(const T* __restrict__ x, const float* __restrict__ w9,
                                          int n, int ho, int wo, int c, int H, int W, int C,
                                          int stride, int pad) {
  float acc = 0.f;
  const int hi0 = ho * stride - pad;
  const int wi0 = wo * stride - pad;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int hi = hi0 + di;
    if (hi < 0 || hi >= H) continue;
    const T* row = x + ((int64_t)n * H + hi) * W * C;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int wi = wi0 + dj;
      if (wi < 0 || wi >= W) continue;
      acc = __fadd_rn(acc, __fmul_rn(to_f32(row[(int64_t)wi * C + c]), w9[(di * 3 + dj) * C + c]));
    }
  }
  return acc;
}

// B4: one thread per (wo, c) element of one output row; the grid's x
// dimension tiles the row, and the ragged last tile is masked below.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                  const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
                  int Ho, int Wo, int stride, int pad, int relu) {
  const int n = blockIdx.z;
  const int ho = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)Wo * C) return;  // ragged edge of the last W tile
  const int wo = (int)(idx / C);
  const int c = (int)(idx % C);
  float v = dw3x3_at(x, w9, n, ho, wo, c, H, W, C, stride, pad);
  if (bias != nullptr) v = __fadd_rn(v, bias[c]);
  if (relu) v = fmaxf(v, 0.f);
  out[((int64_t)n * Ho + ho) * Wo * C + idx] = from_f32<T>(v);
}

// B3: one block per (image, output row, tile of kDsTileW output columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ds_conv3x3_pw_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                     const float* __restrict__ b_dw, const float* __restrict__ w_pw,
                     const float* __restrict__ b_pw, T* __restrict__ out, int H, int W, int C,
                     int Cout, int Ho, int Wo, int stride, int pad) {
  extern __shared__ float smem[];
  float* mid = smem;                   // [kDsTileW][C]: the dw activation tile
  float* wpw = smem + kDsTileW * C;    // [C][Cout]: pw weights
  const int n = blockIdx.z;
  const int ho = blockIdx.y;
  const int wo0 = blockIdx.x * kDsTileW;
  const int tw = min(kDsTileW, Wo - wo0);  // ragged last tile: every loop below stops at tw

  for (int i = threadIdx.x; i < C * Cout; i += kThreads) wpw[i] = w_pw[i];
  for (int i = threadIdx.x; i < tw * C; i += kThreads) {
    const int wl = i / C;
    const int c = i % C;
    const float v = __fadd_rn(dw3x3_at(x, w9, n, ho, wo0 + wl, c, H, W, C, stride, pad), b_dw[c]);
    mid[i] = round_to<T>(fmaxf(v, 0.f));
  }
  __syncthreads();

  T* orow = out + (((int64_t)n * Ho + ho) * Wo + wo0) * Cout;
  for (int i = threadIdx.x; i < tw * Cout; i += kThreads) {
    const int wl = i / Cout;
    const int o = i % Cout;
    const float* m = mid + wl * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, __fmul_rn(m[c], wpw[c * Cout + o]));
    acc = __fadd_rn(acc, b_pw[o]);
    orow[i] = from_f32<T>(fmaxf(acc, 0.f));
  }
}

template <typename T>
int launch_ds(const void* x, const void* w9, const void* b_dw, const void* w_pw, const void* b_pw,
              void* out, int n, int h, int w, int c, int cout, int ho, int wo, int stride, int pad,
              cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)kDsTileW * c + (size_t)c * cout);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ds_conv3x3_pw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((wo + kDsTileW - 1) / kDsTileW, ho, n);
  ds_conv3x3_pw_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w9), static_cast<const float*>(b_dw),
      static_cast<const float*>(w_pw), static_cast<const float*>(b_pw), static_cast<T*>(out), h,
      w, c, cout, ho, wo, stride, pad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* w9, const void* bias, void* out, int n, int h, int w,
              int c, int ho, int wo, int stride, int pad, int relu, cudaStream_t s) {
  const dim3 grid((unsigned)(((int64_t)wo * c + kThreads - 1) / kThreads), ho, n);
  dw_conv3x3_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w9), static_cast<const float*>(bias),
      static_cast<T*>(out), h, w, c, ho, wo, stride, pad, relu);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (n, h, w, c); w9 (9, c) f32; bias (c) f32 or null; out (n, ho, wo, c).
extern "C" int fastscnn_dw_conv3x3(int dtype, const void* x, const void* w9, const void* bias,
                                   void* out, int n, int h, int w, int c, int ho, int wo,
                                   int stride, int pad, int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_dw<__nv_bfloat16>(x, w9, bias, out, n, h, w, c, ho, wo, stride, pad, relu, s);
  if (dtype == kF32) return launch_dw<float>(x, w9, bias, out, n, h, w, c, ho, wo, stride, pad, relu, s);
  return (int)cudaErrorInvalidValue;
}

// x (n, h, w, c); w9 (9, c), b_dw (c), w_pw (c, cout), b_pw (cout) all f32;
// out (n, ho, wo, cout).
extern "C" int fastscnn_ds_conv3x3_pw(int dtype, const void* x, const void* w9, const void* b_dw,
                                      const void* w_pw, const void* b_pw, void* out, int n, int h,
                                      int w, int c, int cout, int ho, int wo, int stride, int pad,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_ds<__nv_bfloat16>(x, w9, b_dw, w_pw, b_pw, out, n, h, w, c, cout, ho, wo,
                                    stride, pad, s);
  if (dtype == kF32)
    return launch_ds<float>(x, w9, b_dw, w_pw, b_pw, out, n, h, w, c, cout, ho, wo, stride, pad, s);
  return (int)cudaErrorInvalidValue;
}
