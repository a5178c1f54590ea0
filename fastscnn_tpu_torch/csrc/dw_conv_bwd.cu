// Backward of the depthwise 3x3 conv (no bias, no ReLU) of the LTD stem in
// training, NHWC, bf16 or f32 in and out, f32 accumulation: kernel B6's
// backward half. B6's forward is B4 (dw_conv.cu) with no bias and no ReLU.
//
// B6 dw_conv3x3_vjp replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    dw_conv3x3_pallas_vjp, whose backward (_vjp_bwd) is XLA's transposed
//    conv (ops/conv.py::_conv_dx) for dX and per-tap multiply-reduces
//    (ops/conv.py::_conv_dw_taps) for dW.
//
// What bounds them on an H100: bytes. dX does at most 9 FMAs per input
// element (at most 4 at stride 2), dW 9 per output-gradient element; both
// read one or two activation-sized tensors and write one (dX) or almost
// nothing (dW: 9 x C values), far below the ~295 operations per byte
// where compute would bind.
//
// dX: one thread per (w, c) element of one input row, the grid's x
// dimension tiling the row (as B4 tiles an output row). The thread
// gathers the taps whose output positions read (h, w): for tap (di, dj)
// that is ho = (h + pad - di) / stride when the division is exact and ho
// lies in [0, Ho), and the same for wo. No zero-dilated copy of g is
// made, and odd sizes (383 -> 192 at stride 2) need nothing special: an
// input column that no output reads (the last of an even padded width)
// gets no tap and writes 0.
//
// dW: the sum over (n, ho, wo) of x-window * g for each (tap, c) spans
// the whole tensor, so it takes two passes and no atomics (the result is
// the same from run to run). Pass 1: each block takes a run of
// consecutive (n, ho) output rows; thread (lane, c) walks the columns
// wo = lane, lane + L, ... keeping the 9 tap sums of channel c in
// registers, the block folds its L lanes in lane order in shared memory
// and writes 9 x C partials to a scratch tensor laid out (9 * C, blocks).
// Pass 2: one block per (tap, c) sums its row of partials (contiguous) in
// a fixed tree order and casts to w's dtype.
//
// Arithmetic: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction). dX adds its taps in (di, dj)
// row-major order into 0.f, exactly what the plain version in
// ops/cuda/dw_conv.py does, so the two agree bit for bit. dW sums in
// another order than the plain version's tensor reductions: they agree to
// f32 reassociation.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_conv3x3_dx_kernel(const T* __restrict__ g, const float* __restrict__ w9, T* __restrict__ dx,
                     int H, int W, int C, int Ho, int Wo, int stride, int pad) {
  const int n = blockIdx.z;
  const int h = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)W * C) return;  // ragged edge of the last W tile
  const int w = (int)(idx / C);
  const int c = (int)(idx % C);
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int hh = h + pad - di;
    if (hh < 0 || hh % stride != 0) continue;
    const int ho = hh / stride;
    if (ho >= Ho) continue;
    const T* grow = g + ((int64_t)n * Ho + ho) * Wo * C;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int ww = w + pad - dj;
      if (ww < 0 || ww % stride != 0) continue;
      const int wo = ww / stride;
      if (wo >= Wo) continue;
      acc = __fadd_rn(acc, __fmul_rn(to_f32(grow[(int64_t)wo * C + c]), w9[(di * 3 + dj) * C + c]));
    }
  }
  dx[((int64_t)n * H + h) * W * C + idx] = from_f32<T>(acc);
}

// Pass 1 of dW. Block b covers output rows [b * rows, min((b + 1) * rows,
// N * Ho)) of the flattened (n, ho) index; blockDim.x == C * lanes.
template <typename T>
__global__ void __launch_bounds__(1024)
dw_conv3x3_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ partial, int N, int H, int W, int C, int Ho,
                             int Wo, int stride, int pad, int rows, int lanes) {
  extern __shared__ float red[];  // [9][lanes][C]
  const int c = threadIdx.x % C;
  const int lane = threadIdx.x / C;
  const int row0 = blockIdx.x * rows;
  const int row1 = min(row0 + rows, N * Ho);
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;
  for (int r = row0; r < row1; ++r) {
    const int n = r / Ho;
    const int ho = r % Ho;
    const T* grow = g + (int64_t)r * Wo * C;
    const int hi0 = ho * stride - pad;
    for (int wo = lane; wo < Wo; wo += lanes) {
      const float gv = to_f32(grow[(int64_t)wo * C + c]);
      const int wi0 = wo * stride - pad;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int hi = hi0 + di;
        if (hi < 0 || hi >= H) continue;
        const T* xrow = x + ((int64_t)n * H + hi) * W * C;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int wi = wi0 + dj;
          if (wi < 0 || wi >= W) continue;
          acc[di * 3 + dj] =
              __fadd_rn(acc[di * 3 + dj], __fmul_rn(to_f32(xrow[(int64_t)wi * C + c]), gv));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) red[(k * lanes + lane) * C + c] = acc[k];
  __syncthreads();
  // fold the lanes in lane order: thread (lane, c) finishes taps
  // k = lane, lane + lanes, ... of channel c
  for (int k = lane; k < 9; k += lanes) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, red[(k * lanes + l) * C + c]);
    partial[(int64_t)(k * C + c) * gridDim.x + blockIdx.x] = s;
  }
}

// Pass 2 of dW: block (k * C + c) sums partial[k * C + c, 0 .. nblocks).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
dw_conv3x3_dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int nblocks) {
  __shared__ float s[kReduceThreads];
  const float* row = partial + (int64_t)blockIdx.x * nblocks;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += kReduceThreads) acc = __fadd_rn(acc, row[i]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) dw[blockIdx.x] = from_f32<T>(s[0]);
}

template <typename T>
int launch_dx(const void* g, const void* w9, void* dx, int n, int h, int w, int c, int ho, int wo,
              int stride, int pad, cudaStream_t s) {
  const dim3 grid((unsigned)(((int64_t)w * c + kThreads - 1) / kThreads), h, n);
  dw_conv3x3_dx_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(w9), static_cast<T*>(dx), h, w, c, ho,
      wo, stride, pad);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_dw(const void* x, const void* g, void* partial, void* dw, int n, int h, int w, int c,
              int ho, int wo, int stride, int pad, int rows, int nblocks, int lanes,
              cudaStream_t s) {
  const size_t smem = sizeof(float) * 9 * (size_t)lanes * c;
  dw_conv3x3_dw_partial_kernel<Tin><<<nblocks, c * lanes, smem, s>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(g), static_cast<float*>(partial), n, h,
      w, c, ho, wo, stride, pad, rows, lanes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_conv3x3_dw_reduce_kernel<Tout><<<9 * c, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<Tout*>(dw), nblocks);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// g (n, ho, wo, c); w9 (9, c) f32; dx (n, h, w, c) in g's dtype.
extern "C" int fastscnn_dw_conv3x3_dx(int dtype, const void* g, const void* w9, void* dx, int n,
                                      int h, int w, int c, int ho, int wo, int stride, int pad,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_dx<__nv_bfloat16>(g, w9, dx, n, h, w, c, ho, wo, stride, pad, s);
  if (dtype == kF32) return launch_dx<float>(g, w9, dx, n, h, w, c, ho, wo, stride, pad, s);
  return (int)cudaErrorInvalidValue;
}

// x (n, h, w, c) and g (n, ho, wo, c) in dtype; partial (9 * c, nblocks)
// f32 scratch; dw (9, c) in out_dtype. Block b of pass 1 covers `rows`
// flattened (n, ho) rows with c * lanes threads.
extern "C" int fastscnn_dw_conv3x3_dw(int dtype, int out_dtype, const void* x, const void* g,
                                      void* partial, void* dw, int n, int h, int w, int c, int ho,
                                      int wo, int stride, int pad, int rows, int nblocks,
                                      int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FASTSCNN_DW(TIN, TOUT)                                                                \
  return launch_dw<TIN, TOUT>(x, g, partial, dw, n, h, w, c, ho, wo, stride, pad, rows, nblocks, \
                              lanes, s)
  if (dtype == kBF16 && out_dtype == kBF16) FASTSCNN_DW(__nv_bfloat16, __nv_bfloat16);
  if (dtype == kBF16 && out_dtype == kF32) FASTSCNN_DW(__nv_bfloat16, float);
  if (dtype == kF32 && out_dtype == kF32) FASTSCNN_DW(float, float);
  if (dtype == kF32 && out_dtype == kBF16) FASTSCNN_DW(float, __nv_bfloat16);
#undef FASTSCNN_DW
  return (int)cudaErrorInvalidValue;
}
