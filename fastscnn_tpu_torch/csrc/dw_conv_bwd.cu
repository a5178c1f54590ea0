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
// the same from run to run). The first design gave thread (lane, c) the
// columns wo = lane, lane + L, ... of one channel: per output pixel one
// 2-byte g and nine 2-byte x loads for 18 flops, no reuse of the x column
// that wo and wo + 1 share, and at C = 48 blocks of 5 lanes (7.5 warps,
// warps straddling pixels). This one:
// - Pass 1. A thread owns VEC channels, 16 bytes (as the forward: the
//   wrapper picks VEC from C and the pointers' alignment), and keeps
//   9 x VEC f32 tap sums. A "slot" is the C / VEC threads of one pixel
//   (at most 32: wider C takes several channel groups, grid.y); a warp
//   holds 32 / slot-width whole slots and leaves the remaining lanes idle.
//   Block b (kDwThreads threads) takes a run of `rows` consecutive (n, ho)
//   output rows; its slots split the run's pixels, in order, into equal
//   contiguous pieces. A slot walks its piece column by column and keeps
//   the x columns the next pixel shares: at stride 2 x column 2wo + 1 is
//   tap dj = 2 of wo and dj = 0 of wo + 1, so each pixel loads one g
//   vector and 2 x 3 new x vectors (7 loads for 9 x VEC FMAs). Taps
//   outside the input load zeros.
// - Fold, in a fixed order: the slots of a warp by shuffles in a fixed
//   tree, the warps in shared memory in warp order; the block writes its
//   9 x C sums as column b of a (9 * C, blocks) f32 scratch tensor.
// - Pass 2: one warp per (tap, c) sums its row of partials (contiguous),
//   each lane a fixed stride of it, then a fixed shuffle tree; the result
//   is cast to w's dtype.
// The plan (blocks, rows, channel groups) is a function of the shape
// alone (ops/cuda/dw_conv.py::dw_plan), so a shape always sums in the
// same order. Sums use FMA: dW is held to a tolerance, not to bits, since
// the plain version's tensor reductions sum in yet another order.
//
// Arithmetic of dX: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction), taps in (di, dj) row-major
// order into 0.f, exactly what the plain version in ops/cuda/dw_conv.py
// does, so the two agree bit for bit.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;
constexpr int kDwThreads = 128;  // pass-1 block
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kReduceWarps = 8;  // pass 2: one warp per (tap, c)

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

// Pass 1 of dW. Block (b, group) covers output rows [b * rows, min((b + 1)
// * rows, N * Ho)) of the flattened (n, ho) index and channel vectors
// [group * 32, group * 32 + 32) (all of them when C / VEC <= 32).
template <typename T, int VEC, int S>
__global__ void __launch_bounds__(kDwThreads)
dw_conv3x3_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ partial, int N, int H, int W, int C, int Ho,
                             int Wo, int pad, int rows) {
  __shared__ float red[kDwWarps][9][32 * VEC];
  constexpr int kKeep = 3 - S;  // x columns a pixel hands to the next
  const int width = min(C / VEC, 32);  // threads of a slot (one pixel)
  const int per_warp = 32 / width;     // whole slots in a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sw = lane / width;  // slot within the warp
  const int cv = lane - sw * width;
  const int c0 = (blockIdx.y * width + cv) * VEC;
  const bool active = sw < per_warp && c0 < C;
  const int slots = kDwWarps * per_warp;
  const int slot = warp * per_warp + sw;

  float acc[9][VEC];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;

  // this slot's piece [p, pend) of the block's pixels, in (row, column) order
  const int r0 = blockIdx.x * rows;
  const int64_t npix = (int64_t)(min(r0 + rows, N * Ho) - r0) * Wo;
  int64_t p = active ? npix * slot / slots : 0;
  const int64_t pend = active ? npix * (slot + 1) / slots : 0;
  if (p < pend) {
    int r = r0 + (int)(p / Wo);
    int wo = (int)(p % Wo);
    const T* xrow[3];
    bool row_ok[3];
    const T* grow = nullptr;
    auto start_row = [&](int rr) {
      const int n = rr / Ho, ho = rr - n * Ho;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int hi = ho * S - pad + di;
        row_ok[di] = (unsigned)hi < (unsigned)H;
        xrow[di] = x + ((int64_t)n * H + (row_ok[di] ? hi : 0)) * W * C + c0;
      }
      grow = g + (int64_t)rr * Wo * C + c0;
    };
    start_row(r);
    Pack<T, VEC> xc[3][3];
    bool fresh = true;  // first pixel of a row piece: load all three columns
    for (; p < pend; ++p) {
      if (!fresh) {
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int j = 0; j < kKeep; ++j) xc[di][j] = xc[di][j + S];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (!fresh && j < kKeep) continue;
        const int wi = wo * S - pad + j;
        const bool col_ok = (unsigned)wi < (unsigned)W;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          if (row_ok[di] && col_ok) xc[di][j].load(xrow[di] + (int64_t)wi * C);
          else xc[di][j].zero();
        }
      }
      Pack<T, VEC> gv;
      gv.load(grow + (int64_t)wo * C);
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[di * 3 + dj][v] = fmaf(xc[di][dj].get(v), gv.get(v), acc[di * 3 + dj][v]);
      fresh = false;
      if (++wo == Wo) {
        wo = 0;
        fresh = true;
        if (p + 1 < pend) start_row(++r);
      }
    }
  }

  // fold the slots of each warp: slot s takes s + d for d = 1, 2, 4, ...
  for (int d = 1; d < per_warp; d *= 2) {
    const bool take = sw % (2 * d) == 0 && sw + d < per_warp;
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float o = __shfl_down_sync(0xffffffffu, acc[k][v], d * width);
        if (take) acc[k][v] += o;
      }
  }
  if (sw == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][k][cv * VEC + v] = acc[k][v];
  }
  __syncthreads();
  // then the warps, in warp order; column b of the (9 * C, blocks) scratch
  const int cbase = blockIdx.y * width * VEC;
  for (int k = 0; k < 9; ++k)
    for (int j = threadIdx.x; j < width * VEC && cbase + j < C; j += kDwThreads) {
      float s = red[0][k][j];
#pragma unroll
      for (int w = 1; w < kDwWarps; ++w) s += red[w][k][j];
      partial[((int64_t)k * C + cbase + j) * gridDim.x + blockIdx.x] = s;
    }
}

// Pass 2 of dW: warp `col` sums partial[col, 0 .. nblocks), col = k * C + c.
template <typename T>
__global__ void __launch_bounds__(kReduceWarps * 32)
dw_conv3x3_dw_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, int cols,
                            int nblocks) {
  const int col = blockIdx.x * kReduceWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (col >= cols) return;  // whole warps only
  const float* row = partial + (int64_t)col * nblocks;
  float s = 0.f;
  for (int i = lane; i < nblocks; i += 32) s += row[i];
#pragma unroll
  for (int d = 16; d > 0; d /= 2) s += __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) dw[col] = from_f32<T>(s);
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

template <typename Tin, int VEC>
void launch_dw_partial(const void* x, const void* g, void* partial, int n, int h, int w, int c,
                       int ho, int wo, int stride, int pad, int rows, int nblocks, int groups,
                       cudaStream_t s) {
  const dim3 grid(nblocks, groups);
  const Tin* xp = static_cast<const Tin*>(x);
  const Tin* gp = static_cast<const Tin*>(g);
  float* pp = static_cast<float*>(partial);
  if (stride == 2)
    dw_conv3x3_dw_partial_kernel<Tin, VEC, 2><<<grid, kDwThreads, 0, s>>>(xp, gp, pp, n, h, w, c,
                                                                           ho, wo, pad, rows);
  else
    dw_conv3x3_dw_partial_kernel<Tin, VEC, 1><<<grid, kDwThreads, 0, s>>>(xp, gp, pp, n, h, w, c,
                                                                           ho, wo, pad, rows);
}

template <typename Tin, typename Tout>
int launch_dw(const void* x, const void* g, void* partial, void* dw, int n, int h, int w, int c,
              int ho, int wo, int stride, int pad, int vec, int rows, int nblocks, int groups,
              cudaStream_t s) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
#define FASTSCNN_DW_PARTIAL(VEC)                                                         \
  launch_dw_partial<Tin, VEC>(x, g, partial, n, h, w, c, ho, wo, stride, pad, rows, nblocks, \
                              groups, s)
  if (vec == 1) FASTSCNN_DW_PARTIAL(1);
  else if (vec == 2) FASTSCNN_DW_PARTIAL(2);
  else if (vec == 4) FASTSCNN_DW_PARTIAL(4);
  else if constexpr (sizeof(Tin) == 2) {  // 8 bf16 = 16 bytes; f32 stops at 4
    if (vec == 8) FASTSCNN_DW_PARTIAL(8);
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FASTSCNN_DW_PARTIAL
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cols = 9 * c;
  dw_conv3x3_dw_reduce_kernel<Tout><<<(cols + kReduceWarps - 1) / kReduceWarps,
                                      kReduceWarps * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<Tout*>(dw), cols, nblocks);
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

// x (n, h, w, c) and g (n, ho, wo, c) in dtype, aligned to vec elements;
// partial (9 * c, nblocks) f32 scratch; dw (9, c) in out_dtype. The plan
// (ops/cuda/dw_conv.py::dw_plan): block b of pass 1 covers `rows`
// flattened (n, ho) rows, grid.y = groups channel groups of 32 vectors.
extern "C" int fastscnn_dw_conv3x3_dw(int dtype, int out_dtype, const void* x, const void* g,
                                      void* partial, void* dw, int n, int h, int w, int c, int ho,
                                      int wo, int stride, int pad, int vec, int rows, int nblocks,
                                      int groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FASTSCNN_DW(TIN, TOUT)                                                                \
  return launch_dw<TIN, TOUT>(x, g, partial, dw, n, h, w, c, ho, wo, stride, pad, vec, rows, \
                              nblocks, groups, s)
  if (dtype == kBF16 && out_dtype == kBF16) FASTSCNN_DW(__nv_bfloat16, __nv_bfloat16);
  if (dtype == kBF16 && out_dtype == kF32) FASTSCNN_DW(__nv_bfloat16, float);
  if (dtype == kF32 && out_dtype == kF32) FASTSCNN_DW(float, float);
  if (dtype == kF32 && out_dtype == kBF16) FASTSCNN_DW(float, __nv_bfloat16);
#undef FASTSCNN_DW
  return (int)cudaErrorInvalidValue;
}
