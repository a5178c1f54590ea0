// Multi-row fused depthwise-separable conv (DSConv) for the LTD stem of the
// BN-folded serving graph, NHWC, bf16 or f32 in and out, f32 accumulation.
//
// B5 ds_conv3x3_pw_multirow replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    ds_conv3x3_pw_pallas_multirow:  relu(pw1x1(round(relu(dw3x3(x) + b_dw))) + b_pw)
//
// It is B3's function (csrc/dw_conv.cu). What bounds it on an H100: bytes.
// The dw taps are 9 FMAs and the 1x1 C (32 or 48) MACs per output, far
// below the ~295 operations per byte where compute would bind. B3 reads
// each output row's three input rows on its own, so at stride 2 every
// other input row is read twice (1.5x the input). B5 gives a block
// `rows` output rows of one tile of kTileW output columns and stages the
// (rows - 1) * stride + 3 input rows of that tile, (kTileW - 1) * stride + 3
// columns wide, in shared memory once: about (2 * rows + 1) / (2 * rows)
// of the input at stride 2 (1.06x for rows = 8), plus 3 / 32 of a column
// halo. At rows = 8 and bf16 the LTD's two sites stage 35.9 KB (C = 32) and
// 53.9 KB (C = 48) of input, so two or three blocks fit on an SM.
//
// The TPU kernel's constraints are not carried over: its 128-lane DMA
// slices and its `ho % rows_per_step` fallback to the single-row kernel
// were Mosaic's. Here every shape runs in this kernel; a ragged last row
// block and a ragged last column tile are masked. The pad-1 border and the
// image edges are zeros written into the staged tile.
//
// Phases of a block: (1) stage the pw weights and the input tile;
// (2) the dw activation of every output pixel of the block into shared
// memory, rounded to the compute dtype (the unfused bf16 graph hands a
// bf16 tensor from the dw conv to the pw conv); (3) the 1x1, each thread
// one output channel of kPix pixels, so a weight read from shared memory
// serves kPix MACs.
//
// Arithmetic order, identical to B3 and to the plain PyTorch version
// ds_conv3x3_pw_reference: taps (di, dj) in row-major order (a padding tap
// adds 0 * w, which leaves the sum's value unchanged), + bias, each
// operation rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction);
// the pw dot runs c = 0..C-1 the same way. So kernel, B3 and the plain
// version agree bit for bit.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 16;  // output columns per block
constexpr int kPix = 4;     // pw outputs (pixels) per thread and output channel

// Shared-memory layout of one block: pw weights [C][Cout] f32, dw
// activations [rows * kTileW][C + 1] f32 (the +1 staggers banks between the
// pixels a warp reads), input tile [rows_in][cols_in][C] T. The wrapper
// (ops/cuda/dw_conv.py::_mr_smem_bytes) computes the same size.
__host__ __device__ inline size_t mr_smem_floats(int rows, int c, int cout) {
  return (size_t)c * cout + (size_t)rows * kTileW * (c + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ds_conv3x3_pw_mr_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                        const float* __restrict__ b_dw, const float* __restrict__ w_pw,
                        const float* __restrict__ b_pw, T* __restrict__ out, int H, int W, int C,
                        int Cout, int Ho, int Wo, int stride, int pad, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int rows_in = (rows - 1) * stride + 3;
  const int cols_in = (kTileW - 1) * stride + 3;
  const int cp = C + 1;
  float* wpw = smem;                        // [C][Cout]
  float* mid = smem + C * Cout;             // [rows * kTileW][C + 1]
  T* xs = reinterpret_cast<T*>(smem + mr_smem_floats(rows, C, Cout));  // [rows_in][cols_in][C]

  const int n = blockIdx.z;
  const int ho0 = blockIdx.y * rows;
  const int wo0 = blockIdx.x * kTileW;
  const int tr = min(rows, Ho - ho0);    // ragged last row block
  const int tw = min(kTileW, Wo - wo0);  // ragged last column tile
  const int hi0 = ho0 * stride - pad;
  const int wi0 = wo0 * stride - pad;

  // (1) stage. A staged row is one contiguous run of cols_in * C elements
  // of an NHWC input row; elements left or right of the image are zeros.
  for (int i = threadIdx.x; i < C * Cout; i += kThreads) wpw[i] = w_pw[i];
  const int row_elems = cols_in * C;
  const int lo = max(0, -wi0) * C;                  // first in-image element
  const int hi_end = min(cols_in, W - wi0) * C;     // one past the last
  const T zero = from_f32<T>(0.f);
  for (int r = 0; r < rows_in; ++r) {
    const int hi = hi0 + r;
    T* dst = xs + r * row_elems;
    if (hi < 0 || hi >= H) {
      for (int e = threadIdx.x; e < row_elems; e += kThreads) dst[e] = zero;
      continue;
    }
    const int64_t src = (((int64_t)n * H + hi) * W + wi0) * C;  // element (hi, wi0, 0)
    for (int e = threadIdx.x; e < row_elems; e += kThreads)
      dst[e] = (e >= lo && e < hi_end) ? x[src + e] : zero;
  }
  __syncthreads();

  // (2) dw 3x3 + bias + ReLU, rounded to T, for the tr x tw pixels.
  const int tile_elems = kTileW * C;
  for (int i = threadIdx.x; i < tr * tile_elems; i += kThreads) {
    const int rl = i / tile_elems;
    const int rem = i - rl * tile_elems;
    const int wl = rem / C;
    const int c = rem - wl * C;
    if (wl >= tw) continue;  // past the image's right edge: never read below
    const T* base = xs + ((rl * stride) * cols_in + wl * stride) * C + c;
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc = __fadd_rn(acc, __fmul_rn(to_f32(base[(di * cols_in + dj) * C]),
                                       w9[(di * 3 + dj) * C + c]));
    }
    acc = __fadd_rn(acc, b_dw[c]);
    mid[(rl * kTileW + wl) * cp + c] = round_to<T>(fmaxf(acc, 0.f));
  }
  __syncthreads();

  // (3) 1x1 + bias + ReLU. Pixel p of the block is (p / tw, p % tw);
  // consecutive threads take consecutive output channels, so the stores of
  // one pixel coalesce.
  const int npix = tr * tw;
  const int groups = (npix + kPix - 1) / kPix;
  for (int i = threadIdx.x; i < groups * Cout; i += kThreads) {
    const int g = i / Cout;
    const int o = i - g * Cout;
    const float* m[kPix];
    float acc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = min(g * kPix + j, npix - 1);  // a ragged group recomputes the last pixel
      const int rl = p / tw;
      m[j] = mid + (rl * kTileW + (p - rl * tw)) * cp;
      acc[j] = 0.f;
    }
    for (int c = 0; c < C; ++c) {
      const float wv = wpw[c * Cout + o];
#pragma unroll
      for (int j = 0; j < kPix; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(m[j][c], wv));
    }
    const float bo = b_pw[o];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = g * kPix + j;
      if (p >= npix) break;
      const int rl = p / tw;
      const int wl = p - rl * tw;
      out[(((int64_t)n * Ho + ho0 + rl) * Wo + wo0 + wl) * Cout + o] =
          from_f32<T>(fmaxf(__fadd_rn(acc[j], bo), 0.f));
    }
  }
}

template <typename T>
int launch_mr(const void* x, const void* w9, const void* b_dw, const void* w_pw, const void* b_pw,
              void* out, int n, int h, int w, int c, int cout, int ho, int wo, int stride, int pad,
              int rows, cudaStream_t s) {
  const int rows_in = (rows - 1) * stride + 3;
  const int cols_in = (kTileW - 1) * stride + 3;
  const size_t smem = sizeof(float) * mr_smem_floats(rows, c, cout) +
                      sizeof(T) * (size_t)rows_in * cols_in * c;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ds_conv3x3_pw_mr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((wo + kTileW - 1) / kTileW, (ho + rows - 1) / rows, n);
  ds_conv3x3_pw_mr_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w9), static_cast<const float*>(b_dw),
      static_cast<const float*>(w_pw), static_cast<const float*>(b_pw), static_cast<T*>(out), h,
      w, c, cout, ho, wo, stride, pad, rows);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (n, h, w, c); w9 (9, c), b_dw (c), w_pw (c, cout), b_pw (cout) all f32;
// out (n, ho, wo, cout); rows output rows per block.
extern "C" int fastscnn_ds_conv3x3_pw_mr(int dtype, const void* x, const void* w9,
                                         const void* b_dw, const void* w_pw, const void* b_pw,
                                         void* out, int n, int h, int w, int c, int cout, int ho,
                                         int wo, int stride, int pad, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return launch_mr<__nv_bfloat16>(x, w9, b_dw, w_pw, b_pw, out, n, h, w, c, cout, ho, wo,
                                    stride, pad, rows, s);
  if (dtype == kF32)
    return launch_mr<float>(x, w9, b_dw, w_pw, b_pw, out, n, h, w, c, cout, ho, wo, stride, pad,
                            rows, s);
  return (int)cudaErrorInvalidValue;
}
