// Bilinear-upsample + argmax mask heads: the full-resolution logits are
// never written to device memory.
//
// B1 upsample_argmax replaces fastscnn_tpu/ops/pallas/upsample_argmax.py::
//    upsample_argmax: mask = argmax_C(bilinear(logits NHWC)), int32.
// B2 h_lerp_argmax replaces the Pallas H-lerp/argmax kernel inside
//    fastscnn_tpu/ops/pallas/upsample_argmax.py::w_matmul_h_lerp_argmax:
//    the H pass of the W-upsampled (N, h, C, W) tensor, then argmax_C.
//
// What bounds them on an H100: bytes. Per output pixel each does ~3*C
// flops of lerp and C compares against 4 bytes of int32 mask written
// (B1 reads only 1.25 MB of logits per 1024x2048 frame, B2 10 MB), so
// the mask write and, for B2, the input read set the byte floor. But B2
// issues at least 5 instructions a pixel and class (the lerp's multiply
// and add, each rounded on its own, and the argmax's compare and two
// selects: 200 M at 19 classes a 1024x2048 frame), which take longer at
// the CUDA cores' issue rate than its bytes take at the memory's rate:
// its design keeps every other instruction out of the class loop
// (PERF.md, section 6).
//
// Both drop the TPU's interpolation matrices (the dense matmuls were for
// the MXU) and interpolate two taps per axis from the same lerp tables as
// ops/resize.py::_axis_lerp_coeffs, built by the wrapper and passed in as
// (lo int64, hi int64, w f32) arrays.
//   B1: one block per (image, output row). The block first H-lerps its
//       two source rows into one (w, C) f32 row in shared memory, then
//       each thread W-lerps and argmaxes output pixels of the row. The
//       kernel reads the (N, h, w, C) NHWC logits directly.
//   B2: staged strips. A block owns a column tile (128 or 256 columns)
//       and a strip of consecutive output rows (ops/cuda/upsample_argmax.py
//       ::h_lerp_plan). It copies the source rows its strip needs,
//       hlo[first row] .. hhi[last row], all C planes of the tile, into
//       shared memory once, in the stored dtype, by 16-byte cp.async
//       (element by element where W or the pointer forbids 16), then walks
//       the strip's rows from there. At a x8 upsample and 32 rows a strip
//       (at most 6 source rows staged for about 4 new ones) each input
//       element is read about 1.5 times instead of 16 (one thread a pixel
//       read its two source rows from L2 for every output row: ~159 MB a
//       1024x2048 frame). A warp spans 128 columns, 4 a thread, and a
//       thread takes 4 consecutive output rows at once: for each class it
//       loads each distinct (lo, hi) pair of its rows once (8 bytes, 4
//       columns) and forms hi - lo once (the same value for every row of
//       the pair), so an output pixel costs the multiply, the add and the
//       argmax. The mask leaves as one 16-byte int4 store of 4 columns a
//       thread, coalesced along the row, where W % 4 == 0.
// Both lerp as lo + (hi - lo) * w with each operation rounded on its own
// (no FMA contraction), H then W, all in f32 from bf16 or f32 inputs,
// and argmax with a strict '>' scan so ties go to the lowest class —
// exactly the plain PyTorch versions in ops/cuda/upsample_argmax.py.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ x, const int64_t* __restrict__ hlo,
                       const int64_t* __restrict__ hhi, const float* __restrict__ hw,
                       const int64_t* __restrict__ wlo, const int64_t* __restrict__ whi,
                       const float* __restrict__ ww, int* __restrict__ out, int h, int w, int C,
                       int H, int W) {
  extern __shared__ float hrow[];  // [w][C]: the H-lerped source row of output row y
  const int y = blockIdx.x;
  const int n = blockIdx.y;
  const int64_t rowlen = (int64_t)w * C;
  const T* r0 = x + ((int64_t)n * h + hlo[y]) * rowlen;
  const T* r1 = x + ((int64_t)n * h + hhi[y]) * rowlen;
  const float wy = hw[y];
  for (int64_t i = threadIdx.x; i < rowlen; i += kThreads)
    hrow[i] = lerp_rn(to_f32(r0[i]), to_f32(r1[i]), wy);
  __syncthreads();

  int* orow = out + ((int64_t)n * H + y) * W;
  for (int xo = threadIdx.x; xo < W; xo += kThreads) {
    const float* a = hrow + wlo[xo] * C;
    const float* b = hrow + whi[xo] * C;
    const float wx = ww[xo];
    float best = lerp_rn(a[0], b[0], wx);
    int arg = 0;
    for (int c = 1; c < C; ++c) {
      const float v = lerp_rn(a[c], b[c], wx);
      if (v > best) {
        best = v;
        arg = c;
      }
    }
    orow[xo] = arg;
  }
}

// B2: grid (column tiles, strips, N), 256 threads: WC warps across the
// TW = 128 * WC columns of the tile, 8 / WC stacked along the rows.
// VCOPY: the staging by 16-byte cp.async (W * sizeof(T) % 16 == 0, xw
// aligned), else element by element. vec_out: the mask by int4 stores.
constexpr int kHRows = 4;  // output rows a thread takes at once

// 4 consecutive staged values as f32 (a bf16 is the top half of its f32)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}

template <typename T, int WC, bool VCOPY>
__global__ void __launch_bounds__(kThreads)
h_lerp_argmax_kernel(const T* __restrict__ xw, const int64_t* __restrict__ hlo,
                     const int64_t* __restrict__ hhi, const float* __restrict__ hw,
                     int* __restrict__ out, int h, int C, int H, int W, int rows, int vec_out) {
  constexpr int TW = 128 * WC;
  constexpr int kPassRows = (kThreads / 32 / WC) * kHRows;  // rows the block takes a pass
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem);  // [staged rows][C][TW]
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * rows, y1 = min(y0 + rows, H);
  const int n = blockIdx.z;
  const int s0 = (int)hlo[y0];
  const int planes = ((int)hhi[y1 - 1] - s0 + 1) * C;  // staged (source row, class) planes
  const T* src = xw + ((int64_t)n * h + s0) * C * W + x0;
  if constexpr (VCOPY) {
    constexpr int kPer = 16 / (int)sizeof(T), kSegs = TW / kPer;
    for (int i = threadIdx.x; i < planes * kSegs; i += kThreads) {
      const int p = i / kSegs, col = (i % kSegs) * kPer;
      const bool ok = x0 + col < W;  // W % kPer == 0: a segment is all in or all out
      cp_async<16>(smem_addr(st + p * TW + col), ok ? src + (int64_t)p * W + col : xw,
                   ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < planes * TW; i += kThreads) {
      const int p = i / TW, col = i % TW;
      st[i] = x0 + col < W ? src[(int64_t)p * W + col] : from_f32<T>(0.f);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = (warp % WC) * 128 + 4 * lane;  // the thread's 4 columns in the tile
  const int x = x0 + col;
  for (int yb = y0 + (warp / WC) * kHRows; yb < y1; yb += kPassRows) {
    // each row's two staged rows, as element offsets at class 0 and the
    // thread's first column; rows past the strip repeat its last (not stored)
    int lo[kHRows], hi[kHRows];
    float wy[kHRows];
#pragma unroll
    for (int q = 0; q < kHRows; ++q) {
      const int y = min(yb + q, y1 - 1);
      lo[q] = ((int)hlo[y] - s0) * C * TW + col;
      hi[q] = ((int)hhi[y] - s0) * C * TW + col;
      wy[q] = hw[y];
    }
    float best[kHRows][4];
    int arg[kHRows][4];
    // class c of the kHRows x 4 pixels: the staged values of each distinct
    // (lo, hi) pair and their difference once (hi - lo is the same for
    // every row of the pair), then each row's lerp and the strict '>'
    // argmax step (class 0 only sets best)
    auto step = [&](int c, bool first) {
      float lo4[4], d4[4];
#pragma unroll
      for (int q = 0; q < kHRows; ++q) {
        if (q == 0 || lo[q] != lo[q - 1] || hi[q] != hi[q - 1]) {  // uniform across the warp
          float hi4[4];
          load4(st + lo[q] + c * TW, lo4);
          load4(st + hi[q] + c * TW, hi4);
#pragma unroll
          for (int j = 0; j < 4; ++j) d4[j] = __fsub_rn(hi4[j], lo4[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = __fadd_rn(lo4[j], __fmul_rn(d4[j], wy[q]));
          if (first || v > best[q][j]) {
            best[q][j] = v;
            arg[q][j] = c;
          }
        }
      }
    };
    step(0, true);
    for (int c = 1; c < C; ++c) step(c, false);
#pragma unroll
    for (int q = 0; q < kHRows; ++q) {
      if (yb + q >= y1) break;
      int* orow = out + ((int64_t)n * H + yb + q) * W;
      if (vec_out) {
        if (x < W)
          *reinterpret_cast<int4*>(orow + x) =
              make_int4(arg[q][0], arg[q][1], arg[q][2], arg[q][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j < W) orow[x + j] = arg[q][j];
      }
    }
  }
}

template <typename T>
int launch_up(const void* x, const void* hlo, const void* hhi, const void* hw, const void* wlo,
              const void* whi, const void* ww, void* out, int n, int h, int w, int c, int H,
              int W, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)w * c;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        upsample_argmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(H, n);
  upsample_argmax_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(hlo),
      static_cast<const int64_t*>(hhi), static_cast<const float*>(hw),
      static_cast<const int64_t*>(wlo), static_cast<const int64_t*>(whi),
      static_cast<const float*>(ww), static_cast<int*>(out), h, w, c, H, W);
  return (int)cudaGetLastError();
}

template <typename T, int WC, bool VCOPY>
int launch_h_kernel(dim3 grid, const void* xw, const void* hlo, const void* hhi, const void* hw,
                    void* out, int h, int c, int H, int W, int rows, int smem, int vec_out,
                    cudaStream_t s) {
  auto* kernel = h_lerp_argmax_kernel<T, WC, VCOPY>;
  static int attribute_bytes = 48 * 1024;  // the largest size allowed so far, per instantiation
  if (smem > attribute_bytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attribute_bytes = smem;
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(xw), static_cast<const int64_t*>(hlo),
      static_cast<const int64_t*>(hhi), static_cast<const float*>(hw), static_cast<int*>(out), h,
      c, H, W, rows, vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_h(const void* xw, const void* hlo, const void* hhi, const void* hw, void* out, int n,
             int h, int c, int H, int W, int tile, int rows, int smem, int vcopy, int vec_out,
             cudaStream_t s) {
  if (rows < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const int strips = (H + rows - 1) / rows;
  if (strips > 65535) return (int)cudaErrorInvalidValue;
#define FASTSCNN_H(WC, VC)                                                                   \
  return launch_h_kernel<T, WC, VC>(dim3((W + 128 * WC - 1) / (128 * WC), strips, n), xw, hlo, \
                                    hhi, hw, out, h, c, H, W, rows, smem, vec_out, s)
  if (tile == 128 && vcopy) FASTSCNN_H(1, true);
  if (tile == 128) FASTSCNN_H(1, false);
  if (tile == 256 && vcopy) FASTSCNN_H(2, true);
  if (tile == 256) FASTSCNN_H(2, false);
#undef FASTSCNN_H
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (n, h, w, c) logits; H tables (H), W tables (W); out (n, H, W) int32.
extern "C" int fastscnn_upsample_argmax(int dtype, const void* x, const void* hlo, const void* hhi,
                                        const void* hw, const void* wlo, const void* whi,
                                        const void* ww, void* out, int n, int h, int w, int c,
                                        int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_up<__nv_bfloat16>(x, hlo, hhi, hw, wlo, whi, ww, out, n, h, w, c, H, W, s);
  if (dtype == kF32) return launch_up<float>(x, hlo, hhi, hw, wlo, whi, ww, out, n, h, w, c, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// xw (n, h, c, W) W-upsampled logits; H tables (H); out (n, H, W) int32.
// tile (128 or 256 columns), rows (output rows a strip) and smem (bytes of
// the most source rows a strip stages) from ops/cuda/upsample_argmax.py::
// h_lerp_plan; vcopy: W * itemsize % 16 == 0 and xw 16-byte aligned;
// vec_out: W % 4 == 0 and out 16-byte aligned.
extern "C" int fastscnn_h_lerp_argmax(int dtype, const void* xw, const void* hlo, const void* hhi,
                                      const void* hw, void* out, int n, int h, int c, int H,
                                      int W, int tile, int rows, int smem, int vcopy,
                                      int vec_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_h<__nv_bfloat16>(xw, hlo, hhi, hw, out, n, h, c, H, W, tile, rows, smem, vcopy,
                                   vec_out, s);
  if (dtype == kF32)
    return launch_h<float>(xw, hlo, hhi, hw, out, n, h, c, H, W, tile, rows, smem, vcopy,
                           vec_out, s);
  return (int)cudaErrorInvalidValue;
}
