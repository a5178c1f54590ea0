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
// B3: one block per (image, output row, W tile). Stride-2 column taps are
// plain strided loads (the TPU kernel's pair-merged lanes existed only
// for Mosaic's unit-stride slices), the pad-1 border is handled by bounds
// checks rather than a padded copy of the input, and odd H/W (511x1023
// after the stem conv's padding=0) need nothing special. B3 computes its
// tile's dw activation row into shared memory, rounds it to the compute
// dtype (as the unfused bf16 graph hands a bf16 tensor from the dw conv to
// the pw conv), then takes the C->Cout dot against the (C, Cout) weights
// staged in shared memory.
//
// B4 (also B6's forward, in training). Its bytes come from L2 as much as
// from device memory (a 383x383x32 bf16 image is 9.4 MB), so what held
// the first design back was the number of memory instructions and the
// work behind each: one thread per output element, 9 two-byte loads each
// behind its own bounds check, coordinates from a 64-bit idx / C and
// idx % C, and every input element shared by neighbouring outputs
// fetched again by each (36 loads for 4 stride-2 outputs). It ran at
// ~0.83 TB/s against cuDNN's ~2.1. This design:
// - A thread owns VEC channels, 16 bytes (8 bf16 or 4 f32): one load or
//   store moves all of them (ld.global.nc.v4, asking L2 for the 256-byte
//   block around it). The wrapper picks the largest VEC that divides C
//   and suits the pointers' alignment, down to 1, so every C and every
//   view runs in this one kernel.
// - It makes COLS neighbouring output columns (4 at the widest VEC, 2 at
//   narrower ones; 3 is built for timing) and walks `rows` output rows
//   down the image (16 where the grid stays large, fewer at serving
//   sizes), keeping the input row that two output rows share in
//   registers: at stride 2 each output row loads 2 new input rows of
//   2 * COLS + 1 vectors for COLS outputs, 4.5 loads per output at
//   COLS = 4 and 5 at COLS = 2, instead of 9.
// - The block stages its channels' 9 taps and bias in shared memory as
//   f32 (from f32 or bf16, so the wrapper casts nothing) and each tap is
//   read where it is used, which leaves 164 registers a thread at VEC = 8
//   and COLS = 4 (three blocks an SM), 127 at COLS = 3 and 93 at COLS = 2
//   (`chip_smoke.py --tune-dw` prints the counts and times each COLS).
// - No division: the block's (image, row strip, column tile, channel
//   group) comes from blockIdx, the thread's channel vector and column
//   group from threadIdx (block = C / VEC x column groups). Column bounds
//   are checked once per thread, row bounds once per input row; a tap
//   outside the input loads zeros.
//
// Arithmetic order: taps (di, dj) in row-major order into 0.f, then
// + bias, then ReLU, each operation rounded on its own (__fmul_rn /
// __fadd_rn, no FMA contraction); the pw dot runs c = 0..C-1 the same way.
// A padding tap adds 0 * w, as the plain version's zero-padded copy does
// (the sum starts at +0 and so is never -0, which leaves it unchanged).
// The plain PyTorch versions in ops/cuda/dw_conv.py do exactly these
// operations, so kernel and plain version agree bit for bit.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;
constexpr int kDsTileW = 64;  // output columns per B3 block
constexpr int kFwdThreads = 128;  // B4 block: C / VEC (at most 128) x column groups

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

// VEC f32 values from shared memory. Volatile, so that the compiler reads
// them where they are used rather than keeping all 9 x VEC taps live in
// registers for the whole walk, which would halve the blocks an SM holds.
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

// Element i of a weight or bias vector stored as f32 or bf16, as f32.
__device__ __forceinline__ float weight_at(const void* p, int bf16, int64_t i) {
  return bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// B4: thread (threadIdx.x, threadIdx.y) owns channels [c0, c0 + VEC) of
// output columns [wo0, wo0 + COLS) and walks output rows [ho0, ho0 +
// rows) of image n. grid = (column tiles x channel groups, row strips, N). The
// block first stages the 9 taps and the bias of its channels in shared
// memory as f32 (weights and bias may each be f32 or bf16).
template <typename T, int VEC, int S, int COLS>
__global__ void __launch_bounds__(kFwdThreads)
dw_conv3x3_kernel(const T* __restrict__ x, const void* __restrict__ w9, int w_bf16,
                  const void* __restrict__ bias, int b_bf16, T* __restrict__ out, int H, int W,
                  int C, int Ho, int Wo, int pad, int rows, int groups, int relu) {
  constexpr int kIn = (COLS - 1) * S + 3;  // input columns a thread reads
  __shared__ __align__(16) float s_w[10][kFwdThreads * VEC];  // taps 0..8, bias
  int tile = blockIdx.x, group = 0;
  if (groups > 1) {  // C / VEC > kFwdThreads: channel groups share grid.x
    group = tile % groups;
    tile /= groups;
  }
  {
    const int cbase = group * blockDim.x * VEC, nch = blockDim.x * VEC;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
    for (int k = 0; k < (bias != nullptr ? 10 : 9); ++k)
      for (int j = tid; j < nch; j += nt) {
        const int c = cbase + j;
        s_w[k][j] = c >= C ? 0.f : k < 9 ? weight_at(w9, w_bf16, (int64_t)k * C + c)
                                         : weight_at(bias, b_bf16, c);
      }
  }
  __syncthreads();
  const int c0 = (group * blockDim.x + threadIdx.x) * VEC;
  const int wo0 = (tile * blockDim.y + threadIdx.y) * COLS;
  if (c0 >= C || wo0 >= Wo) return;
  const int n = blockIdx.z;
  const int ho0 = blockIdx.y * rows;
  const int ho1 = min(ho0 + rows, Ho);
  const float* my_w = &s_w[0][threadIdx.x * VEC];  // tap k at my_w + k * kFwdThreads * VEC

  // the thread's input columns: offsets from a row's start, and bounds
  int col_off[kIn];
  bool col_ok[kIn];
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    const int wi = wo0 * S - pad + j;
    col_ok[j] = (unsigned)wi < (unsigned)W;
    col_off[j] = wi * C + c0;
  }
  const T* xn = x + (int64_t)n * H * W * C;
  auto load_row = [&](int hi, Pack<T, VEC>(&row)[kIn]) {
    const bool row_ok = (unsigned)hi < (unsigned)H;
    const T* p = xn + (int64_t)(row_ok ? hi : 0) * W * C;
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      if (row_ok && col_ok[j]) row[j].load(p + col_off[j]);
      else row[j].zero();
    }
  };
  // acc[o] += taps (di, 0..2) of output column o from one input row
  auto add_taps = [&](float(&acc)[COLS][VEC], const Pack<T, VEC>(&row)[kIn], int di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      float w[VEC];
      lds_f32<VEC>(my_w + (di * 3 + dj) * kFwdThreads * VEC, w);
#pragma unroll
      for (int o = 0; o < COLS; ++o)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(row[o * S + dj].get(v), w[v]));
    }
  };
  auto zero = [](float(&acc)[COLS][VEC]) {
#pragma unroll
    for (int o = 0; o < COLS; ++o)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[o][v] = 0.f;
  };
  auto store = [&](const float(&acc)[COLS][VEC], int ho) {
    T* orow = out + ((int64_t)n * Ho + ho) * Wo * C;
    float b[VEC];
    if (bias != nullptr) lds_f32<VEC>(my_w + 9 * kFwdThreads * VEC, b);
#pragma unroll
    for (int o = 0; o < COLS; ++o) {
      if (wo0 + o >= Wo) continue;  // ragged last column group
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[i] = bias != nullptr ? __fadd_rn(acc[o][i], b[i]) : acc[o][i];
        if (relu) v[i] = fmaxf(v[i], 0.f);
      }
      store_pack<T, VEC>(orow + (int64_t)(wo0 + o) * C + c0, v);
    }
  };

  Pack<T, VEC> ra[kIn], rb[kIn];
  float acc[COLS][VEC];
  if constexpr (S == 2) {
    // input row 2 * ho - pad + 2 is tap row 2 of output row ho and tap row
    // 0 of ho + 1: it stays in rb from one output row to the next
    zero(acc);
    load_row(ho0 * 2 - pad, rb);
    add_taps(acc, rb, 0);
    for (int ho = ho0; ho < ho1; ++ho) {
      load_row(ho * 2 - pad + 1, ra);
      load_row(ho * 2 - pad + 2, rb);
      add_taps(acc, ra, 1);
      add_taps(acc, rb, 2);
      store(acc, ho);
      zero(acc);
      add_taps(acc, rb, 0);
    }
  } else {
    // stride 1: input row ho - pad + 2 is tap row 2 of ho, 1 of ho + 1 and
    // 0 of ho + 2, so three output rows are open at a time
    float acc1[COLS][VEC], acc2[COLS][VEC];
    zero(acc);
    zero(acc1);
    load_row(ho0 - pad, ra);
    add_taps(acc, ra, 0);
    load_row(ho0 - pad + 1, ra);
    add_taps(acc, ra, 1);
    add_taps(acc1, ra, 0);
    for (int ho = ho0; ho < ho1; ++ho) {
      load_row(ho - pad + 2, ra);
      add_taps(acc, ra, 2);
      store(acc, ho);
      add_taps(acc1, ra, 1);
      zero(acc2);
      add_taps(acc2, ra, 0);
#pragma unroll
      for (int o = 0; o < COLS; ++o)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[o][v] = acc1[o][v];
          acc1[o][v] = acc2[o][v];
        }
    }
  }
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

template <typename T, int VEC, int COLS>
int launch_dw(const void* x, const void* w9, int w_bf16, const void* bias, int b_bf16, void* out,
              int n, int h, int w, int c, int ho, int wo, int stride, int pad, int relu, int rows,
              int bx, int by, int tiles, int groups, cudaStream_t s) {
  if (bx * by > kFwdThreads) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles * groups, (ho + rows - 1) / rows, n);
  const dim3 block(bx, by);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (stride == 2)
    dw_conv3x3_kernel<T, VEC, 2, COLS><<<grid, block, 0, s>>>(
        xp, w9, w_bf16, bias, b_bf16, op, h, w, c, ho, wo, pad, rows, groups, relu);
  else
    dw_conv3x3_kernel<T, VEC, 1, COLS><<<grid, block, 0, s>>>(
        xp, w9, w_bf16, bias, b_bf16, op, h, w, c, ho, wo, pad, rows, groups, relu);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (n, h, w, c) in dtype, aligned to vec elements; w9 (9, c) and bias (c)
// or null in w_dtype and b_dtype (f32 or bf16); out (n, ho, wo, c). The
// launch plan (ops/cuda/dw_conv.py::dw_fwd_plan): vec channels a thread,
// cols output columns (2; 3 or 4 at the widest vec) by rows output rows a
// thread, block (bx, by), grid.x = tiles * groups.
extern "C" int fastscnn_dw_conv3x3(int dtype, const void* x, int w_dtype, const void* w9,
                                   int b_dtype, const void* bias, void* out, int n, int h, int w,
                                   int c, int ho, int wo, int stride, int pad, int relu, int vec,
                                   int cols, int rows, int bx, int by, int tiles, int groups,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int w_bf16 = w_dtype == kBF16, b_bf16 = b_dtype == kBF16;
#define FASTSCNN_DW(T, VEC, COLS)                                                     \
  return launch_dw<T, VEC, COLS>(x, w9, w_bf16, bias, b_bf16, out, n, h, w, c, ho, wo, \
                                 stride, pad, relu, rows, bx, by, tiles, groups, s)
  if (dtype == kBF16) {
    if (vec == 8 && cols == 2) FASTSCNN_DW(__nv_bfloat16, 8, 2);
    if (vec == 8 && cols == 3) FASTSCNN_DW(__nv_bfloat16, 8, 3);
    if (vec == 8 && cols == 4) FASTSCNN_DW(__nv_bfloat16, 8, 4);
    if (cols != 2) return (int)cudaErrorInvalidValue;
    if (vec == 4) FASTSCNN_DW(__nv_bfloat16, 4, 2);
    if (vec == 2) FASTSCNN_DW(__nv_bfloat16, 2, 2);
    if (vec == 1) FASTSCNN_DW(__nv_bfloat16, 1, 2);
  } else if (dtype == kF32) {
    if (vec == 4 && cols == 2) FASTSCNN_DW(float, 4, 2);
    if (vec == 4 && cols == 3) FASTSCNN_DW(float, 4, 3);
    if (vec == 4 && cols == 4) FASTSCNN_DW(float, 4, 4);
    if (cols != 2) return (int)cudaErrorInvalidValue;
    if (vec == 2) FASTSCNN_DW(float, 2, 2);
    if (vec == 1) FASTSCNN_DW(float, 1, 2);
  }
#undef FASTSCNN_DW
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
