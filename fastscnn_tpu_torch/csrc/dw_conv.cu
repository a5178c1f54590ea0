// Depthwise 3x3 and fused depthwise-separable (DSConv) kernels for the
// LTD stem of the BN-folded serving graph, NHWC, bf16 or f32 in and out,
// f32 accumulation.
//
// B3 ds_conv3x3_pw replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    ds_conv3x3_pw_pallas:  relu(pw1x1(round(relu(dw3x3(x) + b_dw))) + b_pw)
// B4 dw_conv3x3 replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    dw_conv3x3_pallas:     [relu](dw3x3(x) [+ b])
//
// What bounds them on an H100. B4: bytes (9 FMAs per output element, far
// below the ~295 operations per byte where Hopper's compute would start to
// bind). B3 keeps the dw activation out of device memory entirely, which is
// the TPU kernel's whole point; its 1x1 is C (32 or 48) MACs per output,
// and since the plain version rounds every product and sum on its own (no
// FMA), a frame's two sites are ~0.71 G f32 instructions, ~0.021 ms on 132
// SMs: its arithmetic and its bytes (~0.019 ms) bound it about equally.
//
// B3 (see ds_conv3x3_pw_kernel). A block makes a tile of a few output rows
// by 64 columns, all channels, in two phases:
// - the dw phase takes B4's vector path (below): VEC channels a thread by
//   one 16-byte load, 2 output columns, a walk down the tile's rows that
//   keeps the input row two stride-2 output rows share in registers, taps
//   and bias staged in shared memory as f32 from f32 or bf16, no division.
//   It writes the tile's dw activation, rounded to the compute dtype (as
//   the unfused graph hands a bf16 tensor from the dw conv to the 1x1),
//   into shared memory, channel-major;
// - the 1x1 phase gives a thread 4 neighbouring pixels by 8 output
//   channels (32 sums in registers), reads the pixels and the staged 1x1
//   weights (rounded to the compute dtype) as float4s, and writes its
//   outputs as 16-byte vectors.
// Stride-2 column taps are plain strided loads (the TPU kernel's
// pair-merged lanes existed only for Mosaic's unit-stride slices), the
// pad-1 border is handled by bounds checks rather than a padded copy, and
// odd H/W (511x1023 after the stem conv's padding=0) need nothing special.
// The launch plan (rows a block, block shape) is ops/cuda/dw_conv.py::
// ds_plan, a function of the shape.
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

constexpr int kFwdThreads = 128;  // B4 block: C / VEC (at most 128) x column groups
// B3's block: `rows` output rows by kDsTileW output columns, all C and Cout
constexpr int kDsTileW = 64;     // output columns a block
constexpr int kDsCols = 2;       // output columns a thread in the dw phase
constexpr int kDsPix = 4;        // neighbouring pixels a thread in the 1x1 phase
constexpr int kDsCo = 8;         // output channels a thread in the 1x1 phase
constexpr int kDsThreads = 256;  // a block's threads at most

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

// B3: block (blockIdx.x, blockIdx.y, blockIdx.z) makes output rows
// [ho0, ho0 + rows) by columns [wo0, wo0 + kDsTileW) of image n, every
// output channel; block (Cout groups of kDsCo, pixel-group stride).
// Shared memory (f32): the 9 dw taps and dw bias [10][C]; the 1x1 weights
// rounded to T, [C][cop] (Cout padded with zeros to cop = kDsCo *
// blockDim.x); the 1x1 bias [cop]; and the tile's dw activation, rounded
// to T, channel-major [C][rows * kDsTileW].
// - dw phase: a work item is VEC channels by kDsCols output columns, walked
//   down the tile's rows as B4's threads walk theirs (the input row two
//   stride-2 output rows share stays in registers); items run column
//   group fastest, so a warp's stores to the tile are contiguous.
// - 1x1 phase: a thread owns kDsPix neighbouring pixels by kDsCo output
//   channels; for c = 0..C-1 in order it reads the pixels as one float4
//   and the weights as two, and adds the 32 products, each rounded on its
//   own. Neighbouring threads take neighbouring channel groups, so their
//   16-byte output stores are contiguous.
template <typename T, int VEC, int S>
__global__ void __launch_bounds__(kDsThreads)
ds_conv3x3_pw_kernel(const T* __restrict__ x, const void* __restrict__ w9, int w9_bf16,
                     const void* __restrict__ b_dw, int bdw_bf16, const void* __restrict__ w_pw,
                     int wpw_bf16, const void* __restrict__ b_pw, int bpw_bf16,
                     T* __restrict__ out, int H, int W, int C, int Cout, int Ho, int Wo, int pad,
                     int rows, int vec_out) {
  constexpr int kGroups = kDsTileW / kDsCols;  // column groups of a tile row
  constexpr int kIn = (kDsCols - 1) * S + 3;   // input columns a dw item reads
  extern __shared__ __align__(16) float smem[];
  const int cop = blockDim.x * kDsCo;
  const int npix = rows * kDsTileW;
  float* s_dw = smem;                        // [10][C]
  float* s_pw = smem + ((10 * C + 3) & ~3);  // [C][cop], 16-byte aligned
  float* s_bp = s_pw + C * cop;              // [cop]
  float* mid = s_bp + cop;                   // [C][npix]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int i = tid; i < 9 * C; i += nt) s_dw[i] = weight_at(w9, w9_bf16, i);
  for (int i = tid; i < C; i += nt) s_dw[9 * C + i] = weight_at(b_dw, bdw_bf16, i);
  for (int c = threadIdx.y; c < C; c += blockDim.y)
    for (int co = threadIdx.x; co < cop; co += blockDim.x)
      s_pw[c * cop + co] =
          co < Cout ? round_to<T>(weight_at(w_pw, wpw_bf16, (int64_t)c * Cout + co)) : 0.f;
  for (int co = tid; co < cop; co += nt) s_bp[co] = co < Cout ? weight_at(b_pw, bpw_bf16, co) : 0.f;
  const int co0 = threadIdx.x * kDsCo;
  const float* wp = s_pw + co0;
  const int n = blockIdx.z, ho0 = blockIdx.y * rows, wo0 = blockIdx.x * kDsTileW;
  const int nrows = min(rows, Ho - ho0);
  const T* xn = x + (int64_t)n * H * W * C;
  __syncthreads();

  // dw phase: relu(dw3x3 + b_dw) rounded to T, into mid
  for (int item = tid; item < (C / VEC) * kGroups; item += nt) {
    const int c0 = (item / kGroups) * VEC, wl = (item % kGroups) * kDsCols;
    const float* my_w = s_dw + c0;  // tap k at my_w + k * C, the bias at my_w + 9 * C
    int col_off[kIn];
    bool col_ok[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int wi = (wo0 + wl) * S - pad + j;
      col_ok[j] = (unsigned)wi < (unsigned)W;
      col_off[j] = wi * C + c0;
    }
    auto load_row = [&](int hi, Pack<T, VEC>(&row)[kIn]) {
      const bool row_ok = (unsigned)hi < (unsigned)H;
      const T* p = xn + (int64_t)(row_ok ? hi : 0) * W * C;
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        if (row_ok && col_ok[j]) row[j].load(p + col_off[j]);
        else row[j].zero();
      }
    };
    auto add_taps = [&](float(&acc)[kDsCols][VEC], const Pack<T, VEC>(&row)[kIn], int di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        float w[VEC];
        lds_f32<VEC>(my_w + (di * 3 + dj) * C, w);
#pragma unroll
        for (int o = 0; o < kDsCols; ++o)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(row[o * S + dj].get(v), w[v]));
      }
    };
    auto zero = [](float(&acc)[kDsCols][VEC]) {
#pragma unroll
      for (int o = 0; o < kDsCols; ++o)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[o][v] = 0.f;
    };
    auto store = [&](const float(&acc)[kDsCols][VEC], int r) {
      float b[VEC];
      lds_f32<VEC>(my_w + 9 * C, b);
      float* m = mid + (int64_t)c0 * npix + r * kDsTileW + wl;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        *reinterpret_cast<float2*>(m + v * npix) =
            make_float2(round_to<T>(fmaxf(__fadd_rn(acc[0][v], b[v]), 0.f)),
                        round_to<T>(fmaxf(__fadd_rn(acc[1][v], b[v]), 0.f)));
    };
    static_assert(kDsCols == 2, "store writes two columns");

    Pack<T, VEC> ra[kIn], rb[kIn];
    float acc[kDsCols][VEC];
    if constexpr (S == 2) {
      zero(acc);
      load_row(ho0 * 2 - pad, rb);
      add_taps(acc, rb, 0);
      for (int r = 0; r < nrows; ++r) {
        const int ho = ho0 + r;
        load_row(ho * 2 - pad + 1, ra);
        load_row(ho * 2 - pad + 2, rb);
        add_taps(acc, ra, 1);
        add_taps(acc, rb, 2);
        store(acc, r);
        zero(acc);
        add_taps(acc, rb, 0);
      }
    } else {
      float acc1[kDsCols][VEC], acc2[kDsCols][VEC];
      zero(acc);
      zero(acc1);
      load_row(ho0 - pad, ra);
      add_taps(acc, ra, 0);
      load_row(ho0 - pad + 1, ra);
      add_taps(acc, ra, 1);
      add_taps(acc1, ra, 0);
      for (int r = 0; r < nrows; ++r) {
        load_row(ho0 + r - pad + 2, ra);
        add_taps(acc, ra, 2);
        store(acc, r);
        add_taps(acc1, ra, 1);
        zero(acc2);
        add_taps(acc2, ra, 0);
#pragma unroll
        for (int o = 0; o < kDsCols; ++o)
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[o][v] = acc1[o][v];
            acc1[o][v] = acc2[o][v];
          }
      }
    }
  }
  __syncthreads();

  // 1x1 phase: relu(sum_c mid[c] * w_pw[c] + b_pw), c in order
  float bias[kDsCo];
#pragma unroll
  for (int j = 0; j < kDsCo; ++j) bias[j] = s_bp[co0 + j];
  for (int pg = threadIdx.y; pg < npix / kDsPix; pg += blockDim.y) {
    const int p0 = pg * kDsPix;
    const int r = p0 / kDsTileW, wo = wo0 + p0 % kDsTileW;
    if (r >= nrows || wo >= Wo) continue;
    float acc[kDsPix][kDsCo];
#pragma unroll
    for (int i = 0; i < kDsPix; ++i)
#pragma unroll
      for (int j = 0; j < kDsCo; ++j) acc[i][j] = 0.f;
    const float* mp = mid + p0;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 m4 = *reinterpret_cast<const float4*>(mp + c * npix);
      const float4 wa = *reinterpret_cast<const float4*>(wp + c * cop);
      const float4 wb = *reinterpret_cast<const float4*>(wp + c * cop + 4);
      const float mv[kDsPix] = {m4.x, m4.y, m4.z, m4.w};
      const float wv[kDsCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < kDsPix; ++i)
#pragma unroll
        for (int j = 0; j < kDsCo; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(mv[i], wv[j]));
    }
    T* op = out + (((int64_t)n * Ho + ho0 + r) * Wo + wo) * Cout + co0;
#pragma unroll
    for (int i = 0; i < kDsPix; ++i) {
      if (wo + i >= Wo) break;  // ragged last tile
      float v[kDsCo];
#pragma unroll
      for (int j = 0; j < kDsCo; ++j) v[j] = fmaxf(__fadd_rn(acc[i][j], bias[j]), 0.f);
      if (vec_out) {
        store8<T>(op + i * Cout, v);
      } else {
#pragma unroll
        for (int j = 0; j < kDsCo; ++j)
          if (co0 + j < Cout) op[i * Cout + j] = from_f32<T>(v[j]);
      }
    }
  }
}

template <typename T, int VEC>
int launch_ds(const void* x, int w9_bf16, const void* w9, int bdw_bf16, const void* b_dw,
              int wpw_bf16, const void* w_pw, int bpw_bf16, const void* b_pw, void* out, int n,
              int h, int w, int c, int cout, int ho, int wo, int stride, int pad, int rows, int bx,
              int by, int vec_out, cudaStream_t s) {
  if (bx * by > kDsThreads || bx * kDsCo < cout || rows < 1) return (int)cudaErrorInvalidValue;
  const int cop = bx * kDsCo;
  const size_t smem = sizeof(float) * (((size_t)10 * c + 3) / 4 * 4 + (size_t)c * cop + cop +
                                       (size_t)c * rows * kDsTileW);
  auto* kernel = stride == 2 ? ds_conv3x3_pw_kernel<T, VEC, 2> : ds_conv3x3_pw_kernel<T, VEC, 1>;
  static SmemOptIn opt_in[2];  // the two kernels, stride 1 and 2
  const cudaError_t e = opt_in[stride - 1].allow(reinterpret_cast<const void*>(kernel), (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((wo + kDsTileW - 1) / kDsTileW, (ho + rows - 1) / rows, n);
  kernel<<<grid, dim3(bx, by), smem, s>>>(
      static_cast<const T*>(x), w9, w9_bf16, b_dw, bdw_bf16, w_pw, wpw_bf16, b_pw, bpw_bf16,
      static_cast<T*>(out), h, w, c, cout, ho, wo, pad, rows, vec_out);
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

// x (n, h, w, c) in dtype, aligned to vec elements; w9 (9, c), b_dw (c),
// w_pw (c, cout) and b_pw (cout) each f32 or bf16 (its own dtype code);
// out (n, ho, wo, cout), 16-byte aligned with cout % 8 == 0 when vec_out.
// The launch plan (ops/cuda/dw_conv.py::ds_plan): rows output rows a block,
// block (bx, by), bx * 8 >= cout.
extern "C" int fastscnn_ds_conv3x3_pw(int dtype, const void* x, int w9_dtype, const void* w9,
                                      int bdw_dtype, const void* b_dw, int wpw_dtype,
                                      const void* w_pw, int bpw_dtype, const void* b_pw, void* out,
                                      int n, int h, int w, int c, int cout, int ho, int wo,
                                      int stride, int pad, int vec, int rows, int bx, int by,
                                      int vec_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
#define FASTSCNN_DS(T, VEC)                                                                    \
  return launch_ds<T, VEC>(x, w9_dtype == kBF16, w9, bdw_dtype == kBF16, b_dw,                 \
                           wpw_dtype == kBF16, w_pw, bpw_dtype == kBF16, b_pw, out, n, h, w, c, \
                           cout, ho, wo, stride, pad, rows, bx, by, vec_out, s)
  if (dtype == kBF16) {
    if (vec == 8) FASTSCNN_DS(__nv_bfloat16, 8);
    if (vec == 4) FASTSCNN_DS(__nv_bfloat16, 4);
    if (vec == 2) FASTSCNN_DS(__nv_bfloat16, 2);
    if (vec == 1) FASTSCNN_DS(__nv_bfloat16, 1);
  } else if (dtype == kF32) {
    if (vec == 4) FASTSCNN_DS(float, 4);
    if (vec == 2) FASTSCNN_DS(float, 2);
    if (vec == 1) FASTSCNN_DS(float, 1);
  }
#undef FASTSCNN_DS
  return (int)cudaErrorInvalidValue;
}
