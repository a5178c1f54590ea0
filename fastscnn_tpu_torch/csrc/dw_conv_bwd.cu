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
// dX. Its bytes are mostly the writes (dX is four times g at stride 2).
// The first design gave a thread one (w, c) element: 2-byte loads and
// stores, a 64-bit idx / C and idx % C, a % stride test and a branch for
// each of the 9 taps, and each g vector fetched again by up to 4 threads;
// it moved 188 MB in 0.905 ms at dsconv1 (~0.21 TB/s). This one takes the
// forward's vector path (dw_conv.cu, B4):
// - A thread owns VEC channels, 16 bytes (8 bf16 or 4 f32) where C and the
//   pointers allow (ops/cuda/dw_conv.py::vec_width, down to 1): one load
//   or store moves all of them. The block stages its channels' 9 taps in
//   shared memory as f32, read as stored (f32 or bf16).
// - Stride 2 splits dX by parity. Input row h receives tap row di only
//   where h + pad - di is even, so the tap rows that reach h are fixed by
//   the parity of h + pad, and so are the tap columns by that of w + pad.
//   A "cell" is the 2 x 2 dX pixels {h, h + 1} x {w, w + 1} with h + pad
//   and w + pad odd: it reads the 2 x 2 g pixels (a, b), (a, b + 1),
//   (a + 1, b), (a + 1, b + 1), a = (h + pad - 1) / 2, and takes 1 + 2 +
//   2 + 4 = 9 taps for its 4 outputs, with no parity test and no dead tap.
//   A thread makes COLS neighbouring cells and walks `rows` cell rows
//   down, keeping in registers the g row and column its neighbouring
//   cells share: ~1 new g vector a cell, each dX vector written once.
// - Stride 1 is the 3 x 3 stencil as a correlation: dX[h] takes g rows
//   h + pad, h + pad - 1, h + pad - 2 for tap rows 0, 1, 2. A thread makes
//   COLS neighbouring dX columns and walks its rows upwards, so that each
//   g row it loads is the first tap row of one open output row, the
//   second of the next and the third of a third (B4's walk, mirrored).
// - No division: the block's (image, row strip, column tile, channel
//   group) comes from blockIdx, the thread's channels and columns from
//   threadIdx. Odd and even H and W (383 and 192) need only bounds checks:
//   a g pixel outside g loads zeros (it adds 0 * w, which leaves the sum
//   unchanged for finite taps), and a dX pixel outside dX is not stored.
//   A dX pixel that no output reads (the last of an even padded width)
//   gets only such taps and writes 0.
// The plan (columns and rows a thread, block, grid) is a function of the
// shape (ops/cuda/dw_conv.py::dx_plan).
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

constexpr int kDxThreads = 128;  // dX block: C / VEC (at most 128) x column groups
constexpr int kDwThreads = 128;  // pass-1 block
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kReduceWarps = 8;  // pass 2: one warp per (tap, c)

// dX: thread (threadIdx.x, threadIdx.y) owns channels [c0, c0 + VEC) of
// COLS column units from u0 and walks `rows` row units of image n; grid =
// (column tiles x channel groups, row strips, N). At stride 2 a unit is a
// cell of 2 x 2 dX pixels, at stride 1 one dX pixel. The block first stages
// the 9 taps of its channels in shared memory as f32.
template <typename T, int VEC, int S, int COLS>
__global__ void __launch_bounds__(kDxThreads)
dw_conv3x3_dx_kernel(const T* __restrict__ g, const void* __restrict__ w9, int w_bf16,
                     T* __restrict__ dx, int H, int W, int C, int Ho, int Wo, int pad, int rows,
                     int groups) {
  __shared__ __align__(16) float s_w[9][kDxThreads * VEC];
  int tile = blockIdx.x, group = 0;
  if (groups > 1) {  // C / VEC > kDxThreads: channel groups share grid.x
    group = tile % groups;
    tile /= groups;
  }
  {
    const int cbase = group * blockDim.x * VEC, nch = blockDim.x * VEC;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
    for (int k = 0; k < 9; ++k)
      for (int j = tid; j < nch; j += nt) {
        const int c = cbase + j;
        s_w[k][j] = c >= C ? 0.f : weight_at(w9, w_bf16, (int64_t)k * C + c);
      }
  }
  __syncthreads();
  const int c0 = (group * blockDim.x + threadIdx.x) * VEC;
  const int u0 = (tile * blockDim.y + threadIdx.y) * COLS;
  const int n = blockIdx.z;
  const T* gn = g + (int64_t)n * Ho * Wo * C;
  T* dn = dx + (int64_t)n * H * W * C;
  const float* my_w = &s_w[0][threadIdx.x * VEC];  // tap k at my_w + k * kDxThreads * VEC
  // acc[o] += tap k of g column o + shift, for each of the COLS units
  auto taps = [&](float(&acc)[COLS][VEC], const auto& row, int shift, int k) {
    float w[VEC];
    lds_f32<VEC>(my_w + k * kDxThreads * VEC, w);
#pragma unroll
    for (int o = 0; o < COLS; ++o)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(row[o + shift].get(v), w[v]));
  };
  auto zero = [](float(&acc)[COLS][VEC]) {
#pragma unroll
    for (int o = 0; o < COLS; ++o)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[o][v] = 0.f;
  };

  if constexpr (S == 2) {
    // cell (a, b): dX rows 2a + 1 - pad + {0, 1} by columns 2b + 1 - pad +
    // {0, 1}; cell row r is a = a_off + r, cell column u is b = a_off + u
    const int a_off = (pad - 1) >> 1;          // floor((pad - 1) / 2)
    const int first = 2 * a_off + 1 - pad;     // the first cell's first dX row: 0 or -1
    const int ncw = (W - first + 1) / 2, nch = (H - first + 1) / 2;
    if (c0 >= C || u0 >= ncw) return;
    constexpr int kG = COLS + 1;  // g columns b0 .. b0 + COLS
    const int b0 = a_off + u0;
    int g_off[kG];
    bool g_ok[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      g_ok[j] = (unsigned)(b0 + j) < (unsigned)Wo;
      g_off[j] = (b0 + j) * C + c0;
    }
    // the left (q = 0) and right (q = 1) dX column of each cell o:
    // 2 * (b0 + o) + 1 - pad + q
    int d_off[2][COLS];
    bool d_ok[2][COLS];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 0; o < COLS; ++o) {
        const int wc = 2 * (b0 + o) + 1 - pad + q;
        d_ok[q][o] = (unsigned)wc < (unsigned)W;
        d_off[q][o] = wc * C + c0;
      }
    auto load_row = [&](int a, Pack<T, VEC>(&row)[kG]) {
      const bool row_ok = (unsigned)a < (unsigned)Ho;
      const T* p = gn + (int64_t)(row_ok ? a : 0) * Wo * C;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        if (row_ok && g_ok[j]) row[j].load(p + g_off[j]);
        else row[j].zero();
      }
    };
    // one column (d_off[q], d_ok[q]) of every cell, dX row h
    auto store = [&](const float(&acc)[COLS][VEC], int h, const int(&off)[COLS],
                     const bool(&ok)[COLS]) {
      if ((unsigned)h >= (unsigned)H) return;
      T* p = dn + (int64_t)h * W * C;
#pragma unroll
      for (int o = 0; o < COLS; ++o)
        if (ok[o]) store_pack<T, VEC>(p + off[o], acc[o]);
    };
    const int r0 = blockIdx.y * rows, r1 = min(r0 + rows, nch);
    Pack<T, VEC> ga[kG], gb[kG];  // g rows a and a + 1, columns b0 ..
    load_row(a_off + r0, ga);
    float acc[COLS][VEC];
    for (int r = r0; r < r1; ++r) {
      const int a = a_off + r, h = 2 * a + 1 - pad;
      load_row(a + 1, gb);
      // taps are k = 3 di + dj, each output's in ascending k
      zero(acc);  // (h, w): (1, 1) of g[a, b]
      taps(acc, ga, 0, 4);
      store(acc, h, d_off[0], d_ok[0]);
      zero(acc);  // (h, w + 1): (1, 0) of g[a, b + 1], (1, 2) of g[a, b]
      taps(acc, ga, 1, 3);
      taps(acc, ga, 0, 5);
      store(acc, h, d_off[1], d_ok[1]);
      zero(acc);  // (h + 1, w): (0, 1) of g[a + 1, b], (2, 1) of g[a, b]
      taps(acc, gb, 0, 1);
      taps(acc, ga, 0, 7);
      store(acc, h + 1, d_off[0], d_ok[0]);
      zero(acc);  // (h + 1, w + 1): (0, 0), (0, 2), (2, 0), (2, 2)
      taps(acc, gb, 1, 0);
      taps(acc, gb, 0, 2);
      taps(acc, ga, 1, 6);
      taps(acc, ga, 0, 8);
      store(acc, h + 1, d_off[1], d_ok[1]);
#pragma unroll
      for (int j = 0; j < kG; ++j) ga[j] = gb[j];
    }
  } else {
    // dX[h, w] = sum over (di, dj) of g[h + pad - di, w + pad - dj] * w[di, dj]
    if (c0 >= C || u0 >= W) return;
    constexpr int kG = COLS + 2;  // g columns u0 + pad - 2 .. u0 + COLS - 1 + pad
    int g_off[kG];
    bool g_ok[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int b = u0 + pad - 2 + j;
      g_ok[j] = (unsigned)b < (unsigned)Wo;
      g_off[j] = b * C + c0;
    }
    auto load_row = [&](int a, Pack<T, VEC>(&row)[kG]) {
      const bool row_ok = (unsigned)a < (unsigned)Ho;
      const T* p = gn + (int64_t)(row_ok ? a : 0) * Wo * C;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        if (row_ok && g_ok[j]) row[j].load(p + g_off[j]);
        else row[j].zero();
      }
    };
    // tap row di: output o takes dj = 0, 1, 2 from g columns o + 2, o + 1, o
    auto add_taps = [&](float(&acc)[COLS][VEC], const Pack<T, VEC>(&row)[kG], int di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) taps(acc, row, 2 - dj, di * 3 + dj);
    };
    auto store = [&](const float(&acc)[COLS][VEC], int h) {
      T* p = dn + ((int64_t)h * W + u0) * C + c0;
#pragma unroll
      for (int o = 0; o < COLS; ++o)
        if (u0 + o < W) store_pack<T, VEC>(p + o * C, acc[o]);
    };
    const int h0 = blockIdx.y * rows, h1 = min(h0 + rows, H);
    Pack<T, VEC> ra[kG];
    float acc[COLS][VEC], acc1[COLS][VEC], acc2[COLS][VEC];
    // g row h + pad - 2 is tap row 2 of h, 1 of h - 1 and 0 of h - 2, so
    // walking h downwards three output rows are open at a time
    zero(acc);
    zero(acc1);
    load_row(h1 - 1 + pad, ra);
    add_taps(acc, ra, 0);
    load_row(h1 - 2 + pad, ra);
    add_taps(acc, ra, 1);
    add_taps(acc1, ra, 0);
    for (int h = h1 - 1; h >= h0; --h) {
      load_row(h + pad - 2, ra);
      add_taps(acc, ra, 2);
      store(acc, h);
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

template <typename T, int VEC, int COLS>
int launch_dx(const void* g, const void* w9, int w_bf16, void* dx, int n, int h, int w, int c,
              int ho, int wo, int stride, int pad, int rows, int bx, int by, int tiles, int groups,
              cudaStream_t s) {
  if (bx * by > kDxThreads || rows < 1) return (int)cudaErrorInvalidValue;
  const int row_units = stride == 2 ? (h - (2 * ((pad - 1) >> 1) + 1 - pad) + 1) / 2 : h;
  const dim3 grid(tiles * groups, (row_units + rows - 1) / rows, n);
  const dim3 block(bx, by);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (stride == 2)
    dw_conv3x3_dx_kernel<T, VEC, 2, COLS><<<grid, block, 0, s>>>(gp, w9, w_bf16, dp, h, w, c, ho,
                                                                  wo, pad, rows, groups);
  else
    dw_conv3x3_dx_kernel<T, VEC, 1, COLS><<<grid, block, 0, s>>>(gp, w9, w_bf16, dp, h, w, c, ho,
                                                                  wo, pad, rows, groups);
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

// g (n, ho, wo, c) and dx (n, h, w, c) in dtype, aligned to vec elements;
// w9 (9, c) in w_dtype (f32 or bf16). The launch plan
// (ops/cuda/dw_conv.py::dx_plan): vec channels a thread, cols column units
// (2; 1 or 4 at the widest vec) by rows row units a thread, block (bx, by),
// grid.x = tiles * groups; a unit is a 2 x 2 cell at stride 2, a pixel at 1.
extern "C" int fastscnn_dw_conv3x3_dx(int dtype, const void* g, int w_dtype, const void* w9,
                                      void* dx, int n, int h, int w, int c, int ho, int wo,
                                      int stride, int pad, int vec, int cols, int rows, int bx,
                                      int by, int tiles, int groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int w_bf16 = w_dtype == kBF16;
#define FASTSCNN_DX(T, VEC, COLS)                                                             \
  return launch_dx<T, VEC, COLS>(g, w9, w_bf16, dx, n, h, w, c, ho, wo, stride, pad, rows, bx, \
                                 by, tiles, groups, s)
  if (dtype == kBF16) {
    if (vec == 8 && cols == 1) FASTSCNN_DX(__nv_bfloat16, 8, 1);
    if (vec == 8 && cols == 2) FASTSCNN_DX(__nv_bfloat16, 8, 2);
    if (vec == 8 && cols == 4) FASTSCNN_DX(__nv_bfloat16, 8, 4);
    if (cols != 2) return (int)cudaErrorInvalidValue;
    if (vec == 4) FASTSCNN_DX(__nv_bfloat16, 4, 2);
    if (vec == 2) FASTSCNN_DX(__nv_bfloat16, 2, 2);
    if (vec == 1) FASTSCNN_DX(__nv_bfloat16, 1, 2);
  } else if (dtype == kF32) {
    if (vec == 4 && cols == 1) FASTSCNN_DX(float, 4, 1);
    if (vec == 4 && cols == 2) FASTSCNN_DX(float, 4, 2);
    if (vec == 4 && cols == 4) FASTSCNN_DX(float, 4, 4);
    if (cols != 2) return (int)cudaErrorInvalidValue;
    if (vec == 2) FASTSCNN_DX(float, 2, 2);
    if (vec == 1) FASTSCNN_DX(float, 1, 2);
  }
#undef FASTSCNN_DX
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
