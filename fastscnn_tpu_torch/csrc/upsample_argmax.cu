// Bilinear-upsample + argmax mask heads: the full-resolution logits are
// never written to device memory.
//
// B1 upsample_argmax replaces fastscnn_tpu/ops/pallas/upsample_argmax.py::
//    upsample_argmax: mask = argmax_C(bilinear(logits NHWC)), int32.
// B2 h_lerp_argmax replaces the Pallas H-lerp/argmax kernel inside
//    fastscnn_tpu/ops/pallas/upsample_argmax.py::w_matmul_h_lerp_argmax:
//    the H pass of the W-upsampled (N, h, C, W) tensor, then argmax_C.
//
// What bounds them on an H100: instruction issue, not bytes. Per output
// pixel each writes 4 bytes of int32 mask and reads little (B1 1.25 MB of
// logits per 1024x2048 frame, B2 10 MB): 2.9 and 5.5 us of bytes. But a
// pixel and class cost at least 5 instructions (the W-lerp's multiply and
// add, each rounded on its own, and the argmax's compare and two selects:
// 200 M at 19 classes a frame, ~12 K clocks on the 528 schedulers), which
// take longer at the CUDA cores' issue rate than the bytes take at the
// memory's rate: both designs keep every other instruction out of the
// class loop (PERF.md, section 6).
//
// Both drop the TPU's interpolation matrices (the dense matmuls were for
// the MXU) and interpolate two taps per axis from the same lerp tables as
// ops/resize.py::_axis_lerp_coeffs, built by the wrappers: B2 takes them as
// (lo int64, hi int64, w f32) arrays, B1 takes the w arrays and an int32
// table of its tiles and runs (ops/cuda/upsample_argmax.py::_run_table).
//   B1: runs in both axes. A block, one warp, takes a tile of output
//       columns by a run of at most 4 output rows that share one source row
//       pair (ops/cuda/upsample_argmax.py::upsample_plan). It copies the
//       run's two source rows, columns wlo[first column] .. whi[last
//       column], into shared memory: one contiguous run of the NHWC logits
//       a row, in the stored dtype, by 16-byte cp.async from a 16-byte
//       boundary (element by element where the row or the pointer forbids
//       16). A lane owns a run of at most 8 (or 4) output columns that
//       share one source column pair (upsample_column_tiles), so per class
//       it loads its pair's four staged values and forms their H
//       differences once for the block's rows, each row's two H-lerps t_lo
//       and t_hi and their difference d = t_hi - t_lo once for its columns,
//       and then per pixel only the W-lerp's multiply and add and the
//       argmax step: 32 independent pixels a thread. The mask leaves
//       through a padded buffer in shared memory as int4 stores coalesced
//       along the row, where W % 4 == 0.
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
// B1: one warp a block, one block a task: a tile of output columns by a
// run of at most R output rows of one image that share one source row
// pair; a lane takes a run of at most KC output columns of the tile that
// share one source column pair. The tasks go tile by tile, so that those
// of the last tile, the one with the fewest column runs, start last and
// the card's last partial wave holds the lightest blocks. runs: ops/cuda/upsample_argmax.py
// ::_run_table, laid out as RunTable reads it. VCOPY: the staging by
// 16-byte cp.async (x 16-byte aligned and w * C * sizeof(T) % 16 == 0),
// else element by element. vec_out: the mask by int4 stores.
struct RunTable {
  const int* p;
  int ntiles, nruns, nrows;
  // tile t: columns x0 .. x1 - 1, column runs r0 .. r1 - 1, staged source
  // columns j0 .. j1 (j0 a multiple of the plan's align)
  __device__ int x0(int t) const { return p[t]; }
  __device__ int x1(int t) const { return p[t + 1]; }
  __device__ int r0(int t) const { return p[ntiles + 1 + t]; }
  __device__ int r1(int t) const { return p[ntiles + 2 + t]; }
  __device__ int j0(int t) const { return p[2 * ntiles + 2 + t]; }
  __device__ int j1(int t) const { return p[3 * ntiles + 2 + t]; }
  // column run r: first column, count, source column wlo - j0, whi - wlo
  __device__ const int* col(int field) const { return p + 4 * ntiles + 2 + field * nruns; }
  // row run y: first row, count, source rows hlo and hhi
  __device__ const int* row(int field) const {
    return p + 4 * ntiles + 2 + 4 * nruns + field * nrows;
  }
};

// a staged element as f32 (a bf16 is the top half of its f32)
__device__ __forceinline__ float staged(const float* p) { return *p; }
__device__ __forceinline__ float staged(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

template <typename T, int KC, int R, bool VCOPY>
__global__ void __launch_bounds__(32, 16)
upsample_argmax_kernel(const T* __restrict__ x, const float* __restrict__ hw,
                       const float* __restrict__ ww, RunTable tab, int* __restrict__ out, int n_img,
                       int h, int w, int C, int H, int W, int vec_out) {
  constexpr int TW = 32 * KC;       // the most output columns a tile
  constexpr int TWP = TW + TW / 8;  // a mask row: 4 words of padding after every 32
  constexpr int kPer = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  int* mask = reinterpret_cast<int*>(smem);  // [R][TWP]: the block's mask rows
  T* st = reinterpret_cast<T*>(smem + sizeof(int) * R * TWP);  // [2][stride]: hlo and hhi rows
  const int per_tile = n_img * tab.nrows, lane = threadIdx.x;
  const int t = blockIdx.x / per_tile, n = blockIdx.x % per_tile / tab.nrows,
            yr = blockIdx.x % tab.nrows;
  const int x0 = tab.x0(t), x1 = tab.x1(t), r0 = tab.r0(t), r1 = tab.r1(t);
  const int y0 = tab.row(0)[yr], ny = tab.row(1)[yr];

  // stage the run's two source rows, columns j0 .. j1: one contiguous
  // NHWC run of the stored dtype a row
  const int j0 = tab.j0(t);
  const int run = (tab.j1(t) - j0 + 1) * C;  // staged elements a row
  const int stride = (run + kPer - 1) / kPer * kPer;
  const int64_t rowlen = (int64_t)w * C;
  const T* src0 = x + ((int64_t)n * h + tab.row(2)[yr]) * rowlen + (int64_t)j0 * C;
  const T* src1 = x + ((int64_t)n * h + tab.row(3)[yr]) * rowlen + (int64_t)j0 * C;
  int done = 0;  // elements of each row copied by 16-byte segments
  if constexpr (VCOPY) {
    const int segs = run / kPer;
    for (int i = lane; i < 2 * segs; i += 32) {
      const int p = i >= segs, e = (i - p * segs) * kPer;
      cp_async<16>(smem_addr(st + p * stride + e), (p ? src1 : src0) + e, 16);
    }
    cp_async_commit();
    done = segs * kPer;
  }
  for (int e = done + lane; e < run; e += 32) {
    st[e] = src0[e];
    st[stride + e] = src1[e];
  }

  const bool live = r0 + lane < r1;
  const int cr = live ? r0 + lane : r0;
  const int xs = tab.col(0)[cr];  // the lane's first column and count
  const int cnt = live ? tab.col(1)[cr] : 1;
  const T* lo = st + tab.col(2)[cr] * C;  // its source pair in the staged rows
  const int dj = tab.col(3)[cr] * C;
  float wx[KC];  // its columns' weights; slots past cnt repeat the last column
#pragma unroll
  for (int k = 0; k < KC; ++k) wx[k] = ww[xs + min(k, cnt - 1)];
  float wy[R];  // the run's rows' weights; slots past ny repeat the last row
#pragma unroll
  for (int q = 0; q < R; ++q) wy[q] = hw[y0 + min(q, ny - 1)];
  if constexpr (VCOPY) cp_async_wait<0>();
  __syncwarp();

  float best[R][KC];
  int arg[R][KC];
  // class c of the R x KC pixels: the staged values at both source columns
  // and their H differences once; per row the two H-lerps and their W
  // difference once; per pixel the W-lerp's multiply and add and the strict
  // '>' argmax step (class 0 only sets best)
  auto step = [&](int c, bool first) {
    const float a0 = staged(lo + c), a1 = staged(lo + dj + c);
    const float e0 = __fsub_rn(staged(lo + stride + c), a0);
    const float e1 = __fsub_rn(staged(lo + stride + dj + c), a1);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float t0 = __fadd_rn(a0, __fmul_rn(e0, wy[q]));
      const float d = __fsub_rn(__fadd_rn(a1, __fmul_rn(e1, wy[q])), t0);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = __fadd_rn(t0, __fmul_rn(d, wx[k]));
        if (first || v > best[q][k]) {
          best[q][k] = v;
          arg[q][k] = c;
        }
      }
    }
  };
  step(0, true);
  for (int c = 1; c < C; ++c) step(c, false);
  // the mask rows through the block's buffer (padded, so that the lanes'
  // runs, 8 words apart, fall in different banks), then out along each row
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int col = xs - x0 + k;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (live && k < cnt) mask[q * TWP + col + 4 * (col / 32)] = arg[q][k];
  }
  __syncwarp();
  const int width = x1 - x0;
  for (int q = 0; q < ny; ++q) {
    int* orow = out + ((int64_t)n * H + y0 + q) * W + x0;
    const int* m = mask + q * TWP;
    if (vec_out) {
      for (int i = 4 * lane; i < width; i += 128)
        *reinterpret_cast<int4*>(orow + i) = *reinterpret_cast<const int4*>(m + i + 4 * (i / 32));
    } else {
      for (int i = lane; i < width; i += 32) orow[i] = m[i + 4 * (i / 32)];
    }
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

template <typename T, int KC, int R, bool VCOPY>
int launch_up_kernel(dim3 grid, const void* x, const void* hw, const void* ww, RunTable tab,
                     void* out, int n, int h, int w, int c, int H, int W, int smem, int vec_out,
                     cudaStream_t s) {
  auto* kernel = upsample_argmax_kernel<T, KC, R, VCOPY>;
  static SmemOptIn opt_in;  // the largest size allowed so far on each device
  const cudaError_t e = opt_in.allow(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32, smem, s>>>(static_cast<const T*>(x), static_cast<const float*>(hw),
                                static_cast<const float*>(ww), tab, static_cast<int*>(out), n, h,
                                w, c, H, W, vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_up(const void* x, const void* hw, const void* ww, const void* table, void* out, int n,
              int h, int w, int c, int H, int W, int tile, int rows, int smem, int ntiles,
              int nruns, int nrows, int vcopy, int vec_out, cudaStream_t s) {
  if (rows < 1 || rows > 4 || n < 1 || ntiles < 1 || nrows < 1 ||
      (int64_t)ntiles * nrows * n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ntiles * nrows * n);
  const RunTable tab{static_cast<const int*>(table), ntiles, nruns, nrows};
#define FASTSCNN_UP(KC, R, VC)                                                                \
  return launch_up_kernel<T, KC, R, VC>(grid, x, hw, ww, tab, out, n, h, w, c, H, W, smem, \
                                        vec_out, s)
#define FASTSCNN_UP_VC(KC, R) \
  if (vcopy) FASTSCNN_UP(KC, R, true); \
  FASTSCNN_UP(KC, R, false)
  if (tile == 256 && rows > 2) { FASTSCNN_UP_VC(8, 4); }
  if (tile == 256) { FASTSCNN_UP_VC(8, 2); }
  if (tile == 128 && rows > 2) { FASTSCNN_UP_VC(4, 4); }
  if (tile == 128) { FASTSCNN_UP_VC(4, 2); }
#undef FASTSCNN_UP_VC
#undef FASTSCNN_UP
  return (int)cudaErrorInvalidValue;
}

template <typename T, int WC, bool VCOPY>
int launch_h_kernel(dim3 grid, const void* xw, const void* hlo, const void* hhi, const void* hw,
                    void* out, int h, int c, int H, int W, int rows, int smem, int vec_out,
                    cudaStream_t s) {
  auto* kernel = h_lerp_argmax_kernel<T, WC, VCOPY>;
  static SmemOptIn opt_in;  // the largest size allowed so far on each device
  const cudaError_t e = opt_in.allow(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return (int)e;
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

// x (n, h, w, c) logits; hw (H) and ww (W) the lerp weights; out (n, H,
// W) int32. table: the column tiles' and runs' and the row runs' table;
// tile (256 or 128 columns), rows (at most 4 rows a run), smem (bytes a
// block), ntiles, nruns (column runs) and nrows (row runs) from
// ops/cuda/upsample_argmax.py::upsample_plan;
// vcopy: x 16-byte aligned and w * c * itemsize % 16 == 0; vec_out: W % 4
// == 0 and out 16-byte aligned.
extern "C" int fastscnn_upsample_argmax(int dtype, const void* x, const void* hw, const void* ww,
                                        const void* table, void* out, int n, int h, int w, int c,
                                        int H, int W, int tile, int rows, int smem, int ntiles,
                                        int nruns, int nrows, int vcopy, int vec_out,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_up<__nv_bfloat16>(x, hw, ww, table, out, n, h, w, c, H, W, tile, rows, smem,
                                    ntiles, nruns, nrows, vcopy, vec_out, s);
  if (dtype == kF32)
    return launch_up<float>(x, hw, ww, table, out, n, h, w, c, H, W, tile, rows, smem, ntiles,
                            nruns, nrows, vcopy, vec_out, s);
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
