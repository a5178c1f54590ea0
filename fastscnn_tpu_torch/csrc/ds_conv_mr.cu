// Multi-row fused depthwise-separable conv (DSConv) for the LTD stem of the
// BN-folded serving graph, NHWC, bf16 or f32 in and out, f32 accumulation.
//
// B5 ds_conv3x3_pw_multirow replaces fastscnn_tpu/ops/pallas/dw_conv.py::
//    ds_conv3x3_pw_pallas_multirow:  relu(pw1x1(round(relu(dw3x3(x) + b_dw))) + b_pw)
//
// It is B3's function (csrc/dw_conv.cu). What bounds it on an H100: bytes
// and the 1x1's f32 instructions about equally. A frame's two sites move
// ~63 MB (0.019 ms at 3.35 TB/s); the 1x1 rounds every product and sum on
// its own (no FMA, as the plain version), ~0.6 G f32 instructions, ~0.02 ms
// on 132 SMs.
//
// What the TPU kernel has and B3 lacks is the double buffer: it fetches
// block b + 1's input rows while it computes block b. So here a block owns
// one column tile of `tile` output columns and walks `strips` strips of
// `rows` output rows down one image:
// - Staging. A strip's (rows - 1) * stride + 3 input rows, (tile - 1) *
//   stride + 3 columns wide, land in one of two shared-memory slots by
//   cp.async, VEC channels (16 bytes at C = 32 and 48) a copy. The pad-1
//   border, the image's edges and a ragged last tile or strip are zeros
//   written by the copy itself (source size 0), not by a branch a thread.
//   Strip s + 2's copies go into the slot strip s leaves as soon as every
//   thread is past strip s's dw phase, so they land while the block
//   computes strip s + 1's dw phase and strip s's 1x1; the one input row
//   two stride-2 strips share is copied twice (1 / (2 * rows + 1) more
//   bytes, no ring).
// - dw phase, from the staged rows: a work item is VEC channels (one
//   16-byte ld.shared) by 2 output columns of one output row; taps and bias
//   are f32 in shared memory (read as stored, f32 or bf16); no division by
//   C in the tap loop. It writes the strip's activation, rounded to the
//   compute dtype (the unfused graph hands a bf16 tensor from the dw conv
//   to the 1x1), into shared memory, channel-major.
// - 1x1 phase, B3's: a thread makes 4 neighbouring pixels by 8 output
//   channels (32 sums in registers) from float4 reads of the activation and
//   of the weights rounded to the compute dtype, and stores 16-byte vectors.
// The phases are pipelined too, with two activation buffers: between two
// barriers a thread first does its dw items of strip s + 1, then its 1x1
// pixel groups of strip s, so that no thread waits at a barrier between
// the phases and the phases' uneven splits of work even out. One barrier a
// strip, after the wait for the next strip's copies, orders every slot and
// buffer reuse. The launch plan (rows, tile, strips, block) is
// ops/cuda/dw_conv.py::mr_plan, a function of the shape.
//
// Arithmetic order, identical to B3 and to the plain PyTorch version
// ds_conv3x3_pw_reference: taps (di, dj) in row-major order into +0.f (a
// padding tap adds 0 * w, which leaves the sum's value unchanged), + bias,
// ReLU, each operation rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction), then the round to the compute dtype; the pw dot runs
// c = 0..C-1 the same way. So kernel, B3 and the plain version agree bit
// for bit.
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kMrThreads = 256;  // a block's threads at most
constexpr int kMrCols = 2;       // output columns a dw item
constexpr int kMrPix = 4;        // neighbouring pixels a thread in the 1x1 phase
constexpr int kMrCo = 8;         // output channels a thread in the 1x1 phase

// Bytes of one input slot: rows_in x cols_in x C elements, rounded up to 16.
__host__ __device__ inline int mr_slot_bytes(int rows, int tile, int c, int stride, int itemsize) {
  const int rows_in = (rows - 1) * stride + 3, cols_in = (tile - 1) * stride + 3;
  return (rows_in * cols_in * c * itemsize + 15) & ~15;
}

// Shared memory of one block, in bytes (ops/cuda/dw_conv.py::_mr_smem_bytes
// computes the same): f32 dw taps and bias [10][C] (padded to 4 floats),
// 1x1 weights rounded to T [C][cop], 1x1 bias [cop], two strips' dw
// activations [2][C][rows * tile]; then the two input slots.
__host__ __device__ inline size_t mr_smem_bytes(int rows, int tile, int c, int cop, int stride,
                                                int itemsize) {
  return 4 * ((size_t)((10 * c + 3) & ~3) + (size_t)c * cop + cop + 2 * (size_t)c * rows * tile) +
         2 * (size_t)mr_slot_bytes(rows, tile, c, stride, itemsize);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) makes output columns [wo0,
// wo0 + tile) of strips [blockIdx.y * strips, + strips) of image n, every
// output channel; block (Cout groups of kMrCo, pixel-group stride), so
// that neighbouring lanes share a pixel group's activation reads and a
// pixel's outputs leave in one contiguous run (lanes over pixels of one
// channel group, reading one weight vector, measured 8 % slower).
template <typename T, int VEC, int S>
__global__ void __launch_bounds__(kMrThreads, 2)
ds_conv3x3_pw_mr_kernel(const T* __restrict__ x, const void* __restrict__ w9, int w9_bf16,
                        const void* __restrict__ b_dw, int bdw_bf16, const void* __restrict__ w_pw,
                        int wpw_bf16, const void* __restrict__ b_pw, int bpw_bf16,
                        T* __restrict__ out, int H, int W, int C, int Cout, int Ho, int Wo, int pad,
                        int rows, int tile, int strips, int vec_out) {
  constexpr int kBytes = VEC * (int)sizeof(T);  // one copy
  constexpr int kIn = (kMrCols - 1) * S + 3;    // input columns a dw item reads
  extern __shared__ __align__(16) float smem[];
  const int cop = blockDim.x * kMrCo;
  const int npix = rows * tile;
  const int rows_in = (rows - 1) * S + 3, cols_in = (tile - 1) * S + 3;
  const int row_elems = cols_in * C;
  const int slot_elems = mr_slot_bytes(rows, tile, C, S, sizeof(T)) / (int)sizeof(T);
  float* s_dw = smem;                        // [10][C]
  float* s_pw = smem + ((10 * C + 3) & ~3);  // [C][cop], 16-byte aligned
  float* s_bp = s_pw + C * cop;              // [cop]
  float* mid = s_bp + cop;                   // [2][C][npix]
  T* slots = reinterpret_cast<T*>(mid + 2 * (size_t)C * npix);  // [2][rows_in][cols_in][C]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int n = blockIdx.z, wo0 = blockIdx.x * tile;
  const int wi0 = wo0 * S - pad;
  const int s0 = blockIdx.y * strips;
  const int ns = min(strips, (Ho + rows - 1) / rows - s0);
  const T* xn = x + (int64_t)n * H * W * C;
  // the in-image elements [lo, hi_end) of a staged row
  const int lo = max(0, -wi0) * C, hi_end = min(cols_in, W - wi0) * C;

  // strip's input rows into slot: chunk i of the slot is row i / chunks,
  // element (i % chunks) * VEC; the thread starts at chunk tid and steps
  // by nt chunks without dividing again
  const int chunks = row_elems / VEC;
  const int r_first = tid / chunks, e_first = (tid - r_first * chunks) * VEC;
  const int r_step = nt / chunks, e_step = (nt - r_step * chunks) * VEC;
  auto fetch = [&](int strip, int slot) {
    T* dst = slots + slot * slot_elems;
    const int hi0 = strip * rows * S - pad;
    for (int r = r_first, e = e_first; r < rows_in;) {
      const int hi = hi0 + r;
      const bool ok = (unsigned)hi < (unsigned)H && e >= lo && e < hi_end;
      const T* src = ok ? xn + ((int64_t)hi * W + wi0) * C + e : x;
      if constexpr (kBytes >= 4) {
        cp_async<kBytes>(smem_addr(dst + r * row_elems + e), src, ok ? kBytes : 0);
      } else {  // 2-byte elements one at a time: cp.async moves 4 bytes at least
        dst[r * row_elems + e] = ok ? *src : from_f32<T>(0.f);
      }
      r += r_step;
      e += e_step;
      if (e >= row_elems) {
        e -= row_elems;
        ++r;
      }
    }
  };
  if (ns > 0) fetch(s0, 0);
  cp_async_commit();
  if (ns > 1) fetch(s0 + 1, 1);
  cp_async_commit();  // (an empty group where the block has one strip)

  for (int i = tid; i < 9 * C; i += nt) s_dw[i] = weight_at(w9, w9_bf16, i);
  for (int i = tid; i < C; i += nt) s_dw[9 * C + i] = weight_at(b_dw, bdw_bf16, i);
  for (int i = tid; i < C * cop; i += nt) {
    const int c = i / cop, co = i - c * cop;
    s_pw[i] = co < Cout ? round_to<T>(weight_at(w_pw, wpw_bf16, (int64_t)c * Cout + co)) : 0.f;
  }
  for (int co = tid; co < cop; co += nt) s_bp[co] = co < Cout ? weight_at(b_pw, bpw_bf16, co) : 0.f;
  const int co0 = threadIdx.x * kMrCo;
  const float* wp = s_pw + co0;
  const int cv_n = C / VEC, col_groups = tile / kMrCols;
  const int items = rows * col_groups * cv_n;

  // dw phase of local strip s: relu(dw3x3 + b_dw) rounded to T, from slot
  // s & 1 into mid s & 1. Items run channel vector fastest, then column
  // pair, then row.
  auto dw_phase = [&](int s) {
    const T* xs = slots + (s & 1) * slot_elems;
    float* m_out = mid + (s & 1) * C * npix;
    for (int it = tid; it < items; it += nt) {
      const int cv = it % cv_n, t = it / cv_n;
      const int cg = t % col_groups, r = t / col_groups;
      const int c0 = cv * VEC, wl = cg * kMrCols;
      const T* base = xs + ((r * S) * cols_in + wl * S) * C + c0;
      const float* my_w = s_dw + c0;  // tap k at my_w + k * C, the bias at my_w + 9 * C
      float acc[kMrCols][VEC];
#pragma unroll
      for (int o = 0; o < kMrCols; ++o)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[o][v] = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        Pack<T, VEC> row[kIn];
#pragma unroll
        for (int j = 0; j < kIn; ++j) row[j].load_shared(base + (di * cols_in + j) * C);
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          float w[VEC];
          lds_f32<VEC>(my_w + (di * 3 + dj) * C, w);
#pragma unroll
          for (int o = 0; o < kMrCols; ++o)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(row[o * S + dj].get(v), w[v]));
        }
      }
      float b[VEC];
      lds_f32<VEC>(my_w + 9 * C, b);
      float* m = m_out + (size_t)c0 * npix + r * tile + wl;
      static_assert(kMrCols == 2, "the store writes two columns");
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        *reinterpret_cast<float2*>(m + v * npix) =
            make_float2(round_to<T>(fmaxf(__fadd_rn(acc[0][v], b[v]), 0.f)),
                        round_to<T>(fmaxf(__fadd_rn(acc[1][v], b[v]), 0.f)));
    }
  };

  // 1x1 phase of local strip s: relu(sum_c mid[c] * w_pw[c] + b_pw), c in
  // order, from mid s & 1 to the output
  auto pw_phase = [&](int s) {
    float bias[kMrCo];
#pragma unroll
    for (int j = 0; j < kMrCo; ++j) bias[j] = s_bp[co0 + j];
    const int ho0 = (s0 + s) * rows;
    const int nrows = min(rows, Ho - ho0);
    const float* m_in = mid + (s & 1) * C * npix;
    for (int pg = threadIdx.y; pg < npix / kMrPix; pg += blockDim.y) {
      const int p0 = pg * kMrPix;
      const int r = p0 / tile, wo = wo0 + p0 % tile;
      if (r >= nrows || wo >= Wo) continue;
      float acc[kMrPix][kMrCo];
#pragma unroll
      for (int i = 0; i < kMrPix; ++i)
#pragma unroll
        for (int j = 0; j < kMrCo; ++j) acc[i][j] = 0.f;
      const float* mp = m_in + p0;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 m4 = *reinterpret_cast<const float4*>(mp + c * npix);
        const float4 wa = *reinterpret_cast<const float4*>(wp + c * cop);
        const float4 wb = *reinterpret_cast<const float4*>(wp + c * cop + 4);
        const float mv[kMrPix] = {m4.x, m4.y, m4.z, m4.w};
        const float wv[kMrCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < kMrPix; ++i)
#pragma unroll
          for (int j = 0; j < kMrCo; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(mv[i], wv[j]));
      }
      T* op = out + (((int64_t)n * Ho + ho0 + r) * Wo + wo) * Cout + co0;
#pragma unroll
      for (int i = 0; i < kMrPix; ++i) {
        if (wo + i >= Wo) break;  // ragged last tile
        float v[kMrCo];
#pragma unroll
        for (int j = 0; j < kMrCo; ++j) v[j] = fmaxf(__fadd_rn(acc[i][j], bias[j]), 0.f);
        if (vec_out) {
          store8<T>(op + i * Cout, v);
        } else {
#pragma unroll
          for (int j = 0; j < kMrCo; ++j)
            if (co0 + j < Cout) op[i * Cout + j] = from_f32<T>(v[j]);
        }
      }
    }
  };

  cp_async_wait<1>();  // strip 0's rows (this thread's copies)
  __syncthreads();     // everyone's, and the weights
  if (ns > 0) dw_phase(0);
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<0>();  // strip s + 1's rows
    // everyone's; dw(s) and pw(s - 1) are done, so slot s & 1 and mid
    // (s + 1) & 1 are free
    __syncthreads();
    if (s + 2 < ns) fetch(s0 + s + 2, s & 1);
    cp_async_commit();
    if (s + 1 < ns) dw_phase(s + 1);
    pw_phase(s);
  }
}

template <typename T, int VEC>
int launch_mr(const void* x, int w9_bf16, const void* w9, int bdw_bf16, const void* b_dw,
              int wpw_bf16, const void* w_pw, int bpw_bf16, const void* b_pw, void* out, int n,
              int h, int w, int c, int cout, int ho, int wo, int stride, int pad, int rows,
              int tile, int strips, int bx, int by, int vec_out, cudaStream_t s) {
  if (bx * by > kMrThreads || bx * kMrCo < cout || rows < 1 || strips < 1 || tile < kMrPix ||
      tile % kMrPix || c % VEC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mr_smem_bytes(rows, tile, c, bx * kMrCo, stride, sizeof(T));
  auto* kernel =
      stride == 2 ? ds_conv3x3_pw_mr_kernel<T, VEC, 2> : ds_conv3x3_pw_mr_kernel<T, VEC, 1>;
  static SmemOptIn opt_in[2];  // the two kernels, stride 1 and 2
  const cudaError_t e = opt_in[stride - 1].allow(reinterpret_cast<const void*>(kernel), (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nstrips = (ho + rows - 1) / rows;
  const dim3 grid((wo + tile - 1) / tile, (nstrips + strips - 1) / strips, n);
  kernel<<<grid, dim3(bx, by), smem, s>>>(
      static_cast<const T*>(x), w9, w9_bf16, b_dw, bdw_bf16, w_pw, wpw_bf16, b_pw, bpw_bf16,
      static_cast<T*>(out), h, w, c, cout, ho, wo, pad, rows, tile, strips, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (n, h, w, c) in dtype, aligned to vec elements; w9 (9, c), b_dw (c),
// w_pw (c, cout) and b_pw (cout) each f32 or bf16 (its own dtype code);
// out (n, ho, wo, cout), 16-byte aligned with cout % 8 == 0 when vec_out.
// The launch plan (ops/cuda/dw_conv.py::mr_plan): rows output rows a
// strip, tile output columns a block, strips a block walks, block (bx, by):
// bx >= cout / 8 output-channel groups by a pixel-group stride by.
extern "C" int fastscnn_ds_conv3x3_pw_mr(int dtype, const void* x, int w9_dtype, const void* w9,
                                         int bdw_dtype, const void* b_dw, int wpw_dtype,
                                         const void* w_pw, int bpw_dtype, const void* b_pw,
                                         void* out, int n, int h, int w, int c, int cout, int ho,
                                         int wo, int stride, int pad, int vec, int rows, int tile,
                                         int strips, int bx, int by, int vec_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
#define FASTSCNN_MR(T, VEC)                                                                    \
  return launch_mr<T, VEC>(x, w9_dtype == kBF16, w9, bdw_dtype == kBF16, b_dw,                 \
                           wpw_dtype == kBF16, w_pw, bpw_dtype == kBF16, b_pw, out, n, h, w, c, \
                           cout, ho, wo, stride, pad, rows, tile, strips, bx, by, vec_out, s)
  if (dtype == kBF16) {
    if (vec == 8) FASTSCNN_MR(__nv_bfloat16, 8);
    if (vec == 4) FASTSCNN_MR(__nv_bfloat16, 4);
    if (vec == 2) FASTSCNN_MR(__nv_bfloat16, 2);
    if (vec == 1) FASTSCNN_MR(__nv_bfloat16, 1);
  } else if (dtype == kF32) {
    if (vec == 4) FASTSCNN_MR(float, 4);
    if (vec == 2) FASTSCNN_MR(float, 2);
    if (vec == 1) FASTSCNN_MR(float, 1);
  }
#undef FASTSCNN_MR
  return (int)cudaErrorInvalidValue;
}
