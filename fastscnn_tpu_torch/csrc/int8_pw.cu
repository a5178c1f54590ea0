// Pointwise (1x1) convolutions on int8 activations with the requantizing
// epilogue fused, as (M, K) x (K, N) products of the NHWC activations
// flattened to rows.
//
// B7 pw_conv_a8 replaces fastscnn_tpu/ops/pallas/int8_pw.py::pw_conv_a8:
//    int8 x (exact as bf16) times bf16 effective weights, f32 sums,
//    + bias, [ReLU], -> bf16, or -> clip(round(.), +-127) int8.
// B8 pw_conv_w8a8 replaces int8_pw.py::pw_conv_w8a8:
//    int8 x times int8 weights, int32 sums, * per-channel f32 scale,
//    + bias, [ReLU], -> bf16 or int8 as above.
//
// What bounds them on an H100. On the serving path a frame runs them at 23
// (B7) or 25 (B8) sites with K from 32 to 768 and N from 48 to 768: about
// 136 MB of activations in and out but 11 G operations, so at the card's
// tensor-core rates (989 TFLOP/s bf16, 1,979 TOP/s int8) bytes bound them
// (~0.04 ms a frame), the operations a quarter of that.
//
// Both run on the tensor cores, as the TPU kernels' jnp.dot runs on the
// MXU, with one pipeline:
// - A block computes a BM x BN output tile with 4 or 8 warps, each warp a
//   (BM / WARPS_M) x (BN / WARPS_N) tile of 16 x 8 mma tiles whose sums
//   stay in registers. ops/cuda/int8_pw.py::pw_a8_plan and pw_w8a8_plan
//   pick the block tile from (M, K, N) so that every site's grid fills the
//   card.
// - K goes through a ring of 3 or 4 shared-memory stages (32 to 128 k a
//   stage), its copies started that many chunks ahead: the int8
//   activation chunk and the weight chunk (K x N, row-major) both by
//   cp.async, 16 bytes a thread (4 where K % 16 or the pointer forbids 16;
//   the weight element by element where N or the pointer forbids 16),
//   zero-filled past M, K and N through the copy's source size. The long-K
//   sites (K up to 768 at M = 2,048) have one block or two an SM, whose
//   loop would otherwise wait a memory latency per chunk.
// - Each chunk gets one pass that puts it in the form the mma fragments
//   want, one chunk ahead of the mmas that read it: B7 widens its int8
//   activations to bf16 (exact, by integer and f32 add tricks rather than
//   conversion instructions); B8 transposes its int8 weight chunk so that
//   each output channel's k lie contiguous, as the .col operand of
//   m16n8k32 wants (4 x 4-byte blocks by __byte_perm; the raw chunk's
//   16-byte segments are stored XOR-swizzled by row so that the pass's
//   reads spread over the banks).
// - Fragments come from ldmatrix (A; B8's transposed weight: the b16 view
//   of a 16-row x 32-byte int8 tile is exactly m16n8k32's fragment) and
//   ldmatrix.trans (B7's row-major bf16 weight), from rows padded by 16
//   bytes so that the 8 rows an ldmatrix reads fall in distinct banks.
// - B7: mma.sync m16n8k16, bf16 operands, f32 sums. B8: mma.sync
//   m16n8k32, s8 operands, s32 sums.
// - One epilogue: f32 t (B7: its sum; B8: __fmul_rn(__int2float_rn(sum),
//   cs[n])), then __fadd_rn(t, b[n]), [ReLU], bf16 (round to nearest
//   even) or clip(rint(.), +-127) int8, through a shared-memory tile so
//   that the outputs leave in 16-byte vectors where N allows it. The bias
//   is read in its stored dtype (f32 or bf16).
// - No split-K and no atomics: the bits are a function of the shape and
//   the inputs alone.
// B8's int32 sums are exact in any order (|sum| <= 127 * 127 * K < 2^24
// for K <= 768, so the int32 -> f32 conversion is exact too), and its
// epilogue is the plain version's operations, so B8 agrees with its plain
// version bit for bit. B7's products of an int8 value and a bf16 value are
// exact in f32, so only the order of the sums (the hardware's) differs
// from the plain version's in-order sum; ops/cuda/int8_pw.py::
// pw_conv_a8_tolerance states the bound.
//
// A ragged last M or N tile is masked, and k past K is zeros (the TPU
// kernels' M % 32 fallback to XLA becomes this mask).
#include "common.cuh"

namespace fastscnn {
namespace {

// ---- the mma, copy and epilogue pieces; B7 --------------------------------------
constexpr int kA8Pad = 8;  // bf16 of padding a shared-memory row (16 bytes)

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major bf16) * b (16 x 8, bf16), f32 sums
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one 32-bit word, k ascending) as four bf16, exactly, without a
// conversion instruction: the f32 with bits 0x4B000000 | (x ^ 0x80) is
// 2^23 + 128 + x, and subtracting 2^23 + 128 leaves x; an integer of at
// most 8 significant bits is a bf16, whose bits are its f32's upper half.
__device__ __forceinline__ uint2 widen_int8x4(unsigned v) {
  const unsigned u = v ^ 0x80808080u;
  unsigned f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)),
                                     8388736.f));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ int8_t requantize(float t) {
  return (int8_t)fminf(fmaxf(rintf(t), -127.f), 127.f);
}

// The shapes of one B7 block tile: BM x BN outputs, WARPS_M x WARPS_N
// warps, K in chunks of BK through a ring of STAGES shared-memory stages.
template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES>
struct A8Tile {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N;  // a warp's tile
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;            // its mma tiles
  static constexpr int kAS = BK + kA8Pad;  // bf16 activation row
  static constexpr int kBS = BN + kA8Pad;  // bf16 weight row
  static constexpr int kRawBytes = STAGES * BM * BK;       // int8 activations, [STAGES][BM][BK]
  static constexpr int kWBytes = STAGES * BK * kBS * 2;    // weights, [STAGES][BK][kBS]
  static constexpr int kABytes = 2 * BM * kAS * 2;         // bf16 activations, [2][BM][kAS]
  static constexpr int kPipeBytes = kRawBytes + kWBytes + kABytes;
  static constexpr int kOutBytes = BM * (BN + kA8Pad) * 2;  // the bf16 output tile
  static constexpr int kSmem = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
};

// The output tile from shared memory (row stride os) to out, 16 bytes a
// thread where vec_out (N a multiple of 16 bytes' elements, out aligned),
// else element by element.
template <typename TO, int BM, int BN>
__device__ __forceinline__ void write_tile(const TO* so, int os, TO* __restrict__ out, int m0,
                                           int n0, int M, int N, int vec_out, int tid, int nt) {
  constexpr int kPer = 16 / (int)sizeof(TO);
  constexpr int kRowSegs = BN / kPer;
  for (int s = tid; s < BM * kRowSegs; s += nt) {
    const int r = s / kRowSegs, c = (s % kRowSegs) * kPer;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    TO* dst = out + (int64_t)m * N + n;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(so + r * os + c);
    } else {
      for (int e = 0; e < kPer && n + e < N; ++e) dst[e] = so[r * os + c + e];
    }
  }
}

// The epilogue of a BM x BN block tile. Warp (wm, wn) holds the f32 values
// t[mi][ni][.] of its (BM / WARPS_M) x (BN / WARPS_N) tile, at rows
// lane / 4 (+ 8) and columns 2 (lane % 4) (+ 1) of each 16 x 8 mma tile:
// __fadd_rn(t, b[n]) (b f32, or bf16 when b_bf16), [ReLU], then bf16 or
// clip(rint(.), +-127) int8, staged in smem (which the caller has freed
// and synchronised) and written to out by write_tile.
template <int BM, int BN, int WARPS_M, int WARPS_N>
__device__ __forceinline__ void epilogue(const float (&t)[BM / WARPS_M / 16][BN / WARPS_N / 8][4],
                                         const void* __restrict__ b, int b_bf16,
                                         void* __restrict__ out, unsigned char* smem, int m0,
                                         int n0, int M, int N, int relu, int qout, int vec_out) {
  constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N, kMI = kWM / 16, kNI = kWN / 8;
  constexpr int kT = WARPS_M * WARPS_N * 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float bias[kNI][2];
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * kWN + ni * 8 + 2 * (lane % 4) + e;
      bias[ni][e] = n >= N ? 0.f : weight_at(b, b_bf16, n);
    }
  const int r0 = wm * kWM + lane / 4, c0 = wn * kWN + 2 * (lane % 4);
  if (qout) {
    constexpr int kOS = BN + 16;  // int8 row: 16 bytes of padding
    int8_t* so = reinterpret_cast<int8_t*>(smem);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t0 = __fadd_rn(t[mi][ni][2 * h], bias[ni][0]);
          float t1 = __fadd_rn(t[mi][ni][2 * h + 1], bias[ni][1]);
          if (relu) t0 = fmaxf(t0, 0.f), t1 = fmaxf(t1, 0.f);
          *reinterpret_cast<char2*>(so + (r0 + mi * 16 + 8 * h) * kOS + c0 + ni * 8) =
              make_char2(requantize(t0), requantize(t1));
        }
    __syncthreads();
    write_tile<int8_t, BM, BN>(so, kOS, static_cast<int8_t*>(out), m0, n0, M, N, vec_out, tid, kT);
  } else {
    constexpr int kOS = BN + kA8Pad;
    __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t0 = __fadd_rn(t[mi][ni][2 * h], bias[ni][0]);
          float t1 = __fadd_rn(t[mi][ni][2 * h + 1], bias[ni][1]);
          if (relu) t0 = fmaxf(t0, 0.f), t1 = fmaxf(t1, 0.f);
          *reinterpret_cast<unsigned*>(so + (r0 + mi * 16 + 8 * h) * kOS + c0 + ni * 8) =
              bf16x2_bits(t0, t1);
        }
    __syncthreads();
    write_tile<__nv_bfloat16, BM, BN>(so, kOS, static_cast<__nv_bfloat16*>(out), m0, n0, M, N,
                                      vec_out, tid, kT);
  }
}

// B7: grid (N tiles, M tiles). AVEC: bytes of one activation copy (16, or
// 4 where K % 16 or the pointer forbids 16); WVEC: the weight chunk by
// 16-byte cp.async (N % 8 == 0, aligned), else element by element.
//
// Chunk c's copies are started STAGES - 1 chunks ahead. In iteration c the
// block waits for chunk c + 1, widens its activations into the bf16 buffer
// (c + 1) % 2, and runs chunk c's mmas from buffer c % 2 and weight stage
// c % STAGES: one __syncthreads an iteration, and every copy and widening
// overlaps the mmas of an earlier chunk.
template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES, int AVEC, bool WVEC>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
pw_a8_mma_kernel(const int8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const void* __restrict__ b, int b_bf16, void* __restrict__ out, int M, int K,
                 int N, int relu, int qout, int vec_out) {
  using Tile = A8Tile<BM, BN, WARPS_M, WARPS_N, BK, STAGES>;
  constexpr int kT = Tile::kThreads;
  constexpr int kMI = Tile::kMI, kNI = Tile::kNI, kAS = Tile::kAS, kBS = Tile::kBS;
  static_assert(kMI >= 1 && kNI % 2 == 0 && BK % 16 == 0 && STAGES >= 3, "B7 tile");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_raw = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + Tile::kRawBytes);
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem + Tile::kRawBytes + Tile::kWBytes);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;

  auto fetch = [&](int c) {  // chunk c's copies into stage c % STAGES
    const int stage = c % STAGES, k0 = c * BK;
    constexpr int kRowSegs = BK / AVEC, kSegs = BM * kRowSegs;
    int8_t* raw = s_raw + stage * BM * BK;
    for (int s = tid; s < kSegs; s += kT) {
      const int r = s / kRowSegs, kk = (s % kRowSegs) * AVEC;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;
      cp_async<AVEC>(smem_addr(raw + r * BK + kk), ok ? x + (int64_t)m * K + k : x,
                     ok ? AVEC : 0);
    }
    __nv_bfloat16* ws = s_w + stage * BK * kBS;
    if constexpr (WVEC) {
      constexpr int kWRowSegs = BN / 8, kWSegs = BK * kWRowSegs;
      for (int s = tid; s < kWSegs; s += kT) {
        const int kr = s / kWRowSegs, c8 = (s % kWRowSegs) * 8;
        const int k = k0 + kr, n = n0 + c8;
        const bool ok = k < K && n < N;
        cp_async<16>(smem_addr(ws + kr * kBS + c8), ok ? w + (int64_t)k * N + n : w,
                     ok ? 16 : 0);
      }
    } else {
      for (int s = tid; s < BK * BN; s += kT) {
        const int kr = s / BN, cc = s % BN;
        const int k = k0 + kr, n = n0 + cc;
        ws[kr * kBS + cc] = (k < K && n < N) ? w[(int64_t)k * N + n] : __float2bfloat16(0.f);
      }
    }
  };
  auto widen = [&](int c) {  // chunk c's int8 activations into bf16 buffer c % 2
    const int8_t* raw = s_raw + (c % STAGES) * BM * BK;
    __nv_bfloat16* a = s_a + (c & 1) * BM * kAS;
    constexpr int kRowSegs = BK / 16;
    for (int s = tid; s < BM * kRowSegs; s += kT) {
      const int r = s / kRowSegs, kk = (s % kRowSegs) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(raw + r * BK + kk);
      uint4* dst = reinterpret_cast<uint4*>(a + r * kAS + kk);
      const uint2 w0 = widen_int8x4(q.x), w1 = widen_int8x4(q.y);
      const uint2 w2 = widen_int8x4(q.z), w3 = widen_int8x4(q.w);
      dst[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);
      dst[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);
    }
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) fetch(c);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // chunk 0
  __syncthreads();
  widen(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 3>();  // chunks up to kc + 1
    __syncthreads();
    if (kc + STAGES - 1 < nk) fetch(kc + STAGES - 1);  // into the stage chunk kc - 1 used
    cp_async_commit();
    if (kc + 1 < nk) widen(kc + 1);
    // A from ldmatrix (rows lane % 16, k (lane / 16) * 8); the row-major
    // weight from ldmatrix.trans (k rows lane % 16, n (lane / 16) * 8)
    const __nv_bfloat16* a_s = s_a + (kc & 1) * BM * kAS +
                               (wm * Tile::kWM + lane % 16) * kAS + (lane / 16) * 8;
    const __nv_bfloat16* w_s = s_w + (kc % STAGES) * BK * kBS + (lane % 16) * kBS +
                               wn * Tile::kWN + (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) ldsm_x4(af[mi], smem_addr(a_s + mi * 16 * kAS + ks));
      unsigned bf[kNI][2];
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        unsigned r[4];  // k 0-7 and 8-15 of n-tiles 2 nj and 2 nj + 1
        ldsm_x4_trans(r, smem_addr(w_s + ks * kBS + nj * 16));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  __syncthreads();  // every warp is done with the ring before the epilogue reuses it
  epilogue<BM, BN, WARPS_M, WARPS_N>(acc, b, b_bf16, out, smem, m0, n0, M, N, relu, qout, vec_out);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES, int AVEC, bool WVEC>
int launch_a8_kernel(dim3 grid, const int8_t* x, const __nv_bfloat16* w, const void* b,
                     int b_bf16, void* out, int m, int k, int n, int relu, int qout, int vec_out,
                     cudaStream_t s) {
  using Tile = A8Tile<BM, BN, WARPS_M, WARPS_N, BK, STAGES>;
  auto* kernel = pw_a8_mma_kernel<BM, BN, WARPS_M, WARPS_N, BK, STAGES, AVEC, WVEC>;
  static SmemOptIn opt_in;  // once per instantiation and device
  const cudaError_t e = opt_in.allow(reinterpret_cast<const void*>(kernel), Tile::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Tile::kThreads, Tile::kSmem, s>>>(x, w, b, b_bf16, out, m, k, n, relu, qout,
                                                    vec_out);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES>
int launch_a8(const void* x, const void* w, const void* b, int b_bf16, void* out, int m, int k,
              int n, int relu, int qout, int avec, int wvec, int vec_out, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
#define FASTSCNN_A8(AV, WV)                                                                \
  return launch_a8_kernel<BM, BN, WARPS_M, WARPS_N, BK, STAGES, AV, WV>(                    \
      grid, xp, wp, b, b_bf16, out, m, k, n, relu, qout, vec_out, s)
  if (avec == 16 && wvec) FASTSCNN_A8(16, true);
  if (avec == 16) FASTSCNN_A8(16, false);
  if (avec == 4 && wvec) FASTSCNN_A8(4, true);
  if (avec == 4) FASTSCNN_A8(4, false);
#undef FASTSCNN_A8
  return (int)cudaErrorInvalidValue;
}


// ---- B8 on the int8 tensor cores ---------------------------------------------
constexpr int kW8Pad = 16;  // bytes of padding a shared-memory row of k

// d += a (16 x 32, row-major s8) * b (32 x 8, s8, each column's k
// contiguous), s32 sums
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shapes of one B8 block tile: BM x BN outputs, WARPS_M x WARPS_N
// warps, K in chunks of BK bytes through a ring of STAGES stages.
template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES>
struct W8Tile {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N;  // a warp's tile
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;            // its mma tiles
  static constexpr int kRS = BK + kW8Pad;  // a row of k: activations, transposed weights
  static constexpr int kSegs = BN / 16;    // 16-byte segments of a raw weight row
  static constexpr int kABytes = STAGES * BM * kRS;  // activations, [STAGES][BM][kRS]
  static constexpr int kRawBytes = STAGES * BK * BN;  // weights as stored, [STAGES][BK][BN]
  static constexpr int kWTBytes = 2 * BN * kRS;       // transposed weights, [2][BN][kRS]
  static constexpr int kPipeBytes = kABytes + kRawBytes + kWTBytes;
  static constexpr int kOutBytes = BM * (BN + kA8Pad) * 2;  // the bf16 output tile
  static constexpr int kSmem = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
};

// Where byte c of raw weight row kr lies: 16-byte segment c / 16 goes to
// segment (c / 16) ^ ((kr / 4) % SEGS), so that the transpose's reads of
// one word from each of 4-row groups fall in different banks.
template <int BN>
__device__ __forceinline__ int raw_at(int kr, int c) {
  constexpr int kSegs = BN / 16;
  return kr * BN + ((((c >> 4) ^ (kr >> 2)) & (kSegs - 1)) << 4) + (c & 15);
}

// B8: grid (N tiles, M tiles). AVEC: bytes of one activation copy (16, or
// 4 where K % 16 or the pointer forbids 16); WVEC: the weight chunk by
// 16-byte cp.async (N % 16 == 0, aligned), else element by element.
//
// Chunk c's copies are started STAGES - 1 chunks ahead. In iteration c the
// block waits for chunk c + 1, transposes its weights into buffer
// (c + 1) % 2, and runs chunk c's mmas from activation stage c % STAGES
// and transposed buffer c % 2: one __syncthreads an iteration, and every
// copy and transpose overlaps the mmas of an earlier chunk.
template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES, int AVEC, bool WVEC>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
pw_w8a8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ cs, const void* __restrict__ b, int b_bf16,
                   void* __restrict__ out, int M, int K, int N, int relu, int qout, int vec_out) {
  using Tile = W8Tile<BM, BN, WARPS_M, WARPS_N, BK, STAGES>;
  constexpr int kT = Tile::kThreads;
  constexpr int kMI = Tile::kMI, kNI = Tile::kNI, kRS = Tile::kRS;
  static_assert(kMI >= 1 && kNI % 2 == 0 && BK % 32 == 0 && STAGES >= 3 && BN % 64 == 0,
                "B8 tile");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_a = reinterpret_cast<int8_t*>(smem);
  int8_t* s_raw = s_a + Tile::kABytes;
  int8_t* s_wt = s_raw + Tile::kRawBytes;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;

  auto fetch = [&](int c) {  // chunk c's copies into stage c % STAGES
    const int stage = c % STAGES, k0 = c * BK;
    constexpr int kRowSegs = BK / AVEC, kSegs = BM * kRowSegs;
    int8_t* a = s_a + stage * BM * kRS;
    for (int s = tid; s < kSegs; s += kT) {
      const int r = s / kRowSegs, kk = (s % kRowSegs) * AVEC;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;
      cp_async<AVEC>(smem_addr(a + r * kRS + kk), ok ? x + (int64_t)m * K + k : x,
                     ok ? AVEC : 0);
    }
    int8_t* raw = s_raw + stage * BK * BN;
    if constexpr (WVEC) {
      constexpr int kWSegs = BK * Tile::kSegs;
      for (int s = tid; s < kWSegs; s += kT) {
        const int kr = s / Tile::kSegs, c16 = (s % Tile::kSegs) * 16;
        const int k = k0 + kr, n = n0 + c16;
        const bool ok = k < K && n < N;
        cp_async<16>(smem_addr(raw + raw_at<BN>(kr, c16)), ok ? w + (int64_t)k * N + n : w,
                     ok ? 16 : 0);
      }
    } else {
      for (int s = tid; s < BK * BN; s += kT) {
        const int kr = s / BN, cc = s % BN;
        const int k = k0 + kr, n = n0 + cc;
        raw[raw_at<BN>(kr, cc)] = (k < K && n < N) ? w[(int64_t)k * N + n] : int8_t(0);
      }
    }
  };
  // chunk c's raw weights (k rows of n) into transposed buffer c % 2 (n
  // rows of k), a 4 k x 4 n block a thread: word i of the raw block holds
  // the 4 n of k row i, word j of the result the 4 k of column j
  auto transpose = [&](int c) {
    const int8_t* raw = s_raw + (c % STAGES) * BK * BN;
    int8_t* wt = s_wt + (c & 1) * BN * kRS;
    constexpr int kKB = BK / 4, kBlocks = kKB * (BN / 4);
    for (int s = tid; s < kBlocks; s += kT) {
      const int kb = s % kKB, ng = s / kKB;
      unsigned r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const unsigned*>(raw + raw_at<BN>(4 * kb + i, 4 * ng));
      const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
      int8_t* dst = wt + 4 * ng * kRS + 4 * kb;
      *reinterpret_cast<unsigned*>(dst) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<unsigned*>(dst + kRS) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<unsigned*>(dst + 2 * kRS) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<unsigned*>(dst + 3 * kRS) = __byte_perm(t2, t3, 0x7632);
    }
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) fetch(c);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // chunk 0
  __syncthreads();
  transpose(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 3>();  // chunks up to kc + 1
    __syncthreads();
    if (kc + STAGES - 1 < nk) fetch(kc + STAGES - 1);  // into the stage chunk kc - 1 used
    cp_async_commit();
    if (kc + 1 < nk) transpose(kc + 1);
    // A: rows lane % 16, k bytes (lane / 16) * 16 (the four 8 x 16-byte
    // matrices of a 16 x 32 tile, in fragment order). B: columns lane % 8
    // (+ 8 from lane 16), k bytes ((lane / 8) % 2) * 16, so that an x4
    // gives k 0-15 and 16-31 of two n-tiles
    const int8_t* a_s = s_a + (kc % STAGES) * BM * kRS + (wm * Tile::kWM + lane % 16) * kRS +
                        (lane / 16) * 16;
    const int8_t* b_s = s_wt + (kc & 1) * BN * kRS +
                        (wn * Tile::kWN + lane % 8 + (lane / 16) * 8) * kRS +
                        ((lane / 8) % 2) * 16;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) ldsm_x4(af[mi], smem_addr(a_s + mi * 16 * kRS + ks));
      unsigned bf[kNI][2];
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        unsigned r[4];
        ldsm_x4(r, smem_addr(b_s + nj * 16 * kRS + ks));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_s8_16832(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  __syncthreads();  // every warp is done with the ring before the epilogue reuses it

  // the exact int32 sums to f32, times the column's scale (a thread's
  // columns 2 (lane % 4) (+ 1) of each 16 x 8 tile)
  float t[kMI][kNI][4];
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * Tile::kWN + ni * 8 + 2 * (lane % 4) + e;
      const float scale = n < N ? cs[n] : 0.f;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          t[mi][ni][2 * h + e] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), scale);
    }
  epilogue<BM, BN, WARPS_M, WARPS_N>(t, b, b_bf16, out, smem, m0, n0, M, N, relu, qout, vec_out);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES, int AVEC, bool WVEC>
int launch_w8a8_kernel(dim3 grid, const int8_t* x, const int8_t* w, const float* cs,
                       const void* b, int b_bf16, void* out, int m, int k, int n, int relu,
                       int qout, int vec_out, cudaStream_t s) {
  using Tile = W8Tile<BM, BN, WARPS_M, WARPS_N, BK, STAGES>;
  auto* kernel = pw_w8a8_mma_kernel<BM, BN, WARPS_M, WARPS_N, BK, STAGES, AVEC, WVEC>;
  static SmemOptIn opt_in;  // once per instantiation and device
  const cudaError_t e = opt_in.allow(reinterpret_cast<const void*>(kernel), Tile::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Tile::kThreads, Tile::kSmem, s>>>(x, w, cs, b, b_bf16, out, m, k, n, relu, qout,
                                                    vec_out);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES>
int launch_w8a8(const void* x, const void* w, const void* cs, const void* b, int b_bf16,
                void* out, int m, int k, int n, int relu, int qout, int avec, int wvec,
                int vec_out, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* csp = static_cast<const float*>(cs);
#define FASTSCNN_W8(AV, WV)                                                                  \
  return launch_w8a8_kernel<BM, BN, WARPS_M, WARPS_N, BK, STAGES, AV, WV>(                    \
      grid, xp, wp, csp, b, b_bf16, out, m, k, n, relu, qout, vec_out, s)
  if (avec == 16 && wvec) FASTSCNN_W8(16, true);
  if (avec == 16) FASTSCNN_W8(16, false);
  if (avec == 4 && wvec) FASTSCNN_W8(4, true);
  if (avec == 4) FASTSCNN_W8(4, false);
#undef FASTSCNN_W8
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (m, k) int8, k % 4 == 0, 4-byte aligned rows (16-byte when avec is
// 16); w (k, n) int8, 16-byte aligned rows when wvec; cs (n) f32; b (n) f32
// or bf16 (b_dtype); out (m, n) bf16, or int8 when qout. tile: the block
// tile of ops/cuda/int8_pw.py::pw_w8a8_plan, 0 = 128 x 128 (K in 3 stages
// of 64), 1 = 64 x 64 (4 stages of 64), 2 = 32 x 64 (4 stages of 128: this
// tile takes the long-K sites, whose few blocks an SM must keep more bytes
// in flight), 3 = 128 x 64 (4 stages of 32, for the long-M, short-K sites,
// which stream their bytes).
extern "C" int fastscnn_pw_conv_w8a8(const void* x, const void* w, const void* cs, int b_dtype,
                                     const void* b, void* out, int m, int k, int n, int relu,
                                     int qout, int tile, int avec, int wvec, int vec_out,
                                     void* stream) {
  if (k <= 0 || k % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b_bf16 = b_dtype == kBF16;
#define FASTSCNN_TILE(BM, BN, WM, WN, BK, STAGES)                                            \
  return launch_w8a8<BM, BN, WM, WN, BK, STAGES>(x, w, cs, b, b_bf16, out, m, k, n, relu, qout, \
                                                 avec, wvec, vec_out, s)
  switch (tile) {
    case 0: FASTSCNN_TILE(128, 128, 2, 4, 64, 3);
    case 1: FASTSCNN_TILE(64, 64, 2, 2, 64, 4);
    case 2: FASTSCNN_TILE(32, 64, 2, 2, 128, 4);
    case 3: FASTSCNN_TILE(128, 64, 4, 1, 32, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FASTSCNN_TILE
}

// x (m, k) int8 as above, 16-byte aligned rows when avec is 16; w (k, n)
// bf16, 16-byte aligned rows when wvec; b (n) f32 or bf16 (b_dtype); out
// as above. tile: the block tile of ops/cuda/int8_pw.py::pw_a8_plan, 0 =
// 128 x 128 (K in 3 stages of 32), 1 = 64 x 64 (4 stages of 64), 2 = 32 x
// 64 (4 stages of 128: this tile takes the long-K sites, whose few blocks an
// SM must keep more bytes in flight).
extern "C" int fastscnn_pw_conv_a8(const void* x, const void* w, int b_dtype, const void* b,
                                   void* out, int m, int k, int n, int relu, int qout, int tile,
                                   int avec, int wvec, int vec_out, void* stream) {
  if (k <= 0 || k % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b_bf16 = b_dtype == kBF16;
#define FASTSCNN_TILE(BM, BN, WM, WN, BK, STAGES)                                         \
  return launch_a8<BM, BN, WM, WN, BK, STAGES>(x, w, b, b_bf16, out, m, k, n, relu, qout, avec, \
                                               wvec, vec_out, s)
  switch (tile) {
    case 0: FASTSCNN_TILE(128, 128, 2, 4, 32, 3);
    case 1: FASTSCNN_TILE(64, 64, 2, 2, 64, 4);
    case 2: FASTSCNN_TILE(32, 64, 2, 2, 128, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FASTSCNN_TILE
}
