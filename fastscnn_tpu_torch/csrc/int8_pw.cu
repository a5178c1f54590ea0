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
// B8 runs on the CUDA cores: one block of 256 threads per 64 x 64 output
// tile, K in chunks of 64 staged in shared memory, a 4 x 4 register tile of
// int32 sums a thread, __dp4a (four int8 MACs an instruction). Its int32
// sums are exact (|sum| <= 127 * 127 * K < 2^24 for K <= 768, so the
// int32 -> f32 conversion is exact too); then __fmul_rn(acc, cs) and
// __fadd_rn(., b), as the plain version, so the two agree bit for bit.
//
// B7 runs on the tensor cores, as the TPU kernel's bf16 jnp.dot runs on the
// MXU: mma.sync m16n8k16, bf16 operands, f32 sums. On the CUDA cores (one
// f32 FMA per MAC) a frame's 5.6 G MACs alone took longer than a bf16 GEMM
// of the library; on the tensor cores they are ~0.011 ms against ~0.04 ms
// of bytes. The design:
// - A block computes a BM x BN output tile with 4 or 8 warps, each warp a
//   (BM / WARPS_M) x (BN / WARPS_N) tile of 16 x 8 mma tiles whose f32
//   sums stay in registers. Three tiles are built, 128 x 128 (8 warps),
//   64 x 64 and 32 x 64 (4 warps); ops/cuda/int8_pw.py::pw_a8_plan picks one
//   from (M, K, N) so that every site's grid fills the card.
// - K goes through a ring of 3 or 4 shared-memory stages (32, 64 or 128 k
//   a stage), its copies started that many chunks ahead: the int8 activation
//   chunk and the weight chunk (K x N, row-major bf16) both by cp.async,
//   16 bytes a thread, zero-filled past M, K and N. The long-K sites
//   (K up to 768 at M = 2,048) have one block or two an SM, whose loop
//   would otherwise wait a memory latency per chunk.
// - Each chunk's activations are widened to bf16 (exact, by integer and
//   f32 add tricks rather than conversion instructions) once, into a
//   second shared-memory buffer, one chunk ahead of the mmas that read it.
// - Fragments come from ldmatrix (A) and ldmatrix.trans (the row-major
//   weight), from rows padded by 16 bytes so that the 8 rows an ldmatrix
//   reads fall in distinct banks.
// - The epilogue (f32 acc + b, [ReLU], bf16 or clip(rint(.), +-127) int8)
//   goes through a shared-memory tile so that the outputs leave in 16-byte
//   vectors where N allows it. The bias is read in its stored dtype.
// - No split-K and no atomics: the bits are a function of the shape and
//   the inputs alone.
// Each product of an int8 value and a bf16 value is exact in f32, so only
// the order of the sums (the hardware's) differs from the plain version's
// in-order sum; ops/cuda/int8_pw.py::pw_conv_a8_tolerance states the bound.
//
// A ragged last M or N tile is masked, and k past K is zeros (the TPU
// kernels' M % 32 fallback to XLA becomes this mask).
#include "common.cuh"

namespace fastscnn {
namespace {

constexpr int kThreads = 256;  // B8: 16 x 16 threads, each a 4 x 4 tile of outputs
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;

// Store the 4 x 4 epilogue values of one thread: t = acc + b, [ReLU], then
// bf16 or clip(round(t), -127, 127) int8 (rintf rounds half to even, as
// jnp.round and torch.round).
__device__ __forceinline__ void store_epilogue(void* out, float t, int64_t idx, int relu,
                                               int qout) {
  if (relu) t = fmaxf(t, 0.f);
  if (qout) {
    static_cast<int8_t*>(out)[idx] = (int8_t)fminf(fmaxf(rintf(t), -127.f), 127.f);
  } else {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(t);
  }
}

// B8: int8 x int8 -> int32 with __dp4a. xs holds the activation chunk as
// packed int32 (4 consecutive k of a row), ws the weight chunk packed the
// same way along k for each output column.
__global__ void __launch_bounds__(kThreads)
pw_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ cs, const float* __restrict__ b, void* __restrict__ out,
               int M, int K, int N, int relu, int qout) {
  constexpr int kK4 = kBK / 4;
  __shared__ __align__(16) int xs[kBM][kK4 + 4];  // +4 keeps rows 16-byte aligned, staggers banks
  __shared__ __align__(16) int ws[kK4][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kK4; i += kThreads) {
      const int r = i / kK4, k4 = i % kK4;
      const int m = m0 + r, k = k0 + 4 * k4;
      xs[r][k4] = (m < M && k < K) ? *reinterpret_cast<const int*>(x + (int64_t)m * K + k) : 0;
    }
    for (int i = threadIdx.x; i < kK4 * kBN; i += kThreads) {
      const int k4 = i / kBN, c = i % kBN;
      const int n = n0 + c, k = k0 + 4 * k4;
      int v = 0;
      if (n < N && k < K) {
        const int8_t* p = w + (int64_t)k * N + n;
        v = (int)((uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[N] << 8) |
                  ((uint32_t)(uint8_t)p[2 * N] << 16) | ((uint32_t)(uint8_t)p[3 * N] << 24));
      }
      ws[k4][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < kK4; k4 += 4) {
      int4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const int4*>(&xs[ty * 4 + i][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 bq = *reinterpret_cast<const int4*>(&ws[k4 + q][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = __dp4a(av, bq.x, acc[i][0]);
          acc[i][1] = __dp4a(av, bq.y, acc[i][1]);
          acc[i][2] = __dp4a(av, bq.z, acc[i][2]);
          acc[i][3] = __dp4a(av, bq.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        store_epilogue(out, __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), cs[n]), b[n]),
                       (int64_t)m * N + n, relu, qout);
    }
  }
}

// ---- B7 on the tensor cores ----------------------------------------------
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

  // epilogue: a thread's sums sit at rows lane / 4 (+ 8) and columns
  // 2 (lane % 4) (+ 1) of each 16 x 8 tile
  float bias[kNI][2];
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * Tile::kWN + ni * 8 + 2 * (lane % 4) + e;
      bias[ni][e] = n >= N ? 0.f
                           : b_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(b)[n])
                                    : static_cast<const float*>(b)[n];
    }
  const int r0 = wm * Tile::kWM + lane / 4, c0 = wn * Tile::kWN + 2 * (lane % 4);
  if (qout) {
    constexpr int kOS = BN + 16;  // int8 row: 16 bytes of padding
    int8_t* so = reinterpret_cast<int8_t*>(smem);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t0 = __fadd_rn(acc[mi][ni][2 * h], bias[ni][0]);
          float t1 = __fadd_rn(acc[mi][ni][2 * h + 1], bias[ni][1]);
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
          float t0 = __fadd_rn(acc[mi][ni][2 * h], bias[ni][0]);
          float t1 = __fadd_rn(acc[mi][ni][2 * h + 1], bias[ni][1]);
          if (relu) t0 = fmaxf(t0, 0.f), t1 = fmaxf(t1, 0.f);
          *reinterpret_cast<unsigned*>(so + (r0 + mi * 16 + 8 * h) * kOS + c0 + ni * 8) =
              bf16x2_bits(t0, t1);
        }
    __syncthreads();
    write_tile<__nv_bfloat16, BM, BN>(so, kOS, static_cast<__nv_bfloat16*>(out), m0, n0, M, N,
                                      vec_out, tid, kT);
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, int STAGES, int AVEC, bool WVEC>
int launch_a8_kernel(dim3 grid, const int8_t* x, const __nv_bfloat16* w, const void* b,
                     int b_bf16, void* out, int m, int k, int n, int relu, int qout, int vec_out,
                     cudaStream_t s) {
  using Tile = A8Tile<BM, BN, WARPS_M, WARPS_N, BK, STAGES>;
  auto* kernel = pw_a8_mma_kernel<BM, BN, WARPS_M, WARPS_N, BK, STAGES, AVEC, WVEC>;
  static bool attribute_set = false;  // once per instantiation and process
  if (Tile::kSmem > 48 * 1024 && !attribute_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
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

dim3 grid_for(int m, int n) { return dim3((n + kBN - 1) / kBN, (m + kBM - 1) / kBM); }

}  // namespace
}  // namespace fastscnn

using namespace fastscnn;

// x (m, k) int8, k % 4 == 0 and 4-byte aligned rows; w (k, n) int8; cs, b
// (n) f32; out (m, n) bf16, or int8 when qout.
extern "C" int fastscnn_pw_conv_w8a8(const void* x, const void* w, const void* cs, const void* b,
                                     void* out, int m, int k, int n, int relu, int qout,
                                     void* stream) {
  if (k % 4 != 0 || (m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  pw_w8a8_kernel<<<grid_for(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(cs),
      static_cast<const float*>(b), out, m, k, n, relu, qout);
  return (int)cudaGetLastError();
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
