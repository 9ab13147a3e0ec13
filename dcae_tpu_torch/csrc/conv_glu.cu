// Convolutional GLU MLP with its LayerNorm:
//     [g | v] = LN(x) @ W1^T + b1
//     out     = (GELU(dwconv3x3(g) + dwb) * v) @ W2^T + b2
//
// Replaces the TPU kernel dcae_tpu/ops/pallas/conv_glu.py
// (fused_conv_glu -> pl.pallas_call), which keeps a whole row band and
// the 2h-wide fc1 output in VMEM and writes only the output.
//
// What bounds it on the H100: 6*C*h flops per token (fc1 + fc2) against
// 2-4*C bytes, so it is operation-bound. Two designs, by dtype:
//
// f32 callers (the entropy-side DCA GLU, C=640, h=1280, which must stay
// f32 and bitwise repeatable): on the CUDA cores the bound is the f32 rate,
// 67 TFLOP/s. The TPU kernel's shape, a haloed tile walk cut to 227 KB of
// shared memory, would recompute the gate half of fc1 on every halo (1.5x
// the flops), fill 1.45 waves at one block an SM and stream all of W1 and
// W2 through every block. So the f32 path is four phases, each shaped for
// the card, with g and v in a scratch of 2 x tokens x h f32 that stays
// mostly in the 50 MB L2:
//   conv_glu_ln_kernel     LN(x) into scratch (skipped without LN);
//   conv_glu_gemm_kernel   fc1 as a GEMM on 128 x 128 tiles: g | v + b1;
//   conv_glu_gate_kernel   v <- GELU(dwconv3x3(g) + dwb) * v, in place;
//   conv_glu_gemm_kernel   fc2 as a GEMM on 64 x 64 tiles (enough tiles
//                          for ~2 waves at C=640): out = y W2^T + b2.
// The products run on the tensor cores in 3xTF32 (mma.sync m16n8k8): each
// operand is split as a = hi + lo, and hi*hi + hi*lo + lo*hi accumulate in
// f32: f32-class accuracy from three products at the TF32 rate (495
// TFLOP/s) instead of one at the f32 FMA rate (67 TFLOP/s), a ceiling 2.5x
// lower. Fragments come by ldmatrix from a 3-stage cp.async ring
// of operand K-slices, each slice read once per tile. The split uses no
// conversion instruction (see split_tf32), and each k-step's three
// products sum in a fresh partial that is added to the accumulator in f32
// (the tensor cores' own accumulation truncates). The gate is computed
// once per element, not per output tile: fused into fc2's operand load it
// would be recomputed for every one of the C/64 column tiles.
//
// bf16 callers (the stage-3 GLUs): conv_glu_mma_kernel, a haloed tile
// walk on mma.sync m16n8k16. A block owns 4 x 8 output tokens with a
// one-pixel halo, walks the hidden width in chunks of 64 (gate on the
// haloed tile, value on the tile, 3x3 conv, GELU * v, fc2 partial into a
// register accumulator), and keeps the LN'd haloed tile in shared memory.
//
// Both: zero padding of the conv lives in g-space (an out-of-image
// neighbour contributes g = 0, not fc1(LN(0)) + b1); GELU is exact (erff,
// within 2 ulp; the TPU kernel used an Abramowitz-Stegun erf with 1.5e-7
// error); bf16 callers get bf16 operands at the two products' inputs and
// f32 accumulation, LN, conv and GELU; f32 callers stay f32. Every sum runs
// in a fixed order without atomics, so the result is bitwise repeatable
// from launch to launch: the entropy side needs that for encoder/decoder
// agreement.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 8;            // bf16 tile width (tokens)

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// f32 callers: LN, fc1, gate, fc2 as separate phases (see the header).

__global__ void __launch_bounds__(kThreads)
conv_glu_ln_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, float* __restrict__ xn,
                   int M, int C) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row < M)
    dcae::warp_layernorm_row<float>(x + (size_t)row * C, ln_w, ln_b,
                                    xn + (size_t)row * C, C, true,
                                    threadIdx.x & 31);
}

// v = hi + lo: hi = v with its low 13 mantissa bits cleared (a tf32
// value); lo = v - hi exactly, which the tensor core reads as tf32 by
// dropping its own low 13 bits (an error of at most 2^-20 |v|, the size of
// the lo * lo term the split leaves out). No conversion instruction:
// conversions run at a fraction of the FMA rate.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// D(16x8, f32) += A(16x8, tf32) B(8x8, tf32). Fragments (lane = 4 g + q):
// A {a0..a3} = (g, q), (g+8, q), (g, q+4), (g+8, q+4); B {b0, b1} =
// (k q, col g), (k q+4, col g); D as for m16n8k16.
__device__ __forceinline__ void mma_tf32_1688(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kGK = 32;           // K-slice of a stage
constexpr int kGKS = kGK + 4;     // staged row stride: conflict-free frags
constexpr int kGStages = 3;

template <int BM, int BN>
constexpr size_t gemm_smem_bytes() {
  return sizeof(float) * (size_t)kGStages * (BM + BN) * kGKS;
}

// Cout[m, n] = sum_k A[m, k] B[n, k] + bias[n] for m < M, in 3xTF32.
// A: M rows of stride lda; B: N x K row-major (torch weight layout);
// needs N % BN == 0, K % 32 == 0, lda and K multiples of 4. 8 warps as
// 2 (M) x 4 (N); grid (N / BN, ceil(M / BM)).
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_glu_gemm_kernel(const float* __restrict__ A, int lda,
                     const float* __restrict__ B,
                     const float* __restrict__ bias, float* __restrict__ Cout,
                     int ldc, int M, int K) {
  constexpr int MT = BM / 32, NT = BN / 32;    // 16x8 tiles a warp
  extern __shared__ float smem[];
  float* As = smem;                                // [stage][BM][kGKS]
  float* Bs = smem + kGStages * BM * kGKS;         // [stage][BN][kGKS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 1) * (BM / 2), wn = (warp >> 1) * (BN / 4);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * kGK;
    for (int f = tid; f < BM * (kGK / 4); f += kThreads) {
      const int r = f / (kGK / 4), c4 = f % (kGK / 4);
      const int m = min(m0 + r, M - 1);        // rows past M: never stored
      dcae::cp_async16(As + (stage * BM + r) * kGKS + 4 * c4,
                       A + (size_t)m * lda + k0 + 4 * c4);
    }
    for (int f = tid; f < BN * (kGK / 4); f += kThreads) {
      const int r = f / (kGK / 4), c4 = f % (kGK / 4);
      dcae::cp_async16(Bs + (stage * BN + r) * kGKS + 4 * c4,
                       B + (size_t)(n0 + r) * K + k0 + 4 * c4);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = K / kGK;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    dcae::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    dcae::cp_async_wait<kGStages - 2>();
    __syncthreads();    // slice kt landed; slice kt-1's stage is free
    if (kt + kGStages - 1 < ktiles)
      load(kt + kGStages - 1, (kt + kGStages - 1) % kGStages);
    dcae::cp_async_commit();
    const float* as = As + (kt % kGStages) * BM * kGKS;
    const float* bs = Bs + (kt % kGStages) * BN * kGKS;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 8) {
      // fragments by ldmatrix, f32 as 4-byte elements: A matrices (rows
      // 0-7, k..k+3), (rows 8-15, k..), (rows 0-7, k+4..), (rows 8-15,
      // k+4..); B two n-tiles at once, (n 0-7, k..), (n 0-7, k+4..),
      // (n 8-15, k..), (n 8-15, k+4..)
      uint32_t ar[MT][4], br[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        dcae::ldmatrix_x4(ar[i], as + (wm + 16 * i + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * kGKS +
                                     kk + (lane >> 4) * 4);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t t[4];
        dcae::ldmatrix_x4(t, bs + (wn + 8 * j + (lane & 7) +
                                   (lane >> 4) * 8) * kGKS +
                                 kk + ((lane >> 3) & 1) * 4);
        br[j][0] = t[0];
        br[j][1] = t[1];
        br[j + 1][0] = t[2];
        br[j + 1][1] = t[3];
      }
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(ar[i][e]), ah[i][e], al[i][e]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_tf32(__uint_as_float(br[j][e]), bh[j][e], bl[j][e]);
      // each k-step's three products (small terms first) sum in a fresh
      // partial, added to the accumulator in f32: the tensor cores' own
      // accumulation is not round-to-nearest, and its error would grow with
      // K if the accumulator ran through every step
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32_1688(part, al[i], bh[j]);
          mma_tf32_1688(part, ah[i], bl[j]);
          mma_tf32_1688(part, ah[i], bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
    }
  }
  dcae::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + 8 * j + 2 * q;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m < M)
          *reinterpret_cast<float2*>(Cout + (size_t)m * ldc + n) =
              make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
  }
}

// gv: (M, 2h) rows [g | v] of the tokens of (B, H, W); v <- GELU(dwconv3x3
// (g) + dwb) * v, one thread per (token, hidden channel). In place: v of a
// token is read and written only by its own thread, and g is never written.
__global__ void __launch_bounds__(kThreads)
conv_glu_gate_kernel(float* __restrict__ gv, const float* __restrict__ dwk,
                     const float* __restrict__ dwb, int M, int H, int W,
                     int hidden) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)M * hidden) return;
  const int t = (int)(e / hidden), n = (int)(e % hidden);
  const int r = (t / W) % H, c = t % W;
  const size_t ld = 2 * (size_t)hidden;
  float s = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int rr = r + dy - 1, cc = c + dx - 1;
      const float gn = rr >= 0 && rr < H && cc >= 0 && cc < W
                           ? gv[(size_t)(t + (dy - 1) * W + dx - 1) * ld + n]
                           : 0.f;
      s = fmaf(gn, dwk[n * 9 + dy * 3 + dx], s);
    }
  s += dwb[n];
  float* v = gv + (size_t)t * ld + hidden + n;
  *v = gelu(s) * *v;
}

constexpr int kFc1BM = 128, kFc1BN = 128, kFc2BM = 64, kFc2BN = 64;

// ---------------------------------------------------------------------------
// bf16 callers: a haloed tile walk with the three products on the tensor
// cores (mma.sync m16n8k16, f32 accumulate). The tile is fixed at 4 x 8
// tokens: 60 haloed rows (padded to 4 m-tiles) and 32 central rows (2
// m-tiles); hidden channels go 64 at a time (8 n-tiles, one per warp), and
// the fc2 accumulator of the tile (32 x C f32) lives in registers, warp w
// holding the n-tiles w, w+8, ... of both m-tiles.
constexpr int kMTH = 4;                        // tile rows
constexpr int kMNH = (kMTH + 2) * (kTW + 2);   // 60 haloed tokens
constexpr int kMRows = 64;                     // haloed rows padded to 16s
constexpr int kMNC = kMTH * kTW;               // 32 central tokens
constexpr int kMChunk = 64;                    // hidden channels per step
constexpr int kMGS = kMChunk + 1;              // g / v row stride (f32)
constexpr int kMYS = kMChunk + 8;              // gated row stride (bf16)
constexpr int kMMaxNT = 8;                     // fc2 n-tiles a warp: C <= 512

__host__ __device__ inline int mma_row_stride(int C) { return C + 8; }

__host__ inline size_t mma_smem_bytes(int C) {
  return sizeof(__nv_bfloat16) * ((size_t)kMRows * mma_row_stride(C) +
                                  (size_t)kMNC * kMYS) +
         sizeof(float) * ((size_t)kMRows * kMGS + (size_t)kMNC * kMGS +
                          (size_t)kWarps * C);
}

__global__ void __launch_bounds__(kThreads)
conv_glu_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ ln_w,
                    const __nv_bfloat16* __restrict__ ln_b,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ dwk,
                    const __nv_bfloat16* __restrict__ dwb,
                    const __nv_bfloat16* __restrict__ w2,
                    const __nv_bfloat16* __restrict__ b2,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C,
                    int hidden, int apply_ln) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float smem[];
  const int XS = mma_row_stride(C);
  float* gs = smem;                          // (64, 65) gate chunk, haloed
  float* vs = gs + kMRows * kMGS;            // (32, 65) value chunk
  float* scratch = vs + kMNC * kMGS;         // (8, C) LN rows, per warp
  bf16* xs = reinterpret_cast<bf16*>(scratch + kWarps * C);  // (64, C+8)
  bf16* ys = xs + kMRows * XS;               // (32, 72) gated chunk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;     // mma fragment coordinates
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kMTH - 1) / kMTH;
  const int b = blockIdx.x / (tiles_h * tiles_w);
  const int r0 = (blockIdx.x / tiles_w) % tiles_h * kMTH;
  const int c0 = blockIdx.x % tiles_w * kTW;

  auto halo_in_image = [&](int u) {
    const int r = r0 - 1 + u / (kTW + 2), c = c0 - 1 + u % (kTW + 2);
    return u < kMNH && r >= 0 && r < H && c >= 0 && c < W;
  };
  auto center = [&](int t) { return (t / kTW + 1) * (kTW + 2) + t % kTW + 1; };

  // ---- LayerNorm of the haloed tile into bf16 rows (zeros off-image)
  for (int u = warp; u < kMRows; u += kWarps) {
    bf16* row = xs + u * XS;
    if (halo_in_image(u)) {
      const int r = r0 - 1 + u / (kTW + 2), c = c0 - 1 + u % (kTW + 2);
      float* tmp = scratch + warp * C;
      dcae::warp_layernorm_row<bf16>(x + (((size_t)b * H + r) * W + c) * C,
                                     ln_w, ln_b, tmp, C, apply_ln != 0, lane);
      __syncwarp();
      for (int k = lane; k < C; k += 32) row[k] = __float2bfloat16(tmp[k]);
      __syncwarp();
    } else {
      for (int k = lane; k < C; k += 32) row[k] = __float2bfloat16(0.f);
    }
  }

  float acc[2][kMMaxNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < kMMaxNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
  const int n_tiles = C / 8;
  __syncthreads();

  for (int k0 = 0; k0 < hidden; k0 += kMChunk) {
    // ---- fc1 for this chunk: warp w takes hidden channels k0+8w..+8 of
    // the gate (4 m-tiles of haloed rows) and of the value (2 m-tiles of
    // central rows)
    {
      float cg[4][4], cv[2][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) cg[m][e] = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) cv[m][e] = 0.f;
      const int nc = k0 + 8 * warp;                       // first channel
      const bf16* wg = w1 + (size_t)(nc + g) * C;
      const bf16* wv = w1 + (size_t)(hidden + nc + g) * C;
      const bf16* vrow_lo[2];
      const bf16* vrow_hi[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        vrow_lo[m] = xs + center(m * 16 + g) * XS;
        vrow_hi[m] = xs + center(m * 16 + g + 8) * XS;
      }
      for (int k = 0; k < C; k += 16) {
        uint32_t bg[2], bv[2], a[4];
        dcae::load_b(bg, wg, k, q);
        dcae::load_b(bv, wv, k, q);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dcae::load_a(a, xs + (m * 16 + g) * XS, xs + (m * 16 + g + 8) * XS,
                       k, q);
          dcae::mma_bf16_16816(cg[m], a, bg);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          dcae::load_a(a, vrow_lo[m], vrow_hi[m], k, q);
          dcae::mma_bf16_16816(cv[m], a, bv);
        }
      }
      const int col = 8 * warp + 2 * q;                   // within chunk
      const float bg0 = to_f<bf16>(b1[k0 + col]);
      const float bg1 = to_f<bf16>(b1[k0 + col + 1]);
      const float bv0 = to_f<bf16>(b1[hidden + k0 + col]);
      const float bv1 = to_f<bf16>(b1[hidden + k0 + col + 1]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = m * 16 + g + 8 * h;
          const bool in = halo_in_image(u);
          gs[u * kMGS + col] = in ? cg[m][2 * h] + bg0 : 0.f;
          gs[u * kMGS + col + 1] = in ? cg[m][2 * h + 1] + bg1 : 0.f;
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = m * 16 + g + 8 * h;
          vs[t * kMGS + col] = cv[m][2 * h] + bv0;
          vs[t * kMGS + col + 1] = cv[m][2 * h + 1] + bv1;
        }
    }
    __syncthreads();

    // ---- depthwise 3x3 + GELU gate, rounded to bf16 for fc2
    for (int e = tid; e < kMNC * kMChunk; e += kThreads) {
      const int t = e / kMChunk, j = e % kMChunk, n = k0 + j;
      const int tr = t / kTW, tc = t % kTW;
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          s = fmaf(gs[((tr + dy) * (kTW + 2) + tc + dx) * kMGS + j],
                   to_f<bf16>(dwk[n * 9 + dy * 3 + dx]), s);
      s += to_f<bf16>(dwb[n]);
      ys[t * kMYS + j] = __float2bfloat16(gelu(s) * vs[t * kMGS + j]);
    }
    __syncthreads();

    // ---- fc2 partial: acc += ys (32 x 64) . W2[:, k0:k0+64]^T
#pragma unroll
    for (int kk = 0; kk < kMChunk; kk += 16) {
      uint32_t a0[4], a1[4];
      dcae::load_a(a0, ys + g * kMYS, ys + (g + 8) * kMYS, kk, q);
      dcae::load_a(a1, ys + (16 + g) * kMYS, ys + (24 + g) * kMYS, kk, q);
#pragma unroll
      for (int i = 0; i < kMMaxNT; ++i) {
        const int nt = warp + kWarps * i;
        if (nt < n_tiles) {
          uint32_t bw[2];
          dcae::load_b(bw, w2 + (size_t)(nt * 8 + g) * hidden + k0, kk, q);
          dcae::mma_bf16_16816(acc[0][i], a0, bw);
          dcae::mma_bf16_16816(acc[1][i], a1, bw);
        }
      }
    }
    __syncthreads();
  }

  // ---- out = acc + b2 for the tile's tokens inside the image
#pragma unroll
  for (int i = 0; i < kMMaxNT; ++i) {
    const int nt = warp + kWarps * i;
    if (nt >= n_tiles) continue;
    const int n = nt * 8 + 2 * q;
    const float bo0 = to_f<bf16>(b2[n]), bo1 = to_f<bf16>(b2[n + 1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m * 16 + g + 8 * h;
        const int r = r0 + t / kTW, c = c0 + t % kTW;
        if (r < H && c < W)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (((size_t)b * H + r) * W + c) * C + n) =
              __floats2bfloat162_rn(acc[m][i][2 * h] + bo0,
                                    acc[m][i][2 * h + 1] + bo1);
      }
  }
}

int launch_mma(const void* x, const void* ln_w, const void* ln_b,
               const void* w1, const void* b1, const void* dwk,
               const void* dwb, const void* w2, const void* b2, void* out,
               int B, int H, int W, int C, int hidden, int apply_ln,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = mma_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv_glu_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * ((H + kMTH - 1) / kMTH) * ((W + kTW - 1) / kTW);
  conv_glu_mma_kernel<<<tiles, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)ln_w, (const bf16*)ln_b, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)dwk, (const bf16*)dwb, (const bf16*)w2,
      (const bf16*)b2, (bf16*)out, H, W, C, hidden, apply_ln);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_gemm(const float* A, int lda, const float* Bw,
                        const float* bias, float* Cout, int ldc, int M, int N,
                        int K, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      conv_glu_gemm_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  conv_glu_gemm_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(
      A, lda, Bw, bias, Cout, ldc, M, K);
  return cudaGetLastError();
}

int launch_f32(const float* x, const float* ln_w, const float* ln_b,
               const float* w1, const float* b1, const float* dwk,
               const float* dwb, const float* w2, const float* b2,
               float* out, float* scratch, int B, int H, int W, int C,
               int hidden, int apply_ln, cudaStream_t stream) {
  const int M = B * H * W;
  float* xn = scratch;                         // (M, C)  LN(x)
  float* gv = scratch + (size_t)M * C;         // (M, 2h) [g | v], then [g | y]
  cudaError_t err;
  if (apply_ln) {
    conv_glu_ln_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        x, ln_w, ln_b, xn, M, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = launch_gemm<kFc1BM, kFc1BN>(apply_ln ? xn : x, C, w1, b1, gv,
                                    2 * hidden, M, 2 * hidden, C, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)M * hidden;
  conv_glu_gate_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(gv, dwk, dwb, M, H, W, hidden);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_gemm<kFc2BM, kFc2BN>(gv + hidden, 2 * hidden, w2, b2,
                                          out, C, M, C, hidden, stream);
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at width C (bf16: tensor-core tile
// kernel; f32: the larger of the two GEMMs).
long long dcae_conv_glu_smem(int C, int bf16) {
  return (long long)(bf16 ? mma_smem_bytes(C)
                          : gemm_smem_bytes<kFc1BM, kFc1BN>());
}

// f32 scratch the kernel needs, in floats (bf16 needs none): LN(x) and
// [g | v] of every token.
long long dcae_conv_glu_scratch(int B, int H, int W, int C, int hidden,
                                int bf16) {
  return bf16 ? 0 : (long long)B * H * W * (C + 2 * (long long)hidden);
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: w1 (2h, C)
// packed [gate | value], b1 (2h), dwk (h, 1, 3, 3), dwb (h), w2 (C, h),
// b2 (C); ln_w, ln_b (C), read only when apply_ln. All of one dtype: f32
// (bf16 == 0: 3xTF32 GEMM phases, C % 64 == 0, h % 64 == 0, `scratch` of
// dcae_conv_glu_scratch floats) or bf16 (bf16 == 1: tensor-core tile
// kernel, C % 16 == 0, C <= 512, h % 64 == 0, `scratch` unused). Returns
// the CUDA error of the launches.
int dcae_conv_glu(const void* x, const void* ln_w, const void* ln_b,
                  const void* w1, const void* b1, const void* dwk,
                  const void* dwb, const void* w2, const void* b2, void* out,
                  void* scratch, int B, int H, int W, int C, int hidden,
                  int apply_ln, int bf16, void* stream) {
  if (bf16)
    return launch_mma(x, ln_w, ln_b, w1, b1, dwk, dwb, w2, b2, out, B, H, W,
                      C, hidden, apply_ln, (cudaStream_t)stream);
  using F = const float*;
  return launch_f32((F)x, (F)ln_w, (F)ln_b, (F)w1, (F)b1, (F)dwk, (F)dwb,
                    (F)w2, (F)b2, (float*)out, (float*)scratch, B, H, W, C,
                    hidden, apply_ln, (cudaStream_t)stream);
}

}  // extern "C"
