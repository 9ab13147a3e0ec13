// Convolutional GLU MLP with its LayerNorm:
//     [g | v] = LN(x) @ W1^T + b1
//     out     = (GELU(dwconv3x3(g) + dwb) * v) @ W2^T + b2
//
// Replaces the TPU kernel dcae_tpu/ops/pallas/conv_glu.py
// (fused_conv_glu -> pl.pallas_call), which keeps a whole row band and
// the 2h-wide fc1 output in VMEM and writes only the output.
//
// What bounds it on the H100: 6*C*h flops per token (fc1 + fc2) against
// 2-4*C bytes, so it is operation-bound. That kernel's shape, a haloed tile
// walk cut to the 227 KB of a block's shared memory, would recompute the
// gate half of fc1 on every halo (1.5x fc1's flops), stream all of W1 and
// W2 through every block and leave the products in tiles far too small for
// the tensor cores. So both dtypes run the same phases, each shaped for
// the card, with [g | v] in an f32 scratch no larger than the 50 MB L2:
//   LN            LN(x), skipped by f32 callers without LN;
//   fc1           a GEMM on 128 x 128 tiles: [g | v] + b1, f32;
//   gate          GELU(dwconv3x3(g) + dwb) * v, once per element;
//   fc2           a GEMM: out = y W2^T + b2.
// The gate is computed once per element, not per output tile: fused into
// fc2's operand load it would be recomputed for every column tile.
//
// f32 callers (the entropy-side DCA GLU, C=640, h=1280, which must stay
// f32 and bitwise repeatable): on the CUDA cores the bound is the f32 rate,
// 67 TFLOP/s. Kernels conv_glu_ln_kernel, conv_glu_gemm_kernel (fc1 on
// 128 x 128 tiles, fc2 on 64 x 64 tiles: enough tiles for ~2 waves at
// C=640) and conv_glu_gate_kernel (in place on v). The
// products run on the tensor cores in 3xTF32 (mma.sync m16n8k8): each
// operand is split as a = hi + lo, and hi*hi + hi*lo + lo*hi accumulate in
// f32: f32-class accuracy from three products at the TF32 rate (495
// TFLOP/s) instead of one at the f32 FMA rate (67 TFLOP/s), a ceiling 2.5x
// lower. Fragments come by ldmatrix from a 3-stage cp.async ring
// of operand K-slices, each slice read once per tile. The split uses no
// conversion instruction (see split_tf32), and each k-step's three
// products sum in a fresh partial that is added to the accumulator in f32
// (the tensor cores' own accumulation truncates).
//
// bf16 callers (the stage-3 GLUs, C=256, h=512): the bound is the bf16
// tensor-core rate, 989 TFLOP/s, which only wgmma reaches, and wgmma
// wants both operands in shared memory as 8 x 8 core matrices. Kernels
// conv_glu_bf16_*:
//   prepare  writes bf16(LN(x)) (or x) straight into the order fc1 reads: a
//          tile of 128 rows, K step after K step (dcae::tiled), so that
//          any K-slice of a tile is one contiguous 16 KB piece; its last
//          blocks lay [W1; W2] out the same way, once a call (768 KB), and
//          the conv taps as f32, tap after tap;
//   gemm   128 x 128 tiles, two warpgroups on m64n128k16, f32 accumulators
//          in registers; one thread feeds a 3-stage ring of K-slices with
//          one bulk copy (the TMA engine, no tensor map) an operand and
//          slice, completing on an mbarrier, and refills a stage while the
//          next slice multiplies; 96 KB a block, two blocks an SM, so one
//          tile's epilogue overlaps another's products. fc1 writes [g | v]
//          in f32 (g and v are not rounded before the gate); fc2 writes
//          the bf16 result;
//   gate   persistent blocks walk tiles of 8 rows x 16 columns x 64
//          channels: a tile's g and halo come to shared memory by cp.async
//          while the tile before is computed (the sums are bound by
//          instructions, the loads by latency); a thread owns a column and
//          four channels and walks down the rows, reading each row of g
//          once and keeping the three partial row sums in registers; y is
//          rounded to bf16 (fc2's operand) and written in fc2's tiled order.
// The call is walked in bands of rows (the wrapper's plan), fc1 and gate
// back to back on one reused scratch, fc1 covering the band's rows and the
// one row of g above and below that lies in the same image; a band holds
// at most 48 MiB of [g | v], the size of the L2 and the whole of a call at
// the model's shape. (Bands of a quarter of that keep [g | v] in L2 but
// make every launch a partial wave of short blocks, and measured slower.)
// y of all bands (bf16, a quarter of [g | v]) waits in L2 for one fc2 over
// every row, which fills the card better than a band's fc2 would.
//
// Both: zero padding of the conv lives in g-space (an out-of-image
// neighbour contributes g = 0, not fc1(LN(0)) + b1); bf16 callers get bf16
// operands at the two products' inputs and f32 accumulation, LN, conv and
// GELU; f32 callers stay f32. GELU's erf is erff for f32 callers (within
// 2 ulp) and, for bf16 callers, the TPU kernel's own Abramowitz-Stegun
// form (1.5e-7), far below y's rounding to bf16. Every sum runs in a fixed
// order without atomics, so the result is bitwise repeatable from launch
// to launch: the entropy side needs that for encoder/decoder agreement.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::mma_tf32_1688;
using dcae::split_tf32;
using dcae::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// f32 callers (see the header).

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
// bf16 callers: prepare, fc1, gate, fc2 (see the header). Activations and
// weights meet the products in dcae::tiled order, so that every operand
// slice is one bulk copy and needs no conversion in shared memory.
using bf16 = __nv_bfloat16;

constexpr int kTile = dcae::kTileRows;   // GEMM tile: 128 x 128
constexpr int kKC = 64;                  // K columns a ring stage
constexpr int kStages = 3;
constexpr int kStageElems = 2 * kTile * kKC;   // an A slice, then a B slice
constexpr int kBarBytes = 128;                 // the ring's mbarriers
constexpr int kRowPieces = 4;    // 8-channel pieces a lane in LN: C <= 1024
constexpr size_t kWgmmaSmem =
    kBarBytes + sizeof(bf16) * (size_t)kStages * kStageElems;

// Blocks below `row_blocks`: xn = bf16(LN(x)) (or x itself without LN) in
// tiled order, one block a group of 8 rows, one warp a row: lane l takes
// the 8-channel pieces l, l + 32, ... (C % 8 == 0, C <= 1024: the row stays
// in registers), statistics in f32 in a fixed order. The group's pieces
// meet in shared memory (C * 16 bytes) in tiled order, so that they leave
// as whole 128-byte core matrices. The other blocks: the call's weights into the forms the
// phases read: wp = [W1 (2h x C) | W2 (C x h)] in tiled order, and dwp = the
// conv taps and bias in f32, tap after tap: dwp[tap * h + n] = dwk[n, tap],
// dwp[9 h + n] = dwb[n].
__global__ void __launch_bounds__(kThreads)
conv_glu_bf16_prepare_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ ln_w,
                             const bf16* __restrict__ ln_b,
                             const bf16* __restrict__ w1,
                             const bf16* __restrict__ w2,
                             const bf16* __restrict__ dwk,
                             const bf16* __restrict__ dwb,
                             bf16* __restrict__ xn, bf16* __restrict__ wp,
                             float* __restrict__ dwp, int row_blocks, int M,
                             int C, int hidden, int apply_ln) {
  if ((int)blockIdx.x >= row_blocks) {
    const int f = (blockIdx.x - row_blocks) * kThreads + threadIdx.x;
    const int n1 = 2 * hidden * (C / 8), n2 = C * (hidden / 8);
    if (f < n1) {                          // 8-element pieces of W1, of W2
      const int r = f / (C / 8), c8 = f % (C / 8);
      *reinterpret_cast<uint4*>(wp + dcae::tiled(r, 8 * c8, C)) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)r * C + 8 * c8);
    } else if (f < n1 + n2) {
      const int r = (f - n1) / (hidden / 8), c8 = (f - n1) % (hidden / 8);
      *reinterpret_cast<uint4*>(wp + (size_t)2 * hidden * C +
                                dcae::tiled(r, 8 * c8, hidden)) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)r * hidden + 8 * c8);
    }
    if (f < 9 * hidden)
      dwp[f] = to_f<bf16>(dwk[(f % hidden) * 9 + f / hidden]);
    else if (f < 10 * hidden)
      dwp[f] = to_f<bf16>(dwb[f - 9 * hidden]);
    return;
  }
  extern __shared__ float smem[];
  uint4* group = reinterpret_cast<uint4*>(smem);   // [c8][row of the group]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  auto piece = [&](const bf16* p, int c8, float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + 8 * c8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  };
  if (row < M) {
    const bf16* src = x + (size_t)row * C;
    if (!apply_ln) {
      for (int c8 = lane; c8 < C / 8; c8 += 32)
        group[c8 * 8 + warp] = *reinterpret_cast<const uint4*>(src + 8 * c8);
    } else {
      float v[kRowPieces][8], s = 0.f;     // the row, in registers
#pragma unroll
      for (int j = 0; j < kRowPieces; ++j)
        if (lane + 32 * j < C / 8) {
          piece(src, lane + 32 * j, v[j]);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += v[j][i];
        }
      const float mean = dcae::warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < kRowPieces; ++j)
        if (lane + 32 * j < C / 8) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            q += (v[j][i] - mean) * (v[j][i] - mean);
        }
      const float rstd = rsqrtf(dcae::warp_sum(q) / C + 1e-5f);
#pragma unroll
      for (int j = 0; j < kRowPieces; ++j)
        if (lane + 32 * j < C / 8) {
          const int c8 = lane + 32 * j;
          float w[8], b[8];
          piece(ln_w, c8, w);
          piece(ln_b, c8, b);
          uint4 packed;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[i] = __floats2bfloat162_rn(
                (v[j][2 * i] - mean) * rstd * w[2 * i] + b[2 * i],
                (v[j][2 * i + 1] - mean) * rstd * w[2 * i + 1] +
                    b[2 * i + 1]);
          group[c8 * 8 + warp] = packed;
        }
    }
  }
  __syncthreads();
  // rows past M get what the shared memory held: the products never store
  // them
  bf16* dst = xn + dcae::tiled(blockIdx.x * 8, 0, C);
  for (int i = threadIdx.x; i < C; i += kThreads)   // C / 8 pieces x 8 rows
    *reinterpret_cast<uint4*>(dst + (size_t)(i >> 3) * (kTile / 8) * 64 +
                              (i & 7) * 8) = group[i];
}

// out[m - row_base, n] = sum_k A[m, k] Bw[n, k] + bias[n] for the 128 x 128
// tile (tile0 + blockIdx.y, blockIdx.x) and m < row_end. A (rows x K) and
// Bw (N x K) in tiled order, K % 64 == 0. Two warpgroups, 64 rows each, on
// wgmma m64n128k16; thread 0 feeds a ring of kStages K-slices, one bulk copy
// an operand and slice, refilling a stage as soon as both warpgroups are
// done with it while the next slice multiplies. Rows past the operand's end
// multiply what the tile's padding holds and are never stored. kF32Out: f32
// [g | v] rows for the gate; else bf16 rows of the result.
template <bool kF32Out>
__global__ void __launch_bounds__(kThreads, 2)
conv_glu_bf16_gemm_kernel(const bf16* __restrict__ A,
                          const bf16* __restrict__ Bw,
                          const bf16* __restrict__ bias, void* __restrict__ out,
                          int ldc, int tile0, int row_base, int row_end,
                          int K) {
  extern __shared__ float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem) +
                                       kBarBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wg = warp >> 2;
  const int mtile = tile0 + blockIdx.y;
  const bf16* a_src = A + (size_t)mtile * kTile * K;
  const bf16* b_src = Bw + (size_t)blockIdx.x * kTile * K;
  const int nk = K / kKC;
  constexpr uint32_t kSlice = kTile * kKC * sizeof(bf16);

  auto load_slice = [&](int it) {      // K-slice `it` into stage it % kStages
    uint64_t* bar = &full[it % kStages];
    bf16* st = ring + (it % kStages) * kStageElems;
    dcae::mbar_expect(bar, 2 * kSlice);
    dcae::bulk_copy(st, a_src + (size_t)it * kTile * kKC, kSlice, bar);
    dcae::bulk_copy(st + kTile * kKC, b_src + (size_t)it * kTile * kKC,
                    kSlice, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) dcae::mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < kStages && it < nk; ++it) load_slice(it);
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const bf16* st = ring + (it % kStages) * kStageElems;
    dcae::mbar_wait(&full[it % kStages], (it / kStages) & 1);
    // this warpgroup's 64 rows are 8 row groups into the A slice
    const uint64_t da =
        dcae::wgmma_desc_strided(st + wg * 8 * 64, dcae::kTileLbo, 128);
    const uint64_t db =
        dcae::wgmma_desc_strided(st + kTile * kKC, dcae::kTileLbo, 128);
    dcae::wgmma_fence();
    // a k16 step is two K steps of the slice: 4 KB, 256 descriptor units
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
      dcae::wgmma_m64n128k16(acc, da + kk * (2 * dcae::kTileLbo / 16),
                             db + kk * (2 * dcae::kTileLbo / 16));
    dcae::wgmma_commit();
    dcae::wgmma_wait<1>();    // slice it - 1 is multiplied
    if (it >= 1 && it - 1 + kStages < nk) {
      __syncthreads();        // ... by both warpgroups: refill its stage
      if (tid == 0) load_slice(it - 1 + kStages);
    }
  }
  dcae::wgmma_wait<0>();

  const int m = mtile * kTile + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = blockIdx.x * kTile + 8 * j + 2 * q;
    const float b0 = to_f<bf16>(bias[n]), b1 = to_f<bf16>(bias[n + 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int mm = m + 8 * hh;
      if (mm >= row_end) continue;
      const size_t off = (size_t)(mm - row_base) * ldc + n;
      const float o0 = acc[4 * j + 2 * hh] + b0;
      const float o1 = acc[4 * j + 2 * hh + 1] + b1;
      if constexpr (kF32Out)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
            make_float2(o0, o1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
            __floats2bfloat162_rn(o0, o1);
    }
  }
}

constexpr int kGateCols = 16;     // image columns a block
constexpr int kGateQuads = 16;    // 4-channel groups a block: 64 channels
constexpr int kGateRows = 8;      // rows a block
constexpr int kGateHaloCols = kGateCols + 2;
constexpr int kGateTile = (kGateRows + 2) * kGateHaloCols * kGateQuads;
constexpr size_t kGateSmem = 2 * sizeof(float4) * kGateTile;   // two buffers

__device__ __forceinline__ float4 fma4(float4 a, float4 w, float4 s) {
  return make_float4(fmaf(a.x, w.x, s.x), fmaf(a.y, w.y, s.y),
                     fmaf(a.z, w.z, s.z), fmaf(a.w, w.w, s.w));
}

// GELU with the erf of Abramowitz and Stegun 7.1.26 (|error| <= 1.5e-7, the
// TPU kernel's own) on the fast reciprocal and exponential: branch-free, a
// third of erff's instructions (the gate is bound by instructions), and far
// below the bf16 rounding of y that follows.
__device__ __forceinline__ float gelu_as(float v) {
  const float z = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, z, 1.f));
  float poly = fmaf(1.061405429f, t, -1.453152027f);
  poly = fmaf(poly, t, 1.421413741f);
  poly = fmaf(poly, t, -0.284496736f);
  poly = fmaf(poly, t, 0.254829592f);
  const float erf_abs = 1.f - poly * t * __expf(-z * z);
  return 0.5f * v * (1.f + copysignf(erf_abs, v));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// y = bf16(GELU(dwconv3x3(g) + dwb) * v) for the rows [r0, r1) of the
// B * H rows of the call (each W tokens), into tiled order for fc2. gv holds
// [g | v] in f32 of the tokens from `tok_base` on, at least the rows r0 - 1
// .. r1 that lie in the same image as a row of the band. The work is cut
// into tiles of 8 rows x 16 columns x 64 channels, which persistent blocks
// walk: a tile's g with a one-token halo comes to shared memory by cp.async
// (zeros for what lies outside the call or is not needed) while the tile
// before it is computed, since the sums are bound by instructions and the
// loads by latency. A thread owns one column and four channels and walks
// down the rows: each row of g is read once (its own and the two
// neighbouring columns), turned into the three partial sums it gives the
// rows above, at and below it, and row r is finished as ((p0(r-1) + p1(r))
// + p2(r+1)) + dwb. A neighbour in another image gives nothing: zero
// padding in g-space.
__global__ void __launch_bounds__(kThreads, 2)
conv_glu_bf16_gate_kernel(const float* __restrict__ gv,
                          const float* __restrict__ dwp, bf16* __restrict__ y,
                          int tok_base, int r0, int r1, int H, int W,
                          int hidden) {
  extern __shared__ float4 gs[];   // 2 x [halo row][halo column][quad]
  const int chunks = hidden / (4 * kGateQuads);
  const int across = (W + kGateCols - 1) / kGateCols * chunks;
  const int tiles = (r1 - r0 + kGateRows - 1) / kGateRows * across;
  const size_t ld = 2 * (size_t)hidden;
  auto ld4 = [](const float* p) { return *reinterpret_cast<const float4*>(p); };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int cx = threadIdx.x / kGateQuads, quad = threadIdx.x % kGateQuads;

  struct Tile { int s0, s1, c0, ch0; };
  auto tile_at = [&](int t) -> Tile {
    const int s0 = r0 + t / across * kGateRows;
    return {s0, min(s0 + kGateRows, r1), t % across / chunks * kGateCols,
            t % chunks * (4 * kGateQuads)};
  };
  // the tile's g and halo into buffer `buf`. The row above the first is read
  // only inside its image, as the row below the last: the scratch holds no
  // other
  auto fetch = [&](const Tile& t, int buf) {
    const int first = t.s0 % H ? t.s0 - 1 : t.s0;
    const int last = t.s1 % H ? t.s1 + 1 : t.s1;
    for (int i = threadIdx.x; i < kGateTile; i += kThreads) {
      const int u = i / kGateQuads;
      const int r = t.s0 - 1 + u / kGateHaloCols;
      const int c = t.c0 - 1 + u % kGateHaloCols;
      const bool in = r >= first && r < last && c >= 0 && c < W;
      dcae::cp_async16_zfill(
          gs + buf * kGateTile + i,
          gv + (in ? ((size_t)r * W + c - tok_base) * ld + t.ch0 +
                         4 * (i % kGateQuads)
                   : 0),
          in);
    }
    dcae::cp_async_commit();
  };

  if ((int)blockIdx.x < tiles) fetch(tile_at(blockIdx.x), 0);
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    const Tile tl = tile_at(t);
    const int c = tl.c0 + cx, ch = tl.ch0 + 4 * quad;
    const bool mine = c < W;
    const bool more = t + (int)gridDim.x < tiles;
    if (more) fetch(tile_at(t + gridDim.x), (n + 1) & 1);
    float4 w[9], bias = zero, v[kGateRows];
    if (mine) {
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = ld4(dwp + k * hidden + ch);
      bias = ld4(dwp + 9 * hidden + ch);
#pragma unroll
      for (int i = 0; i < kGateRows; ++i)
        if (tl.s0 + i < tl.s1)
          v[i] = ld4(gv + ((size_t)(tl.s0 + i) * W + c - tok_base) * ld +
                     hidden + ch);
    }
    if (more)
      dcae::cp_async_wait<1>();
    else
      dcae::cp_async_wait<0>();
    __syncthreads();                 // this tile's g has landed
    if (mine) {
      const float4* g0 = gs + (n & 1) * kGateTile + cx * kGateQuads + quad;
      float4 a0 = zero, a1 = zero;   // rows rp - 1 and rp, so far
      int rin = (tl.s0 + H - 1) % H;   // row s0 - 1 in its image
#pragma unroll
      for (int i = -1; i <= kGateRows; ++i) {
        const int rp = tl.s0 + i;
        if (rp <= tl.s1) {
          // the row gives p0 to the row below and p2 to the row above
          // unless the image ends between them
          const bool below = rp >= 0 && rin != H - 1;
          const bool above = rp >= 0 && rin != 0;
          const float4* g = g0 + (i + 1) * kGateHaloCols * kGateQuads;
          const float4 gl = g[0], gc = g[kGateQuads], gr = g[2 * kGateQuads];
          const float4 p0 =
              fma4(gr, w[2], fma4(gc, w[1], fma4(gl, w[0], zero)));
          const float4 p1 =
              fma4(gr, w[5], fma4(gc, w[4], fma4(gl, w[3], zero)));
          const float4 p2 =
              fma4(gr, w[8], fma4(gc, w[7], fma4(gl, w[6], zero)));
          if (i >= 1) {
            const float4 s = add4(add4(a0, above ? p2 : zero), bias);
            const float4 vv = v[i >= 1 ? i - 1 : 0];
            uint2 packed;
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
            o[0] = __floats2bfloat162_rn(gelu_as(s.x) * vv.x,
                                         gelu_as(s.y) * vv.y);
            o[1] = __floats2bfloat162_rn(gelu_as(s.z) * vv.z,
                                         gelu_as(s.w) * vv.w);
            *reinterpret_cast<uint2*>(
                y + dcae::tiled((rp - 1) * W + c, ch, hidden)) = packed;
          }
          a0 = add4(a1, p1);
          a1 = below ? p0 : zero;
          rin = rin == H - 1 ? 0 : rin + 1;
        }
      }
    }
    __syncthreads();                 // the buffer may be refilled
  }
}

// One band: the rows [r0, r1) of the call's B * H rows and the rows
// [lo, hi) whose g their conv reads.
struct Band { int r0, r1, lo, hi; };

__host__ inline int tiles_of(long long tokens) {
  return (int)((tokens + kTile - 1) / kTile);
}

// The byte offsets of the bf16 path's scratch: [g | v] of a band's tiles
// (f32), the conv taps (f32), then xn, y (tile-padded rows) and the packed
// weights (bf16).
struct Bf16Scratch {
  size_t gv, dwp, xn, y, wp, end;
  Bf16Scratch(long long M, int C, int hidden, int band_tiles) {
    const size_t rows = (size_t)tiles_of(M) * kTile;
    gv = 0;
    dwp = gv + sizeof(float) * (size_t)band_tiles * kTile * 2 * hidden;
    xn = dwp + sizeof(float) * 10 * (size_t)hidden;
    y = xn + sizeof(bf16) * rows * C;
    wp = y + sizeof(bf16) * rows * hidden;
    end = wp + sizeof(bf16) * 3 * (size_t)hidden * C;
  }
};

// Tiles of fc1 that cover the tokens of rows [lo, hi): at most this many
// for a band of `halo_rows` rows, wherever it starts.
__host__ inline int band_tiles_bound(int halo_rows, int W) {
  return tiles_of((long long)halo_rows * W) + 1;
}

template <bool kF32Out>
cudaError_t launch_bf16_gemm(const bf16* A, const bf16* Bw, const bf16* bias,
                             void* out, int ldc, int tile0, int tiles, int N,
                             int row_base, int row_end, int K,
                             cudaStream_t stream) {
  conv_glu_bf16_gemm_kernel<kF32Out>
      <<<dim3(N / kTile, tiles), kThreads, kWgmmaSmem, stream>>>(
          A, Bw, bias, out, ldc, tile0, row_base, row_end, K);
  return cudaGetLastError();
}

// The current device's SM count, after the bf16 kernels were allowed their
// shared memory there: asked of the runtime once a device, since a call is
// short enough for these host calls to show.
cudaError_t bf16_device(int* sms) {
  constexpr int kMaxDevices = 64;
  static int known[kMaxDevices];           // SM count, 0 = not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known[dev]) {
    *sms = known[dev];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           conv_glu_bf16_gemm_kernel<true>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgmmaSmem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(
           conv_glu_bf16_gemm_kernel<false>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgmmaSmem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(
           conv_glu_bf16_gate_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGateSmem)) !=
          cudaSuccess)
    return err;
  if (dev < kMaxDevices) known[dev] = *sms;
  return cudaSuccess;
}

int launch_bf16(const bf16* x, const bf16* ln_w, const bf16* ln_b,
                const bf16* w1, const bf16* b1, const bf16* dwk,
                const bf16* dwb, const bf16* w2, const bf16* b2, bf16* out,
                char* scratch, const Band* bands, int n_bands, int band_rows,
                int B, int H, int W, int C, int hidden, int apply_ln,
                cudaStream_t stream) {
  const int M = B * H * W;
  const Bf16Scratch at(M, C, hidden, band_tiles_bound(band_rows, W));
  float* gv = reinterpret_cast<float*>(scratch + at.gv);
  float* dwp = reinterpret_cast<float*>(scratch + at.dwp);
  bf16* xn = reinterpret_cast<bf16*>(scratch + at.xn);
  bf16* y = reinterpret_cast<bf16*>(scratch + at.y);
  bf16* wp = reinterpret_cast<bf16*>(scratch + at.wp);
  int sms = 0;
  cudaError_t err = bf16_device(&sms);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (M + 7) / 8;
  const int pieces = max(3 * hidden * (C / 8), 10 * hidden);
  conv_glu_bf16_prepare_kernel<<<row_blocks +
                                     (pieces + kThreads - 1) / kThreads,
                                 kThreads, C * sizeof(uint4), stream>>>(
      x, ln_w, ln_b, w1, w2, dwk, dwb, xn, wp, dwp, row_blocks, M, C, hidden,
      apply_ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int i = 0; i < n_bands; ++i) {
    const Band& bd = bands[i];
    // fc1 on the tiles that hold the band's rows and their halo
    const int tile0 = (int)((long long)bd.lo * W / kTile);
    const int tiles = tiles_of((long long)bd.hi * W) - tile0;
    err = launch_bf16_gemm<true>(xn, wp, b1, gv, 2 * hidden, tile0, tiles,
                                 2 * hidden, tile0 * kTile,
                                 min(M, (tile0 + tiles) * kTile), C, stream);
    if (err != cudaSuccess) return (int)err;
    const int gate_tiles = (W + kGateCols - 1) / kGateCols *
                           (hidden / (4 * kGateQuads)) *
                           ((bd.r1 - bd.r0 + kGateRows - 1) / kGateRows);
    conv_glu_bf16_gate_kernel<<<min(gate_tiles, 2 * sms), kThreads, kGateSmem,
                                stream>>>(gv, dwp, y, tile0 * kTile, bd.r0,
                                          bd.r1, H, W, hidden);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // fc2 once, on every row: y of all bands (bf16) stays in L2
  return (int)launch_bf16_gemm<false>(y, wp + (size_t)2 * hidden * C, b2, out,
                                      C, 0, tiles_of(M), C, 0, M, hidden,
                                      stream);
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

// Shared memory the kernel asks for at width C (bf16: the wgmma ring,
// whatever C; f32: the larger of the two GEMMs).
long long dcae_conv_glu_smem(int C, int bf16) {
  (void)C;
  return (long long)(bf16 ? kWgmmaSmem : gemm_smem_bytes<kFc1BM, kFc1BN>());
}

// Bytes of scratch a call needs. f32: LN(x) and [g | v] of every token.
// bf16: [g | v] of the largest band (`band_rows` rows with their halo),
// the conv taps, xn, y and the packed weights.
long long dcae_conv_glu_scratch(int B, int H, int W, int C, int hidden,
                                int bf16, int band_rows) {
  const long long M = (long long)B * H * W;
  if (!bf16) return (long long)sizeof(float) * M * (C + 2 * (long long)hidden);
  return (long long)Bf16Scratch(M, C, hidden,
                                band_tiles_bound(band_rows, W)).end;
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: w1 (2h, C)
// packed [gate | value], b1 (2h), dwk (h, 1, 3, 3), dwb (h), w2 (C, h),
// b2 (C); ln_w, ln_b (C), read only when apply_ln. All of one dtype: f32
// (bf16 == 0: 3xTF32 GEMM phases, C % 64 == 0, h % 64 == 0; `bands` unused)
// or bf16 (bf16 == 1: wgmma GEMM phases, C % 128 == 0, C <= 1024,
// h % 64 == 0, walked
// over the `n_bands` bands of `bands`, host memory, four ints each: rows
// [r0, r1) of the B * H rows and [lo, hi), the rows whose g they read; the
// bands cover every row once, in order, none with more than `band_rows`
// rows in [lo, hi)). `scratch`: dcae_conv_glu_scratch bytes, 256-byte
// aligned. Returns the CUDA error of the launches.
int dcae_conv_glu(const void* x, const void* ln_w, const void* ln_b,
                  const void* w1, const void* b1, const void* dwk,
                  const void* dwb, const void* w2, const void* b2, void* out,
                  void* scratch, const void* bands, int B, int H, int W,
                  int C, int hidden, int apply_ln, int bf16, int n_bands,
                  int band_rows, void* stream) {
  if (bf16) {
    using H16 = const __nv_bfloat16*;
    return launch_bf16((H16)x, (H16)ln_w, (H16)ln_b, (H16)w1, (H16)b1,
                       (H16)dwk, (H16)dwb, (H16)w2, (H16)b2,
                       (__nv_bfloat16*)out, (char*)scratch,
                       (const Band*)bands, n_bands, band_rows, B, H, W, C,
                       hidden, apply_ln, (cudaStream_t)stream);
  }
  using F = const float*;
  return launch_f32((F)x, (F)ln_w, (F)ln_b, (F)w1, (F)b1, (F)dwk, (F)dwb,
                    (F)w2, (F)b2, (float*)out, (float*)scratch, B, H, W, C,
                    hidden, apply_ln, (cudaStream_t)stream);
}

}  // extern "C"
