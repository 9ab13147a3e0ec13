// Convolutional GLU MLP with its LayerNorm:
//     [g | v] = LN(x) @ W1^T + b1
//     out     = (GELU(dwconv3x3(g) + dwb) * v) @ W2^T + b2
//
// Replaces the TPU kernel dcae_tpu/ops/pallas/conv_glu.py
// (fused_conv_glu -> pl.pallas_call): the 2h-wide fc1 output, the depthwise
// conv and the gate never reach device memory; x is read and the output
// written once.
//
// What bounds it on the H100: 6*C*h flops per token (fc1 + fc2) against
// 2-4*C bytes, so like the TPU kernel it is operation-bound. bf16 callers
// (the stage-3 GLUs) run the products on the tensor cores (mma.sync
// m16n8k16, f32 accumulate: conv_glu_mma_kernel); f32 callers (the
// entropy-side DCA GLU, which must stay f32) run them on the CUDA cores in
// f32 FMA (conv_glu_f32_kernel), bound by the f32 FMA rate.
//
// Design:
//  * The TPU kernel keeps a whole row band (all W columns, all h hidden
//    channels) in 16 MB of VMEM; a block here has 227 KB. So a block owns a
//    2D output tile (TH x 8 tokens) with a one-pixel halo and walks the
//    hidden channels in chunks: for each chunk it computes the gate half
//    of fc1 on the haloed tile (recomputing the halo, which the neighbours
//    also compute), the value half on the tile, the 3x3 depthwise conv,
//    GELU * v, and adds the chunk's fc2 partial into an f32 accumulator of
//    the tile. The LN'd haloed tile stays in shared memory for all chunks.
//    f32: TH 2, chunks of 64, weights staged through shared memory;
//    bf16: TH 4, chunks of 64; both keep the accumulator in registers.
//  * Zero padding of the conv lives in g-space: a halo pixel outside the
//    image contributes g = 0, not fc1(LN(0)) + b1.
//  * GELU is exact (erff, within 2 ulp of erf); the TPU kernel used an
//    Abramowitz-Stegun erf with 1.5e-7 error.
//  * bf16 callers get bf16 operands at the two products' inputs (LN
//    output, gated hidden), f32 accumulation, f32 LN/conv/GELU; f32 callers
//    (the entropy-side DCA GLU) keep f32 throughout.
//  * The chunks run in a fixed order and nothing uses atomics, so the f32
//    result is bitwise repeatable from launch to launch: the entropy side
//    needs that for encoder/decoder agreement.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 8;            // tile width (tokens)

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float fma4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// f32 callers (the entropy-side DCA GLU): CUDA-core FMA, register-tiled.
// The tile is 2 x 8 tokens (40 haloed, 16 central); hidden channels go 64
// at a time. Thread (rg = tid / 16, cq = tid % 16) computes the gate of
// haloed rows rg, rg+16, rg+32 and the value of central row rg, for the
// channels cq + 16 i (i < 4), from weights staged through shared memory
// in coalesced 128 x 32 slices. fc2 streams W2 in 64-column blocks; the
// thread accumulates row rg, columns 64 b + cq + 16 i, in registers.
constexpr int kFTH = 2;                        // tile rows
constexpr int kFNH = (kFTH + 2) * (kTW + 2);   // 40 haloed tokens
constexpr int kFNC = kFTH * kTW;               // 16 central tokens
constexpr int kFChunk = 64;                    // hidden channels per step
constexpr int kFKS = 32;                       // k-slice of W1 staged
constexpr int kFWS = kFKS + 4;                 // staged W1 row stride
constexpr int kFW2S = kFChunk + 4;             // staged W2 row stride
constexpr int kFGS = kFChunk + 1;              // g / v row stride
constexpr int kFYS = kFChunk + 4;              // gated row stride
constexpr int kFMaxCB = 16;                    // 64-column blocks: C <= 1024
constexpr int kFStage = 2 * kFChunk * kFWS > kFChunk * kFW2S
                            ? 2 * kFChunk * kFWS
                            : kFChunk * kFW2S;

__host__ inline size_t f32_smem_bytes(int C) {
  return sizeof(float) * ((size_t)kFNH * (C + 4) + kFStage + kFNH * kFGS +
                          kFNC * kFGS + kFNC * kFYS);
}

__global__ void __launch_bounds__(kThreads)
conv_glu_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ dwk,
                    const float* __restrict__ dwb,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int H, int W, int C, int hidden,
                    int apply_ln) {
  extern __shared__ float smem[];
  const int CS = C + 4;
  float* xn = smem;                  // (40, C+4)  LN(x), haloed tile
  float* ws = xn + kFNH * CS;        // staged W1 slice / W2 block
  float* gs = ws + kFStage;          // (40, 65)   gate chunk, haloed
  float* vs = gs + kFNH * kFGS;      // (16, 65)   value chunk
  float* ys = vs + kFNC * kFGS;      // (16, 68)   gated chunk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = tid >> 4, cq = tid & 15;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kFTH - 1) / kFTH;
  const int b = blockIdx.x / (tiles_h * tiles_w);
  const int r0 = (blockIdx.x / tiles_w) % tiles_h * kFTH;
  const int c0 = blockIdx.x % tiles_w * kTW;

  // haloed token u = hr * (kTW + 2) + hc sits at (r0 - 1 + hr, c0 - 1 + hc)
  auto halo_in_image = [&](int u) {
    const int r = r0 - 1 + u / (kTW + 2), c = c0 - 1 + u % (kTW + 2);
    return r >= 0 && r < H && c >= 0 && c < W;
  };
  // central token t = tr * kTW + tc is haloed token (tr + 1, tc + 1)
  auto center = [&](int t) { return (t / kTW + 1) * (kTW + 2) + t % kTW + 1; };

  // ---- LayerNorm of the haloed tile, one warp per token
  for (int u = warp; u < kFNH; u += kWarps) {
    if (halo_in_image(u)) {
      const int r = r0 - 1 + u / (kTW + 2), c = c0 - 1 + u % (kTW + 2);
      dcae::warp_layernorm_row<float>(x + (((size_t)b * H + r) * W + c) * C,
                                      ln_w, ln_b, xn + u * CS, C,
                                      apply_ln != 0, lane);
    } else {
      for (int k = lane; k < C; k += 32) xn[u * CS + k] = 0.f;
    }
  }
  float acc[kFMaxCB][4];
#pragma unroll
  for (int cb = 0; cb < kFMaxCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[cb][i] = 0.f;
  const int n_cb = C / 64;
  // this thread's haloed rows (the third exists for rg < 8; the others
  // compute on the last row and store nothing) and its central row
  const int hrow[3] = {rg, rg + 16, min(rg + 32, kFNH - 1)};
  const int vrow = center(rg);
  __syncthreads();

  for (int k0 = 0; k0 < hidden; k0 += kFChunk) {
    // ---- fc1 of this chunk: gate on the haloed rows, value on the tile
    float ag[3][4], av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 3; ++r) ag[r][i] = 0.f;
    }
    for (int kk = 0; kk < C; kk += kFKS) {
      // W1 rows [gate k0..k0+63 | value h+k0..h+k0+63], columns kk..kk+31
      for (int f = tid; f < 2 * kFChunk * (kFKS / 4); f += kThreads) {
        const int row = f / (kFKS / 4), c4 = f % (kFKS / 4);
        const int src = row < kFChunk ? k0 + row : hidden + k0 + row - kFChunk;
        *reinterpret_cast<float4*>(ws + row * kFWS + 4 * c4) =
            *reinterpret_cast<const float4*>(w1 + (size_t)src * C + kk +
                                             4 * c4);
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < kFKS; k += 4) {
        float4 xg[3], wg[4], wv[4];
#pragma unroll
        for (int r = 0; r < 3; ++r) xg[r] = lds4(xn + hrow[r] * CS + kk + k);
        const float4 xv = lds4(xn + vrow * CS + kk + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wg[i] = lds4(ws + (cq + 16 * i) * kFWS + k);
          wv[i] = lds4(ws + (kFChunk + cq + 16 * i) * kFWS + k);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int r = 0; r < 3; ++r) ag[r][i] = fma4(xg[r], wg[i], ag[r][i]);
          av[i] = fma4(xv, wv[i], av[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = cq + 16 * i;
      const float bg = b1[k0 + ch], bv = b1[hidden + k0 + ch];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int u = rg + 16 * r;
        if (u < kFNH) gs[u * kFGS + ch] = halo_in_image(u) ? ag[r][i] + bg : 0.f;
      }
      vs[rg * kFGS + ch] = av[i] + bv;
    }
    __syncthreads();

    // ---- depthwise 3x3 (cross-correlation) + GELU gate
    for (int e = tid; e < kFNC * kFChunk; e += kThreads) {
      const int t = e / kFChunk, j = e % kFChunk, n = k0 + j;
      const int tr = t / kTW, tc = t % kTW;
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          s = fmaf(gs[((tr + dy) * (kTW + 2) + tc + dx) * kFGS + j],
                   dwk[n * 9 + dy * 3 + dx], s);
      s += dwb[n];
      ys[t * kFYS + j] = gelu(s) * vs[t * kFGS + j];
    }
    __syncthreads();

    // ---- fc2 partial, W2 streamed in 64-column blocks
#pragma unroll
    for (int cb = 0; cb < kFMaxCB; ++cb) {
      if (cb >= n_cb) break;
      for (int f = tid; f < 64 * (kFChunk / 4); f += kThreads) {
        const int row = f / (kFChunk / 4), c4 = f % (kFChunk / 4);
        *reinterpret_cast<float4*>(ws + row * kFW2S + 4 * c4) =
            *reinterpret_cast<const float4*>(
                w2 + (size_t)(64 * cb + row) * hidden + k0 + 4 * c4);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kFChunk; k += 4) {
        const float4 yv = lds4(ys + rg * kFYS + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[cb][i] = fma4(yv, lds4(ws + (cq + 16 * i) * kFW2S + k),
                            acc[cb][i]);
      }
      __syncthreads();
    }
  }

  // ---- out = acc + b2 for the tile's tokens inside the image
  const int r = r0 + rg / kTW, c = c0 + rg % kTW;
  if (r < H && c < W) {
    float* orow = out + (((size_t)b * H + r) * W + c) * C;
#pragma unroll
    for (int cb = 0; cb < kFMaxCB; ++cb) {
      if (cb >= n_cb) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 64 * cb + cq + 16 * i;
        orow[col] = acc[cb][i] + b2[col];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 callers: the same tile walk with the three products on the tensor
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

int launch_f32(const void* x, const void* ln_w, const void* ln_b,
               const void* w1, const void* b1, const void* dwk,
               const void* dwb, const void* w2, const void* b2, void* out,
               int B, int H, int W, int C, int hidden, int apply_ln,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv_glu_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * ((H + kFTH - 1) / kFTH) * ((W + kTW - 1) / kTW);
  conv_glu_f32_kernel<<<tiles, kThreads, smem, stream>>>(
      (const float*)x, (const float*)ln_w, (const float*)ln_b,
      (const float*)w1, (const float*)b1, (const float*)dwk,
      (const float*)dwb, (const float*)w2, (const float*)b2, (float*)out, H,
      W, C, hidden, apply_ln);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at width C (bf16: tensor-core kernel;
// f32: CUDA-core kernel).
long long dcae_conv_glu_smem(int C, int bf16) {
  return (long long)(bf16 ? mma_smem_bytes(C) : f32_smem_bytes(C));
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: w1 (2h, C)
// packed [gate | value], b1 (2h), dwk (h, 1, 3, 3), dwb (h), w2 (C, h),
// b2 (C); ln_w, ln_b (C), read only when apply_ln. All of one dtype: f32
// (bf16 == 0: CUDA-core kernel, C % 64 == 0, C <= 1024, h % 64 == 0) or
// bf16 (bf16 == 1: tensor-core kernel, C % 16 == 0, C <= 512,
// h % 64 == 0). Returns the CUDA error of the launch.
int dcae_conv_glu(const void* x, const void* ln_w, const void* ln_b,
                  const void* w1, const void* b1, const void* dwk,
                  const void* dwb, const void* w2, const void* b2, void* out,
                  int B, int H, int W, int C, int hidden, int apply_ln,
                  int bf16, void* stream) {
  if (bf16)
    return launch_mma(x, ln_w, ln_b, w1, b1, dwk, dwb, w2, b2, out, B, H, W,
                      C, hidden, apply_ln, (cudaStream_t)stream);
  return launch_f32(x, ln_w, ln_b, w1, b1, dwk, dwb, w2, b2, out, B, H, W, C,
                    hidden, apply_ln, (cudaStream_t)stream);
}

}  // extern "C"
