// Swin attention on 8x8 windows (W, or shifted SW windows), two entries
// over one device code:
//     dcae_wmsa_block:      out = rs * x + proj(WMSA(LN(x)))   (kBlock)
//     dcae_wmsa_attention:  out = proj(WMSA(x))               (!kBlock)
//
// Replaces the TPU kernels dcae_tpu/ops/pallas/wmsa_v4.py
// (fused_wmsa_block_v4 -> pl.pallas_call: LN, window extraction, packed
// qkv, relative-position bias, shifted-window masks, softmax, proj and the
// res-scale residual in one pass over x) and dcae_tpu/ops/pallas/wmsa_v3.py
// (fused_wmsa_v3 -> pl.pallas_call: the same window attention on an input
// that is already LayerNormed, with no residual). The two differ only in
// the first step (LN or a copy) and the last (with or without rs * x), so
// both kernels are templates on kBlock.
//
// What bounds it on the H100: the work is matmul-heavy (qkv and proj are
// 8*C^2 flops per token, the attention 4*64*C), ~10x more operations than
// bytes at bf16, so it is operation-bound. bf16 callers (g_a, g_s) run
// every product on the tensor cores (mma.sync m16n8k16, f32 accumulate:
// wmsa_mma_kernel); f32 callers run them on the CUDA cores in f32 FMA
// (wmsa_fma_kernel), bound by the f32 FMA rate.
//
// Design:
//  * One CUDA block per window (64 tokens). Blocks are independent, so no
//    state carries between them (the TPU grid walked row blocks in order;
//    v3's sublane head packing and tile_w windows a step are TPU devices
//    that do not carry over).
//  * The shift is done in the addressing: the window reads and writes
//    token (r, c) of the rolled frame at ((r+4) mod H, (c+4) mod W), so no
//    rolled copy of x is ever made. The residual commutes with the roll.
//  * The mask comes from the window's position: a bottom-row window splits
//    its rows at s = 4, a right-column window its columns (wmsa_v3.py
//    _mask_bank); the bias is table[h, dy+7, dx+7]. Masked scores are
//    -inf where v3 adds -1e30: the same softmax, since no row of an 8x8
//    window shifted by 4 is masked whole.
//  * Shared memory holds the (LN'd) window and the attention output for
//    all heads plus one head's q, k, v and scores at a time: in f32 175 KB
//    at C = 256, in bf16 ~109 KB (two blocks an SM), above the 48 KB
//    default, so the launch raises the dynamic shared-memory limit.
//  * bf16 callers get bf16 operands at every product input (LN output or
//    x, q/k/v, probabilities, attention output), f32 accumulation, f32 LN
//    and softmax, bf16 output: the TPU kernels' rounding points. f32
//    callers keep f32. head_dim 8 (g_a stage 1, g_s stage 3) is half an
//    mma k-step: the upper half of the q k^T step is fed zeros.
//  * Every sum runs in a fixed order, without atomics: deterministic.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::load4;
using dcae::to_f;

constexpr int kWin = 8;
constexpr int kP = kWin * kWin;   // tokens per window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // tokens per thread in the products
constexpr int kGroups = kP / kRows;  // thread t takes tokens g, g+8, ...
constexpr int kSP = kP + 1;       // score row stride (bank-conflict free)

__host__ __device__ inline int row_stride(int C) { return C + 4; }

__host__ inline size_t smem_bytes(int C, int hd) {
  return sizeof(float) *
         (2 * (size_t)kP * row_stride(C) + 3 * (size_t)kP * (hd + 1) +
          (size_t)kP * kSP);
}

template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
wmsa_fma_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const float* __restrict__ rs,
                const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                const float* __restrict__ wproj, const float* __restrict__ bproj,
                const float* __restrict__ rel, float* __restrict__ out, int H,
                int W, int C, int heads, int shifted) {
  extern __shared__ float smem[];
  const int CS = row_stride(C);
  const int hd = C / heads;
  const int HS = hd + 1;
  float* xn = smem;                 // (64, CS)  LN(x) (or x) of the window
  float* ob = xn + kP * CS;         // (64, CS)  attention output, all heads
  float* qs = ob + kP * CS;         // (64, HS)  one head's q
  float* ks = qs + kP * HS;         // (64, HS)
  float* vs = ks + kP * HS;         // (64, HS)
  float* S = vs + kP * HS;          // (64, 65)  scores / probabilities

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nh = H / kWin, nw = W / kWin;
  const int win = blockIdx.x;
  const int b = win / (nh * nw);
  const int wr = (win / nw) % nh;
  const int wc = win % nw;
  const int shift = shifted ? kWin / 2 : 0;
  const bool bottom = shifted && wr == nh - 1;
  const bool right = shifted && wc == nw - 1;

  // global element offset of window token t (rolled frame -> source)
  auto token_offset = [&](int t) -> size_t {
    const int r = (wr * kWin + t / kWin + shift) % H;
    const int c = (wc * kWin + t % kWin + shift) % W;
    return (((size_t)b * H + r) * W + c) * C;
  };

  // ---- LayerNorm (or a copy), one warp per token
  for (int t = warp; t < kP; t += kWarps)
    dcae::warp_layernorm_row<float>(x + token_offset(t), ln_w, ln_b, xn + t * CS,
                                C, kBlock, lane);
  __syncthreads();

  const float scale = rsqrtf((float)hd);
  for (int h = 0; h < heads; ++h) {
    // ---- q, k, v of head h: (64 tokens) x (3 hd columns), 8 tokens a
    // thread, the weight row read once per 8 tokens
    const int ncol = 3 * hd;
    for (int item = tid; item < ncol * kGroups; item += kThreads) {
      const int j = item % ncol;
      const int tg = item / ncol;             // tokens tg, tg+8, ...
      const int n = (j / hd) * C + h * hd + j % hd;   // row of wqkv
      const float* wrow = wqkv + (size_t)n * C;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int c = 0; c < C; c += 4) {
        float w4[4];
        load4(wrow + c, w4);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xn + (tg + r * kGroups) * CS + c);
          acc[r] = fmaf(xv.x, w4[0], acc[r]);
          acc[r] = fmaf(xv.y, w4[1], acc[r]);
          acc[r] = fmaf(xv.z, w4[2], acc[r]);
          acc[r] = fmaf(xv.w, w4[3], acc[r]);
        }
      }
      const float bias = bqkv[n];
      float* dst = (j < hd ? qs : (j < 2 * hd ? ks : vs)) + j % hd;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dst[(tg + r * kGroups) * HS] = acc[r] + bias;
    }
    __syncthreads();

    // ---- scores + relative-position bias + shifted-window mask
    const float* relh = rel + (size_t)h * (2 * kWin - 1) * (2 * kWin - 1);
    for (int e = tid; e < kP * kP; e += kThreads) {
      const int i = e / kP, jt = e % kP;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[i * HS + d], ks[jt * HS + d], s);
      const int ri = i / kWin, ci = i % kWin, rj = jt / kWin, cj = jt % kWin;
      s = s * scale +
          relh[(ri - rj + kWin - 1) * (2 * kWin - 1) + ci - cj +
                       kWin - 1];
      const int half = kWin - kWin / 2;
      if ((bottom && ((ri < half) != (rj < half))) ||
          (right && ((ci < half) != (cj < half))))
        s = -INFINITY;
      S[i * kSP + jt] = s;
    }
    __syncthreads();

    // ---- softmax over each row (f32), one warp per row
    for (int i = warp; i < kP; i += kWarps) {
      float* row = S + i * kSP;
      const float a = row[lane], c = row[lane + 32];
      const float m = dcae::warp_max(fmaxf(a, c));
      const float ea = expf(a - m), ec = expf(c - m);
      const float inv = 1.f / dcae::warp_sum(ea + ec);
      row[lane] = ea * inv;
      row[lane + 32] = ec * inv;
    }
    __syncthreads();

    // ---- o = probs @ v into head h's channels
    for (int e = tid; e < kP * hd; e += kThreads) {
      const int i = e / hd, d = e % hd;
      float o = 0.f;
      for (int jt = 0; jt < kP; ++jt) o = fmaf(S[i * kSP + jt], vs[jt * HS + d], o);
      ob[i * CS + h * hd + d] = o;
    }
    __syncthreads();
  }

  // ---- proj (+ residual): out = [rs * x +] (o @ Wp^T + bp)
  for (int item = tid; item < C * kGroups; item += kThreads) {
    const int n = item % C;
    const int tg = item / C;
    const float* wrow = wproj + (size_t)n * C;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float w4[4];
      load4(wrow + c, w4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 ov =
            *reinterpret_cast<const float4*>(ob + (tg + r * kGroups) * CS + c);
        acc[r] = fmaf(ov.x, w4[0], acc[r]);
        acc[r] = fmaf(ov.y, w4[1], acc[r]);
        acc[r] = fmaf(ov.z, w4[2], acc[r]);
        acc[r] = fmaf(ov.w, w4[3], acc[r]);
      }
    }
    const float bias = bproj[n];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t off = token_offset(tg + r * kGroups) + n;
      if constexpr (kBlock)
        out[off] = x[off] * rs[n] + (acc[r] + bias);
      else
        out[off] = acc[r] + bias;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 callers: the same window walk with every product on the tensor
// cores (mma.sync m16n8k16, f32 accumulate). A window is 4 m-tiles of 16
// tokens; the 8 warps share the output tiles of each product.
constexpr int kMPS = kP + 8;      // probability row stride (bf16)

__host__ __device__ inline int head_stride(int hd) { return hd + 8; }

__host__ inline size_t mma_smem_bytes(int C, int hd) {
  return sizeof(__nv_bfloat16) *
             (2 * (size_t)kP * (C + 8) + 3 * (size_t)kP * head_stride(hd) +
              (size_t)kP * kMPS) +
         sizeof(float) * (size_t)kP * kSP;
}

template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
wmsa_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ ln_w,
                const __nv_bfloat16* __restrict__ ln_b,
                const __nv_bfloat16* __restrict__ rs,
                const __nv_bfloat16* __restrict__ wqkv,
                const __nv_bfloat16* __restrict__ bqkv,
                const __nv_bfloat16* __restrict__ wproj,
                const __nv_bfloat16* __restrict__ bproj,
                const __nv_bfloat16* __restrict__ rel,
                __nv_bfloat16* __restrict__ out, int H, int W, int C,
                int heads, int shifted) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float smem[];
  const int hd = C / heads;
  const int XS = C + 8, HS = head_stride(hd);
  float* S = smem;                               // (64, 65) scores
  bf16* xs = reinterpret_cast<bf16*>(S + kP * kSP);          // (64, C+8)
  bf16* ob = xs + kP * XS;                       // (64, C+8) attention out
  bf16* qs = ob + kP * XS;                       // (64, hd+8) one head
  bf16* ks = qs + kP * HS;
  bf16* vs = ks + kP * HS;
  bf16* ps = vs + kP * HS;                       // (64, 72) probabilities

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int nh = H / kWin, nw = W / kWin;
  const int win = blockIdx.x;
  const int b = win / (nh * nw);
  const int wr = (win / nw) % nh;
  const int wc = win % nw;
  const int shift = shifted ? kWin / 2 : 0;
  const bool bottom = shifted && wr == nh - 1;
  const bool right = shifted && wc == nw - 1;
  auto token_offset = [&](int t) -> size_t {
    const int r = (wr * kWin + t / kWin + shift) % H;
    const int c = (wc * kWin + t % kWin + shift) % W;
    return (((size_t)b * H + r) * W + c) * C;
  };

  // ---- LayerNorm into bf16 rows (or a copy of x), one warp per token
  for (int t = warp; t < kP; t += kWarps) {
    const bf16* src = x + token_offset(t);
    if constexpr (kBlock) {
      // LN scratch rows (8 warps x C f32) borrow ob, unused until the
      // first head's output lands
      float* tmp = reinterpret_cast<float*>(ob) + warp * C;
      dcae::warp_layernorm_row<bf16>(src, ln_w, ln_b, tmp, C, true, lane);
      __syncwarp();
      for (int k = lane; k < C; k += 32)
        xs[t * XS + k] = __float2bfloat16(tmp[k]);
      __syncwarp();
    } else {
      for (int k = lane; k < C; k += 32) xs[t * XS + k] = src[k];
    }
  }
  __syncthreads();

  const float scale = rsqrtf((float)hd);
  const int hd_tiles = hd / 8;
  for (int h = 0; h < heads; ++h) {
    // ---- q, k, v of head h: (64 x 3 hd) tiles of 16 x 8 over K = C
    for (int tile = warp; tile < 4 * 3 * hd_tiles; tile += kWarps) {
      const int m = tile % 4, nt = tile / 4;          // n-tile of [q|k|v]
      const int which = nt / hd_tiles, d0 = (nt % hd_tiles) * 8;
      const bf16* wrow = wqkv + (size_t)(which * C + h * hd + d0 + g) * C;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < C; k += 16) {
        uint32_t a[4], bw[2];
        dcae::load_a(a, xs + (m * 16 + g) * XS, xs + (m * 16 + g + 8) * XS,
                     k, q);
        dcae::load_b(bw, wrow, k, q);
        dcae::mma_bf16_16816(d, a, bw);
      }
      bf16* dst = which == 0 ? qs : (which == 1 ? ks : vs);
      const int col = d0 + 2 * q;
      const int n = which * C + h * hd + col;
      const float b0 = to_f<bf16>(bqkv[n]), b1 = to_f<bf16>(bqkv[n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (m * 16 + g) * HS + col) =
          __floats2bfloat162_rn(d[0] + b0, d[1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(dst + (m * 16 + g + 8) * HS + col) =
          __floats2bfloat162_rn(d[2] + b0, d[3] + b1);
    }
    __syncthreads();

    // ---- scores q k^T (K = hd; hd 8 pads the upper half of the k-step
    // with zeros) + relative-position bias + shifted-window mask
    const bf16* relh = rel + (size_t)h * (2 * kWin - 1) * (2 * kWin - 1);
    for (int tile = warp; tile < 4 * 8; tile += kWarps) {
      const int m = tile % 4, nt = tile / 4;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < hd; k += 16) {
        uint32_t a[4], bw[2];
        const bf16* lo = qs + (m * 16 + g) * HS;
        const bf16* hi = qs + (m * 16 + g + 8) * HS;
        const bf16* krow = ks + (nt * 8 + g) * HS;
        a[0] = dcae::ld_pair(lo + k + 2 * q);
        a[1] = dcae::ld_pair(hi + k + 2 * q);
        bw[0] = dcae::ld_pair(krow + k + 2 * q);
        const bool full = k + 16 <= hd;
        a[2] = full ? dcae::ld_pair(lo + k + 2 * q + 8) : 0u;
        a[3] = full ? dcae::ld_pair(hi + k + 2 * q + 8) : 0u;
        bw[1] = full ? dcae::ld_pair(krow + k + 2 * q + 8) : 0u;
        dcae::mma_bf16_16816(d, a, bw);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m * 16 + g + 8 * (e >> 1);
        const int jt = nt * 8 + 2 * q + (e & 1);
        const int ri = i / kWin, ci = i % kWin, rj = jt / kWin,
                  cj = jt % kWin;
        float s = d[e] * scale +
                  to_f<bf16>(relh[(ri - rj + kWin - 1) * (2 * kWin - 1) +
                                  ci - cj + kWin - 1]);
        const int half = kWin - kWin / 2;
        if ((bottom && ((ri < half) != (rj < half))) ||
            (right && ((ci < half) != (cj < half))))
          s = -INFINITY;
        S[i * kSP + jt] = s;
      }
    }
    __syncthreads();

    // ---- softmax over each row (f32), probabilities to bf16
    for (int i = warp; i < kP; i += kWarps) {
      const float* row = S + i * kSP;
      const float a = row[lane], c = row[lane + 32];
      const float mx = dcae::warp_max(fmaxf(a, c));
      const float ea = expf(a - mx), ec = expf(c - mx);
      const float inv = 1.f / dcae::warp_sum(ea + ec);
      ps[i * kMPS + lane] = __float2bfloat16(ea * inv);
      ps[i * kMPS + lane + 32] = __float2bfloat16(ec * inv);
    }
    __syncthreads();

    // ---- o = p v (K = 64 keys) into head h's channels of ob
    for (int tile = warp; tile < 4 * hd_tiles; tile += kWarps) {
      const int m = tile % 4, nt = tile / 4;
      const int n = nt * 8 + g;                        // v column
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kP; k += 16) {
        uint32_t a[4], bw[2];
        dcae::load_a(a, ps + (m * 16 + g) * kMPS, ps + (m * 16 + g + 8) * kMPS,
                     k, q);
        // B(k = key, n = d) from v's rows: pairs along the key axis
        const bf16* v0 = vs + (k + 2 * q) * HS + n;
        __nv_bfloat162 p0, p1;
        p0.x = v0[0];
        p0.y = v0[HS];
        p1.x = v0[8 * HS];
        p1.y = v0[9 * HS];
        bw[0] = *reinterpret_cast<uint32_t*>(&p0);
        bw[1] = *reinterpret_cast<uint32_t*>(&p1);
        dcae::mma_bf16_16816(d, a, bw);
      }
      const int col = h * hd + nt * 8 + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(ob + (m * 16 + g) * XS + col) =
          __floats2bfloat162_rn(d[0], d[1]);
      *reinterpret_cast<__nv_bfloat162*>(ob + (m * 16 + g + 8) * XS + col) =
          __floats2bfloat162_rn(d[2], d[3]);
    }
    __syncthreads();
  }

  // ---- proj (+ residual): out = [rs * x +] (o Wp^T + bp), 16 x 8 tiles
  for (int tile = warp; tile < 4 * (C / 8); tile += kWarps) {
    const int m = tile % 4, nt = tile / 4;
    const bf16* wrow = wproj + (size_t)(nt * 8 + g) * C;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < C; k += 16) {
      uint32_t a[4], bw[2];
      dcae::load_a(a, ob + (m * 16 + g) * XS, ob + (m * 16 + g + 8) * XS, k,
                   q);
      dcae::load_b(bw, wrow, k, q);
      dcae::mma_bf16_16816(d, a, bw);
    }
    const int n = nt * 8 + 2 * q;
    const float b0 = to_f<bf16>(bproj[n]), b1 = to_f<bf16>(bproj[n + 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t off = token_offset(m * 16 + g + 8 * hh) + n;
      float o0 = d[2 * hh] + b0, o1 = d[2 * hh + 1] + b1;
      if constexpr (kBlock) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off));
        o0 += xv.x * to_f<bf16>(rs[n]);
        o1 += xv.y * to_f<bf16>(rs[n + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

// Launch one window per block; ln_w, ln_b and rs are read only when
// kBlock.
template <bool kBlock>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* rs,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* rel, void* out, int B, int H, int W,
           int C, int heads, int shifted, int bf16, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int hd = C / heads;
  const size_t smem = bf16 ? mma_smem_bytes(C, hd) : smem_bytes(C, hd);
  const int windows = B * (H / kWin) * (W / kWin);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(wmsa_mma_kernel<kBlock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    wmsa_mma_kernel<kBlock><<<windows, kThreads, smem, stream>>>(
        (const bf*)x, (const bf*)ln_w, (const bf*)ln_b, (const bf*)rs,
        (const bf*)wqkv, (const bf*)bqkv, (const bf*)wproj, (const bf*)bproj,
        (const bf*)rel, (bf*)out, H, W, C, heads, shifted);
  } else {
    err = cudaFuncSetAttribute(wmsa_fma_kernel<kBlock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    wmsa_fma_kernel<kBlock><<<windows, kThreads, smem, stream>>>(
        (const float*)x, (const float*)ln_w, (const float*)ln_b,
        (const float*)rs, (const float*)wqkv, (const float*)bqkv,
        (const float*)wproj, (const float*)bproj, (const float*)rel,
        (float*)out, H, W, C, heads, shifted);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at these widths (the wrapper checks it
// against the card's limit before launching).
long long dcae_wmsa_block_smem(int C, int heads, int bf16) {
  return (long long)(bf16 ? mma_smem_bytes(C, C / heads)
                          : smem_bytes(C, C / heads));
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: wqkv (3C, C),
// bqkv (3C), wproj (C, C), bproj (C), rel (heads, 15, 15); ln_w, ln_b, rs
// (C). All of one dtype: f32 (bf16 == 0: CUDA-core kernel, C % 4 == 0) or
// bf16 (bf16 == 1: tensor-core kernel, C % 16 == 0, head_dim % 8 == 0).
// Both entries return the CUDA error of the launch (0 on success).
int dcae_wmsa_block(const void* x, const void* ln_w, const void* ln_b,
                    const void* rs, const void* wqkv, const void* bqkv,
                    const void* wproj, const void* bproj, const void* rel,
                    void* out, int B, int H, int W, int C, int heads,
                    int shifted, int bf16, void* stream) {
  return launch<true>(x, ln_w, ln_b, rs, wqkv, bqkv, wproj, bproj, rel, out,
                      B, H, W, C, heads, shifted, bf16, (cudaStream_t)stream);
}

// The same without LN and residual: out = proj(WMSA(x)) on an x that is
// already LayerNormed (the widths and dtypes of dcae_wmsa_block).
int dcae_wmsa_attention(const void* x, const void* wqkv, const void* bqkv,
                        const void* wproj, const void* bproj, const void* rel,
                        void* out, int B, int H, int W, int C, int heads,
                        int shifted, int bf16, void* stream) {
  return launch<false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, wproj,
                       bproj, rel, out, B, H, W, C, heads, shifted, bf16,
                       (cudaStream_t)stream);
}

}  // extern "C"
