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
// What bounds it on the H100: qkv and proj are 8*C^2 flops a token, the
// attention 4*64*C, against 4*C bytes of x and out at bf16: operation-
// bound at stages 2 and 3, byte-bound at stage 1 (C = 96). In practice a
// window is one 64-row product, too small to fill an SM on its own, and
// every window needs all of the weights (74 KB at C = 96, 512 KB at
// C = 256), so what bounds a per-window design is how fast an SM can take
// in weights and how few instructions a window costs.
//
// bf16 callers (g_a, g_s) run wmsa_mma_kernel:
//  * Persistent blocks (as many as fit on the card) walk the windows. The
//    weights, packed once per call by wmsa_pack_kernel into the operand
//    layout below, stream as 64-row chunks of [Wqkv; Wproj] through a
//    two-stage ring in shared memory: one bulk copy (the TMA engine, no
//    tensor map) a chunk, completing on an mbarrier, issued while the
//    previous chunk multiplies and running on from one window into the
//    next. The next window's x rows arrive the same way during proj. (A
//    ring fed by 16-byte cp.async copies from every thread was slower at
//    every stage: one bulk copy a chunk costs one thread one instruction.)
//  * qkv and proj run on wgmma: a window is exactly one warpgroup's M = 64,
//    and each of the two warpgroups takes 32 rows of a chunk
//    (m64n32k16, both operands K-major in shared memory, without swizzle,
//    as 8 x 8 core matrices). qkv for all heads lands in shared memory
//    (64 x 3C bf16).
//  * The attention core stays on mma.sync m16n8k16 from shared memory: a
//    warp takes one (head, 16 queries) item at a time, with no barrier
//    between heads; scores (K = head_dim; head_dim 8 is half a k-step, fed
//    zeros above), bias, mask and softmax in registers (f32, a row spread
//    over a quad of lanes), and P V with the probabilities as the A operand
//    straight from the score registers and V by ldmatrix.trans. The bias
//    index is a per-thread base plus constants and the masks reduce to
//    per-item and per-thread flags. The relative-position tables and the
//    small vectors stay in shared memory for the block's life.
//  * LN takes four rows a warp at a time and channel pairs a lane. Two
//    barriers a window besides one a chunk.
// f32 callers run wmsa_fma_kernel (off the main path), one block per
// window on the CUDA cores, one head's q, k, v and scores in shared memory
// at a time.
//
// Both:
//  * The shift is done in the addressing: the window reads and writes
//    token (r, c) of the rolled frame at ((r+4) mod H, (c+4) mod W), so no
//    rolled copy of x is ever made. The residual commutes with the roll.
//  * The mask comes from the window's position: a bottom-row window splits
//    its rows at s = 4, a right-column window its columns (wmsa_v3.py
//    _mask_bank); the bias is table[h, dy+7, dx+7]. Masked scores are
//    -inf where v3 adds -1e30: the same softmax, since no row of an 8x8
//    window shifted by 4 is masked whole.
//  * bf16 callers get bf16 operands at every product input (LN output or
//    x, q/k/v, probabilities, attention output), f32 accumulation, f32 LN
//    and softmax, bf16 output: the TPU kernels' rounding points. f32
//    callers keep f32.
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
// bf16 callers: persistent blocks, weights streamed through a ring of bulk
// copies, qkv and proj on wgmma, heads as independent warp items (see the
// header).
constexpr int kChunk = 64;                         // weight rows a stage
constexpr int kRel = (2 * kWin - 1) * (2 * kWin - 1);   // bias table a head
constexpr int kMaxC = 256;                         // LN row: 8 a lane
constexpr int kMaxHdTiles = 4;                     // head_dim <= 32

__host__ __device__ inline int align8(int n) { return (n + 7) / 8 * 8; }

// three mbarriers (32 bytes); rel tables; ln_w, ln_b, rs, bqkv, bproj;
// the window (64 x C, blocked for wgmma); qkv (64, 3C+8) row-major, which
// also stages the next window's x as (64, C+8); two ring stages (64 x C,
// blocked). The row strides of C+8 bf16 keep the attention's fragment
// loads free of bank conflicts for C % 16 == 0.
__host__ inline size_t mma_smem_bytes(int C, int heads) {
  return sizeof(__nv_bfloat16) *
         (16 + (size_t)align8(heads * kRel) + 7 * (size_t)C +
          3 * (size_t)kP * C + (size_t)kP * (3 * C + 8));
}

// The window's rows (stride XS) from the staged x into the blocked bf16
// window: LN (f32 statistics; a lane holds channel pairs 2 lane + 64 i;
// four rows a warp at a time, so that their reductions overlap) or a copy.
template <bool kLN>
__device__ __forceinline__ void window_rows(const __nv_bfloat16* src,
                                            const __nv_bfloat16* ln_w,
                                            const __nv_bfloat16* ln_b,
                                            __nv_bfloat16* dst, int C, int XS,
                                            int tid) {
  using bf16 = __nv_bfloat16;
  using bf162 = __nv_bfloat162;
  const int lane = tid & 31, warp = tid >> 5;
  // offset of row t's first core matrix in the blocked window
  auto row_base = [&](int t) { return (t >> 3) * (C >> 3) * 64 + (t & 7) * 8; };
  if constexpr (!kLN) {
    for (int t = warp; t < kP; t += kWarps)
      for (int c8 = lane; c8 < C / 8; c8 += 32)
        *reinterpret_cast<uint4*>(dst + row_base(t) + 64 * c8) =
            *reinterpret_cast<const uint4*>(src + t * XS + 8 * c8);
  } else {
    constexpr int R = 4, N = kMaxC / 64;
    float2 wv[N], bv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < C) {
        wv[i] = __bfloat1622float2(*reinterpret_cast<const bf162*>(ln_w + c));
        bv[i] = __bfloat1622float2(*reinterpret_cast<const bf162*>(ln_b + c));
      }
    }
    // pair i of this lane sits at core matrix (lane / 4 + 8 i) of the row
    const int lane_off = (lane >> 2) * 64 + 2 * (lane & 3);
    for (int t0 = warp; t0 < kP; t0 += R * kWarps) {   // rows t0 + 8 r
      float2 v[R][N];
      float s[R], q[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int c = 2 * lane + 64 * i;
          v[r][i] = c < C ? __bfloat1622float2(*reinterpret_cast<const bf162*>(
                                src + (t0 + kWarps * r) * XS + c))
                          : make_float2(0.f, 0.f);
          s[r] += v[r][i].x + v[r][i].y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] /= C;                                     // the mean
        q[r] = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float dx = v[r][i].x - s[r], dy = v[r][i].y - s[r];
          if (2 * lane + 64 * i < C) q[r] += dx * dx + dy * dy;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          q[r] += __shfl_xor_sync(0xffffffffu, q[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rstd = rsqrtf(q[r] / C + 1e-5f);
        bf16* drow = dst + row_base(t0 + kWarps * r) + lane_off;
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (2 * lane + 64 * i < C)
            *reinterpret_cast<bf162*>(drow + 512 * i) = __floats2bfloat162_rn(
                (v[r][i].x - s[r]) * rstd * wv[i].x + bv[i].x,
                (v[r][i].y - s[r]) * rstd * wv[i].y + bv[i].y);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <bool kBlock>
__global__ void __launch_bounds__(kThreads, 2)
wmsa_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ ln_w,
                const __nv_bfloat16* __restrict__ ln_b,
                const __nv_bfloat16* __restrict__ rs,
                const __nv_bfloat16* __restrict__ wblk,
                const __nv_bfloat16* __restrict__ bqkv,
                const __nv_bfloat16* __restrict__ bproj,
                const __nv_bfloat16* __restrict__ rel,
                __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
                int heads, int shifted) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float smem[];
  const int hd = C / heads;
  const int XS = C + 8, QS = 3 * C + 8;
  // mbarriers: ring stage 0, ring stage 1, the staged x
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  bf16* rels = reinterpret_cast<bf16*>(smem) + 16; // (heads, 225) bias
  bf16* vec = rels + align8(heads * kRel);         // ln_w ln_b rs bqkv bproj
  bf16* xs = vec + 7 * C;                          // (64 x C) window, then
                                                   // the attention output
  bf16* qkv = xs + kP * C;                         // (64, QS) [q | k | v];
                                                   // (64, XS) x staging
  bf16* ring = qkv + kP * QS;                      // (2, 64 x C) weights
  const bf16* lnw_s = vec;
  const bf16* lnb_s = vec + C;
  const bf16* rs_s = vec + 2 * C;
  const bf16* bqkv_s = vec + 3 * C;
  const bf16* bproj_s = vec + 6 * C;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // chunk products: warps as 4 (16 tokens) x 2 (32 rows of the chunk)
  const int wm = warp & 3, wn0 = (warp >> 2) * 32;
  const int nh = H / kWin, nw = W / kWin;
  const int nwin = B * nh * nw;
  const int shift = shifted ? kWin / 2 : 0;
  const int nq = (3 * C + kChunk - 1) / kChunk;    // qkv chunks
  const int nch = nq + (C + kChunk - 1) / kChunk;  // + proj chunks
  const int total = (nwin - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nch;          // chunks of this block

  // window `win` as (image, window row, window column), and the global
  // element offset of its token t (rolled frame -> source: the row
  // wr * 8 + t / 8 + shift < 2 H, wrapped by one subtraction)
  struct Win { int b, wr, wc; };
  auto window_at = [&](int win) -> Win {
    const int b = win / (nh * nw), rest = win - b * nh * nw;
    const int wr = rest / nw;
    return {b, wr, rest - wr * nw};
  };
  auto token_offset = [&](const Win& w, int t) -> size_t {
    int r = w.wr * kWin + (t >> 3) + shift, c = w.wc * kWin + (t & 7) + shift;
    if (r >= H) r -= H;
    if (c >= W) c -= W;
    return (((size_t)w.b * H + r) * W + c) * C;
  };
  // window `win`'s x rows into the staging rows (in the qkv buffer): one
  // bulk copy a row, issued by warp 0, landing on bars[2]
  auto load_x = [&](int win) {
    if (warp == 0) {
      const Win w = window_at(win);
      if (lane == 0) dcae::mbar_expect(&bars[2], kP * C * sizeof(bf16));
      __syncwarp();
      for (int t = lane; t < kP; t += 32)
        dcae::bulk_copy(qkv + t * XS, x + token_offset(w, t),
                        C * sizeof(bf16), &bars[2]);
    }
  };
  // chunk `it` of the block's weight stream (period nch; rows of the
  // blocked [Wqkv; Wproj], so a chunk is contiguous) into stage it % 2:
  // one bulk copy, landing on bars[it % 2]
  auto load_chunk = [&](int it) {
    if (tid == 0 && it < total) {
      const int c = it % nch;
      const int r0 = c < nq ? c * kChunk : 3 * C + (c - nq) * kChunk;
      const int rows = min(kChunk, (c < nq ? 3 * C : 4 * C) - r0);
      const uint32_t bytes = rows * C * sizeof(bf16);
      dcae::mbar_expect(&bars[it & 1], bytes);
      dcae::bulk_copy(ring + (it & 1) * kP * C, wblk + (size_t)r0 * C, bytes,
                      &bars[it & 1]);
    }
  };
  // wait for chunk `it` (the (it / 2)-th phase of its stage's barrier),
  // start the next one, return its stage; the block barrier also orders
  // every warp's use of the other stage before its refill
  auto next_chunk = [&](int it) -> const bf16* {
    dcae::mbar_wait(&bars[it & 1], (it >> 1) & 1);
    dcae::fence_proxy_async();     // this thread's writes, for wgmma
    __syncthreads();
    load_chunk(it + 1);
    return ring + (it & 1) * kP * C;
  };
  // acc = A (64 x C) . chunk^T for this warpgroup's 64 x 32 half of the
  // chunk, on wgmma from the two blocked operands; a half past `rows` (a
  // multiple of 16) is skipped, and columns past it are never stored
  auto chunk_product = [&](float acc[16], const bf16* A, const bf16* wst,
                           int rows) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    if (wn0 < rows) {
      const uint64_t da = dcae::wgmma_desc(A, C);
      const uint64_t db = dcae::wgmma_desc(wst + wn0 * C, C);
      dcae::wgmma_fence();
      // a k16 step is 256 bytes further: 16 in the descriptor's units
      for (int k = 0; k < C; k += 16)
        dcae::wgmma_m64n32k16(acc, da + k, db + k);
      dcae::wgmma_commit_wait();
    }
  };

  for (int i = tid; i < heads * kRel; i += kThreads) rels[i] = rel[i];
  for (int i = tid; i < C; i += kThreads) {
    if constexpr (kBlock) {
      vec[i] = ln_w[i];
      vec[C + i] = ln_b[i];
      vec[2 * C + i] = rs[i];
    }
    vec[6 * C + i] = bproj[i];
  }
  for (int i = tid; i < 3 * C; i += kThreads) vec[3 * C + i] = bqkv[i];
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) dcae::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_x(blockIdx.x);
  load_chunk(0);
  const float scale = rsqrtf((float)hd);
  const int hd_tiles = hd / 8;
  int it = 0, done = 0;              // chunks and windows done
  for (int win = blockIdx.x; win < nwin; win += gridDim.x, ++done) {
    const Win w = window_at(win);
    const bool bottom = shifted && w.wr == nh - 1;
    const bool right = shifted && w.wc == nw - 1;
    // the source offsets of this thread's two output rows
    const size_t orow[2] = {token_offset(w, wm * 16 + g),
                            token_offset(w, wm * 16 + g + 8)};

    // this window's x has landed; the previous window is done with xs
    dcae::mbar_wait(&bars[2], done & 1);
    __syncthreads();
    window_rows<kBlock>(qkv, lnw_s, lnb_s, xs, C, XS, tid);

    // ---- qkv of all heads: (64 x 3C) = xs . Wqkv^T + b, into shared
    for (int c = 0; c < nq; ++c, ++it) {
      const bf16* wst = next_chunk(it);
      const int rows = min(kChunk, 3 * C - c * kChunk);
      float acc[16];
      chunk_product(acc, xs, wst, rows);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = wn0 + 8 * j;
        if (nl >= rows) continue;
        const int n = c * kChunk + nl + 2 * q;
        const float b0 = to_f(bqkv_s[n]), b1 = to_f(bqkv_s[n + 1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<__nv_bfloat162*>(
              qkv + (wm * 16 + g + 8 * hh) * QS + n) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh] + b0,
                                    acc[4 * j + 2 * hh + 1] + b1);
      }
    }
    __syncthreads();    // qkv complete; xs is free for the output

    // ---- attention, one (head, 16 queries) item a warp at a time
    for (int item = warp; item < heads * 4; item += kWarps) {
      const int h = item >> 2, mt = item & 3;
      const bf16* qrow = qkv + (mt * 16 + g) * QS + h * hd;
      const bf16* kb = qkv + C + h * hd;
      const bf16* vb = qkv + 2 * C + h * hd;
      const bf16* relh = rels + h * kRel;
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      for (int k = 0; k < hd; k += 16) {
        const bool full = k + 16 <= hd;
        uint32_t a[4];
        a[0] = dcae::ld_pair(qrow + k + 2 * q);
        a[1] = dcae::ld_pair(qrow + 8 * QS + k + 2 * q);
        a[2] = full ? dcae::ld_pair(qrow + k + 2 * q + 8) : 0u;
        a[3] = full ? dcae::ld_pair(qrow + 8 * QS + k + 2 * q + 8) : 0u;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* krow = kb + (nt * 8 + g) * QS;
          uint32_t bw[2];
          bw[0] = dcae::ld_pair(krow + k + 2 * q);
          bw[1] = full ? dcae::ld_pair(krow + k + 2 * q + 8) : 0u;
          dcae::mma_bf16_16816(s[nt], a, bw);
        }
      }
      // bias, mask, and the row maxima of rows g (e < 2) and g + 8. The
      // query of (nt, e) sits at window row 2 mt + e / 2, column g, its key
      // at row nt, column 2 q + e % 2; so the bias index is a per-thread
      // base plus a constant, and the masks (split at 4 = kWin - kWin / 2)
      // are per item and tile (rows) or per thread (columns)
      const bf16* relq = relh + (2 * mt + kWin - 1) * (2 * kWin - 1) + g -
                         2 * q + kWin - 1;
      const bool mask_cols = right && ((g < 4) != (q < 2));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bool masked = mask_cols || (bottom && ((mt < 2) != (nt < 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v =
              masked ? -INFINITY
                     : s[nt][e] * scale +
                           to_f(relq[((e >> 1) - nt) * (2 * kWin - 1) -
                                     (e & 1)]);
          s[nt][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f((s[nt][e] - mx[e >> 1]) * 1.4426950408889634f);
          sum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        sum[r] = 1.f / sum[r];
      }
      // probabilities as bf16 A fragments: keys 16 kc.. are n-tiles 2kc,
      // 2kc + 1 of the scores
      uint32_t p[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        p[nt][0] = pack_bf16(s[nt][0] * sum[0], s[nt][1] * sum[0]);
        p[nt][1] = pack_bf16(s[nt][2] * sum[1], s[nt][3] * sum[1]);
      }
      float o[kMaxHdTiles][4];
#pragma unroll
      for (int nt = 0; nt < kMaxHdTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t a[4] = {p[2 * kc][0], p[2 * kc][1], p[2 * kc + 1][0],
                               p[2 * kc + 1][1]};
#pragma unroll
        for (int nt = 0; nt < kMaxHdTiles; ++nt) {
          if (nt < hd_tiles) {
            // B(k = key, n = d) from v's rows, transposed by ldmatrix:
            // lanes 0-15 address keys 16 kc + lane
            uint32_t bw[2];
            dcae::ldmatrix_x2_trans(
                bw, vb + (16 * kc + (lane & 15)) * QS + nt * 8);
            dcae::mma_bf16_16816(o[nt], a, bw);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kMaxHdTiles; ++nt) {
        if (nt < hd_tiles) {
          const int col = h * hd + nt * 8 + 2 * q;
          *reinterpret_cast<__nv_bfloat162*>(
              xs + dcae::blocked(mt * 16 + g, col, C)) =
              __floats2bfloat162_rn(o[nt][0], o[nt][1]);
          *reinterpret_cast<__nv_bfloat162*>(
              xs + dcae::blocked(mt * 16 + g + 8, col, C)) =
              __floats2bfloat162_rn(o[nt][2], o[nt][3]);
        }
      }
    }

    // ---- proj (+ residual): out = [rs * x +] (o Wp^T + bp); the first
    // chunk's barrier orders the attention output before its use and
    // frees the qkv buffer for the next window's x
    for (int c = 0; c < nch - nq; ++c, ++it) {
      const bf16* wst = next_chunk(it);
      if (c == 0 && win + (int)gridDim.x < nwin) load_x(win + gridDim.x);
      const int rows = min(kChunk, C - c * kChunk);
      // the residual's x, loaded before the product hides its latency
      __nv_bfloat162 xres[4][2];
      if constexpr (kBlock) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (wn0 + 8 * j < rows)
              xres[j][hh] = *reinterpret_cast<const __nv_bfloat162*>(
                  x + orow[hh] + c * kChunk + wn0 + 8 * j + 2 * q);
      }
      float acc[16];
      chunk_product(acc, xs, wst, rows);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = wn0 + 8 * j;
        if (nl >= rows) continue;
        const int n = c * kChunk + nl + 2 * q;
        const float b0 = to_f(bproj_s[n]), b1 = to_f(bproj_s[n + 1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t off = orow[hh] + n;
          float o0 = acc[4 * j + 2 * hh] + b0;
          float o1 = acc[4 * j + 2 * hh + 1] + b1;
          if constexpr (kBlock) {
            const float2 xv = __bfloat1622float2(xres[j][hh]);
            o0 += xv.x * to_f(rs_s[n]);
            o1 += xv.y * to_f(rs_s[n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + off) =
              __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
}

// [Wqkv; Wproj] (4C x C) into the blocked layout of the ring, so that
// every 64-row chunk is one contiguous bulk copy. Templated like the
// kernel it feeds, so a profile groups it with its entry.
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
wmsa_pack_kernel(const __nv_bfloat16* __restrict__ wqkv,
                 const __nv_bfloat16* __restrict__ wproj,
                 __nv_bfloat16* __restrict__ wblk, int C) {
  const int f = blockIdx.x * kThreads + threadIdx.x;   // 8-element piece
  if (f >= 4 * C * (C / 8)) return;
  const int r = f / (C / 8), c8 = f % (C / 8);
  const __nv_bfloat16* src =
      r < 3 * C ? wqkv + (size_t)r * C : wproj + (size_t)(r - 3 * C) * C;
  *reinterpret_cast<uint4*>(wblk + dcae::blocked(r, 8 * c8, C)) =
      *reinterpret_cast<const uint4*>(src + 8 * c8);
}

// f32: one window per block. bf16: the weights packed into `scratch`
// (4C x C bf16), then persistent blocks, as many as fit on the card, never
// more than the windows. ln_w, ln_b and rs are read only when kBlock.
template <bool kBlock>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* rs,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* rel, void* out, void* scratch,
           int B, int H, int W, int C, int heads, int shifted, int bf16,
           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int hd = C / heads;
  const int windows = B * (H / kWin) * (W / kWin);
  cudaError_t err;
  if (bf16) {
    const size_t smem = mma_smem_bytes(C, heads);
    err = cudaFuncSetAttribute(wmsa_mma_kernel<kBlock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, wmsa_mma_kernel<kBlock>, kThreads, smem)) !=
            cudaSuccess)
      return (int)err;
    const int pieces = 4 * C * (C / 8);
    wmsa_pack_kernel<kBlock><<<(pieces + kThreads - 1) / kThreads, kThreads,
                               0, stream>>>((const bf*)wqkv,
                                            (const bf*)wproj, (bf*)scratch, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int slots = (per_sm > 0 ? per_sm : 1) * sms;
    const int grid = windows < slots ? windows : slots;
    wmsa_mma_kernel<kBlock><<<grid, kThreads, smem, stream>>>(
        (const bf*)x, (const bf*)ln_w, (const bf*)ln_b, (const bf*)rs,
        (const bf*)scratch, (const bf*)bqkv, (const bf*)bproj,
        (const bf*)rel, (bf*)out, B, H, W, C, heads, shifted);
  } else {
    const size_t smem = smem_bytes(C, hd);
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
  return (long long)(bf16 ? mma_smem_bytes(C, heads)
                          : smem_bytes(C, C / heads));
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: wqkv (3C, C),
// bqkv (3C), wproj (C, C), bproj (C), rel (heads, 15, 15); ln_w, ln_b, rs
// (C). All of one dtype: f32 (bf16 == 0: CUDA-core kernel, C % 4 == 0,
// `scratch` unused) or bf16 (bf16 == 1: tensor-core kernel, C % 16 == 0,
// C <= 256, head_dim % 8 == 0, head_dim <= 32, `scratch` of 4 C^2 bf16).
// Both entries return the CUDA error of the launches (0 on success).
int dcae_wmsa_block(const void* x, const void* ln_w, const void* ln_b,
                    const void* rs, const void* wqkv, const void* bqkv,
                    const void* wproj, const void* bproj, const void* rel,
                    void* out, void* scratch, int B, int H, int W, int C,
                    int heads, int shifted, int bf16, void* stream) {
  return launch<true>(x, ln_w, ln_b, rs, wqkv, bqkv, wproj, bproj, rel, out,
                      scratch, B, H, W, C, heads, shifted, bf16,
                      (cudaStream_t)stream);
}

// The same without LN and residual: out = proj(WMSA(x)) on an x that is
// already LayerNormed (the widths and dtypes of dcae_wmsa_block).
int dcae_wmsa_attention(const void* x, const void* wqkv, const void* bqkv,
                        const void* wproj, const void* bproj, const void* rel,
                        void* out, void* scratch, int B, int H, int W, int C,
                        int heads, int shifted, int bf16, void* stream) {
  return launch<false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, wproj,
                       bproj, rel, out, scratch, B, H, W, C, heads, shifted,
                       bf16, (cudaStream_t)stream);
}

}  // extern "C"
