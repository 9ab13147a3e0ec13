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
// f32 callers (the training path: every training step launches 30, and
// the full-width f32 model) run wmsa_tf32_kernel, whose bound is the
// 3xTF32 tensor-core rate (three tf32 products an f32 one: 495 / 3 TFLOP/s
// against 67 on the FMA units):
//  * Every product (qkv, q k^T, P V, proj) runs 3xTF32 on mma.sync m16n8k8:
//    each operand split as v = hi + lo (dcae::split_tf32), lo hi + hi lo +
//    hi hi of a k-step summed in a fresh partial added to the accumulator.
//  * f32 qkv for all heads does not fit beside the window (64 x 3C x 4 =
//    197 KB at C = 256), so heads go in groups of gw <= 64 channels
//    (f32_plan): a group's q, k, v (64 x 3 gw) come from the resident LN
//    window, its attention runs as (head, 16 queries) warp items, and its
//    share of proj, o_grp . Wproj[:, grp]^T, adds into a 64 x C accumulator
//    that lives in registers (a warp holds 16 rows x C / 2). No buffer of
//    the attention output beyond the group's: o overwrites the item's own
//    rows of q.
//  * The weights, packed once per call by wmsa_tf32_pack_kernel into the
//    B-fragment order of the products, stream group by group as K-slices
//    of at most 16 or 32 KB through a two-stage ring of bulk copies on
//    mbarriers, as in the bf16 kernel: one 8-byte load a fragment, no
//    thread reads a weight from L2. Persistent blocks walk the windows;
//    at C <= 144 two blocks fit an SM.
//  * P V takes the probabilities straight from the score registers: under
//    a permutation of the keys of each k-step (see the kernel) the m16n8k8
//    D fragment is its A fragment. There is no 32-bit ldmatrix.trans, so V
//    comes by scalar loads from rows 4 (or 20) mod 32 floats apart, free of
//    bank conflicts.
//  * It takes the bf16 kernel's widths (widths_taken): a template on its
//    tile counts, instantiated for every pair a plan can ask for
//    (f32_kernel).
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

using dcae::mma_tf32_1688;
using dcae::split_tf32;
using dcae::to_f;

constexpr int kWin = 8;
constexpr int kP = kWin * kWin;   // tokens per window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRel = (2 * kWin - 1) * (2 * kWin - 1);   // bias table a head
constexpr int kMaxC = 256;                         // LN row: 8 a lane
constexpr int kMaxHdTiles = 4;                     // head_dim <= 32

__host__ __device__ inline int align4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int align8(int n) { return (n + 7) / 8 * 8; }

// ---------------------------------------------------------------------------
// f32 callers: 3xTF32 on mma.sync, heads in groups, proj folded into the
// head loop (see the header).

// The widths both kernels take: 16-deep products over C (C <= 256, an LN
// row in a warp's registers) and 8-wide head tiles up to head_dim 32. The
// wrapper's kernel_takes states the same rule.
__host__ inline bool widths_taken(int C, int heads) {
  if (heads <= 0 || C % heads || C % 16 || C > kMaxC) return false;
  const int hd = C / heads;
  return hd % 8 == 0 && hd <= 8 * kMaxHdTiles;
}

// The f32 kernel's plan of a width. Heads go in groups of G, the largest
// divisor of heads with gw = G * hd <= 64 channels and gw % 16 == 0 (so
// that a group gives every warp attention work: 4 G items of 16 queries).
// Every width widths_taken takes has one: hd = 16 or 32 takes G = 1, and
// hd = 8 or 24 G = 2, since C % 16 == 0 makes heads even there.
// A group's qkv product streams its 3 gw rows of Wqkv in K-slices of kc
// columns, its proj share (Wproj's gw columns of the group) in K-slices of
// kp, every slice at most 16 KB (C <= 144: two blocks an SM fit) or 32 KB.
// nt = C / 16 and qt = 3 gw / 16 are a warp's n-tiles in proj and in qkv.
struct F32Plan {
  int G, gw, kc, kp, nt, qt;
};

__host__ inline bool f32_plan(int C, int heads, F32Plan& p) {
  if (!widths_taken(C, heads)) return false;
  const int hd = C / heads;
  p.G = 0;
  for (int g = 1; g <= heads; ++g)
    if (heads % g == 0 && g * hd <= 64 && g * hd % 16 == 0) p.G = g;
  if (p.G == 0) return false;
  p.gw = p.G * hd;
  const int budget = C <= 144 ? 4096 : 8192;       // floats a slice
  auto slice = [budget](int rows, int K) {
    int best = 0;
    for (int k = 8; k <= K; k += 8)
      if (K % k == 0 && rows * k <= budget) best = k;
    return best;
  };
  p.kc = slice(3 * p.gw, C);
  p.kp = slice(C, p.gw);
  p.nt = C / 16;
  p.qt = 3 * p.gw / 16;
  return p.kc > 0 && p.kp > 0;
}

// Two mbarriers (16 bytes); rel tables; ln_w, ln_b, rs, bqkv, bproj; the
// window xn (64, C+4); the group's qkv (64, 3 gw + 4), whose q columns
// also take the attention output; two ring stages of a slice. The row
// strides are 4 mod 32 (or 20 mod 32) floats: the fragment loads are free
// of bank conflicts.
__host__ inline size_t f32_smem_bytes(int C, int heads, const F32Plan& p) {
  const int stage = 3 * p.gw * p.kc > C * p.kp ? 3 * p.gw * p.kc : C * p.kp;
  return sizeof(float) *
         (4 + (size_t)align4(heads * kRel) + 7 * (size_t)C +
          (size_t)kP * (C + 4) + (size_t)kP * (3 * p.gw + 4) + 2 * (size_t)stage);
}

// The window's rows from global x into dst (stride XS): LN (f32
// statistics; a lane holds channel pairs 2 lane + 64 i; four rows a warp
// at a time, so that their loads and reductions overlap) or a copy.
template <bool kLN, typename Offset>
__device__ __forceinline__ void window_rows_f32(const float* __restrict__ x,
                                                Offset token_offset,
                                                const float* ln_w,
                                                const float* ln_b, float* dst,
                                                int C, int XS, int warp,
                                                int lane) {
  constexpr int R = 4, N = kMaxC / 64;
  for (int t0 = warp; t0 < kP; t0 += R * kWarps) {   // rows t0 + 8 r
    float2 v[R][N];
    float s[R], q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* src = x + token_offset(t0 + kWarps * r);
      s[r] = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = 2 * lane + 64 * i;
        v[r][i] = c < C ? *reinterpret_cast<const float2*>(src + c)
                        : make_float2(0.f, 0.f);
        s[r] += v[r][i].x + v[r][i].y;
      }
    }
    if constexpr (kLN) {
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
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int c = 2 * lane + 64 * i;
          if (c < C)
            v[r][i] = make_float2(
                (v[r][i].x - s[r]) * rstd * ln_w[c] + ln_b[c],
                (v[r][i].y - s[r]) * rstd * ln_w[c + 1] + ln_b[c + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = 2 * lane + 64 * i;
        if (c < C)
          *reinterpret_cast<float2*>(dst + (t0 + kWarps * r) * XS + c) =
              v[r][i];
      }
  }
}

// The three tf32 products of one k-step into a fresh partial, added to the
// accumulator in f32 (the tensor cores' own accumulation truncates).
__device__ __forceinline__ void mma_3xtf32(float acc[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(part, al, bh);
  mma_tf32_1688(part, ah, bl);
  mma_tf32_1688(part, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// The A fragment of rows 0..15 at k-step ks of a row-major f32 tile
// (stride lda, 16-byte aligned rows), by ldmatrix, split into hi and lo.
__device__ __forceinline__ void a_frag_3xtf32(const float* A, int lda, int ks,
                                              int lane, uint32_t ah[4],
                                              uint32_t al[4]) {
  uint32_t a[4];
  dcae::ldmatrix_x4(a, A + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                           8 * ks + (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
}

// acc[t] += A (16 rows, ksteps x 8 deep, stride lda) . B^T for the n-tiles
// nt0 + t of a ring slice, which holds the B fragment of n-tile nt at
// k-step ks for lane l at ((ks * ntiles + nt) * 32 + l) * 2.
template <int kT>
__device__ __forceinline__ void slice_product(float acc[kT][4], const float* A,
                                              int lda, const float* Bp,
                                              int ntiles, int nt0, int ksteps,
                                              int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[4], al[4];
    a_frag_3xtf32(A, lda, ks, lane, ah, al);
    const float* bk = Bp + ((size_t)ks * ntiles + nt0) * 64 + 2 * lane;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float2 b = *reinterpret_cast<const float2*>(bk + 64 * t);
      uint32_t bh[2], bl[2];
      split_tf32(b.x, bh[0], bl[0]);
      split_tf32(b.y, bh[1], bl[1]);
      mma_3xtf32(acc[t], ah, al, bh, bl);
    }
  }
}

template <bool kBlock, int kNT, int kQT>
__global__ void __launch_bounds__(kThreads, kNT <= 9 ? 2 : 1)
wmsa_tf32_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const float* __restrict__ rs,
                 const float* __restrict__ wpk, const float* __restrict__ bqkv,
                 const float* __restrict__ bproj,
                 const float* __restrict__ rel, float* __restrict__ out, int B,
                 int H, int W, int C, int heads, int shifted, int G, int kc,
                 int kp) {
  extern __shared__ float smem[];
  const int hd = C / heads, gw = G * hd;
  const int XS = C + 4, QS = 3 * gw + 4;
  const int stage = max(3 * gw * kc, C * kp);      // floats a ring stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // ring stages 0, 1
  float* rels = smem + 4;                          // (heads, 225) bias
  float* vec = rels + align4(heads * kRel);        // ln_w ln_b rs bqkv bproj
  float* xn = vec + 7 * C;                         // (64, XS) LN(x) or x
  float* qkv = xn + kP * XS;                       // (64, QS) [q | k | v]
  float* ring = qkv + kP * QS;                     // (2, stage) weights
  const float* rs_s = vec + 2 * C;
  const float* bqkv_s = vec + 3 * C;
  const float* bproj_s = vec + 6 * C;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // products: warps as 4 (16 tokens) x 2 (halves of the columns)
  const int wm = warp & 3, wn = warp >> 2;
  const int nh = H / kWin, nw = W / kWin;
  const int nwin = B * nh * nw;
  const int shift = shifted ? kWin / 2 : 0;
  const int ngrp = heads / G;
  const int nkq = C / kc, per_grp = nkq + gw / kp;
  const int nch = ngrp * per_grp;                  // slices a window
  const int total = (nwin - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x * nch;          // slices of this block

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
  // slice `it` of the block's weight stream (period nch, in the packed
  // order of wmsa_tf32_pack_kernel) into stage it % 2: one bulk copy,
  // landing on bars[it % 2]
  auto load_slice = [&](int it) {
    if (tid == 0 && it < total) {
      const int c = it % nch, grp = c / per_grp, j = c - grp * per_grp;
      const float* src = wpk + (size_t)grp * 4 * gw * C;
      uint32_t n;
      if (j < nkq) {
        n = 3 * gw * kc;
        src += (size_t)j * n;
      } else {
        n = C * kp;
        src += (size_t)3 * gw * C + (size_t)(j - nkq) * n;
      }
      dcae::mbar_expect(&bars[it & 1], n * sizeof(float));
      dcae::bulk_copy(ring + (it & 1) * stage, src, n * sizeof(float),
                      &bars[it & 1]);
    }
  };
  // wait for slice `it`, start the next one, return its stage; the block
  // barrier also orders every warp's use of the other stage before its
  // refill
  auto next_slice = [&](int it) -> const float* {
    dcae::mbar_wait(&bars[it & 1], (it >> 1) & 1);
    __syncthreads();
    load_slice(it + 1);
    return ring + (it & 1) * stage;
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
    for (int i = 0; i < 2; ++i) dcae::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_slice(0);
  const float scale = rsqrtf((float)hd);
  const int hd_tiles = hd / 8;
  int it = 0;                                      // slices done
  for (int win = blockIdx.x; win < nwin; win += gridDim.x) {
    const Win w = window_at(win);
    const bool bottom = shifted && w.wr == nh - 1;
    const bool right = shifted && w.wc == nw - 1;
    // the previous window's last slice barrier ordered every read of xn
    // before these writes; the next slice barrier orders them before use
    window_rows_f32<kBlock>(
        x, [&](int t) { return token_offset(w, t); }, vec, vec + C, xn, C, XS,
        warp, lane);

    float acc[kNT][4];                             // this warp's 16 x C/2
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int grp = 0; grp < ngrp; ++grp) {
      // ---- q, k, v of the group: (64 x 3 gw) = xn . Wqkv_grp^T + b
      float qa[kQT][4];
#pragma unroll
      for (int t = 0; t < kQT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[t][e] = 0.f;
      for (int j = 0; j < nkq; ++j, ++it)
        slice_product<kQT>(qa, xn + wm * 16 * XS + j * kc, XS, next_slice(it),
                           2 * kQT, wn * kQT, kc / 8, lane);
#pragma unroll
      for (int t = 0; t < kQT; ++t) {
        const int n = (wn * kQT + t) * 8 + 2 * q;  // column of [q | k | v]
        const int part = n / gw;
        const float* b = bqkv_s + part * C + grp * gw + n - part * gw;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(qkv + (wm * 16 + g + 8 * hh) * QS + n) =
              make_float2(qa[t][2 * hh] + b[0], qa[t][2 * hh + 1] + b[1]);
      }
      __syncthreads();                             // the group's qkv is whole

      // ---- attention, one (head, 16 queries) item a warp at a time
      for (int item = warp; item < 4 * G; item += kWarps) {
        const int hh = item >> 2, mt = item & 3;
        float* qrow = qkv + mt * 16 * QS + hh * hd;   // q, then o
        const float* kb = qkv + gw + hh * hd;
        const float* vb = qkv + 2 * gw + hh * hd;
        const float* relh = rels + (grp * G + hh) * kRel;
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        for (int ks = 0; ks < hd_tiles; ++ks) {
          uint32_t ah[4], al[4];
          a_frag_3xtf32(qrow, QS, ks, lane, ah, al);
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            // B fragments of key tiles nt, nt + 1: (key g, d q), (key g,
            // d q + 4) of each
            uint32_t t4[4];
            dcae::ldmatrix_x4(t4, kb + (8 * nt + (lane & 7) + (lane >> 4) * 8) *
                                           QS +
                                      8 * ks + ((lane >> 3) & 1) * 4);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              uint32_t bh[2], bl[2];
              split_tf32(__uint_as_float(t4[2 * u]), bh[0], bl[0]);
              split_tf32(__uint_as_float(t4[2 * u + 1]), bh[1], bl[1]);
              mma_3xtf32(s[nt + u], ah, al, bh, bl);
            }
          }
        }
        // bias, mask and softmax as in the bf16 kernel (f32, a row over a
        // quad of lanes): the query of (nt, e) sits at window row
        // 2 mt + e / 2, column g, its key at row nt, column 2 q + e % 2
        const float* relq = relh + (2 * mt + kWin - 1) * (2 * kWin - 1) + g -
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
                             relq[((e >> 1) - nt) * (2 * kWin - 1) - (e & 1)];
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
            s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
            sum[e >> 1] += s[nt][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          sum[r] = 1.f / sum[r];
        }
        // P V. The scores' D fragment serves as P's A fragment under a
        // permutation of the keys of each k-step (k = q <-> key 2 q, k =
        // q + 4 <-> key 2 q + 1; the sum over keys does not depend on their
        // order), so B takes V's rows in the same order: (key 8 kc + 2 q,
        // d g), (key 8 kc + 2 q + 1, d g). No shuffle, no trip through
        // shared memory.
        float o[kMaxHdTiles][4];
#pragma unroll
        for (int dn = 0; dn < kMaxHdTiles; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
        for (int kc8 = 0; kc8 < 8; ++kc8) {
          const float pv[4] = {s[kc8][0] * sum[0], s[kc8][2] * sum[1],
                               s[kc8][1] * sum[0], s[kc8][3] * sum[1]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(pv[e], ah[e], al[e]);
          const float* v0 = vb + (8 * kc8 + 2 * q) * QS + g;
#pragma unroll
          for (int dn = 0; dn < kMaxHdTiles; ++dn) {
            if (dn < hd_tiles) {
              uint32_t bh[2], bl[2];
              split_tf32(v0[8 * dn], bh[0], bl[0]);
              split_tf32(v0[QS + 8 * dn], bh[1], bl[1]);
              mma_3xtf32(o[dn], ah, al, bh, bl);
            }
          }
        }
        // o over this item's q: no other item reads those rows of q
        __syncwarp();
#pragma unroll
        for (int dn = 0; dn < kMaxHdTiles; ++dn) {
          if (dn < hd_tiles) {
            float* orow = qrow + g * QS + 8 * dn + 2 * q;
            *reinterpret_cast<float2*>(orow) = make_float2(o[dn][0], o[dn][1]);
            *reinterpret_cast<float2*>(orow + 8 * QS) =
                make_float2(o[dn][2], o[dn][3]);
          }
        }
      }

      // ---- proj, the group's share: acc += o_grp . Wproj[:, grp]^T. The
      // first slice's barrier orders the attention output before its use.
      // (proj sums group by group: another order than the plain version's
      // one product over all C channels, a difference of f32 rounding.)
      for (int j = 0; j < gw / kp; ++j, ++it)
        slice_product<kNT>(acc, qkv + wm * 16 * QS + j * kp, QS,
                           next_slice(it), 2 * kNT, wn * kNT, kp / 8, lane);
    }

    // ---- out = [rs * x +] (acc + bproj)
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int n = (wn * kNT + t) * 8 + 2 * q;
      const float b0 = bproj_s[n], b1 = bproj_s[n + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t off = token_offset(w, wm * 16 + g + 8 * hh) + n;
        float o0 = acc[t][2 * hh] + b0, o1 = acc[t][2 * hh + 1] + b1;
        if constexpr (kBlock) {
          const float2 xv = *reinterpret_cast<const float2*>(x + off);
          o0 += xv.x * rs_s[n];
          o1 += xv.y * rs_s[n + 1];
        }
        *reinterpret_cast<float2*>(out + off) = make_float2(o0, o1);
      }
    }
  }
}

// [Wqkv; Wproj] (f32) into the slices the f32 kernel streams: per group of
// heads, its 3 gw rows of Wqkv ([q | k | v] of the group's channels) in
// K-slices of kc, then Wproj's gw columns of the group in K-slices of kp.
// A slice of R rows holds the B fragment (b0, b1) = (W[n][k], W[n][k + 4])
// of n-tile nt at k-step ks for lane l = 4 (n % 8) + k % 4 at
// ((ks * R / 8 + nt) * 32 + l) * 2: one 8-byte load a fragment, free of
// bank conflicts. One thread a fragment.
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
wmsa_tf32_pack_kernel(const float* __restrict__ wqkv,
                      const float* __restrict__ wproj, float* __restrict__ wpk,
                      int C, int gw, int kc, int kp) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= 2 * C * C) return;
  const int e = 2 * f;
  const int grp = e / (4 * gw * C);
  int rem = e - grp * 4 * gw * C;
  const bool is_qkv = rem < 3 * gw * C;
  if (!is_qkv) rem -= 3 * gw * C;
  const int R = is_qkv ? 3 * gw : C, kw = is_qkv ? kc : kp;
  const int j = rem / (R * kw);
  const int pair = (rem - j * R * kw) >> 1;
  const int l = pair & 31, nt = (pair >> 5) % (R / 8), ks = (pair >> 5) / (R / 8);
  const int n = 8 * nt + (l >> 2), k = j * kw + 8 * ks + (l & 3);
  const float* src;
  if (is_qkv) {
    const int part = n / gw;                       // q, k or v
    src = wqkv + (size_t)(part * C + grp * gw + n - part * gw) * C + k;
  } else {
    src = wproj + (size_t)n * C + grp * gw + k;
  }
  *reinterpret_cast<float2*>(wpk + e) = make_float2(src[0], src[4]);
}

// The f32 kernel of a plan's tile counts, from all the pairs a plan can
// ask for, each instantiated: qt = 3 gw / 16 for gw = 16, 32, 48, 64 and
// nt = C / 16, a multiple of gw / 16 (G divides heads) up to 16. The walk
// starts at (1, 3) and steps nt by qt / 3, then qt by 3: 33 pairs.
template <bool kBlock>
using F32Kernel = decltype(&wmsa_tf32_kernel<kBlock, 1, 3>);

template <bool kBlock, int kNT = 1, int kQT = 3>
F32Kernel<kBlock> f32_kernel(const F32Plan& p) {
  if (p.nt == kNT && p.qt == kQT) return wmsa_tf32_kernel<kBlock, kNT, kQT>;
  if constexpr (kNT + kQT / 3 <= kMaxC / 16)
    return f32_kernel<kBlock, kNT + kQT / 3, kQT>(p);
  else if constexpr (kQT < 12)
    return f32_kernel<kBlock, kQT / 3 + 1, kQT + 3>(p);
  else
    return nullptr;
}

// ---------------------------------------------------------------------------
// bf16 callers: persistent blocks, weights streamed through a ring of bulk
// copies, qkv and proj on wgmma, heads as independent warp items (see the
// header).
constexpr int kChunk = 64;                         // weight rows a stage

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

// The weights packed into `scratch` (4C x C of the dtype) for the bulk
// copies, then persistent blocks, as many as fit on the card, never more
// than the windows. ln_w, ln_b and rs are read only when kBlock.
template <bool kBlock>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* rs,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* rel, void* out, void* scratch,
           int B, int H, int W, int C, int heads, int shifted, int bf16,
           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (!widths_taken(C, heads)) return (int)cudaErrorInvalidValue;
  const int windows = B * (H / kWin) * (W / kWin);
  F32Plan plan{};
  const void* kernel;
  size_t smem;
  if (bf16) {
    kernel = (const void*)wmsa_mma_kernel<kBlock>;
    smem = mma_smem_bytes(C, heads);
  } else {
    if (!f32_plan(C, heads, plan) || !f32_kernel<kBlock>(plan))
      return (int)cudaErrorInvalidValue;
    kernel = (const void*)f32_kernel<kBlock>(plan);
    smem = f32_smem_bytes(C, heads, plan);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int slots = (per_sm > 0 ? per_sm : 1) * sms;
  const int grid = windows < slots ? windows : slots;
  if (bf16) {
    const int pieces = 4 * C * (C / 8);
    wmsa_pack_kernel<kBlock><<<(pieces + kThreads - 1) / kThreads, kThreads,
                               0, stream>>>((const bf*)wqkv,
                                            (const bf*)wproj, (bf*)scratch, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wmsa_mma_kernel<kBlock><<<grid, kThreads, smem, stream>>>(
        (const bf*)x, (const bf*)ln_w, (const bf*)ln_b, (const bf*)rs,
        (const bf*)scratch, (const bf*)bqkv, (const bf*)bproj,
        (const bf*)rel, (bf*)out, B, H, W, C, heads, shifted);
  } else {
    const int pairs = 2 * C * C;
    wmsa_tf32_pack_kernel<kBlock><<<(pairs + kThreads - 1) / kThreads,
                                    kThreads, 0, stream>>>(
        (const float*)wqkv, (const float*)wproj, (float*)scratch, C, plan.gw,
        plan.kc, plan.kp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    f32_kernel<kBlock>(plan)<<<grid, kThreads, smem, stream>>>(
        (const float*)x, (const float*)ln_w, (const float*)ln_b,
        (const float*)rs, (const float*)scratch, (const float*)bqkv,
        (const float*)bproj, (const float*)rel, (float*)out, B, H, W, C,
        heads, shifted, plan.G, plan.kc, plan.kp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at these widths (the wrapper checks it
// against the card's limit before launching); -1 for widths the kernels
// do not take.
long long dcae_wmsa_block_smem(int C, int heads, int bf16) {
  if (!widths_taken(C, heads)) return -1;
  if (bf16) return (long long)mma_smem_bytes(C, heads);
  F32Plan plan{};
  if (!f32_plan(C, heads, plan) || !f32_kernel<true>(plan)) return -1;
  return (long long)f32_smem_bytes(C, heads, plan);
}

// x, out: (B, H, W, C) contiguous; weights in torch layout: wqkv (3C, C),
// bqkv (3C), wproj (C, C), bproj (C), rel (heads, 15, 15); ln_w, ln_b, rs
// (C). All of one dtype, with `scratch` of 4 C^2 of it: f32 (bf16 == 0:
// the 3xTF32 kernel) or bf16 (bf16 == 1: the wgmma kernel), at the widths
// widths_taken takes (C % 16 == 0, C <= 256, head_dim % 8 == 0, head_dim
// <= 32). Both entries return the CUDA error of the launches (0 on
// success).
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
