// NHWC stride-1 convolution, 1x1, 3x3 or 5x5 with zero padding k / 2, with
// its bias and the activation that follows it (none, exact-erf GELU or
// ReLU), in f32:
//     out[b, h, w, n] = act(bias[n] + sum_{r, s, c} x[b, h + r - k/2,
//                       w + s - k/2, c] * wt[n, c, r, s])
// The sum runs over every tap (r, s), or, for a 5x5 with taps = 1, over the
// 12 taps with r + s odd only: ELIC's checkerboard-masked spatial context,
// whose other weights are zero by its mask, so they are never loaded.
//
// It replaces no TPU kernel: the JAX package leaves its convolutions to
// XLA. It takes the entropy side's f32 convolutions at inference (the
// slice context nets, the dictionary attention's 1x1s, the hyper
// synthesis's stride-1 convolutions; ELIC's 5x5 channel and spatial
// contexts), which must stay f32 and bitwise repeatable: encoder and
// decoder compute the same mu, sigma and LRP, and the certified encoder
// replays the decoder's chain.
//
// What bounds it on the H100: operations. The slice nets' first layer is a
// GEMM of M = 12,288 pixels, N = 224 and K up to 11,520 at a batch of 8
// Kodak images, some 2,000 operations a byte of its operands. On the CUDA
// cores the f32 FMA rate (67 TFLOP/s) is the ceiling; here the products
// run on the tensor cores in 3xTF32, as the f32 GEMMs of conv_glu.cu do:
// each operand is split as v = hi + lo (split_tf32, no conversion
// instruction), lo*hi + hi*lo + hi*hi of two k-steps of 8 sum in a fresh
// partial and the partial is added to the accumulator in f32 (the tensor
// cores' own accumulation truncates: kSteps). That is f32-class accuracy
// at a ceiling of three TF32 products an f32 one: 3 x flops / 495 TFLOP/s.
//
// The design: an implicit GEMM on the NHWC tensors as they are (M = B H W
// output pixels, N = C_out, K = taps x C_in), one output tile a block, 8
// warps on mma.sync m16n8k8 with ldmatrix fragments, fed by a cp.async ring
// of 2-4 stages. K runs tap by tap, (r, s, c): a K slice of 32 is a
// contiguous channel run of one tap, so a thread loads 16 bytes of one
// input pixel (4 bytes where C_in % 4 != 0), and the image border and the
// channels past C_in are zero fills (no padded copy of x). The weight is
// packed once by the wrapper to (C_out, taps, C_in rounded up to 32), zeros
// past C_in, so every weight slice is whole and aligned. The epilogue adds
// the bias, applies the activation and writes each output once, in NHWC:
// no layout transposes, no separate activation pass.
//
// One body, two kernels: conv2d_nhwc_tf32x3_kernel takes 1x1 and 3x3 (k at
// run time), conv2d_nhwc_k5_tf32x3_kernel takes 5x5 (k a constant, the
// tap set at run time), so that a device trace tells the 5x5 launches
// apart by name.
//
// Tile shapes (BM x BN, warps WM x WN) are a template parameter and the
// wrapper picks one per call from the shape it sees, by the waves of
// tiles it fills on the card's SMs. Determinism: no split-K, no atomics.
// Every output is one thread's sum over k-steps in the fixed order above,
// which depends on C_in, k and the tap set alone, not on B, H, W or the
// tile shape, so a pixel's output is bitwise the same in a batch of 8 as
// alone, and from launch to launch.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::mma_tf32_1688;
using dcae::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;            // K columns a stage: one tap's channels
constexpr int kBKS = kBK + 4;      // staged row stride: conflict-free frags
constexpr int kPieces = kBK / 4;   // 16-byte pieces a staged row
constexpr int kRingBytes = 200 * 1024;   // the ring's budget of shared memory
// k-steps of 8 whose products sum in one partial before it is added to the
// accumulator: the tensor cores' truncating sum then covers 48 products
// that start from zero, never the running total (measured on an H100
// against f64: 1.3e-6 of max at K = 10,944, against 1.8e-6 with a partial
// a k-step and 8.5e-5 with none), and each accumulator takes half the f32
// adds; more steps would hold more fragments than the registers take
constexpr int kSteps = 2;

enum Act { kNone = 0, kGelu = 1, kRelu = 2 };

struct Conv {
  const float* x;       // (B, H, W) pixels, ldx floats apart, C channels
  const float* w;       // packed (N, taps, Cp)
  const float* bias;    // (N) or null
  float* out;           // (B, H, W, N) contiguous
  int B, H, W, C, ldx, N, k, Cp, act;
  int odd;              // 5x5 only: 1 runs the 12 taps with r + s odd
};

template <int BM, int BN, int WM>
struct Tile {
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = BM / WM / 16;    // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;     // n8 tiles a warp
  static constexpr int kStageFloats = (BM + BN) * kBKS;
  static constexpr int kFit = kRingBytes / (int)sizeof(float) / kStageFloats;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)kStages * kStageFloats;
  static_assert(MT * WM * 16 == BM && NT * WN * 8 == BN, "warp tiling");
  static_assert(BM * kPieces % kThreads == 0 &&
                BN * kPieces % kThreads == 0, "whole loads a thread");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// Two 8 x 16-byte matrices from shared memory: lanes 0-7 give the row
// addresses of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGelu) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

// One BM x BN output tile a block; grid (ceil(M / BM), ceil(N / BN)).
// kVec: C % 4 == 0 and ldx % 4 == 0 and x 16-byte aligned (16-byte loads).
// KS: 0, k from p (1 or 3, every tap); or 5, a 5x5 whose taps are every
// one, or those with r + s odd (p.odd), whose linear index r * 5 + s is
// then odd too: tap t of the packed weight sits at 2 t + 1.
template <int BM, int BN, int WM, bool kVec, int KS>
__device__ __forceinline__ void conv_tile(const Conv& p) {
  using T = Tile<BM, BN, WM>;
  constexpr int MT = T::MT, NT = T::NT, S = T::kStages;
  constexpr int kARows = BM * kPieces / kThreads;   // A rows a thread loads
  constexpr int kBRows = BN * kPieces / kThreads;
  constexpr int kRowStep = kThreads / kPieces;
  extern __shared__ float smem[];
  float* As = smem;                     // [S][BM][kBKS]
  float* Bs = smem + S * BM * kBKS;     // [S][BN][kBKS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp % WM) * (BM / WM), wn = (warp / WM) * (BN / T::WN);
  const int M = p.B * p.H * p.W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int piece = tid % kPieces, row0 = tid / kPieces;

  // the output pixels whose input rows this thread loads; a row past M
  // gets a height that no tap brings inside the image
  int am[kARows], ah[kARows], aw[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + row0 + i * kRowStep;
    am[i] = m;
    ah[i] = m < M ? (m / p.W) % p.H : -(1 << 20);
    aw[i] = m % p.W;
  }
  const int k = KS ? KS : p.k;
  const int taps = KS && p.odd ? KS * KS / 2 : k * k;
  const int pad = k / 2, cps = p.Cp / kBK, ktiles = taps * cps;
  const size_t ldw = (size_t)taps * p.Cp;

  auto load = [&](int kt, int stage) {
    const int t = kt / cps;
    const int tap = KS && p.odd ? 2 * t + 1 : t;
    const int c = (kt - t * cps) * kBK + 4 * piece;
    const int dy = tap / k - pad, dx = tap % k - pad;
    float* as = As + stage * BM * kBKS + piece * 4;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int h = ah[i] + dy, w = aw[i] + dx;
      const bool in = h >= 0 && h < p.H && w >= 0 && w < p.W;
      const long long off =
          ((long long)am[i] + dy * p.W + dx) * p.ldx + c;
      float* dst = as + (row0 + i * kRowStep) * kBKS;
      if (kVec) {
        const bool ok = in && c < p.C;
        dcae::cp_async16_zfill(dst, ok ? p.x + off : p.x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && c + e < p.C;
          cp_async4_zfill(dst + e, ok ? p.x + off + e : p.x, ok);
        }
      }
    }
    float* bs = Bs + stage * BN * kBKS + piece * 4;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int r = row0 + i * kRowStep, n = n0 + r;
      const bool ok = n < p.N;
      dcae::cp_async16_zfill(
          bs + r * kBKS,
          ok ? p.w + (size_t)n * ldw + (size_t)kt * kBK + 4 * piece : p.w,
          ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ktiles) load(s, s);
    dcae::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    dcae::cp_async_wait<S - 2>();
    __syncthreads();    // slice kt landed; slice kt-1's stage is free
    if (kt + S - 1 < ktiles) load(kt + S - 1, (kt + S - 1) % S);
    dcae::cp_async_commit();
    const float* as = As + (kt % S) * BM * kBKS;
    const float* bs = Bs + (kt % S) * BN * kBKS;
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 8 * kSteps) {
      uint32_t ahi[kSteps][MT][4], alo[kSteps][MT][4];
      uint32_t bhi[kSteps][NT][2], blo[kSteps][NT][2];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        // fragments by ldmatrix, f32 as 4-byte elements: A matrices (rows
        // 0-7, k..k+3), (rows 8-15, k..), (rows 0-7, k+4..), (rows 8-15,
        // k+4..); B two n-tiles at once, (n 0-7, k..), (n 0-7, k+4..),
        // (n 8-15, k..), (n 8-15, k+4..), and the last alone if NT is odd
        const int kk = k0 + 8 * st;
        uint32_t ar[MT][4], br[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          dcae::ldmatrix_x4(ar[i], as + (wm + 16 * i + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * kBKS +
                                       kk + (lane >> 4) * 4);
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t t[4];
          dcae::ldmatrix_x4(t, bs + (wn + 8 * j + (lane & 7) +
                                     (lane >> 4) * 8) * kBKS +
                                   kk + ((lane >> 3) & 1) * 4);
          br[j][0] = t[0];
          br[j][1] = t[1];
          br[j + 1][0] = t[2];
          br[j + 1][1] = t[3];
        }
        if (NT % 2)
          ldmatrix_x2(br[NT - 1], bs + (wn + 8 * (NT - 1) + (lane & 7)) *
                                           kBKS +
                                      kk + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(ar[i][e]), ahi[st][i][e],
                       alo[st][i][e]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split_tf32(__uint_as_float(br[j][e]), bhi[st][j][e],
                       blo[st][j][e]);
      }
      // the three products of each k-step (small terms first) sum in a
      // fresh partial over kSteps k-steps, added to the accumulator in f32
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int st = 0; st < kSteps; ++st) {
            mma_tf32_1688(part, alo[st][i], bhi[st][j]);
            mma_tf32_1688(part, ahi[st][i], blo[st][j]);
            mma_tf32_1688(part, ahi[st][i], bhi[st][j]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
    }
  }
  dcae::cp_async_wait<0>();

  const bool pairs = (p.N & 1) == 0;    // n even: float2 stores aligned
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + 8 * j + 2 * q;
    if (n >= p.N) continue;
    const bool two = n + 1 < p.N;
    const float b0 = p.bias ? p.bias[n] : 0.f;
    const float b1 = p.bias && two ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        const float v0 = activate(acc[i][j][2 * h] + b0, p.act);
        const float v1 = activate(acc[i][j][2 * h + 1] + b1, p.act);
        float* o = p.out + (size_t)m * p.N + n;
        if (two && pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
  }
}

template <int BM, int BN, int WM, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv2d_nhwc_tf32x3_kernel(const Conv p) {
  conv_tile<BM, BN, WM, kVec, 0>(p);
}

template <int BM, int BN, int WM, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv2d_nhwc_k5_tf32x3_kernel(const Conv p) {
  conv_tile<BM, BN, WM, kVec, 5>(p);
}

// The tile shapes, by index (the wrapper's TILES lists the same):
//   0: 96 x 224 (2 x 4 warps of 48 x 56)   the slice nets' first layer
//   1: 96 x 128 (2 x 4 warps of 48 x 32)
//   2: 96 x 64  (2 x 4 warps of 48 x 16)
//   3: 64 x 64  (2 x 4 warps of 32 x 16)   small calls

template <int BM, int BN, int WM, bool kVec>
struct Kernel {
  static constexpr size_t kSmem = Tile<BM, BN, WM>::kSmem;

  // the kernel of a call: the 5x5 one for k = 5
  static void (*pick(int k))(const Conv) {
    return k == 5 ? conv2d_nhwc_k5_tf32x3_kernel<BM, BN, WM, kVec>
                  : conv2d_nhwc_tf32x3_kernel<BM, BN, WM, kVec>;
  }

  static int launch(const Conv& p, cudaStream_t stream) {
    const auto fn = pick(p.k);
    // raises the kernel's shared-memory limit to what it asks for
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const long long M = (long long)p.B * p.H * p.W;
    const dim3 grid((unsigned)((M + BM - 1) / BM),
                    (unsigned)((p.N + BN - 1) / BN));
    fn<<<grid, kThreads, kSmem, stream>>>(p);
    return (int)cudaGetLastError();
  }
};

// f(Kernel<...>{}) for tile `tile`; returns f's result, or `none`.
template <bool kVec, typename F, typename R>
R with_tile(int tile, F f, R none) {
  switch (tile) {
    case 0: return f(Kernel<96, 224, 2, kVec>{});
    case 1: return f(Kernel<96, 128, 2, kVec>{});
    case 2: return f(Kernel<96, 64, 2, kVec>{});
    case 3: return f(Kernel<64, 64, 2, kVec>{});
    default: return none;
  }
}

template <typename F, typename R>
R with_kernel(int tile, int vec, F f, R none) {
  return vec ? with_tile<true>(tile, f, none) : with_tile<false>(tile, f, none);
}

}  // namespace

extern "C" {

// x: (B, H, W) pixels `ldx` floats apart, C channels each (a channels-last
// view: ldx >= C); w: the weight packed as (N, taps, Cp), Cp = C rounded
// up to 32, zeros past C; bias: (N) or null; out: (B, H, W, N) contiguous.
// k is 1, 3 or 5 (padding k / 2); odd 1 (5x5 only): the taps are the 12
// with r + s odd, in order, else all k * k. act 0 none, 1 GELU (exact
// erf), 2 ReLU. vec: 16-byte loads of x (C and ldx multiples of 4, x
// 16-byte aligned); w 16-byte aligned. Returns the CUDA error of the
// launch.
int dcae_conv2d_nhwc(const void* x, const void* w, const void* bias,
                     void* out, int B, int H, int W, int C, int ldx, int N,
                     int k, int odd, int Cp, int act, int tile, int vec,
                     void* stream) {
  const Conv p{(const float*)x, (const float*)w, (const float*)bias,
               (float*)out, B, H, W, C, ldx, N, k, Cp, act, odd};
  if ((k != 1 && k != 3 && k != 5) || (odd != 0 && (odd != 1 || k != 5)) ||
      Cp % kBK || Cp < C || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  return with_kernel(tile, vec, [&](auto kern) {
    return kern.launch(p, (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}

}  // extern "C"
