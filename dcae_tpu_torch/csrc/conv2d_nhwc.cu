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
// output pixels, N = C_out, K = taps x C_in), one BM x BN output tile a
// block, warp-specialised on Hopper's warpgroup products (wgmma, the only
// way to the tensor cores' full rate):
//  * the weight is packed and split once, by the wrapper, into hi and lo
//    (C_out, taps, C_in rounded up to 32), zeros past C_in; a K slice of 32
//    floats is one 128-byte row, so a stage's B hi and lo tiles are two TMA
//    loads with the 128-byte swizzle that wgmma reads, rows past C_out
//    filled with zeros by the TMA;
//  * one producer warpgroup fills a ring of stages under full / empty
//    mbarriers. The A slice is one tap's 32 channels of BM pixels. For a
//    stride-1 tap those are BM consecutive pixels of x, shifted by the
//    tap, so one thread brings them as one TMA box (zeros past C_in and
//    outside the tensor) beside the weight's boxes, and three warps zero
//    the rows whose tap leaves the image once the box has landed: no
//    padded copy of x, and the gather costs the producer a few
//    instructions a row (on an H100, 16-byte cp.async a piece held the
//    slice nets' first layer at ~0.66 ms, the TMA at ~0.49). Where C_in % 4
//    != 0 or the view is unaligned the TMA cannot read x, and the whole
//    warpgroup gathers the slice with 4-byte cp.async, zero-filling the
//    border and the channels past C_in;
//  * each of WGS consumer warpgroups owns 64 rows x BN: it loads its A
//    fragments with ldmatrix, splits them into hi and lo in registers, and
//    runs wgmma m64nBNk8 (tf32, A from registers, B hi or lo from shared
//    memory) lo*hi, hi*lo, hi*hi into its partial, which it adds to its
//    f32 accumulator; while one warpgroup waits for its partial the others'
//    products keep the tensor cores busy. At three consumer warpgroups the
//    producer gives up registers to them (setmaxnreg): 56 accumulator and
//    56 partial registers a thread at BN = 112.
// The epilogue adds the bias, applies the activation and writes each output
// once, in NHWC: no layout transposes, no separate activation pass.
//
// One body, two kernels: conv2d_nhwc_tf32x3_kernel takes 1x1 and 3x3 (k at
// run time), conv2d_nhwc_k5_tf32x3_kernel takes 5x5 (k a constant, the
// tap set at run time), so that a device trace tells the 5x5 launches
// apart by name.
//
// Tile shapes (WGS consumer warpgroups, BN) are template parameters and the
// wrapper picks one per call from the shape it sees, by the waves of tiles
// it fills on the card's SMs. Determinism: no split-K, no atomics. Every
// output is one warpgroup's sum over k-steps in the fixed order above,
// which depends on C_in, k and the tap set alone, not on B, H, W or the
// tile shape, so a pixel's output is bitwise the same in a batch of 8 as
// alone, and from launch to launch.
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::split_tf32;

constexpr int kBK = 32;              // K columns a stage: one tap's channels
constexpr int kPieces = kBK / 4;     // 16-byte pieces a staged row
constexpr int kWG = 128;             // threads a warpgroup
// k-steps of 8 whose products sum in one partial before it is added to the
// accumulator: the tensor cores' truncating sum then covers 48 products
// that start from zero, never the running total (measured on an H100
// against f64: 1.3e-6 of max at K = 10,944 on mma.sync, 1.2e-6 to 2.2e-6
// at K = 8,640 to 11,520 on wgmma, against 1.8e-6 with a partial a k-step
// and 8.5e-5 with none), and each accumulator takes half the f32 adds
constexpr int kSteps = 2;
// registers a thread of the producer and of a consumer warpgroup keep at
// three consumers: 32 + 3 x 160 = 512 of the block's 4 x 128
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;

enum Act { kNone = 0, kGelu = 1, kRelu = 2 };

struct Conv {
  const float* x;       // (B, H, W) pixels, ldx floats apart, C channels
  const float* bias;    // (N) or null
  float* out;           // (B, H, W, N) contiguous
  int B, H, W, C, ldx, N, k, Cp, act;
  int odd;              // 5x5 only: 1 runs the 12 taps with r + s odd
};

template <int kWGS, int kBN>
struct Tile {
  static constexpr int WGS = kWGS, BN = kBN, BM = 64 * WGS;
  static constexpr int kThreads = kWG * (WGS + 1);
  // one consumer warpgroup (at most 64 columns) fits two blocks on an SM
  static constexpr int kMinBlocks = WGS == 1 ? 2 : 1;
  static constexpr int kABytes = BM * kBK * 4;
  static constexpr int kBBytes = BN * kBK * 4;          // hi or lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kBudget = (kMinBlocks == 2 ? 110 : 224) * 1024;
  static constexpr int kFit = kBudget / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  // the ring (1024-byte aligned: the swizzle's atom), then a full, an empty
  // and an A-landed barrier a stage, then (h, w) of each of the tile's rows
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024 +
                                  24 * kStages + 8 * BM;
  static constexpr bool kRebalance = WGS == 3;
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma's N");
  static_assert(WGS == 3 || BN <= 64, "one consumer: two blocks an SM");
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0,
                "stages keep the swizzle atom's alignment");
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kWG % kPieces == 0 && BM % (kWG / kPieces) == 0,
                "whole rows a producer thread");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// Arrive on `bar` once every cp.async this thread started has landed; the
// arrival is one of those the barrier was initialised to expect.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the phase of `bar` with this parity. A wait that outlasts ~10 s
// of the SM's clock traps: a stuck pipeline fails the launch with an error
// and never holds the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// A 2D box of the tensor map `map` at (c0 innermost, c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* smem, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Descriptor of a K-major wgmma operand of 128-byte rows in the 128-byte
// swizzle, as the TMA writes it: 8-row atoms of 1024 bytes (SBO), the
// start 1024-byte aligned; a k-step of 8 tf32 (32 bytes) further along K is
// the descriptor plus 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The registers of `d` are written by the products in flight until their
// wait: reads of them stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGelu) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

// D(64 x N, f32) = A(64 x 8, tf32, registers) B(N x 8, tf32, shared)^T
// (+ D where scale_d != 0) by one warpgroup. A's registers in each warp
// (rows 16 w..) as mma.sync m16n8k8 lays them out: (g, q), (g + 8, q),
// (g, q + 4), (g + 8, q + 4) for lane 4 g + q; d[4 j + e] as the m16n8
// tile j (columns 8 j..) of the mma.sync D layout.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t a[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t a[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t a[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
  }
};

// Offset in floats of element (r, c) of a stage's A rows (32 floats each)
// in the 128-byte swizzle, as the TMA writes them: the 16-byte piece c / 4
// of row r sits at piece (c / 4) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kBK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// One BM x BN output tile a block; grid (ceil(M / BM), ceil(N / BN)).
// kVec: C % 4 == 0 and ldx % 4 == 0 and x 16-byte aligned; xa then maps x
// as M pixels (ldx floats apart) of C channels, boxes of 32 channels x BM
// pixels in the 128-byte swizzle. KS: 0, k from p (1 or 3, every tap); or
// 5, a 5x5 whose taps are every one, or those with r + s odd (p.odd), whose
// linear index r * 5 + s is then odd too: tap t of the packed weight sits
// at 2 t + 1. whi / wlo: the packed weight's hi and lo halves as (N, taps x
// Cp) tensor maps, boxes of 32 x BN in the same swizzle.
template <typename T, bool kVec, int KS>
__device__ __forceinline__ void conv_tile(const Conv& p,
                                          const CUtensorMap* xa,
                                          const CUtensorMap* whi,
                                          const CUtensorMap* wlo) {
  constexpr int S = T::kStages, BM = T::BM, BN = T::BN, WGS = T::WGS;
  // producer threads that put a stage's A rows in place: warps 1-3 zeroing
  // after the TMA (kVec), else the whole warpgroup gathering
  constexpr int kFillers = kVec ? kWG - 32 : kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * T::kStageBytes);
  uint64_t* empty = full + S;
  uint64_t* landed = empty + S;          // a stage's A box (kVec)
  int2* rows = reinterpret_cast<int2*>(landed + S);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int M = p.B * p.H * p.W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k = KS ? KS : p.k;
  const int taps = KS && p.odd ? KS * KS / 2 : k * k;
  const int pad = k / 2, cps = p.Cp / kBK, ktiles = taps * cps;

  // (h, w) of each row's output pixel; a row past M gets a height that no
  // tap brings inside the image
  for (int r = tid; r < BM; r += T::kThreads) {
    const int m = m0 + r;
    rows[r] = make_int2(m < M ? (m / p.W) % p.H : -(1 << 20), m % p.W);
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the fillers' arrivals and the arrival for the weight's TMA bytes
      dcae::mbar_init(&full[s], kFillers + 1);
      dcae::mbar_init(&empty[s], 4 * WGS);    // a consumer warp each
      dcae::mbar_init(&landed[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // ---- producer: slice kt into stage kt % S once its last use is done
    if constexpr (T::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    const int pt = tid - WGS * kWG;
    // the slice's tap offset and first channel
    auto slice = [&](int kt, int& dy, int& dx, int& c0) {
      const int t = kt / cps;
      const int tap = KS && p.odd ? 2 * t + 1 : t;
      c0 = (kt - t * cps) * kBK;
      dy = tap / k - pad;
      dx = tap % k - pad;
    };
    // the weight's hi and lo boxes; with kVec the A box too: the BM pixels
    // from m0 + dy W + dx on, which are the rows' taps wherever the tap
    // stays inside the image
    auto request = [&](int kt) {
      const int s = kt % S;
      if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
      uint8_t* st = ring + s * T::kStageBytes;
      dcae::mbar_expect(&full[s], 2 * T::kBBytes);
      tma_load(st + T::kABytes, whi, kt * kBK, n0, &full[s]);
      tma_load(st + T::kABytes + T::kBBytes, wlo, kt * kBK, n0, &full[s]);
      if (kVec) {
        int dy, dx, c0;
        slice(kt, dy, dx, c0);
        dcae::mbar_expect(&landed[s], T::kABytes);
        tma_load(st, xa, c0, m0 + dy * p.W + dx, &landed[s]);
      }
    };
    if (kVec) {
      // thread 0 requests the boxes, S slices ahead of the consumers; warps
      // 1-3 zero each slice's rows whose tap leaves the image as soon as it
      // lands, so the consumers never wait on a request
      if (pt == 0) {
        for (int kt = 0; kt < ktiles; ++kt) request(kt);
      } else if (pt >= 32) {
        const int f = pt - 32;
        for (int j = 0; j < ktiles; ++j) {
          const int s = j % S;
          int dy, dx, c0;
          slice(j, dy, dx, c0);
          mbar_wait(&landed[s], (j / S) & 1);
          float* as = reinterpret_cast<float*>(ring + s * T::kStageBytes);
          for (int r = f; r < BM; r += kFillers) {
            const int2 hw = rows[r];
            const int h = hw.x + dy, w = hw.y + dx;
            if (h < 0 || h >= p.H || w < 0 || w >= p.W) {
#pragma unroll
              for (int c = 0; c < kBK; c += 4)
                *reinterpret_cast<float4*>(as + r * kBK + c) =
                    make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
          dcae::fence_proxy_async();   // the zeros, before later TMA writes
          mbar_arrive(&full[s]);
        }
      }
    } else {
      // 4-byte copies, four to a thread's 16-byte piece of a row; rows
      // row0, row0 + 16, ...
      const int piece = pt % kPieces, row0 = pt / kPieces;
      for (int kt = 0; kt < ktiles; ++kt) {
        if (pt == 0) request(kt);
        else if (kt >= S) mbar_wait(&empty[kt % S], (kt / S - 1) & 1);
        int dy, dx, c0;
        slice(kt, dy, dx, c0);
        const int c = c0 + 4 * piece;
        float* as = reinterpret_cast<float*>(ring + (kt % S) * T::kStageBytes);
#pragma unroll 1
        for (int r = row0; r < BM; r += kWG / kPieces) {
          const int2 hw = rows[r];
          const int h = hw.x + dy, w = hw.y + dx;
          const bool in = h >= 0 && h < p.H && w >= 0 && w < p.W;
          const long long off =
              ((long long)(m0 + r) + dy * p.W + dx) * p.ldx + c;
          float* dst = as + swizzled(r, 4 * piece);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = in && c + e < p.C;
            cp_async4_zfill(dst + e, ok ? p.x + off + e : p.x, ok);
          }
        }
        cp_async_arrive(&full[kt % S]);
      }
      dcae::cp_async_wait<0>();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg.. of the tile
  if constexpr (T::kRebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  constexpr int ND = BN / 2;                  // accumulator registers
  const int lane = tid & 31, warp = (tid / 32) & 3;
  const int wm = wg * 64 + warp * 16;
  // this lane's ldmatrix row: matrices (rows 0-7, k..k+3), (rows 8-15, k..),
  // (rows 0-7, k+4..), (rows 8-15, k+4..) give A's four registers, its
  // row's swizzle is lane % 8
  const int a_row = (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * kBK;
  const int a_piece = lane >> 4, a_xor = lane & 7;
  float acc[ND], part[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e] = part[e] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint8_t* st = ring + s * T::kStageBytes;
    const float* as = reinterpret_cast<const float*>(st) + a_row;
    const uint64_t dhi = sw128_desc(st + T::kABytes);
    const uint64_t dlo = sw128_desc(st + T::kABytes + T::kBBytes);
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 8 * kSteps) {
      uint32_t ahi[kSteps][4], alo[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        uint32_t ar[4];
        const int piece = (k0 + 8 * j) / 4 + a_piece;
        dcae::ldmatrix_x4(ar, as + ((piece ^ a_xor) << 2));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(ar[e]), ahi[j][e], alo[j][e]);
      }
      // the three products of each k-step (small terms first) sum in a
      // fresh partial over kSteps k-steps, added to the accumulator in f32
      dcae::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kd = (k0 + 8 * j) * 4 / 16;    // 16-byte units along K
        Wgmma<BN>::mma(part, alo[j], dhi + kd, j > 0);
        Wgmma<BN>::mma(part, ahi[j], dlo + kd, 1);
        Wgmma<BN>::mma(part, ahi[j], dhi + kd, 1);
      }
      dcae::wgmma_commit();
      dcae::wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[e] += part[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);    // this warp is done with it
  }

  const int g = lane >> 2, q = lane & 3;
  const bool pairs = (p.N & 1) == 0;    // n even: float2 stores aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    if (n >= p.N) continue;
    const bool two = n + 1 < p.N;
    const float b0 = p.bias ? p.bias[n] : 0.f;
    const float b1 = p.bias && two ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + g + 8 * h;
      if (m >= M) continue;
      const float v0 = activate(acc[4 * j + 2 * h] + b0, p.act);
      const float v1 = activate(acc[4 * j + 2 * h + 1] + b1, p.act);
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv2d_nhwc_tf32x3_kernel(const Conv p, const __grid_constant__ CUtensorMap xa,
                          const __grid_constant__ CUtensorMap whi,
                          const __grid_constant__ CUtensorMap wlo) {
  conv_tile<T, kVec, 0>(p, &xa, &whi, &wlo);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv2d_nhwc_k5_tf32x3_kernel(const Conv p,
                             const __grid_constant__ CUtensorMap xa,
                             const __grid_constant__ CUtensorMap whi,
                             const __grid_constant__ CUtensorMap wlo) {
  conv_tile<T, kVec, 5>(p, &xa, &whi, &wlo);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      f = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The rows x cols f32 matrix at a (rows `ld` floats apart, 16-byte
// aligned) as TMA boxes of 32 columns x `box_rows` rows in the 128-byte
// swizzle; columns past `cols` and rows outside [0, rows) read as zeros.
int tile_map(CUtensorMap* map, const float* a, long long rows, int cols,
             long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tile shapes, by index (the wrapper's TILES lists the same, BM x BN):
//   0: 192 x 112, three consumer warpgroups   the slice nets' first layer
//   1: 192 x 64
//   2:  64 x 64, one consumer warpgroup, two blocks an SM   small M
//   3:  64 x 32                                             narrow calls

template <typename T, bool kVec>
struct Kernel {
  // the kernel of a call: the 5x5 one for k = 5
  static void (*pick(int k))(const Conv, const CUtensorMap, const CUtensorMap,
                             const CUtensorMap) {
    return k == 5 ? conv2d_nhwc_k5_tf32x3_kernel<T, kVec>
                  : conv2d_nhwc_tf32x3_kernel<T, kVec>;
  }

  static int launch(const Conv& p, const float* whi, const float* wlo,
                    cudaStream_t stream) {
    const int taps = p.k == 5 && p.odd ? 12 : p.k * p.k;
    const long long M = (long long)p.B * p.H * p.W;
    CUtensorMap mx{}, mhi, mlo;
    int err = tile_map(&mhi, whi, p.N, taps * p.Cp, taps * p.Cp, T::BN);
    if (!err) err = tile_map(&mlo, wlo, p.N, taps * p.Cp, taps * p.Cp, T::BN);
    if (!err && kVec) err = tile_map(&mx, p.x, M, p.C, p.ldx, T::BM);
    if (err) return err;
    const auto fn = pick(p.k);
    // raises the kernel's shared-memory limit to what it asks for
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err) return err;
    const dim3 grid((unsigned)((M + T::BM - 1) / T::BM),
                    (unsigned)((p.N + T::BN - 1) / T::BN));
    fn<<<grid, T::kThreads, T::kSmem, stream>>>(p, mx, mhi, mlo);
    return (int)cudaGetLastError();
  }
};

// f(Kernel<...>{}) for tile `tile`; returns f's result, or `none`.
template <bool kVec, typename F, typename R>
R with_tile(int tile, F f, R none) {
  switch (tile) {
    case 0: return f(Kernel<Tile<3, 112>, kVec>{});
    case 1: return f(Kernel<Tile<3, 64>, kVec>{});
    case 2: return f(Kernel<Tile<1, 64>, kVec>{});
    case 3: return f(Kernel<Tile<1, 32>, kVec>{});
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
// view: ldx >= C); whi, wlo: the weight packed as (N, taps, Cp), Cp = C
// rounded up to 32, zeros past C, and split into its tf32 hi and the rest
// (split_tf32), 16-byte aligned; bias: (N) or null; out: (B, H, W, N)
// contiguous. k is 1, 3 or 5 (padding k / 2); odd 1 (5x5 only): the taps
// are the 12 with r + s odd, in order, else all k * k. act 0 none, 1 GELU
// (exact erf), 2 ReLU. vec: 16-byte loads of x (C and ldx multiples of 4,
// x 16-byte aligned). Returns the CUDA error of the launch.
int dcae_conv2d_nhwc(const void* x, const void* whi, const void* wlo,
                     const void* bias, void* out, int B, int H, int W, int C,
                     int ldx, int N, int k, int odd, int Cp, int act,
                     int tile, int vec, void* stream) {
  const Conv p{(const float*)x, (const float*)bias, (float*)out, B, H, W,
               C, ldx, N, k, Cp, act, odd};
  if ((k != 1 && k != 3 && k != 5) || (odd != 0 && (odd != 1 || k != 5)) ||
      Cp % kBK || Cp < C || act < 0 || act > 2 ||
      ((uintptr_t)whi | (uintptr_t)wlo) % 16)
    return (int)cudaErrorInvalidValue;
  return with_kernel(tile, vec, [&](auto kern) {
    return kern.launch(p, (const float*)whi, (const float*)wlo,
                       (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}

}  // extern "C"
