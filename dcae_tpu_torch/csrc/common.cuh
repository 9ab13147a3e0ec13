// Helpers shared by the port's CUDA kernels: f32 <-> storage-type
// conversion, the bf16 operand rounding the TPU kernels apply at their
// matmul inputs, warp reductions and LayerNorm, 4-wide f32 loads, and the
// bf16 tensor-core (mma.sync) fragment helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcae {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the matmul operand precision: bf16 callers feed bf16 operands
// (f32 accumulation), f32 callers keep f32.
template <typename T>
__device__ __forceinline__ float op_round(float v) {
  return to_f<T>(from_f<T>(v));
}

// Four consecutive floats starting at a 4-element-aligned index.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// ---- bf16 tensor-core tile product: D(16x8, f32) += A(16x16) B(16x8).
// Fragments as the PTX ISA lays out mma.m16n8k16 (lane = 4 * g + q):
//   A regs {a0..a3}: (row g, k 2q..2q+1), (row g+8, k 2q..), (row g,
//     k 2q+8..), (row g+8, k 2q+8..) - two bf16 per register;
//   B regs {b0, b1}: (k 2q..2q+1, col g), (k 2q+8.., col g);
//   D {d0..d3}: (row g, col 2q..2q+1), (row g+8, col 2q..2q+1).
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows (row_lo, row_hi) = (g, g+8) of a row-major bf16 tile
// at column k.
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* row_lo,
                                       const __nv_bfloat16* row_hi, int k,
                                       int q) {
  a[0] = ld_pair(row_lo + k + 2 * q);
  a[1] = ld_pair(row_hi + k + 2 * q);
  a[2] = ld_pair(row_lo + k + 2 * q + 8);
  a[3] = ld_pair(row_hi + k + 2 * q + 8);
}

// B fragment from a torch-layout weight row (out channel g of the n-tile,
// input channels contiguous) at input channel k.
__device__ __forceinline__ void load_b(uint32_t b[2],
                                       const __nv_bfloat16* wrow, int k,
                                       int q) {
  b[0] = ld_pair(wrow + k + 2 * q);
  b[1] = ld_pair(wrow + k + 2 * q + 8);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm (eps 1e-5, f32 statistics) of one C-wide row by one warp:
// reads `src` (global), writes the normalized row, rounded to the operand
// precision, into `dst` (shared). Without `ln`, copies the row.
template <typename T>
__device__ __forceinline__ void warp_layernorm_row(
    const T* __restrict__ src, const T* __restrict__ ln_w,
    const T* __restrict__ ln_b, float* dst, int C, bool ln, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f<T>(src[c]);
    dst[c] = v;
    s += v;
  }
  if (!ln) {
    for (int c = lane; c < C; c += 32) dst[c] = op_round<T>(dst[c]);
    return;
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = dst[c] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
  for (int c = lane; c < C; c += 32)
    dst[c] = op_round<T>((dst[c] - mean) * rstd * to_f<T>(ln_w[c]) +
                         to_f<T>(ln_b[c]));
}

}  // namespace dcae
