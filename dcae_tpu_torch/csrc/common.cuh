// Helpers shared by the port's CUDA kernels: f32 <-> storage-type
// conversion, the bf16 operand rounding the TPU kernels apply at their
// matmul inputs, warp reductions and LayerNorm, the
// bf16 and 3xTF32 tensor-core fragment helpers (mma.sync), cp.async and
// bulk copies, and the Hopper warpgroup product (wgmma) with its operand
// layout.
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

// ---- 3xTF32 (f32-class products on the tf32 tensor cores).
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

// Two consecutive bf16 (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 16-byte matrices from shared memory (ldmatrix.x4): lanes 8 i ..
// 8 i + 7 give the row addresses of matrix i, and r[i] holds, in lane l,
// the 4 bytes at column l % 4 of row l / 4: the (g, q) element of an mma
// fragment, for bf16 pairs and tf32 alike.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// The B fragment of m16n8k16 from a row-major (k, n) bf16 tile: lanes 0-7
// give the addresses of rows k..k+7 at column n, lanes 8-15 those of rows
// k+8..k+15 (ldmatrix.x2.trans).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t b[2],
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// ---- asynchronous global -> shared copies (cp.async, 16 bytes a thread)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The same, or 16 bytes of zeros when `valid` is false (nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- Hopper bulk copies (the TMA engine, no tensor map) completing on an
// mbarrier in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}

// Arrive on `bar` and expect `bytes` more of copies to land in its phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
      "l"(gmem), "r"(bytes),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// ---- Hopper warpgroup products (wgmma, sm_90a) on bf16 operands in shared
// memory, without swizzle. Both operands are K-major and stored as 8 x 8
// core matrices of 128 contiguous bytes (8 rows of 16 bytes): element
// (r, k) of a rows x K operand sits at blocked(r, k, K). A k16 step reads
// two core matrices along K (LBO = 128 bytes apart) for every 8 rows (SBO
// = 16 K bytes apart).
__device__ __forceinline__ int blocked(int r, int k, int K) {
  return ((r >> 3) * (K >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// Descriptor of an operand of core matrices starting at `p` (16-byte
// aligned): `lbo` bytes from a core matrix to the next along K, `sbo` bytes
// to the next 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc_strided(const void* p,
                                                       uint64_t lbo,
                                                       uint64_t sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

// Descriptor of a blocked operand starting at `p` (16-byte aligned), K wide.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int K) {
  return wgmma_desc_strided(p, 128, 16 * (uint64_t)K);
}

// The same core matrices in the order a GEMM tile streams them: a rows x K
// operand is cut into tiles of kTileRows rows, and inside a tile the core
// matrices of one 8-wide K step (all 16 row groups, 2 KB) are contiguous,
// K step after K step. So any K-slice of a tile is one contiguous piece
// (one bulk copy), and in shared memory a slice has lbo = 2 KB, sbo = 128 B.
constexpr int kTileRows = 128;
constexpr int kTileLbo = kTileRows / 8 * 128;   // bytes between K steps

__host__ __device__ __forceinline__ size_t tiled(int r, int k, int K) {
  return (size_t)(r / kTileRows) * kTileRows * K +
         (size_t)((k >> 3) * (kTileRows / 8) + ((r % kTileRows) >> 3)) * 64 +
         (r & 7) * 8 + (k & 7);
}

// Writes of the generic proxy (stores, cp.async) to shared memory become
// visible to the async proxy that wgmma reads through; before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

// D(64 x 32, f32) += A(64 x 16) B(32 x 16)^T by one warpgroup. Warp w of the
// group holds rows 16 w.. of D: d[4 j + e] as an m16n8 tile j (columns
// 8 j..) in the mma.sync D layout.
__device__ __forceinline__ void wgmma_m64n32k16(float d[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// D(64 x 128, f32) += A(64 x 16) B(128 x 16)^T by one warpgroup: d[4 j + e]
// as for m64n32k16, with j up to 16.
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
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
