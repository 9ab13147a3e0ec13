// K-lane interleaved rANS on the card: decode and encode of one slice's
// stream, bit for bit the format of native/rans.cpp
// (dcae_rans_encode_interleaved / dcae_rans_decode_interleaved).
//
// Counterpart of the two XLA loops of the JAX package
// (dcae_tpu/entropy/device_decode.py: _decode_interleaved and _encode_core,
// lax.fori_loop over (K,)-lane vectors). Eager PyTorch has no loop that
// stays on the device, so each loop is one kernel here.
//
// Format: symbol i rides lane i % K; a lane's state is a uint32, renorm
// words are 16 bits, and all lanes share ONE word stream. In step t the
// lanes 0..K-1 handle symbols t*K .. t*K+K-1; the lanes that renorm in a
// step take consecutive words, in lane order when decoding. The encoder
// walks the steps backwards and emits in descending lane order, so the
// reversed emission is the stream the decoder reads forwards.
//
// What bounds them: neither bytes nor operations but latency. A slice is a
// dependent chain of T = ceil(n / K) steps; a decode step is a gather from
// the 2^16-slot table (L2 or HBM latency), a block-wide prefix sum (one
// barrier) and a word load; an encode step is a 32-bit division and the
// prefix sum. One block walks the chain: lane j is thread j with its state
// in a register (K <= 1024, every K the codec picks). The loads that do
// not depend on the state (coding indexes; bucket positions and the
// (start | freq) words of the encoder) are issued one and two steps ahead.
// The prefix sum is ballot + popc inside a warp and one shared-memory pass
// across warps, double-buffered so a step needs one barrier. Any larger K
// that the container's 16-bit field can carry runs the *_wide kernels: a
// thread walks lanes tid, tid + 1024, ... with the states in global memory.
//
// Plain-C entries return the launch's cudaError_t; nothing synchronizes or
// allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSlots = 1u << 16;
constexpr uint32_t kRansL = 1u << 16;   // a lane's state at the encoder's start
constexpr int kMaxThreads = 1024;

struct Scan {
  int rank;    // flagged threads before this one (after it, if reversed)
  int total;   // flagged threads of the block
};

// Exclusive count of the block's flagged threads in thread order (reversed:
// in descending thread order). Every thread of the block calls it; `tot` is
// this step's 32-int buffer (the caller alternates two).
template <bool kReverse>
__device__ __forceinline__ Scan block_scan(bool flag, int* tot, int n_warps) {
  const int lid = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  const int in_warp = kReverse ? (lid == 31 ? 0 : __popc(b >> (lid + 1)))
                               : __popc(b & ((1u << lid) - 1u));
  if (lid == 0) tot[wid] = __popc(b);
  __syncthreads();
  const int v = lid < n_warps ? tot[lid] : 0;
  const bool counts = kReverse ? lid > wid : lid < wid;
  const int before = __reduce_add_sync(0xffffffffu, counts ? v : 0);
  const int total = __reduce_add_sync(0xffffffffu, v);
  return {before + in_warp, total};
}

// One table lookup of the decoder: the packed (slot - start) | (freq - 1)
// << 16 word and the decoded symbol. Paired layout: lut_b holds (df, bucket
// position) pairs and lut_a the rows' symbol offsets; classic layout: lut_b
// holds df and lut_a the symbol itself, both by idx * 2^16 + slot.
template <bool kPaired>
__device__ __forceinline__ void lookup(const int* __restrict__ lut_a,
                                       const uint32_t* __restrict__ lut_b,
                                       int idx, uint32_t slot, uint32_t& df,
                                       int& sym) {
  const size_t flat = (size_t)idx * kSlots + slot;
  if (kPaired) {
    const uint2 p = reinterpret_cast<const uint2*>(lut_b)[flat];
    df = p.x;
    sym = (int)p.y + lut_a[idx];
  } else {
    df = lut_b[flat];
    sym = lut_a[flat];
  }
}

// ---- decode, one lane a thread ----------------------------------------
template <bool kPaired>
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_decode_kernel(
    const uint16_t* __restrict__ words, const int* __restrict__ n_words_p,
    int words_len, const uint32_t* __restrict__ states_in,
    const int* __restrict__ indexes, const int* __restrict__ lut_a,
    const uint32_t* __restrict__ lut_b, int* __restrict__ syms,
    uint32_t* __restrict__ states_out, int* __restrict__ ok_out, int n, int K,
    int rows, int check_base) {
  __shared__ int tot[2][32];
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int n_words = *n_words_p;
  const int limit = min(n_words, words_len);
  const int T = (int)(((long long)n + K - 1) / K);
  uint32_t x = tid < K ? states_in[tid] : 0u;
  int ptr = 0;
  bool bad = false;
  int idx_next = (tid < K && tid < n) ? indexes[tid] : 0;
  for (int t = 0; t < T; ++t) {
    const long long i = (long long)t * K + tid;
    const bool active = tid < K && i < n;
    int idx = idx_next;
    // the next step's coding index does not depend on the state: ask now
    idx_next = (tid < K && i + K < n) ? indexes[i + K] : 0;
    bool need = false;
    uint32_t x2 = x;
    if (active) {
      if (idx < 0 || idx >= rows) {   // no such CDF row: a corrupt input
        bad = true;
        idx = 0;
      }
      uint32_t df;
      int sym;
      lookup<kPaired>(lut_a, lut_b, idx, x & 0xFFFFu, df, sym);
      syms[i] = sym;
      x2 = ((df >> 16) + 1u) * (x >> 16) + (df & 0xFFFFu);
      need = x2 < kRansL;
    }
    const Scan s = block_scan<false>(need, tot[t & 1], n_warps);
    if (need) {
      const int p = ptr + s.rank;
      // past the stream's end: a corrupt stream; ptr then ends past n_words
      x2 = (x2 << 16) | (p < limit ? (uint32_t)words[p] : 0u);
    }
    ptr += s.total;
    x = x2;
  }
  bool good = !bad;
  if (tid < K) {
    states_out[tid] = x;
    if (check_base && x != kRansL) good = false;
  }
  const int all_good = __syncthreads_and(good);
  if (tid == 0) *ok_out = (all_good && ptr == n_words) ? 1 : 0;
}

// ---- decode, any K: a thread walks lanes tid, tid + blockDim, ... -------
template <bool kPaired>
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_decode_wide_kernel(
    const uint16_t* __restrict__ words, const int* __restrict__ n_words_p,
    int words_len, const uint32_t* __restrict__ states_in,
    const int* __restrict__ indexes, const int* __restrict__ lut_a,
    const uint32_t* __restrict__ lut_b, int* __restrict__ syms,
    uint32_t* states_out, int* __restrict__ ok_out, int n, int K, int rows,
    int check_base) {
  __shared__ int tot[2][32];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int n_warps = bd >> 5;
  const int chunks = (K + bd - 1) / bd;
  const int n_words = *n_words_p;
  const int limit = min(n_words, words_len);
  const int T = (int)(((long long)n + K - 1) / K);
  // states_out is the working array: a lane is always read and written by
  // the same thread
  for (int lane = tid; lane < K; lane += bd) states_out[lane] = states_in[lane];
  int ptr = 0;
  bool bad = false;
  unsigned step = 0;
  for (int t = 0; t < T; ++t) {
    for (int c = 0; c < chunks; ++c, ++step) {
      const int lane = c * bd + tid;
      const long long i = (long long)t * K + lane;
      const bool active = lane < K && i < n;
      bool need = false;
      uint32_t x2 = 0;
      if (active) {
        const uint32_t x = states_out[lane];
        int idx = indexes[i];
        if (idx < 0 || idx >= rows) {
          bad = true;
          idx = 0;
        }
        uint32_t df;
        int sym;
        lookup<kPaired>(lut_a, lut_b, idx, x & 0xFFFFu, df, sym);
        syms[i] = sym;
        x2 = ((df >> 16) + 1u) * (x >> 16) + (df & 0xFFFFu);
        need = x2 < kRansL;
      }
      const Scan s = block_scan<false>(need, tot[step & 1], n_warps);
      if (need) {
        const int p = ptr + s.rank;
        x2 = (x2 << 16) | (p < limit ? (uint32_t)words[p] : 0u);
      }
      ptr += s.total;
      if (active) states_out[lane] = x2;
    }
  }
  bool good = !bad;
  if (check_base)
    for (int lane = tid; lane < K; lane += bd)
      if (states_out[lane] != kRansL) good = false;
  const int all_good = __syncthreads_and(good);
  if (tid == 0) *ok_out = (all_good && ptr == n_words) ? 1 : 0;
}

// ---- encode -----------------------------------------------------------
// What the encoder reads of a symbol before it touches the lane's state.
struct RawSym {
  int row, pos;
  bool in_range, active;
};

struct CodedSym {
  uint32_t start, freq;
  bool active, escape;
};

__device__ __forceinline__ RawSym load_raw(const int* __restrict__ pos,
                                           const int* __restrict__ idx,
                                           const uint8_t* __restrict__ in_range,
                                           long long i, bool active) {
  RawSym r = {0, 0, false, active};
  if (active) {
    r.row = idx[i];
    r.pos = pos[i];
    r.in_range = in_range[i] != 0;
  }
  return r;
}

// The (start | freq << 16) word of a symbol's bucket. freq is the TRUE
// width: 0 marks a zero-width bucket, which escapes like a row without
// in-range buckets; the division then runs on 1.
__device__ __forceinline__ CodedSym gather_sf(
    const uint32_t* __restrict__ enc_sf, const RawSym& r, int stride,
    int rows) {
  CodedSym c = {0u, 1u, r.active, false};
  if (r.active) {
    const int row = min(max(r.row, 0), rows - 1);
    const int p = min(max(r.pos, 0), stride - 1);
    const uint32_t sf = enc_sf[(size_t)row * stride + p];
    c.start = sf & 0xFFFFu;
    const uint32_t freq = sf >> 16;
    c.escape = !r.in_range || freq == 0u;
    c.freq = max(freq, 1u);
  }
  return c;
}

// One lane a thread. Walks t = T-1 .. 0; in a step the renorming lanes emit
// in DESCENDING lane order, so word `ptr + (renorming lanes above mine)` is
// this lane's: words_out is in emission order, and the byte stream is its
// reversed prefix of n_words words.
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_encode_kernel(
    const int* __restrict__ pos, const int* __restrict__ idx,
    const uint8_t* __restrict__ in_range, const uint32_t* __restrict__ enc_sf,
    const uint32_t* __restrict__ init_states, uint16_t* __restrict__ words_out,
    int* __restrict__ n_words_out, uint32_t* __restrict__ states_out,
    int* __restrict__ escape_out, int n, int K, int stride, int rows,
    int cap) {
  __shared__ int tot[2][32];
  const int tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const int T = (int)(((long long)n + K - 1) / K);
  const bool lane_ok = tid < K;
  uint32_t x = (lane_ok && init_states != nullptr) ? init_states[tid] : kRansL;
  int ptr = 0;
  bool esc = false;
  auto at = [&](int t) { return (long long)t * K + tid; };
  auto live = [&](int t) { return lane_ok && t >= 0 && at(t) < n; };
  // two steps of loads in flight: raw inputs of step t-2, the table word of
  // step t-1, while step t computes
  CodedSym cur = gather_sf(
      enc_sf, load_raw(pos, idx, in_range, at(T - 1), live(T - 1)), stride,
      rows);
  RawSym raw = load_raw(pos, idx, in_range, at(T - 2), live(T - 2));
  for (int t = T - 1; t >= 0; --t) {
    const RawSym raw_next =
        load_raw(pos, idx, in_range, at(t - 2), live(t - 2));
    const CodedSym next = gather_sf(enc_sf, raw, stride, rows);
    esc = esc || cur.escape;
    const bool need = cur.active && (x >> 16) >= cur.freq;
    const Scan s = block_scan<true>(need, tot[t & 1], n_warps);
    if (need) {
      words_out[ptr + s.rank] = (uint16_t)(x & 0xFFFFu);
      x >>= 16;
    }
    ptr += s.total;
    if (cur.active) x = ((x / cur.freq) << 16) + (x % cur.freq) + cur.start;
    cur = next;
    raw = raw_next;
  }
  if (lane_ok) states_out[tid] = x;
  for (int p = ptr + tid; p < cap; p += blockDim.x) words_out[p] = 0;
  const int any_esc = __syncthreads_or(esc);
  if (tid == 0) {
    *n_words_out = ptr;
    *escape_out = any_esc ? 1 : 0;
  }
}

// Any K: lanes in chunks of blockDim, highest chunk first, states in global
// memory (states_out is the working array).
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_encode_wide_kernel(
    const int* __restrict__ pos, const int* __restrict__ idx,
    const uint8_t* __restrict__ in_range, const uint32_t* __restrict__ enc_sf,
    const uint32_t* __restrict__ init_states, uint16_t* __restrict__ words_out,
    int* __restrict__ n_words_out, uint32_t* states_out,
    int* __restrict__ escape_out, int n, int K, int stride, int rows,
    int cap) {
  __shared__ int tot[2][32];
  const int tid = threadIdx.x, bd = blockDim.x;
  const int n_warps = bd >> 5;
  const int chunks = (K + bd - 1) / bd;
  const int T = (int)(((long long)n + K - 1) / K);
  for (int lane = tid; lane < K; lane += bd)
    states_out[lane] = init_states != nullptr ? init_states[lane] : kRansL;
  int ptr = 0;
  bool esc = false;
  unsigned step = 0;
  for (int t = T - 1; t >= 0; --t) {
    for (int c = chunks - 1; c >= 0; --c, ++step) {
      const int lane = c * bd + tid;
      const long long i = (long long)t * K + lane;
      const bool active = lane < K && i < n;
      const CodedSym cur = gather_sf(
          enc_sf, load_raw(pos, idx, in_range, i, active), stride, rows);
      esc = esc || cur.escape;
      uint32_t x = active ? states_out[lane] : 0u;
      const bool need = active && (x >> 16) >= cur.freq;
      const Scan s = block_scan<true>(need, tot[step & 1], n_warps);
      if (need) {
        words_out[ptr + s.rank] = (uint16_t)(x & 0xFFFFu);
        x >>= 16;
      }
      ptr += s.total;
      if (active)
        states_out[lane] =
            ((x / cur.freq) << 16) + (x % cur.freq) + cur.start;
    }
  }
  for (int p = ptr + tid; p < cap; p += bd) words_out[p] = 0;
  const int any_esc = __syncthreads_or(esc);
  if (tid == 0) {
    *n_words_out = ptr;
    *escape_out = any_esc ? 1 : 0;
  }
}

// One lane a thread, in whole warps.
int block_threads(int K) {
  return K >= kMaxThreads ? kMaxThreads : (K + 31) / 32 * 32;
}

}  // namespace

extern "C" {

// Decode n symbols of one slice. words: uint16 (words_len), *n_words the
// stream's true length; states_in / states_out: uint32 (K); indexes: int32
// (n); paired: lut_a = row offsets int32 (rows), lut_b = (df, pos) uint32
// pairs (rows * 2^16, 2); classic: lut_a = symbols int32, lut_b = df uint32
// (rows * 2^16 each). Writes syms (n), the final lane states and *ok = the
// stream was consumed exactly and, with check_base, every lane is back at
// 2^16. No word past min(n_words, words_len) is read.
int dcae_rans_lanes_decode(const void* words, const void* n_words,
                           const void* states_in, const void* indexes,
                           const void* lut_a, const void* lut_b, void* syms,
                           void* states_out, void* ok_out, int words_len,
                           int n, int K, int rows, int paired, int check_base,
                           void* stream) {
  if (K < 1 || n < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(K);
#define DCAE_DECODE_ARGS                                                      \
  static_cast<const uint16_t*>(words), static_cast<const int*>(n_words),      \
      words_len, static_cast<const uint32_t*>(states_in),                     \
      static_cast<const int*>(indexes), static_cast<const int*>(lut_a),       \
      static_cast<const uint32_t*>(lut_b), static_cast<int*>(syms),           \
      static_cast<uint32_t*>(states_out), static_cast<int*>(ok_out), n, K,    \
      rows, check_base
  if (K <= kMaxThreads) {
    if (paired)
      rans_lanes_decode_kernel<true><<<1, threads, 0, st>>>(DCAE_DECODE_ARGS);
    else
      rans_lanes_decode_kernel<false><<<1, threads, 0, st>>>(DCAE_DECODE_ARGS);
  } else {
    if (paired)
      rans_lanes_decode_wide_kernel<true>
          <<<1, threads, 0, st>>>(DCAE_DECODE_ARGS);
    else
      rans_lanes_decode_wide_kernel<false>
          <<<1, threads, 0, st>>>(DCAE_DECODE_ARGS);
  }
#undef DCAE_DECODE_ARGS
  return (int)cudaGetLastError();
}

// Encode n symbols of one slice. pos: int32 (n) bucket positions, clamped
// into the row's in-range buckets; idx: int32 (n) CDF rows; in_range: uint8
// (n), 0 where the row has no in-range bucket; enc_sf: uint32 (rows *
// stride) start | freq << 16; init_states: uint32 (K) or null for the 2^16
// base. Writes words_out uint16 (cap >= n) in emission order, zero past
// *n_words_out, the decode-start states and *escape_out.
int dcae_rans_lanes_encode(const void* pos, const void* idx,
                           const void* in_range, const void* enc_sf,
                           const void* init_states, void* words_out,
                           void* n_words_out, void* states_out,
                           void* escape_out, int n, int K, int stride,
                           int rows, int cap, void* stream) {
  if (K < 1 || n < 0 || rows < 1 || stride < 1 || cap < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(K);
#define DCAE_ENCODE_ARGS                                                      \
  static_cast<const int*>(pos), static_cast<const int*>(idx),                 \
      static_cast<const uint8_t*>(in_range),                                  \
      static_cast<const uint32_t*>(enc_sf),                                   \
      static_cast<const uint32_t*>(init_states),                              \
      static_cast<uint16_t*>(words_out), static_cast<int*>(n_words_out),      \
      static_cast<uint32_t*>(states_out), static_cast<int*>(escape_out), n,   \
      K, stride, rows, cap
  if (K <= kMaxThreads)
    rans_lanes_encode_kernel<<<1, threads, 0, st>>>(DCAE_ENCODE_ARGS);
  else
    rans_lanes_encode_wide_kernel<<<1, threads, 0, st>>>(DCAE_ENCODE_ARGS);
#undef DCAE_ENCODE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
