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
// What bounds them: neither bytes nor operations but the latency of one
// step, since a slice is a dependent chain of T = ceil(n / K) steps walked
// by one block (lane j is thread j, its state in a register; K <= 1024,
// every K the codec picks). So a step touches global memory only where it
// must not wait for it:
//  * the row tables (build_row_tables, ~139 KB for the codec's 64-row
//    Gaussian bank) sit in dynamic shared memory, brought in by one bulk
//    copy on an mbarrier at the launch's start. A decode step finds its
//    bucket through the row's coarse index (the buckets of 256-slot cells)
//    and an interpolation search of the cell in shared memory; an encode
//    step reads its bucket word there;
//  * the decoder's word stream runs through a shared-memory ring of
//    kStages chunks, refilled by bulk copies as soon as the lanes are past
//    a chunk, so the word at ptr + rank is a shared-memory read;
//  * the inputs that do not depend on the state (coding indexes; the
//    encoder's bucket positions, rows and in-range flags) arrive kDepth
//    steps ahead by cp.async into per-thread slots, and what a step reads
//    of the tables through them is read a step ahead; outputs are plain
//    stores.
// Measured on an H100 this still leaves ~1000 SM cycles a step (PERF.md).
// The prefix sum is ballot + popc inside a warp and one shared-memory pass
// across warps, double-buffered so a step needs one barrier. Any larger K
// that the container's 16-bit field can carry runs the kWide kernels: a
// thread walks lanes tid, tid + 1024, ... with the states in global memory
// and the same tables, ring and prefetch.
//
// Plain-C entries return the launch's cudaError_t; nothing synchronizes or
// allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dcae::bulk_copy;
using dcae::mbar_expect;
using dcae::mbar_init;
using dcae::mbar_wait;

constexpr uint32_t kRansL = 1u << 16;   // a lane's state at the encoder's start
constexpr int kMaxThreads = 1024;
constexpr int kCellShift = 8;           // 256 slots a coarse cell
constexpr int kCoarse = (1 << (16 - kCellShift)) + 1;   // bounds a row
constexpr int kDepth = 4;               // steps of inputs in flight
constexpr int kSlots = kDepth + 1;      // their per-thread slots
constexpr int kChunk = 1024;            // stream words a bulk copy
constexpr int kStages = 8;              // chunks in the ring
constexpr int kRing = kChunk * kStages;
constexpr int kBars = 16 * ((kStages + 1 + 1) / 2);   // mbarrier bytes

// ---- row tables (build_row_tables in ops/kernels/rans_lanes.py), uint32
// words: [0, 4) rows, coarse_off, words_off, total; [4, 4 + 2 rows) each
// row's (base, nb): its first bucket word (from words_off) and its bucket
// count (cdf length - 1); from coarse_off, kCoarse uint16 a row: entry c <
// 256 the bucket of slot 256 c, entry 256 that of slot 65535, each as its
// word's index from words_off (a table that fits shared memory has fewer
// than 2^16 buckets); from words_off one word a bucket, start + (freq -
// 1) << 16 (mod 2^32). The
// decode table's df word for slot s in bucket b is s - start | (freq - 1)
// << 16, and the encode table's (start | freq << 16) is the word + 2^16.
struct Rows {
  const uint32_t* meta;
  const uint16_t* coarse;
  const uint32_t* words;
  int rows;
};

__device__ __forceinline__ Rows rows_at(const uint32_t* t) {
  return {t + 4, reinterpret_cast<const uint16_t*>(t + t[1]), t + t[2],
          (int)t[0]};
}

// The decoder's bucket of `slot` in `row`: the last bucket whose start is
// <= slot, as build_slot_tables maps the slots (a zero-width bucket is
// never chosen). Its cell's first bucket starts at or below the slot and
// the next cell's first bucket is at or past it, so the search runs inside
// that window, where every start is below 2^16. A step waits for its
// slowest lane, and that is a lane in a Gaussian tail, where a cell holds
// up to 256 one-slot buckets: so the search guesses by interpolation
// (exact on a run of equal widths: two probes), with every third probe a
// bisection to bound the worst case. crow: the row's coarse index; returns
// the bucket's word index, w: its word.
__device__ __forceinline__ int find_bucket(const uint16_t* crow,
                                           const uint32_t* rw, uint32_t slot,
                                           uint32_t& w) {
  const uint16_t* cell = crow + (slot >> kCellShift);
  int lo = cell[0], hi = cell[1];
  w = rw[lo];
  if (hi > lo) {
    const uint32_t w_hi = rw[hi];
    uint32_t s_hi = w_hi & 0xFFFFu;
    if (s_hi <= slot) {
      lo = hi;
      w = w_hi;
    } else {
      // start(lo) <= slot < start(hi): the answer is in [lo, hi)
      uint32_t s_lo = w & 0xFFFFu;
      for (int k = 0; hi - lo > 1; k = k == 2 ? 0 : k + 1) {
        int g = k == 2 ? (lo + hi) >> 1
                       : lo + (int)__fdividef(
                                  ((float)(slot - s_lo) + 0.5f) *
                                      (float)(hi - lo),
                                  (float)(s_hi - s_lo));
        g = min(max(g, lo + 1), hi - 1);
        const uint32_t w_g = rw[g];
        if ((w_g & 0xFFFFu) <= slot) {
          lo = g;
          s_lo = w_g & 0xFFFFu;
          w = w_g;
        } else {
          hi = g;
          s_hi = w_g & 0xFFFFu;
        }
      }
    }
  }
  return lo;
}

// The encoder's (start | freq << 16) word of bucket `pos` in `row`, as
// build_enc_tables holds it: 0 past the row's buckets. Row and position
// are clamped as the JAX gather clamps them.
__device__ __forceinline__ uint32_t enc_word(const Rows& tb, int row,
                                             int pos) {
  row = min(max(row, 0), tb.rows - 1);
  const uint32_t base = tb.meta[2 * row], nb = tb.meta[2 * row + 1];
  const uint32_t p = (uint32_t)max(pos, 0);
  return p < nb ? tb.words[base + p] + kRansL : 0u;
}

// ---- the block-wide prefix sum ------------------------------------------
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

// ---- per-thread input prefetch (cp.async, 4 bytes) ------------------------
// 4 bytes from global to shared memory, or zeros when `valid` is false
// (then nothing is read).
__device__ __forceinline__ void cp_async4(int* smem, const int* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Wait until at most N of this thread's newest prefetch groups are in
// flight; its slots are read only after this.
template <int N>
__device__ __forceinline__ void prefetch_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int next_slot(int s) {
  return s + 1 == kSlots ? 0 : s + 1;
}

// Sub-step u of a launch: lanes c * blockDim .. of step t, symbol t * K +
// lane. The decoder walks t and c upwards, the encoder downwards. One lane
// a thread (kWide false) has one sub-step a step.
template <bool kWide, bool kReverse>
struct Walk {
  int K, T, chunks;
  __device__ __forceinline__ long long symbol(int u, int& lane) const {
    int t = kWide ? u / chunks : u;
    int c = kWide ? u - t * chunks : 0;
    if (kReverse) {
      t = T - 1 - t;
      c = chunks - 1 - c;
    }
    lane = c * (int)blockDim.x + (int)threadIdx.x;
    return (long long)t * K + lane;
  }
};

// ---- the decoder's word ring ---------------------------------------------
// Stream word p sits at ring coordinate q = p + off, where off places the
// stream in 16-byte units (bulk copies need 16-byte addresses and sizes).
// Words q in [q_lo, q_hi) come through the ring, chunk c = q / kChunk in
// stage c % kStages; the few words before q_lo (head) and from q_hi (tail)
// are loaded once into `edge` at the start. Thread 0 alone waits on the
// chunks' barriers, before a step's prefix-sum barrier, for every chunk the
// step may read; the other threads then read the ring without a check.
struct Ring {
  uint16_t* buf;
  uint16_t* edge;     // [0, 8) head, [8, 16) tail
  uint64_t* bars;     // one a stage
  const uint16_t* src;
  int off, q_lo, q_hi, q_end, n_chunks;
  int issued;         // chunks issued so far (thread 0's count)
  int landed;         // chunks waited for so far (thread 0's count)

  __device__ void init(const uint16_t* words, int limit) {
    off = (int)((reinterpret_cast<uintptr_t>(words) & 15u) >> 1);
    src = words - off;
    q_end = off + limit;
    q_lo = min((off + 7) & ~7, q_end);
    q_hi = max(q_end & ~7, q_lo);
    n_chunks = q_hi > q_lo ? (q_hi + kChunk - 1) / kChunk : 0;
    issued = landed = 0;
  }

  // Threads 0..15 load the head and tail words.
  __device__ void load_edge(const uint16_t* words) {
    const int j = threadIdx.x;
    if (j < 8) {
      if (off + j < q_lo) edge[j] = words[j];
    } else if (j < 16) {
      const int q = q_hi + j - 8;
      if (q < q_end) edge[j] = words[q - off];
    }
  }

  // Thread 0: bring in every chunk whose stage the lanes have left, i.e.
  // whose stage's previous chunk lies wholly below ring coordinate
  // `consumed`; every read of those words happened before the barrier the
  // caller has just passed.
  __device__ void refill(int consumed) {
    bool fenced = false;
    while (issued < n_chunks &&
           (issued - kStages + 1) * kChunk <= consumed) {
      if (!fenced) {
        // the ring's earlier reads (generic proxy) before the copy's
        // writes (async proxy)
        dcae::fence_proxy_async();
        fenced = true;
      }
      const int c = issued++;
      const int lo = max(c * kChunk, q_lo), hi = min((c + 1) * kChunk, q_hi);
      uint64_t* bar = &bars[c % kStages];
      mbar_expect(bar, (uint32_t)(hi - lo) * 2u);
      bulk_copy(buf + (lo & (kRing - 1)), src + lo, (uint32_t)(hi - lo) * 2u,
                bar);
    }
  }

  // Thread 0, before the step's barrier: wait until every chunk holding a
  // word below ring coordinate `end` has landed (issued chunks only: a
  // chunk past the body is never read).
  __device__ __forceinline__ void await(int end) {
    const int need = min((end + kChunk - 1) / kChunk, issued);
    for (; landed < need; ++landed)
      mbar_wait(&bars[landed % kStages], (uint32_t)(landed / kStages) & 1u);
  }

  // Word p (0 <= p < limit), once thread 0 has awaited it.
  __device__ __forceinline__ uint32_t word(int p) const {
    const int q = p + off;
    if (q < q_lo) return edge[q - off];
    if (q >= q_hi) return edge[8 + q - q_hi];
    return buf[q & (kRing - 1)];
  }

  // Thread 0, before the block exits: no copy may still be writing.
  __device__ void drain() { await(issued * kChunk); }
};

// ---- shared-memory layout -------------------------------------------------
__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// table | mbarriers | tot[2][32] | (decode: ring, edge, row offsets) |
// input slots
__host__ __device__ inline size_t smem_bytes(bool decode, int table_bytes,
                                             int threads, int rows) {
  size_t s = align16((size_t)table_bytes) + kBars + 2 * 32 * sizeof(int);
  if (decode)
    s += kRing * sizeof(uint16_t) + 16 * sizeof(uint16_t) +
         align16((size_t)rows * sizeof(int));
  return s + (size_t)(decode ? 1 : 3) * kSlots * threads * sizeof(int);
}

struct Smem {
  uint32_t* table;
  uint64_t* bars;     // [0] the table, [1 ..] the ring's stages
  int* tot;           // [2][32]
  uint16_t* ring;
  uint16_t* edge;
  int* offsets;       // the rows' symbol offsets
  int* slots;         // kSlots x blockDim a prefetched input
};

__device__ __forceinline__ Smem carve(unsigned char* smem, bool decode,
                                      int table_bytes, int rows) {
  Smem m;
  size_t o = 0;
  m.table = reinterpret_cast<uint32_t*>(smem);
  o += align16((size_t)table_bytes);
  m.bars = reinterpret_cast<uint64_t*>(smem + o);
  o += kBars;
  m.tot = reinterpret_cast<int*>(smem + o);
  o += 2 * 32 * sizeof(int);
  m.ring = m.edge = nullptr;
  m.offsets = nullptr;
  if (decode) {
    m.ring = reinterpret_cast<uint16_t*>(smem + o);
    o += kRing * sizeof(uint16_t);
    m.edge = reinterpret_cast<uint16_t*>(smem + o);
    o += 16 * sizeof(uint16_t);
    m.offsets = reinterpret_cast<int*>(smem + o);
    o += align16((size_t)rows * sizeof(int));
  }
  m.slots = reinterpret_cast<int*>(smem + o);
  return m;
}

// Thread 0: the barriers, then the table's bulk copy on barrier 0.
__device__ void start_table(const Smem& m, const uint32_t* table,
                            int table_bytes, int n_bars) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < n_bars; ++b) mbar_init(&m.bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&m.bars[0], (uint32_t)table_bytes);
    bulk_copy(m.table, table, (uint32_t)table_bytes, &m.bars[0]);
  }
}

// ---- decode ----------------------------------------------------------------
// kWide = false: one lane a thread, its state in a register. kWide = true:
// a thread walks lanes tid, tid + blockDim, ... (chunks sub-steps a step)
// and states_out is the working array: a lane is always read and written
// by the same thread.
template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_decode_kernel(
    const uint16_t* __restrict__ words, const int* __restrict__ n_words_p,
    int words_len, const uint32_t* __restrict__ states_in,
    const int* __restrict__ indexes, const int* __restrict__ offsets,
    const uint32_t* __restrict__ table, int table_bytes, int* __restrict__ syms,
    uint32_t* states_out, int* __restrict__ ok_out, int n, int K, int rows,
    int check_base) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem m = carve(smem_raw, true, table_bytes, rows);
  const int tid = threadIdx.x, bd = blockDim.x;
  const int n_warps = bd >> 5;
  const int n_words = *n_words_p;
  const int limit = max(0, min(n_words, words_len));
  const Walk<kWide, false> walk{K, (int)(((long long)n + K - 1) / K),
                                kWide ? (K + bd - 1) / bd : 1};
  const int steps = walk.T * walk.chunks;

  start_table(m, table, table_bytes, 1 + kStages);
  Ring ring;
  ring.buf = m.ring;
  ring.edge = m.edge;
  ring.bars = m.bars + 1;
  ring.init(words, limit);
  ring.load_edge(words);
  for (int r = tid; r < rows; r += bd) m.offsets[r] = offsets[r];
  __syncthreads();               // barriers ready, edge words and offsets in
  if (tid == 0) ring.refill(ring.off);

  // the coding indexes, kDepth sub-steps ahead
  int* slots = m.slots + tid;
  auto prefetch = [&](int u, int slot) {
    int lane;
    const long long i = walk.symbol(u, lane);
    const bool live = u < steps && lane < K && i < n;
    cp_async4(slots + slot * bd, indexes + (live ? i : 0), live);
    dcae::cp_async_commit();
  };
  int rd = 0, wr = 0;
  for (int d = 0; d < kDepth; ++d, wr = next_slot(wr)) prefetch(d, wr);

  uint32_t xr = 0;
  if (kWide) {
    for (int lane = tid; lane < K; lane += bd) states_out[lane] = states_in[lane];
  } else if (tid < K) {
    xr = states_in[tid];
  }
  mbar_wait(&m.bars[0], 0);              // the table has landed
  const Rows tb = rows_at(m.table);
  const int n_rows = min(rows, tb.rows);
  // a symbol is its bucket's word index + its row's bias
  for (int r = tid; r < n_rows; r += bd) m.offsets[r] -= (int)tb.meta[2 * r];
  __syncthreads();
  int ptr = 0;
  bool bad = false;
  // sub-step u's row (its coarse index and bias), read a sub-step ahead:
  // it does not depend on the state
  const uint16_t* crow;
  int bias;
  auto row_of = [&](int u, const uint16_t*& c, int& bs) {
    prefetch_wait<kDepth - 1>();
    int idx = slots[rd * bd];            // 0 past the symbols
    rd = next_slot(rd);
    prefetch(u + kDepth, wr);
    wr = next_slot(wr);
    if (idx < 0 || idx >= n_rows) {      // no such CDF row: a corrupt input
      bad = true;
      idx = 0;
    }
    c = tb.coarse + idx * kCoarse;
    bs = m.offsets[idx];
  };
  row_of(0, crow, bias);
  for (int u = 0; u < steps; ++u) {
    int lane;
    const long long i = walk.symbol(u, lane);
    const bool active = lane < K && i < n;
    bool need = false;
    uint32_t x2 = 0;
    if (active) {
      const uint32_t x = kWide ? states_out[lane] : xr;
      const uint32_t slot = x & 0xFFFFu;
      uint32_t w;
      syms[i] = find_bucket(crow, tb.words, slot, w) + bias;
      x2 = ((w >> 16) + 1u) * (x >> 16) + (slot - (w & 0xFFFFu));
      need = x2 < kRansL;
    }
    row_of(u + 1, crow, bias);
    // a step reads at most blockDim words from ptr on
    if (tid == 0) ring.await(ptr + ring.off + bd);
    const Scan s = block_scan<false>(need, m.tot + 32 * (u & 1), n_warps);
    if (tid == 0) ring.refill(ptr + ring.off);
    if (need) {
      const int p = ptr + s.rank;
      // past the stream's end: a corrupt stream; ptr then ends past n_words
      x2 = (x2 << 16) | (p < limit ? ring.word(p) : 0u);
    }
    ptr += s.total;
    if (active) {
      if (kWide)
        states_out[lane] = x2;
      else
        xr = x2;
    }
  }
  prefetch_wait<0>();
  bool good = !bad;
  if (kWide) {
    if (check_base)
      for (int lane = tid; lane < K; lane += bd)
        if (states_out[lane] != kRansL) good = false;
  } else if (tid < K) {
    states_out[tid] = xr;
    if (check_base && xr != kRansL) good = false;
  }
  if (tid == 0) ring.drain();
  const int all_good = __syncthreads_and(good);
  if (tid == 0) *ok_out = (all_good && ptr == n_words) ? 1 : 0;
}

// ---- encode ----------------------------------------------------------------
// Walks the sub-steps backwards; in a step the renorming lanes emit in
// DESCENDING lane order, so word `ptr + (renorming lanes above mine)` is
// this lane's: words_out is in emission order, and the byte stream is its
// reversed prefix of n_words words. A lane's next state does not depend on
// the prefix sum, only where its word goes.
template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads) rans_lanes_encode_kernel(
    const int* __restrict__ pos, const int* __restrict__ idx,
    const uint8_t* __restrict__ in_range, const uint32_t* __restrict__ table,
    int table_bytes, const uint32_t* __restrict__ init_states,
    uint16_t* __restrict__ words_out, int* __restrict__ n_words_out,
    uint32_t* states_out, int* __restrict__ escape_out, int n, int K,
    int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem m = carve(smem_raw, false, table_bytes, 0);
  const int tid = threadIdx.x, bd = blockDim.x;
  const int n_warps = bd >> 5;
  const Walk<kWide, true> walk{K, (int)(((long long)n + K - 1) / K),
                               kWide ? (K + bd - 1) / bd : 1};
  const int steps = walk.T * walk.chunks;

  start_table(m, table, table_bytes, 1);
  __syncthreads();                       // the barrier is initialized

  // positions, rows and in-range flags, kDepth sub-steps ahead; a flag
  // comes in its aligned 4-byte word (which lies in the flags' allocation,
  // allocations being whole multiples of 4 bytes)
  int* pos_s = m.slots + tid;
  int* row_s = m.slots + kSlots * bd + tid;
  int* inr_s = m.slots + 2 * kSlots * bd + tid;
  auto prefetch = [&](int u, int slot) {
    int lane;
    const long long i = walk.symbol(u, lane);
    const bool live = u < steps && lane < K && i < n;
    const long long at = live ? i : 0;
    cp_async4(pos_s + slot * bd, pos + at, live);
    cp_async4(row_s + slot * bd, idx + at, live);
    cp_async4(inr_s + slot * bd,
              reinterpret_cast<const int*>(
                  reinterpret_cast<uintptr_t>(in_range + at) & ~uintptr_t(3)),
              live);
    dcae::cp_async_commit();
  };
  int rd = 0, wr = 0;
  for (int d = 0; d < kDepth; ++d, wr = next_slot(wr)) prefetch(d, wr);

  uint32_t xr = kRansL;
  if (kWide) {
    for (int lane = tid; lane < K; lane += bd)
      states_out[lane] = init_states != nullptr ? init_states[lane] : kRansL;
  } else if (tid < K && init_states != nullptr) {
    xr = init_states[tid];
  }
  mbar_wait(&m.bars[0], 0);
  const Rows tb = rows_at(m.table);
  int ptr = 0;
  bool esc = false;
  // sub-step u's bucket, read a sub-step ahead: it does not depend on the
  // state. freq 0 marks a zero-width bucket (or a row's single bucket of
  // 2^16), which escapes like a symbol without an in-range bucket; the
  // division then runs on 1. x / freq goes by a double reciprocal, which
  // needs only freq: the estimate is q or q - 1 (x / freq < 2^32, the
  // error below 2^-20, and a remainder is at least 2^-16 of freq), so one
  // step fixes it.
  struct Coded {
    double rcp;
    uint32_t start, freq;
    bool escape;
  };
  auto code_of = [&](int u) {
    prefetch_wait<kDepth - 1>();
    const int p = pos_s[rd * bd], row = row_s[rd * bd];
    const uint32_t flags = (uint32_t)inr_s[rd * bd];
    rd = next_slot(rd);
    prefetch(u + kDepth, wr);
    wr = next_slot(wr);
    int lane;
    const long long i = walk.symbol(u, lane);
    const uint32_t sf = enc_word(tb, row, p);
    const int byte = (int)((reinterpret_cast<uintptr_t>(in_range) +
                            (uintptr_t)i) & 3);
    Coded c;
    c.start = sf & 0xFFFFu;
    c.freq = max(sf >> 16, 1u);
    c.escape = (sf >> 16) == 0u || ((flags >> (8 * byte)) & 0xFFu) == 0u;
    c.rcp = __drcp_rn((double)c.freq);
    return c;
  };
  Coded cur = code_of(0);
  for (int u = 0; u < steps; ++u) {
    int lane;
    const long long i = walk.symbol(u, lane);
    const bool active = lane < K && i < n;
    bool need = false;
    uint32_t xn = 0, emit = 0;
    if (active) {
      uint32_t x = kWide ? states_out[lane] : xr;
      need = (x >> 16) >= cur.freq;
      emit = x & 0xFFFFu;
      if (need) x >>= 16;
      uint32_t q = __double2uint_rz(__uint2double_rn(x) * cur.rcp);
      uint32_t r = x - q * cur.freq;
      if (r >= cur.freq) {
        ++q;
        r -= cur.freq;
      }
      xn = (q << 16) + r + cur.start;
      esc = esc || cur.escape;
    }
    const Coded next = code_of(u + 1);
    const Scan s = block_scan<true>(need, m.tot + 32 * (u & 1), n_warps);
    if (need) words_out[ptr + s.rank] = (uint16_t)emit;
    ptr += s.total;
    if (active) {
      if (kWide)
        states_out[lane] = xn;
      else
        xr = xn;
    }
    cur = next;
  }
  prefetch_wait<0>();
  if (!kWide && tid < K) states_out[tid] = xr;
  for (int q = ptr + tid; q < cap; q += bd) words_out[q] = 0;
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

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shared memory one launch asks for: decode (kind 0, `rows` row offsets) or
// encode (kind 1) on a table of table_bytes with K lanes.
long long dcae_rans_lanes_smem(int kind, int table_bytes, int K, int rows) {
  return (long long)smem_bytes(kind == 0, table_bytes, block_threads(K),
                               rows);
}

// Decode n symbols of one slice. words: uint16 (words_len), *n_words the
// stream's true length; states_in / states_out: uint32 (K); indexes: int32
// (n); offsets: int32 (rows) the rows' symbol offsets; table: uint32
// (table_bytes / 4, 16-byte aligned) build_row_tables' table. Writes syms
// (n), the final lane states and *ok = the stream was consumed exactly
// and, with check_base, every lane is back at 2^16. No word past
// min(n_words, words_len) is used.
int dcae_rans_lanes_decode(const void* words, const void* n_words,
                           const void* states_in, const void* indexes,
                           const void* offsets, const void* table, void* syms,
                           void* states_out, void* ok_out, int words_len,
                           int table_bytes, int n, int K, int rows,
                           int check_base, void* stream) {
  if (K < 1 || n < 0 || rows < 1 || table_bytes < 16 || table_bytes % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(K);
  const size_t smem = smem_bytes(true, table_bytes, threads, rows);
  const void* kernel = K <= kMaxThreads
                           ? (const void*)rans_lanes_decode_kernel<false>
                           : (const void*)rans_lanes_decode_kernel<true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
#define DCAE_DECODE_ARGS                                                      \
  static_cast<const uint16_t*>(words), static_cast<const int*>(n_words),      \
      words_len, static_cast<const uint32_t*>(states_in),                     \
      static_cast<const int*>(indexes), static_cast<const int*>(offsets),     \
      static_cast<const uint32_t*>(table), table_bytes,                       \
      static_cast<int*>(syms), static_cast<uint32_t*>(states_out),            \
      static_cast<int*>(ok_out), n, K, rows, check_base
  if (K <= kMaxThreads)
    rans_lanes_decode_kernel<false><<<1, threads, smem, st>>>(DCAE_DECODE_ARGS);
  else
    rans_lanes_decode_kernel<true><<<1, threads, smem, st>>>(DCAE_DECODE_ARGS);
#undef DCAE_DECODE_ARGS
  return (int)cudaGetLastError();
}

// Encode n symbols of one slice. pos: int32 (n) bucket positions; idx:
// int32 (n) CDF rows; in_range: uint8 (n), 0 where the symbol has no
// in-range bucket; table: as for decode; init_states: uint32 (K) or null
// for the 2^16 base. Writes words_out uint16 (cap >= n) in emission order,
// zero past *n_words_out, the decode-start states and *escape_out.
int dcae_rans_lanes_encode(const void* pos, const void* idx,
                           const void* in_range, const void* table,
                           const void* init_states, void* words_out,
                           void* n_words_out, void* states_out,
                           void* escape_out, int table_bytes, int n, int K,
                           int cap, void* stream) {
  if (K < 1 || n < 0 || cap < n || table_bytes < 16 || table_bytes % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(K);
  const size_t smem = smem_bytes(false, table_bytes, threads, 0);
  const void* kernel = K <= kMaxThreads
                           ? (const void*)rans_lanes_encode_kernel<false>
                           : (const void*)rans_lanes_encode_kernel<true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
#define DCAE_ENCODE_ARGS                                                      \
  static_cast<const int*>(pos), static_cast<const int*>(idx),                 \
      static_cast<const uint8_t*>(in_range),                                  \
      static_cast<const uint32_t*>(table), table_bytes,                       \
      static_cast<const uint32_t*>(init_states),                              \
      static_cast<uint16_t*>(words_out), static_cast<int*>(n_words_out),      \
      static_cast<uint32_t*>(states_out), static_cast<int*>(escape_out), n,   \
      K, cap
  if (K <= kMaxThreads)
    rans_lanes_encode_kernel<false><<<1, threads, smem, st>>>(DCAE_ENCODE_ARGS);
  else
    rans_lanes_encode_kernel<true><<<1, threads, smem, st>>>(DCAE_ENCODE_ARGS);
#undef DCAE_ENCODE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
