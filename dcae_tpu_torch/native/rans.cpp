// TPU-DCAE native entropy-coding runtime.
//
// 64-bit rANS (range Asymmetric Numeral System) encoder/decoder with
// escape/bypass coding, plus exact integer PMF->CDF quantization.
//
// Stream format is designed to be compatible with the layout used by the
// reference's entropy-coding dependency (CompressAI `BufferedRansEncoder` /
// `RansDecoder`, see the reference's models/dcae.py:722,755-756,875-893 for
// the call sites): a 64-bit rANS state renormalizing in 32-bit words, 16-bit
// probability precision, 4-bit bypass chunks for out-of-range symbols, words
// emitted back-to-front, and the final state flushed as two little-endian
// 32-bit words at the head of the stream.
//
// Unlike the reference (which marshals Python lists across the pybind11
// boundary, a known bottleneck), this library operates directly on int32
// arrays so the Python layer can pass numpy buffers with zero copies, and the
// GIL is released for the duration of each call via ctypes.
//
// Build: dcae_tpu_torch/ops/kernels/_build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

constexpr uint32_t kPrecision = 16;   // probability bits
constexpr uint32_t kBypassPrecision = 4;  // bypass chunk bits
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;  // lower bound of normalized interval

struct RansSym {
  uint32_t start;   // cdf[value]  (or raw bits value when bypass)
  uint32_t range;   // cdf[value+1]-cdf[value]  (unused when bypass)
  bool bypass;
};

// --- 64-bit rANS core (words emitted into `out` in emission order; the
// --- final stream reverses them; see flush_stream) ---------------------

inline void enc_put(uint64_t &x, std::vector<uint32_t> &out, uint32_t start,
                    uint32_t freq) {
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    out.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t &x, std::vector<uint32_t> &out, uint32_t val,
                         uint32_t nbits) {
  const uint32_t freq = 1u << (kPrecision - nbits);
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    out.push_back(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = (x << nbits) | val;
}

// Serializes: [state_lo32, state_hi32, last_emitted, ..., first_emitted]
// as little-endian bytes. Matches a back-to-front buffer writer whose
// flush prepends the two state words.
inline int64_t flush_stream(uint64_t x, const std::vector<uint32_t> &emitted,
                            uint8_t *out, int64_t capacity) {
  const int64_t n_words = static_cast<int64_t>(emitted.size()) + 2;
  const int64_t n_bytes = n_words * 4;
  if (n_bytes > capacity) return -1;
  uint32_t *w = reinterpret_cast<uint32_t *>(out);
  w[0] = static_cast<uint32_t>(x);
  w[1] = static_cast<uint32_t>(x >> 32);
  for (size_t i = 0; i < emitted.size(); ++i) {
    w[2 + i] = emitted[emitted.size() - 1 - i];
  }
  return n_bytes;
}

struct RansDecState {
  std::vector<uint32_t> words;
  size_t pos = 0;
  uint64_t x = 0;

  bool init(const uint8_t *stream, int64_t size) {
    if (size < 8 || (size % 4) != 0) return false;
    words.resize(static_cast<size_t>(size) / 4);
    std::memcpy(words.data(), stream, static_cast<size_t>(size));
    x = static_cast<uint64_t>(words[0]) |
        (static_cast<uint64_t>(words[1]) << 32);
    pos = 2;
    return true;
  }

  inline void renorm() {
    if (x < kRansL && pos < words.size()) {
      x = (x << 32) | words[pos++];
    }
  }

  inline uint32_t get() const {
    return static_cast<uint32_t>(x & ((1u << kPrecision) - 1));
  }

  inline void advance(uint32_t start, uint32_t freq) {
    const uint64_t mask = (1u << kPrecision) - 1;
    x = freq * (x >> kPrecision) + (x & mask) - start;
    renorm();
  }

  inline uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
    x >>= nbits;
    renorm();
    return val;
  }
};

// Binary search: largest s in [0, length-2] with cdf[s] <= cum < cdf[s+1].
// CDF rows are strictly increasing over their valid range by construction
// (see dcae_pmf_to_quantized_cdf), so this matches a linear scan.
inline int32_t find_symbol(const int32_t *cdf, int32_t length, uint32_t cum) {
  int32_t lo = 0, hi = length - 1;  // invariant: cdf[lo] <= cum < cdf[hi]
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) / 2;
    if (static_cast<uint32_t>(cdf[mid]) <= cum) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace

extern "C" {

// Encode n symbols with per-symbol CDF-row indexes.
//   symbols: raw integer symbols (offset NOT yet removed)
//   indexes: row in `cdfs` per symbol
//   cdfs:    [cdf_rows, cdf_stride] int32; row i valid up to cdf_lengths[i]
//   offsets: per-row integer offset (symbol - offset = cdf bucket)
// Returns bytes written to `out`, or -1 if capacity is insufficient,
// -2 on bad arguments.
int64_t dcae_rans_encode_with_indexes(
    const int32_t *symbols, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_rows, int64_t cdf_stride,
    const int32_t *cdf_lengths, const int32_t *offsets, uint8_t *out,
    int64_t out_capacity) {
  std::vector<RansSym> syms;
  syms.reserve(static_cast<size_t>(n) + 16);

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= cdf_rows) return -2;
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    if (max_value < 0 || cdf_lengths[idx] > cdf_stride) return -2;

    int32_t value = symbols[i] - offsets[idx];
    uint32_t raw_val = 0;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
    }

    syms.push_back({static_cast<uint32_t>(cdf[value]),
                    static_cast<uint32_t>(cdf[value + 1] - cdf[value]),
                    false});

    if (value == max_value) {
      // Escape: emit bypass chunk count, then the raw value in 4-bit chunks
      // (low to high).
      uint32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;
      uint32_t val = n_bypass;
      while (val >= kMaxBypassVal) {
        syms.push_back({kMaxBypassVal, 0, true});
        val -= kMaxBypassVal;
      }
      syms.push_back({val, 0, true});
      for (uint32_t j = 0; j < n_bypass; ++j) {
        const uint32_t chunk =
            (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
        syms.push_back({chunk, 0, true});
      }
    }
  }

  uint64_t x = kRansL;
  std::vector<uint32_t> emitted;
  emitted.reserve(syms.size() / 2 + 4);
  // rANS encodes back-to-front so the decoder pops symbols front-to-back.
  for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
    if (!it->bypass) {
      enc_put(x, emitted, it->start, it->range);
    } else {
      enc_put_bits(x, emitted, it->start, kBypassPrecision);
    }
  }
  return flush_stream(x, emitted, out, out_capacity);
}

// ---- Streaming decoder (state persists across calls so the channel-
// ---- autoregressive slice loop can interleave with model evaluation) ----

void *dcae_rans_dec_new(const uint8_t *stream, int64_t size) {
  auto *dec = new RansDecState();
  if (!dec->init(stream, size)) {
    delete dec;
    return nullptr;
  }
  return dec;
}

void dcae_rans_dec_free(void *handle) {
  delete static_cast<RansDecState *>(handle);
}

// Decode n symbols; returns 0 on success, negative on error.
int32_t dcae_rans_dec_decode(void *handle, const int32_t *indexes, int64_t n,
                             const int32_t *cdfs, int64_t cdf_rows,
                             int64_t cdf_stride, const int32_t *cdf_lengths,
                             const int32_t *offsets, int32_t *out_symbols) {
  auto *dec = static_cast<RansDecState *>(handle);
  if (dec == nullptr) return -1;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= cdf_rows) return -2;
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t length = cdf_lengths[idx];
    const int32_t max_value = length - 2;
    if (max_value < 0 || length > cdf_stride) return -2;

    const uint32_t cum = dec->get();
    const int32_t s = find_symbol(cdf, length, cum);
    dec->advance(static_cast<uint32_t>(cdf[s]),
                 static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

    int32_t value = s;
    if (value == max_value) {
      // Bypass-decode the raw value.
      uint32_t val = dec->get_bits(kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec->get_bits(kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec->get_bits(kBypassPrecision) << (j * kBypassPrecision);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      value = (raw_val & 1) ? -value - 1 : value + max_value;
    }
    out_symbols[i] = value + offsets[idx];
  }
  return 0;
}

// ---- LUT decode: replace the per-symbol binary search with a direct
// ---- 2^precision-entry table per CDF row. The tables are a pure
// ---- function of the quantized CDFs (built once per update()). Each
// ---- entry fuses (symbol | start<<16 | freq<<32) into one uint64, so
// ---- the decoder's inner loop is a SINGLE dependent load — no second
// ---- fetch into the cdf row for start/freq. freq <= 2^16 - 1 always:
// ---- pmf_to_quantized_cdf keeps every bucket >= 1 and rows have >= 2
// ---- buckets, so no field overflows.

// Fill lut_out[row * 2^kPrecision + cum] = sym|start<<16|freq<<32.
// lut_out must hold cdf_rows << kPrecision uint64 entries.
int32_t dcae_rans_build_lut(const int32_t *cdfs, int64_t cdf_rows,
                            int64_t cdf_stride, const int32_t *cdf_lengths,
                            uint64_t *lut_out) {
  const int64_t slots = 1ll << kPrecision;
  for (int64_t r = 0; r < cdf_rows; ++r) {
    const int32_t *cdf = cdfs + r * cdf_stride;
    const int32_t length = cdf_lengths[r];
    if (length < 2 || length > cdf_stride || cdf[0] != 0 ||
        cdf[length - 1] != static_cast<int32_t>(slots)) {
      // cdf[0] must be 0: the bucket loop writes slots [cdf[0], 2^16),
      // and the caller's buffer may be uninitialized (np.empty) — a
      // nonzero first entry would leave garbage entries below it
      return -2;
    }
    uint64_t *lut = lut_out + r * slots;
    for (int32_t s = 0; s + 1 < length; ++s) {
      const int32_t lo = cdf[s], hi = cdf[s + 1];
      if (lo < 0 || hi > slots || hi < lo) return -3;
      // freq must fit the 16-bit field: a single-bucket row (freq ==
      // 2^16) would silently truncate to 0 and corrupt the decoder
      // state; pmf_to_quantized_cdf never emits one, but this is a
      // public entry point
      if (hi - lo >= static_cast<int32_t>(slots)) return -4;
      const uint64_t entry = static_cast<uint64_t>(s) |
                             (static_cast<uint64_t>(lo) << 16) |
                             (static_cast<uint64_t>(hi - lo) << 32);
      for (int32_t c = lo; c < hi; ++c) lut[c] = entry;
    }
  }
  return 0;
}

// Decode n symbols via the LUT; identical streams/output to
// dcae_rans_dec_decode (the LUT is exactly find_symbol tabulated).
int32_t dcae_rans_dec_decode_lut(void *handle, const int32_t *indexes,
                                 int64_t n, const int32_t *cdfs,
                                 int64_t cdf_rows, int64_t cdf_stride,
                                 const int32_t *cdf_lengths,
                                 const int32_t *offsets, const uint64_t *lut,
                                 int32_t *out_symbols) {
  auto *dec = static_cast<RansDecState *>(handle);
  if (dec == nullptr) return -1;
  const int64_t slots = 1ll << kPrecision;
  (void)cdfs;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= cdf_rows) return -2;
    const int32_t max_value = cdf_lengths[idx] - 2;
    if (max_value < 0 || cdf_lengths[idx] > cdf_stride) return -2;

    const uint32_t cum = dec->get();
    const uint64_t e = lut[idx * slots + cum];
    const int32_t s = static_cast<int32_t>(e & 0xFFFF);
    dec->advance(static_cast<uint32_t>((e >> 16) & 0xFFFF),
                 static_cast<uint32_t>((e >> 32) & 0xFFFF));

    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec->get_bits(kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec->get_bits(kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec->get_bits(kBypassPrecision) << (j * kBypassPrecision);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      value = (raw_val & 1) ? -value - 1 : value + max_value;
    }
    out_symbols[i] = value + offsets[idx];
  }
  return 0;
}

// One-shot convenience: init + decode + free.
int32_t dcae_rans_decode_with_indexes(
    const uint8_t *stream, int64_t size, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_rows, int64_t cdf_stride,
    const int32_t *cdf_lengths, const int32_t *offsets,
    int32_t *out_symbols) {
  void *dec = dcae_rans_dec_new(stream, size);
  if (dec == nullptr) return -1;
  const int32_t rc = dcae_rans_dec_decode(dec, indexes, n, cdfs, cdf_rows,
                                          cdf_stride, cdf_lengths, offsets,
                                          out_symbols);
  dcae_rans_dec_free(dec);
  return rc;
}

// Quantize a PMF (including the tail-mass as its last entry) to an integer
// CDF with `precision` bits, fixing zero-frequency buckets by stealing from
// the lowest-frequency non-unit bucket. cdf_out must hold n+1 entries.
// The exact integer semantics determine the bitstream, so encoder and
// decoder must share this function's output (table baking; see
// the reference's export_checkpoint.py:13-43 for the shipping workflow).
int32_t dcae_pmf_to_quantized_cdf(const float *pmf, int64_t n,
                                  int32_t precision, uint32_t *cdf_out) {
  if (n < 1 || precision < 1 || precision > 30) return -2;
  const uint32_t one = 1u << precision;

  cdf_out[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float p = (pmf[i] > 0.0f && std::isfinite(pmf[i])) ? pmf[i] : 0.0f;
    cdf_out[i + 1] =
        static_cast<uint32_t>(std::round(p * static_cast<float>(one)));
  }

  uint64_t total = 0;
  for (int64_t i = 0; i <= n; ++i) total += cdf_out[i];
  if (total == 0) return -3;

  for (int64_t i = 0; i <= n; ++i) {
    cdf_out[i] = static_cast<uint32_t>(
        (static_cast<uint64_t>(one) * cdf_out[i]) / total);
  }
  for (int64_t i = 1; i <= n; ++i) cdf_out[i] += cdf_out[i - 1];
  cdf_out[n] = one;

  for (int64_t i = 0; i < n; ++i) {
    if (cdf_out[i] == cdf_out[i + 1]) {
      // steal one count from the smallest stealable bucket
      uint32_t best_freq = ~0u;
      int64_t best_steal = -1;
      for (int64_t j = 0; j < n; ++j) {
        const uint32_t freq = cdf_out[j + 1] - cdf_out[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < 0) return -4;
      if (best_steal < i) {
        for (int64_t j = best_steal + 1; j <= i; ++j) cdf_out[j]--;
      } else {
        for (int64_t j = i + 1; j <= best_steal; ++j) cdf_out[j]++;
      }
    }
  }
  return 0;
}

// ---- K-lane interleaved rANS (the device-decodable profile) -----------
//
// A second stream format designed for DECODE ON THE ACCELERATOR:
//   * uint32 lane state, 16-bit renorm words (all arithmetic fits int32-
//     friendly uint32 — TPU jnp has no 64-bit ints by default);
//   * K lanes in strict round-robin symbol order sharing ONE word stream
//     (lane renorm points interleave deterministically, so the decoder's
//     per-iteration cumsum of consume-masks reproduces the exact word
//     positions — no per-lane framing or padding);
//   * no bypass/escape coding: out-of-table symbols return -3 and the
//     caller falls back to the classic (host-decoded) stream format.
// The decoder lives in dcae_tpu/entropy/device_decode.py as a vectorized
// lax.fori_loop; this C++ encoder and the reference decoder below pin the
// format.
//
// Lane j's state starts (at ENCODE time) at kRansL16 = 1<<16; the encoder
// walks symbols in REVERSE global order (lane = i % K), so the decoder
// walks forward. `states_out[K]` receives the decode-START states.
// Returns the number of 16-bit words written, -1 on capacity, -2 on bad
// args, -3 on an escape (symbol outside its CDF row's in-range buckets).

constexpr uint32_t kRansL16 = 1u << 16;

// init_states (nullable): lane states to start encoding from — the
// CHAINED format (round 5: one K-lane set spanning all slices, encoded in
// reverse slice order) passes the next slice's final states here; null =
// the kRansL16 base (per-slice format / the last-encoded slice).
int64_t dcae_rans_encode_interleaved(
    const int32_t *symbols, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_rows, int64_t cdf_stride,
    const int32_t *cdf_lengths, const int32_t *offsets, int32_t K,
    uint16_t *out_words, int64_t out_capacity_words, uint32_t *states_out,
    const uint32_t *init_states) {
  if (n < 0 || K < 1) return -2;
  std::vector<uint32_t> x(static_cast<size_t>(K), kRansL16);
  if (init_states != nullptr) {
    for (int32_t j = 0; j < K; ++j) x[static_cast<size_t>(j)] =
        init_states[j];
  }
  std::vector<uint16_t> emitted;
  emitted.reserve(static_cast<size_t>(n) / 2 + 16);

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= cdf_rows) return -2;
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    if (max_value < 0 || cdf_lengths[idx] > cdf_stride) return -2;
    const int32_t value = symbols[i] - offsets[idx];
    // in-range buckets only (the escape bucket `max_value` itself needs
    // bypass bits the device decoder does not implement)
    if (value < 0 || value >= max_value) return -3;
    const uint32_t start = static_cast<uint32_t>(cdf[value]);
    const uint32_t freq = static_cast<uint32_t>(cdf[value + 1] - cdf[value]);
    if (freq == 0) return -3;
    uint32_t &xj = x[static_cast<size_t>(i % K)];
    // renorm while x >= freq<<16, compared shift-free (freq can be 2^16,
    // which would overflow uint32); a single 16-bit emission suffices
    // because x < 2^32 and freq >= 1
    if ((xj >> kPrecision) >= freq) {
      emitted.push_back(static_cast<uint16_t>(xj & 0xFFFFu));
      xj >>= 16;
    }
    xj = ((xj / freq) << kPrecision) + (xj % freq) + start;
  }

  const int64_t n_words = static_cast<int64_t>(emitted.size());
  if (n_words > out_capacity_words) return -1;
  for (int64_t w = 0; w < n_words; ++w) {
    out_words[w] = emitted[static_cast<size_t>(n_words - 1 - w)];
  }
  for (int32_t j = 0; j < K; ++j) states_out[j] = x[static_cast<size_t>(j)];
  return n_words;
}

// Reference decoder for the interleaved format (tests + host fallback).
// Mirrors the vectorized device loop word-for-word. Returns 0, or -2 on
// bad args, -4 if the stream under/overruns or the end-state checksum
// (every lane back at kRansL16) fails.
// check_base: 1 = require every lane back at kRansL16 after the last
// symbol (whole-stream / last-slice-of-chain decode); 0 = skip (an
// intermediate slice of the chained format — the caller threads the
// final states, written to states_out when non-null, into the next
// slice and checks the base only at the end of the chain).
int32_t dcae_rans_decode_interleaved(
    const uint16_t *words, int64_t n_words, const uint32_t *states,
    const int32_t *indexes, int64_t n, const int32_t *cdfs, int64_t cdf_rows,
    int64_t cdf_stride, const int32_t *cdf_lengths, const int32_t *offsets,
    int32_t K, int32_t *out_symbols, uint32_t *states_out,
    int32_t check_base) {
  if (n < 0 || K < 1) return -2;
  std::vector<uint32_t> x(states, states + K);
  int64_t ptr = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= cdf_rows) return -2;
    const int32_t *cdf = cdfs + idx * cdf_stride;
    uint32_t &xj = x[static_cast<size_t>(i % K)];
    const uint32_t slot = xj & 0xFFFFu;
    const int32_t value = find_symbol(cdf, cdf_lengths[idx], slot);
    const uint32_t start = static_cast<uint32_t>(cdf[value]);
    const uint32_t freq = static_cast<uint32_t>(cdf[value + 1] - cdf[value]);
    xj = freq * (xj >> kPrecision) + slot - start;
    if (xj < kRansL16) {
      if (ptr >= n_words) return -4;
      xj = (xj << 16) | static_cast<uint32_t>(words[ptr++]);
    }
    out_symbols[i] = value + offsets[idx];
  }
  if (ptr != n_words) return -4;
  if (states_out != nullptr) {
    for (int32_t j = 0; j < K; ++j) states_out[j] =
        x[static_cast<size_t>(j)];
  }
  if (check_base) {
    for (int32_t j = 0; j < K; ++j) {
      if (x[static_cast<size_t>(j)] != kRansL16) return -4;
    }
  }
  return 0;
}

}  // extern "C"
