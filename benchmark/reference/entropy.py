"""Plain statement of the codec's entropy coding: the quantized CDF tables,
the classic rANS stream (the z stream) and the K-lane interleaved rANS
stream (the y streams), decoded in NumPy.

The formats are the published ones of the codec's coder: 16-bit
probabilities; the classic stream is CompressAI's (64-bit state, 32-bit
words, the escape bucket followed by 4-bit bypass chunks); the
interleaved stream gives symbol i to lane i % K, every lane a 32-bit
state renormalised by 16-bit words that all lanes read in turn from one
shared word sequence, and every lane ends back at 2^16.
"""

from __future__ import annotations

import bisect

import numpy as np
from scipy.special import erfc, ndtri

PRECISION = 16
ONE = 1 << PRECISION
RANS_L = 1 << 31          # classic stream: lower bound of the state
RANS_L16 = 1 << 16        # interleaved stream: a lane's base state


# ---------------------------------------------------------------- tables --

def pmf_to_quantized_cdf(pmf: np.ndarray) -> np.ndarray:
    """CompressAI's pmf -> 16-bit CDF with no empty bucket: round each
    probability to 1/2^16, renormalise, and give every empty bucket one
    count taken from the smallest bucket that can spare it."""
    p = np.asarray(pmf, np.float32)
    p = np.where((p > 0) & np.isfinite(p), p, np.float32(0))
    # round half away from zero, as std::round does (p * 2^16 is exact)
    v = p.astype(np.float64) * ONE
    cdf = np.zeros(len(p) + 1, np.int64)
    cdf[1:] = np.floor(v + 0.5)
    total = int(cdf.sum())
    cdf = (ONE * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = ONE
    n = len(p)
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freq = np.diff(cdf)
            cand = np.where(freq > 1, freq, np.iinfo(np.int64).max)
            j = int(np.argmin(cand))
            if cand[j] == np.iinfo(np.int64).max:
                raise ValueError("no bucket can spare a count")
            if j < i:
                cdf[j + 1: i + 1] -= 1
            else:
                cdf[i + 1: j + 1] += 1
    return cdf.astype(np.int32)


class CdfTable:
    """Rows of quantized CDFs, their lengths (pmf + escape + end) and the
    symbol offset of each row."""

    def __init__(self, pmf, tail, pmf_length, offset):
        rows = pmf.shape[0]
        self.cdf = np.zeros((rows, int(pmf_length.max()) + 2), np.int32)
        for r in range(rows):
            L = int(pmf_length[r])
            row = pmf_to_quantized_cdf(np.concatenate(
                [pmf[r, :L], [max(float(tail[r]), 0.0)]]).astype(np.float32))
            self.cdf[r, :len(row)] = row
        self.length = (pmf_length + 2).astype(np.int32)
        self.offset = np.asarray(offset).astype(np.int32)

    def lut(self) -> np.ndarray:
        """(rows, 2^16) int32: the bucket of every slot of every row."""
        out = np.zeros((self.cdf.shape[0], ONE), np.int32)
        for r in range(self.cdf.shape[0]):
            c = self.cdf[r, :self.length[r]]
            out[r] = np.repeat(np.arange(len(c) - 1, dtype=np.int32),
                               np.diff(c))
        return out


def _phi(x):
    return 0.5 * erfc(-(2 ** -0.5) * x)


def gaussian_table(scales: np.ndarray, tail_mass: float) -> CdfTable:
    """The scale-indexed Gaussian bank of the y symbols."""
    scales = np.asarray(scales, np.float64)
    centre = np.ceil(scales * -float(ndtri(tail_mass / 2))).astype(np.int64)
    length = 2 * centre + 1
    samples = np.abs(np.arange(int(length.max()), dtype=np.int64)[None, :]
                     - centre[:, None]).astype(np.float32)
    s = scales.astype(np.float32)[:, None]
    upper = _phi((0.5 - samples) / s)
    lower = _phi((-0.5 - samples) / s)
    return CdfTable((upper - lower).astype(np.float32), 2.0 * lower[:, 0],
                    length, -centre)


def _logits_cumulative(eb: dict, n_filters: int, x: np.ndarray):
    x = x.astype(np.float32)
    for i in range(n_filters + 1):
        m = np.logaddexp(0.0, np.asarray(eb[f"_matrix{i}"], np.float32))
        x = np.einsum("cij,cjn->cin", m, x) \
            + np.asarray(eb[f"_bias{i}"], np.float32)
        if i < n_filters:
            x = x + np.tanh(np.asarray(eb[f"_factor{i}"], np.float32)) \
                * np.tanh(x)
    return x


def factorized_table(eb: dict) -> CdfTable:
    """One row a z channel, from the bottleneck's parameters (numpy)."""
    n_filters = len([k for k in eb if k.startswith("_factor")])
    q = np.asarray(eb["quantiles"], np.float32)
    med = q[:, 0, 1]
    lo = np.clip(np.ceil(med - q[:, 0, 0]), 0, None).astype(np.int64)
    hi = np.clip(np.ceil(q[:, 0, 2] - med), 0, None).astype(np.int64)
    length = hi + lo + 1
    start = med - lo.astype(np.float32)
    samples = (np.arange(int(length.max()), dtype=np.float32)[None, None, :]
               + start[:, None, None])
    lower = _logits_cumulative(eb, n_filters, samples - 0.5)
    upper = _logits_cumulative(eb, n_filters, samples + 0.5)
    sign = -np.sign(lower + upper)
    sig = lambda t: 1.0 / (1.0 + np.exp(-t))  # noqa: E731
    pmf = np.abs(sig(sign * upper) - sig(sign * lower))[:, 0, :]
    tail = sig(lower[:, 0, 0]) + sig(-upper[:, 0, -1])
    return CdfTable(pmf.astype(np.float32), tail, length, -lo)


# ------------------------------------------------------- classic stream --

def decode_classic(stream: bytes, indexes: np.ndarray, t: CdfTable
                   ) -> np.ndarray:
    """Symbols of one classic stream under per-symbol table rows."""
    words = np.frombuffer(stream, np.uint32)
    if len(stream) < 8 or len(stream) % 4:
        raise ValueError("classic stream: bad length")
    x = int(words[0]) | (int(words[1]) << 32)
    pos = 2
    n_words = len(words)
    mask = ONE - 1
    out = np.empty(len(indexes), np.int64)
    cdfs = [t.cdf[r, :t.length[r]].tolist() for r in range(len(t.length))]

    def renorm(x, pos):
        if x < RANS_L and pos < n_words:
            x = (x << 32) | int(words[pos])
            pos += 1
        return x, pos

    def bits(x, pos, n):
        v = x & ((1 << n) - 1)
        x, pos = renorm(x >> n, pos)
        return v, x, pos

    for i, r in enumerate(indexes.tolist()):
        cdf = cdfs[r]
        cum = x & mask
        s = bisect.bisect_right(cdf, cum) - 1
        x = (cdf[s + 1] - cdf[s]) * (x >> PRECISION) + cum - cdf[s]
        x, pos = renorm(x, pos)
        value = s
        max_value = len(cdf) - 2
        if value == max_value:
            v, x, pos = bits(x, pos, 4)
            n_bypass = v
            while v == 15:
                v, x, pos = bits(x, pos, 4)
                n_bypass += v
            raw = 0
            for j in range(n_bypass):
                v, x, pos = bits(x, pos, 4)
                raw |= v << (4 * j)
            value = raw >> 1
            value = -value - 1 if raw & 1 else value + max_value
        out[i] = value + t.offset[r]
    return out


# --------------------------------------------------- interleaved stream --

def decode_lanes(words: np.ndarray, states: np.ndarray, indexes: np.ndarray,
                 t: CdfTable, lut: np.ndarray):
    """One slice of the K-lane stream: (symbols, final states, words
    read). indexes: the slice's table rows in symbol order; states: the
    K decode-start states."""
    K = len(states)
    n = len(indexes)
    x = states.astype(np.int64).copy()
    w = words.astype(np.int64)
    out = np.empty(n, np.int64)
    ptr = 0
    cdf, off = t.cdf.astype(np.int64), t.offset.astype(np.int64)
    for start in range(0, n, K):
        k = min(K, n - start)
        rows = indexes[start:start + k]
        xs = x[:k]
        slot = xs & (ONE - 1)
        s = lut[rows, slot]
        lo = cdf[rows, s]
        freq = cdf[rows, s + 1] - lo
        xs = freq * (xs >> PRECISION) + slot - lo
        need = xs < RANS_L16
        take = int(need.sum())
        if ptr + take > len(w):
            raise ValueError("interleaved stream: words run out")
        xs[need] = (xs[need] << 16) | w[ptr:ptr + take]
        ptr += take
        x[:k] = xs
        out[start:start + k] = s + off[rows]
    return out, x, ptr
