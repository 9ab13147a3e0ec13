"""ctypes binding of the rANS coder (native/rans.cpp): the classic stream
and the K-lane interleaved profile (encode_interleaved /
decode_interleaved_ref, the host coder every device-coded stream is held
to bit for bit).

The C++ source is the JAX package's coder, its code unchanged (three
comments differ: where the reference lives and how the copy is built), so
both packages write the same streams. It is built with g++ into the build
directory at first use. Arrays cross as contiguous numpy int32; ctypes
releases the interpreter lock during each call, so streams of a batch can
be coded from a thread pool.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from dcae_tpu_torch.ops.kernels import _build

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "rans.cpp")

PRECISION_SLOTS = 1 << 16

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load(_SRC)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.dcae_rans_encode_with_indexes.restype = i64
        lib.dcae_rans_encode_with_indexes.argtypes = [
            i32p, i32p, i64, i32p, i64, i64, i32p, i32p, u8p, i64]
        lib.dcae_rans_dec_new.restype = ctypes.c_void_p
        lib.dcae_rans_dec_new.argtypes = [u8p, i64]
        lib.dcae_rans_dec_free.restype = None
        lib.dcae_rans_dec_free.argtypes = [ctypes.c_void_p]
        lib.dcae_rans_dec_decode_lut.restype = ctypes.c_int32
        lib.dcae_rans_dec_decode_lut.argtypes = [
            ctypes.c_void_p, i32p, i64, i32p, i64, i64, i32p, i32p, u64p,
            i32p]
        lib.dcae_rans_decode_with_indexes.restype = ctypes.c_int32
        lib.dcae_rans_decode_with_indexes.argtypes = [
            u8p, i64, i32p, i64, i32p, i64, i64, i32p, i32p, i32p]
        lib.dcae_pmf_to_quantized_cdf.restype = ctypes.c_int32
        lib.dcae_pmf_to_quantized_cdf.argtypes = [
            f32p, i64, ctypes.c_int32, u32p]
        lib.dcae_rans_build_lut.restype = ctypes.c_int32
        lib.dcae_rans_build_lut.argtypes = [i32p, i64, i64, i32p, u64p]
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.dcae_rans_encode_interleaved.restype = i64
        lib.dcae_rans_encode_interleaved.argtypes = [
            i32p, i32p, i64, i32p, i64, i64, i32p, i32p, ctypes.c_int32,
            u16p, i64, u32p, u32p]
        lib.dcae_rans_decode_interleaved.restype = ctypes.c_int32
        lib.dcae_rans_decode_interleaved.argtypes = [
            u16p, i64, u32p, i32p, i64, i32p, i64, i64, i32p, i32p,
            ctypes.c_int32, i32p, u32p, ctypes.c_int32]
        _lib = lib
        return lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_tables(cdfs, cdf_lengths, offsets):
    cdfs = np.ascontiguousarray(np.asarray(cdfs), dtype=np.int32)
    if cdfs.ndim != 2:
        raise ValueError("cdfs must be 2D [rows, stride]")
    cdf_lengths = _as_i32(cdf_lengths)
    offsets = _as_i32(offsets)
    if len(cdf_lengths) != cdfs.shape[0] or len(offsets) != cdfs.shape[0]:
        raise ValueError("cdf_lengths/offsets must match cdfs rows")
    return cdfs, cdf_lengths, offsets


def _check_indexes(indexes: np.ndarray, rows: int) -> None:
    if indexes.size and (indexes.min() < 0 or indexes.max() >= rows):
        raise ValueError("index outside the CDF table")


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets
                        ) -> bytes:
    """Encode integer symbols, each under its CDF row, into one stream."""
    lib = _load()
    symbols = _as_i32(symbols)
    indexes = _as_i32(indexes)
    if symbols.shape != indexes.shape:
        raise ValueError("symbols and indexes must have equal length")
    cdfs, cdf_lengths, offsets = _check_tables(cdfs, cdf_lengths, offsets)
    _check_indexes(indexes, cdfs.shape[0])
    n = symbols.size
    capacity = 16 * n + 64
    while True:
        out = np.empty(capacity, dtype=np.uint8)
        written = lib.dcae_rans_encode_with_indexes(
            _i32p(symbols), _i32p(indexes), n,
            _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
            _i32p(cdf_lengths), _i32p(offsets),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity)
        if written == -1:          # buffer too small: grow and retry
            capacity *= 2
            continue
        if written < 0:
            raise ValueError(f"rANS encode failed (rc={written})")
        return out[:written].tobytes()


def decode_with_indexes(stream: bytes, indexes, cdfs, cdf_lengths,
                        offsets, lut: np.ndarray | None = None
                        ) -> np.ndarray:
    """One-shot decode of `len(indexes)` symbols from `stream`."""
    if lut is not None:
        dec = RansDecoder()
        dec.set_stream(stream)
        try:
            return dec.decode_stream(indexes, cdfs, cdf_lengths, offsets,
                                     lut)
        finally:
            dec.close()
    lib = _load()
    indexes = _as_i32(indexes)
    cdfs, cdf_lengths, offsets = _check_tables(cdfs, cdf_lengths, offsets)
    _check_indexes(indexes, cdfs.shape[0])
    buf = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty(indexes.size, dtype=np.int32)
    rc = lib.dcae_rans_decode_with_indexes(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        _i32p(indexes), indexes.size,
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
        _i32p(cdf_lengths), _i32p(offsets), _i32p(out))
    if rc != 0:
        raise ValueError(f"rANS decode failed (rc={rc})")
    return out


def build_decode_lut(cdfs, cdf_lengths) -> np.ndarray:
    """(rows, 2^16) uint64 decode table fusing (symbol | start << 16 |
    freq << 32): one load per decoded symbol instead of a search."""
    lib = _load()
    cdfs = np.ascontiguousarray(np.asarray(cdfs), dtype=np.int32)
    cdf_lengths = _as_i32(cdf_lengths)
    lut = np.empty((cdfs.shape[0], PRECISION_SLOTS), dtype=np.uint64)
    rc = lib.dcae_rans_build_lut(
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1], _i32p(cdf_lengths),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc != 0:
        raise ValueError(f"rANS LUT build failed (rc={rc})")
    return lut


class RansDecoder:
    """Streaming decoder: decode_stream may be called repeatedly and the
    coder state persists across calls (the sequential slice loop)."""

    def __init__(self):
        self._handle = None
        self._lib = _load()

    def set_stream(self, stream: bytes) -> None:
        self.close()
        buf = np.frombuffer(stream, dtype=np.uint8)
        self._buf = buf  # the native decoder reads it until close()
        handle = self._lib.dcae_rans_dec_new(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
        if not handle:
            raise ValueError("invalid rANS stream")
        self._handle = handle

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets,
                      lut: np.ndarray) -> np.ndarray:
        """Decode len(indexes) symbols through the build_decode_lut table."""
        if self._handle is None:
            raise RuntimeError("set_stream must be called first")
        indexes = _as_i32(indexes)
        cdfs, cdf_lengths, offsets = _check_tables(cdfs, cdf_lengths,
                                                   offsets)
        _check_indexes(indexes, cdfs.shape[0])
        if lut.dtype != np.uint64 or lut.shape != (cdfs.shape[0],
                                                   PRECISION_SLOTS):
            raise ValueError("bad LUT shape/dtype")
        out = np.empty(indexes.size, dtype=np.int32)
        rc = self._lib.dcae_rans_dec_decode_lut(
            self._handle, _i32p(indexes), indexes.size,
            _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
            _i32p(cdf_lengths), _i32p(offsets),
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), _i32p(out))
        if rc != 0:
            raise ValueError(f"rANS decode failed (rc={rc})")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.dcae_rans_dec_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Exact integer PMF -> CDF quantization. `pmf` ends with the tail mass
    (the escape bucket); the CDF has len(pmf)+1 entries ending at
    2**precision."""
    lib = _load()
    pmf = np.ascontiguousarray(np.asarray(pmf).reshape(-1), dtype=np.float32)
    out = np.empty(pmf.size + 1, dtype=np.uint32)
    rc = lib.dcae_pmf_to_quantized_cdf(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pmf.size,
        precision, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed (rc={rc})")
    return out.astype(np.int32)


class EscapeError(ValueError):
    """An interleaved-profile encode met a symbol outside its CDF row's
    in-range buckets (the lane decoder has no bypass path), or more of
    them than the patch list holds. Callers fall back to the classic
    stream format."""


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode_interleaved(symbols, indexes, cdfs, cdf_lengths, offsets,
                       lanes: int, init_states=None
                       ) -> tuple[bytes, np.ndarray]:
    """K-lane interleaved rANS encode: uint32 lane states, 16-bit renorm
    words, strict round-robin symbol order (symbol i on lane i % K), ONE
    shared word stream. Returns (stream_bytes, states_u32[K]); states are
    the decode-START states. Raises EscapeError when a symbol falls outside
    its row's in-range buckets.

    init_states (K,) uint32: start the lanes from these states instead of
    the 2^16 base. The chained format encodes slice s+1 first and feeds
    its final states in here when encoding slice s, so one lane set spans
    all slices."""
    lib = _load()
    symbols = _as_i32(symbols)
    indexes = _as_i32(indexes)
    if symbols.shape != indexes.shape:
        raise ValueError("symbols and indexes must have equal length")
    cdfs, cdf_lengths, offsets = _check_tables(cdfs, cdf_lengths, offsets)
    n = symbols.size
    states = np.empty(lanes, dtype=np.uint32)
    capacity = n + 64            # at most one renorm word per symbol
    out = np.empty(capacity, dtype=np.uint16)
    init_p = None
    if init_states is not None:
        init_states = np.ascontiguousarray(np.asarray(init_states),
                                           dtype=np.uint32)
        if init_states.size != lanes:
            raise ValueError("init_states must have `lanes` entries")
        init_p = _u32p(init_states)
    written = lib.dcae_rans_encode_interleaved(
        _i32p(symbols), _i32p(indexes), n,
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
        _i32p(cdf_lengths), _i32p(offsets), lanes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), capacity,
        _u32p(states), init_p)
    if written == -3:
        raise EscapeError("symbol outside in-range CDF buckets")
    if written < 0:
        raise ValueError(f"interleaved rANS encode failed (rc={written})")
    return out[:written].tobytes(), states


def decode_interleaved_ref(stream: bytes, states, indexes, cdfs,
                           cdf_lengths, offsets, lanes: int,
                           return_states: bool = False):
    """C++ reference decoder of the interleaved profile (tests, and the
    yardstick of the lane kernels).

    return_states=True decodes an INTERMEDIATE slice of the chained
    format: the base-state checksum is skipped (it applies only after the
    chain's last slice) and (symbols, final_states) is returned, the
    states to thread into the next slice."""
    lib = _load()
    indexes = _as_i32(indexes)
    cdfs, cdf_lengths, offsets = _check_tables(cdfs, cdf_lengths, offsets)
    words = np.ascontiguousarray(np.frombuffer(stream, dtype=np.uint16))
    states = np.ascontiguousarray(np.asarray(states), dtype=np.uint32)
    if states.size != lanes:
        raise ValueError("states must have `lanes` entries")
    out = np.empty(indexes.size, dtype=np.int32)
    fin = np.empty(lanes, dtype=np.uint32)
    rc = lib.dcae_rans_decode_interleaved(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), words.size,
        _u32p(states), _i32p(indexes), indexes.size,
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
        _i32p(cdf_lengths), _i32p(offsets), lanes, _i32p(out), _u32p(fin),
        0 if return_states else 1)
    if rc != 0:
        raise ValueError(f"interleaved rANS decode failed (rc={rc})")
    if return_states:
        return out, fin
    return out
