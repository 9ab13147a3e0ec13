"""K-lane interleaved rANS of one slice on the device: decode and encode.

Counterparts of the two XLA loops of the JAX package
(`dcae_tpu/entropy/device_decode.py::_decode_interleaved` and
`::_encode_core`, `lax.fori_loop`s over (K,)-lane vectors). On CUDA tensors
`rans_lanes_decode` / `rans_lanes_encode` launch the kernels of
csrc/rans_lanes.cu (one launch a call, counted) or raise; on CPU tensors
they run `rans_lanes_decode_ref` / `rans_lanes_encode_ref`, the plain
PyTorch statement: the lanes as a vector, a Python loop over the T =
ceil(n / K) steps, the JAX loop body op for op.

Storage types. Torch has little arithmetic on unsigned types, so the
unsigned quantities cross this module as signed tensors holding the same
bits: lane states and the table words as int32 (uint32 bits), stream words
as int16 (uint16 bits). `u32_bits` / `u16_bits` reinterpret numpy arrays
and torch unsigned tensors; `to_u32` / `to_u16` give the numpy view back.
The plain versions compute in int64; the kernels reinterpret the storage.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dcae_tpu_torch.ops.kernels import _build, note_launch

SLOTS = 1 << 16
RANS_L16 = 1 << 16


# ------------------------------------------------------- storage types --

def u32_bits(a, device=None) -> torch.Tensor:
    """uint32 values (numpy, or a torch uint32 / int32 / int64 tensor) as
    an int32 tensor with the same low 32 bits."""
    if torch.is_tensor(a):
        if a.dtype == torch.int32:
            t = a
        elif a.dtype == torch.uint32:
            t = a.view(torch.int32)
        else:
            t = _wrap(a.to(torch.int64), 32).to(torch.int32)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(np.uint32)).view(np.int32))
    return t if device is None else t.to(device)


def u16_bits(a, device=None) -> torch.Tensor:
    """uint16 values as an int16 tensor with the same bits."""
    if torch.is_tensor(a):
        if a.dtype == torch.int16:
            t = a
        elif a.dtype == torch.uint16:
            t = a.view(torch.int16)
        else:
            t = _wrap(a.to(torch.int64), 16).to(torch.int16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(np.uint16)).view(np.int16))
    return t if device is None else t.to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """The uint32 numpy view of an int32 bit-pattern tensor (copied to the
    host)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def to_u16(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint16)


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Non-negative int64 values < 2^bits -> the signed value with the same
    low `bits` bits."""
    v = v & ((1 << bits) - 1)
    return torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)


def _unsigned(t: torch.Tensor, bits: int) -> torch.Tensor:
    return t.to(torch.int64) & ((1 << bits) - 1)


def bool_all(t: torch.Tensor) -> torch.Tensor:
    """all() that is True on an empty tensor, as a () bool tensor."""
    return (~t).sum() == 0


def _rows(indexes: torch.Tensor, lanes: int):
    """(T, (T, K) int64 rows of the zero-padded indexes, (T, K) active)."""
    n = indexes.numel()
    T = -(-n // lanes)
    pad = T * lanes - n
    dev = indexes.device
    idx = torch.cat([indexes.to(torch.int64),
                     torch.zeros(pad, dtype=torch.int64, device=dev)])
    active = torch.arange(T * lanes, device=dev) < n
    return T, idx.view(T, lanes), active.view(T, lanes)


# --------------------------------------------------------------- decode --

def rans_lanes_decode_ref(words, n_words, states, indexes, lut_a, lut_b,
                          lanes: int, paired: bool, check_base: bool):
    """Plain PyTorch statement of the decode kernel (and of the JAX loop):
    (symbols (n,) int32, ok () bool, final states (K,) int32 bits).
    Words past n_words are read as they lie in the buffer (the kernel reads
    0 there); in both a stream that runs over ends with ok false."""
    n, K = indexes.numel(), lanes
    dev = indexes.device
    T, idx, active_rows = _rows(indexes, K)
    w64 = torch.cat([_unsigned(words.reshape(-1), 16),
                     torch.zeros(K, dtype=torch.int64, device=dev)])
    last = w64.numel() - 1
    x = _unsigned(states.reshape(-1), 32)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.zeros((T, K), dtype=torch.int64, device=dev)
    lut_b2 = lut_b.reshape(-1, 2) if paired else None
    for t in range(T):
        active = active_rows[t]
        slot = x & 0xFFFF
        flat = idx[t] * SLOTS + slot
        if paired:
            pair = lut_b2[flat]                  # one gather, 2 values
            df = _unsigned(pair[:, 0], 32)
            rec = pair[:, 1].to(torch.int64)     # bucket position
        else:
            df = _unsigned(lut_b[flat], 32)
            rec = slot
        delta = df & 0xFFFF                      # slot - cdf start
        freq = (df >> 16) + 1
        x2 = (freq * (x >> 16) + delta) & 0xFFFFFFFF
        need = (x2 < RANS_L16) & active
        need_i = need.to(torch.int64)
        cum = torch.cumsum(need_i, 0)
        local = cum - need_i                     # in [0, K)
        w = w64[torch.clamp(ptr + local, max=last)]
        x2 = torch.where(need, ((x2 << 16) | w) & 0xFFFFFFFF, x2)
        x = torch.where(active, x2, x)
        out[t] = torch.where(active, rec, torch.zeros_like(rec))
        ptr = ptr + need_i.sum()
    ok = ptr == n_words.to(torch.int64).reshape(())
    if check_base:
        ok = ok & bool_all(x == RANS_L16)
    rec = out.reshape(-1)[:n]
    i64 = indexes.to(torch.int64)
    if paired:
        syms = rec + lut_a.to(torch.int64)[i64]
    else:
        syms = lut_a[i64 * SLOTS + rec].to(torch.int64)
    return syms.to(torch.int32), ok, _wrap(x, 32).to(torch.int32)


@functools.cache
def _entries():
    lib = _build.load_kernel("rans_lanes")
    return (_build.bind(lib, "dcae_rans_lanes_decode", 9, 6),
            _build.bind(lib, "dcae_rans_lanes_encode", 9, 5))


def _operand(what: str, t: torch.Tensor, dtype, like: torch.Tensor) -> int:
    if t.device != like.device:
        raise ValueError(f"{what}: operands on {t.device} and {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: operand dtype {t.dtype}, wants {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: operands must be contiguous")
    return t.data_ptr()


def rans_lanes_decode(words, n_words, states, indexes, lut_a, lut_b,
                      lanes: int, paired: bool = False,
                      check_base: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode indexes.numel() symbols of one slice's stream.

    words (W,) int16 (uint16 bits; W >= n_words, the padding is ignored);
    n_words () int32 tensor; states (K,) int32 (uint32 bits), the
    decode-start states; indexes (n,) int32 CDF rows in stream order;
    paired: lut_a (rows,) int32 row offsets and lut_b (rows * 2^16, 2)
    int32 (df, bucket position) pairs; classic: lut_a the symbols and lut_b
    the df words, (rows * 2^16,) int32 each (build_slot_tables).
    Returns (symbols (n,) int32, ok () bool, final states (K,) int32);
    nothing here waits for the device. ok: the stream was consumed exactly
    and, with check_base, every lane ended at 2^16."""
    if indexes.device.type == "cpu":
        return rans_lanes_decode_ref(words, n_words, states, indexes, lut_a,
                                     lut_b, lanes, paired, check_base)
    if indexes.device.type != "cuda":
        raise ValueError(f"rans_lanes_decode: no kernel for {indexes.device}")
    what = "rans_lanes_decode"
    n, K = indexes.numel(), int(lanes)
    i32 = torch.int32
    if states.numel() != K or not 1 <= K < 1 << 16:
        raise ValueError(f"{what}: {states.numel()} states for {K} lanes")
    rows = lut_a.numel() if paired else lut_a.numel() // SLOTS
    if lut_b.numel() != rows * SLOTS * (2 if paired else 1) or rows < 1:
        raise ValueError(f"{what}: tables of {lut_a.numel()} and "
                         f"{lut_b.numel()} entries")
    if n >= (1 << 31) - (1 << 16):
        raise ValueError(f"{what}: {n} symbols do not fit the kernel's ints")
    syms = torch.empty(n, dtype=i32, device=indexes.device)
    st_out = torch.empty(K, dtype=i32, device=indexes.device)
    ok = torch.empty((), dtype=i32, device=indexes.device)
    ptrs = (_operand(what, words, torch.int16, indexes),
            _operand(what, n_words, i32, indexes),
            _operand(what, states, i32, indexes),
            _operand(what, indexes, i32, indexes),
            _operand(what, lut_a, i32, indexes),
            _operand(what, lut_b, i32, indexes))
    if lut_b.data_ptr() % 8:
        raise ValueError(f"{what}: lut_b must be 8-byte aligned")
    with torch.cuda.device(indexes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entries()[0](*ptrs, syms.data_ptr(), st_out.data_ptr(),
                           ok.data_ptr(), words.numel(), n, K, rows,
                           int(paired), int(check_base), stream)
    _build.check(rc, what)
    rans_lanes_decode.launches += 1
    # the streams, states and symbols (a lookup touches a sliver of the
    # tables)
    note_launch(what, 0, words, n_words, states, indexes, syms, st_out)
    return syms, ok != 0, st_out


rans_lanes_decode.launches = 0


# --------------------------------------------------------------- encode --

def rans_lanes_encode_ref(pos, idx, in_range, enc_sf, stride: int,
                          lanes: int, init_states=None):
    """Plain PyTorch statement of the encode kernel (and of the JAX loop,
    with an exact integer division where the TPU multiplies by an f32
    reciprocal and corrects): (words (n + 1,) int16 bits in emission order,
    n_words () int32, states (K,) int32 bits, escape () bool)."""
    n, K = idx.numel(), lanes
    dev = idx.device
    cap = n + 1                                   # <= 1 renorm word a symbol
    T, idx2, active_rows = _rows(idx, K)
    _, pos2, _ = _rows(pos, K)
    _, ok2, _ = _rows(in_range, K)
    ok2 = ok2 != 0
    # everything table-driven happens once, before the loop
    sf = _unsigned(enc_sf[idx2 * stride + pos2], 32)
    start_all = sf & 0xFFFF
    freq_raw = sf >> 16               # TRUE freq; 0 = a zero-width bucket
    esc = (active_rows & ~(ok2 & (freq_raw > 0))).sum() > 0
    freq_all = torch.clamp(freq_raw, min=1)
    x = (torch.full((K,), RANS_L16, dtype=torch.int64, device=dev)
         if init_states is None else _unsigned(init_states.reshape(-1), 32))
    wbuf = torch.full((T, K), -1, dtype=torch.int64, device=dev)
    for t in range(T - 1, -1, -1):
        active = active_rows[t]
        freq = freq_all[t]
        need = ((x >> 16) >= freq) & active
        # -1 marks "no word emitted" for the compaction after the loop
        wbuf[t] = torch.where(need, x & 0xFFFF, torch.full_like(x, -1))
        x2 = torch.where(need, x >> 16, x)
        q = torch.div(x2, freq, rounding_mode="floor")
        r = x2 - q * freq
        x = torch.where(active, ((q << 16) + r + start_all[t]) & 0xFFFFFFFF,
                        x)
    # the loop ran t = T-1 .. 0 and lanes emit DESCENDING within a step, so
    # emission order is wbuf reversed on both axes
    seq = wbuf.flip(0, 1).reshape(-1)
    emit = seq >= 0
    cum = torch.cumsum(emit.to(torch.int64), 0)
    wpos = torch.where(emit, cum - 1, torch.full_like(cum, cap))
    buf = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    buf.scatter_(0, wpos, seq)
    n_words = emit.sum().to(torch.int32)
    return (_wrap(buf[:cap], 16).to(torch.int16), n_words,
            _wrap(x, 32).to(torch.int32), esc)


def rans_lanes_encode(pos, idx, in_range, enc_sf, stride: int, lanes: int,
                      init_states: Optional[torch.Tensor] = None):
    """Encode one slice. pos (n,) int32 bucket positions already clamped
    into [0, stride); idx (n,) int32 CDF rows; in_range (n,) bool, False
    where the symbol's row has no in-range bucket; enc_sf (rows * stride,)
    int32 (start | freq << 16 as uint32 bits, build_enc_tables);
    init_states (K,) int32 bits or None for the 2^16 base.
    Returns (words (n + 1,) int16 bits in EMISSION order, zero past n_words
    (the byte stream is the reversed prefix words[:n_words]), n_words ()
    int32, the decode-start states (K,) int32 bits, escape () bool).
    Nothing here waits for the device."""
    if idx.device.type == "cpu":
        return rans_lanes_encode_ref(pos, idx, in_range, enc_sf, stride,
                                     lanes, init_states)
    if idx.device.type != "cuda":
        raise ValueError(f"rans_lanes_encode: no kernel for {idx.device}")
    what = "rans_lanes_encode"
    n, K, stride = idx.numel(), int(lanes), int(stride)
    i32 = torch.int32
    if pos.numel() != n or in_range.numel() != n:
        raise ValueError(f"{what}: {pos.numel()} positions and "
                         f"{in_range.numel()} flags for {n} indexes")
    if not 1 <= K < 1 << 16 or stride < 1 or enc_sf.numel() % stride \
            or not enc_sf.numel() or n >= (1 << 31) - (1 << 16):
        raise ValueError(f"{what}: lanes {K}, stride {stride}, table of "
                         f"{enc_sf.numel()}, n {n}")
    if init_states is not None and init_states.numel() != K:
        raise ValueError(f"{what}: {init_states.numel()} states for {K} "
                         "lanes")
    cap = n + 1
    words = torch.empty(cap, dtype=torch.int16, device=idx.device)
    n_words = torch.empty((), dtype=i32, device=idx.device)
    st_out = torch.empty(K, dtype=i32, device=idx.device)
    esc = torch.empty((), dtype=i32, device=idx.device)
    ptrs = (_operand(what, pos, i32, idx), _operand(what, idx, i32, idx),
            _operand(what, in_range, torch.bool, idx),
            _operand(what, enc_sf, i32, idx),
            None if init_states is None
            else _operand(what, init_states, i32, idx))
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entries()[1](*ptrs, words.data_ptr(), n_words.data_ptr(),
                           st_out.data_ptr(), esc.data_ptr(), n, K, stride,
                           enc_sf.numel() // stride, cap, stream)
    _build.check(rc, what)
    rans_lanes_encode.launches += 1
    note_launch(what, 0, pos, idx, in_range, words, n_words, st_out)
    return words, n_words, st_out, esc != 0


rans_lanes_encode.launches = 0
