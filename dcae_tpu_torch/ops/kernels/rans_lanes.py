"""K-lane interleaved rANS of one slice on the device: decode and encode.

Counterparts of the two XLA loops of the JAX package
(`dcae_tpu/entropy/device_decode.py::_decode_interleaved` and
`::_encode_core`, `lax.fori_loop`s over (K,)-lane vectors). On CUDA tensors
`rans_lanes_decode` / `rans_lanes_encode` launch the kernels of
csrc/rans_lanes.cu (one launch a call, counted) or raise; on CPU tensors
they run `rans_lanes_decode_ref` / `rans_lanes_encode_ref`, the plain
PyTorch statement: the lanes as a vector, a Python loop over the T =
ceil(n / K) steps, the JAX loop body op for op. Both read the row tables
of `build_row_tables` (a word a bucket and a coarse index a row, small
enough for a block's shared memory), where the JAX package reads 2^16-slot
tables; the plain versions find a bucket with searchsorted.

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


# ---------------------------------------------------------- row tables --
# The tables both kernels read, built once per table bake and held whole in
# a launch's shared memory (csrc/rans_lanes.cu): uint32 words
#   [0, 4)              rows, coarse_off, words_off, total (in words);
#   [4, 4 + 2 rows)     each row's (base, nb): its first bucket word (from
#                       words_off) and its bucket count (cdf length - 1);
#   from coarse_off     COARSE uint16 a row: entry c < 256 the bucket of
#                       slot 256 c, entry 256 that of slot 2^16 - 1, as the
#                       bucket's word index from words_off;
#   from words_off      a word a bucket: start + (freq - 1) << 16, mod 2^32.
# The decode slot table's df word for slot s in bucket b is s - start |
# (freq - 1) << 16; the encode table's start | freq << 16 is the word +
# 2^16, bit for bit, the wrap of a single bucket's freq of 2^16 to 0 and of
# a trailing zero-width bucket's start of 2^16 into the freq field included.
CELL_SHIFT = 8                       # 256 slots a coarse cell
COARSE = (SLOTS >> CELL_SHIFT) + 1   # cell bounds a row


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def build_row_tables(cdfs, cdf_lengths, offsets
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The lane coders' row tables: (row offsets int32 (rows,), table
    uint32 (total,), a multiple of 16 bytes). The decoder's pair takes the
    place of build_slot_tables' (the symbol is the bucket + the row's
    offset); the table alone takes the place of build_enc_tables' enc_sf.
    For the codec's 64-row Gaussian bank the table is ~139 KB, against
    32 MB of slot tables and 802 KB of enc_sf."""
    cdfs = np.asarray(cdfs, np.int64)
    lengths = np.asarray(cdf_lengths, np.int64).reshape(-1)
    offsets = np.asarray(offsets, np.int64).reshape(-1)
    rows = cdfs.shape[0]
    coarse_off = 4 + 2 * rows
    words_off = _round4(coarse_off + -(-rows * COARSE // 2))
    buckets = int((lengths - 1).sum())
    if buckets > 1 << 16:
        raise ValueError(f"{buckets} buckets: the row tables index at most "
                         "2^16 (a table that fits shared memory has fewer)")
    total = _round4(words_off + buckets)
    out = np.zeros(total, np.uint32)
    coarse = np.zeros((rows, COARSE), np.uint16)
    cell_slots = np.append(np.arange(0, SLOTS, 1 << CELL_SHIFT), SLOTS - 1)
    base = 0
    for r in range(rows):
        L = int(lengths[r])
        cdf = cdfs[r, :L]
        if L < 2 or cdf[0] != 0 or cdf[-1] != SLOTS:
            raise ValueError(f"row {r}: invalid CDF (len {L})")
        # the slot's bucket: the last whose start is <= the slot
        coarse[r] = base + np.searchsorted(cdf, cell_slots, side="right") - 1
        out[words_off + base:words_off + base + L - 1] = (
            (cdf[:-1] + ((np.diff(cdf) - 1) << 16)) & 0xFFFFFFFF)
        out[4 + 2 * r:6 + 2 * r] = (base, L - 1)
        base += L - 1
    out[:4] = (rows, coarse_off, words_off, total)
    out[coarse_off:words_off].view(np.uint16)[:rows * COARSE] = coarse.ravel()
    return offsets.astype(np.int32), out


class _RowTables:
    """build_row_tables' table (an int32 tensor of its bits) taken apart
    for the plain versions, in int64."""

    def __init__(self, table: torch.Tensor):
        flat = table.reshape(-1)
        t = _unsigned(flat, 32)
        rows, coarse_off, words_off, _ = (int(v) for v in t[:4].tolist())
        meta = t[4:4 + 2 * rows].view(rows, 2)
        self.rows, self.base, self.nb = rows, meta[:, 0], meta[:, 1]
        self.words = t[words_off:words_off + int(self.nb.sum())]
        coarse = _unsigned(flat[coarse_off:words_off].view(torch.int16), 16)
        last = coarse[:rows * COARSE].view(rows, COARSE)[:, -1] - self.base
        # every row's starts in one ascending key, row * 2^17 + start; a
        # trailing zero-width bucket (start 2^16, past the bucket of the
        # last slot) keys above every slot of its row
        dev = flat.device
        row_of = torch.repeat_interleave(torch.arange(rows, device=dev),
                                         self.nb)
        local = torch.arange(self.words.numel(), device=dev) - self.base[row_of]
        start = torch.where(local <= last[row_of], self.words & 0xFFFF,
                            torch.full_like(local, SLOTS))
        self.keys = (row_of << 17) + start

    def bucket(self, row: torch.Tensor, slot: torch.Tensor):
        """The last bucket of each row whose start is <= the slot: (bucket
        position, its word)."""
        g = torch.searchsorted(self.keys, (row << 17) + slot, right=True) - 1
        return g - self.base[row], self.words[g]

    def enc_word(self, row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """build_enc_tables' start | freq << 16 word of (row, pos), 0 past
        the row's buckets; row and pos clamped as the kernel clamps them."""
        row = torch.clamp(row, 0, self.rows - 1)
        p = torch.clamp(pos, min=0)
        inside = p < self.nb[row]
        g = torch.where(inside, self.base[row] + p, torch.zeros_like(p))
        return torch.where(inside, (self.words[g] + SLOTS) & 0xFFFFFFFF,
                           torch.zeros_like(p))


# --------------------------------------------------------------- decode --

def rans_lanes_decode_ref(words, n_words, states, indexes, offsets, table,
                          lanes: int, check_base: bool):
    """Plain PyTorch statement of the decode kernel (and of the JAX loop):
    (symbols (n,) int32, ok () bool, final states (K,) int32 bits).
    Words past n_words are read as they lie in the buffer (the kernel reads
    0 there); in both a stream that runs over ends with ok false. A coding
    index outside the rows is read as row 0 and clears ok."""
    n, K = indexes.numel(), lanes
    dev = indexes.device
    T, idx, active_rows = _rows(indexes, K)
    rt = _RowTables(table)
    bad = ((idx < 0) | (idx >= min(rt.rows, offsets.numel()))) & active_rows
    idx = torch.where(bad, torch.zeros_like(idx), idx)
    w64 = torch.cat([_unsigned(words.reshape(-1), 16),
                     torch.zeros(K, dtype=torch.int64, device=dev)])
    last = w64.numel() - 1
    x = _unsigned(states.reshape(-1), 32)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.zeros((T, K), dtype=torch.int64, device=dev)
    for t in range(T):
        active = active_rows[t]
        slot = x & 0xFFFF
        b, w = rt.bucket(idx[t], slot)
        start = w & 0xFFFF
        freq = (w >> 16) + 1
        x2 = (freq * (x >> 16) + slot - start) & 0xFFFFFFFF
        need = (x2 < RANS_L16) & active
        need_i = need.to(torch.int64)
        cum = torch.cumsum(need_i, 0)
        local = cum - need_i                     # in [0, K)
        w = w64[torch.clamp(ptr + local, max=last)]
        x2 = torch.where(need, ((x2 << 16) | w) & 0xFFFFFFFF, x2)
        x = torch.where(active, x2, x)
        out[t] = torch.where(active, b, torch.zeros_like(b))
        ptr = ptr + need_i.sum()
    ok = (ptr == n_words.to(torch.int64).reshape(())) & ~bad.any()
    if check_base:
        ok = ok & bool_all(x == RANS_L16)
    syms = out.reshape(-1)[:n] + offsets.to(torch.int64)[idx.reshape(-1)[:n]]
    return syms.to(torch.int32), ok, _wrap(x, 32).to(torch.int32)


@functools.cache
def _entries():
    lib = _build.load_kernel("rans_lanes")
    return (_build.bind(lib, "dcae_rans_lanes_decode", 9, 6),
            _build.bind(lib, "dcae_rans_lanes_encode", 9, 4),
            _build.bind_query(lib, "dcae_rans_lanes_smem", 4))


def smem_bytes(kernel: str, table: torch.Tensor, lanes: int,
               rows: int = 0) -> int:
    """Shared memory a launch of `kernel` ("decode", with `rows` row
    offsets, or "encode") asks for on this table with this many lanes
    (builds the kernels' library)."""
    return int(_entries()[2](("decode", "encode").index(kernel),
                             table.numel() * 4, int(lanes), int(rows)))


def _operand(what: str, t: torch.Tensor, dtype, like: torch.Tensor) -> int:
    if t.device != like.device:
        raise ValueError(f"{what}: operands on {t.device} and {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: operand dtype {t.dtype}, wants {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: operands must be contiguous")
    return t.data_ptr()


def _table_bytes(what: str, kernel: str, table: torch.Tensor, K: int,
                 rows: int = 0) -> int:
    """The table's bytes, after checking that a launch can take it."""
    nbytes = table.numel() * 4
    if nbytes < 16 or nbytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{what}: the row table must be 16-byte aligned "
                         f"and a multiple of 16 bytes ({nbytes})")
    if smem_bytes(kernel, table, K, rows) > _build.SMEM_LIMIT:
        raise ValueError(f"{what}: a row table of {nbytes} bytes does not "
                         "fit a block's shared memory")
    return nbytes


def rans_lanes_decode(words, n_words, states, indexes, offsets, table,
                      lanes: int, check_base: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode indexes.numel() symbols of one slice's stream.

    words (W,) int16 (uint16 bits; W >= n_words, the padding is ignored);
    n_words () int32 tensor; states (K,) int32 (uint32 bits), the
    decode-start states; indexes (n,) int32 CDF rows in stream order;
    offsets (rows,) int32 and table int32 (uint32 bits): build_row_tables'
    pair. Returns (symbols (n,) int32, ok () bool, final states (K,)
    int32); nothing here waits for the device. ok: the stream was consumed
    exactly, every index names a row and, with check_base, every lane
    ended at 2^16."""
    if indexes.device.type == "cpu":
        return rans_lanes_decode_ref(words, n_words, states, indexes,
                                     offsets, table, lanes, check_base)
    if indexes.device.type != "cuda":
        raise ValueError(f"rans_lanes_decode: no kernel for {indexes.device}")
    what = "rans_lanes_decode"
    n, K = indexes.numel(), int(lanes)
    i32 = torch.int32
    if states.numel() != K or not 1 <= K < 1 << 16:
        raise ValueError(f"{what}: {states.numel()} states for {K} lanes")
    if n >= (1 << 31) - (1 << 16):
        raise ValueError(f"{what}: {n} symbols do not fit the kernel's ints")
    syms = torch.empty(n, dtype=i32, device=indexes.device)
    st_out = torch.empty(K, dtype=i32, device=indexes.device)
    ok = torch.empty((), dtype=i32, device=indexes.device)
    ptrs = (_operand(what, words, torch.int16, indexes),
            _operand(what, n_words, i32, indexes),
            _operand(what, states, i32, indexes),
            _operand(what, indexes, i32, indexes),
            _operand(what, offsets, i32, indexes),
            _operand(what, table, i32, indexes))
    if offsets.numel() < 1:
        raise ValueError(f"{what}: no rows")
    table_bytes = _table_bytes(what, "decode", table, K, offsets.numel())
    with torch.cuda.device(indexes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entries()[0](*ptrs, syms.data_ptr(), st_out.data_ptr(),
                           ok.data_ptr(), words.numel(), table_bytes, n, K,
                           offsets.numel(), int(check_base), stream)
    _build.check(rc, what)
    rans_lanes_decode.launches += 1
    note_launch(what, 0, words, n_words, states, indexes, table, syms,
                st_out)
    return syms, ok != 0, st_out


rans_lanes_decode.launches = 0


# --------------------------------------------------------------- encode --

def rans_lanes_encode_ref(pos, idx, in_range, table, lanes: int,
                          init_states=None):
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
    sf = _RowTables(table).enc_word(idx2, pos2)
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


def rans_lanes_encode(pos, idx, in_range, table, lanes: int,
                      init_states: Optional[torch.Tensor] = None):
    """Encode one slice. pos (n,) int32 bucket positions; idx (n,) int32
    CDF rows; in_range (n,) bool, False where the symbol has no in-range
    bucket; table int32 (uint32 bits), build_row_tables' table;
    init_states (K,) int32 bits or None for the 2^16 base.
    Returns (words (n + 1,) int16 bits in EMISSION order, zero past n_words
    (the byte stream is the reversed prefix words[:n_words]), n_words ()
    int32, the decode-start states (K,) int32 bits, escape () bool).
    Nothing here waits for the device."""
    if idx.device.type == "cpu":
        return rans_lanes_encode_ref(pos, idx, in_range, table, lanes,
                                     init_states)
    if idx.device.type != "cuda":
        raise ValueError(f"rans_lanes_encode: no kernel for {idx.device}")
    what = "rans_lanes_encode"
    n, K = idx.numel(), int(lanes)
    i32 = torch.int32
    if pos.numel() != n or in_range.numel() != n:
        raise ValueError(f"{what}: {pos.numel()} positions and "
                         f"{in_range.numel()} flags for {n} indexes")
    if not 1 <= K < 1 << 16 or n >= (1 << 31) - (1 << 16):
        raise ValueError(f"{what}: lanes {K}, n {n}")
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
            _operand(what, table, i32, idx),
            None if init_states is None
            else _operand(what, init_states, i32, idx))
    table_bytes = _table_bytes(what, "encode", table, K)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entries()[1](*ptrs, words.data_ptr(), n_words.data_ptr(),
                           st_out.data_ptr(), esc.data_ptr(), table_bytes, n,
                           K, cap, stream)
    _build.check(rc, what)
    rans_lanes_encode.launches += 1
    note_launch(what, 0, pos, idx, in_range, table, words, n_words, st_out)
    return words, n_words, st_out, esc != 0


rans_lanes_encode.launches = 0
