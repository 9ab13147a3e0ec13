"""Entropy coding of the K-lane interleaved profile on the device.

The classic decode path is bound by the host: each slice of the channel-AR
loop ships sigma -> CDF indexes to the host, rANS-decodes there and ships
the symbols back. This module codes the interleaved stream format
(native/rans.cpp `dcae_rans_encode_interleaved`) where the tensors live:

  * K lanes advance in lock step, one symbol a lane a step;
  * the slot -> (symbol, start, freq) search reads compact row tables
    (build_row_tables: a word a bucket and a coarse index of 256-slot
    cells a row, ~139 KB for the 64-row Gaussian bank, built once per
    table bake), which the kernels hold in shared memory;
  * the lanes share ONE word stream: which lanes renorm in a step is a
    mask, and a lane's word sits at ptr + (renorming lanes before it), the
    positions the encoder's reversed round-robin emitted.

The two loops run in ops/kernels/rans_lanes.py: CUDA kernels for CUDA
tensors, the plain PyTorch statement for CPU tensors. Here are the table
builders (numpy, byte-equal to the JAX package's), the format's functions
with the JAX package's names and argument order (the row tables take the
places of the JAX package's slot and enc_sf tables; no unroll or paired
argument, below), and the escape-patch
side channel. build_slot_tables and build_enc_tables stay as the JAX
package's counterparts: the row tables are held against them. The decoder
returns an `ok` flag (the stream was consumed exactly AND every lane is
back at the encoder's initial state 2^16): an end-to-end checksum for
free.

Unsigned quantities are carried as signed tensors with the same bits
(lane states and table words int32, stream words int16; see
ops/kernels/rans_lanes.py); the functions here also take numpy arrays and
torch unsigned tensors and convert. Not carried over from the JAX module,
because they shape the XLA loop and change no bit: the word-select
variants and their switches, the f32-reciprocal division, and the loops'
`unroll` and `paired` arguments (both ride the container, which writes
and checks them: runtime/container.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dcae_tpu_torch.ops.kernels.rans_lanes import (  # noqa: F401
    RANS_L16, SLOTS, build_row_tables, rans_lanes_decode, rans_lanes_encode,
    u16_bits, u32_bits)


def build_slot_tables(cdfs, cdf_lengths, offsets, paired: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat slot tables for the device decoder.

    paired=False returns (lut_sym, lut_df), each (rows * 2^16,):
      lut_sym int32: the decoded SYMBOL VALUE (bucket + row offset baked);
      lut_df uint32: (slot - cdf start) in the low 16 | freq - 1 in the
        high 16. Storing slot - start instead of start keeps the state
        update x2 = freq * (x >> 16) + (slot - start) to ONE gather a
        step.

    paired=True returns (row_offsets int32 (rows,), lut2 uint32
    (rows * 2^16, 2)): lut2[:, 0] is the df word above, lut2[:, 1] the
    BUCKET POSITION. The decode step gathers the (df, pos) pair with one
    8-byte load; the symbol is pos + the row's offset."""
    cdfs = np.asarray(cdfs, np.int64)
    cdf_lengths = np.asarray(cdf_lengths, np.int64).reshape(-1)
    offsets = np.asarray(offsets, np.int64).reshape(-1)
    rows = cdfs.shape[0]
    lut_sym = np.zeros((rows, SLOTS), np.int32)
    lut_df = np.zeros((rows, SLOTS), np.uint32)
    lut_pos = np.zeros((rows, SLOTS), np.uint32) if paired else None
    slot_ids = np.arange(SLOTS, dtype=np.uint32)
    for r in range(rows):
        L = int(cdf_lengths[r])
        cdf = cdfs[r, :L]
        if L < 2 or cdf[0] != 0 or cdf[-1] != SLOTS:
            raise ValueError(f"row {r}: invalid CDF (len {L})")
        counts = np.diff(cdf)  # (L-1,) bucket frequencies, sum == 2^16
        pos = np.repeat(np.arange(L - 1, dtype=np.int64), counts)
        lut_sym[r] = (pos + offsets[r]).astype(np.int32)
        starts = np.repeat(cdf[:-1], counts).astype(np.uint32)
        freqs = np.repeat(counts, counts).astype(np.uint32)
        lut_df[r] = (slot_ids - starts) | ((freqs - 1) << np.uint32(16))
        if paired:
            lut_pos[r] = pos.astype(np.uint32)
    if paired:
        lut2 = np.stack([lut_df.reshape(-1), lut_pos.reshape(-1)], axis=1)
        return offsets.astype(np.int32), lut2
    return lut_sym.reshape(-1), lut_df.reshape(-1)


def build_enc_tables(cdfs, cdf_lengths, offsets
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Encode-side lookup for the interleaved profile.

    Returns (enc_sf, offsets_i32, maxpos_i32, stride):
      enc_sf (rows * stride,) uint32: cdf start (low 16) | freq (high 16)
        for bucket position p of row r at [r * stride + p];
      offsets_i32 (rows,): symbol -> bucket position offset;
      maxpos_i32 (rows,): number of IN-RANGE buckets (length - 2; the
        escape bucket itself is out of range for this profile);
      stride: row stride of enc_sf."""
    cdfs = np.asarray(cdfs, np.int64)
    cdf_lengths = np.asarray(cdf_lengths, np.int64).reshape(-1)
    offsets = np.asarray(offsets, np.int64).reshape(-1)
    rows = cdfs.shape[0]
    stride = int(cdf_lengths.max())  # >= length - 1 buckets + slack
    enc_sf = np.zeros((rows, stride), np.uint32)
    for r in range(rows):
        L = int(cdf_lengths[r])
        cdf = cdfs[r, :L]
        starts = cdf[:-1].astype(np.uint32)
        # the TRUE freq in the high bits (unlike the decode table's
        # freq - 1): 0 marks a zero-width bucket, which the device encoder
        # must ESCAPE exactly like the C++ encoder ('if (freq == 0) return
        # -3'); pmf_to_quantized_cdf never produces one, but externally
        # supplied tables can. freq 2^16 (a single-bucket row) wraps to 0
        # and escapes too, rightly: its row has no in-range bucket.
        freqs = np.diff(cdf).astype(np.uint32)
        enc_sf[r, :L - 1] = starts | (freqs << np.uint32(16))
    return (enc_sf.reshape(-1),
            offsets.astype(np.int32),
            (cdf_lengths - 2).astype(np.int32),
            stride)


def row_tables_to_device(tables, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """build_row_tables' pair as int32 tensors (uint32 bits) on `device`:
    (row offsets, table)."""
    offs, table = tables
    return u32_bits(offs, device), u32_bits(table, device).contiguous()


def enc_bounds(cdf_lengths) -> Tuple[np.ndarray, int]:
    """build_enc_tables' (maxpos, stride) without its table: the in-range
    buckets a row (length - 2) and the row stride (the longest length)."""
    lengths = np.asarray(cdf_lengths, np.int64).reshape(-1)
    return (lengths - 2).astype(np.int32), int(lengths.max())


def row_offset_bcast(indexes: torch.Tensor, offsets: torch.Tensor
                     ) -> torch.Tensor:
    """Each symbol's row offset: indexes (n,) int, offsets (rows,) int32 ->
    (n,) int32. The JAX function avoids a gather with a broadcast compare
    over the row table; a gather from a 64-entry table costs nothing
    here, and the values are the same."""
    return offsets.to(torch.int32)[indexes.to(torch.int64)]


def _scalar_i32(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _decode(words, n_words, states, indexes, lut_sym, lut_df, lanes: int,
            check_base: bool):
    dev = indexes.device
    return rans_lanes_decode(
        u16_bits(words, dev).reshape(-1).contiguous(),
        _scalar_i32(n_words, dev),
        u32_bits(states, dev).reshape(-1).contiguous(),
        indexes.reshape(-1).to(torch.int32).contiguous(),
        u32_bits(lut_sym, dev), u32_bits(lut_df, dev).contiguous(),
        int(lanes), check_base)


def decode_interleaved(words, n_words, states, indexes, lut_sym, lut_df,
                       lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode indexes.numel() symbols from one interleaved stream.

    words: (W,) uint16 bits (W >= n_words; padding ignored); n_words: the
    true word count (int or () tensor); states: (lanes,) uint32 bits, the
    decode-start states; indexes: (n,) int CDF row per symbol in stream
    order; lut_sym / lut_df: build_row_tables' pair (row offsets, table),
    where the JAX package takes build_slot_tables' pair. Returns (symbols
    (n,) int32, ok () bool)."""
    syms, ok, _ = _decode(words, n_words, states, indexes, lut_sym, lut_df,
                          lanes, True)
    return syms, ok


def decode_interleaved_chain(words, n_words, states, indexes, lut_sym,
                             lut_df, lanes: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One CHAINED slice decode: like decode_interleaved, but the lane
    states thread across consecutive streams (ONE K-lane set spans all
    slices, so the header is K states instead of S * K). `ok` here checks
    stream consumption only; the caller checks that the states returned by
    the LAST slice equal the 2^16 base. Returns (symbols, ok_stream,
    final_states (K,) int32 bits)."""
    return _decode(words, n_words, states, indexes, lut_sym, lut_df, lanes,
                   False)


def encode_interleaved_device(symbols, indexes, enc_sf, offsets, maxpos,
                              stride: int, lanes: int):
    """K-lane interleaved rANS ENCODE on the device, bit-identical to the
    C++ encoder's streams. symbols / indexes: (n,) int in stream order;
    enc_sf: build_row_tables' table (where the JAX package takes
    build_enc_tables' enc_sf); offsets, maxpos, stride: build_enc_tables'
    other three (enc_bounds gives the last two).

    Returns (words (n + 1,) int16 (uint16 bits) in EMISSION order (the
    byte stream is the reversed prefix words[:n_words]), n_words () int32,
    states (K,) int32 (uint32 bits) decode-start states, escape () bool).
    escape=True means some symbol fell outside its row's in-range buckets:
    the stream is invalid and the caller falls back to the classic
    format."""
    idx1 = indexes.reshape(-1).to(torch.int64)
    sym1 = symbols.reshape(-1).to(torch.int64)
    dev = idx1.device
    offsets = torch.as_tensor(offsets).to(dev).to(torch.int64)
    maxpos = torch.as_tensor(maxpos).to(dev).to(torch.int64)
    pos = sym1 - offsets[idx1]
    in_range = (pos >= 0) & (pos < maxpos[idx1])
    pos_c = torch.clamp(pos, 0, stride - 1)
    return _encode_core(pos_c, idx1, in_range, u32_bits(enc_sf, dev),
                        K=lanes)


def _encode_core(pos_c, idx1, in_range, enc_sf, K: int, init_states=None):
    """encode_interleaved_device's engine, taking bucket positions already
    CLAMPED into [0, stride) and a validity mask, so callers that clamp for
    the patch list (encode_slices_with_patches) do not look the rows up
    twice. init_states (K,) uint32 bits: the lane states to start from;
    the chained format feeds slice s+1's final encode states in as slice
    s's; None = the 2^16 base. enc_sf: build_row_tables' table. The JAX
    function's stride is not taken: a position past a row's buckets reads
    as none."""
    dev = idx1.device
    return rans_lanes_encode(
        pos_c.reshape(-1).to(torch.int32).contiguous(),
        idx1.reshape(-1).to(torch.int32).contiguous(),
        in_range.reshape(-1).to(torch.bool).contiguous(),
        enc_sf, int(K),
        None if init_states is None
        else u32_bits(init_states, dev).reshape(-1).contiguous())


def encode_slices_with_patches(y_syms, idxs, enc_sf, offsets, maxpos,
                               stride: int, lanes: int, patch_cap: int,
                               chain: bool = False) -> dict:
    """Per-slice interleaved rANS encode with the escape-patch side
    channel (the lane encoder of models/codec.py compress_device). Queues
    device work only: nothing here waits for the device.

    y_syms: (S, ...) int true symbols; idxs: (S, ...) int coding-index
    rows (flattened per slice). Each symbol is clamped into its row's
    in-range buckets for the stream; the true value of a clamped position
    rides the (pos, val) patch list, <= patch_cap entries a slice
    (patch_overflow is set beyond, and the caller falls back to the
    classic format). escape fires only for rows with no in-range bucket
    at all.

    chain=True: ONE K-lane state set spans all S slices. The slices encode
    in REVERSE order (s = S-1 .. 0), each starting from the next slice's
    final states; "states" is the single (K,) decode-start vector (after
    slice 0). chain=False keeps per-slice (S, K) states (DTI1 containers).

    Returns tensors: words (S, n + 1) int16 bits in emission order,
    n_words (S,) int32, states int32 bits, patch_pos (S, min(patch_cap,
    n)) int32 (padding rows hold n), patch_val (same) int32, patch_count
    (S,) int32, patch_overflow () bool, escape () bool."""
    S = y_syms.shape[0]
    sym2 = y_syms.reshape(S, -1).to(torch.int64)
    idx2 = idxs.reshape(S, -1).to(torch.int64)
    n = sym2.shape[1]
    dev = sym2.device
    offs = torch.as_tensor(offsets).to(dev).to(torch.int64)[idx2]
    mp = torch.as_tensor(maxpos).to(dev).to(torch.int64)[idx2]
    pos_raw = sym2 - offs
    pos_cl = torch.minimum(torch.clamp(pos_raw, min=0),
                           torch.clamp(mp - 1, min=0))
    esc_mask = pos_cl != pos_raw
    pcnt = esc_mask.sum(dim=1)

    # patch extraction in a fixed-size form (nonzero would wait for the
    # device): the k-th clamped position of a slice goes to slot k, and
    # everything past patch_cap, like every unclamped position, to a spare
    # slot that is cut off
    P = min(int(patch_cap), n)       # a slice has no more positions
    rank = torch.cumsum(esc_mask.to(torch.int64), dim=1) - 1
    dest = torch.where(esc_mask & (rank < P), rank,
                       torch.full_like(rank, P))
    at = torch.arange(n, device=dev).expand(S, n).contiguous()
    ppos = torch.full((S, P + 1), n, dtype=torch.int64, device=dev)
    ppos.scatter_(1, dest, at)
    ppos = ppos[:, :P]
    ppos = torch.where(torch.arange(P, device=dev)[None, :]
                       < pcnt[:, None], ppos, torch.full_like(ppos, n))
    pval = torch.where(ppos < n,
                       torch.gather(sym2, 1, torch.clamp(ppos, max=n - 1)),
                       torch.zeros_like(ppos))

    enc_sf = u32_bits(enc_sf, dev)
    row_ok = mp > 0
    w_l, nw_l, st_l, esc_l = ([None] * S for _ in range(4))
    st = None
    # chained: slice s starts from slice s+1's final states, so the S
    # encodes are strictly sequential (encode order S-1 .. 0)
    for s in reversed(range(S)):
        w_l[s], nw_l[s], st, esc_l[s] = _encode_core(
            pos_cl[s], idx2[s], row_ok[s], enc_sf, K=lanes,
            init_states=st if chain else None)
        st_l[s] = st
    return {
        "words": torch.stack(w_l),
        "n_words": torch.stack(nw_l),
        "states": st if chain else torch.stack(st_l),
        "patch_pos": ppos.to(torch.int32),
        "patch_val": pval.to(torch.int32),
        "patch_count": pcnt.to(torch.int32),
        "patch_overflow": (pcnt > int(patch_cap)).sum() > 0,
        "escape": torch.stack(esc_l).sum() > 0,
    }
