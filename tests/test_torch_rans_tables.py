"""The lane coders' row tables (dcae_tpu_torch/ops/kernels/rans_lanes.py,
build_row_tables) against the JAX package's slot and enc_sf tables
(dcae_tpu/entropy/device_decode.py build_slot_tables / build_enc_tables):
for every slot of every row, the decode kernel's lookup, stated here step
for step as csrc/rans_lanes.cu's find_bucket takes it (the row's coarse
cell, then interpolation and bisection inside the cell), and the plain
versions' searchsorted give the slot table's (df, symbol); for every (row,
position)
the encode read gives enc_sf's (start, freq, escape). Tables: the codec's
64-row Gaussian bank, the device-decode tests' fixture and adversarial rows,
and edge rows (zero-width buckets at the start, in the middle and at the
end, a single bucket of 2^16, cells of 256 one-slot buckets).
"""

import numpy as np
import pytest
import torch

from dcae_tpu.entropy import device_decode as jdd
from dcae_tpu_torch.entropy import device_decode as dd
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.entropy.gaussian import get_scale_table
from dcae_tpu_torch.entropy.tables import build_gaussian_table
from dcae_tpu_torch.ops.kernels import rans_lanes as rl
from tests.test_torch_device_decode import (_adversarial_tables,
                                            _fixture_tables)

SLOTS = 1 << 16


def _edge_tables():
    cdfs = [
        [0, SLOTS],                                  # one bucket of 2^16
        [0, 0, 0, 100, SLOTS],                       # leading zero widths
        [0, 100, 100, 100, SLOTS],                   # zero widths inside
        [0, 100, SLOTS - 1, SLOTS, SLOTS, SLOTS],    # trailing, start 2^16
        [0, SLOTS - 1, SLOTS],                       # a last bucket of 1
        list(range(3000)) + [SLOTS],                 # 2999 one-slot buckets
        [0, 256, 512, SLOTS - 256, SLOTS],           # bounds on the cells
    ]
    lengths = np.array([len(c) for c in cdfs], np.int32)
    table = np.zeros((len(cdfs), lengths.max()), np.int32)
    for r, c in enumerate(cdfs):
        table[r, :len(c)] = c
    return table, lengths, np.arange(len(cdfs), dtype=np.int32) * 7 - 20


def _tables(which):
    if which == "bank":
        g = build_gaussian_table(get_scale_table())
        return g.quantized_cdf, g.cdf_length, g.offset
    if which == "fixture":
        return _fixture_tables(rans)
    if which == "adversarial":
        return _adversarial_tables(np.random.default_rng(11))
    return _edge_tables()


WHICH = ["bank", "fixture", "adversarial", "edge"]


def _kernel_lookup(table, row, slot):
    """find_bucket of csrc/rans_lanes.cu over numpy vectors: the cell's
    first and last bucket from the coarse index, then the same search on
    the words' 16-bit starts, interpolation twice and bisection once
    (the float guess may land elsewhere than the kernel's; the answer does
    not depend on it). Returns (bucket, word)."""
    t = table.astype(np.int64)
    coarse = table[t[1]:t[2]].view(np.uint16).astype(np.int64)
    words = t[t[2]:]
    cell = row * rl.COARSE + (slot >> rl.CELL_SHIFT)
    lo, hi = coarse[cell], coarse[cell + 1]
    w = words[lo]
    w_hi = words[hi]
    top = (hi > lo) & ((w_hi & 0xFFFF) <= slot)
    lo = np.where(top, hi, lo)
    w = np.where(top, w_hi, w)
    s_lo, s_hi = w & 0xFFFF, w_hi & 0xFFFF
    k = 0
    while (hi - lo > 1).any():
        live = hi - lo > 1
        if k == 2:
            g = (lo + hi) >> 1
        else:               # the kernel's float interpolation, as a guess
            g = lo + ((slot - s_lo + 0.5) * (hi - lo)
                      // np.maximum(s_hi - s_lo, 1)).astype(np.int64)
        g = np.minimum(np.maximum(g, lo + 1), np.maximum(hi - 1, lo + 1))
        w_g = words[np.where(live, g, lo)]
        up = live & ((w_g & 0xFFFF) <= slot)
        down = live & ~up
        lo, s_lo, w = (np.where(up, g, lo), np.where(up, w_g & 0xFFFF, s_lo),
                       np.where(up, w_g, w))
        hi, s_hi = np.where(down, g, hi), np.where(down, w_g & 0xFFFF, s_hi)
        k = 0 if k == 2 else k + 1
    return lo - t[4 + 2 * row], w


def _plain_lookup(table, row, slot):
    """The plain versions' lookup: searchsorted over the rows' starts."""
    b, w = rl._RowTables(rl.u32_bits(table)).bucket(torch.from_numpy(row),
                                                   torch.from_numpy(slot))
    return b.numpy(), w.numpy()


@pytest.mark.parametrize("lookup", ["kernel", "plain"])
@pytest.mark.parametrize("which", WHICH)
def test_decode_lookup_equals_the_slot_tables(which, lookup):
    tables = _tables(which)
    offsets, table = dd.build_row_tables(*tables)
    rows = len(tables[1])
    row = np.repeat(np.arange(rows, dtype=np.int64), SLOTS)
    slot = np.tile(np.arange(SLOTS, dtype=np.int64), rows)
    b, w = (_kernel_lookup if lookup == "kernel" else _plain_lookup)(
        table, row, slot)
    df = ((slot - (w & 0xFFFF)) | (w & 0xFFFF0000)).astype(np.uint32)
    want_sym, want_df = jdd.build_slot_tables(*tables)
    np.testing.assert_array_equal(df, want_df)
    np.testing.assert_array_equal(b + offsets[row], want_sym)


@pytest.mark.parametrize("read", ["kernel", "plain"])
@pytest.mark.parametrize("which", WHICH)
def test_encode_read_equals_enc_sf(which, read):
    """(start, freq, escape) of every (row, position < stride), the
    single bucket's freq of 2^16 wrapping to 0 and escaping, and a
    trailing zero-width bucket's start of 2^16 carrying into freq as in
    enc_sf."""
    tables = _tables(which)
    _, table = dd.build_row_tables(*tables)
    enc_sf, _, _, stride = jdd.build_enc_tables(*tables)
    rows = len(tables[1])
    row = np.repeat(np.arange(rows, dtype=np.int64), stride)
    pos = np.tile(np.arange(stride, dtype=np.int64), rows)
    if read == "kernel":        # enc_word of csrc/rans_lanes.cu
        t = table.astype(np.int64)
        base, nb = t[4 + 2 * row], t[5 + 2 * row]
        inside = pos < nb
        sf = np.where(inside, (t[t[2]:][np.where(inside, base + pos, 0)]
                               + SLOTS) & 0xFFFFFFFF, 0)
    else:
        sf = rl._RowTables(rl.u32_bits(table)).enc_word(
            torch.from_numpy(row), torch.from_numpy(pos)).numpy()
    want = enc_sf.astype(np.int64)
    np.testing.assert_array_equal(sf & 0xFFFF, want & 0xFFFF)      # start
    np.testing.assert_array_equal(sf >> 16, want >> 16)            # freq
    np.testing.assert_array_equal(sf >> 16 == 0, want >> 16 == 0)  # escape


def test_row_tables_of_the_bank_fit_in_150_kb():
    offsets, table = dd.build_row_tables(*_tables("bank"))
    assert table.dtype == np.uint32 and table.nbytes % 16 == 0
    assert table.nbytes + offsets.nbytes < 150_000
    # the slot tables they replace: 2^16 (df, position) pairs a row
    assert jdd.build_slot_tables(*_tables("bank"), paired=True)[1].nbytes \
        > 200 * table.nbytes


def test_row_tables_reject_invalid_cdf():
    cdfs, lengths, offsets = _tables("fixture")
    bad = cdfs.copy()
    bad[2, 0] = 1
    with pytest.raises(ValueError, match="row 2"):
        dd.build_row_tables(bad, lengths, offsets)


def test_enc_bounds_equal_build_enc_tables():
    tables = _tables("bank")
    _, _, maxpos, stride = jdd.build_enc_tables(*tables)
    got_maxpos, got_stride = dd.enc_bounds(tables[1])
    assert got_stride == stride
    assert got_maxpos.dtype == maxpos.dtype
    np.testing.assert_array_equal(got_maxpos, maxpos)
