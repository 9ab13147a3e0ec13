"""The port's K-lane interleaved rANS (dcae_tpu_torch/entropy/device_decode.py,
plain versions, on the CPU) against the JAX package's
dcae_tpu/entropy/device_decode.py and the C++ host coder, case for case
with tests/test_device_decode.py. Both packages code under the same CDFs:
the port reads its row tables (build_row_tables), the JAX package its slot
and enc_sf tables. Inputs come from seeded numpy; every result is an
integer array and is compared EXACTLY.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcae_tpu.entropy import device_decode as jdd
from dcae_tpu.entropy import rans as jrans
from dcae_tpu_torch.entropy import device_decode as dd
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.entropy.gaussian import get_scale_table
from dcae_tpu_torch.entropy.tables import build_gaussian_table
from dcae_tpu_torch.ops.kernels import rans_lanes as rl
from tests.torch_jax_coder import ensure_library

# the JAX coder's library, whole before any test loads it
ensure_library()


def _fixture_tables(coder):
    rng = np.random.default_rng(7)
    rows, maxlen = 9, 60
    cdfs = np.zeros((rows, maxlen + 2), np.int32)
    lengths = np.zeros(rows, np.int32)
    offsets = rng.integers(-25, 6, rows).astype(np.int32)
    for r in range(rows):
        n = int(rng.integers(3, maxlen))
        pmf = rng.uniform(0.001, 1, n).astype(np.float32)
        pmf /= pmf.sum() * 1.0005
        cdf = coder.pmf_to_quantized_cdf(
            np.concatenate([pmf, [1 - pmf.sum()]]))
        cdfs[r, :len(cdf)] = cdf
        lengths[r] = len(cdf)
    return cdfs, lengths, offsets


@pytest.fixture(scope="module")
def tables():
    """The 9-row fixture of tests/test_device_decode.py."""
    t = _fixture_tables(rans)
    for a, b in zip(t, _fixture_tables(jrans)):
        np.testing.assert_array_equal(a, b)
    return t


@pytest.fixture(scope="module")
def bank():
    """The codec's 64-row Gaussian bank."""
    g = build_gaussian_table(get_scale_table())
    return g.quantized_cdf, g.cdf_length, g.offset


def _draw(tables, n, seed):
    cdfs, lengths, offsets = tables
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cdfs.shape[0], n).astype(np.int32)
    val = (rng.random(n) * (lengths[idx] - 2)).astype(np.int32)
    return val + offsets[idx], idx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode(words, n_words, states, idx, tables, K):
    """The port's decode under the row tables of `tables` (CDFs)."""
    luts = dd.build_row_tables(*tables)
    out, ok = dd.decode_interleaved(_t(words), n_words, states, _t(idx),
                                    luts[0], luts[1], K)
    return out.numpy(), bool(ok)


def _jdecode(words, states, idx, tables, K, unroll=1, paired=False):
    """The JAX package's decode under the slot tables of `tables`."""
    luts = jdd.build_slot_tables(*tables, paired=paired)
    out, ok = jdd.decode_interleaved(
        jnp.asarray(words), jnp.int32(len(words)), jnp.asarray(states),
        jnp.asarray(idx), jnp.asarray(luts[0]), jnp.asarray(luts[1]), K,
        unroll, paired)
    return np.asarray(out), bool(ok)


# ------------------------------------------------------------- tables --

@pytest.mark.parametrize("which", ["fixture", "bank"])
@pytest.mark.parametrize("paired", [False, True])
def test_slot_tables_byte_equal(tables, bank, which, paired):
    t = tables if which == "fixture" else bank
    got = dd.build_slot_tables(*t, paired=paired)
    want = jdd.build_slot_tables(*t, paired=paired)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", ["fixture", "bank"])
def test_enc_tables_byte_equal(tables, bank, which):
    t = tables if which == "fixture" else bank
    got = dd.build_enc_tables(*t)
    want = jdd.build_enc_tables(*t)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_slot_tables_reject_invalid_cdf(tables):
    cdfs, lengths, offsets = tables
    bad = cdfs.copy()
    bad[2, 0] = 1
    with pytest.raises(ValueError, match="row 2"):
        dd.build_slot_tables(bad, lengths, offsets)


def test_row_offset_bcast_equals_jax(tables):
    offsets = tables[2]
    idx = np.random.default_rng(1).integers(0, len(offsets), 500).astype(
        np.int32)
    got = dd.row_offset_bcast(_t(idx), _t(offsets))
    want = jdd.row_offset_bcast(jnp.asarray(idx), jnp.asarray(offsets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- host coder --

@pytest.mark.parametrize("n,K", [(50_000, 1024), (49_152, 512), (777, 16),
                                 (5, 8), (64, 64), (1, 1)])
def test_cpp_roundtrip_and_binding_equals_jax_binding(tables, n, K):
    sym, idx = _draw(tables, n, seed=n)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    jstream, jstates = jrans.encode_interleaved(sym, idx, *tables, K)
    assert stream == jstream
    np.testing.assert_array_equal(states, jstates)
    out = rans.decode_interleaved_ref(stream, states, idx, *tables, K)
    np.testing.assert_array_equal(out, sym)


def test_escape_raises(tables):
    sym, idx = _draw(tables, 1000, seed=5)
    sym[123] = 99_999
    with pytest.raises(rans.EscapeError):
        rans.encode_interleaved(sym, idx, *tables, 64)
    assert issubclass(rans.EscapeError, ValueError)


def test_binding_argument_checks(tables):
    sym, idx = _draw(tables, 100, seed=1)
    with pytest.raises(ValueError, match="init_states"):
        rans.encode_interleaved(sym, idx, *tables, 8,
                                init_states=np.zeros(4, np.uint32))
    stream, states = rans.encode_interleaved(sym, idx, *tables, 8)
    with pytest.raises(ValueError, match="states"):
        rans.decode_interleaved_ref(stream, states[:4], idx, *tables, 8)
    with pytest.raises(ValueError, match="decode failed"):
        rans.decode_interleaved_ref(stream[:-2], states, idx, *tables, 8)


# -------------------------------------------------------------- decode --

@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("n,K", [(50_000, 1024), (49_152, 512), (777, 16),
                                 (64, 64), (5, 8), (1, 1), (20_000, 2048)])
def test_decode_matches_jax_and_cpp(tables, n, K, paired):
    """The port's one decode against the JAX decode under either slot
    table layout."""
    sym, idx = _draw(tables, n, seed=100 + n)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    words = np.frombuffer(stream, np.uint16)
    out, ok = _decode(words, len(words), states, idx, tables, K)
    jout, jok = _jdecode(words, states, idx, tables, K, paired=paired)
    assert ok and jok
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, sym)
    np.testing.assert_array_equal(
        out, rans.decode_interleaved_ref(stream, states, idx, *tables, K))


def test_decode_on_the_gaussian_bank(bank):
    sym, idx = _draw(bank, 20_000, seed=9)
    K = 128
    stream, states = rans.encode_interleaved(sym, idx, *bank, K)
    words = np.frombuffer(stream, np.uint16)
    out, ok = _decode(words, len(words), states, idx, bank, K)
    assert ok
    np.testing.assert_array_equal(out, sym)


def test_decode_padded_words(tables):
    """The word buffer may be padded past n_words."""
    sym, idx = _draw(tables, 10_000, seed=3)
    K = 256
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    words = np.frombuffer(stream, np.uint16)
    padded = np.concatenate([words, np.zeros(1000, np.uint16)])
    out, ok = _decode(padded, len(words), states, idx, tables, K)
    assert ok
    np.testing.assert_array_equal(out, sym)
    # the count may come as a tensor, the words and states as torch
    # unsigned or signed-bit tensors
    out2, ok2 = dd.decode_interleaved(
        rl.u16_bits(padded), torch.tensor(len(words), dtype=torch.int32),
        rl.u32_bits(states), _t(idx),
        *dd.row_tables_to_device(dd.build_row_tables(*tables), "cpu"), K)
    assert bool(ok2)
    np.testing.assert_array_equal(out2.numpy(), sym)


def test_checksum_flags_corruption(tables):
    sym, idx = _draw(tables, 30_000, seed=4)
    K = 256
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    words = np.frombuffer(stream, np.uint16).copy()
    words[50] ^= 0xFFFF
    _, ok = _decode(words, len(words), states, idx, tables, K)
    _, jok = _jdecode(words, states, idx, tables, K)
    assert not ok and not jok

    st2 = states.copy()
    st2[0] += 1
    words_ok = np.frombuffer(stream, np.uint16)
    _, ok = _decode(words_ok, len(words_ok), st2, idx, tables, K)
    assert not ok
    # a stream cut short runs over its end
    _, ok = _decode(words_ok[:-3], len(words_ok) - 3, states, idx, tables, K)
    assert not ok
    # a coding index that names no row
    wild = idx.copy()
    wild[7] = 1000
    _, ok = _decode(words_ok, len(words_ok), states, wild, tables, K)
    assert not ok


@pytest.mark.parametrize("unroll", [1, 2, 3, 8])
def test_unroll_identical(tables, unroll):
    """The port's decode, which has no unroll, against the JAX decode at
    each unroll."""
    sym, idx = _draw(tables, 10_000, seed=42)
    K = 128
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    words = np.frombuffer(stream, np.uint16)
    out, ok = _decode(words, len(words), states, idx, tables, K)
    jout, jok = _jdecode(words, states, idx, tables, K, unroll)
    assert ok and jok
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, sym)


def test_unroll_must_be_positive():
    """A container's unroll field is 0 (unspecified) or a power of two up
    to 64: decompress_interleaved refuses any other before it decodes."""
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    codec = DCAECodec(DCAEConfig.tiny(), device="cpu", seed=0)
    enc = {"shape": (1, 1), "istreams": [b"ab"], "lanes": 4,
           "states": np.full(4, 1 << 16, np.uint32), "z_strings": [b""]}
    try:
        for unroll in (-1, 128):
            with pytest.raises(ValueError, match="unroll"):
                codec.decompress_interleaved({**enc, "unroll": unroll})
    finally:
        codec.close()


@pytest.mark.parametrize("n,K,unroll", [(50_000, 1024, 1), (777, 16, 2),
                                        (64, 64, 4)])
def test_decode_paired_lut_matches(tables, n, K, unroll):
    sym, idx = _draw(tables, n, seed=500 + n)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    luts = jdd.build_slot_tables(*tables, paired=True)
    assert luts[1].shape == (tables[0].shape[0] * 65536, 2)
    words = np.frombuffer(stream, np.uint16)
    out, ok = _decode(words, len(words), states, idx, tables, K)
    jout, jok = _jdecode(words, states, idx, tables, K, unroll, True)
    assert ok and jok
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, sym)


# -------------------------------------------------------------- encode --

def _adversarial_tables(rng, rows=6, maxlen=34):
    """One dominant bucket, the rest width 1: freq in {1, 65536 - n + 1}
    drives the state division through its extremes."""
    cdfs = np.zeros((rows, maxlen + 2), np.int32)
    lengths = np.zeros(rows, np.int32)
    offsets = np.zeros(rows, np.int32)
    for r in range(rows):
        n = int(rng.integers(3, maxlen))
        counts = np.ones(n, np.int64)
        counts[int(rng.integers(0, n))] = (1 << 16) - n + 1
        cdf = np.concatenate([[0], np.cumsum(counts)])
        cdfs[r, :len(cdf)] = cdf
        lengths[r] = len(cdf)
    return cdfs, lengths, offsets


def _port_enc(tables):
    """The port's encode tables of `tables` (CDFs): (row table, offsets,
    maxpos, stride), where the JAX package takes build_enc_tables'."""
    offs, table = dd.build_row_tables(*tables)
    return (table, offs, *dd.enc_bounds(tables[1]))


def _encode(sym, idx, tables, K):
    tabs = _port_enc(tables)
    buf, nw, st, esc = dd.encode_interleaved_device(
        _t(sym), _t(idx), tabs[0], tabs[1], tabs[2], tabs[3], K)
    return rl.to_u16(buf), int(nw), rl.to_u32(st), bool(esc)


@pytest.mark.parametrize("K", [64, 1024])
def test_encode_adversarial_freqs(K):
    rng = np.random.default_rng(11)
    tables = _adversarial_tables(rng)
    cdfs, lengths, offsets = tables
    n_sym = 200_000 if K == 1024 else 40_000
    idx = rng.integers(0, cdfs.shape[0], n_sym).astype(np.int32)
    val = (rng.random(n_sym) * (lengths[idx] - 2)).astype(np.int32)
    sym = val + offsets[idx]
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    tabs = dd.build_enc_tables(*tables)
    buf, nw, st, esc = _encode(sym, idx, tables, K)
    assert not esc
    np.testing.assert_array_equal(st, states)
    assert buf[:nw][::-1].tobytes() == stream
    assert not buf[nw:].any() and len(buf) == n_sym + 1
    jbuf, jnw, jst, jesc = jdd.encode_interleaved_device(
        jnp.asarray(sym), jnp.asarray(idx), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), jnp.asarray(tabs[2]), tabs[3], K)
    assert int(jnw) == nw and not bool(jesc)
    np.testing.assert_array_equal(buf, np.asarray(jbuf))
    np.testing.assert_array_equal(st, np.asarray(jst))


@pytest.mark.parametrize("n,K", [(50_000, 1024), (777, 16), (5, 8), (1, 1),
                                 (20_000, 2048)])
def test_encode_matches_cpp_and_jax(tables, n, K):
    sym, idx = _draw(tables, n, seed=200 + n)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    tabs = dd.build_enc_tables(*tables)
    buf, nw, st, esc = _encode(sym, idx, tables, K)
    assert not esc
    assert buf[:nw][::-1].tobytes() == stream
    np.testing.assert_array_equal(st, states)
    jbuf, jnw, jst, _ = jdd.encode_interleaved_device(
        jnp.asarray(sym), jnp.asarray(idx), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), jnp.asarray(tabs[2]), tabs[3], K, 2)
    assert int(jnw) == nw
    np.testing.assert_array_equal(buf, np.asarray(jbuf))
    np.testing.assert_array_equal(st, np.asarray(jst))


@pytest.mark.parametrize("what", ["above", "below", "escape_bucket",
                                  "zero_width"])
def test_encode_escape_flag(tables, what):
    """Out of the row's in-range buckets, or a zero-width bucket: the flag
    is raised, as in the JAX encoder and as the C++ encoder raises."""
    cdfs, lengths, offsets = (a.copy() for a in tables)
    sym, idx = _draw((cdfs, lengths, offsets), 1000, seed=5)
    if what == "above":
        sym[123] = 99_999
    elif what == "below":
        sym[123] = -99_999
    elif what == "escape_bucket":
        sym[123] = offsets[idx[123]] + lengths[idx[123]] - 2
    else:
        r = idx[123]
        pos = 1
        cdfs[r, pos + 1] = cdfs[r, pos]          # bucket `pos` has width 0
        sym[123] = offsets[r] + pos
    tabs = dd.build_enc_tables(cdfs, lengths, offsets)
    assert _encode(sym, idx, (cdfs, lengths, offsets), 64)[3]
    _, _, _, jesc = jdd.encode_interleaved_device(
        jnp.asarray(sym), jnp.asarray(idx), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), jnp.asarray(tabs[2]), tabs[3], 64)
    assert bool(jesc)
    with pytest.raises(rans.EscapeError):
        rans.encode_interleaved(sym, idx, cdfs, lengths, offsets, 64)


# ------------------------------------------------- slices with patches --

@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("patch_cap", [16, 2, 0])
def test_encode_slices_with_patches_matches_jax(tables, chain, patch_cap):
    """Spiked symbols: patch positions, values and counts, the overflow
    flag, streams and states against the JAX function."""
    S, n, K = 3, 4096, 64
    sym = np.stack([_draw(tables, n, seed=70 + s)[0] for s in range(S)])
    idx = np.stack([_draw(tables, n, seed=70 + s)[1] for s in range(S)])
    sym[1, 5], sym[1, 77], sym[1, 4000] = 9_999, -9_999, 512
    sym[2, n - 1] = 7_777
    tabs = dd.build_enc_tables(*tables)
    port = _port_enc(tables)
    got = dd.encode_slices_with_patches(
        _t(sym), _t(idx), port[0], port[1], port[2], port[3], K, patch_cap,
        chain=chain)
    want = jdd.encode_slices_with_patches(
        jnp.asarray(sym), jnp.asarray(idx), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), jnp.asarray(tabs[2]), tabs[3], K, 2,
        patch_cap, chain=chain)
    counts = got["patch_count"].numpy()
    np.testing.assert_array_equal(counts, np.asarray(want["patch_count"]))
    np.testing.assert_array_equal(counts, [0, 3, 1])
    assert bool(got["patch_overflow"]) == bool(want["patch_overflow"]) \
        == (patch_cap < 3)
    assert not bool(got["escape"]) and not bool(want["escape"])
    np.testing.assert_array_equal(got["patch_pos"].numpy(),
                                  np.asarray(want["patch_pos"]))
    for s in range(S):
        k = min(int(counts[s]), patch_cap)
        np.testing.assert_array_equal(got["patch_val"].numpy()[s, :k],
                                      np.asarray(want["patch_val"])[s, :k])
    np.testing.assert_array_equal(got["n_words"].numpy(),
                                  np.asarray(want["n_words"]))
    np.testing.assert_array_equal(rl.to_u16(got["words"]),
                                  np.asarray(want["words"]))
    np.testing.assert_array_equal(rl.to_u32(got["states"]),
                                  np.asarray(want["states"]))
    assert got["states"].shape == ((K,) if chain else (S, K))


def test_encode_slices_row_without_buckets_escapes(tables):
    """A row with no in-range bucket cannot be clamped: escape."""
    cdfs, lengths, offsets = (a.copy() for a in tables)
    lengths[4] = 2
    cdfs[4, :2] = [0, 1 << 16]
    sym, idx = _draw(tables, 512, seed=8)
    idx[10] = 4
    tabs = dd.build_enc_tables(cdfs, lengths, offsets)
    port = _port_enc((cdfs, lengths, offsets))
    got = dd.encode_slices_with_patches(_t(sym[None]), _t(idx[None]),
                                        port[0], port[1], port[2], tabs[3],
                                        16, 8)
    want = jdd.encode_slices_with_patches(
        jnp.asarray(sym[None]), jnp.asarray(idx[None]), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), jnp.asarray(tabs[2]), tabs[3], 16, 1, 8)
    assert bool(got["escape"]) and bool(want["escape"])


# ------------------------------------------------------- chained lanes --

class TestChainedLaneSet:
    """ONE K-lane state set spans all slices: C++ chained encode <-> C++
    chained decode, the port's chained decode of the C++ streams (against
    the JAX decode), its chained ENCODE bit-identical with C++ and JAX,
    and the base-state checksum at the chain's end."""

    @staticmethod
    def _chain(tables, S, n, K, seed):
        sym = np.stack([_draw(tables, n, seed=seed + s * 7)[0]
                        for s in range(S)])
        idx = np.stack([_draw(tables, n, seed=seed + s * 7)[1]
                        for s in range(S)])
        streams, st = [None] * S, None
        for s in reversed(range(S)):
            streams[s], st = rans.encode_interleaved(
                sym[s], idx[s], *tables, K, init_states=st)
        return sym, idx, streams, st

    @pytest.mark.parametrize("S,n,K", [(3, 4096, 64), (5, 2048, 16),
                                       (2, 1000, 128)])
    def test_chain_bit_identity(self, tables, S, n, K):
        sym, idx, streams, header = self._chain(tables, S, n, K, 1000)

        cur = header
        for s in range(S):
            out, cur = rans.decode_interleaved_ref(
                streams[s], cur, idx[s], *tables, K, return_states=True)
            np.testing.assert_array_equal(out, sym[s])
        assert np.all(cur == dd.RANS_L16)

        luts = dd.build_row_tables(*tables)
        jluts = jdd.build_slot_tables(*tables, paired=True)
        cur, jcur = header, jnp.asarray(header)
        for s in range(S):
            w = np.frombuffer(streams[s], np.uint16)
            out, ok, cur = dd.decode_interleaved_chain(
                _t(w), len(w), cur, _t(idx[s]), luts[0], luts[1], K)
            jout, jok, jcur = jdd.decode_interleaved_chain(
                jnp.asarray(w), jnp.int32(len(w)), jcur, jnp.asarray(idx[s]),
                jnp.asarray(jluts[0]), jnp.asarray(jluts[1]), K, 2, True)
            assert bool(ok) and bool(jok)
            np.testing.assert_array_equal(out.numpy(), sym[s])
            np.testing.assert_array_equal(rl.to_u32(cur), np.asarray(jcur))
        assert np.all(rl.to_u32(cur) == dd.RANS_L16)

        tabs = _port_enc(tables)
        res = dd.encode_slices_with_patches(
            _t(sym), _t(idx), tabs[0], tabs[1], tabs[2], tabs[3], K, 16,
            chain=True)
        assert not bool(res["escape"])
        np.testing.assert_array_equal(rl.to_u32(res["states"]), header)
        words = rl.to_u16(res["words"])
        for s in range(S):
            nw = int(res["n_words"][s])
            assert words[s][:nw][::-1].tobytes() == streams[s]

    def test_corruption_detected_at_chain_end(self, tables):
        S, n, K = 3, 2048, 32
        _, idx, streams, st = self._chain(tables, S, n, K, 50)
        bad = bytearray(streams[1])
        bad[len(bad) // 2] ^= 0xFF
        streams[1] = bytes(bad)
        luts = dd.build_row_tables(*tables)
        cur, ok_all = st, True
        for s in range(S):
            w = np.frombuffer(streams[s], np.uint16)
            _, ok, cur = dd.decode_interleaved_chain(
                _t(w), len(w), cur, _t(idx[s]), luts[0], luts[1], K)
            ok_all = ok_all and bool(ok)
        # either a stream ran under or over, or the base check at the
        # chain's end catches the corruption
        assert not (ok_all and np.all(rl.to_u32(cur) == dd.RANS_L16))


def test_kernel_wrappers_take_the_plain_version_only_on_cpu_tensors(tables):
    """On the CPU the wrappers count no launch; for a device without a
    kernel they raise."""
    sym, idx = _draw(tables, 64, seed=2)
    before = (rl.rans_lanes_encode.launches, rl.rans_lanes_decode.launches)
    _encode(sym, idx, tables, 8)
    assert (rl.rans_lanes_encode.launches,
            rl.rans_lanes_decode.launches) == before
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rl.rans_lanes_encode(meta, meta, meta, meta, 4)
    with pytest.raises(ValueError, match="no kernel"):
        rl.rans_lanes_decode(meta, meta, meta, meta, meta, meta, 4)
