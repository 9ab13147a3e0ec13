"""The port's CUDA kernels against their plain PyTorch statements, on the
card. Marked `cuda`: they skip without an NVIDIA GPU. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain| / max |plain|): f32 1e-4 (summation order
only), bf16 3e-2 (operands rounded to bf16 at the same points on both
sides; an accumulated sum that lands near a rounding boundary can flip one
bf16 ulp of an intermediate).
"""

import numpy as np
import pytest
import torch

from dcae_tpu_torch.ops.kernels import conv_glu as cg
from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
from dcae_tpu_torch.ops.kernels import wmsa_block as wm

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape)


def _args(rng, dtype, shapes_and_scales):
    return [torch.from_numpy(np.asarray(f(rng, s), np.float32)).cuda()
            .to(dtype).contiguous() for s, f in shapes_and_scales]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,heads", [(128, 4), (96, 12)])
def test_wmsa_block_kernel(card, C, heads, dtype, shifted):
    rng = np.random.default_rng(14)
    dt = getattr(torch, dtype)
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(2, 16, 24, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((3 * C, C), lambda r, s: _uniform(r, s, b)),
        ((3 * C,), lambda r, s: _uniform(r, s, b)),
        ((C, C), lambda r, s: _uniform(r, s, b)),
        ((C,), lambda r, s: _uniform(r, s, b)),
        ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s)),
    ])
    before = wm.wmsa_block.launches
    got = wm.wmsa_block(x, *args, heads=heads, shifted=shifted)
    want = wm.wmsa_block_ref(x, *args, heads=heads, shifted=shifted)
    assert wm.wmsa_block.launches == before + 1
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,heads", [(128, 4), (96, 12)])
def test_wmsa_attention_kernel(card, C, heads, dtype, shifted):
    """C=96 with 12 heads is head_dim 8: half an mma k-step in bf16."""
    rng = np.random.default_rng(16)
    dt = getattr(torch, dtype)
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(2, 16, 24, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((3 * C, C), lambda r, s: _uniform(r, s, b)),
        ((3 * C,), lambda r, s: _uniform(r, s, b)),
        ((C, C), lambda r, s: _uniform(r, s, b)),
        ((C,), lambda r, s: _uniform(r, s, b)),
        ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s)),
    ])
    before = wa.wmsa_attention.launches
    got = wa.wmsa_attention(x, *args, heads=heads, shifted=shifted)
    want = wa.wmsa_attention_ref(x, *args, heads=heads, shifted=shifted)
    assert wa.wmsa_attention.launches == before + 1
    assert got.dtype == x.dtype
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, wa.wmsa_attention(x, *args, heads=heads,
                                              shifted=shifted))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,h", [("float32", 640, 1280),
                                       ("float32", 128, 256),
                                       ("bfloat16", 256, 512)])
def test_conv_glu_kernel(card, dtype, C, h):
    """Includes the image border (zero padding in g-space) on every side:
    H and W are not multiples of the tile."""
    rng = np.random.default_rng(15)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(2, 10, 21, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    got = cg.conv_glu(x, *args)
    want = cg.conv_glu_ref(x, *args)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, cg.conv_glu(x, *args))   # deterministic


def _wmsa_call(entry, rng, dt, shape, C, heads, shifted):
    """(kernel out, plain out, kernel again) of one wmsa entry."""
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda().to(dt)
    spec = [((3 * C, C), lambda r, s: _uniform(r, s, b)),
            ((3 * C,), lambda r, s: _uniform(r, s, b)),
            ((C, C), lambda r, s: _uniform(r, s, b)),
            ((C,), lambda r, s: _uniform(r, s, b)),
            ((heads, 15, 15), lambda r, s: 0.02 * r.normal(size=s))]
    if entry == "wmsa_block":
        spec = [((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
                ((C,), lambda r, s: 0.1 * r.normal(size=s)),
                ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s))] + spec
        fn, ref = wm.wmsa_block, wm.wmsa_block_ref
    else:
        fn, ref = wa.wmsa_attention, wa.wmsa_attention_ref
    args = _args(rng, dt, spec)
    kw = dict(heads=heads, shifted=shifted)
    return fn(x, *args, **kw), ref(x, *args, **kw), fn(x, *args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["wmsa_block", "wmsa_attention"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(96, 12), (144, 9), (256, 8)])
@pytest.mark.parametrize("shape", [(1, 8, 24), (2, 16, 24), (2, 96, 96)])
def test_wmsa_bf16_window_counts(card, entry, shifted, C, heads, shape):
    """3 and 12 windows: fewer than the persistent grid; 288: more than
    the grid (132 or 264 blocks on an H100) and not a multiple of it, so
    some blocks walk two windows and others one. At the three path widths
    (head_dim 8, 16, 32); W and SW; one window row (H = 8), where the
    bottom row is the only row."""
    rng = np.random.default_rng(17)
    got, want, again = _wmsa_call(entry, rng, torch.bfloat16, shape, C,
                                  heads, shifted)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= TOL["bfloat16"]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,h", [(640, 1280), (128, 256)])
@pytest.mark.parametrize("shape", [(1, 7, 9), (2, 12, 23)])
def test_conv_glu_f32_tiles(card, shape, C, h, apply_ln):
    """The f32 GEMM phases at token counts below one tile (63) and not a
    multiple of either tile (552), with and without the LN; bitwise
    repeatable."""
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda()
    args = _args(rng, torch.float32, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    before = cg.conv_glu.launches
    got = cg.conv_glu(x, *args, apply_ln=apply_ln)
    want = cg.conv_glu_ref(x, *args, apply_ln=apply_ln)
    assert cg.conv_glu.launches == before + 1
    assert _rel_err(got, want) <= TOL["float32"]
    for _ in range(3):
        assert torch.equal(got, cg.conv_glu(x, *args, apply_ln=apply_ln))


@pytest.mark.cuda
@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("C,h", [(256, 512), (128, 256)])
@pytest.mark.parametrize("shape", [(1, 7, 9), (2, 12, 23), (2, 10, 21),
                                   (2, 64, 96)])
def test_conv_glu_bf16_phases(card, shape, C, h, apply_ln):
    """The bf16 wgmma phases at token counts below one 128-row tile (63),
    not a multiple of it (552, 420) and at the path's shape (12,288), with
    and without the LN; 1e-2 of max against the
    plain version (the largest error measured is 4.7e-3); bitwise
    repeatable; one launch counted a call."""
    rng = np.random.default_rng(19)
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    before = cg.conv_glu.launches
    got = cg.conv_glu(x, *args, apply_ln=apply_ln)
    want = cg.conv_glu_ref(x, *args, apply_ln=apply_ln)
    assert cg.conv_glu.launches == before + 1
    assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= 1e-2
    for _ in range(3):
        assert torch.equal(got, cg.conv_glu(x, *args, apply_ln=apply_ln))


@pytest.mark.cuda
@pytest.mark.parametrize("band_rows", [1, 5, 1000])
def test_conv_glu_bf16_bands(card, band_rows, monkeypatch):
    """Bands of one row, bands that cross the border between the images
    (H = 12, five rows a band) and one band for the whole call give the
    same bits: the walk changes where [g | v] waits, not what is summed."""
    rng = np.random.default_rng(20)
    C, h, shape = 128, 256, (2, 12, 23)
    dt = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda().to(dt)
    args = _args(rng, dt, [
        ((C,), lambda r, s: 1 + 0.1 * r.normal(size=s)),
        ((C,), lambda r, s: 0.1 * r.normal(size=s)),
        ((2 * h, C), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((2 * h,), lambda r, s: _uniform(r, s, C ** -0.5)),
        ((h, 1, 3, 3), lambda r, s: _uniform(r, s, 1 / 3)),
        ((h,), lambda r, s: _uniform(r, s, 1 / 3)),
        ((C, h), lambda r, s: _uniform(r, s, h ** -0.5)),
        ((C,), lambda r, s: _uniform(r, s, h ** -0.5)),
    ])
    default = cg.conv_glu(x, *args)
    monkeypatch.setattr(cg, "BAND_BYTES", band_rows * shape[2] * 2 * h * 4)
    got = cg.conv_glu(x, *args)
    assert _rel_err(got, cg.conv_glu_ref(x, *args)) <= 1e-2
    assert torch.equal(got, default)


# ------------------------------------------------------ the lane coders --

def _lane_tables(adversarial: bool = False):
    """CDF rows for the lane-coder tests: nine random rows, or six rows of
    one dominant bucket among width-1 buckets (the state division's
    extremes)."""
    from dcae_tpu_torch.entropy import rans

    rng = np.random.default_rng(7)
    rows, maxlen = (6, 34) if adversarial else (9, 60)
    cdfs = np.zeros((rows, maxlen + 2), np.int32)
    lengths = np.zeros(rows, np.int32)
    offsets = rng.integers(-25, 6, rows).astype(np.int32)
    for r in range(rows):
        n = int(rng.integers(3, maxlen))
        if adversarial:
            counts = np.ones(n, np.int64)
            counts[int(rng.integers(0, n))] = (1 << 16) - n + 1
            cdf = np.concatenate([[0], np.cumsum(counts)])
        else:
            pmf = rng.uniform(0.001, 1, n).astype(np.float32)
            pmf /= pmf.sum() * 1.0005
            cdf = rans.pmf_to_quantized_cdf(
                np.concatenate([pmf, [1 - pmf.sum()]]))
        cdfs[r, :len(cdf)] = cdf
        lengths[r] = len(cdf)
    return cdfs, lengths, offsets


def _lane_draw(tables, n, seed):
    cdfs, lengths, offsets = tables
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cdfs.shape[0], n).astype(np.int32)
    val = (rng.random(n) * (lengths[idx] - 2)).astype(np.int32)
    return val + offsets[idx], idx


LANE_CASES = [(50_000, 1024), (49_152, 512), (777, 16), (64, 64), (5, 8),
              (1, 1), (3000, 100), (70_000, 2048), (9000, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("n,K", LANE_CASES)
def test_rans_lanes_encode_kernel(card, n, K, adversarial):
    """Two chained slices: the kernel's words, counts, states and escape
    flag equal the plain version's and the C++ host coder's stream, for
    one lane a thread (K <= 1024) and for the wide kernel."""
    from dcae_tpu_torch.entropy import device_decode as dd
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables(adversarial)
    enc_sf, offs, maxpos, stride = dd.enc_tables_to_device(
        dd.build_enc_tables(*tables), "cuda")
    state_k = state_p = host_state = None
    for s in (1, 0):
        sym, idx = _lane_draw(tables, n, seed=31 * n + s)
        stream, host_state = rans.encode_interleaved(
            sym, idx, *tables, K, init_states=host_state)
        pos = torch.from_numpy(sym - tables[2][idx]).cuda()
        idx_d = torch.from_numpy(idx).cuda()
        ok = torch.ones(n, dtype=torch.bool, device="cuda")
        before = rl.rans_lanes_encode.launches
        w, nw, state_k, esc = rl.rans_lanes_encode(pos, idx_d, ok, enc_sf,
                                                   stride, K, state_k)
        assert rl.rans_lanes_encode.launches == before + 1
        w_p, nw_p, state_p, esc_p = rl.rans_lanes_encode_ref(
            pos, idx_d, ok, enc_sf, stride, K, state_p)
        assert torch.equal(w, w_p) and torch.equal(nw, nw_p)
        assert torch.equal(state_k, state_p)
        assert not bool(esc) and not bool(esc_p)
        assert rl.to_u16(w)[:int(nw)][::-1].tobytes() == stream
        assert np.array_equal(rl.to_u32(state_k), host_state)


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("n,K", LANE_CASES)
def test_rans_lanes_decode_kernel(card, n, K, paired):
    """Two chained slices of the host coder's streams, padded: symbols, ok
    and final states equal the plain version's, the symbols are the
    encoder's, and the chain ends at the 2^16 base."""
    from dcae_tpu_torch.entropy import device_decode as dd
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables()
    luts = dd.slot_tables_to_device(
        dd.build_slot_tables(*tables, paired=paired), "cuda")
    data = [_lane_draw(tables, n, seed=17 * n + s) for s in range(2)]
    streams, st = [None, None], None
    for s in (1, 0):
        streams[s], st = rans.encode_interleaved(*data[s], *tables, K,
                                                 init_states=st)
    state_k = state_p = rl.u32_bits(st, "cuda")
    for s in range(2):
        words = np.frombuffer(streams[s], np.uint16)
        padded = rl.u16_bits(np.concatenate(
            [words, np.full(77, 0xABCD, np.uint16)]), "cuda")
        nw = torch.tensor(len(words), dtype=torch.int32).cuda()
        idx_d = torch.from_numpy(data[s][1]).cuda()
        before = rl.rans_lanes_decode.launches
        sym_k, ok_k, state_k = rl.rans_lanes_decode(
            padded, nw, state_k, idx_d, *luts, K, paired, s == 1)
        assert rl.rans_lanes_decode.launches == before + 1
        sym_p, ok_p, state_p = rl.rans_lanes_decode_ref(
            padded, nw, state_p, idx_d, *luts, K, paired, s == 1)
        assert bool(ok_k) and bool(ok_p)
        assert torch.equal(sym_k, sym_p) and torch.equal(state_k, state_p)
        assert np.array_equal(sym_k.cpu().numpy(), data[s][0])
    assert bool((state_k == rl.RANS_L16).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 2048])
def test_rans_lanes_kernels_flag_faults(card, K):
    """A flipped word, a bumped state, a short stream and a coding index
    outside the table give ok = false and no fault; a symbol marked out of
    range or a zero-width bucket raises the encoder's escape flag."""
    from dcae_tpu_torch.entropy import device_decode as dd
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables()
    n = 30_000
    sym, idx = _lane_draw(tables, n, seed=4)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    luts = dd.slot_tables_to_device(dd.build_slot_tables(*tables), "cuda")
    words = np.frombuffer(stream, np.uint16)
    idx_d = torch.from_numpy(idx).cuda()

    def ok(words, n_words, states, idx_d=idx_d):
        res = rl.rans_lanes_decode(
            rl.u16_bits(words, "cuda"),
            torch.tensor(n_words, dtype=torch.int32).cuda(),
            rl.u32_bits(states, "cuda"), idx_d, *luts, K)
        torch.cuda.synchronize()
        return bool(res[1])

    assert ok(words, len(words), states)
    flipped = words.copy()
    flipped[50] ^= 0xFFFF
    assert not ok(flipped, len(words), states)
    bumped = states.copy()
    bumped[0] += 1
    assert not ok(words, len(words), bumped)
    assert not ok(words[:-3], len(words) - 3, states)
    assert not ok(words, len(words) + 5, states)       # count past the buffer
    wild = idx_d.clone()
    wild[7] = 1000
    assert not ok(words, len(words), states, wild)

    cdfs, lengths, offsets = (a.copy() for a in tables)
    r = idx[123]
    cdfs[r, 2] = cdfs[r, 1]                            # bucket 1 has width 0
    tabs = dd.enc_tables_to_device(
        dd.build_enc_tables(cdfs, lengths, offsets), "cuda")
    pos = torch.from_numpy(sym - offsets[idx]).cuda()
    in_range = torch.ones(n, dtype=torch.bool, device="cuda")
    good = dd.enc_tables_to_device(dd.build_enc_tables(*tables), "cuda")
    assert not bool(rl.rans_lanes_encode(pos, idx_d, in_range, good[0],
                                         good[3], K)[3])
    marked = in_range.clone()
    marked[n - 1] = False
    zero_width = pos.clone()
    zero_width[123] = 1
    got = rl.rans_lanes_encode(zero_width, idx_d, in_range, tabs[0],
                               tabs[3], K)
    want = rl.rans_lanes_encode_ref(zero_width, idx_d, in_range, tabs[0],
                                    tabs[3], K)
    assert bool(got[3]) and bool(want[3])
    assert bool(rl.rans_lanes_encode(pos, idx_d, marked, good[0], good[3],
                                     K)[3])


@pytest.mark.cuda
def test_rans_lanes_wrappers_refuse_wrong_operands(card):
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    i32 = dict(dtype=torch.int32, device="cuda")
    idx = torch.zeros(8, **i32)
    with pytest.raises(TypeError, match="dtype"):
        rl.rans_lanes_encode(idx.long(), idx, idx.bool(), idx, 1, 4)
    with pytest.raises(ValueError, match="lanes"):
        rl.rans_lanes_encode(idx, idx, idx.bool(), idx, 1, 1 << 16)
    with pytest.raises(ValueError, match="states"):
        rl.rans_lanes_decode(torch.zeros(4, dtype=torch.int16,
                                         device="cuda"),
                             torch.zeros((), **i32), torch.zeros(3, **i32),
                             idx, torch.zeros(1 << 16, **i32),
                             torch.zeros(1 << 16, **i32), 4)
    with pytest.raises(ValueError, match="operands on"):
        rl.rans_lanes_decode(torch.zeros(4, dtype=torch.int16),
                             torch.zeros((), **i32), torch.zeros(4, **i32),
                             idx, torch.zeros(1 << 16, **i32),
                             torch.zeros(1 << 16, **i32), 4)
