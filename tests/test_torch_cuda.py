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

from dcae_tpu_torch.ops.kernels import conv2d_nhwc as cv
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["wmsa_block", "wmsa_attention"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(96, 12), (144, 9), (256, 8)])
@pytest.mark.parametrize("shape", [(1, 8, 24), (2, 16, 24), (2, 64, 64),
                                   (2, 96, 96)])
def test_wmsa_window_counts(card, entry, shifted, C, heads, shape, dtype):
    """3 and 12 windows: fewer than the persistent grid; 128 (the training
    path's stage 3) and 288: about one grid and more than the grid (132
    or 264 blocks on an H100), not a multiple of it, so some blocks walk
    two windows and others one. At the three path widths (head_dim 8, 16,
    32: f32 head groups of 48, 48, 64 channels); W and SW; one window row
    (H = 8), where the bottom row is the only row; both dtypes, bitwise
    repeatable."""
    rng = np.random.default_rng(17)
    dt = getattr(torch, dtype)
    got, want, again = _wmsa_call(entry, rng, dt, shape, C, heads, shifted)
    assert got.dtype == dt
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["wmsa_block", "wmsa_attention"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(16, 2), (32, 4), (48, 6), (64, 2),
                                     (80, 5), (112, 14), (192, 6),
                                     (224, 14), (240, 10), (256, 32)])
def test_wmsa_widths(card, entry, shifted, C, heads, dtype):
    """Widths off the model's path, taken by the same rule: f32 head groups
    of 16, 32, 48 and 64 channels (3 gw / 16 = 3, 6, 9, 12 tiles of qkv) at
    1 to 16 tiles of proj (C / 16), head_dim 8 to 32, 32 heads' bias
    tables; 12 windows, W and SW, bitwise repeatable."""
    rng = np.random.default_rng(18)
    dt = getattr(torch, dtype)
    got, want, again = _wmsa_call(entry, rng, dt, (2, 16, 24), C, heads,
                                  shifted)
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_wmsa_width_rule_is_the_library_rule(card):
    """kernel_takes and the library's own check (its shared-memory query
    answers -1 for a width it does not take) agree at every C up to 264
    and every head count that divides it, in both dtypes; every taken
    width fits a block's shared memory."""
    from dcae_tpu_torch.ops.kernels import _build

    smem = wm._entries()["smem"]
    for C in range(8, 272, 8):
        for heads in (h for h in range(1, C + 1) if C % h == 0):
            for bf16, dt in ((0, torch.float32), (1, torch.bfloat16)):
                need = smem(C, heads, bf16)
                assert wm.kernel_takes(C, heads, dt) == (need >= 0), \
                    (C, heads, dt)
                assert need <= _build.SMEM_LIMIT, (C, heads, dt)


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


def _row_tables(tables):
    from dcae_tpu_torch.entropy import device_decode as dd

    return dd.row_tables_to_device(dd.build_row_tables(*tables), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("n,K", LANE_CASES)
def test_rans_lanes_encode_kernel(card, n, K, adversarial):
    """Two chained slices: the kernel's words, counts, states and escape
    flag equal the plain version's and the C++ host coder's stream, for
    one lane a thread (K <= 1024) and for the wide kernel."""
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables(adversarial)
    _, table = _row_tables(tables)
    state_k = state_p = host_state = None
    for s in (1, 0):
        sym, idx = _lane_draw(tables, n, seed=31 * n + s)
        stream, host_state = rans.encode_interleaved(
            sym, idx, *tables, K, init_states=host_state)
        pos = torch.from_numpy(sym - tables[2][idx]).cuda()
        idx_d = torch.from_numpy(idx).cuda()
        ok = torch.ones(n, dtype=torch.bool, device="cuda")
        before = rl.rans_lanes_encode.launches
        w, nw, state_k, esc = rl.rans_lanes_encode(pos, idx_d, ok, table, K,
                                                   state_k)
        assert rl.rans_lanes_encode.launches == before + 1
        w_p, nw_p, state_p, esc_p = rl.rans_lanes_encode_ref(
            pos, idx_d, ok, table, K, state_p)
        assert torch.equal(w, w_p) and torch.equal(nw, nw_p)
        assert torch.equal(state_k, state_p)
        assert not bool(esc) and not bool(esc_p)
        assert rl.to_u16(w)[:int(nw)][::-1].tobytes() == stream
        assert np.array_equal(rl.to_u32(state_k), host_state)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K", LANE_CASES)
def test_rans_lanes_decode_kernel(card, n, K):
    """Two chained slices of the host coder's streams, padded: symbols, ok
    and final states equal the plain version's (and device_decode's
    chained decode's), the symbols are the encoder's, and the chain ends
    at the 2^16 base."""
    from dcae_tpu_torch.entropy import device_decode as dd
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables()
    luts = _row_tables(tables)
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
        chained = dd.decode_interleaved_chain(padded, nw, state_k, idx_d,
                                              *luts, K)
        sym_k, ok_k, state_k = rl.rans_lanes_decode(
            padded, nw, state_k, idx_d, *luts, K, s == 1)
        assert rl.rans_lanes_decode.launches == before + 2
        sym_p, ok_p, state_p = rl.rans_lanes_decode_ref(
            padded, nw, state_p, idx_d, *luts, K, s == 1)
        assert bool(ok_k) and bool(ok_p)
        assert torch.equal(sym_k, sym_p) and torch.equal(state_k, state_p)
        assert torch.equal(chained[0], sym_k) and bool(chained[1])
        assert torch.equal(chained[2], state_k)
        assert np.array_equal(sym_k.cpu().numpy(), data[s][0])
    assert bool((state_k == rl.RANS_L16).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", range(8))
@pytest.mark.parametrize("n,K", [(5, 8), (64, 64), (777, 16),
                                 (30_000, 256)])
def test_rans_lanes_decode_any_word_alignment(card, n, K, shift):
    """The word ring takes a stream at any 2-byte offset from a 16-byte
    boundary: the few words before and after the 16-byte body come apart
    from the bulk copies."""
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables()
    luts = _row_tables(tables)
    sym, idx = _lane_draw(tables, n, seed=n + shift)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    words = np.frombuffer(stream, np.uint16)
    buf = np.full(len(words) + 16, 0xABCD, np.uint16)
    buf[shift:shift + len(words)] = words
    view = rl.u16_bits(buf, "cuda")[shift:shift + len(words)]
    if len(words):                     # an empty view has no address
        assert view.data_ptr() % 16 == 2 * shift
    nw = torch.tensor(len(words), dtype=torch.int32).cuda()
    st = rl.u32_bits(states, "cuda")
    idx_d = torch.from_numpy(idx).cuda()
    sym_k, ok_k, st_k = rl.rans_lanes_decode(view, nw, st, idx_d, *luts, K)
    sym_p, ok_p, st_p = rl.rans_lanes_decode_ref(view, nw, st, idx_d, *luts,
                                                 K, True)
    assert bool(ok_k) and bool(ok_p)
    assert torch.equal(sym_k, sym_p) and torch.equal(st_k, st_p)
    assert np.array_equal(sym_k.cpu().numpy(), sym)


@pytest.mark.cuda
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("K", [256, 512, 1024, 2048])
def test_rans_lanes_kernels_on_the_gaussian_bank(card, K, narrow):
    """The codec's 64-row bank, its whole row table in shared memory: the
    kernels equal their plain versions and the host coder on symbols drawn
    from the rows' own pmfs, over every row or over the 8 narrowest (as a
    trained model's latents mostly code)."""
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.entropy.gaussian import get_scale_table
    from dcae_tpu_torch.entropy.tables import build_gaussian_table
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    g = build_gaussian_table(get_scale_table())
    tables = (g.quantized_cdf, g.cdf_length, g.offset)
    offs, table = _row_tables(tables)
    rng = np.random.default_rng(K + narrow)
    n = 60 * K
    idx = rng.integers(0, 8 if narrow else len(g.cdf_length),
                       n).astype(np.int32)
    slot = rng.integers(0, 1 << 16, n)
    pos = np.array([np.searchsorted(g.quantized_cdf[r, :g.cdf_length[r]], v,
                                    side="right") - 1
                    for r, v in zip(idx, slot)])
    pos = np.minimum(pos, g.cdf_length[idx] - 3)
    sym = (pos + g.offset[idx]).astype(np.int32)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    pos_d = torch.from_numpy(pos.astype(np.int32)).cuda()
    idx_d = torch.from_numpy(idx).cuda()
    inr = torch.ones(n, dtype=torch.bool, device="cuda")
    enc = rl.rans_lanes_encode(pos_d, idx_d, inr, table, K)
    enc_p = rl.rans_lanes_encode_ref(pos_d, idx_d, inr, table, K)
    assert all(torch.equal(a, b) for a, b in zip(enc, enc_p))
    assert rl.to_u16(enc[0])[:int(enc[1])][::-1].tobytes() == stream
    assert np.array_equal(rl.to_u32(enc[2]), states)
    words = rl.u16_bits(np.frombuffer(stream, np.uint16), "cuda")
    nw = torch.tensor(words.numel(), dtype=torch.int32).cuda()
    st = rl.u32_bits(states, "cuda")
    dec = rl.rans_lanes_decode(words, nw, st, idx_d, offs, table, K)
    dec_p = rl.rans_lanes_decode_ref(words, nw, st, idx_d, offs, table, K,
                                     True)
    assert bool(dec[1]) and bool(dec_p[1])
    assert torch.equal(dec[0], dec_p[0]) and torch.equal(dec[2], dec_p[2])
    assert np.array_equal(dec[0].cpu().numpy(), sym)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 2048])
def test_rans_lanes_kernels_flag_faults(card, K):
    """A flipped word, a bumped state, a short stream and a coding index
    outside the table give ok = false and no fault; a symbol marked out of
    range or a zero-width bucket raises the encoder's escape flag."""
    from dcae_tpu_torch.entropy import rans
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    tables = _lane_tables()
    n = 30_000
    sym, idx = _lane_draw(tables, n, seed=4)
    stream, states = rans.encode_interleaved(sym, idx, *tables, K)
    luts = _row_tables(tables)
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
    _, zw_table = _row_tables((cdfs, lengths, offsets))
    pos = torch.from_numpy(sym - offsets[idx]).cuda()
    in_range = torch.ones(n, dtype=torch.bool, device="cuda")
    table = luts[1]
    assert not bool(rl.rans_lanes_encode(pos, idx_d, in_range, table, K)[3])
    marked = in_range.clone()
    marked[n - 1] = False
    zero_width = pos.clone()
    zero_width[123] = 1
    got = rl.rans_lanes_encode(zero_width, idx_d, in_range, zw_table, K)
    want = rl.rans_lanes_encode_ref(zero_width, idx_d, in_range, zw_table, K)
    assert bool(got[3]) and bool(want[3])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(rl.rans_lanes_encode(pos, idx_d, marked, table, K)[3])


@pytest.mark.cuda
def test_rans_lanes_wrappers_refuse_wrong_operands(card):
    from dcae_tpu_torch.ops.kernels import rans_lanes as rl

    i32 = dict(dtype=torch.int32, device="cuda")
    idx = torch.zeros(8, **i32)
    luts = _row_tables(_lane_tables())
    with pytest.raises(TypeError, match="dtype"):
        rl.rans_lanes_encode(idx.long(), idx, idx.bool(), luts[1], 4)
    with pytest.raises(ValueError, match="lanes"):
        rl.rans_lanes_encode(idx, idx, idx.bool(), luts[1], 1 << 16)
    with pytest.raises(ValueError, match="states"):
        rl.rans_lanes_decode(torch.zeros(4, dtype=torch.int16,
                                         device="cuda"),
                             torch.zeros((), **i32), torch.zeros(3, **i32),
                             idx, *luts, 4)
    with pytest.raises(ValueError, match="operands on"):
        rl.rans_lanes_decode(torch.zeros(4, dtype=torch.int16),
                             torch.zeros((), **i32), torch.zeros(4, **i32),
                             idx, *luts, 4)
    with pytest.raises(ValueError, match="16-byte"):
        rl.rans_lanes_encode(idx, idx, idx.bool(), luts[1][1:], 4)


# ------------------------------------------------- gradients on the card --
# The wrappers' autograd Functions: kernel forward, recompute backward. A
# module's parameter gradients on the card against the same module on the
# CPU (plain versions) to the forward's tolerance, f32.

def _grads_on(module_factory, x, device):
    torch.manual_seed(0)
    m = module_factory().to(device)
    xin = x.to(device).requires_grad_(True)
    out = m(xin)
    out.square().mean().backward()
    return out, xin.grad, {n: p.grad for n, p in m.named_parameters()}


def _same_grads(module_factory, x, counter, launches, skip=()):
    """Seeded weights, then the module's input and parameter gradients on
    the card against the CPU's; `counter` must count `launches` forward
    launches; parameter names ending in one of `skip` are left out."""
    from dcae_tpu_torch.ops.layers import reset_layer

    def seeded():
        m = module_factory()
        gen = torch.Generator().manual_seed(3)
        for sub in m.modules():
            reset_layer(sub, gen)
        with torch.no_grad():
            for n, p in m.named_parameters():
                if "relative_position" in n or n.endswith("scale"):
                    p.copy_(1 + 0.02 * torch.randn(p.shape, generator=gen))
        return m

    # full-f32 products on the card, as the trainer sets them (cuDNN's
    # convolutions default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = counter.launches
    out, gx, grads = _grads_on(seeded, x, "cuda")
    assert counter.launches == before + launches
    assert out.grad_fn is not None
    _, gx_cpu, grads_cpu = _grads_on(seeded, x, "cpu")
    assert _rel_err(gx.cpu(), gx_cpu) <= TOL["float32"]
    for n, g in grads.items():
        assert g is not None and bool(torch.isfinite(g).all()), n
        if not n.endswith(tuple(skip)):
            assert _rel_err(g.cpu(), grads_cpu[n]) <= TOL["float32"], n


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_block_parameter_gradients_match_cpu(card, fused):
    """A window-8 Swin block at stage-3 width: wmsa_block (fused) or
    wmsa_attention, and the routed conv_glu, each through its Function."""
    from dcae_tpu_torch.ops.blocks import ResScaleConvolutionGateBlock

    x = torch.from_numpy(np.random.default_rng(30).normal(
        size=(2, 16, 16, 256)).astype(np.float32))
    counter = wm.wmsa_block if fused else wa.wmsa_attention
    glu_before = cg.conv_glu.launches
    _same_grads(lambda: ResScaleConvolutionGateBlock(
        256, 32, 8, shifted=True, fused_attention_block=fused), x, counter,
        1)
    assert cg.conv_glu.launches == glu_before + 1


@pytest.mark.cuda
def test_glu_parameter_gradients_match_cpu(card):
    from dcae_tpu_torch.ops.blocks import ConvolutionalGLU
    from torch import nn

    class Glu(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(128)
            self.mlp = ConvolutionalGLU(128, 512)

        def forward(self, x):
            return self.mlp.fused(x, self.ln)

    x = torch.from_numpy(np.random.default_rng(31).normal(
        size=(2, 9, 11, 128)).astype(np.float32))
    _same_grads(Glu, x, cg.conv_glu, 1)


@pytest.mark.cuda
def test_dictionary_attention_parameter_gradients_match_cpu(card):
    """The DCA module at full width: its GLU (C=640, h=1280) goes through
    conv_glu's Function."""
    from dcae_tpu_torch.ops.dictionary import DictionaryCrossAttention
    from torch import nn

    class Dca(nn.Module):
        def __init__(self):
            super().__init__()
            self.dca = DictionaryCrossAttention(320, 320)
            self.dt = nn.Parameter(torch.empty(128, 640))

        def forward(self, x):
            return self.dca(x, self.dt)

    def factory():
        m = Dca()
        with torch.no_grad():
            m.dt.copy_(torch.randn(m.dt.shape,
                                   generator=torch.Generator()
                                   .manual_seed(1)))
        return m

    x = torch.from_numpy(np.random.default_rng(32).normal(
        size=(1, 8, 8, 320)).astype(np.float32))
    # the key bias's true gradient is 0 (softmax ignores a shift of every
    # score): both devices hold rounding noise there, so it is left out
    _same_grads(factory, x, cg.conv_glu, 1, skip=("dca.k.bias",))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wmsa_block", "wmsa_attention",
                                    "conv_glu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_requires_grad_input_yields_grad_fn(card, kernel, dtype):
    """Each public wrapper returns a differentiable output for an input
    that requires grad (and none under no_grad), with gradients in the
    operands' dtype."""
    rng = np.random.default_rng(33)
    dt = getattr(torch, dtype)
    C, heads, h = 128, 4, 256
    b = C ** -0.5
    x = torch.from_numpy(rng.normal(size=(1, 8, 16, C)).astype(
        np.float32)).cuda().to(dt).requires_grad_(True)
    vec = lambda r, s: 0.1 * r.normal(size=s)            # noqa: E731
    mat = lambda r, s: _uniform(r, s, b)                 # noqa: E731
    if kernel == "conv_glu":
        args = _args(rng, dt, [((C,), vec), ((C,), vec), ((2 * h, C), mat),
                               ((2 * h,), mat), ((h, 1, 3, 3), mat),
                               ((h,), mat), ((C, h), mat), ((C,), mat)])
        fn, kw = cg.conv_glu, {}
    else:
        shapes = [((3 * C, C), mat), ((3 * C,), mat), ((C, C), mat),
                  ((C,), mat), ((heads, 15, 15), vec)]
        if kernel == "wmsa_block":
            shapes = [((C,), vec)] * 3 + shapes
            fn = wm.wmsa_block
        else:
            fn = wa.wmsa_attention
        args = _args(rng, dt, shapes)
        kw = dict(heads=heads, shifted=True)
    args[-1].requires_grad_(True)
    with torch.no_grad():
        assert fn(x, *args, **kw).grad_fn is None
    out = fn(x, *args, **kw)
    assert out.grad_fn is not None and out.dtype == dt
    out.float().sum().backward()
    for t in (x, args[-1]):
        assert t.grad is not None and t.grad.dtype == dt
        assert bool(torch.isfinite(t.grad.float()).all())
    assert args[0].grad is None


# ---------------------------------------------------- split deployment --

def _tiny_w8():
    from chip_smoke import TINY_W8
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE

    cfg = DCAEConfig.tiny(**TINY_W8)
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, init.state_dict()


@pytest.mark.cuda
def test_split_halves_on_card_equal_halves_on_cpu(card):
    """An encoder half on the card writes the streams an encoder half on
    the CPU writes (f32, the tiny window-8 model, whose widths the window
    kernels take); a decoder half on the card decodes them exactly, with
    the encoder's indexes shipped and without."""
    from dcae_tpu_torch.models.split import make_split_pair

    cfg, sd = _tiny_w8()
    x = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    x = np.clip(x * 0.3 + 0.35, 0, 1)
    cpu_enc, cpu_dec = make_split_pair(cfg, sd, "cpu", "cpu")
    enc, dec = make_split_pair(cfg, sd, "cuda", "cuda")
    want = cpu_enc.compress(x)
    rec = []
    got = enc.compress(x, record=rec)
    assert got["strings"] == want["strings"]
    dec_rec = []
    out = dec.decompress(got["strings"], got["shape"], record=dec_rec)
    assert len(dec_rec) == len(rec) == cfg.num_slices
    for (ei, es), (di, ds) in zip(rec, dec_rec):
        np.testing.assert_array_equal(di, ei)
        np.testing.assert_array_equal(ds, es)
    shipped = enc.codec.compress_with_indexes(x)
    out2 = dec.decompress(shipped["strings"], shipped["shape"],
                          indexes=shipped["indexes"])
    ref = cpu_dec.decompress(want["strings"], want["shape"])["x_hat"]
    for o in (out["x_hat"], out2["x_hat"]):
        assert _rel_err(o.cpu(), ref) < 1e-4
    for c in (cpu_enc, cpu_dec, enc, dec):
        c.close()


@pytest.mark.cuda
def test_split_step_on_card_equals_cpu(card):
    """The tiny window-8 split step with both halves on the card against
    the same step on the CPU (fixed noise), held to the tiny card step's
    bars (chip_smoke.tiny_step_passes, calibrated in PR 7)."""
    import chip_smoke as cs
    from dcae_tpu_torch.entropy import ops
    from dcae_tpu_torch.train.split_step import (create_split_train_state,
                                                 make_split_train_step)
    from dcae_tpu_torch.train.state import make_optimizer

    cfg, _ = _tiny_w8()
    batch = torch.from_numpy(cs.train_batch(2, 128, seed=3))
    lr = 1e-4
    tx = make_optimizer(lr, 1e-3, 1.0)

    def step(dev):
        model = cs.seeded_model(cfg, "cpu")
        state = create_split_train_state(model, tx, dev, dev)
        _, m = make_split_train_step(model, tx, cs.LMBDA, "mse", dev,
                                     dev)(state, batch)
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                {n: p.detach().cpu() for n, p in model.named_parameters()})

    real, ops.noise_quantize = ops.noise_quantize, cs.fixed_noise
    try:
        ref, got = step("cpu"), step("cuda")
    finally:
        ops.noise_quantize = real
    res = cs.compare_steps(ref, got, lr)
    assert cs.tiny_step_passes(res), res


@pytest.mark.cuda
def test_serving_loops_on_card_equal_sequential_calls(card):
    """Both serving loops on the card (the tiny window-8 model, f32) give
    each batch what the sequential calls give it, bitwise, in order."""
    from dcae_tpu_torch.entropy.rans import EscapeError
    from dcae_tpu_torch.models.codec import DCAECodec

    cfg, sd = _tiny_w8()
    codec = DCAECodec(cfg, params=sd, device="cuda")
    codec.update()
    rng = np.random.default_rng(5)
    batches = [np.clip(rng.uniform(0, 1, (n, 128, 128, 3)) * 0.3 + 0.35,
                       0, 1).astype(np.float32) for n in (2, 1, 2)]
    codec.patch_cap = 2 * 128 * 128          # no overflow at random weights
    for got, x in zip(codec.encdec_pipeline_interleaved(batches), batches):
        try:
            want = codec.decompress_interleaved(codec.compress_device(x))
            assert got["profile"] == "interleaved" and bool(got["ok"])
        except EscapeError:
            enc = codec.compress(x)
            want = codec.decompress(enc["strings"], enc["shape"])
            assert got["profile"] == "classic"
        assert torch.equal(got["x_hat"], want["x_hat"])
    for got, x in zip(codec.encdec_pipeline(batches), batches):
        enc = codec.compress(x)
        assert got["strings"] == enc["strings"]
        assert torch.equal(got["x_hat"], codec.decompress(
            enc["strings"], enc["shape"])["x_hat"])
    codec.close()


@pytest.mark.cuda
def test_server_decodes_on_arrival_on_card(card, tmp_path):
    """tools/server.py's decoder on a BitstreamServer, its codec on the
    card: a classic .bin and a DTI2 payload each decode to the direct
    decode of the same bytes, bitwise."""
    import threading

    from dcae_tpu_torch.models.codec import DCAECodec
    from dcae_tpu_torch.runtime import container
    from dcae_tpu_torch.runtime.service import BitstreamServer, send_bytes
    from dcae_tpu_torch.tools.server import payload_decoder

    cfg, sd = _tiny_w8()
    codec = DCAECodec(cfg, params=sd, device="cuda")
    codec.update()
    codec.patch_cap = 128 * 128
    x = np.clip(np.random.default_rng(6).uniform(0, 1, (1, 128, 128, 3))
                * 0.3 + 0.35, 0, 1).astype(np.float32)
    enc = codec.compress(x)
    payloads = {"c.bin": container.pack_bin(enc["strings"], (128, 128)),
                "d.bin": container.pack_bin_interleaved(
                    codec.compress_device(x), (128, 128))}
    served, done = {}, threading.Event()

    def on_decoded(name, x_hat):
        served[name] = x_hat
        done.set()

    srv = BitstreamServer(0, str(tmp_path),
                          payload_decoder(codec, str(tmp_path), on_decoded))
    srv.start(background=True)
    try:
        for name, blob in payloads.items():
            done.clear()
            send_bytes(name, blob, "127.0.0.1", srv.bound_port)
            assert done.wait(60), name
    finally:
        srv.stop()
    c = container.unpack_bin(payloads["c.bin"], cfg.pad_multiple,
                             cfg.z_downsample)
    assert torch.equal(served["c.bin"],
                       codec.decompress(c[0], c[1])["x_hat"])
    d, _, _ = container.unpack_bin_interleaved(
        payloads["d.bin"], cfg.pad_multiple, cfg.z_downsample)
    assert torch.equal(served["d.bin"],
                       codec.decompress_interleaved(d)["x_hat"])
    codec.close()


@pytest.mark.cuda
def test_dp_over_cards_equals_one_card(card, tmp_path):
    """Every card of the machine a rank (NCCL, tests/torch_dp_worker.py
    in its card mode), the tiny window-8 model in f32, 2 rows a rank, two
    steps: every rank bitwise alike, and equal to the same shards' steps
    computed one after another on one card (torch_dp_common.
    shard_mean_steps; the all-reduce sums in another order): step 1's
    gradients within 1e-5 of the largest gradient, the parameters 99%
    within 1e-3 lr and all within the tiny card step's 2.1 lr a step.
    Against the whole batch on one card the difference is printed, not
    held: cuDNN picks its algorithms by the batch's shape (on four H100s
    4.3e-4 of one gradient tensor's largest, 0.47 lr in the parameters);
    on the CPU the whole batch agrees to 1e-6 of the largest parameter
    (tests/test_torch_parallel.py). Needs two cards at least."""
    import os
    import socket
    import subprocess
    import sys

    from dcae_tpu_torch.ops.kernels import _build
    from tests.torch_dp_common import (TRAIN_KW, card_config, global_batch,
                                       shard_mean_steps, state_and_step)

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    _build.build_kernels()                # once, before the ranks start
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_dp_worker.py"),
         str(port), str(n), str(r), str(tmp_path), "cuda"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the dp ranks timed out:\n" + "\n".join(
            p.communicate()[0] for p in procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    got = [np.load(str(tmp_path / f"w{n}r{r}_step.npz")) for r in range(n)]
    got_grads = np.load(str(tmp_path / f"w{n}r0_grad.npz"))
    for k in got[0].files:
        assert all(np.array_equal(g[k], got[0][k]) for g in got), k

    # full-f32 products, as in the ranks and the trainer
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = torch.from_numpy(global_batch(2 * n, 128)).to("cuda:0")
    try:
        model, grads = shard_mean_steps(card_config(), "cuda:0", batch, n,
                                        **TRAIN_KW)
        whole, state, step = state_and_step(card_config(), "cuda:0",
                                            **TRAIN_KW)
        state, _ = step(state, batch)
        whole_grads = {k: p.grad.cpu().numpy()
                       for k, p in whole.named_parameters()}
        state, _ = step(state, batch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before

    def compare(ref_model, ref_grads):
        """(largest gradient difference over the largest gradient, the
        parameters' largest and 99th-percentile difference in lr)."""
        g_scale = max(float(np.abs(v).max()) for k, v in ref_grads.items()
                      if not k.endswith(".k.bias"))
        g = max(float(np.abs(got_grads[k] - v).max())
                for k, v in ref_grads.items() if not k.endswith(".k.bias"))
        d = np.concatenate([
            np.abs(got[0][k] - v.detach().cpu().numpy()).ravel()
            for k, v in ref_model.state_dict().items()])
        return g / g_scale, float(d.max()) / lr, float(
            np.quantile(d, 0.99)) / lr

    lr = 1e-4
    shard = compare(model, grads)
    wb = compare(whole, whole_grads)
    print(f"dp over {n} cards against the shards on one card: gradients "
          f"{shard[0]:.3e} of the largest, parameters {shard[1]:.3e} lr at "
          f"most, 99% within {shard[2]:.3e} lr; against the whole batch: "
          f"{wb[0]:.3e}, {wb[1]:.3e}, {wb[2]:.3e}")
    # the key biases (true gradient 0, tests/test_torch_train_step.py) are
    # left out of the gradients and held with the parameters: Adam moves
    # a near-zero gradient's rounding by up to lr a step
    assert shard[0] <= 1e-5
    assert shard[1] <= 2 * 2.1 and shard[2] <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sp_over_cards_equals_one_card(card, tmp_path, n):
    """n cards a rank each (NCCL, tests/torch_sp_worker.py in its card
    mode): sp = 2 on 2 cards, dp = 2 x sp = 2 on 4; the tiny window-8
    model in f32 on 128x128 images (the band rule's least height at
    sp = 2), 2 rows a dp index, two steps: every rank bitwise alike, and
    equal to the same dp shards' steps computed one after another, whole,
    on one card (torch_dp_common.shard_mean_steps): step 1's gradients
    within 1e-5 of the largest gradient, the parameters 99% within 1e-3 lr
    and all within the tiny card step's 2.1 lr a step. Needs n cards."""
    import os
    import socket
    import subprocess
    import sys

    from dcae_tpu_torch.ops.kernels import _build
    from tests.torch_dp_common import (TRAIN_KW, card_config, global_batch,
                                       shard_mean_steps)

    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    _build.build_kernels()                # once, before the ranks start
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_sp_worker.py"),
         str(port), str(n), "2", str(r), str(tmp_path), "cuda"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the sp ranks timed out:\n" + "\n".join(
            p.communicate()[0] for p in procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    got = [np.load(str(tmp_path / f"w{n}s2r{r}_step.npz")) for r in range(n)]
    got_grads = np.load(str(tmp_path / f"w{n}s2r0_grad.npz"))
    for k in got[0].files:
        assert all(np.array_equal(g[k], got[0][k]) for g in got), k

    # the ranks' flags: full-f32 products, deterministic cuDNN
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dp = n // 2
    try:
        model, grads = shard_mean_steps(
            card_config(), "cuda:0",
            torch.from_numpy(global_batch(2 * dp, 128)).to("cuda:0"), dp,
            **TRAIN_KW)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    lr = 1e-4
    g_scale = max(float(np.abs(v).max()) for k, v in grads.items()
                  if not k.endswith(".k.bias"))
    gaps = sorted(((float(np.abs(got_grads[k] - v).max()) / g_scale, k)
                   for k, v in grads.items() if not k.endswith(".k.bias")),
                  reverse=True)
    g = gaps[0][0] * g_scale
    d = np.concatenate([np.abs(got[0][k] - v.detach().cpu().numpy()).ravel()
                        for k, v in model.state_dict().items()])
    p_max, p99 = float(d.max()) / lr, float(np.quantile(d, 0.99)) / lr
    print(f"sp = 2 over {n} cards (dp = {dp}) against the shards on one "
          f"card: gradients {g / g_scale:.3e} of the largest, parameters "
          f"{p_max:.3e} lr at most, 99% within {p99:.3e} lr")
    # which parameters carry the gap: the five largest, of the largest
    # gradient, beside the parameter's own largest gradient
    print("largest gradient gaps: " + ", ".join(
        f"{k} {gap:.3e} (own max "
        f"{float(np.abs(grads[k]).max()) / g_scale:.3e})"
        for gap, k in gaps[:5]))
    # the key biases (true gradient 0) are held with the parameters, as in
    # test_dp_over_cards_equals_one_card
    assert g / g_scale <= 1e-5
    assert p_max <= 2 * 2.1 and p99 <= 1e-3


# ------------------------------------------------------------ conv2d_nhwc --

# every shape the codec cell routes (a batch of 8 768x512 images: the
# latent at 32 x 48, the hyper synthesis at 16 x 24): (H, W, C_in, C_out,
# k, act)
CONV2D_SHAPES = [
    *((32, 48, c, 224, 3, "gelu") for c in range(960, 1281, 64)),
    (32, 48, 224, 128, 3, "gelu"), (32, 48, 128, 64, 3, "none"),
    (32, 48, 640, 640, 1, "none"), (32, 48, 640, 640, 1, "gelu"),
    (32, 48, 2560, 640, 1, "none"),
    (16, 24, 192, 96, 1, "relu"), (16, 24, 96, 96, 3, "relu"),
    (16, 24, 96, 192, 1, "none"), (16, 24, 192, 192, 3, "none")]


@pytest.fixture
def no_tf32():
    """The plain statement in f32 on the card: cuDNN with TF32 off."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        yield


def _conv_args(rng, shape, C, N, k):
    b = (C * k * k) ** -0.5
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(
        np.float32)).cuda()
    w, bias = _args(rng, torch.float32, [
        ((N, C, k, k), lambda r, s: _uniform(r, s, b)),
        ((N,), lambda r, s: _uniform(r, s, b))])
    return x, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,N,k,act", CONV2D_SHAPES)
def test_conv2d_nhwc_at_the_codec_cells_shapes(card, no_tf32, H, W, C, N, k,
                                               act):
    """Within 1e-5 of max|plain| of the plain f32 statement, bitwise
    repeatable, and batch-invariant: each image alone equals its place in
    the batch of 8, bit for bit. One launch counted a call."""
    rng = np.random.default_rng(40)
    x, w, bias = _conv_args(rng, (8, H, W), C, N, k)
    with torch.no_grad():
        before = cv.conv2d_nhwc.launches
        got = cv.conv2d_nhwc(x, w, bias, act=act)
        assert cv.conv2d_nhwc.launches == before + 1
        assert _rel_err(got, cv.conv2d_nhwc_ref(x, w, bias, act=act)) <= 1e-5
        for _ in range(2):
            assert torch.equal(got, cv.conv2d_nhwc(x, w, bias, act=act))
        for i in range(8):
            assert torch.equal(cv.conv2d_nhwc(x[i:i + 1], w, bias, act=act),
                               got[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(shape=(1, 1, 1), C=8, N=8, k=3),          # one pixel: all padding
    dict(shape=(3, 5, 7), C=6, N=5, k=3),          # 4-byte loads, odd N
    dict(shape=(2, 9, 11), C=40, N=33, k=1, bias=False),
    dict(shape=(2, 17, 13), C=36, N=300, k=3),     # M, N past whole tiles
    dict(shape=(2, 12, 10), C=64, N=24, k=3, view=96),   # a channel slice
    dict(shape=(2, 12, 10), C=48, N=16, k=1, view=49)])  # ... unaligned
@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
def test_conv2d_nhwc_any_shape(card, no_tf32, case, act):
    """Widths and extents off the model's: C_in not a multiple of 4, C_out
    odd and past a tile, no bias, one pixel, and x a channel slice of a
    wider NHWC tensor (read in place, any alignment)."""
    rng = np.random.default_rng(41)
    C, N, k = case["C"], case["N"], case["k"]
    wide, w, bias = _conv_args(rng, case["shape"], case.get("view", C), N, k)
    x = wide[..., case.get("view", C) - C:]
    w = w[:, :C].contiguous() if "view" in case else w
    bias = bias if case.get("bias", True) else None
    with torch.no_grad():
        got = cv.conv2d_nhwc(x, w, bias, act=act)
        want = cv.conv2d_nhwc_ref(x, w, bias, act=act)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(got, cv.conv2d_nhwc(x, w, bias, act=act))


@pytest.mark.cuda
def test_conv2d_nhwc_against_f64_at_the_slice_conv1(card, no_tf32):
    """The slice nets' first layer at its widest (C_in 1280, 3x3: K 11,520,
    N 224, batch 8 of the 32 x 48 latent): within 2e-6 of max|f64| of the
    statement in f64. The partial of kSteps k-steps keeps the tensor
    cores' truncating sum off the running total."""
    rng = np.random.default_rng(44)
    x, w, bias = _conv_args(rng, (8, 32, 48), 1280, 224, 3)
    with torch.no_grad():
        got = cv.conv2d_nhwc(x, w, bias, act="gelu")
        f64 = cv.conv2d_nhwc_ref(x.double(), w.double(), bias.double(),
                                 act="gelu")
    assert _rel_err(got.double(), f64) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("tile", range(len(cv.TILES)))
def test_conv2d_nhwc_every_tile(card, no_tf32, tile, monkeypatch):
    """Each tile, forced, at an M and an N that fill no whole tile (M = 2 x
    13 x 17, N 2 x BN + 3), C_in not a multiple of 32, 3x3: within 1e-5 of
    max|plain|, bitwise repeatable, and bitwise the tile the wrapper
    picks: the sum order is the tile's no more than the batch's."""
    bm, bn = cv.TILES[tile]
    rng = np.random.default_rng(45)
    x, w, bias = _conv_args(rng, (2, 13, 17), 72, 2 * bn + 3, 3)
    with torch.no_grad():
        picked = cv.conv2d_nhwc(x, w, bias, act="gelu")
        monkeypatch.setattr(cv, "pick_tile", lambda *call: tile)
        before = list(cv.conv2d_nhwc.tile_launches)
        got = cv.conv2d_nhwc(x, w, bias, act="gelu")
        assert cv.conv2d_nhwc.tile_launches[tile] == before[tile] + 1
        want = cv.conv2d_nhwc_ref(x, w, bias, act="gelu")
        assert _rel_err(got, want) <= 1e-5
        assert torch.equal(got, cv.conv2d_nhwc(x, w, bias, act="gelu"))
    assert torch.equal(got, picked)


@pytest.mark.cuda
def test_conv2d_nhwc_refuses(card):
    rng = np.random.default_rng(42)
    x, w, bias = _conv_args(rng, (1, 4, 4), 8, 8, 3)
    with pytest.raises(ValueError):
        cv.conv2d_nhwc(x, w.requires_grad_(), bias)     # a gradient wanted
    w = w.detach()
    with pytest.raises(TypeError):
        cv.conv2d_nhwc(x.bfloat16(), w.bfloat16(), bias.bfloat16())
    with pytest.raises(ValueError):
        cv.conv2d_nhwc(x, torch.zeros((8, 8, 7, 7), device="cuda"), bias)
    with pytest.raises(ValueError):
        cv.conv2d_nhwc(x, w, bias, act="tanh")


@pytest.mark.cuda
def test_conv2d_nhwc_launches_of_a_pass(card):
    """A forward of the model with bf16 transforms launches the kernel for
    the entropy side's 105 convolutions; a training forward, none."""
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE

    model = DCAE(DCAEConfig.tiny(compute_dtype="bfloat16"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.set_transform_dtype(torch.bfloat16)
    model.cuda()
    x = torch.rand((1, 64, 64, 3), device="cuda")
    before = cv.conv2d_nhwc.launches
    with torch.no_grad():
        model(x)
    assert cv.conv2d_nhwc.launches == before + 105
    model(x, training=True, generator=torch.Generator("cuda").manual_seed(1))
    assert cv.conv2d_nhwc.launches == before + 105


@pytest.mark.cuda
def test_sigma_indexes_agree_with_the_plain_path(card, no_tf32, monkeypatch):
    """The scale net of slice 0 at full widths and the cell's shape, its
    last layer set so that sigma spans the scale table (drawn weights put
    every index at 0): the table indexes from the kernel path equal those
    from the plain path (cuDNN f32) on at least 99.9% of the symbols."""
    import dcae_tpu_torch.ops.layers as layers
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.entropy import gaussian
    from dcae_tpu_torch.models.dcae import reset_modules
    from dcae_tpu_torch.models.transforms import SliceNet

    cfg = DCAEConfig()
    net = SliceNet(cfg, cfg.support_dim(0))
    reset_modules(net, torch.Generator().manual_seed(0))
    net.cuda().requires_grad_(False)
    support = torch.randn((8, 32, 48, cfg.support_dim(0)),
                          generator=torch.Generator().manual_seed(1)).cuda()
    table = torch.from_numpy(gaussian.get_scale_table()).cuda()
    last = net[4]
    with torch.no_grad():
        std = net(support).std(dim=(0, 1, 2))
        # channel c centred on a table scale, spread +-30%: log-spaced over
        # the whole table
        centre = torch.exp(torch.linspace(np.log(0.15), np.log(200.0),
                                          cfg.slice_dim, device="cuda"))
        last.weight.mul_((0.3 * centre / std)[:, None, None, None])
        last.bias.copy_(centre)
        before = cv.conv2d_nhwc.launches
        got = gaussian.build_indexes(net(support), table)
        assert cv.conv2d_nhwc.launches == before + 3
        monkeypatch.setattr(layers, "routes", lambda conv, x: False)
        want = gaussian.build_indexes(net(support), table)
    counts = torch.bincount(want.flatten().long(), minlength=64)
    assert int((counts > 0).sum()) >= 60       # the table is spanned
    agree = float((got == want).float().mean())
    print(f"sigma -> index: {100 * agree:.4f}% of {want.numel()} symbols "
          "agree")
    assert agree >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype,heads", [("bfloat16", 16), ("bfloat16", 8),
                                         ("bfloat16", 4), ("float32", 8)])
def test_wmsa_block_kernel_at_tcm_widths(card, dtype, heads, shifted):
    """TCM's window-8 blocks: C = 128 with head_dim 8 / 16 / 32 in the bf16
    transforms, head_dim 16 in the f32 SWAtten blocks; the bars above."""
    test_wmsa_block_kernel(card, 128, heads, dtype, shifted)


@pytest.mark.cuda
def test_tcm_request_against_the_reference(card):
    """One request of the TCM cell (batch 8 of 768x512, TCM-L with bf16
    transforms and seeded weights) through compress_device and
    decompress_interleaved, judged by the benchmark's TCM judge against
    the plain reference under the cell's own limits."""
    import dataclasses
    import json
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    sys.path.insert(0, bench)
    try:
        from harness import corpus, tcm_weights
        from reference import tcm_check
    finally:
        sys.path.remove(bench)
    from dcae_tpu_torch.config import TCMConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    cfg = TCMConfig(compute_dtype="bfloat16")
    c = dataclasses.asdict(cfg)
    x = corpus.synthetic_kodak(8, 512, 768, seed=20)
    codec = DCAECodec(cfg, params=tcm_weights.make(c, 21, "cuda"),
                      device="cuda", patch_cap=8 * 32 * 48 * cfg.slice_dim)
    codec.update()
    keep = {}
    fn = codec.model.decode_device_streams

    def decode(*a, **k):
        keep["out"] = fn(*a, **k)
        return keep["out"]

    enc = codec.compress_device(x)
    codec.model.decode_device_streams = decode
    dec = codec.decompress_interleaved(enc)
    assert bool(dec["ok"])
    y_hat, _, idxs, syms = keep["out"]
    got = tcm_check.judge(c, tcm_weights.make(c, 21, "cuda"), [{
        "x": x, "enc": enc, "y_hat": y_hat.cpu(), "idxs": idxs.cpu(),
        "syms": syms.cpu(), "x_hat": dec["x_hat"].cpu()}], "cuda")
    limits = json.load(open(os.path.join(
        bench, "workloads", "tcm-bf16.kodak-b8-interleaved.json")))["checks"]
    print(f"TCM request judged: {got}")
    for name, lim in limits.items():
        assert got[name] <= lim, (name, got[name], lim)


# ------------------------------------------------------- entropy graph --
# The entropy pass (ChannelARModel.decode_device_streams) replayed from a
# CUDA graph (models/entropy_graph.py), at the codec cells' shape: batch 8
# of 768x512, bf16 transforms, seeded weights, DCAE and TCM.

def _kodak(n_batches: int, seed: int):
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    sys.path.insert(0, bench)
    try:
        from harness import corpus
    finally:
        sys.path.remove(bench)
    return [corpus.synthetic_kodak(8, 512, 768, seed=seed + i)
            for i in range(n_batches)]


@pytest.fixture(scope="module", params=["dcae", "tcm"])
def cell_codec(request):
    """(codec, two requests) of a codec cell's model."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from dcae_tpu_torch.config import DCAEConfig, TCMConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    cfg = (TCMConfig if request.param == "tcm" else DCAEConfig)(
        compute_dtype="bfloat16")
    codec = DCAECodec(cfg, device="cuda",
                      patch_cap=8 * 32 * 48 * cfg.slice_dim)
    codec.update()
    yield codec, _kodak(2, 31)
    codec.close()
    del codec
    torch.cuda.empty_cache()


@torch.no_grad()
def _pass_args(codec, x, override: bool) -> dict:
    """decode_device_streams' arguments as the codec passes them (certified
    encoder's replay, or the decoder of compress_device's streams)."""
    common = dict(scale_table=codec._scale_table, chained=True)
    if override:
        y, _, z_hat = codec.model.encode_analysis(codec._input(x))
        return dict(z_hat=z_hat, words=None, n_words=None, states=None,
                    patch_pos=None, patch_val=None, override=True, true_y=y,
                    lut_sym=None, lut_sf=None, **common)
    words, n_words, states, ppos, pval, luts, _, z_hat = \
        codec._interleaved_inputs(codec.compress_device(x))
    return dict(z_hat=z_hat, words=words, n_words=n_words, states=states,
                patch_pos=ppos, patch_val=pval, override=False, true_y=None,
                lut_sym=luts[0], lut_sf=luts[1], **common)


def _same_pass(got, want) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


class _EntropyRecords:
    """A sink of the program's counts and launch records."""

    def __init__(self):
        from dcae_tpu_torch.utils import profiling

        class Sink(profiling.Sink):
            def __init__(s):
                s.counts, s.launches = {}, []

            def count(s, name, n):
                s.counts[name] = s.counts.get(name, 0) + n

            def launch(s, name, flops, nbytes):
                s.launches.append((name, flops, nbytes))

        self.sink = Sink()
        self._ctx = profiling.registered(self.sink)

    def __enter__(self):
        self._ctx.__enter__()
        return self.sink

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


@pytest.mark.cuda
def test_entropy_graph_replays_equal_the_eager_pass(cell_codec):
    """Both directions of two requests: the first call of a key captures
    and replays, later ones replay; each equals the eager pass bitwise."""
    from dcae_tpu_torch.models import entropy_graph as eg

    codec, xs = cell_codec
    model = codec.model
    args = [_pass_args(codec, x, o) for x in xs for o in (True, False)]
    keys = {eg.key(model.cfg, a) for a in args}
    model._entropy_graphs = eg.PassGraphs()
    with _EntropyRecords() as rec, torch.no_grad():
        for a in args + args:
            _same_pass(model.decode_device_streams(**a),
                       model._entropy_pass(**a))
    assert rec.counts.get("codec.entropy.captured") == len(keys)
    assert rec.counts.get("codec.entropy.replayed") == 2 * len(args)
    assert "codec.entropy.eager" not in rec.counts
    with _EntropyRecords() as rec:                  # under autograd
        got = model.decode_device_streams(**args[0])
    assert rec.counts == {"codec.entropy.eager": 1} and len(got) == 4


@pytest.mark.cuda
def test_entropy_graph_outputs_outlive_the_next_request(cell_codec):
    """Two requests on one key: the first's returned tensors are as they
    were after the second ran."""
    from dcae_tpu_torch.models import entropy_graph as eg

    codec, xs = cell_codec
    model = codec.model
    for override in (True, False):
        a, b = (_pass_args(codec, x, override) for x in xs)
        if not override:       # one patch width: the scatter drops -1
            P = max(a["patch_pos"].shape[1], b["patch_pos"].shape[1])
            a, b = ({**t, "patch_pos": torch.nn.functional.pad(
                t["patch_pos"], (0, P - t["patch_pos"].shape[1]), value=-1),
                "patch_val": torch.nn.functional.pad(
                t["patch_val"], (0, P - t["patch_val"].shape[1]))}
                for t in (a, b))
        assert eg.key(model.cfg, a) == eg.key(model.cfg, b)
        with torch.no_grad():
            first = model.decode_device_streams(**a)
            kept = [t.clone() for t in first]
            second = model.decode_device_streams(**b)
            _same_pass(first, kept)
            _same_pass(second, model._entropy_pass(**b))
        assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
def test_graphed_and_eager_coders_decode_each_other(cell_codec,
                                                    monkeypatch):
    """The certified encoder graphed and eager write the same streams, and
    each decodes on the other's decoder with ok and the same image."""
    from dcae_tpu_torch.models import entropy_graph as eg

    codec, xs = cell_codec
    x = xs[0]
    enc_g = codec.compress_device(x)
    dec_gg = codec.decompress_interleaved(enc_g)
    with monkeypatch.context() as m:
        m.setattr(eg, "engages", lambda cfg, a: False)
        enc_e = codec.compress_device(x)
        dec_ge = codec.decompress_interleaved(enc_g)
    dec_eg = codec.decompress_interleaved(enc_e)
    assert enc_g["istreams"] == enc_e["istreams"]
    assert np.array_equal(enc_g["states"], enc_e["states"])
    assert all(np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])
               for p, q in zip(enc_g["patches"], enc_e["patches"]))
    for dec in (dec_gg, dec_ge, dec_eg):
        assert bool(dec["ok"])
        assert torch.equal(dec["x_hat"], dec_gg["x_hat"])


@pytest.mark.cuda
def test_entropy_graph_follows_a_weight_swap(cell_codec):
    """After load_state_dict(assign=True) with other entropy-side weights,
    and after a round trip through .to(), the next call captures again and
    equals the eager pass on the weights the model now holds."""
    from dcae_tpu_torch.models import entropy_graph as eg

    codec, xs = cell_codec
    model = codec.model
    model._entropy_graphs = eg.PassGraphs()
    a = _pass_args(codec, xs[0], True)
    original = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with _EntropyRecords() as rec, torch.no_grad():
            before = model.decode_device_streams(**a)
            model.load_state_dict(
                {k: v * 1.01 if k.startswith("cc_mean_transforms.") else v
                 for k, v in original.items()}, assign=True)
            swapped = model.decode_device_streams(**a)
            _same_pass(swapped, model._entropy_pass(**a))
            assert not torch.equal(swapped[3], before[3])
            model.to("cpu").to("cuda")
            moved = model.decode_device_streams(**a)
            _same_pass(moved, swapped)
        assert rec.counts.get("codec.entropy.captured") == 3
    finally:
        model.load_state_dict(original, assign=True)
    with torch.no_grad():
        _same_pass(model.decode_device_streams(**a), before)


@pytest.mark.cuda
def test_entropy_graph_counts_the_launches_of_the_eager_pass(cell_codec):
    """The kernel wrappers' launch counters and the sinks' launch records
    step alike for an eager pass, a capture and a replay; a record's bytes
    differ only where the lane decoder reads the padded word buffer."""
    from dcae_tpu_torch.models import entropy_graph as eg
    from dcae_tpu_torch.ops.kernels import wrappers

    codec, xs = cell_codec
    model = codec.model
    model._entropy_graphs = eg.PassGraphs()
    for override in (True, False):
        a = _pass_args(codec, xs[1], override)
        steps = []
        for fn in (model._entropy_pass, model.decode_device_streams,
                   model.decode_device_streams):
            before = {n: f.launches for n, f in wrappers().items()}
            with _EntropyRecords() as rec, torch.no_grad():
                fn(**a)
            steps.append(({n: f.launches - before[n]
                           for n, f in wrappers().items()},
                          sorted(rec.launches)))
        (eager, eager_rec), (capture, capture_rec), (replay, replay_rec) = \
            steps
        assert eager == capture == replay and capture_rec == replay_rec
        assert [r[:2] for r in eager_rec] == [r[:2] for r in replay_rec]
        words = 0 if override else 2 * a["words"].shape[0] * (
            eg.words_width(model.cfg, a["z_hat"]) - a["words"].shape[1])
        assert sum(r[2] for r in replay_rec) - sum(r[2] for r in eager_rec) \
            == words
        assert [r for r in eager_rec if r[0] != "rans_lanes_decode"] == \
            [r for r in replay_rec if r[0] != "rans_lanes_decode"]
        assert eager["conv2d_nhwc"] > 0
        assert eager["rans_lanes_decode"] == (0 if override
                                              else model.cfg.num_slices)


@pytest.mark.cuda
def test_entropy_graph_capture_and_replay_read_nothing_back(cell_codec):
    """Under torch.cuda.set_sync_debug_mode("error") a capture (after the
    eager pass's lazy uploads) and its replays make the host wait for the
    device nowhere."""
    from dcae_tpu_torch.models import entropy_graph as eg

    codec, xs = cell_codec
    model = codec.model
    args = [_pass_args(codec, xs[0], o) for o in (True, False)]
    model._entropy_graphs = eg.PassGraphs()
    with torch.no_grad():
        want = [model._entropy_pass(**a) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = [[model.decode_device_streams(**a) for a in args]
                   for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for rnd in got:
        for g, w in zip(rnd, want):
            _same_pass(g, w)


@pytest.mark.cuda
def test_entropy_graph_replays_from_threads(cell_codec):
    """Six threads replay one key's graph in turns, with a short switch
    interval: every result equals the eager pass (the static buffers are
    taken by one replay at a time)."""
    import sys
    import threading

    codec, xs = cell_codec
    model = codec.model
    args = [_pass_args(codec, x, True) for x in xs]
    with torch.no_grad():
        want = [model._entropy_pass(**a) for a in args]
    errors, done = [], []

    def work(i):
        try:
            with torch.no_grad():
                for r in range(3):
                    got = model.decode_device_streams(**args[(i + r) % 2])
                    _same_pass(got, want[(i + r) % 2])
            done.append(i)
        except Exception as e:          # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == list(range(6))


# --------------------------------------------------------- train graph --
# The training step's forward and backward replayed from a CUDA graph
# (train/step_graph.py) against the same steps run eagerly from the same
# weights and noise seed, f32 with TF32 off. Gaps as the training cells'
# judge takes them (benchmark/reference/train_check.py), held at the
# cells' limits: losses 3e-5 of their value; each leaf's gradient or
# change norm 5e-4 / 0.015 of its own or of the median leaf's.

TRAIN_LIMITS = {"loss": 3e-5, "grad": 5e-4, "change": 0.015}


def _leaf_gap(got: dict, want: dict, keep=lambda n: True) -> float:
    names = [n for n in want if keep(n)]
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in names)


def _train_gaps(got: dict, want: dict) -> dict:
    """{"loss", "grad", "change"} gaps of one run against another, each a
    dict of per-step losses and per-leaf gradient and change norms."""
    med = float(np.median(list(want["grad"].values())))
    return {"loss": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], want["loss"])),
            "grad": _leaf_gap(got["grad"], want["grad"]),
            "change": _leaf_gap(got["change"], want["change"],
                                lambda n: want["grad"][n] >= 1e-3 * med)}


class _Counts:
    """A sink of the program's counts."""

    def __init__(self):
        from dcae_tpu_torch.utils import profiling

        class Sink(profiling.Sink):
            def __init__(s):
                s.counts = {}

            def count(s, name, n):
                s.counts[name] = s.counts.get(name, 0) + n

        self.sink = Sink()
        self._ctx = profiling.registered(self.sink)

    def __enter__(self):
        return self._ctx.__enter__().counts

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def _train_setup(cfg, device="cuda"):
    """A seeded model, its train state (noise seed 1) and train step."""
    from dcae_tpu_torch.models.base import build_model
    from dcae_tpu_torch.train.state import create_train_state, make_optimizer
    from dcae_tpu_torch.train.step import make_train_step

    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    tx = make_optimizer(1e-4, 1e-3, 1.0)
    state = create_train_state(
        model, tx, torch.Generator(device=device).manual_seed(1))
    return model, tx, state, make_train_step(model, tx, 0.0483, "mse")


def _train_batches(n: int, rows: int, side: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(0, 1, (rows, side, side, 3))
                             .astype(np.float32)).cuda() for _ in range(n)]


def _forced_eager(monkeypatch, on: bool):
    from dcae_tpu_torch.train import step_graph as sg

    if on:
        monkeypatch.setattr(sg, "eager_reason", lambda *a: "forced")
    else:
        monkeypatch.undo()


def _run_steps(model, state, step, batches) -> dict:
    """Steps on `batches`: per-step losses (loss + aux), the last step's
    gradient norms and the change of every leaf; the metrics as returned
    and as they read right after their step."""
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    mets, read = [], []
    for b in batches:
        _, m = step(state, b)
        mets.append(m)
        read.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    with torch.no_grad():
        return {"loss": [float(m["loss"] + m["aux_loss"]) for m in read],
                "grad": {n: float(p.grad.norm())
                         for n, p in model.named_parameters()},
                "change": {n: float((p - p0[n]).norm())
                           for n, p in model.named_parameters()},
                "metrics": mets, "read": read}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dcae", "tcm"])
def test_train_graph_steps_equal_the_eager_steps(card, no_tf32, monkeypatch,
                                                 arch):
    """Five steps on five batches of 8 x 256x256 at full width: the first
    warms the key up eagerly, the second captures and replays, the rest
    replay; against five eager steps from the same state, within the
    training cells' limits. Counts: captured 1, replayed 4, eager 0; a
    step's metrics are as they read right after it."""
    from dcae_tpu_torch.config import DCAEConfig, TCMConfig

    cfg = (TCMConfig if arch == "tcm" else DCAEConfig)()
    batches = _train_batches(5, 8, 256)
    runs, counts = [], []
    for eager in (False, True):
        _forced_eager(monkeypatch, eager)
        model, _, state, step = _train_setup(cfg)
        with _Counts() as c:
            runs.append(_run_steps(model, state, step, batches))
        counts.append(c)
        del model, state, step
        torch.cuda.empty_cache()
    _forced_eager(monkeypatch, False)
    graphed, eager = runs
    assert counts == [{"train.graph.captured": 1, "train.graph.replayed": 4},
                      {"train.graph.eager": 5}]
    for m, r in zip(graphed["metrics"], graphed["read"]):
        for k in m:
            assert torch.equal(m[k], r[k]), k
    assert len({r["loss"].item() for r in graphed["read"]}) == 5
    gaps = _train_gaps(graphed, eager)
    print(f"{arch} graphed against eager over 5 steps: {gaps}")
    for k, lim in TRAIN_LIMITS.items():
        assert gaps[k] <= lim, (k, gaps[k], lim)


@pytest.mark.cuda
def test_train_graph_recaptures_after_to_and_assign(card, no_tf32,
                                                    monkeypatch):
    """The tiny window-8 model, graphed and eager side by side through
    three phases of three steps: as built, after `.to()` round trip (new
    storages) and after `load_state_dict(assign=True)` (new parameters,
    and new Adams over them). Each phase warms up, captures and replays
    again, and every step's loss and gradients follow the eager twin's."""
    from dcae_tpu_torch.train.state import create_train_state
    from tests.torch_dp_common import card_config

    batches = _train_batches(3, 2, 128)
    twins = [_train_setup(card_config()) for _ in range(2)]
    counts = []
    for phase in ("built", "to", "assign"):
        got = []
        for eager, (model, tx, state, step) in zip((False, True), twins):
            if phase == "to":
                model.to("cpu").to("cuda")
            elif phase == "assign":
                model.load_state_dict({k: v.clone() for k, v in
                                       model.state_dict().items()},
                                      assign=True)
                state = create_train_state(model, tx, state.generator,
                                           step=state.step)
            _forced_eager(monkeypatch, eager)
            with _Counts() as c:
                got.append(_run_steps(model, state, step, batches))
            _forced_eager(monkeypatch, False)
            if not eager:
                counts.append(c)
        gaps = _train_gaps(*got)
        print(f"{phase}: graphed against eager {gaps}")
        for k, lim in TRAIN_LIMITS.items():
            assert gaps[k] <= lim, (phase, k, gaps[k], lim)
    assert counts == [{"train.graph.captured": 1,
                       "train.graph.replayed": 2}] * 3


@pytest.mark.cuda
def test_train_graph_replays_read_nothing_back(card, no_tf32):
    """Under torch.cuda.set_sync_debug_mode("error") the replayed steps,
    the eager update after each included, make the host wait for the
    device nowhere."""
    from tests.torch_dp_common import card_config

    model, _, state, step = _train_setup(card_config())
    batches = _train_batches(4, 2, 128)
    for b in batches[:2]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _Counts() as c:
            mets = [step(state, b)[1] for b in batches[2:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert c == {"train.graph.replayed": 2}
    assert all(bool(torch.isfinite(m["loss"])) for m in mets)


@pytest.mark.cuda
def test_train_graph_dp_over_two_cards_equals_eager(card, tmp_path):
    """Two ranks, a card each (NCCL, tests/torch_train_graph_worker.py):
    three graphed dp steps (the mean all-reduce between the replay and
    the update) against three eager ones (the all-reduce in the
    backward's final callback) from the same state, on every rank.
    Needs two cards."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from dcae_tpu_torch.ops.kernels import _build

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    _build.build_kernels()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests",
                                      "torch_train_graph_worker.py"),
         str(port), "2", str(r), str(tmp_path)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the ranks timed out:\n" + "\n".join(
            p.communicate()[0] for p in procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    for r in range(2):
        with open(tmp_path / f"r{r}.json") as f:
            res = json.load(f)
        assert res["counts"] == [{"train.graph.captured": 1,
                                  "train.graph.replayed": 2},
                                 {"train.graph.eager": 3}]
        gaps = _train_gaps(*res["runs"])
        print(f"rank {r}: graphed dp against eager {gaps}")
        for k, lim in TRAIN_LIMITS.items():
            assert gaps[k] <= lim, (r, k, gaps[k], lim)


# ----------------------------------------------------------------- ELIC --
# ELIC's entropy side on the 5x5 instance of conv2d_nhwc, and one request
# of the ELIC cell (batch 8 of 768x512, bf16 transforms, seeded weights).

# the 5x5 shapes of the ELIC cell (the latent at 32 x 48): each channel
# context's three layers, (C_in, C_out, act, C of the tensor x is a slice
# of), and each group's masked spatial context (taps "odd")
ELIC_CONV5 = [
    (16, 192, "relu", 320), (192, 192, "relu", 192), (192, 32, "none", 192),
    (32, 192, "relu", 320), (64, 192, "relu", 320), (128, 213, "relu", 320),
    (213, 298, "relu", 213), (298, 384, "none", 298),
    (16, 32, "none", 320), (32, 64, "none", 64), (64, 128, "none", 320),
    (192, 384, "none", 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["all", "odd"])
@pytest.mark.parametrize("C,N,act,wide", ELIC_CONV5)
def test_conv2d_nhwc_5x5_at_elics_shapes(card, no_tf32, C, N, act, wide,
                                         taps):
    """The 5x5 instance, every tap and the checkerboard's 12, on x read in
    place as the first C channels of a wider latent: within 1e-5 of
    max|plain| of the plain f32 statement (the weight masked), bitwise
    repeatable, batch-invariant, one launch a call."""
    rng = np.random.default_rng(43)
    full, w, bias = _conv_args(rng, (8, 32, 48), wide, N, 5)
    x = full[..., :C]
    w = w[:, :C].contiguous()
    with torch.no_grad():
        before = cv.conv2d_nhwc.launches
        got = cv.conv2d_nhwc(x, w, bias, act=act, taps=taps)
        assert cv.conv2d_nhwc.launches == before + 1
        want = cv.conv2d_nhwc_ref(x, w, bias, act=act, taps=taps)
        assert _rel_err(got, want) <= 1e-5
        if taps == "odd":       # the masked taps are read by neither
            assert torch.equal(got, cv.conv2d_nhwc(
                x, w * cv.tap_mask(5, "odd").cuda(), bias, act=act,
                taps=taps))
        assert torch.equal(got, cv.conv2d_nhwc(x, w, bias, act=act,
                                               taps=taps))
        for i in range(8):
            assert torch.equal(cv.conv2d_nhwc(x[i:i + 1], w, bias, act=act,
                                              taps=taps), got[i:i + 1])


def _bench_imports():
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    sys.path.insert(0, bench)
    try:
        from harness import corpus, elic_weights
        from reference import elic_check
    finally:
        sys.path.remove(bench)
    return bench, corpus, elic_weights, elic_check


@pytest.fixture(scope="module")
def elic_codec():
    """(codec, two requests, state dict) of the ELIC cell's model."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from dcae_tpu_torch.config import ELICConfig
    from dcae_tpu_torch.models.codec import DCAECodec

    _, corpus, elic_weights, _ = _bench_imports()
    cfg = ELICConfig(compute_dtype="bfloat16")
    state = elic_weights.make(dataclasses.asdict(cfg), 21, "cuda")
    codec = DCAECodec(cfg, params=state, device="cuda",
                      patch_cap=8 * 32 * 48 * cfg.slice_dim)
    codec.update()
    yield codec, [corpus.synthetic_kodak(8, 512, 768, seed=20 + i)
                  for i in range(2)], state
    codec.close()
    del codec
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_elic_request_against_the_reference(elic_codec):
    """One request of the ELIC cell through compress_device and
    decompress_interleaved, judged by the benchmark's ELIC judge against
    the plain reference under the cell's own limits; the classic codec
    decodes the same image."""
    import dataclasses
    import json
    import os

    bench, _, _, elic_check = _bench_imports()
    codec, xs, state = elic_codec
    x = xs[0]
    keep = {}
    fn = codec.model.decode_device_streams

    def decode(*a, **k):
        keep["out"] = fn(*a, **k)
        return keep["out"]

    enc = codec.compress_device(x)
    codec.model.decode_device_streams = decode
    try:
        dec = codec.decompress_interleaved(enc)
    finally:
        codec.model.decode_device_streams = fn
    assert bool(dec["ok"])
    y_hat, _, idxs, syms = keep["out"]
    assert len(idxs) == len(syms) == 10

    def flat(steps):
        return torch.cat([t.reshape(-1) for t in steps]).cpu()

    got = elic_check.judge(
        dataclasses.asdict(codec.cfg), state, [{
            "x": x, "enc": enc, "y_hat": y_hat.cpu(), "idxs": flat(idxs),
            "syms": flat(syms), "x_hat": dec["x_hat"].cpu()}], "cuda")
    limits = json.load(open(os.path.join(
        bench, "workloads", "elic-bf16.kodak-b8-interleaved.json")))["checks"]
    print(f"ELIC request judged: {got}")
    for name, lim in limits.items():
        assert got[name] <= lim, (name, got[name], lim)
    classic = codec.compress(x)
    assert torch.equal(codec.decompress(classic["strings"],
                                        classic["shape"])["x_hat"],
                       dec["x_hat"])


def _same_elic_pass(got, want) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        gs, ws = (list(g), list(w)) if isinstance(w, tuple) else ([g], [w])
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_elic_entropy_graph_replays_equal_the_eager_pass(elic_codec):
    """Both directions of two requests, captured and replayed under
    torch.cuda.set_sync_debug_mode("error"): every replay equals the eager
    pass bitwise, the steps' arrays a tuple of ten; an eager decoding pass
    launches conv2d_nhwc 48 times (17 of them 5x5) and the lane decoder
    10 times."""
    from dcae_tpu_torch.models import entropy_graph as eg
    from dcae_tpu_torch.ops.kernels import wrappers

    codec, xs, _ = elic_codec
    model = codec.model
    args = [_pass_args(codec, x, o) for x in xs for o in (True, False)]
    model._entropy_graphs = eg.PassGraphs()
    with torch.no_grad():
        want = [model._entropy_pass(**a) for a in args]
        before = {n: f.launches for n, f in wrappers().items()}
        model._entropy_pass(**args[1])
        launched = {n: f.launches - before[n] for n, f in wrappers().items()}
    assert launched["rans_lanes_decode"] == 10
    # 17 5x5; the aggregation's three 1x1 a step, 30; h_s's one 3x3
    assert launched["conv2d_nhwc"] == 17 + 30 + 1
    torch.cuda.synchronize()
    with _EntropyRecords() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                got = [[model.decode_device_streams(**a) for a in args]
                       for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for rnd in got:
        for g, w in zip(rnd, want):
            _same_elic_pass(g, w)
    keys = {eg.key(model.cfg, a) for a in args}
    assert rec.counts.get("codec.entropy.captured") == len(keys)
    assert rec.counts.get("codec.entropy.replayed") == 2 * len(args)
