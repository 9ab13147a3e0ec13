"""The port's interleaved device-coding profile on the CPU (plain versions
of the lane coders): compress_device / compress_interleaved /
decompress_interleaved, the patch side channel, the serving loop and the
DTI1 / DTI2 containers, on the tiny window-8 config of
tests/test_torch_codec.py with the Flax weights carried across.

Integer results (streams, states, patches) and x_hat within the port are
compared exactly. Against dcae_tpu's compress_interleaved on the same
weights and images: bpp within 1% and PSNR within 0.05 dB, the tolerances
of tests/test_torch_codec.py (rounding at a symbol boundary may code a few
symbols differently; decoding the other framework's streams is not a bar).
Against dcae_tpu's compress_device on these weights and images the
streams are compared exactly: they code no symbol differently.
"""

import numpy as np
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.runtime import container as jcontainer
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.models import codec as codec_mod
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_codec import KW, _images


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors through many small ops beside other test processes:
    one intra-op thread, or the workers' thread pools fight over the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, port, images, the port's classic x_hat)."""
    jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in init.state_dict().items()}, jcfg)
    jax_codec = JaxCodec(jcfg, params=params)
    jax_codec.update()
    port = DCAECodec(cfg, device="cpu",
                     params=state_dict_from_flax(params, jcfg))
    port.update()
    x = _images()
    enc = port.compress(x)
    classic = port.decompress(enc["strings"], enc["shape"])["x_hat"]
    yield jax_codec, port, x, classic
    port.close()


def _same_streams(a, b):
    assert a["istreams"] == b["istreams"]
    np.testing.assert_array_equal(a["states"], b["states"])
    assert a["z_strings"] == b["z_strings"]
    assert tuple(a["shape"]) == tuple(b["shape"]) and a["lanes"] == b["lanes"]
    assert len(a["patches"]) == len(b["patches"])
    for (pa, va), (pb, vb) in zip(a["patches"], b["patches"]):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(va, vb)


def _n_slice(port, x):
    yd = port.cfg.y_downsample
    return x.shape[0] * (x.shape[1] // yd) * (x.shape[2] // yd) \
        * port.cfg.slice_dim


def _spike(port, monkeypatch, value=10_000):
    """Put one wild symbol into the LAST slice at the hand-off to the host
    coders (an earlier slice's spike would not have entered the y_hat
    chain the device computed)."""
    orig = port._fetch_encode_arrays

    def spiked(out):
        z_sym, y_sym, y_idx = orig(out)
        y_sym = np.array(y_sym)
        y_sym.reshape(y_sym.shape[0], -1)[-1, 0] = value
        return z_sym, y_sym, y_idx

    monkeypatch.setattr(port, "_fetch_encode_arrays", spiked)


# ----------------------------------------------------------- round trip --

@pytest.mark.parametrize("chain", [True, False])
def test_roundtrip_matches_classic(codecs, chain):
    _, port, x, classic = codecs
    enc = port.compress_interleaved(x, chain=chain)
    S, K = port.cfg.num_slices, codec_mod._auto_lanes(_n_slice(port, x))
    assert enc["lanes"] == K and enc["chained"] is chain
    assert enc["states"].shape == ((K,) if chain else (S, K))
    assert enc["states"].dtype == np.uint32
    assert "bucket" not in enc and "unroll" not in enc
    dec = port.decompress_interleaved(enc)
    assert dec["ok"].dtype == torch.bool and bool(dec["ok"])
    assert torch.equal(dec["x_hat"], classic)


@pytest.mark.parametrize("kw", [
    dict(), dict(chain=False), dict(lanes=8), dict(lanes=1)], ids=str)
def test_compress_device_matches_host_encode(codecs, kw):
    """The device's lane encoder emits the streams, states, patches and z
    of the host (C++) encoder, whatever the options, and the decode of
    either is the classic x_hat. The container fields are the JAX
    package's: unroll 2, paired slot tables."""
    _, port, x, classic = codecs
    a = port.compress_interleaved(x, lanes=kw.get("lanes"),
                                  chain=kw.get("chain", True))
    b = port.compress_device(x, **kw)
    _same_streams(a, b)
    cap = _n_slice(port, x) + 1
    n_words = max(len(s) // 2 for s in b["istreams"])
    assert b["bucket"] == codec_mod._len_bucket(n_words, cap)
    assert b["unroll"] == 2 and b["paired"] is True
    assert b["chained"] is kw.get("chain", True)
    dec = port.decompress_interleaved(b)
    assert bool(dec["ok"])
    assert torch.equal(dec["x_hat"], classic)


def test_corrupted_stream_flags_not_ok(codecs):
    _, port, x, _ = codecs
    enc = port.compress_interleaved(x)
    s = max(range(len(enc["istreams"])),
            key=lambda i: len(enc["istreams"][i]))
    stream = bytearray(enc["istreams"][s])
    assert len(stream) >= 2
    stream[0] ^= 0xFF
    bad = dict(enc)
    bad["istreams"] = [bytes(stream) if i == s else b
                       for i, b in enumerate(enc["istreams"])]
    assert not bool(port.decompress_interleaved(bad)["ok"])
    bumped = dict(enc)
    bumped["states"] = enc["states"].copy()
    bumped["states"][0] += 1
    assert not bool(port.decompress_interleaved(bumped)["ok"])


def test_decoder_validates_the_container_fields(codecs):
    _, port, x, _ = codecs
    enc = port.compress_device(x)
    with pytest.raises(ValueError, match="unroll"):
        port.decompress_interleaved({**enc, "unroll": 3})
    with pytest.raises(ValueError, match="states"):
        port.decompress_interleaved({**enc, "chained": False})
    # a bucket that fits nothing is ignored, as is a missing field
    dec = port.decompress_interleaved({**enc, "bucket": 1, "unroll": 0})
    assert bool(dec["ok"])


@pytest.fixture(scope="module")
def device_one(codecs):
    """compress_device of one image and its decode's x_hat."""
    _, port, x, _ = codecs
    enc = port.compress_device(x[:1])
    return enc, port.decompress_interleaved(enc)["x_hat"]


def _through_container(port, enc, **fields):
    """enc with `fields` set, packed into a DTI container and unpacked."""
    blob = container.pack_bin_interleaved({**enc, **fields}, (32, 32))
    got, _, _ = container.unpack_bin_interleaved(
        blob, port.cfg.pad_multiple, port.cfg.z_downsample)
    for k, v in fields.items():
        assert got[k] == v
    return got


@pytest.mark.parametrize("unroll", [0, 1, 64])
def test_unroll_field_changes_no_bit(codecs, device_one, unroll):
    """A container's unroll field, 0 (unspecified) or any power of two up
    to 64, decodes to the same x_hat; 3 is refused."""
    _, port, _, _ = codecs
    enc, x_hat = device_one
    dec = port.decompress_interleaved(
        _through_container(port, enc, unroll=unroll))
    assert bool(dec["ok"]) and torch.equal(dec["x_hat"], x_hat)
    with pytest.raises(ValueError, match="unroll"):
        port.decompress_interleaved({**enc, "unroll": 3})


@pytest.mark.parametrize("paired", [False, True])
def test_paired_field_changes_no_bit(codecs, device_one, paired):
    """Either slot-table layout named in the container decodes alike."""
    _, port, _, _ = codecs
    enc, x_hat = device_one
    dec = port.decompress_interleaved(
        _through_container(port, enc, paired=paired))
    assert bool(dec["ok"]) and torch.equal(dec["x_hat"], x_hat)


def test_unchained_device_encode_equals_jax(codecs, monkeypatch):
    """The certified encoder at chain=False (DTI1) against the JAX
    package's compress_device with its chain off: the same streams,
    per-slice states, patches, z and container fields."""
    jax_codec, port, x, _ = codecs
    monkeypatch.setenv("DCAE_IL_CHAIN", "0")
    want = jax_codec.compress_device(x)
    got = port.compress_device(x, chain=False)
    _same_streams(got, want)
    assert got["states"].shape == (port.cfg.num_slices, got["lanes"])
    for k in ("bucket", "unroll", "paired", "chained"):
        assert got[k] == want[k]
    assert got["chained"] is False


# -------------------------------------------------------------- patches --

def test_escape_symbols_ride_patches(codecs, monkeypatch):
    """A wild symbol (a Gaussian-tail outlier the classic format
    bypass-codes) rides the patch list: x_hat equals the classic path's on
    the same spiked symbols."""
    _, port, x, _ = codecs
    _spike(port, monkeypatch)
    classic_enc = port.compress(x, mode="split")       # bypass-codes it
    classic = port.decompress(classic_enc["strings"], classic_enc["shape"])
    enc = port.compress_interleaved(x)
    assert sum(len(p[0]) for p in enc["patches"]) >= 1
    assert 10_000 in np.concatenate([p[1] for p in enc["patches"]])
    dec = port.decompress_interleaved(enc)
    assert bool(dec["ok"])
    assert torch.equal(dec["x_hat"], classic["x_hat"])


def test_patch_overflow_raises_for_fallback(codecs, monkeypatch):
    _, port, x, _ = codecs
    _spike(port, monkeypatch)
    monkeypatch.setattr(port, "patch_cap", 0)
    with pytest.raises(rans.EscapeError):
        port.compress_interleaved(x)


def _narrowed(port, monkeypatch, keep: int):
    """At most `keep` in-range buckets a row in the DEVICE encoder: heavy
    clamping."""
    orig = port._enc_luts

    def narrowed():
        enc_sf, offs, mp, stride = orig()
        return enc_sf, offs, torch.clamp(mp, max=keep), stride

    monkeypatch.setattr(port, "_enc_luts", narrowed)


def test_device_encode_patches_and_clamping(codecs, monkeypatch):
    """Clamping restricts which bucket a symbol may occupy, never its
    coded (start, freq): the decode tables read the stream and the patch
    scatter restores every true symbol, so the classic x_hat comes back."""
    _, port, x, classic = codecs
    _narrowed(port, monkeypatch, 2)
    monkeypatch.setattr(port, "patch_cap", _n_slice(port, x))
    enc = port.compress_device(x)
    assert sum(len(p[0]) for p in enc["patches"]) >= 1
    dec = port.decompress_interleaved(enc)
    assert bool(dec["ok"])
    assert torch.equal(dec["x_hat"], classic)


def test_device_encode_patch_cap_zero_raises(codecs, monkeypatch):
    _, port, x, _ = codecs
    _narrowed(port, monkeypatch, 2)
    monkeypatch.setattr(port, "patch_cap", 0)
    with pytest.raises(rans.EscapeError, match="patch list overflow"):
        port.compress_device(x)


def test_device_encode_row_without_buckets_escapes(codecs, monkeypatch):
    _, port, x, _ = codecs
    _narrowed(port, monkeypatch, 0)
    monkeypatch.setattr(port, "patch_cap", _n_slice(port, x))
    with pytest.raises(rans.EscapeError, match="in-range"):
        port.compress_device(x)


def test_patch_cap_is_a_constructor_argument(codecs):
    _, port, _, _ = codecs
    assert port.patch_cap == 512
    other = DCAECodec(port.cfg, device="cpu", patch_cap=7)
    assert other.patch_cap == 7
    other.close()


# ---------------------------------------------------------------- tables --

def test_device_tables_follow_the_coding_tables(codecs):
    """The device-resident tables are built once per bake and rebuilt when
    update() bakes new tables."""
    _, port, x, _ = codecs
    a = port._slot_luts()
    assert port._slot_luts() is a
    e = port._enc_luts()
    assert port._enc_luts() is e
    port.update(force=True)
    try:
        assert port._enc_luts() is not e
        assert port._slot_luts() is not a
        assert bool(port.decompress_interleaved(
            port.compress_device(x))["ok"])
    finally:
        port.update(force=True)


def test_lane_and_bucket_rules_equal_jax():
    from dcae_tpu.models import codec as jcodec

    for n in (1, 100, 64 * 256 - 1, 128 * 256, 196_608, 1024 * 256, 10 ** 7):
        assert codec_mod._auto_lanes(n) == jcodec._auto_lanes(n)
    for n, cap in ((0, 513), (1, 1), (33, 513), (257, 513), (513, 513),
                   (12_000, 196_609), (196_609, 196_609)):
        assert codec_mod._len_bucket(n, cap) == jcodec._len_bucket(n, cap)


# ----------------------------------------------------------------- bf16 --

def test_bf16_config_roundtrip(codecs):
    """bf16 transform bodies: the profile's safety rests on the f32
    entropy side and the lanes checksum."""
    _, _, x, _ = codecs
    c = DCAECodec(DCAEConfig.tiny(**KW, compute_dtype="bfloat16"),
                  device="cpu", seed=0)
    c.update()
    enc = c.compress_device(x)
    _same_streams(c.compress_interleaved(x), enc)
    dec = c.decompress_interleaved(enc)
    assert bool(dec["ok"])
    cl = c.compress(x)
    assert torch.equal(dec["x_hat"],
                       c.decompress(cl["strings"], cl["shape"])["x_hat"])
    fwd = c.forward(x)["x_hat"].float().clamp(0, 1)
    np.testing.assert_allclose(dec["x_hat"].numpy(), fwd.numpy(), atol=2e-2)
    c.close()


# -------------------------------------------------------------- pipeline --

def test_pipeline_matches_sequential(codecs):
    _, port, x, classic = codecs
    outs = port.encdec_pipeline_interleaved([x, x])
    assert len(outs) == 2
    for o in outs:
        assert o["profile"] == "interleaved" and bool(o["ok"])
        assert tuple(o["shape"]) == (2, 2)
        assert torch.equal(o["x_hat"], classic)


def test_pipeline_depths(codecs):
    """Batches of mixed sizes, each coded at its own shape, in order."""
    _, port, x, classic = codecs
    batches = [x, x[:1], x, x[:1], x]
    outs = port.encdec_pipeline_interleaved(batches)
    assert [o["x_hat"].shape[0] for o in outs] == [2, 1, 2, 1, 2]
    assert all(bool(o["ok"]) for o in outs)
    for o in outs[::2]:
        assert torch.equal(o["x_hat"], classic)


def test_pipeline_escape_falls_back_to_classic(codecs, monkeypatch):
    """A batch that escapes the profile is coded by the classic codec and
    tagged; every batch still gets its result, in order."""
    _, port, x, classic = codecs
    orig = port._compress_device_fetch
    calls = {"n": 0}

    def flaky(pend):
        calls["n"] += 1
        if calls["n"] == 2:            # the second batch escapes
            raise rans.EscapeError("synthetic out-of-table symbol")
        return orig(pend)

    monkeypatch.setattr(port, "_compress_device_fetch", flaky)
    outs = port.encdec_pipeline_interleaved([x] * 3)
    assert [o["profile"] for o in outs] == [
        "interleaved", "classic", "interleaved"]
    for o in outs:
        assert bool(o["ok"])
        assert torch.equal(o["x_hat"], classic)


def test_pipeline_real_overflow_falls_back(codecs, monkeypatch):
    _, port, x, classic = codecs
    _narrowed(port, monkeypatch, 2)
    monkeypatch.setattr(port, "patch_cap", 0)
    outs = port.encdec_pipeline_interleaved([x] * 2)
    assert [o["profile"] for o in outs] == ["classic", "classic"]
    assert all(torch.equal(o["x_hat"], classic) for o in outs)


def test_pipeline_producer_failure_propagates(codecs, monkeypatch):
    _, port, x, _ = codecs

    def boom(*a, **k):
        raise RuntimeError("encode died")

    monkeypatch.setattr(port, "_compress_device_dispatch", boom)
    with pytest.raises(RuntimeError, match="encode died"):
        port.encdec_pipeline_interleaved([x] * 3)


def test_pipeline_consumer_failure_stops_the_producer(codecs, monkeypatch):
    _, port, x, _ = codecs

    def boom(enc):
        raise RuntimeError("decode died")

    monkeypatch.setattr(port, "decompress_interleaved", boom)
    with pytest.raises(RuntimeError, match="decode died"):
        port.encdec_pipeline_interleaved([x] * 6)


# ------------------------------------------------------- against dcae_tpu --

def test_rate_and_quality_match_jax_interleaved(codecs):
    jax_codec, port, x, _ = codecs
    enc = port.compress_interleaved(x)
    dec = port.decompress_interleaved(enc)
    jenc = jax_codec.compress_interleaved(x)
    jdec = jax_codec.decompress_interleaved(jenc)
    assert bool(dec["ok"]) and bool(jdec["ok"])
    assert enc["lanes"] == jenc["lanes"]
    assert enc["states"].shape == np.asarray(jenc["states"]).shape

    def bpp_psnr(e, x_hat):
        nbytes = (sum(len(s) for s in e["istreams"] + list(e["z_strings"]))
                  + 4 * np.asarray(e["states"]).size
                  + 8 * sum(len(p[0]) for p in e["patches"]))
        mse = float(np.mean((np.asarray(x_hat, np.float32) - x) ** 2))
        return nbytes * 8 / x[..., 0].size, 10 * np.log10(1 / mse)

    bpp, psnr = bpp_psnr(enc, dec["x_hat"].numpy())
    jbpp, jpsnr = bpp_psnr(jenc, jdec["x_hat"])
    assert abs(bpp - jbpp) <= 0.01 * jbpp, (bpp, jbpp)
    assert abs(psnr - jpsnr) <= 0.05, (psnr, jpsnr)


# ------------------------------------------------------------ containers --

def _enc_dicts(port, x):
    one = x[:1]
    return {"dti2_device": port.compress_device(one),
            # other container fields than the device encoder writes
            "dti1_device": {**port.compress_device(one, chain=False),
                            "paired": False, "unroll": 8},
            "dti2_host": port.compress_interleaved(one),
            "dti1_host": port.compress_interleaved(one, chain=False)}


@pytest.mark.parametrize("which", ["dti2_device", "dti1_device",
                                   "dti2_host", "dti1_host"])
def test_container_bytes_equal_jax_and_cross_unpack(codecs, which):
    """Same dict -> same bytes from both packages; each unpacks the
    other's blob to the same dict; the port decodes what it unpacked."""
    _, port, x, _ = codecs
    enc = _enc_dicts(port, x)[which]
    # make sure a patch list rides along
    enc["patches"][1] = (np.array([3, 70], np.int32),
                         np.array([-900, 12_345], np.int32))
    size = (100, 120)
    blob = container.pack_bin_interleaved(enc, size)
    assert blob == jcontainer.pack_bin_interleaved(enc, size)
    assert blob[:4] == (b"DTI2" if which.startswith("dti2") else b"DTI1")
    assert container.is_interleaved_bin(blob)
    assert not container.is_interleaved_bin(b"\x00\x64\x00\x78rest")
    p, zd = port.cfg.pad_multiple, port.cfg.z_downsample
    got, padding, hw = container.unpack_bin_interleaved(blob, p, zd)
    want, jpadding, jhw = jcontainer.unpack_bin_interleaved(blob, p, zd)
    assert padding == jpadding and hw == jhw == size
    assert set(got) == set(want)
    _same_streams(got, want)
    _same_streams(got, enc)
    for k in ("bucket", "unroll", "paired", "chained", "lanes"):
        assert got[k] == want[k]
    assert got["bucket"] == enc.get("bucket", 0)
    assert got["unroll"] == enc.get("unroll", 0)
    assert got["paired"] is bool(enc.get("paired"))
    assert got["chained"] is enc["chained"]


def test_container_file_round_trip_decodes(codecs, tmp_path):
    _, port, x, _ = codecs
    enc = port.compress_device(x[:1])
    path = tmp_path / "img.bin"
    path.write_bytes(container.pack_bin_interleaved(enc, x.shape[1:3]))
    back, padding, size = container.unpack_bin_interleaved(
        path.read_bytes(), port.cfg.pad_multiple, port.cfg.z_downsample)
    assert size == x.shape[1:3] and padding == (0, 0, 0, 0)
    dec = port.decompress_interleaved(back)
    assert bool(dec["ok"])
    assert torch.equal(dec["x_hat"],
                       port.decompress_interleaved(enc)["x_hat"])


def test_paired_flag_and_bucket_ride_the_container():
    enc = {"istreams": [b"ab"], "states": np.ones((1, 4), "<u4"),
           "patches": [(np.zeros(0, np.int32), np.zeros(0, np.int32))],
           "z_strings": [b"z"], "lanes": 4, "bucket": 123, "unroll": 2,
           "paired": True}
    blob = container.pack_bin_interleaved(enc, (100, 160))
    assert blob == jcontainer.pack_bin_interleaved(enc, (100, 160))
    got, _, _ = container.unpack_bin_interleaved(blob)
    assert got["paired"] is True and got["unroll"] == 2 \
        and got["bucket"] == 123 and got["chained"] is False
    enc["paired"] = False
    got, _, _ = container.unpack_bin_interleaved(
        container.pack_bin_interleaved(enc, (100, 160)))
    assert got["paired"] is False and got["unroll"] == 2


@pytest.mark.parametrize("unroll", [3, 5, 65, 127])
def test_writer_rejects_what_the_reader_rejects(unroll):
    """The JAX writer packs unroll=3 and its reader then refuses the
    blob; the port's writer refuses it first."""
    enc = {"istreams": [b"ab"], "states": np.ones(4, "<u4"),
           "patches": None, "z_strings": [b"z"], "lanes": 4, "bucket": 9,
           "unroll": unroll, "chained": True}
    with pytest.raises(ValueError, match="unroll"):
        container.pack_bin_interleaved(enc, (64, 64))
    blob = jcontainer.pack_bin_interleaved(enc, (64, 64))
    with pytest.raises(ValueError, match="unroll"):
        container.unpack_bin_interleaved(blob)
    with pytest.raises(ValueError, match="unroll"):
        jcontainer.unpack_bin_interleaved(blob)


def test_container_rejects_foreign_bytes_and_wide_buckets():
    with pytest.raises(ValueError, match="DTI1/DTI2"):
        container.unpack_bin_interleaved(b"DLT1" + bytes(20))
    enc = {"istreams": [b""], "states": np.ones(2, "<u4"), "patches": None,
           "z_strings": [b""], "lanes": 2, "bucket": 1 << 24}
    with pytest.raises(ValueError, match="bucket"):
        container.pack_bin_interleaved(enc, (8, 8))
