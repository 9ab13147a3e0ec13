"""The port's classic codec beyond the staged encoder, on the CPU: the
split and fused encoders and their certification (self_check), the
shipped-index decoder, the latent hand-off, update(scale_table=...) and
the attention-only configuration (fused_attention_block=False), against
the JAX package's DCAECodec on the same weights (the tiny window-8 config
of tests/test_torch_codec.py).

Tolerances are those of tests/test_torch_codec.py: x_hat atol 1e-4 (f32,
other summation orders through a few dozen layers), bpp within 1% and
PSNR within 0.05 dB (rounding at a symbol boundary may code a few
symbols differently).
"""

import numpy as np
import jax
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy.gaussian import get_scale_table
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_codec import KW, _bpp_psnr, _images


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, port, attention-only port, images), each codec built
    once on the same seeded weights."""
    jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in init.state_dict().items()}, jcfg)
    jax_codec = JaxCodec(jcfg, params=params)
    jax_codec.update()
    sd = state_dict_from_flax(params, jcfg)
    port = DCAECodec(cfg, device="cpu", params=sd)
    port.update()
    attn = DCAECodec(DCAEConfig.tiny(**KW, fused_attention_block=False),
                     device="cpu", params=sd)
    attn.update()
    yield jax_codec, port, attn, _images()
    port.close()
    attn.close()


def _exact(enc_rec, dec_rec, n) -> bool:
    return len(enc_rec) == len(dec_rec) == n and all(
        np.array_equal(ei, di) and np.array_equal(es, ds)
        for (ei, es), (di, ds) in zip(enc_rec, dec_rec))


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_mode_streams_equal_staged(codecs, mode):
    _, port, _, x = codecs
    rec_staged, rec_mode = [], []
    staged = port.compress(x, mode="staged", record=rec_staged)
    got = port.compress(x, mode=mode, record=rec_mode)
    assert got["strings"] == staged["strings"]
    assert tuple(got["shape"]) == tuple(staged["shape"])
    assert _exact(rec_staged, rec_mode, port.cfg.num_slices)


def test_self_check_certifies_split(codecs):
    _, port, _, _ = codecs
    try:
        assert port.self_check() is True
        assert port.encode_mode == "split" and not port.fused_encode
        assert port.self_check(prefer_fused=True) is True
        assert port.encode_mode == "fused" and port.fused_encode
        assert port._roundtrip_check(_images(1), mode="fused")
    finally:
        port.encode_mode = "staged"
    with pytest.raises(ValueError, match="unknown encode mode"):
        port.compress(_images(1), mode="bogus")


def test_shipped_index_decode_equals_per_slice_decode(codecs):
    _, port, _, x = codecs
    enc = port.compress_with_indexes(x)
    S, sd = port.cfg.num_slices, port.cfg.slice_dim
    assert enc["indexes"].shape == (S, x.shape[0], 8, 8, sd)
    assert enc["indexes"].dtype == np.uint8
    rec_slice, rec_shipped = [], []
    per_slice = port.decompress(enc["strings"], enc["shape"],
                                record=rec_slice)
    shipped = port.decompress(enc["strings"], enc["shape"],
                              indexes=enc["indexes"], record=rec_shipped)
    assert _exact(rec_slice, rec_shipped, S)
    assert torch.equal(shipped["x_hat"], per_slice["x_hat"])


def test_update_with_scale_table_rebakes(codecs):
    _, port, _, x = codecs
    cfg = port.cfg
    default = get_scale_table(cfg.scales_min, cfg.scales_max,
                              cfg.scales_levels)
    coarse = get_scale_table(cfg.scales_min, cfg.scales_max, 32)
    try:
        assert port.update(scale_table=coarse) is False   # tables exist
        assert port.update(scale_table=coarse, force=True) is True
        assert port.tables.gaussian.quantized_cdf.shape[0] == 32
        assert port._scale_table.shape == (32,)
        rec_enc, rec_dec = [], []
        enc = port.compress(x[:1], record=rec_enc)
        port.decompress(enc["strings"], enc["shape"], record=rec_dec)
        assert _exact(rec_enc, rec_dec, cfg.num_slices)
        assert max(int(i.max()) for i, _ in rec_enc) < 32
    finally:
        port.update(scale_table=default, force=True)
    assert port.tables.gaussian.quantized_cdf.shape[0] == cfg.scales_levels


def test_latent_handoff_matches_jax(codecs):
    jax_codec, port, _, x = codecs
    y = port.compress_latent(x)
    jy = jax_codec.compress_latent(x)
    assert y.shape == jy.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-5)
    got = port.decompress_latent(y)["x_hat"].numpy()
    want = np.asarray(jax_codec.decompress_latent(y)["x_hat"])
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_analyze_sizes_has_jax_keys(codecs):
    jax_codec, port, _, x = codecs
    got = port.analyze_sizes(x[:1])
    want = jax_codec.analyze_sizes(x[:1])
    assert set(got) == set(want)
    assert got["model_params"] == want["model_params"]
    assert got["raw_latent_bytes_f32"] == want["raw_latent_bytes_f32"]
    assert got["total_stream_bytes"] == (got["y_string_bytes"]
                                         + got["z_string_bytes"])


def test_attention_only_forward_matches_flax_dcae(codecs):
    """The tolerances of test_torch_codec.py::test_forward_matches_flax_dcae
    (the JAX codec's default path on the CPU, f32)."""
    jax_codec, _, attn, x = codecs
    assert not attn.cfg.fused_attention_block
    want = jax.tree.map(np.asarray, jax_codec.forward(x))
    got = attn.forward(x)
    np.testing.assert_allclose(got["x_hat"].numpy(), want["x_hat"],
                               atol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(got["likelihoods"][k].numpy(),
                                   want["likelihoods"][k], rtol=1e-4,
                                   atol=1e-7)
    for k in ("means", "scales", "y"):
        np.testing.assert_allclose(got["para"][k].numpy(), want["para"][k],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["default", "attention_only"])
def test_split_mode_matches_jax_split(codecs, which):
    """The port's split encoder (default and attention-only configuration)
    decodes exactly, and its bpp / PSNR agree with the JAX codec's
    compress(mode="split")."""
    jax_codec, port, attn, x = codecs
    codec = port if which == "default" else attn
    rec_enc, rec_dec = [], []
    enc = codec.compress(x, mode="split", record=rec_enc)
    dec = codec.decompress(enc["strings"], enc["shape"], record=rec_dec)
    assert _exact(rec_enc, rec_dec, codec.cfg.num_slices)
    bpp, psnr = _bpp_psnr(enc, dec["x_hat"].numpy(), x)
    jenc = jax_codec.compress(x, mode="split")
    jdec = jax_codec.decompress(jenc["strings"], jenc["shape"])
    jbpp, jpsnr = _bpp_psnr(jenc, jdec["x_hat"], x)
    assert abs(bpp - jbpp) <= 0.01 * jbpp, (bpp, jbpp)
    assert abs(psnr - jpsnr) <= 0.05, (psnr, jpsnr)
