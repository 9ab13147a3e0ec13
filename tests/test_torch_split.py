"""The port's split deployment and the surface around it, against the JAX
package on the CPU: the DLT1 latent container, the buffered rANS encoder,
the RD reference table, compress_many / decompress_many / encdec_pipeline,
the encoder / decoder halves and their parameter shipping, the
cross-device codec with shipped indexes, and the transforms-only
autoencoder.

Tolerances: the containers and the coder are held byte for byte; the
codec's streams and x_hat against the port's own per-batch calls bitwise,
against the JAX codec within the bars of tests/test_torch_codec.py (bpp
1%, PSNR 0.05 dB); the autoencoder against the Flax module at 1e-5 of each
output's max (f32, other summation orders through some 30 layers).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.data import rd_reference as jrd
from dcae_tpu.entropy import rans as jrans
from dcae_tpu.models import autoencoder as jae
from dcae_tpu.models import split as jsplit
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.runtime import container as jcontainer
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data import rd_reference
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.models import autoencoder, split
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.tools.eval import CrossDeviceCodec
from tests.test_torch_codec import KW, _bpp_psnr, _images


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
def weights():
    """(port state dict, Flax params, JAX config, port config) of one
    seeded init of the tiny window-8 DCAE."""
    jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in init.state_dict().items()}
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    return sd, params, jcfg, cfg


@pytest.fixture(scope="module")
def joint(weights):
    sd, _, _, cfg = weights
    codec = DCAECodec(cfg, params=sd, device="cpu")
    codec.update()
    yield codec
    codec.close()


# ------------------------------------------------------------ DLT1 --

def _latents() -> np.ndarray:
    """A latent with values on bf16 rounding ties, +-0 and +-inf beside
    ordinary ones."""
    rng = np.random.default_rng(0)
    y = rng.normal(0, 3, (1, 4, 6, 20)).astype(np.float32)
    ties = (rng.integers(0, 2 ** 16, 40, dtype=np.uint32) << 16) | 0x8000
    y.reshape(-1)[:40] = ties.view(np.float32)
    y.reshape(-1)[40:46] = [0.0, -0.0, np.inf, -np.inf, 1 + 2 ** -8,
                            1 + 3 * 2 ** -8]
    y[~np.isfinite(y) & ~np.isinf(y)] = 1.0       # no NaN from the ties
    return y


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "int8"])
def test_latent_container_equals_jax(dtype):
    """Bytes equal to the JAX packer's; each package unpacks the other's
    blob to the same values. int8 takes finite values (max-abs scale)."""
    y = _latents()
    if dtype == "int8":
        y = np.where(np.isfinite(y), y, 7.0).astype(np.float32)
    with np.errstate(over="ignore"):
        ours = container.pack_latent(y, (100, 150), dtype)
        theirs = jcontainer.pack_latent(y, (100, 150), dtype)
    assert ours == theirs
    assert container.is_latent_bin(ours)
    assert not container.is_interleaved_bin(ours)
    got, padding, size = container.unpack_latent(theirs)
    want, jpadding, jsize = jcontainer.unpack_latent(ours)
    np.testing.assert_array_equal(got, want)
    assert (padding, size) == (jpadding, jsize) and size == (100, 150)
    # the tensor form packs the same bytes
    with np.errstate(over="ignore"):
        assert container.pack_latent(torch.from_numpy(y), (100, 150),
                                     dtype) == ours


def test_latent_container_rejects_foreign_bytes():
    with pytest.raises(ValueError):
        container.unpack_latent(b"DTI2" + bytes(20))
    with pytest.raises(ValueError):
        container.pack_latent(np.zeros((1, 1, 1, 1), np.float32), (1, 1),
                              "float64")


# ------------------------------------------------------- RansEncoder --

def test_buffered_encoder_equals_jax(joint):
    g = joint.tables.gaussian
    args = (g.quantized_cdf, g.cdf_length, g.offset)
    rng = np.random.default_rng(3)
    ours, theirs = rans.RansEncoder(), jrans.RansEncoder()
    assert ours.flush() == theirs.flush() == b""
    for n in (100, 1, 700):
        sym = np.round(rng.normal(0, 3, n)).astype(np.int32)
        idx = rng.integers(0, g.cdf_length.shape[0], n).astype(np.int32)
        ours.encode_with_indexes(sym, idx, *args)
        theirs.encode_with_indexes(sym, idx, *args)
    a, b = ours.flush(), theirs.flush()
    assert a == b and len(a) > 0
    assert ours.flush() == b""


# ------------------------------------------------------ RD reference --

def test_rd_reference_equals_jax():
    assert rd_reference.REFERENCE_RD == jrd.REFERENCE_RD
    assert rd_reference.MSE_LAMBDAS == jrd.MSE_LAMBDAS
    assert rd_reference.MSSSIM_LAMBDAS == jrd.MSSSIM_LAMBDAS
    k = rd_reference.REFERENCE_RD["Kodak"]
    bpp = [b * 0.9 for b in k["bpp"]]
    assert rd_reference.compare_to_reference("Kodak", bpp, k["psnr"]) == \
        jrd.compare_to_reference("Kodak", bpp, k["psnr"])
    assert rd_reference.bd_rate(k["bpp"][:3], k["psnr"][:3], bpp[:3],
                                k["psnr"][:3]) == \
        jrd.bd_rate(k["bpp"][:3], k["psnr"][:3], bpp[:3], k["psnr"][:3])
    with pytest.raises(ValueError):
        rd_reference.bd_rate([1, 2], [1, 2], [1, 2], [5, 6])


# ------------------------------------------- many batches / pipeline --

@pytest.fixture(scope="module")
def batches():
    return [_images(2, 128, seed=s) for s in (0, 1, 2)]


@pytest.mark.parametrize("mode,pipeline", [("staged", False),
                                           ("split", True),
                                           ("fused", True)])
def test_compress_many_equals_per_batch(joint, batches, mode, pipeline):
    many = joint.compress_many(batches, mode=mode, pipeline=pipeline)
    for x, got in zip(batches, many):
        want = joint.compress(x, mode=mode)
        assert got["strings"] == want["strings"]
        assert tuple(got["shape"]) == tuple(want["shape"])


@pytest.mark.parametrize("interleave", [1, 2, 3])
def test_decompress_many_equals_decompress(joint, batches, interleave):
    encs = [joint.compress(x) for x in batches]
    got = joint.decompress_many([(e["strings"], e["shape"]) for e in encs],
                                interleave=interleave)
    for e, d in zip(encs, got):
        want = joint.decompress(e["strings"], e["shape"])["x_hat"]
        assert torch.equal(d["x_hat"], want)


def test_encdec_pipeline_matches_sequential_and_jax(weights, joint,
                                                    batches):
    """The serving loop's streams and x_hat equal per-batch calls; its
    bpp and PSNR are the JAX codec's within the codec bars."""
    _, params, jcfg, _ = weights
    out = joint.encdec_pipeline(batches, decode_interleave=2)
    assert len(out) == len(batches)
    jax_codec = JaxCodec(jcfg, params=params)
    jax_codec.update()
    for x, r in zip(batches, out):
        enc = joint.compress(x)
        assert r["strings"] == enc["strings"]
        assert torch.equal(
            r["x_hat"], joint.decompress(enc["strings"],
                                         enc["shape"])["x_hat"])
    jout = jax_codec.encdec_pipeline(batches)
    for x, r, j in zip(batches, out, jout):
        bpp, psnr = _bpp_psnr(r, r["x_hat"].numpy(), x)
        jbpp, jpsnr = _bpp_psnr(j, np.asarray(j["x_hat"]), x)
        assert abs(bpp - jbpp) <= 0.01 * jbpp, (bpp, jbpp)
        assert abs(psnr - jpsnr) <= 0.05, (psnr, jpsnr)


def test_pipeline_producer_failure_propagates(joint, batches, monkeypatch):
    def boom(x, **kw):
        raise RuntimeError("encode failed")

    monkeypatch.setattr(joint, "compress", boom)
    with pytest.raises(RuntimeError, match="encode failed"):
        joint.encdec_pipeline(batches)


# ------------------------------------------------------------ halves --

_INDEXED = ("dt_cross_attention", "cc_mean_transforms",
            "cc_scale_transforms", "lrp_transforms")


def _flax_top(key: str) -> str:
    """The Flax tree's top-level name of a port state-dict key."""
    parts = key.split(".")
    return f"{parts[0]}_{parts[1]}" if parts[0] in _INDEXED else parts[0]


def test_partition_equals_jax(weights):
    """compress_params / decompress_params / shared_param_keys take the
    state dict's entries of exactly the modules the JAX functions take of
    the Flax tree."""
    sd, params, _, _ = weights
    for ours, theirs in ((split.compress_params, jsplit.compress_params),
                         (split.decompress_params,
                          jsplit.decompress_params)):
        assert {_flax_top(k) for k in ours(sd)} == set(theirs(params))
    shared = split.shared_param_keys(sd)
    assert {_flax_top(k) for k in sd if k.split(".")[0] in shared} == \
        set(jsplit.shared_param_keys(params))
    enc, dec = split.compress_params(sd), split.decompress_params(sd)
    assert set(enc) | set(dec) == set(sd)
    assert {k.split(".")[0] for k in set(enc) & set(dec)} == set(shared)


def test_parameter_sync_round_trip(weights, tmp_path):
    sd = weights[0]
    path = str(tmp_path / "shared.pt")
    split.ParameterSync.save_shared_parameters(sd, path)
    moved = {k: torch.zeros_like(v) for k, v in sd.items()}
    back = split.ParameterSync.load_shared_parameters(moved, path)
    shared = split.ParameterSync.extract_shared(sd)
    assert set(shared) and not any(k.startswith(("g_a.", "h_a.", "g_s."))
                                   for k in shared)
    for k in sd:
        want = sd[k] if k in shared else moved[k]
        assert torch.equal(back[k], want), k
    with pytest.raises(KeyError):
        split.ParameterSync.inject_shared({}, shared)


@pytest.fixture(scope="module")
def pair(weights):
    enc, dec = split.make_split_pair(weights[3], weights[0],
                                     enc_device="cpu", dec_device="cpu")
    yield enc, dec
    enc.close()
    dec.close()


def test_split_pair_equals_joint_codec(pair, joint, batches):
    """The encoder half's streams are the joint codec's; the decoder half
    decodes them exactly (its per-slice indexes and symbols are the
    encoder's) to the joint decode's x_hat, bitwise; the decoder codes
    under the encoder's tables."""
    enc, dec = pair
    assert dec.codec.tables is enc.tables
    x = batches[0]
    enc_rec, dec_rec = [], []
    out = enc.compress(x, record=enc_rec)
    want = joint.compress(x)
    assert out["strings"] == want["strings"]
    got = dec.decompress(out["strings"], out["shape"], record=dec_rec)
    assert len(enc_rec) == len(dec_rec) == joint.cfg.num_slices
    for (ei, es), (di, ds) in zip(enc_rec, dec_rec):
        np.testing.assert_array_equal(di, ei)
        np.testing.assert_array_equal(ds, es)
    assert torch.equal(got["x_hat"], joint.decompress(
        want["strings"], want["shape"])["x_hat"])


def test_halves_hold_only_their_modules(pair, joint, weights):
    enc, dec = pair
    e_keys = set(enc.codec.model.state_dict())
    d_keys = set(dec.codec.model.state_dict())
    assert e_keys == set(split.compress_params(weights[0]))
    assert d_keys == set(split.decompress_params(weights[0]))
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    jm = joint.model
    assert count(enc.codec.model) == count(jm) - count(jm.g_s)
    assert count(dec.codec.model) == count(jm) - count(jm.g_a) \
        - count(jm.h_a)
    assert enc.codec.role == "encoder" and dec.codec.role == "decoder"
    assert joint.role == "joint"


def test_half_refuses_the_other_halfs_work(pair, batches):
    enc, dec = pair
    x = batches[0]
    out = enc.compress(x)
    for call in (lambda: enc.codec.decompress(out["strings"], out["shape"]),
                 lambda: enc.codec.decompress_latent(np.zeros((1, 8, 8, 20),
                                                              np.float32)),
                 lambda: enc.codec.forward(x),
                 lambda: dec.codec.compress(x),
                 lambda: dec.codec.compress_latent(x),
                 lambda: dec.codec.compress_device(x),
                 lambda: dec.codec.encdec_pipeline([x])):
        with pytest.raises(RuntimeError, match="split deployment"):
            call()
    with pytest.raises(RuntimeError, match="holds no g_s"):
        enc.codec.model.synthesis(torch.zeros(1, 8, 8, 20))


def test_analyze_sizes_counts_what_a_half_holds(pair, joint, batches):
    x = (batches[0][:1] * 255).astype(np.uint8)
    whole = joint.analyze_sizes(x)
    half = pair[0].codec.analyze_sizes(x)
    n = sum(p.numel() for p in pair[0].codec.model.parameters())
    assert half["model_params"] == n < whole["model_params"]
    assert half["model_bytes_f32"] == 4 * n
    assert half["total_stream_bytes"] == whole["total_stream_bytes"]


def test_cross_device_codec_with_shipped_indexes_is_exact(weights, batches):
    """CrossDeviceCodec over two halves (both on the CPU here): with the
    encoder's indexes shipped, the decoder computes none and decodes
    exactly; its x_hat equals the decoder half's own per-slice decode."""
    sd, _, _, cfg = weights
    cross = CrossDeviceCodec(
        DCAECodec(cfg, params=split.compress_params(sd), device="cpu"),
        DCAECodec(cfg, params=split.decompress_params(sd), device="cpu"),
        ship_indexes=True)
    cross.update()
    assert cross.dec.tables is cross.enc.tables
    x = batches[1]
    out = cross.compress(x)
    assert cross._indexes is not None and "indexes" not in out
    rec = []
    got = cross.decompress(out["strings"], out["shape"], record=rec)
    assert cross._indexes is None and len(rec) == cfg.num_slices
    want = cross.dec.decompress(out["strings"], out["shape"])
    torch.testing.assert_close(got["x_hat"], want["x_hat"], rtol=0,
                               atol=1e-6)
    fwd = cross.forward(x)
    torch.testing.assert_close(fwd["x_hat"],
                               DCAECodec(cfg, params=sd,
                                         device="cpu").forward(x)["x_hat"],
                               rtol=0, atol=0)
    cross.close()


def test_entry_points_refuse_cpu_fallback(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sd, _, _, cfg = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        split.make_split_pair(cfg, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DCAECodec(cfg, params=split.compress_params(sd), device="cuda")


# ------------------------------------------------------- autoencoder --

@pytest.fixture(scope="module")
def ae(weights):
    """(port SimpleAutoencoder, Flax module, its params) on the DCAE
    weights' transforms, through params_from_dcae on each side."""
    sd, params, jcfg, cfg = weights
    model = autoencoder.SimpleAutoencoder(cfg).eval()
    model.load_state_dict(autoencoder.params_from_dcae(sd), strict=True)
    return model, jae.SimpleAutoencoder(jcfg), \
        jae.params_from_dcae(params, strict=True)


def test_autoencoder_matches_flax(ae):
    model, jmodel, jparams = ae
    x = _images(2, 128, seed=4)
    want = jax.tree.map(np.asarray, jmodel.apply({"params": jparams},
                                                 jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        y = model.compress(torch.from_numpy(x))
        x_hat = model.decompress(y)
    for k in ("y", "x_hat"):
        bar = 1e-5 * float(np.abs(want[k]).max())
        assert float(np.abs(got[k].numpy() - want[k]).max()) <= bar, k
    np.testing.assert_array_equal(y.numpy(), got["y"].numpy())
    jx = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(want["y"]),
                                 method=jae.SimpleAutoencoder.decompress))
    assert float(x_hat.min()) >= 0 and float(x_hat.max()) <= 1
    assert float(np.abs(x_hat.numpy() - jx).max()) <= 1e-5


def test_autoencoder_helpers_equal_jax(weights):
    sd, params, jcfg, cfg = weights
    got = autoencoder.params_from_dcae(sd)
    assert {k.split(".")[0] for k in got} == \
        set(jae.params_from_dcae(params)) == {"g_a", "g_s"}
    with pytest.raises(KeyError):
        autoencoder.params_from_dcae({"g_a.0.w": 1}, strict=True)
    with pytest.raises(KeyError):
        jae.params_from_dcae({"g_a": 1}, strict=True)
    for c, jc in ((cfg, jcfg), (DCAEConfig(), JaxConfig()),
                  (DCAEConfig(M=160), JaxConfig(M=160))):
        assert autoencoder.compression_ratio(c) == jae.compression_ratio(jc)
