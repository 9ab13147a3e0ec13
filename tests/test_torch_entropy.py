"""The port's entropy side against the JAX package: Gaussian likelihood and
coding indexes, the factorized bottleneck, the integer coding tables, the
rANS coder's bytes, the .bin container and the weight conversion."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.entropy import gaussian as jg
from dcae_tpu.entropy import ops as jops
from dcae_tpu.entropy import rans as jrans
from dcae_tpu.entropy.bottleneck import EntropyBottleneck as JaxEB
from dcae_tpu.entropy.tables import build_codec_tables as jax_tables
from dcae_tpu.models.dcae import DCAE as JaxDCAE
from dcae_tpu.runtime import container as jcontainer
from dcae_tpu.utils.convert import export_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy import gaussian, ops, rans
from dcae_tpu_torch.entropy.bottleneck import EntropyBottleneck
from dcae_tpu_torch.entropy.tables import build_codec_tables
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.utils.convert import (clean_reference_state_dict,
                                          state_dict_from_flax)
from tests.torch_jax_coder import ensure_library

# the JAX coder's library, whole before any test loads it
ensure_library()


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.normal(0, 3, (2, 4, 4, 8)).astype(np.float32)
    mu = rng.normal(0, 1, y.shape).astype(np.float32)
    sigma = np.exp(rng.normal(0, 1.5, y.shape)).astype(np.float32)
    sigma.flat[:5] = [0.01, 0.05, 0.11, 0.2, 300.0]
    want = np.asarray(jg.likelihood(jnp.asarray(y), jnp.asarray(sigma),
                                    jnp.asarray(mu)))
    got = gaussian.likelihood(torch.from_numpy(y), torch.from_numpy(sigma),
                              torch.from_numpy(mu)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_build_indexes_matches_jax_at_table_boundaries():
    """The row pick counts table[:-1] < max(sigma, 0.11): sigmas exactly on
    a table entry, one ulp either side, below the bound and above the top
    must pick the same rows as the JAX package."""
    table = gaussian.get_scale_table()
    np.testing.assert_array_equal(table, jg.get_scale_table())
    on = table.astype(np.float32)
    sig = np.concatenate([
        on, np.nextafter(on, np.float32(0)), np.nextafter(on, np.float32(1e9)),
        np.float32([0.0, 0.05, 0.109999, 0.11, 255.9, 256.0, 1e4]),
        np.exp(np.random.default_rng(1).normal(0, 2, 500)).astype(np.float32),
    ]).astype(np.float32)
    want = np.asarray(jg.build_indexes(jnp.asarray(sig), jnp.asarray(table)))
    got = gaussian.build_indexes(torch.from_numpy(sig),
                                 torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lower_bound_gradient_matches_jax():
    x = np.float32([-1.0, 0.05, 0.11, 0.5, 2.0])
    g = np.float32([1.0, -1.0, 1.0, -1.0, 1.0])
    _, vjp = jax.vjp(lambda a: jops.lower_bound(a, 0.11), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(x).requires_grad_()
    ops.lower_bound(t, 0.11).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), want)


def _eb_params(C=16, seed=3):
    """Flax EntropyBottleneck params, perturbed off their init so the
    tables are not trivially symmetric."""
    eb = JaxEB(channels=C)
    z = jnp.zeros((1, 2, 2, C))
    p = jax.tree.map(np.asarray, eb.init(jax.random.PRNGKey(seed), z)[
        "params"])
    rng = np.random.default_rng(seed)
    p = {k: (v + rng.normal(0, 0.3, v.shape)).astype(np.float32)
         for k, v in p.items()}
    q = p["quantiles"]
    q[:, 0, 0], q[:, 0, 2] = q[:, 0, 1] - 8 - 4 * rng.uniform(size=C), \
        q[:, 0, 1] + 8 + 4 * rng.uniform(size=C)
    return eb, p


def _torch_eb_params(p):
    """Flax names (matrix_0, ...) -> the reference's (_matrix0, ...)."""
    return {k if k == "quantiles" else "_" + k.replace("_", ""): v
            for k, v in p.items()}


def test_bottleneck_likelihood_and_medians_match_jax():
    eb, p = _eb_params()
    z = np.random.default_rng(4).normal(0, 4, (2, 3, 5, 16)).astype(
        np.float32)
    vals, like = eb.apply({"params": p}, jnp.asarray(z))
    port = EntropyBottleneck(16)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          _torch_eb_params(p).items()}, strict=True)
    with torch.no_grad():
        pv, pl = port(torch.from_numpy(z))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(vals))
    np.testing.assert_allclose(pl.numpy(), np.asarray(like), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(port.medians().detach().numpy(),
                                  p["quantiles"][:, 0, 1])


def test_codec_tables_array_equal_to_jax():
    _, p = _eb_params()
    want = jax_tables(p)
    got = build_codec_tables(_torch_eb_params(p))
    for name in ("gaussian", "factorized"):
        w, g = getattr(want, name), getattr(got, name)
        for field in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    np.testing.assert_array_equal(got.medians, want.medians)
    np.testing.assert_array_equal(got.scale_table, want.scale_table)


def test_rans_bytes_identical_to_jax_coder():
    """Same symbols (escapes included), indexes and tables: byte-identical
    streams, and each package decodes the other's."""
    _, p = _eb_params()
    g = build_codec_tables(_torch_eb_params(p)).gaussian
    rng = np.random.default_rng(5)
    n = 5000
    idx = rng.integers(0, g.cdf_length.shape[0], n).astype(np.int32)
    sym = np.round(rng.normal(0, 4, n)).astype(np.int32)
    sym[::97] = rng.integers(-400, 400, sym[::97].shape)   # bypass escapes
    args = (g.quantized_cdf, g.cdf_length, g.offset)
    ours = rans.encode_with_indexes(sym, idx, *args)
    theirs = jrans.encode_with_indexes(sym, idx, *args)
    assert ours == theirs
    np.testing.assert_array_equal(
        rans.decode_with_indexes(theirs, idx, *args, lut=g.lut), sym)
    np.testing.assert_array_equal(rans.decode_with_indexes(theirs, idx,
                                                           *args), sym)
    np.testing.assert_array_equal(
        jrans.decode_with_indexes(ours, idx, *args), sym)
    pmf = rng.uniform(size=40).astype(np.float32)
    np.testing.assert_array_equal(rans.pmf_to_quantized_cdf(pmf),
                                  jrans.pmf_to_quantized_cdf(pmf))
    np.testing.assert_array_equal(
        rans.build_decode_lut(*args[:2]),
        jrans.build_decode_lut(*args[:2]))


def test_container_bytes_identical():
    strings = [[b"\x01\x02y-stream"], [b"z"]]
    ours = container.pack_bin(strings, (500, 740))
    assert ours == jcontainer.pack_bin(strings, (500, 740))
    assert container.unpack_bin(ours) == jcontainer.unpack_bin(ours)
    assert container.calculate_padding(500, 740) == \
        jcontainer.calculate_padding(500, 740)


@pytest.fixture(scope="module")
def flax_params():
    """Parameters of the shapes of a tiny Flax DCAE whose deepest stage is
    scanned (block_num 4), filled from a numpy seed (shapes traced only)."""
    jcfg = JaxConfig.tiny(block_num=(1, 2, 4))
    x = jnp.zeros((1, jcfg.pad_multiple, jcfg.pad_multiple, 3))
    shapes = jax.eval_shape(JaxDCAE(jcfg).init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(6)
    return jcfg, jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        shapes["params"])


def test_state_dict_from_flax_equals_export(flax_params):
    """Key for key and value for value the JAX package's own exporter, and
    a strict load into the port's DCAE."""
    jcfg, params = flax_params
    want = export_reference_state_dict(params, jcfg)
    got = state_dict_from_flax(params, jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = DCAE(DCAEConfig.tiny(block_num=(1, 2, 4)))
    model.load_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in got.items()}, strict=True)


def test_reference_state_dict_loads_unchanged(flax_params):
    """A reference-style checkpoint (DDP prefix, coding buffers) loads
    strictly after clean_reference_state_dict."""
    jcfg, params = flax_params
    sd = {f"module.{k}": torch.from_numpy(v.copy()) for k, v in
          export_reference_state_dict(params, jcfg).items()}
    sd["module.entropy_bottleneck._quantized_cdf"] = torch.zeros(3, 4)
    sd["module.gaussian_conditional.scale_table"] = torch.ones(64)
    model = DCAE(DCAEConfig.tiny(block_num=(1, 2, 4)))
    model.load_state_dict(clean_reference_state_dict({"state_dict": sd}),
                          strict=True)
