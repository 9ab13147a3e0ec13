"""Full-size f32 parity of the port against the Flax DCAE: DCAEConfig()
(N=192, M=320, 119M parameters), one 256x256 image, on the CPU.

The weights are a seeded init of the port, carried into Flax params by
the JAX package's own converter and back with state_dict_from_flax (the
pattern of tests/test_torch_codec.py), so both sides hold the same
numbers. Held, with the tolerances stated:

  * y, means and scales: max |port - Flax| / max |Flax| <= 1e-5 (the
    North star's class of agreement: the JAX model matched the
    reference's torch code to about 5e-6 on y);
  * the likelihoods of y and z: rtol 1e-4, atol 1e-7;
  * x_hat: atol 1e-4, as in the tiny-config test.

Slow: the Flax forward compiles the whole model on the CPU.
"""

import time

import numpy as np
import jax
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data.synthetic import synth_image
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.utils.convert import state_dict_from_flax


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.slow
def test_full_size_forward_matches_flax_dcae():
    jcfg, cfg = JaxConfig(), DCAEConfig()
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in init.state_dict().items()}, jcfg)
    del init
    x = synth_image(np.random.default_rng(0), 256)[None]

    t0 = time.perf_counter()
    want = jax.tree.map(np.asarray,
                        JaxCodec(jcfg, params=params).forward(x))
    t1 = time.perf_counter()
    port = DCAECodec(cfg, device="cpu",
                     params=state_dict_from_flax(params, jcfg))
    try:
        with torch.no_grad():
            got = port.forward(x)
    finally:
        port.close()
    t2 = time.perf_counter()

    errs = {k: _rel(got["para"][k].numpy(), want["para"][k])
            for k in ("y", "means", "scales")}
    like = {k: float(np.abs(got["likelihoods"][k].numpy()
                            - want["likelihoods"][k]).max())
            for k in ("y", "z")}
    x_hat = float(np.abs(got["x_hat"].numpy() - want["x_hat"]).max())
    print(f"full-size parity: max|diff| / max|Flax| {errs}; likelihoods "
          f"max|diff| {like}; x_hat max|diff| {x_hat:.3e}; Flax forward "
          f"{t1 - t0:.1f} s, port {t2 - t1:.1f} s")
    for k, e in errs.items():
        assert e <= 1e-5, (k, e)
    for k in ("y", "z"):
        np.testing.assert_allclose(got["likelihoods"][k].numpy(),
                                   want["likelihoods"][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["x_hat"].numpy(), want["x_hat"],
                               atol=1e-4)
