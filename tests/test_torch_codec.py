"""The port's slice as a whole against the JAX package: the tiny window-8
DCAE on the same weights (Flax params carried across with
state_dict_from_flax), f32 on the CPU.

  * forward: x_hat, likelihoods y/z, means and scales match the Flax DCAE;
  * real coding: the port decodes its own streams exactly (the decoder's
    per-slice indexes and symbols equal the encoder's), and its bpp / PSNR
    agree with dcae_tpu's DCAECodec within 1% / 0.05 dB;
  * its .bin files parse with the JAX package's container;
  * guards: the port imports neither jax nor dcae_tpu, and its entry points
    refuse to fall back to the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.runtime import container as jcontainer
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.utils.convert import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_size=8, hyper_window_size=4)


def _images(n=2, size=128, seed=0):
    """Smooth structured images with mild noise, f32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        f = rng.uniform(0.5, 3, 3)
        img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy
                                                         + p))
                        for p in rng.uniform(0, 1, 3)], -1)
        out.append(img + rng.normal(0, 0.02, img.shape))
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    """The JAX codec and the port on the same weights. The weights are a
    seeded init in the reference's layout, turned into Flax params by the
    JAX package's own converter (a Flax init would compile the whole model
    on the CPU), then carried into the port by state_dict_from_flax."""
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
    yield jax_codec, port, _images()
    port.close()


def test_forward_matches_flax_dcae(codecs):
    jax_codec, port, x = codecs
    want = jax.tree.map(np.asarray, jax_codec.forward(x))
    got = port.forward(x)
    np.testing.assert_allclose(got["x_hat"].numpy(), want["x_hat"],
                               atol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(got["likelihoods"][k].numpy(),
                                   want["likelihoods"][k], rtol=1e-4,
                                   atol=1e-7)
    for k in ("means", "scales", "y"):
        np.testing.assert_allclose(got["para"][k].numpy(), want["para"][k],
                                   rtol=1e-4, atol=1e-5)


def _bpp_psnr(enc, x_hat, x):
    nbytes = sum(len(s) for s in enc["strings"][0] + enc["strings"][1])
    mse = float(np.mean((np.asarray(x_hat, np.float32) - x) ** 2))
    return nbytes * 8 / (x.shape[0] * x.shape[1] * x.shape[2]), \
        10 * np.log10(1 / mse)


def test_round_trip_exact_and_matches_dcae_codec(codecs):
    jax_codec, port, x = codecs
    enc_rec, dec_rec = [], []
    enc = port.compress(x, record=enc_rec)
    dec = port.decompress(enc["strings"], enc["shape"], record=dec_rec)
    assert len(enc_rec) == len(dec_rec) == port.cfg.num_slices
    for (ei, es), (di, ds) in zip(enc_rec, dec_rec):
        np.testing.assert_array_equal(di, ei)
        np.testing.assert_array_equal(ds, es)
    bpp, psnr = _bpp_psnr(enc, dec["x_hat"].numpy(), x)

    jenc = jax_codec.compress(x)
    jdec = jax_codec.decompress(jenc["strings"], jenc["shape"])
    jbpp, jpsnr = _bpp_psnr(jenc, jdec["x_hat"], x)
    assert abs(bpp - jbpp) <= 0.01 * jbpp, (bpp, jbpp)
    assert abs(psnr - jpsnr) <= 0.05, (psnr, jpsnr)


def test_bin_parses_with_jax_container(codecs, tmp_path):
    _, port, x = codecs
    enc = port.compress(x[:1])
    path = str(tmp_path / "img.bin")
    container.save_bin(path, enc["strings"], x.shape[1:3])
    strings, z_shape, padding, size = jcontainer.read_bin(
        path, port.cfg.pad_multiple, port.cfg.z_downsample)
    assert strings == enc["strings"]
    assert tuple(z_shape) == tuple(enc["shape"])
    assert size == x.shape[1:3] and padding == (0, 0, 0, 0)


def test_port_imports_no_jax():
    """Every module of the port, the training sub-packages and the tools
    included, and chip_smoke, import neither jax nor anything of dcae_tpu
    (nor the root tools or bench.py)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import dcae_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dcae_tpu_torch.__path__, 'dcae_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('train.loop', 'train.step', 'train.state',\n"
        "             'train.losses', 'data.datasets', 'utils.metrics',\n"
        "             'utils.checkpoint', 'utils.logging', 'utils.convert',\n"
        "             'tools.train', 'eval_lib', 'runtime.service',\n"
        "             'parallel.mesh', 'parallel.multihost',\n"
        "             'parallel.spatial',\n"
        "             'utils.profiling', 'utils.debug', 'tools.server',\n"
        "             'tools.client', 'tools.eval_sharded',\n"
        "             'data.synthetic', 'data.downloader',\n"
        "             'tools.validate_training', 'tools.rd_sweep_eval',\n"
        "             'tools.lanes_ab', 'tools.profile_interleaved',\n"
        "             'tools.bench_wmsa', 'tools.bench_link'):\n"
        "    assert 'dcae_tpu_torch.' + want in names, want\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dcae_tpu' or m.startswith('dcae_tpu.')\n"
        "       or m in ('bench', 'tools') or m.startswith('tools.')]\n"
        "print('modules', len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_point_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DCAECodec(DCAEConfig.tiny(**KW))
