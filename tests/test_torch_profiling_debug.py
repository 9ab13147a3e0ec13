"""The port's profiling and tensor-dump tools on the CPU (tiny config):
time_fn, report, op_stats and codec_breakdown give the JAX package's keys;
cost_analysis counts a product's FLOPs and a hand kernel's registered
count; a port dump_codec_run and a JAX dump_codec_run on the same weights
are read by the JAX package's compare_dumps (and the port's, which reports
alike): float tensors within a stated tolerance, the streams, indexes and
symbols reported (not required equal across frameworks: ROADMAP, "Not a
bar").
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.utils import debug as jdebug
from dcae_tpu.utils import profiling as jprofiling
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.ops.kernels import note_launch
from dcae_tpu_torch.utils import debug, profiling
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_codec import KW, _images

REPORT_KEYS = {"label", "median_ms", "best_ms", "gflops", "hbm_gb",
               "tflops_per_s", "hbm_gb_per_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def codecs():
    """The JAX codec and the port on one seeded init (as in
    tests/test_torch_codec.py)."""
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
    yield jax_codec, port, _images(1)
    port.close()


def test_time_fn_and_report_keys():
    a = torch.ones(64, 64)
    t = profiling.time_fn(torch.matmul, a, a, iters=3, warmup=1)
    jt = jprofiling.time_fn(jnp.matmul, jnp.ones((8, 8)), jnp.ones((8, 8)),
                            iters=1, warmup=0)
    assert t.keys() == jt.keys() and len(t["times_s"]) == 3
    assert 0 < t["best_s"] <= t["median_s"]
    r = profiling.report(torch.matmul, a, a, iters=2, warmup=1, label="mm")
    jr = jprofiling.report(jnp.matmul, jnp.ones((8, 8)), jnp.ones((8, 8)),
                           iters=1, warmup=0)
    assert r.keys() == jr.keys() == REPORT_KEYS
    assert r["label"] == "mm" and r["gflops"] == pytest.approx(2 * 64 ** 3
                                                               / 1e9)


def test_cost_analysis_counts_products_and_hand_kernels():
    a = torch.ones(32, 16)
    b = torch.ones(16, 8)
    c = profiling.cost_analysis(torch.matmul, a, b)
    assert c["flops"] == 2 * 32 * 16 * 8 and c["kernel_flops"] == 0
    # operands and result, each once: (32*16 + 16*8 + 32*8) f32
    assert c["bytes_accessed"] == 4 * (32 * 16 + 16 * 8 + 32 * 8)

    def with_kernel(x):
        note_launch("wmsa_block", 1000, x, x)   # what a launch tells
        return x * 2

    k = profiling.cost_analysis(with_kernel, a)
    # FlopCounterMode counts products and convolutions, not x * 2
    assert k["kernel_flops"] == k["flops"] == 1000
    assert k["bytes_accessed"] == 2 * 4 * 32 * 16 + 2 * 4 * 32 * 16


def test_trace_and_op_stats(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        torch.nn.functional.conv2d(torch.randn(1, 3, 16, 16),
                                   torch.randn(4, 3, 3, 3))
        a @ a
    assert os.path.exists(tmp_path / "trace.json")
    s = profiling.op_stats(str(tmp_path), group_fn=lambda n: n[:4],
                           keep_rows=True)
    assert {"total_ms", "by_type", "by_group", "top", "rows"} <= s.keys()
    assert s["total_ms"] > 0
    assert {"convolution", "gemm"} <= s["by_type"].keys()
    assert s["total_ms"] == pytest.approx(sum(s["by_type"].values()))
    assert s["total_ms"] == pytest.approx(sum(s["by_group"].values()))
    ms, n, kind, name = s["top"][0]
    assert ms > 0 and n >= 1 and kind == profiling.op_type(name)


@pytest.mark.parametrize("name,kind", [
    ("void wmsa_mma_kernel<true>(...)", "wmsa_block"),
    ("void wmsa_tf32_kernel<false>(...)", "wmsa_attention"),
    ("conv_glu_bf16_gemm_kernel", "conv_glu bf16"),
    ("conv_glu_gate_kernel", "conv_glu f32"),
    ("rans_lanes_decode_kernel", "rans_lanes"),
    ("sm90_xmma_fprop_implicit_gemm", "convolution"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("elementwise_kernel", "other")])
def test_op_type(name, kind):
    assert profiling.op_type(name) == kind


def test_codec_breakdown_keys(codecs):
    _, port, x = codecs
    out = profiling.codec_breakdown(port, x, iters=1)
    # the JAX package's subnets (dcae_tpu/utils/profiling.py)
    assert list(out) == ["g_a", "h_a", "hyper_synthesis", "g_s",
                         "encode_full"]
    for r in out.values():
        assert r.keys() == REPORT_KEYS and r["median_ms"] > 0
    assert out["g_a"]["gflops"] > 0


def test_dumps_cross_between_packages(codecs, tmp_path):
    jax_codec, port, x = codecs
    root = str(tmp_path)
    debug.dump_codec_run(port, x, root, "port")
    jdebug.dump_codec_run(jax_codec, x, root, "jax")
    names = sorted(os.listdir(os.path.join(root, "port")))
    assert names == sorted(os.listdir(os.path.join(root, "jax")))
    report = jdebug.compare_dumps(root, "port", "jax")
    assert report == debug.compare_dumps(root, "port", "jax")
    assert set(report) == {n for n in names if n != "manifest.json"}
    for name, entry in report.items():
        assert "missing_in" not in entry and "shape_mismatch" not in entry
        if name.startswith(("indexes_", "symbols_")) or \
                name.endswith(".bin") or name == "z_symbols.npy":
            continue                      # reported, not a bar
        a = np.load(os.path.join(root, "port", name))
        # f32 against f32 on the same weights, the reference-parity class:
        # y 1.4e-6 of its largest, the entropy side ~3e-7 on this input
        assert entry["max_abs"] <= 1e-5 * max(float(np.abs(a).max()), 1e-6), \
            (name, entry)
    # the same rounding most everywhere
    for i in range(5):
        p = np.load(os.path.join(root, "port", f"symbols_{i}.npy"))
        j = np.load(os.path.join(root, "jax", f"symbols_{i}.npy"))
        assert np.mean(p == j) > 0.99
    assert debug.print_report(debug.compare_dumps(root, "port", "port"))
