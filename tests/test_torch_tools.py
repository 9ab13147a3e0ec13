"""The port's data generators, downloader and six root tools against the
JAX package's, tiny and on the CPU:

  * data/synthetic.py: make_dataset and synthetic_kodak write the same
    bytes as tools/validate_training.py and bench.py for the same seed;
  * data/downloader.py: sample_image_ids on a local manifest equals the
    JAX function's (no network is touched);
  * validate_training.validate at tiny size writes the JAX tool's summary
    keys (read from the JAX tool's source);
  * rd_sweep_eval.sweep on two tiny checkpoints: each point's bpp / PSNR
    within 1% / 0.05 dB of the JAX tool's logic (eval_image_real of
    dcae_tpu on the same weights), the same BD-rate from the same points;
  * lanes_ab at tiny size, K 64 and 32: header bytes exactly the JAX
    compress_device header's for the same K and slices, payload within 1%;
    every decode checksum holds;
  * profile_interleaved.bucket puts every __global__ kernel of csrc/ and
    the library kernels the path runs into their region;
  * bench_wmsa and bench_link refuse to run without a card.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

import bench
from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.data import downloader as jdownloader
from dcae_tpu.data.rd_reference import bd_rate as jbd_rate
from dcae_tpu.eval_lib import eval_image_real as jeval_image_real
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data import downloader, synthetic
from dcae_tpu_torch.data.datasets import ImageFolder
from dcae_tpu_torch.data.rd_reference import REFERENCE_RD, bd_rate
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.tools import (bench_link, bench_wmsa, lanes_ab,
                                  profile_interleaved, rd_sweep_eval,
                                  validate_training)
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.utils.checkpoint import save_checkpoint
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tools import validate_training as jvalidate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_size=8, hyper_window_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seeded_params(seed: int) -> dict:
    """A seeded init of the tiny window-8 model in the port's naming."""
    model = DCAE(DCAEConfig.tiny(**KW))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.state_dict()


# ---------------------------------------------------------- the corpora --

def test_make_dataset_same_bytes_as_jax_tool(tmp_path):
    for mod, d in ((synthetic, "port"), (jvalidate, "jax")):
        mod.make_dataset(str(tmp_path / d), n_train=3, n_test=2, size=64,
                         seed=4)
    for split, n in (("train", 3), ("test", 2)):
        for i in range(n):
            a, b = (tmp_path / d / split / f"{i:04d}.png"
                    for d in ("port", "jax"))
            assert a.read_bytes() == b.read_bytes(), (split, i)


@pytest.mark.parametrize("n,h,w,seed", [(2, 64, 96, 100), (1, 128, 64, 7)])
def test_synthetic_kodak_same_bytes_as_bench(n, h, w, seed):
    got = synthetic.synthetic_kodak(n, h, w, seed=seed)
    want = bench.synthetic_kodak(n, h, w, seed=seed)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


def test_sample_image_ids_equals_jax(tmp_path):
    csv = tmp_path / "ids.csv"
    csv.write_text("ImageID,Subset\n" + "".join(
        f"{i:016x},train\n" for i in range(50)))
    for n, seed in ((10, 100), (50, 3)):
        assert downloader.sample_image_ids(str(csv), n, seed) == \
            jdownloader.sample_image_ids(str(csv), n, seed)


def test_downloader_gates_boto3(monkeypatch, tmp_path):
    """Without boto3 the download raises the JAX package's error before
    it reaches for the network."""
    import builtins

    real = builtins.__import__

    def no_boto(name, *a, **k):
        if name in ("boto3", "botocore"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_boto)
    with pytest.raises(RuntimeError, match="boto3 is required"):
        downloader.download_images(["x"], str(tmp_path))


# ---------------------------------------------------- validate_training --

def _jax_summary_keys() -> set:
    """The keys of the summary dict literal in the JAX tool's main."""
    with open(os.path.join(ROOT, "tools", "validate_training.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "summary" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in tools/validate_training.py")


def test_validate_writes_the_jax_summary(tmp_path):
    data, save = str(tmp_path / "data"), str(tmp_path / "run")
    synthetic.make_dataset(data, n_train=16, n_test=4, size=64)
    a = validate_training.parse_args(
        ["--data", data, "--save_path", save, "--epochs", "1",
         "--patch-size", "64", "--device", "cpu"])
    opts = validate_training.options(a)
    opts.num_workers = 1
    summary = validate_training.validate(opts, DCAEConfig.tiny(), "cpu")
    keys = _jax_summary_keys()
    assert set(summary) == keys
    with open(os.path.join(save, "summary.json")) as f:
        assert set(json.load(f)) == keys
    assert np.isfinite(summary["loss_last"])
    assert summary["real_bpp_untrained"] > 0
    assert os.path.exists(os.path.join(save, "checkpoint_latest.ckpt"))
    assert isinstance(validate_training.passed(summary), bool)


# -------------------------------------------------------- rd_sweep_eval --

def test_sweep_matches_jax_logic(tmp_path):
    data = str(tmp_path / "data")
    synthetic.make_dataset(data, n_train=1, n_test=2, size=256)
    cfg, jcfg = DCAEConfig.tiny(**KW), JaxConfig.tiny(**KW)
    points = []
    for lam, seed in ((0.05, 0), (0.013, 1)):
        model = DCAE(cfg)
        model.load_state_dict(_seeded_params(seed))
        path = str(tmp_path / f"ck{seed}.ckpt")
        save_checkpoint(path, create_train_state(
            model, make_optimizer(1e-4), torch.Generator()), 1, 1.0)
        points.append((lam, path))
    out = rd_sweep_eval.sweep(points, cfg, data, 2, "cpu")
    assert out["caveat"] == rd_sweep_eval.CAVEAT

    # the JAX tool's loop on the same weights and the same crops
    ds = ImageFolder(data, "test", 256, num_workers=1)
    batch = next(iter(ds.batches(2, drop_last=False)))
    ds.pool.shutdown()
    want, codec = [], None
    for seed in (0, 1):
        params = convert_reference_state_dict(
            {k: v.numpy() for k, v in _seeded_params(seed).items()}, jcfg)
        # one codec, its parameters swapped: its programs compile once
        if codec is None:
            codec = JaxCodec(jcfg, params=params)
        codec.params = params
        codec.update(force=True)
        rs = [jeval_image_real(codec, batch[i:i + 1]) for i in range(2)]
        want.append((float(np.mean([r.bpp for r in rs])),
                     float(np.mean([r.psnr for r in rs]))))
    for row, (bpp, psnr) in zip(out["points"], want):
        assert abs(row["bpp"] - bpp) <= 0.01 * bpp, (row, bpp)
        assert abs(row["psnr"] - psnr) <= 0.05, (row, psnr)
    ref = REFERENCE_RD["Kodak"]
    try:
        jbd = jbd_rate(ref["bpp"], ref["psnr"], [r["bpp"] for r in
                                                 out["points"]],
                       [r["psnr"] for r in out["points"]])
    except ValueError:
        jbd = None
    assert out["bd_rate_vs_anchor_pct"] == jbd


def test_bd_rate_same_from_same_points():
    """The port's BD-rate is the JAX package's on overlapping curves."""
    ref = REFERENCE_RD["Kodak"]
    for scale in (0.8, 1.0, 1.3):
        pts = ([b * scale for b in ref["bpp"][1:4]], ref["psnr"][1:4])
        assert bd_rate(ref["bpp"], ref["psnr"], *pts) == pytest.approx(
            jbd_rate(ref["bpp"], ref["psnr"], *pts), rel=1e-12)


# ------------------------------------------------------------ lanes_ab --

def test_lanes_ab_accounting_matches_jax_compress_device():
    jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in _seeded_params(0).items()}, jcfg)
    imgs = [synthetic.synthetic_kodak(2, 128, 128, seed=s)
            for s in (100, 101)]
    port = DCAECodec(cfg, device="cpu",
                     params=state_dict_from_flax(params, jcfg))
    try:
        port.update()
        out = lanes_ab.ab(port, imgs, [64, 32], 1)
    finally:
        port.close()
    jax_codec = JaxCodec(jcfg, params=params)
    jax_codec.update()
    px = 2 * 128 * 128
    for k in (64, 32):
        hdr, pay = lanes_ab.accounting(jax_codec.compress_device(imgs[0],
                                                                 lanes=k))
        row = out[k]
        assert row["hdr_bytes"] == hdr == 4 * k
        assert abs(row["payload_bytes"] - pay) <= 0.01 * pay
        assert row["bpp"] == (row["hdr_bytes"] + row["payload_bytes"]) \
            * 8 / px
        assert row["tax_pct"] == 100 * row["hdr_bytes"] \
            / row["payload_bytes"]
        assert row["enc_ms"] > 0 and row["dec_ms"] > 0


# -------------------------------------------------- profile_interleaved --

def _global_kernels() -> list:
    """Every __global__ function's name in csrc/*.cu."""
    import re

    names = set()
    src = os.path.join(ROOT, "dcae_tpu_torch", "csrc")
    for f in sorted(os.listdir(src)):
        if f.endswith(".cu"):
            with open(os.path.join(src, f)) as fh:
                names |= set(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)", fh.read()))
    return sorted(names)


def test_every_hand_kernel_has_its_region():
    names = _global_kernels()
    # 12 since the lane coders' wide kernels became template instances
    assert len(names) >= 12, names
    assert {"rans_lanes_decode_kernel", "rans_lanes_encode_kernel"} <= set(
        names), names
    # conv2d_nhwc counts with the convolutions it takes from cuDNN
    want = {"wmsa": "wmsa_kernel", "conv_glu": "conv_glu_kernel",
            "rans_lanes": "rans_lanes_kernel", "conv2d": "conv_cudnn"}
    for name in names:
        region = next(v for k, v in want.items() if name.startswith(k))
        # as torch.profiler names a launch: the demangled signature
        assert profile_interleaved.bucket(
            f"void {name}<64, true>(float const*, int)") == region, name


@pytest.mark.parametrize("name,region", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv_cudnn"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "conv_cudnn"),
    ("sm80_xmma_dgrad_implicit_gemm_indexed_f32f32", "conv_cudnn"),
    ("void at::native::conv_depthwise2d_forward_kernel<float>",
     "conv_cudnn"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16",
     "gemm_cublas"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>",
     "gemm_cublas"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Add>",
     "elementwise_copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "elementwise_copy"),
    ("Memcpy DtoH (Device -> Pinned)", "elementwise_copy"),
    ("void at::native::roll_cuda_kernel<float>", "elementwise_copy"),
    ("aten::conv2d", "conv_cudnn"), ("aten::addmm", "gemm_cublas"),
    ("aten::add", "elementwise_copy"), ("something_else", "other")])
def test_library_kernels_have_their_region(name, region):
    assert profile_interleaved.bucket(name) == region


# ---------------------------------------------------------- the benches --

@pytest.mark.parametrize("call", [
    lambda: bench_wmsa.main(["--reps", "1"]),
    lambda: bench_link.main(["1"])])
def test_benches_refuse_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        call()


# ------------------------------------------------------ flags and paths --

@pytest.mark.parametrize("main", [lanes_ab.main, profile_interleaved.main])
def test_tools_raise_on_a_checkpoint_that_is_not_there(tmp_path, main):
    """A --ckpt that names no file raises (seeded weights only when the
    flag is empty), so a mistyped path cannot pass for trained weights."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(["--ckpt", str(tmp_path / "missing.ckpt"), "--device", "cpu",
              "--batch", "1"])


def test_tool_paths_default_under_tmpdir(tmp_path, monkeypatch):
    """validate_training's corpus (_cli.synth_dir, which rd_sweep_eval
    reads by default) and run directory follow TMPDIR."""
    import tempfile

    from dcae_tpu_torch.tools import _cli

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a = validate_training.parse_args([])
    assert a.data == _cli.synth_dir() == str(tmp_path / "dcae_synth")
    assert a.save_path == str(tmp_path / "dcae_train_validation")
