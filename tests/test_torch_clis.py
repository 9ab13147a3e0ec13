"""The port's CLIs (dcae_tpu_torch/tools) on the CPU, at the tiny config, on
generated PNGs, the way tests/test_eval_clis.py drives the JAX package's:
compress_and_decompress in the classic, interleaved and latent formats,
cal_bin, eval (forward, real, two-phase, the cross-device codec with
shipped indexes, size analysis), export_checkpoint, train_autoencoder and
eval_autoencoder (joint and split), plus the cross-package check: a .bin,
DTI and DLT1 file written by either package's codec CLI is read by the
other's and decodes within the codec bars (PSNR against the source within
0.05 dB of the writing package's own decode, as tests/test_torch_codec.py
holds the two codecs).
"""

import os
import re

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.runtime import container as jcontainer
from dcae_tpu.utils import checkpoint as jcheckpoint
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container
from dcae_tpu_torch.tools import (cal_bin, compress_and_decompress, eval as
                                  eval_cli, eval_autoencoder,
                                  export_checkpoint, train_autoencoder)
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.utils.checkpoint import (load_params_only, load_tables,
                                             save_checkpoint)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate([(192, 256), (176, 240)]):
        base = rng.uniform(0, 1, (h // 16, w // 16, 3))
        img = np.clip(np.kron(base, np.ones((16, 16, 1)))
                      + rng.normal(0, 0.02, (h, w, 3)), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            str(d / f"im{i}.png"))
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One seeded tiny-config init as a checkpoint of each package: the
    port's (a train state) and the JAX package's (msgpack params)."""
    d = tmp_path_factory.mktemp("ck")
    cfg = DCAEConfig.tiny()
    model = DCAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    port = str(d / "port.ckpt")
    save_checkpoint(port, create_train_state(model, make_optimizer(1e-4),
                                             torch.Generator()), 1, 2.0)
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JaxConfig.tiny())
    jax_path = str(d / "jax.ckpt")
    jcheckpoint.save_checkpoint(jax_path, {"params": params}, 1, 2.0)
    return {"port": port, "jax": jax_path, "params": params}


def _codec_cli(*args):
    compress_and_decompress.main(["--tiny", "--device", "cpu", *args])


def _psnr(png: str, src: str) -> float:
    a = np.asarray(Image.open(png), np.float64)
    b = np.asarray(Image.open(src), np.float64)
    return 10 * np.log10(255.0 ** 2 / np.mean((a - b) ** 2))


FORMATS = {"classic": [], "interleaved": ["--interleaved"],
           **{f"latent_{d}": ["--latent", d]
              for d in ("float32", "float16", "bfloat16", "int8")}}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_codec_cli_round_trip(image_dir, ckpts, tmp_path, fmt, capsys):
    save = str(tmp_path / "o")
    _codec_cli("--mode", "compress", "--data", image_dir, "--save_path",
               save, "--checkpoint", ckpts["port"], *FORMATS[fmt])
    bins = sorted(os.listdir(os.path.join(save, "bin")))
    assert bins == ["im0.bin", "im1.bin"]
    with open(os.path.join(save, "bin", "im0.bin"), "rb") as f:
        head = f.read(4)
    if fmt.startswith("latent"):
        assert container.is_latent_bin(head)
    elif fmt == "interleaved":
        assert head == b"DTI2" or "classic .bin" in capsys.readouterr().out
    _codec_cli("--mode", "decompress", "--data", os.path.join(save, "bin"),
               "--save_path", save, "--checkpoint", ckpts["port"])
    for i, shape in enumerate([(192, 256, 3), (176, 240, 3)]):
        png = os.path.join(save, "png", f"im{i}.png")
        assert np.asarray(Image.open(png)).shape == shape
        assert _psnr(png, os.path.join(image_dir, f"im{i}.png")) > 3


@pytest.fixture(scope="module")
def jax_files(image_dir, ckpts, tmp_path_factory):
    """The JAX CLI's compress_dir / decompress_dir on one JAX codec, so
    that its programs compile once. Its main() builds the codec from a Flax
    init (which compiles the whole model) and then loads the checkpoint;
    here the checkpoint's params go in directly."""
    from tools.compress_and_decompress import compress_dir, decompress_dir

    template = jax.tree.map(np.zeros_like, ckpts["params"])
    codec = JaxCodec(JaxConfig.tiny(), params=jcheckpoint.load_params_only(
        ckpts["jax"], template))
    codec.update()
    d = tmp_path_factory.mktemp("jaxcli")
    for fmt, kw in (("classic", {}), ("interleaved", {"interleaved": True}),
                    ("latent", {"latent_dtype": "float16"})):
        compress_dir(codec, image_dir, str(d / fmt), **kw)
    return codec, decompress_dir, d


@pytest.mark.parametrize("fmt", ["classic", "interleaved", "latent"])
def test_files_cross_between_packages(image_dir, ckpts, jax_files, tmp_path,
                                      fmt):
    """A file the JAX CLI writes decodes with the port's CLI, and the
    reverse, each within 0.05 dB of the writer's own decode."""
    jcodec, jdecompress_dir, d = jax_files
    ours = str(tmp_path / "ours")
    extra = {"classic": [], "interleaved": ["--interleaved"],
             "latent": ["--latent", "float16"]}[fmt]
    _codec_cli("--mode", "compress", "--data", image_dir, "--save_path",
               ours, "--checkpoint", ckpts["port"], *extra)
    theirs = str(d / fmt / "bin")
    with open(os.path.join(theirs, "im0.bin"), "rb") as f:
        jraw = f.read()
    with open(os.path.join(ours, "bin", "im0.bin"), "rb") as f:
        raw = f.read()
    if fmt == "latent":
        assert jcontainer.is_latent_bin(jraw) and container.is_latent_bin(raw)
    elif fmt == "interleaved":
        assert container.is_interleaved_bin(jraw) == \
            jcontainer.is_interleaved_bin(jraw)
    else:
        assert raw == jraw            # the classic streams, byte for byte

    out = {}
    for writer, bins in (("jax", theirs), ("port", os.path.join(ours,
                                                                "bin"))):
        for reader in ("jax", "port"):
            dst = str(tmp_path / f"{writer}_by_{reader}")
            if reader == "jax":
                jdecompress_dir(jcodec, bins, dst)
            else:
                _codec_cli("--mode", "decompress", "--data", bins,
                           "--save_path", dst, "--checkpoint",
                           ckpts["port"])
            out[writer, reader] = [
                _psnr(os.path.join(dst, "png", f"im{i}.png"),
                      os.path.join(image_dir, f"im{i}.png"))
                for i in range(2)]
    for writer in ("jax", "port"):
        for a, b in zip(out[writer, "jax"], out[writer, "port"]):
            assert abs(a - b) <= 0.05, (writer, out)


def test_cal_bin(image_dir, ckpts, tmp_path, capsys):
    save = str(tmp_path / "o")
    _codec_cli("--mode", "compress", "--data", image_dir, "--save_path",
               save, "--checkpoint", ckpts["port"])
    capsys.readouterr()
    cal_bin.main(["--data", os.path.join(save, "bin")])
    text = capsys.readouterr().out
    assert "im0.bin: 192x256" in text and "average over 2" in text
    r = cal_bin.summarize(os.path.join(save, "bin", "im0.bin"))
    assert r["bytes"] == os.path.getsize(os.path.join(save, "bin",
                                                      "im0.bin"))
    assert r["bpp"] == pytest.approx(r["bytes"] * 8 / (192 * 256))


def _eval(*args):
    eval_cli.main(["--tiny", *args])


def _average(text: str) -> tuple:
    m = re.search(r"average: psnr ([\d.]+) dB .*?bpp ([\d.]+)", text)
    return float(m.group(1)), float(m.group(2))


def test_eval_forward_real_and_two_phase(image_dir, ckpts, tmp_path,
                                         capsys):
    ck = ["--checkpoint", ckpts["port"], "--device", "cpu"]
    _eval("--data", image_dir, *ck)
    fwd = _average(capsys.readouterr().out)
    _eval("--data", image_dir, "--real", "--bd_dataset", "Kodak", *ck)
    text = capsys.readouterr().out
    real = _average(text)
    assert "golden Kodak RD" in text
    assert abs(fwd[0] - real[0]) < 0.5 and real[1] > 0
    enc_dir = str(tmp_path / "enc")
    _eval("--data", image_dir, "--mode", "compress", "--save_path", enc_dir,
          *ck)
    capsys.readouterr()
    _eval("--data", image_dir, "--mode", "decompress", "--save_path",
          enc_dir, *ck)
    two = capsys.readouterr().out
    assert "over 2 images" in two
    # the two-phase PSNR of im1 equals the one-pass real eval's
    p1 = re.search(r"im1.png: psnr ([\d.]+)", two).group(1)
    assert f"im1.png: psnr {p1}" in text


def test_eval_cross_device_ship_indexes(image_dir, ckpts, tmp_path, capsys):
    ck = ["--checkpoint", ckpts["port"]]
    _eval("--data", image_dir, "--real", "--device", "cpu", *ck)
    joint = _average(capsys.readouterr().out)
    _eval("--data", image_dir, "--real", "--device_encoder", "cpu",
          "--device_decoder", "cpu", "--ship_indexes", *ck)
    cross = _average(capsys.readouterr().out)
    assert cross == joint
    enc_dir = str(tmp_path / "enc")
    for mode in ("compress", "decompress"):
        _eval("--data", image_dir, "--mode", mode, "--save_path", enc_dir,
              "--device_encoder", "cpu", "--device_decoder", "cpu",
              "--ship_indexes", *ck)
    assert "over 2 images" in capsys.readouterr().out


def test_eval_size_analysis_of_a_split_deployment(image_dir, ckpts, capsys):
    import json

    _eval("--data", image_dir, "--mode", "size_analysis", "--device", "cpu",
          "--checkpoint", ckpts["port"])
    joint = json.loads(capsys.readouterr().out)
    _eval("--data", image_dir, "--mode", "size_analysis", "--device_encoder",
          "cpu", "--device_decoder", "cpu", "--checkpoint", ckpts["port"])
    split = json.loads(capsys.readouterr().out)
    assert split["total_stream_bytes"] == joint["total_stream_bytes"]
    assert split["model_params"] < joint["model_params"]
    assert split["decoder_model_params"] < joint["model_params"]


def test_export_checkpoint(ckpts, tmp_path, capsys):
    out = str(tmp_path / "exported.ckpt")
    export_checkpoint.main(["--checkpoint", ckpts["port"], "--output", out,
                            "--tiny", "--device", "cpu"])
    params = load_params_only(out)
    src = load_params_only(ckpts["port"])
    assert set(params) == set(src)
    assert all(torch.equal(params[k], src[k]) for k in src)
    tables = load_tables(out)
    from dcae_tpu_torch.models.codec import DCAECodec
    codec = DCAECodec(DCAEConfig.tiny(), params=src, device="cpu")
    codec.update()
    np.testing.assert_array_equal(tables.gaussian.quantized_cdf,
                                  codec.tables.gaussian.quantized_cdf)
    np.testing.assert_array_equal(tables.factorized.quantized_cdf,
                                  codec.tables.factorized.quantized_cdf)
    codec.close()


@pytest.fixture(scope="module")
def ae_ckpt(image_dir, ckpts, tmp_path_factory):
    """train_autoencoder for 2 steps (2 training images, batch 1), started
    from the DCAE checkpoint's transforms."""
    import shutil

    root = tmp_path_factory.mktemp("ae_ds")
    for split, names in (("train", ["im0", "im1"]), ("test", ["im0"])):
        os.makedirs(root / split)
        for n in names:
            shutil.copy(os.path.join(image_dir, f"{n}.png"),
                        root / split / f"{n}.png")
    save = str(tmp_path_factory.mktemp("ae"))
    train_autoencoder.main(["-d", str(root), "--tiny", "--M", "20",
                            "--epochs", "1", "--batch-size", "1",
                            "--patch-size", "64", "--device", "cpu",
                            "--save_path", save, "--num-workers", "1",
                            "--from_dcae", ckpts["port"]])
    return os.path.join(save, "checkpoint_latest.ckpt")


def test_train_autoencoder_two_steps(ae_ckpt, ckpts):
    import dcae_tpu_torch.utils.checkpoint as ck

    payload = ck._read(ae_ckpt)
    assert payload["state"]["step"] == 2
    sd = load_params_only(ae_ckpt)
    src = load_params_only(ckpts["port"])
    assert {k.split(".")[0] for k in sd} == {"g_a", "g_s"}
    assert not torch.equal(sd["g_a.0.conv.weight"],
                           src["g_a.0.conv.weight"])


def test_eval_autoencoder_joint_and_split(image_dir, ae_ckpt, tmp_path,
                                          capsys):
    out = str(tmp_path / "out")
    eval_autoencoder.main(["--data", image_dir, "--tiny", "--M", "20",
                           "--checkpoint", ae_ckpt, "--device", "cpu",
                           "--save_path", out])
    with open(os.path.join(out, "summary_results.txt")) as f:
        joint = f.read()
    assert "Average PSNR" in joint and "Compression Ratio" in joint
    assert os.path.exists(os.path.join(out, "reconstructed_im0.png"))
    assert os.path.exists(os.path.join(out, "metrics_im0.txt"))
    res = eval_autoencoder.main([
        "--data", image_dir, "--tiny", "--M", "20", "--checkpoint", ae_ckpt,
        "--split", "--device_encoder", "cpu", "--device_decoder", "cpu",
        "--latent_dtype", "float16", "--save_path", out])
    printed = capsys.readouterr().out
    assert "xfer" in printed and "SIZE ANALYSIS" in printed
    assert "spatial_reduction" in printed and "model sizes: g_a" in printed
    assert res["size_analysis"]["latent_dtype"] == "float16"
    with open(os.path.join(out, "summary_results_split.txt")) as f:
        text = f.read()
    assert "transfer time" in text and "float16 latent" in text
    # fp16 shipping costs little against the joint f32 decode
    psnr = lambda t: float(re.search(r"Average PSNR: ([\d.]+)",  # noqa
                                     t).group(1))
    assert abs(psnr(text) - psnr(joint)) < 0.1


def test_eval_autoencoder_split_encoder_defaults_to_cpu():
    """The split deployment's encoder is the CPU edge by default, as in
    the JAX tool; the joint and decoder devices keep the card."""
    a = eval_autoencoder.parser().parse_args(["--data", "d", "--split"])
    assert (a.device_encoder, a.device_decoder, a.device) == \
        ("cpu", "cuda", "cuda")


def test_clis_refuse_cpu_fallback(image_dir, ckpts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (
            lambda: compress_and_decompress.main(
                ["--mode", "compress", "--data", image_dir, "--tiny",
                 "--save_path", str(tmp_path)]),
            lambda: eval_cli.main(["--data", image_dir, "--tiny"]),
            lambda: eval_cli.main(["--data", image_dir, "--tiny",
                                   "--device_encoder", "cpu"]),
            lambda: export_checkpoint.main(["--checkpoint", ckpts["port"],
                                            "--output", str(tmp_path / "e"),
                                            "--tiny"]),
            lambda: eval_autoencoder.main(["--data", image_dir, "--tiny",
                                           "--split", "--device_encoder",
                                           "cpu"]),
            lambda: train_autoencoder.main(["-d", image_dir, "--tiny"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
