"""The port's training stack around the step, on the CPU: the aux-LR
scheduler, checkpoints and their policy, the coding tables' files in both
directions between the packages, the data pipeline, the metrics and the
training loop with its real-codec validation. Mirrors tests/test_train.py;
where the JAX package has the same function the two are held together on
the same seeded inputs.
"""

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from dcae_tpu.data.datasets import ImageFolder as JaxImageFolder
from dcae_tpu.entropy.tables import CodecTables as JaxCodecTables
from dcae_tpu.train.state import \
    ExponentialTargetScheduler as JaxTargetScheduler
from dcae_tpu.utils import metrics as jmetrics
from dcae_tpu_torch import eval_lib
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.data.datasets import ImageFolder
from dcae_tpu_torch.entropy.tables import CodecTables
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.ops.layers import crop_spatial, pad_spatial
from dcae_tpu_torch.train import state as tstate
from dcae_tpu_torch.train.loop import (TrainOptions, resolve_aux_scheduler,
                                       run_training, validate_real)
from dcae_tpu_torch.train.step import make_train_step
from dcae_tpu_torch.utils import metrics
from dcae_tpu_torch.utils.checkpoint import (CheckpointPolicy,
                                             load_checkpoint,
                                             load_params_only, load_tables,
                                             save_checkpoint)
from dcae_tpu_torch.utils.logging import MetricLogger
from tests.test_torch_codec import KW, _images

CFG = DCAEConfig.tiny(**KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many small ops beside other
    test processes: one intra-op thread each, or the workers' thread pools
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(seed=0, **opt):
    model = DCAE(CFG)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    tx = tstate.make_optimizer(1e-4, 1e-3, **opt)
    return model, tx, tstate.create_train_state(
        model, tx, torch.Generator().manual_seed(seed + 1))


def _write_pngs(root, n_train=6, n_test=3, size=(80, 100)):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            arr = rng.integers(0, 255, (*size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, split, f"{i}.png"))


# ------------------------------------------------------------ optimizer --

def test_param_labels():
    model, _, _ = _state()
    labels = tstate.param_labels(model)
    aux = [k for k, v in labels.items() if v == "aux"]
    assert aux == ["entropy_bottleneck.quantiles"]
    assert set(labels.values()) == {"aux", "main"}
    frozen = tstate.param_labels(model, ("g_a", "h_a"))
    assert {k.split(".")[0] for k, v in frozen.items() if v == "main"} == {
        "g_a", "h_a"}
    assert frozen["entropy_bottleneck.quantiles"] == "frozen"
    assert frozen["dt"] == "frozen"


def test_frozen_quantiles_leave_no_aux_optimizer():
    _, _, st = _state(trainable_keys=("g_a", "h_a"))
    assert st.aux_opt is None and np.isnan(tstate.get_aux_lr(st))
    tstate.set_aux_lr(st, 0.05)                  # nothing to set: no error


def test_multiplier_bands_match_jax():
    """The same bands and 0.1 cap as the JAX scheduler, value for value."""
    s = tstate.ExponentialTargetScheduler(3820, 10, 100)
    j = JaxTargetScheduler(3820, 10, 100)
    lr, mult = s.step(current_aux_loss=3820, main_lr=1e-4, epoch=50)
    assert mult == 1000 and lr == pytest.approx(0.1)
    expected = 3820 * s.decay_rate ** 30
    lr, mult = s.step(expected * 0.99, 1e-4, 30)
    assert mult >= 50 and lr <= 0.1
    lr, mult = s.step(expected * 1.2, 1e-4, 30)
    assert 100 <= mult <= 500
    for aux, epoch in ((3820, 50), (expected * 0.99, 30),
                       (expected * 1.2, 30), (5.0, 99), (2000, 1)):
        assert s.step(aux, 1e-4, epoch) == j.step(aux, 1e-4, epoch)


def test_default_aux_scheduler_resolution():
    opts = TrainOptions(dataset="/nonexistent")
    assert opts.aux_scheduler is None
    assert resolve_aux_scheduler(opts, DCAEConfig()) is True
    assert resolve_aux_scheduler(opts, DCAEConfig.tiny()) is False
    off = dataclasses.replace(opts, aux_scheduler=False)
    assert resolve_aux_scheduler(off, DCAEConfig()) is False
    on = dataclasses.replace(opts, aux_scheduler=True)
    assert resolve_aux_scheduler(on, DCAEConfig.tiny()) is True
    assert opts.sp == 1


def test_set_get_aux_lr_and_boost_moves_quantiles_faster():
    x = torch.from_numpy(_images(1, 128, seed=2))

    def quantile_delta(aux_lr):
        model, tx, st = _state()
        assert tstate.get_aux_lr(st) == pytest.approx(1e-3)
        tstate.set_aux_lr(st, aux_lr)
        assert tstate.get_aux_lr(st) == pytest.approx(aux_lr)
        assert st.main_opt.param_groups[0]["lr"] == pytest.approx(1e-4)
        q0 = model.entropy_bottleneck.quantiles.detach().clone()
        make_train_step(model, tx, 0.013)(st, x)
        return float((model.entropy_bottleneck.quantiles - q0).abs().max())

    assert quantile_delta(5e-2) > 10 * quantile_delta(1e-3)


# ----------------------------------------------------------- checkpoints --

def test_save_load_round_trip_and_resume(tmp_path):
    """A reloaded state resumes at the same step and its next step lands
    on the same parameters, bit for bit: model, both Adams' moments and
    the generator's state all come back."""
    x = torch.from_numpy(_images(1, 128, seed=2))
    model, tx, st = _state()
    step = make_train_step(model, tx, 0.013)
    step(st, x)
    path = str(tmp_path / "sub" / "ck.ckpt")
    save_checkpoint(path, st, epoch=7, loss=1.25, extra={"note": 1})
    assert not os.path.exists(path + ".tmp")

    # a checkpoint written on the card names the fused Adam: which
    # implementation runs must stay the resuming state's own
    payload = torch.load(path, weights_only=True)
    for group in payload["state"]["main_opt"]["param_groups"]:
        group["fused"] = True
    torch.save(payload, path)

    model2, tx2, st2 = _state(seed=5)            # other weights, other noise
    restored, epoch, loss = load_checkpoint(path, st2)
    assert not st2.main_opt.param_groups[0]["fused"]
    assert restored is st2 and epoch == 7 and loss == 1.25
    assert st2.step == st.step == 1
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), n
    step(st, x)
    make_train_step(model2, tx2, 0.013)(st2, x)
    assert st2.step == 2
    for (n, a), (_, b) in zip(model.named_parameters(),
                              model2.named_parameters()):
        assert torch.equal(a, b), n

    # ... and so must the noise generator, whose state has another layout
    # on the other kind of device
    payload["state"]["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(payload, path)
    load_checkpoint(path, _state(seed=6)[2])

    params = load_params_only(path)
    assert set(params) == set(model.state_dict())
    codec = DCAECodec(CFG, params=params, device="cpu")
    codec.close()


def test_policy_files(tmp_path):
    _, _, st = _state()
    policy = CheckpointPolicy(str(tmp_path))
    policy.save(st, epoch=5, loss=2.0)
    policy.save(st, epoch=6, loss=1.0)
    policy.save(st, epoch=7, loss=3.0)
    names = set(os.listdir(tmp_path))
    assert names == {"checkpoint_latest.ckpt", "checkpoint_epoch5.ckpt",
                     "checkpoint_best.ckpt"}
    _, epoch, best = load_checkpoint(
        str(tmp_path / "checkpoint_best.ckpt"), st)
    assert (epoch, best) == (6, 1.0)
    _, epoch, _ = load_checkpoint(
        str(tmp_path / "checkpoint_latest.ckpt"), st)
    assert epoch == 7


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_codec_tables_files_cross_the_packages(tmp_path, writer):
    """An .npz written by one package loads in the other, every array
    equal; a checkpoint stores its tables beside itself."""
    codec = DCAECodec(CFG, device="cpu")
    codec.update()
    codec.close()
    tables = codec.tables
    path = str(tmp_path / "t.npz")
    if writer == "port":
        tables.save(path)
        back = JaxCodecTables.load(path)
    else:
        JaxCodecTables.from_dict(tables.as_dict()).save(path)
        back = CodecTables.load(path)
    want, got = tables.as_dict(), back.as_dict()
    assert set(want) == set(got) and len(want) == 8
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    _, _, st = _state()
    ck = str(tmp_path / "ck.ckpt")
    assert load_tables(ck) is None
    save_checkpoint(ck, st, 1, 0.5, tables=tables)
    np.testing.assert_array_equal(load_tables(ck).gaussian.quantized_cdf,
                                  tables.gaussian.quantized_cdf)


# ------------------------------------------------------------------ data --

def test_image_folder_batches_equal_the_jax_package(tmp_path):
    _write_pngs(str(tmp_path))
    ds = ImageFolder(str(tmp_path), "train", patch_size=64, seed=7)
    jds = JaxImageFolder(str(tmp_path), "train", patch_size=64, seed=7)
    assert len(ds) == len(jds) == 6 and ds.steps_per_epoch(2) == 3
    for epoch in (0, 1):
        batches = list(ds.batches(batch_size=2, epoch=epoch))
        jbatches = list(jds.batches(batch_size=2, epoch=epoch))
        assert len(batches) == len(jbatches) == 3
        for b, jb in zip(batches, jbatches):
            assert b.shape == (2, 64, 64, 3) and b.dtype == np.float32
            assert 0 <= b.min() and b.max() <= 1
            np.testing.assert_array_equal(b, jb)

    test_ds = ImageFolder(str(tmp_path), "test", patch_size=64)
    jtest = JaxImageFolder(str(tmp_path), "test", patch_size=64)
    tb = list(test_ds.batches(batch_size=2, drop_last=False))
    assert sum(x.shape[0] for x in tb) == 3
    for b, jb in zip(tb, jtest.batches(batch_size=2, drop_last=False)):
        np.testing.assert_array_equal(b, jb)
    with pytest.raises(FileNotFoundError):
        ImageFolder(str(tmp_path / "train"), "train")


def test_small_images_are_reflect_padded(tmp_path):
    _write_pngs(str(tmp_path), 2, 1, size=(40, 50))
    ds = ImageFolder(str(tmp_path), "train", patch_size=64)
    (batch,) = list(ds.batches(2))
    assert batch.shape == (2, 64, 64, 3)


# --------------------------------------------------------------- metrics --

@pytest.mark.parametrize("size", [(192, 192), (177, 201)])
def test_metrics_match_jax(size):
    """psnr, ssim, ms_ssim on seeded images, odd sizes included (the 2x2
    pooling drops the odd row / column on both sides): rtol 1e-5."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, *size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("psnr", "ssim", "ms_ssim"):
        want = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(metrics, name)(ta, tb))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    assert metrics.msssim_db(0.99) == pytest.approx(jmetrics.msssim_db(0.99))
    like = {"y": torch.from_numpy(rng.uniform(0.01, 1, (2, 4, 4, 3)))}
    np.testing.assert_allclose(
        float(metrics.likelihood_bpp(like, 100)),
        float(jmetrics.likelihood_bpp(
            {"y": jnp.asarray(like["y"].numpy())}, 100)), rtol=1e-5)
    strings = [[b"abc", b"de"], [b"f"]]
    assert metrics.real_bpp(strings, 16) == jmetrics.real_bpp(strings, 16)


def test_ms_ssim_is_differentiable():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0, 1, (1, 176, 176, 3))
                         .astype(np.float32))
    b = (a + 0.05 * torch.randn(a.shape,
                                generator=torch.Generator().manual_seed(0))
         ).requires_grad_(True)
    metrics.ms_ssim(a, b.clamp(0, 1)).backward()
    assert bool(torch.isfinite(b.grad).all())
    assert float(b.grad.abs().max()) > 0
    with pytest.raises(RuntimeError):
        metrics.ms_ssim(a[:, :100, :100], a[:, :100, :100])


def test_average_meter_and_logger(tmp_path):
    m = metrics.AverageMeter()
    assert m.avg == 0.0
    m.update(2.0)
    m.update(4.0, n=3)
    assert m.avg == pytest.approx(3.5) and m.val == 4.0 and m.count == 4
    logger = MetricLogger(str(tmp_path), run_name="r", use_wandb=True)
    logger.log(3, {"loss": torch.tensor(1.5)})
    logger.log(4, {"bpp": 0.25}, namespace="val_real")
    logger.close()
    with open(tmp_path / "r.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert rec[0]["step"] == 3 and rec[0]["ns"] == "train"
    assert rec[0]["loss"] == 1.5
    assert rec[1]["ns"] == "val_real" and rec[1]["bpp"] == 0.25


def test_pad_and_crop_spatial_round_trip():
    x = torch.arange(2 * 5 * 7 * 3, dtype=torch.float32).reshape(2, 5, 7, 3)
    padded, padding = pad_spatial(x, 4)
    assert padded.shape == (2, 8, 8, 3) and padding == (0, 1, 1, 2)
    assert float(padded[:, 0].abs().max()) == 0.0
    assert torch.equal(crop_spatial(padded, padding), x)


# ------------------------------------------------------------------ eval --

@pytest.fixture(scope="module")
def codec():
    c = DCAECodec(CFG, device="cpu")
    c.update()
    yield c
    c.close()


def test_eval_image_modes(codec):
    x = _images(1, 128, seed=4)[:, :120, :100]    # padded to 128 x 128
    real = eval_lib.eval_image_real(codec, x)
    fwd = eval_lib.eval_image_forward(codec, x)
    inter = eval_lib.eval_image_interleaved(codec, x)
    for r in (real, fwd, inter):
        assert np.isfinite(r.psnr) and r.bpp > 0 and r.enc_time > 0
        assert np.isnan(r.msssim_db)              # under the 5-scale minimum
    # the same reconstruction, coded three ways
    assert real.psnr == pytest.approx(inter.psnr, abs=1e-4)
    assert real.psnr == pytest.approx(fwd.psnr, abs=1e-3)
    # the profile's payload counts its lane states: visible at this size
    assert real.bpp < inter.bpp < 4 * real.bpp
    assert real.dec_time > 0 and fwd.dec_time == 0.0


def test_eval_interleaved_falls_back_on_escape(codec, monkeypatch):
    from dcae_tpu_torch.entropy.rans import EscapeError

    def escape(x):
        raise EscapeError("more out-of-table symbols than the patch list")

    monkeypatch.setattr(codec, "compress_device", escape)
    x = _images(1, 128, seed=4)
    r = eval_lib.eval_image_interleaved(codec, x)
    assert r.bpp == eval_lib.eval_image_real(codec, x).bpp


def test_eval_directory(codec, tmp_path):
    _write_pngs(str(tmp_path), 3, 1, size=(128, 128))
    d = str(tmp_path / "train")
    summary = eval_lib.eval_directory(codec, d, real=True, verbose=False)
    assert summary["n_images"] == 3 and summary["bpp"] > 0
    fwd = eval_lib.eval_directory(codec, d, limit=2, verbose=False)
    assert fwd["n_images"] == 2 and fwd["dec_time"] == 0.0
    with pytest.raises(ValueError, match="real=True"):
        eval_lib.eval_directory(codec, d, profile="interleaved")


# ------------------------------------------------------------------ loop --

def test_run_training_two_epochs_and_resume(tmp_path, capsys):
    """Two epochs on the CPU write the policy's checkpoints, the train /
    val / val_real log lines and print the val_real line; a third epoch
    resumes from the latest checkpoint at the step it stopped at."""
    data = tmp_path / "data"
    _write_pngs(str(data), n_train=4, n_test=2, size=(140, 150))
    save = str(tmp_path / "ck")
    opts = TrainOptions(dataset=str(data), epochs=2, batch_size=2,
                        test_batch_size=2, patch_size=128, save_path=save,
                        val_real_every=2, val_real_images=1, log_every=1,
                        num_workers=2, lr_epochs=(1,))
    st = run_training(opts, cfg=CFG, device="cpu")
    assert st.step == 4
    assert st.main_opt.param_groups[0]["lr"] == pytest.approx(1e-5)
    out = capsys.readouterr().out
    assert "epoch 1: val_real bpp" in out and "epoch 0: val_real" not in out
    assert {"checkpoint_latest.ckpt", "checkpoint_best.ckpt",
            "train.jsonl"} <= set(os.listdir(save))
    with open(os.path.join(save, "train.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert {r["ns"] for r in rec} == {"train", "val", "val_real"}
    assert sum(r["ns"] == "train" for r in rec) == 4
    assert all(np.isfinite(r["loss"]) for r in rec if "loss" in r)

    latest = os.path.join(save, "checkpoint_latest.ckpt")
    more = run_training(dataclasses.replace(opts, epochs=3,
                                            checkpoint=latest),
                        cfg=CFG, device="cpu")
    assert more.step == 6
    # the latest checkpoint is now epoch 3's; without continue_train the
    # parameters are kept, the step count is set from the epoch and both
    # Adams start afresh
    fresh = run_training(dataclasses.replace(
        opts, epochs=4, checkpoint=latest, continue_train=False,
        save=False, val_real_every=0), cfg=CFG, device="cpu")
    assert fresh.step == 8
    assert int(fresh.main_opt.state[fresh.main_params()[0]]["step"]) == 2


def test_validate_real_reports_stream_bpp_and_psnr(tmp_path):
    _write_pngs(str(tmp_path), 1, 2, size=(128, 128))
    _, _, st = _state()
    ds = ImageFolder(str(tmp_path), "test", patch_size=128)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    vr = validate_real(CFG, st, ds, 2)
    assert set(vr) == {"bpp", "psnr"} and vr["bpp"] > 0
    assert np.isfinite(vr["psnr"])
    # the codec's cuDNN settings do not outlive the validation
    assert flags == (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)


def test_run_training_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(TrainOptions(dataset=str(tmp_path)), cfg=CFG)


def test_cli_flags(tmp_path, monkeypatch):
    """The CLI has tools/train.py's flags (--sp included) plus --device,
    and hands them to run_training."""
    from dcae_tpu_torch.tools import train as cli

    seen = {}
    monkeypatch.setattr(cli, "run_training", lambda opts, cfg, device:
                        seen.update(opts=opts, cfg=cfg, device=device))
    cli.main(["-d", str(tmp_path), "--tiny", "--device", "cpu", "--epochs",
              "3", "--lr_epoch", "1", "2", "--finetune_encoder", "--type",
              "ms-ssim", "--no-aux_scheduler", "--precision_reg", "0.001",
              "--sp", "2"])
    o = seen["opts"]
    assert seen["device"] == "cpu" and seen["cfg"].N == 16
    assert (o.epochs, o.lr_epochs, o.freeze_except, o.loss_type) == (
        3, (1, 2), ("g_a", "h_a"), "ms-ssim")
    assert o.aux_scheduler is False and o.precision_reg == 0.001
    assert o.sp == 2 and cli.parse_args(["-d", "x"]).sp == 1


@pytest.mark.slow
def test_tiny_training_converges(tmp_path):
    """A few epochs of the tiny config on synthetic compressible images
    reduce the RD loss and bpp and move aux, and the val_real hook logs
    true entropy-coded metrics: tests/test_train_convergence.py for the
    port, on the same images and options."""
    from dcae_tpu_torch.data.synthetic import make_dataset

    data, save = str(tmp_path / "data"), str(tmp_path / "run")
    make_dataset(data, n_train=48, n_test=8, size=128)
    opts = TrainOptions(
        dataset=data, epochs=3, batch_size=8, test_batch_size=8,
        patch_size=64, lmbda=0.013, learning_rate=1e-4, lr_epochs=(3,),
        save_path=save, save=False, log_every=1, val_real_every=3,
        val_real_images=2, num_workers=2)
    run_training(opts, cfg=DCAEConfig.tiny(), device="cpu")
    with open(os.path.join(save, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["ns"] == "train" and "bpp_loss" in r]
    assert len(train) >= 10
    k = max(1, len(train) // 5)
    avg = lambda rows, key: float(np.mean([r[key] for r in rows]))  # noqa
    assert avg(train[-k:], "loss") < avg(train[:k], "loss")
    assert avg(train[-k:], "bpp_loss") < avg(train[:k], "bpp_loss")
    assert avg(train[-k:], "aux_loss") < avg(train[:k], "aux_loss")
    vr = [r for r in recs if r["ns"] == "val_real"]
    assert vr and np.isfinite(vr[-1]["bpp"]) and vr[-1]["bpp"] > 0
