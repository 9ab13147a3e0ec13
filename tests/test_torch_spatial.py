"""The spatial (sp) mesh axis of the PyTorch port on the CPU: g_a and g_s
split over image rows by gloo ranks (tests/torch_sp_worker.py), against
the JAX package's sp forward and the one-process step, at the tiny config.

- (a) the sp = 2 forward (x_hat, both likelihoods) against the JAX
  package's own sp = 2 forward on its virtual 8-device mesh (the
  partitioner's halos; tests/test_spatial_parallel.py), same weights, at
  atol 5e-6 / rtol 1e-5, and against the port's one-process forward;
  shard_eval_step with the row split equals the one-process eval step;
- (b) two training steps at sp = 2 and at dp = 2 x sp = 2 (4 ranks), with
  drift noise and the precision penalty, against the one-process steps on
  the global batch: step 1's gradients within 1e-5 of the largest
  gradient, the parameters within 1e-6 of the largest parameter, the
  metrics within 1e-6 relative; every rank alike;
- (c) cut / gather / halo are adjoint to their backwards over 2 ranks,
  and the gradient rule (the world's mean of every rank's gradient of the
  whole loss is the one-device gradient) holds on a scalar;
- (d) in one process, no group: the window kernels' plain versions, the
  plain GLU and whole Swin blocks (W and SW, windows 4 and 8) on first,
  interior and last bands with their halos, cropped, equal the rows of
  the whole;
- (e) the shape rules raise: make_mesh on an sp that does not divide the
  world, run_bands on a height that breaks the band rule, a halo taller
  than a band; and each layer's halo and the band multiple come from its
  own geometry;
- (f) tools/train.py --sp 2 (one epoch) and tools/eval_sharded.py --sp 2
  under two gloo ranks: the epoch's checkpoint against the same epoch in
  one process, the eval summary against the one-process eval step.
The ranks and the one-process epoch go once for the module, side by side,
while the JAX forward compiles.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.ops.blocks import ResScaleConvolutionGateBlock
from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu
from dcae_tpu_torch.ops.kernels.wmsa_attention import wmsa_attention_ref
from dcae_tpu_torch.ops.kernels.wmsa_block import wmsa_block_ref
from dcae_tpu_torch.parallel import mesh as pmesh, spatial
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.train.step import make_eval_step
from dcae_tpu_torch.utils.checkpoint import load_params_only, save_checkpoint
from tests.torch_dp_common import (LMBDA, TRAIN_KW, global_batch,
                                   state_and_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_png(path: str, rng, size) -> None:
    Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
        path)


def _jax_forward(params, x: np.ndarray) -> dict:
    """The JAX DCAE's forward with the batch sharded P('dp', 'sp') on the
    (4, 2) virtual mesh: x_hat and the likelihoods."""
    import jax

    from dcae_tpu.config import DCAEConfig as JaxConfig
    from dcae_tpu.models.dcae import DCAE as JaxDCAE
    from dcae_tpu.parallel.mesh import batch_sharding, make_mesh, replicated

    mesh = make_mesh(8, sp=2)
    model = JaxDCAE(JaxConfig.tiny())
    fwd = jax.jit(
        lambda p, x: model.apply({"params": p}, x, training=False),
        in_shardings=(replicated(mesh), batch_sharding(mesh)),
        out_shardings=replicated(mesh))
    out = fwd(jax.device_put(params, replicated(mesh)),
              jax.device_put(x, batch_sharding(mesh)))
    return {"x_hat": np.asarray(out["x_hat"]),
            "y": np.asarray(out["likelihoods"]["y"]),
            "z": np.asarray(out["likelihoods"]["z"])}


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """The inputs; then the ranks of sp = 2, of dp = 2 x sp = 2 and the
    one-process epoch at once, and meanwhile the JAX sp = 2 forward.
    Returns (workdir, {tag: rank json}, the JAX forward, rank 0's
    output)."""
    from dcae_tpu.config import DCAEConfig as JaxConfig
    from dcae_tpu.utils.convert import convert_reference_state_dict

    work = str(tmp_path_factory.mktemp("sp"))
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 3)):
        os.makedirs(os.path.join(work, "data", split))
        for i in range(n):
            _write_png(os.path.join(work, "data", split, f"{i}.png"), rng,
                       (80, 90))
    os.makedirs(os.path.join(work, "eval"))
    for i in range(4):
        _write_png(os.path.join(work, "eval", f"{i}.png"), rng, (64, 64))
    model = DCAE(DCAEConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(3))
    save_checkpoint(os.path.join(work, "eval.ckpt"), create_train_state(
        model, make_optimizer(1e-4), torch.Generator()), 1, 2.0)
    # the JAX test's input: 8 images of 128x64 (2 x 1 pad multiples)
    torch.save(model.state_dict(), os.path.join(work, "weights.pt"))
    x = np.random.default_rng(0).uniform(0, 1, (8, 128, 64, 3)).astype(
        np.float32)
    np.save(os.path.join(work, "x.npy"), x)

    runs = [(2, 2, 0), (2, 2, 1), (4, 2, 0), (4, 2, 1), (4, 2, 2), (4, 2, 3),
            (1, 1, 0)]
    ports = {2: _free_port(), 4: _free_port(), 1: 0}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_sp_worker.py"),
         str(ports[world]), str(world), str(sp), str(rank), work], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONHASHSEED": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, sp, rank in runs]
    try:
        params = convert_reference_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()},
            JaxConfig.tiny())
        jax_out = _jax_forward(params, x)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the sp workers timed out:\n" + "\n".join(
            p.communicate()[0] for p in procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for run, p, out in zip(runs, procs, outs):
        assert p.returncode == 0, f"{run}:\n{out}"
    ranks = {}
    for world, sp, rank in runs[:-1]:
        tag = f"w{world}s{sp}r{rank}"
        with open(os.path.join(work, f"{tag}.json")) as f:
            ranks[tag] = json.load(f)
    return work, ranks, jax_out, outs[0]


# ------------------------------------------------------------- (a) --

def test_sp_forward_matches_jax_sp_forward(sp_run):
    work, _, want, _ = sp_run
    got = [np.load(os.path.join(work, f"w2s2r{r}_fwd.npz")) for r in (0, 1)]
    for k in ("x_hat", "y", "z"):
        np.testing.assert_allclose(got[0][k], want[k], atol=5e-6, rtol=1e-5,
                                   err_msg=k)
        assert np.array_equal(got[0][k], got[1][k]), k


def test_shard_eval_step_with_and_without_the_row_split(sp_run):
    banded, whole = sp_run[1]["w2s2r0"]["eval_spatial"]
    assert banded.keys() == whole.keys()
    for k in whole:
        assert banded[k] == pytest.approx(whole[k], rel=1e-6), k


def test_sp_forward_matches_one_process(sp_run):
    work = sp_run[0]
    got = np.load(os.path.join(work, "w2s2r0_fwd.npz"))
    model = DCAE(DCAEConfig.tiny())
    model.load_state_dict(torch.load(os.path.join(work, "weights.pt")))
    with torch.no_grad():
        want = model(torch.from_numpy(np.load(os.path.join(work, "x.npy"))))
    for k, v in (("x_hat", want["x_hat"]), ("y", want["likelihoods"]["y"]),
                 ("z", want["likelihoods"]["z"])):
        np.testing.assert_allclose(got[k], v.numpy(), atol=5e-6, rtol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------- (b) --

@pytest.fixture(scope="module")
def one_process_steps():
    """Two one-process steps on the global batch of 2: (step 1's
    gradients, the parameters after step 2, the metrics of both)."""
    model, state, step = state_and_step(**TRAIN_KW)
    batch = torch.from_numpy(global_batch())
    metrics, grads = [], None
    for i in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}
    params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return grads, params, metrics


def _within(got: dict, want: dict, tol: float) -> None:
    """Every tensor within tol of the largest magnitude of all of want."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        diff = np.abs(np.asarray(got[k], np.float64) - want[k]).max()
        assert diff <= tol * scale, (k, diff / scale)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_step_equals_one_process_step(sp_run, one_process_steps, world):
    work, ranks, _, _ = sp_run
    grads, params, metrics = one_process_steps
    tag = f"w{world}s2"
    assert ranks[f"{tag}r0"]["mesh"] == {"dp": world // 2, "sp": 2}
    _within(dict(np.load(os.path.join(work, f"{tag}r0_grad.npz"))), grads,
            1e-5)
    _within(dict(np.load(os.path.join(work, f"{tag}r0_step.npz"))), params,
            1e-6)
    for g, w in zip(ranks[f"{tag}r0"]["step_metrics"], metrics):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("world", [2, 4])
def test_sp_ranks_alike(sp_run, world):
    work, ranks, _, _ = sp_run
    tag = f"w{world}s2"
    first = np.load(os.path.join(work, f"{tag}r0_step.npz"))
    for r in range(1, world):
        other = np.load(os.path.join(work, f"{tag}r{r}_step.npz"))
        assert all(np.array_equal(first[k], other[k]) for k in first.files)
        assert ranks[f"{tag}r{r}"]["step_metrics"] == \
            ranks[f"{tag}r0"]["step_metrics"]
    places = [(ranks[f"{tag}r{r}"]["dp_rank"], ranks[f"{tag}r{r}"]["sp_rank"])
              for r in range(world)]
    assert places == [(r // 2, r % 2) for r in range(world)]
    assert ranks[f"{tag}r0"]["transport"] == "gloo"
    assert [ranks[f"{tag}r{r}"]["primary"] for r in range(world)] == \
        [True] + [False] * (world - 1)


# ------------------------------------------------------------- (c) --

@pytest.mark.parametrize("fn", ["cut", "gather", "halo"])
def test_functions_adjoint_to_their_backwards(sp_run, fn):
    lhs, rhs = sp_run[1]["w2s2r0"]["adjoints"][fn]
    assert lhs == pytest.approx(rhs, rel=1e-12)
    assert sp_run[1]["w2s2r1"]["adjoints"][fn] == [lhs, rhs]


def test_gradient_rule_on_a_scalar(sp_run):
    got, want = sp_run[1]["w2s2r0"]["adjoints"]["rule"]
    assert got == pytest.approx(want, rel=1e-12)


# ------------------------------------------------------------- (d) --

def _bands(H: int, n: int, halo: int):
    """(start, stop, first own row) of each band of n rows with its halo:
    the first, the interior ones, the last."""
    for r0 in range(0, H, n):
        top = halo if r0 else 0
        yield r0 - top, min(H, r0 + n + halo), top


def _check_bands(fn, x: torch.Tensor, n: int, halo: int) -> None:
    want = fn(x)
    scale = float(want.abs().max())
    for start, stop, top in _bands(x.shape[1], n, halo):
        got = fn(x[:, start:stop])[:, top:top + n]
        r0 = start + top
        diff = float((got - want[:, r0:r0 + n]).abs().max())
        assert diff <= 1e-6 * scale, (r0, diff / scale)


def _weights(gen, C: int, heads: int, w: int):
    r = lambda *s: torch.rand(s, generator=gen) * 0.4 - 0.2  # noqa: E731
    return dict(wqkv=r(3 * C, C), bqkv=r(3 * C), wproj=r(C, C), bproj=r(C),
                rel=r(heads, 2 * w - 1, 2 * w - 1))


@pytest.mark.parametrize("kernel,shifted", [
    ("wmsa_block", False), ("wmsa_block", True),
    ("wmsa_attention", False), ("wmsa_attention", True), ("conv_glu", False)])
def test_kernels_on_haloed_bands(kernel, shifted):
    """Three bands of 16 rows, each with one 8-row window of halo a side
    that has a neighbour, as run_bands gives the Swin block's kernels."""
    gen = torch.Generator().manual_seed(5)
    C, heads = 32, 4
    x = torch.rand((2, 48, 24, C), generator=gen) * 2 - 1
    w = _weights(gen, C, heads, 8)
    ln_w, ln_b = torch.rand(C, generator=gen) + 0.5, torch.rand(
        C, generator=gen) - 0.5
    if kernel == "wmsa_block":
        rs = torch.rand(C, generator=gen) + 0.5
        fn = lambda t: wmsa_block_ref(  # noqa: E731
            t, ln_w, ln_b, rs, *w.values(), heads=heads, shifted=shifted)
    elif kernel == "wmsa_attention":
        fn = lambda t: wmsa_attention_ref(  # noqa: E731
            t, *w.values(), heads=heads, shifted=shifted)
    else:
        h = 64
        r = lambda *s: torch.rand(s, generator=gen) * 0.4 - 0.2  # noqa
        glu = (ln_w, ln_b, r(2 * h, C), r(2 * h), r(h, 1, 3, 3), r(h),
               r(C, h), r(C))
        fn = lambda t: conv_glu(t, *glu, apply_ln=True)  # noqa: E731
    _check_bands(fn, x, 16, 8)


@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_blocks_on_haloed_bands(window, shifted):
    gen = torch.Generator().manual_seed(6)
    block = ResScaleConvolutionGateBlock(32, 8, window, shifted=shifted)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * 0.4 - 0.2)
        x = torch.rand((2, 6 * window, 3 * window, 32), generator=gen)
        _check_bands(block, x, 2 * window, window)


# ------------------------------------------------------------- (e) --

def test_shape_rules_raise(sp_run):
    rules = sp_run[1]["w2s2r0"]["rules"]
    assert "does not divide" in rules["make_mesh"]
    assert "multiple of 32 * sp = 64" in rules["height"]
    assert "exceeds a neighbour's band" in rules["halo"]
    with pytest.raises(ValueError, match="no sp axis"):
        with spatial.bands(pmesh.make_mesh(device="cpu")):
            pass


@pytest.mark.parametrize("name,want", [
    ("g_a.0", (8, 7)), ("g_a.1.conv", (1, 1)), ("g_a.6", (2, 1)),
    ("g_s.0", (1, 1)), ("g_s.2", (4, 4)), ("g_s.2.res1", (1, 1)),
    ("g_s.2.res1.conv1", (0, 0))])
def test_halo_from_layer_geometry(name, want):
    """Rows beyond a band that each part needs: k5 s2 convolutions 2 above
    (aligned to the stride) and 1 below, 3 bottlenecks of 3x3 convs one
    row each (x2 before a stride-2 conv), the k5 s2 deconvolution 1 a
    side."""
    model = DCAE(DCAEConfig.tiny())
    assert spatial.reach(model.get_submodule(name)) == want


@pytest.mark.parametrize("cfg,g_a,g_s", [
    (DCAEConfig.tiny(), 32, 2), (DCAEConfig(), 64, 4)])
def test_band_multiple(cfg, g_a, g_s):
    """g_a's bands: a multiple of 8 * window rows; g_s's: of window / 2
    latent rows, the same image rows."""
    model = DCAE(cfg)
    assert spatial.row_multiple(model.g_a) == g_a == 8 * cfg.window_size
    assert spatial.row_multiple(model.g_s) == g_s


# ------------------------------------------------------------- (f) --

def test_eval_sharded_sp2_matches_one_process(sp_run):
    from dcae_tpu_torch.data.datasets import list_images, load_image

    work, ranks, _, out = sp_run
    model = DCAE(DCAEConfig.tiny())
    model.load_state_dict(load_params_only(os.path.join(work, "eval.ckpt")))
    step = make_eval_step(model.eval(), LMBDA)
    files = list_images(os.path.join(work, "eval"))
    meters = {k: [] for k in ("loss", "bpp_loss", "psnr")}
    for i in range(0, 4, 2):
        m = step(torch.from_numpy(np.stack(
            [load_image(f) for f in files[i:i + 2]])))
        for k in meters:
            meters[k].append(float(m[k]))
    ev = ranks["w2s2r0"]["eval"]
    assert ev["images"] == 4
    for k, v in meters.items():
        assert ev[k] == pytest.approx(np.mean(v), rel=1e-6), k
    assert "mesh: dp=1 sp=2 over 2/2 devices" in out


def test_train_cli_sp2_epoch_equals_one_process(sp_run):
    work, _, _, out = sp_run
    latest = "checkpoint_latest.ckpt"
    got, want = ({k: v.numpy() for k, v in load_params_only(
        os.path.join(work, ck, latest)).items()}
        for ck in ("ck_w2s2", "ck_w1s1"))
    _within(got, want, 1e-6)
    assert "dp 1 sp 2" in out and "epoch 0: test loss" in out
