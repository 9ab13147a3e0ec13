"""Data-parallel deployment of the PyTorch port on the CPU: two processes
over gloo (tests/torch_dp_worker.py) against one process on the global
batch, at the tiny config.

- a dp = 2 training step (two steps, with drift noise and the precision
  penalty, so that every noise draw runs) equals the one-process step on
  the global batch of 2: parameters within 1e-6 of the largest parameter
  (_close says why not of each tensor's), metrics within 1e-6 relative;
  the two ranks hold the same parameters;
- is_primary, local_batch_to_global's shapes, the mesh's;
- tools/eval_sharded on dp = 2 against the JAX package's make_eval_step on
  the same weights and images (rtol 2e-5, the bar of
  tests/test_serving_multichip.py);
- one data-parallel run_training epoch (a leftover test batch included),
  the ranks' str hashes salted apart, against the same epoch in one
  process salted as the primary rank;
- make_mesh(sp=2) raises without a group (sp must divide the processes);
  without a process group the mesh is one device and the step is the
  plain step; dp_noise cuts the global draw.
The two ranks and the one-process run go once for the module, side by
side, in about 10 s.
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

from dcae_tpu_torch.entropy.ops import draw_noise, dp_noise
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.parallel import mesh as pmesh, multihost
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.utils.checkpoint import load_params_only, save_checkpoint
from tests.torch_dp_common import (CFG, LMBDA, TRAIN_KW, global_batch,
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


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The inputs, then both ranks and the one-process run at once:
    returns (workdir, [rank json], [rank output])."""
    work = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 3)):
        os.makedirs(os.path.join(work, "data", split))
        for i in range(n):
            _write_png(os.path.join(work, "data", split, f"{i}.png"), rng,
                       (80, 90))
    os.makedirs(os.path.join(work, "eval"))
    for i in range(4):
        _write_png(os.path.join(work, "eval", f"{i}.png"), rng, (64, 64))
    model = DCAE(CFG)
    model.reset_parameters(torch.Generator().manual_seed(3))
    save_checkpoint(os.path.join(work, "eval.ckpt"), create_train_state(
        model, make_optimizer(1e-4), torch.Generator()), 1, 2.0)

    port = _free_port()
    # (world, rank, hash salt): the ranks' salts differ, the one-process
    # run's is the primary rank's
    runs = [(2, 0, "0"), (2, 1, "1"), (1, 0, "0")]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_worker.py"),
         str(port), str(world), str(rank), work], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONHASHSEED": salt},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, rank, salt in runs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the dp workers timed out:\n" + "\n".join(outs))
    for run, p, out in zip(runs, procs, outs):
        assert p.returncode == 0, f"{run}:\n{out}"
    ranks = []
    for rank in range(2):
        with open(os.path.join(work, f"w2r{rank}.json")) as f:
            ranks.append(json.load(f))
    return work, ranks, outs[:2]


def _close(got: dict, want: dict, tol: float) -> None:
    """Every parameter within tol of the largest parameter magnitude. An
    Adam step moves a parameter by up to lr (1e-4), so a wrong gradient
    or noise row shows at ~1e-5 of that scale. Splitting the batch only
    reorders sums: gradients agree to ~1e-5 of each tensor's largest, and
    a zero-initialized bias whose gradient is near Adam's eps then moves
    up to ~1e-5 of its own (tiny) largest, ~1e-9 of the scale."""
    assert got.keys() == want.keys()
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        assert float(np.abs(a - b).max()) <= tol * scale, k


def test_dp_step_equals_one_device_step(dp_run):
    work, ranks, _ = dp_run
    model, state, step = state_and_step(**TRAIN_KW)
    batch = torch.from_numpy(global_batch())
    want_metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        want_metrics.append({k: float(v) for k, v in m.items()})
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = dict(np.load(os.path.join(work, "w2r0_step.npz")))
    _close(got, want, 1e-6)
    for g, w in zip(ranks[0]["step_metrics"], want_metrics):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k


def test_dp_ranks_hold_the_same_parameters(dp_run):
    work, ranks, _ = dp_run
    a = np.load(os.path.join(work, "w2r0_step.npz"))
    b = np.load(os.path.join(work, "w2r1_step.npz"))
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert ranks[0]["step_metrics"] == ranks[1]["step_metrics"]


def test_primary_mesh_and_local_batch(dp_run):
    _, ranks, outs = dp_run
    assert [r["primary"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["mesh"] == {"dp": 2, "sp": 1} and r["device"] == "cpu"
        assert r["local_shape"] == [1, 64, 64, 3]
        assert r["global_batch"] == 2
    # only the primary rank prints the summaries
    assert "mesh: dp=2 sp=1 over 2/2 devices" in outs[0]
    assert "mesh: dp=2" not in outs[1] and "img/s" not in outs[1]


def test_eval_sharded_matches_jax_eval_step(dp_run):
    import jax
    import jax.numpy as jnp

    from dcae_tpu.config import DCAEConfig as JaxConfig
    from dcae_tpu.models.dcae import DCAE as JaxDCAE
    from dcae_tpu.train.step import make_eval_step
    from dcae_tpu.utils.convert import convert_reference_state_dict
    from dcae_tpu_torch.data.datasets import list_images, load_image

    work, ranks, _ = dp_run
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in load_params_only(
            os.path.join(work, "eval.ckpt")).items()}, JaxConfig.tiny())
    step = jax.jit(make_eval_step(JaxDCAE(JaxConfig.tiny()), LMBDA))
    files = list_images(os.path.join(work, "eval"))
    meters = {k: [] for k in ("loss", "bpp_loss", "psnr")}
    for i in range(0, 4, 2):
        batch = jnp.asarray(np.stack([load_image(f) for f in files[i:i + 2]]))
        m = step(params, batch)
        for k in meters:
            meters[k].append(float(m[k]))
    ev = ranks[0]["eval"]
    assert ev["images"] == 4
    for k, v in meters.items():
        assert ev[k] == pytest.approx(np.mean(v), rel=2e-5), k


def test_run_training_dp_equals_one_process(dp_run):
    work, _, outs = dp_run
    latest = "checkpoint_latest.ckpt"
    got, want = ({k: v.numpy() for k, v in load_params_only(
        os.path.join(work, ck, latest)).items()} for ck in ("ck_w2", "ck_w1"))
    _close(got, want, 1e-6)

    def test_loss(ck: str) -> float:
        with open(os.path.join(work, ck, "train.jsonl")) as f:
            return [json.loads(line) for line in f
                    if '"ns": "val"' in line][-1]["loss"]

    assert test_loss("ck_w2") == pytest.approx(test_loss("ck_w1"), rel=1e-6)
    assert "epoch 0: test loss" in outs[0]
    assert "epoch 0" not in outs[1]          # the other rank logs nothing


def test_make_mesh_rejects_sp():
    """sp must divide the processes: one process without a group has sp
    = 1 only (tests/test_torch_spatial.py: the sp axis itself)."""
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.make_mesh(sp=2, device="cpu")


def test_one_process_mesh_is_the_plain_step():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"dp": 1, "sp": 1}
    assert multihost.is_primary()
    fn = object()
    assert pmesh.shard_train_step(fn, mesh) is fn
    assert pmesh.shard_eval_step(fn, mesh) is fn
    batch, n = multihost.local_batch_to_global(global_batch(), mesh)
    assert tuple(batch.shape) == (2, 64, 64, 3) and n == 2
    with pytest.raises(ValueError):
        pmesh.make_mesh(n_devices=2, device="cpu")


@pytest.mark.parametrize("normal", [False, True])
def test_dp_noise_cuts_the_global_draw(normal):
    g = torch.Generator().manual_seed(4)
    whole = draw_noise((6, 3, 2), g, torch.float32, "cpu", normal=normal)
    for rank in range(3):
        g.manual_seed(4)
        with dp_noise(rank, 3):
            part = draw_noise((2, 3, 2), g, torch.float32, "cpu",
                              normal=normal)
        assert torch.equal(part, whole[2 * rank:2 * rank + 2])
    g.manual_seed(4)        # outside dp_noise: the local shape's draw
    local = (torch.randn if normal else torch.rand)((2, 3, 2), generator=g)
    g.manual_seed(4)
    assert torch.equal(draw_noise((2, 3, 2), g, torch.float32, "cpu",
                                  normal=normal), local)
