"""One rank of the spatial-parallel checks of the PyTorch port
(tests/test_torch_spatial.py), on the CPU over gloo:

    python tests/torch_sp_worker.py <port> <world> <sp> <rank> <workdir>
        [cuda]

With world > 1 it joins the group through parallel/multihost.initialize
and makes the (world / sp, sp) mesh; with world 1 it runs in one process
without a group. Every run writes into <workdir>, tagged
w<world>s<sp>r<rank>: _step.npz (the parameters after two training steps
on its dp index's rows of the seeded global batch of 2, every noise draw
on), _grad.npz (step 1's gradients, averaged and clipped) and .json (the
metrics of both steps, the mesh, the transport). The sp = 2 run of world 2
also writes _fwd.npz (the forward of <workdir>/weights.pt on
<workdir>/x.npy: x_hat and the likelihoods) and, in its .json, that
input's shard_eval_step metrics and its one-process eval step's, the
adjoint checks of cut / gather / halo, the scalar check of the gradient
rule, the shape rules' errors, tools/eval_sharded's summary and a
tools/train epoch (checkpoints in <workdir>/ck_w<world>s<sp>). World 1
runs only that epoch, the one-process reference. The sp = 4 run of world
4 takes uneven bands instead: _fwd.npz of <workdir>/x192.npy (192 rows:
bands of 64, 64, 32 and 32 image rows) and _grad.npz of one step on a
global batch of 2 x 192x192. With "cuda" (one card a rank, NCCL) it takes
the two steps alone, on the card config and a global batch of 2 x dp rows
of 128x128.
"""

import json
import os
import sys

import numpy as np
import torch


def adjoints(mesh) -> dict:
    """<f(x), g> and <x, f^T(g)>, each summed over the sp group, for f in
    cut / gather / halo in f64 (f^T: the Function's backward); and the
    gradient rule: a scalar weight's gradients, averaged over the world,
    against its one-device gradient."""
    import torch.distributed as dist
    from dcae_tpu_torch.parallel import mesh as pmesh, spatial

    gen = torch.Generator().manual_seed(11 + mesh.rank)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64)

    rows = [4, 4]   # sp = 2
    out = {}
    for name, fn, shape in (
            ("cut", lambda x: spatial.cut(x, mesh, rows), (2, 8, 5, 3)),
            ("gather", lambda x: spatial.gather(x, mesh, rows), (2, 4, 5, 3)),
            ("halo", lambda x: spatial.halo(x, 2, 1, mesh, rows),
             (2, 4, 5, 3))):
        x = rand(*shape).requires_grad_()
        y = fn(x)
        g = rand(*y.shape)
        (y * g).sum().backward()
        sums = torch.stack([(y * g).sum(), (x * x.grad).sum()]).detach()
        dist.all_reduce(sums, group=mesh.sp_group)
        out[name] = [float(v) for v in sums]

    # every rank back-propagates the whole loss: the world's mean of the
    # gradients is the one-device gradient
    a = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    whole = torch.Generator().manual_seed(12)
    x = torch.rand((2, 8, 4, 1), generator=whole, dtype=torch.float64)
    c = torch.rand((2, 8, 4, 1), generator=whole, dtype=torch.float64)
    y = spatial.gather(a * spatial.cut(x, mesh, rows) ** 2, mesh, rows)
    (c * y).sum().backward()
    grad = a.grad.clone()
    pmesh.all_reduce_mean_([grad], mesh)
    out["rule"] = [float(grad), float((c * x ** 2).sum())]
    return out


def shape_rules(mesh, model) -> dict:
    """The messages of the errors the shape rules raise."""
    from dcae_tpu_torch.parallel import mesh as pmesh, spatial

    out = {}
    for name, fn in (
            ("make_mesh", lambda: pmesh.make_mesh(sp=3, device="cpu")),
            ("height", lambda: model(torch.zeros(1, 80, 64, 3))),
            ("halo", lambda: spatial.halo(torch.zeros(1, 2, 4, 1), 3, 3,
                                          mesh, [2, 2]))):
        try:
            with spatial.bands(mesh):
                fn()
        except ValueError as e:
            out[name] = str(e)
    return out


def forward(mesh, work: str, name: str) -> dict:
    """The forward of <work>/weights.pt on <work>/<name> in row bands:
    x_hat and the likelihoods."""
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.parallel import spatial

    model = DCAE(DCAEConfig.tiny())
    model.load_state_dict(torch.load(os.path.join(work, "weights.pt")))
    x = torch.from_numpy(np.load(os.path.join(work, name)))
    with torch.no_grad(), spatial.bands(mesh):
        r = model(x)
    return {"x_hat": r["x_hat"].numpy(), "y": r["likelihoods"]["y"].numpy(),
            "z": r["likelihoods"]["z"].numpy()}


def main() -> None:
    port, world, sp, rank, work = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), int(sys.argv[4]),
                                   sys.argv[5])
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dcae_tpu_torch.config import DCAEConfig
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.tools import eval_sharded, train as train_cli
    from dcae_tpu_torch.train.step import make_eval_step
    from tests.torch_dp_common import (CFG, TRAIN_KW, card_config,
                                       global_batch, state_and_step)

    card = sys.argv[6:] == ["cuda"]
    if card:
        # full-f32 products and deterministic cuDNN, as the trainer runs
        # them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    device = torch.device("cpu")
    if world > 1:
        device = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                                      num_processes=world, process_id=rank,
                                      device="cuda" if card else "cpu")
    mesh = pmesh.make_mesh(sp=sp, device=device)
    tag = f"w{world}s{sp}r{rank}"
    out = {"rank": rank, "mesh": mesh.shape, "dp_rank": mesh.dp_rank,
           "sp_rank": mesh.sp_rank, "primary": multihost.is_primary(),
           "transport": None if mesh.transport is None
           else mesh.transport.name}

    def train_epoch() -> None:
        train_cli.main([
            "-d", os.path.join(work, "data"), "--epochs", "1",
            "--batch-size", "2", "--test-batch-size", "2",
            "--patch-size", "64", "--save", "--save_path",
            os.path.join(work, f"ck_w{world}s{sp}"), "--num-workers", "1",
            "--seed", "7", "--lmbda", "0.0483", "--val_real_every", "0",
            "--tiny", "--device", "cpu", "--sp", str(sp)])

    if world == 1:
        train_epoch()
        return

    if sp == 4:
        np.savez(os.path.join(work, f"{tag}_fwd.npz"),
                 **forward(mesh, work, "x192.npy"))
        model, state, step = state_and_step(CFG, device, **TRAIN_KW)
        pmesh.shard_train_step(step, mesh)(
            state, torch.from_numpy(global_batch(2, 192)))
        np.savez(os.path.join(work, f"{tag}_grad.npz"),
                 **{k: p.grad.numpy() for k, p in model.named_parameters()})
        with open(os.path.join(work, f"{tag}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.destroy_process_group()
        return

    batch = global_batch(2 * mesh.dp, 128) if card else global_batch()
    local = torch.from_numpy(pmesh.shard_rows(batch, mesh)).to(device)
    model, state, step = state_and_step(
        card_config() if card else CFG, device, **TRAIN_KW)
    step = pmesh.shard_train_step(step, mesh)
    metrics = []
    for i in range(2):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            np.savez(os.path.join(work, f"{tag}_grad.npz"),
                     **{k: p.grad.detach().cpu().numpy()
                        for k, p in model.named_parameters()})
    out["step_metrics"] = metrics
    np.savez(os.path.join(work, f"{tag}_step.npz"),
             **{k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()})

    if not card and world == 2:
        np.savez(os.path.join(work, f"{tag}_fwd.npz"),
                 **forward(mesh, work, "x.npy"))
        fwd = DCAE(DCAEConfig.tiny())
        fwd.load_state_dict(torch.load(os.path.join(work, "weights.pt")))
        x = torch.from_numpy(np.load(os.path.join(work, "x.npy")))
        out["adjoints"] = adjoints(mesh)
        out["rules"] = shape_rules(mesh, fwd)
        # shard_eval_step (row split) and the eval step in one process
        ev = make_eval_step(fwd, 0.0483)
        with torch.no_grad():
            out["eval_spatial"] = [
                {k: float(v) for k, v in fn(x).items()}
                for fn in (pmesh.shard_eval_step(ev, mesh), ev)]
        out["eval"] = eval_sharded.main([
            "--data", os.path.join(work, "eval"), "--checkpoint",
            os.path.join(work, "eval.ckpt"), "--tiny", "--device", "cpu",
            "--batch-size", "2", "--lmbda", "0.0483", "--sp", str(sp)])
        train_epoch()
    with open(os.path.join(work, f"{tag}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
