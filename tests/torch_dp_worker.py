"""One rank of the data-parallel checks of the PyTorch port
(tests/test_torch_parallel.py), on the CPU over gloo:

    python tests/torch_dp_worker.py <port> <world> <rank> <workdir> [cuda]

With world > 1 it joins the group through parallel/multihost.initialize;
with world 1 it runs the same work in one process without a group. It
writes into <workdir>: w<world>r<rank>_step.npz (the parameters after two
steps on its rows of a seeded global batch of 2) and _grad.npz (the
gradients of the first), w<world>r<rank>.json
(its metrics, is_primary, local_batch_to_global's shapes,
tools/eval_sharded's summary), and, from one run_training epoch, the
primary rank's checkpoints into <workdir>/ck_w<world>. With "cuda" (one
card a rank, NCCL) it takes the two steps alone, on the card config and a
global batch of 2 x world rows of 128x128.
"""

import json
import os
import sys

import numpy as np
import torch


def main() -> None:
    port, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.tools import eval_sharded
    from dcae_tpu_torch.train.loop import run_training
    from tests.torch_dp_common import (CFG, TRAIN_KW, card_config,
                                       global_batch, state_and_step,
                                       train_options)

    card = sys.argv[5:] == ["cuda"]
    if card:
        # full-f32 products, as the trainer runs them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu")
    if world > 1:
        device = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                                      num_processes=world, process_id=rank,
                                      device="cuda" if card else "cpu")
    mesh = pmesh.make_mesh(device=device)
    tag = f"w{world}r{rank}"
    out = {"rank": rank, "primary": multihost.is_primary(),
           "mesh": mesh.shape, "device": str(device)}

    batch = global_batch(2 * world, 128) if card else global_batch()
    local, n_global = multihost.local_batch_to_global(
        pmesh.shard_rows(batch, mesh), mesh)
    out["local_shape"] = list(local.shape)
    out["global_batch"] = n_global

    model, state, step = state_and_step(
        card_config() if card else CFG, device, **TRAIN_KW)
    step = pmesh.shard_train_step(step, mesh)
    metrics = []
    for i in range(2):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:       # step 1's gradients: averaged over dp, clipped
            np.savez(os.path.join(work, f"{tag}_grad.npz"),
                     **{k: p.grad.detach().cpu().numpy()
                        for k, p in model.named_parameters()})
    out["step_metrics"] = metrics
    np.savez(os.path.join(work, f"{tag}_step.npz"),
             **{k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()})
    if card:
        with open(os.path.join(work, f"{tag}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.destroy_process_group()
        return

    out["eval"] = eval_sharded.main([
        "--data", os.path.join(work, "eval"), "--checkpoint",
        os.path.join(work, "eval.ckpt"), "--tiny", "--device", "cpu",
        "--batch-size", "2", "--lmbda", "0.0483"])

    run_training(train_options(work, f"ck_w{world}"), cfg=CFG,
                 device="cpu")
    with open(os.path.join(work, f"{tag}.json"), "w") as f:
        json.dump(out, f)
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
