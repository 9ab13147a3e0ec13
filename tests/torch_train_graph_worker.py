"""One rank of the two-card check of the graphed data-parallel step
(tests/test_torch_cuda.py):

    python tests/torch_train_graph_worker.py <port> <world> <rank> <workdir>

Every rank a card (NCCL): the tiny window-8 model in f32, TF32 off, with
drift noise, 2 rows a rank of a seeded global batch. Three
shard_train_step steps with the step's CUDA graph (the first warms up,
the second captures, the third replays; the mean all-reduce runs between
the backward and the update), then three from the same weights and noise
seed with the graph turned off (train/step_graph.py: eager_reason) and
the all-reduce in the backward's final callback, as the CPU runs it.
Writes <workdir>/r<rank>.json: both runs' per-step losses
and per-leaf gradient and change norms, and the counts of each run.
"""

import dataclasses
import json
import os
import sys
from unittest import mock

import torch


def main() -> None:
    port, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.train import step_graph as sg
    from dcae_tpu_torch.utils import profiling
    from tests.torch_dp_common import card_config, global_batch
    from tests.test_torch_cuda import _Counts, _run_steps, _train_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  device="cuda")
    mesh = pmesh.make_mesh(device=device)
    batches = [pmesh.shard_rows(torch.from_numpy(
        global_batch(2 * world, 128, seed=s)).to(device), mesh)
        for s in range(3)]
    runs, counts = [], []
    for eager in (False, True):
        model, _, state, step = _train_setup(card_config(), device)
        # a mesh that names the CPU keeps the all-reduce in the backward
        step = pmesh.shard_train_step(step, dataclasses.replace(
            mesh, device=torch.device("cpu")) if eager else mesh)
        with mock.patch.object(sg, "eager_reason",
                               (lambda *a: "forced") if eager
                               else sg.eager_reason), _Counts() as c:
            run = _run_steps(model, state, step, batches)
        runs.append({k: run[k] for k in ("loss", "grad", "change")})
        counts.append(c)
    assert not profiling.sinks
    with open(os.path.join(work, f"r{rank}.json"), "w") as f:
        json.dump({"runs": runs, "counts": counts}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
