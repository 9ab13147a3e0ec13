"""One rank of the span check of the data-parallel step
(tests/test_torch_spans.py), on the CPU over gloo:

    python tests/torch_span_worker.py <port> <world> <rank> <workdir>

It takes one step of shard_train_step at the tiny config on its rows of a
seeded global batch with a sink registered, and writes the spans that
closed, in order of their start, as [name, start, end] into
<workdir>/r<rank>.json.
"""

import json
import os
import sys

import torch


def main() -> None:
    port, world, rank, work = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dcae_tpu_torch.parallel import mesh as pmesh, multihost
    from dcae_tpu_torch.utils import profiling
    from tests.torch_dp_common import global_batch, state_and_step

    device = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  device="cpu")
    mesh = pmesh.make_mesh(device=device)
    _, state, step = state_and_step(device=device)
    step = pmesh.shard_train_step(step, mesh)
    batch = torch.from_numpy(pmesh.shard_rows(global_batch(2 * world),
                                              mesh))

    class Spans(profiling.Sink):
        def __init__(self):
            self.spans = []

        def span(self, name, start, end):
            self.spans.append((start, name, end))

    sink = Spans()
    with profiling.registered(sink):
        step(state, batch)
    with open(os.path.join(work, f"r{rank}.json"), "w") as f:
        json.dump([[n, a, b] for a, n, b in sorted(sink.spans)], f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
