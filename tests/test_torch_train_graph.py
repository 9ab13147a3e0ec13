"""The training step's CUDA-graph plumbing (train/step_graph.py) on the
CPU, the tiny DCAE with drift noise and the precision penalty on, so that
every training-noise draw runs:

- the CPU step runs eagerly, captures and counts nothing, and equals the
  step written out by hand (zero, forward, backward, update) bitwise;
- eager_reason names grad mode off, eval mode and row bands (sp > 1)
  before the device, so each is seen on the CPU;
- the key follows the batch's shape, strides and dtype, the dp shard of
  the noise, the matmul / cuDNN flags and the generator; the weights'
  fingerprint follows a storage change, `load_state_dict(assign=True)`
  and freezing, not an in-place update;
- the metrics a step returns are not overwritten by the next;
- after_backward runs between the backward and the update, and
  shard_train_step hands the dp all-reduce to it on a card with sp == 1.

The capture and the replay themselves run on the card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from dcae_tpu_torch.entropy.ops import dp_noise
from dcae_tpu_torch.parallel import mesh as pmesh
from dcae_tpu_torch.parallel import spatial
from dcae_tpu_torch.train import step_graph as sg
from dcae_tpu_torch.train.state import apply_updates
from dcae_tpu_torch.train.step import make_loss_fn
from dcae_tpu_torch.utils import profiling
from tests.torch_dp_common import (CFG, LMBDA, TRAIN_KW, _seeded,
                                   global_batch, state_and_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops beside other test processes: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Records(profiling.Sink):
    def __init__(self):
        self.counts, self.spans = {}, []

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0) + n

    def span(self, name, start, end):
        self.spans.append(name)


def _batch() -> torch.Tensor:
    return torch.from_numpy(global_batch(2, 64))


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_cpu_step_is_the_eager_step_and_captures_nothing():
    model, state, step = state_and_step(CFG, "cpu", **TRAIN_KW)
    ref, tx, ref_state = _seeded(CFG, "cpu")
    loss_fn = make_loss_fn(ref, LMBDA, "mse", **TRAIN_KW)
    batch = _batch()
    with profiling.registered(_Records()) as rec:
        for _ in range(3):
            _, got = step(state, batch)
            for p in ref.parameters():
                p.grad = None
            loss, want = loss_fn(batch, ref_state.generator)
            loss.backward()
            apply_updates(ref_state, tx)
            assert got.keys() == want.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), k
    assert not any(n.startswith("train.graph") for n in rec.counts)
    assert "train.graph" not in rec.spans
    assert rec.spans.count("train.forward") == 3
    assert state.step == ref_state.step == 3
    want_p = _params(ref)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, dict(ref.named_parameters())[n].grad), n
        assert torch.equal(p.detach(), want_p[n]), n


def test_step_graphs_run_eagerly_on_the_cpu():
    model, _, _ = _seeded(CFG, "cpu")
    calls = []

    def fn(batch, generator):
        calls.append(batch)
        return {"loss": batch.sum()}

    graphs = sg.StepGraphs(model, fn)
    gen = torch.Generator()
    with profiling.registered(_Records()) as rec:
        for _ in range(3):
            graphs.run(_batch(), gen)
    assert len(calls) == 3 and not graphs.graphs and not graphs._warm
    assert rec.counts == {}


def _fake_mesh(sp: int, device: str) -> pmesh.Mesh:
    return pmesh.Mesh(dp=2, sp=sp, dp_rank=0, sp_rank=0, group=object(),
                      dp_group=object(), sp_group=object() if sp > 1
                      else None, device=torch.device(device), transport=None)


@pytest.mark.parametrize("case", ["grad_off", "eval", "bands", "cpu"])
def test_eager_reason(case):
    model, _, _ = _seeded(CFG, "cpu")
    batch = _batch()
    want = {"grad_off": "grad mode is off",
            "eval": "the model is in eval mode",
            "bands": "g_a and g_s run on row bands, exchanging halo rows",
            "cpu": "the batch is not on a card"}[case]
    if case == "grad_off":
        with torch.no_grad():
            got = sg.eager_reason(model, batch)
    elif case == "eval":
        got = sg.eager_reason(model.eval(), batch)
    elif case == "bands":
        with spatial.bands(_fake_mesh(2, "cuda")):
            got = sg.eager_reason(model, batch)
    else:
        got = sg.eager_reason(model, batch)
    assert got == want


@pytest.mark.parametrize("change", ["shape", "strides", "dtype", "shard",
                                    "matmul_tf32", "cudnn_tf32",
                                    "generator"])
def test_key_follows_what_a_step_captures(change):
    batch, gen = _batch(), torch.Generator()
    k0 = sg.key(batch, gen)
    assert sg.key(batch.clone(), gen) == k0
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        if change == "shape":
            k1 = sg.key(batch[:1], gen)
        elif change == "strides":
            k1 = sg.key(batch.transpose(1, 2), gen)
        elif change == "dtype":
            k1 = sg.key(batch.double(), gen)
        elif change == "shard":
            with dp_noise(1, 2):
                k1 = sg.key(batch, gen)
            with dp_noise(0, 2):
                assert sg.key(batch, gen) != k1
        elif change == "matmul_tf32":
            torch.backends.cuda.matmul.allow_tf32 = not flags[0]
            k1 = sg.key(batch, gen)
        elif change == "cudnn_tf32":
            torch.backends.cudnn.allow_tf32 = not flags[1]
            k1 = sg.key(batch, gen)
        else:
            k1 = sg.key(batch, torch.Generator())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert k1 != k0


@pytest.mark.parametrize("change", ["storage", "assign", "freeze",
                                    "in_place"])
def test_weights_fingerprint(change):
    model, _, _ = _seeded(CFG, "cpu")
    slots = sg.weight_slots(model)
    before = sg.weights(slots)
    assert len(before) == len(list(model.parameters())) + len(
        list(model.buffers()))
    p = next(model.parameters())
    if change == "storage":
        p.data = p.data.clone()
    elif change == "assign":
        model.load_state_dict({k: v.clone() for k, v in
                               model.state_dict().items()}, assign=True)
    elif change == "freeze":
        p.requires_grad_(False)
    else:
        with torch.no_grad():
            p.add_(1.0)
            model.load_state_dict(model.state_dict())
    assert (sg.weights(slots) == before) == (change == "in_place")


def test_metrics_outlive_the_next_step():
    _, state, step = state_and_step(CFG, "cpu", **TRAIN_KW)
    _, first = step(state, _batch())
    kept = {k: v.clone() for k, v in first.items()}
    _, second = step(state, torch.flip(_batch(), [1]))
    for k in first:
        assert torch.equal(first[k], kept[k]), k
        assert first[k].data_ptr() != second[k].data_ptr(), k
    assert not torch.equal(first["loss"], second["loss"])


def test_after_backward_runs_between_the_backward_and_the_update():
    model, state, step = state_and_step(CFG, "cpu", **TRAIN_KW)
    seen = []

    def fn():
        seen.append((all(p.grad is not None for p in model.parameters()),
                     all(torch.equal(p, before[n])
                         for n, p in model.named_parameters())))

    with sg.after_backward(fn):
        with sg.after_backward(lambda: seen.append("inner")):
            step(state, _batch())
        before = _params(model)
        step(state, _batch())
    step(state, _batch())
    # the gradients exist and the parameters are not yet updated
    assert seen == ["inner", (True, True)]
    assert not all(torch.equal(p, before[n])
                   for n, p in model.named_parameters())
    assert getattr(sg._after, "fn", None) is None


@pytest.mark.parametrize("device,sp,hand_off", [("cuda", 1, True),
                                                ("cpu", 1, False),
                                                ("cuda", 2, False)])
def test_dp_all_reduce_leaves_the_backward_on_a_card_with_sp_1(
        device, sp, hand_off):
    """The hooks that queue the reduction as the backward's final callback
    are registered where the step may not be replayed; elsewhere the
    reduction goes to after_backward. No collective runs here: the
    context is entered and left."""
    model, _, _ = _seeded(CFG, "cpu")
    with pmesh._gradients_averaged(model, _fake_mesh(sp, device)):
        handed = getattr(sg._after, "fn", None) is not None
        hooked = [bool(p._post_accumulate_grad_hooks)
                  for p in model.parameters()]
    assert handed == hand_off
    assert all(hooked) == (not hand_off) and any(hooked) == all(hooked)
    assert not any(p._post_accumulate_grad_hooks
                   for p in model.parameters())
