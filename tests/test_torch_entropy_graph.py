"""The CUDA-graph plumbing of the entropy pass (models/entropy_graph.py) on
the CPU, tiny DCAE and TCM configurations with seeded weights:

- the static buffers a replay reads (the stream words padded to
  compress_device's bound, the patch list to its power-of-two bucket,
  stale contents overwritten) leave decode_device_streams' four outputs
  bitwise as they were, encoder and decoder, chained or not;
- requests that differ only in stream length, or in patch count within a
  bucket, share a key; other shapes, buckets and directions do not;
- the CPU captures nothing and counts nothing;
- the weights' fingerprint follows a storage or version change outside
  the one-sided transforms.

The capture and the replay themselves run on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from dcae_tpu_torch.config import DCAEConfig, TCMConfig
from dcae_tpu_torch.models import entropy_graph as eg
from dcae_tpu_torch.models.codec import DCAECodec
from dcae_tpu_torch.utils import profiling

# configuration and image side: TCM's windows need 256 px
CONFIGS = {"dcae": (DCAEConfig.tiny(window_size=8, hyper_window_size=4), 128),
           "tcm": (TCMConfig.tiny(), 256)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops beside other test processes: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def coded(request):
    """(codec, images): seeded weights, a patch list as long as a slice."""
    cfg, side = CONFIGS[request.param]
    codec = DCAECodec(cfg, device="cpu", patch_cap=1 << 20)
    codec.update()
    x = (np.random.default_rng(3).uniform(0, 1, (1, side, side, 3))
         * 255).astype(np.uint8)
    yield codec, x
    codec.close()


def _with_patches(a: dict, n: int, syms=None) -> dict:
    """a with n more patches in slice 0, each the symbol `syms` (the
    decoder's) holds there, so that the streams still check out, or any
    value without it."""
    S = a["patch_pos"].shape[0]
    pos = torch.full((S, n), -1, dtype=torch.int32)
    pos[0] = torch.arange(n, dtype=torch.int32) * 3 + 1
    val = torch.zeros((S, n), dtype=torch.int32)
    val[0] = (torch.arange(n, dtype=torch.int32) - 2 if syms is None
              else syms[0].reshape(-1)[pos[0].long()])
    return {**a, "patch_pos": torch.cat([a["patch_pos"], pos], 1),
            "patch_val": torch.cat([a["patch_val"], val], 1)}


@torch.no_grad()
def _args(codec, x, override: bool, chained: bool) -> dict:
    """decode_device_streams' arguments as the codec passes them: the
    certified encoder's replay, or the decoder of compress_device's
    streams."""
    common = dict(scale_table=codec._scale_table, chained=chained)
    if override:
        y, _, z_hat = codec.model.encode_analysis(codec._input(x))
        return dict(z_hat=z_hat, words=None, n_words=None, states=None,
                    patch_pos=None, patch_val=None, override=True, true_y=y,
                    lut_sym=None, lut_sf=None, **common)
    enc = codec.compress_device(x, chain=chained)
    words, n_words, states, ppos, pval, luts, chained, z_hat = \
        codec._interleaved_inputs(enc)
    return dict(z_hat=z_hat, words=words, n_words=n_words, states=states,
                patch_pos=ppos, patch_val=pval, override=False, true_y=None,
                lut_sym=luts[0], lut_sf=luts[1], **common)


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("override", [False, True])
def test_static_buffers_leave_the_pass_bitwise_unchanged(coded, override,
                                                         chained):
    codec, x = coded
    model = codec.model
    a = _args(codec, x, override, chained)
    with torch.no_grad():
        if not override:
            a = _with_patches(a, 3, model._entropy_pass(**a)[3])
        want = model._entropy_pass(**a)
        bufs = eg.static_inputs(model.cfg, a)
        for b in bufs.values():                 # a replay finds stale data
            b.fill_(3)
        got = model._entropy_pass(**eg.fill(bufs, a))
    assert bool(want[1])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if not override:
        P = a["patch_pos"].shape[1]
        assert bufs["words"].shape[1] == eg.words_width(
            model.cfg, a["z_hat"]) > a["words"].shape[1]
        assert bufs["patch_pos"].shape[1] == eg.patch_bucket(P) > P


def test_keys_hold_shapes_and_buckets_not_stream_lengths(coded):
    codec, x = coded
    cfg = codec.model.cfg
    a = _args(codec, x, False, True)
    P = a["patch_pos"].shape[1]
    longer = {**a, "words": torch.cat(
        [a["words"], torch.zeros((a["words"].shape[0], 5),
                                 dtype=a["words"].dtype)], 1)}
    assert eg.key(cfg, longer) == eg.key(cfg, a)
    # P + n patches share P + 3's key exactly where they share its bucket
    for n in (1, 2, 3):
        same = eg.patch_bucket(P + n) == eg.patch_bucket(P + 3)
        assert (eg.key(cfg, _with_patches(a, n))
                == eg.key(cfg, _with_patches(a, 3))) == same
    assert eg.patch_bucket(0) == 0 and eg.patch_bucket(5) == 8
    assert [eg.patch_bucket(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    flipped = np.ascontiguousarray(x[:, ::-1])
    two = _args(codec, np.concatenate([x, flipped]), False, True)
    assert eg.key(cfg, two) != eg.key(cfg, a)
    assert eg.key(cfg, _args(codec, x, False, False)) != eg.key(cfg, a)
    enc = _args(codec, x, True, True)
    assert eg.key(cfg, enc) != eg.key(cfg, a)
    assert eg.key(cfg, _args(codec, flipped, True, True)) == eg.key(cfg, enc)
    assert eg.key(cfg, {**enc, "scale_table": enc["scale_table"].clone()}) \
        != eg.key(cfg, enc)


class _Counts(profiling.Sink):
    def __init__(self):
        self.counts = {}

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0) + n


def test_the_cpu_captures_nothing(coded):
    codec, x = coded
    sink = _Counts()
    with profiling.registered(sink):
        enc = codec.compress_device(x)
        dec = codec.decompress_interleaved(enc)
    assert bool(dec["ok"])
    assert [n for n in sink.counts if n.startswith("codec.entropy.")] == []
    assert "_entropy_graphs" not in codec.model.__dict__
    with torch.no_grad():
        assert not eg.engages(codec.model.cfg, _args(codec, x, True, True))


def test_weights_follow_storage_and_version(coded):
    codec, x = coded
    model = codec.model
    slots = eg.weight_slots(model)
    before = eg.weights(slots)
    with torch.no_grad():
        model._entropy_pass(**_args(codec, x, True, True))
    assert eg.weights(slots) == before
    p = model.lrp_transforms[0][0].weight
    with torch.no_grad():
        p.add_(0.0)                                     # a new version
    bumped = eg.weights(slots)
    assert bumped != before
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    assert eg.weights(slots) not in (before, bumped)
    # the one-sided transforms are not read
    assigned = eg.weights(slots)
    model.g_s.to(torch.float64)
    assert eg.weights(slots) == assigned
    model.g_s.to(torch.float32)
