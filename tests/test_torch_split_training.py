"""The port's split training step against the JAX package on the CPU: the
tiny window-8 DCAE, f32, the same weights (a seeded port init carried into
Flax params by the JAX package's converter), the same batch and the same
training noise (both packages' noise_quantize patched to add one fixed
array a shape; drift off), as in tests/test_torch_train_step.py.

  * split_halves partitions the state dict as the JAX function partitions
    the Flax tree;
  * the gradients the split step applies (read with plain SGD at rate 1,
    clipping off) equal jax.grad of the JAX package's composed two-half
    loss at the JAX split test's bars: rtol 2e-4, atol 2e-6 elementwise;
  * one real step (per-half Adam and per-half clipping) equals the JAX
    split step's per-half optax update of that gradient: the loss at 1e-5
    relative, the parameters within 2.1 learning rates everywhere and 0.05
    of one for 99% (Adam's first step moves a weight by about one rate,
    and by its gradient's sign: where a gradient is rounding noise the two
    sides may step apart; the bars of chip_smoke.py's tiny card step);
  * each half is clipped by its own global norm;
  * on one device the split step's forward and gradients are the joint
    step's (one generator, drawn in the joint forward's order).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import dcae_tpu.entropy.ops as jops
import dcae_tpu_torch.entropy.ops as tops
from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.dcae import DCAE as JaxDCAE
from dcae_tpu.train import split_step as jsplit
from dcae_tpu.train import state as jstate
from dcae_tpu.train.losses import rate_distortion_loss as jrd_loss
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.train import split_step
from dcae_tpu_torch.train.state import (create_train_state, make_optimizer)
from dcae_tpu_torch.train.step import make_train_step
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_codec import KW, _images
from tests.test_torch_split import _flax_top
from tests.test_torch_train_step import LMBDA, _noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def patched():
    """Both packages' noise_quantize add the same fixed arrays."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jops, "noise_quantize",
               lambda x, rng: x + jnp.asarray(_noise(x.shape)))
    mp.setattr(tops, "noise_quantize",
               lambda x, generator: x + torch.from_numpy(
                   _noise(tuple(x.shape))))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(patched):
    jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
    init = DCAE(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in init.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_reference_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg))
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, params=params,
                x=_images(2, 128, seed=3))


def _model(setup) -> DCAE:
    m = DCAE(setup["cfg"])
    m.load_state_dict(setup["sd"])
    return m


def _sgd(state) -> None:
    """Plain SGD at rate 1 in place of each half's Adams: the step then
    moves every parameter by exactly its (clipped) gradient."""
    for half in (state.enc, state.dec):
        half.main_opt = torch.optim.SGD(
            [p for g in half.main_opt.param_groups for p in g["params"]],
            lr=1.0)
        if half.aux_opt is not None:
            half.aux_opt = torch.optim.SGD(
                [p for g in half.aux_opt.param_groups for p in g["params"]],
                lr=1.0)


def _probe(setup, clip: float, scale: float = 1.0) -> tuple:
    """(moves, metrics, model) of one SGD(1.0) split step on the CPU;
    moves[name] = before - after = the applied gradient."""
    model = _model(setup)
    tx = make_optimizer(1.0, 1.0, clip)
    state = split_step.create_split_train_state(model, tx, "cpu", "cpu")
    _sgd(state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = split_step.make_split_train_step(model, tx, LMBDA * scale,
                                            enc_device="cpu",
                                            dec_device="cpu")
    state, metrics = step(state, torch.from_numpy(setup["x"]))
    assert state.step == 1
    after = model.state_dict()
    return {k: before[k] - after[k] for k in before}, metrics, model


def test_halves_partition_equals_jax(setup):
    enc, dec = split_step.split_halves(setup["sd"])
    jenc, jdec = jsplit.split_halves(setup["params"])
    assert {_flax_top(k) for k in enc} == set(jenc)
    assert {_flax_top(k) for k in dec} == set(jdec)
    assert not set(enc) & set(dec)
    assert split_step.merge_halves(enc, dec) == setup["sd"]


@pytest.fixture(scope="module")
def composed(setup):
    """jax.grad of the JAX package's composed two-half loss (its split
    test's reference), through the converter's name map."""
    jcfg, x = setup["jcfg"], jnp.asarray(setup["x"])
    model = JaxDCAE(jcfg)
    key = jax.random.PRNGKey(0)

    def loss(p):
        y, z_hat, z_like = model.apply({"params": p}, x, True,
                                       rngs={"noise": key, "drift": key},
                                       method=JaxDCAE.encode_half)
        x_hat, y_like, *_ = model.apply({"params": p}, y, z_hat, True,
                                        rngs={"noise": key, "drift": key},
                                        method=JaxDCAE.decode_half)
        rd = jrd_loss({"x_hat": x_hat, "likelihoods": {"y": y_like}}, x,
                      LMBDA, "mse")
        bpp_z = jnp.sum(jnp.log(z_like)) / (
            -math.log(2) * x.shape[0] * x.shape[1] * x.shape[2])
        aux = model.apply({"params": p}, method=JaxDCAE.aux_loss)
        return rd["loss"] + bpp_z + aux

    value, g = jax.jit(jax.value_and_grad(loss))(setup["params"])
    return {"loss": float(value), "flax": g,
            "named": state_dict_from_flax(jax.tree.map(np.asarray, g), jcfg)}


def test_split_gradients_equal_jax_composed_grad(setup, composed):
    moves, metrics, _ = _probe(setup, clip=0.0)
    named = composed["named"]
    assert set(moves) == set(named)
    for name in sorted(named):
        got, want = moves[name].numpy(), named[name]
        if name.endswith(".k.bias"):
            # true gradient 0 (softmax ignores a shift of every score);
            # both sides hold rounding noise, 1e-5 of the key weight's
            w = float(np.abs(named[name[:-4] + "weight"]).max())
            assert float(np.abs(got).max()) <= 1e-5 * w, name
            continue
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6,
                                   err_msg=name)
    assert np.isfinite(float(metrics["loss"])) and metrics["bpp_loss"] > 0


def test_real_step_equals_jax_split_steps_update(setup, composed):
    """Per-half Adam with per-half clipping at 1.0, one step: the JAX
    split step's update (dcae_tpu/train/split_step.py apply_tx: the optax
    chain applied to each half of the tree on its own) of the composed
    gradient, which the JAX package's split test holds equal to its step's
    gradients. Compiling that step's three programs would cost the gate
    about a minute; the update is what this test is about."""
    lr = 1e-4
    jtx = jstate.make_optimizer(lr, 1e-3, 1.0)

    @jax.jit
    def apply_tx(p, g):
        updates, _ = jtx.update(g, jtx.init(p), p)
        return optax.apply_updates(p, updates)

    halves = [apply_tx(p, g) for p, g in zip(
        jsplit.split_halves(setup["params"]),
        jsplit.split_halves(composed["flax"]))]
    want = state_dict_from_flax(
        jax.tree.map(np.asarray, jsplit.merge_halves(*halves)),
        setup["jcfg"])

    model = _model(setup)
    tx = make_optimizer(lr, 1e-3, 1.0)
    step = split_step.make_split_train_step(model, tx, LMBDA,
                                            enc_device="cpu",
                                            dec_device="cpu")
    state = create_train_state(model, tx, torch.Generator().manual_seed(1))
    state, metrics = step(state, setup["x"])       # a joint state converts
    assert isinstance(state, split_step.SplitTrainState)
    assert state.step == 1
    assert set(metrics) == {"loss", "mse_loss", "bpp_loss", "aux_loss"}
    np.testing.assert_allclose(float(metrics["loss"] + metrics["aux_loss"]),
                               composed["loss"], rtol=1e-5)
    got = state.params
    diff = np.concatenate([np.abs(got[n].numpy() - want[n]).ravel()
                           for n in want if not n.endswith(".k.bias")])
    assert float(diff.max()) <= 2.1 * lr
    assert float(np.quantile(diff, 0.99)) <= 0.05 * lr
    still = [n for n in want
             if np.array_equal(got[n].numpy(), setup["sd"][n].numpy())]
    assert all(n.endswith(".k.bias") for n in still), still


def test_each_half_is_clipped_by_its_own_norm(setup):
    """With SGD(1.0), clip 1.0 and a loss large enough that both halves'
    norms exceed it, each half's move is its own gradient scaled to norm
    1 (main groups; the aux quantiles are not clipped): not the joint
    tree's clip."""
    raw, _, model = _probe(setup, clip=0.0, scale=100.0)
    clipped, _, _ = _probe(setup, clip=1.0, scale=100.0)
    for keys in split_step.split_halves(raw):
        main = [k for k in keys if "quantiles" not in k]
        norm = math.sqrt(sum(float((raw[k].double() ** 2).sum())
                             for k in main))
        assert norm > 1.0
        for k in keys:
            want = raw[k] / norm if k in main else raw[k]
            # atol: SGD's p - g rounds to p's ulp (6e-8 where |p| <= 1)
            torch.testing.assert_close(clipped[k], want, rtol=1e-4,
                                       atol=1e-6)
    total = math.sqrt(sum(float((raw[k].double() ** 2).sum())
                          for k in raw if "quantiles" not in k))
    k = "g_a.0.conv.weight"
    assert not torch.allclose(clipped[k], raw[k] / total, rtol=1e-3)


def test_one_device_split_step_is_the_joint_step(setup):
    """Both halves on one device share one generator, drawn in the joint
    forward's order, so the split step's metrics equal the joint step's
    and its SGD moves equal the joint step's gradients (rtol 1e-6: one
    backward against two, the same sums)."""
    tx = make_optimizer(1.0, 1.0, 0.0)
    joint = _model(setup)
    st = create_train_state(joint, tx, torch.Generator().manual_seed(5))
    st.main_opt = torch.optim.SGD(st.main_params(), lr=1.0)
    st.aux_opt = torch.optim.SGD(
        [p for g in st.aux_opt.param_groups for p in g["params"]], lr=1.0)
    before = {k: v.clone() for k, v in joint.state_dict().items()}
    _, jm = make_train_step(joint, tx, LMBDA)(st, torch.from_numpy(
        setup["x"]))
    moves, metrics, _ = _probe(setup, clip=0.0)
    for k in jm:    # bpp_loss adds bpp_y and bpp_z as two sums
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-6, err_msg=k)
    for k, v in joint.state_dict().items():
        torch.testing.assert_close(moves[k], before[k] - v, rtol=1e-6,
                                   atol=1e-9)


def test_split_state_shapes(setup):
    """One device: one generator for both halves; the aux Adam (the
    quantiles) in the encoder half only; both halves step together."""
    model = _model(setup)
    tx = make_optimizer(1e-4)
    state = split_step.create_split_train_state(model, tx, "cpu", "cpu",
                                                seed=3)
    assert state.enc.generator is state.dec.generator
    assert state.dec.aux_opt is None and state.enc.aux_opt is not None
    enc, dec = split_step.split_halves(dict(model.named_parameters()))
    assert {id(p) for p in state.enc.model.parameters()} == \
        {id(p) for p in enc.values()}
    assert {id(p) for p in state.dec.model.parameters()} == \
        {id(p) for p in dec.values()}
    step = split_step.make_split_train_step(model, tx, LMBDA, "mse",
                                            "cpu", "cpu")
    state, _ = step(state, setup["x"])
    assert state.enc.step == state.dec.step == state.step == 1
    for k, v in state.params.items():
        assert v is model.state_dict()[k] or torch.equal(
            v, model.state_dict()[k]), k


def test_step_refuses_cpu_fallback(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        split_step.make_split_train_step(_model(setup), make_optimizer(1e-4),
                                         LMBDA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        split_step.make_split_train_step(_model(setup), make_optimizer(1e-4),
                                         LMBDA, enc_device="cpu")


@pytest.mark.slow
def test_real_step_equals_jax_make_split_train_step(setup):
    """The same step against dcae_tpu.train.split_step's own
    make_split_train_step on two of JAX's CPU devices (its three programs
    compile for about a minute, hence slow), at the same bars and the
    metrics at 1e-5 relative."""
    lr = 1e-4
    jtx = jstate.make_optimizer(lr, 1e-3, 1.0)
    devs = jax.devices()
    jstep = jsplit.make_split_train_step(JaxDCAE(setup["jcfg"]), jtx, LMBDA,
                                         "mse", enc_device=devs[0],
                                         dec_device=devs[1])
    jst, jm = jstep(jstate.create_train_state(setup["params"], jtx,
                                              jax.random.PRNGKey(1)),
                    jnp.asarray(setup["x"]))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                setup["jcfg"])
    model = _model(setup)
    tx = make_optimizer(lr, 1e-3, 1.0)
    state = split_step.create_split_train_state(model, tx, "cpu", "cpu")
    state, metrics = split_step.make_split_train_step(
        model, tx, LMBDA, enc_device="cpu", dec_device="cpu")(state,
                                                              setup["x"])
    assert state.step == 1 == int(jst.step)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    got = state.params
    diff = np.concatenate([np.abs(got[n].numpy() - want[n]).ravel()
                           for n in want if not n.endswith(".k.bias")])
    assert float(diff.max()) <= 2.1 * lr
    assert float(np.quantile(diff, 0.99)) <= 0.05 * lr
