"""The port's training step against the JAX trainer, on the CPU: the tiny
window-8 DCAE, f32, the same weights (a seeded port init carried into Flax
params by the JAX package's converter), the same batch, and the same
training noise (both packages' noise_quantize patched to add one fixed
array per shape; drift off).

One module-scoped jax.value_and_grad of the Flax model gives the training
forward, the RD loss, aux_loss and every parameter's gradient of rd + aux;
the port's come from one backward. JAX gradients are compared through the
converter's name map (state_dict_from_flax is linear, so it carries
gradients as it carries weights).

Tolerances: both sides run f32 with different summation orders through
some 60 layers: 1e-5 relative on the losses, 1e-4 of each tensor's max on
activations and gradients (measured: 3e-7 on the loss, 2.4e-6 on the
likelihoods, 5.6e-6 on the worst gradient, so each bar leaves a factor of
18 or more). The optimizer step is held at rtol 1e-5: both optimizers are
fed the SAME gradients.
"""

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
from dcae_tpu.train import losses as jlosses
from dcae_tpu.train import state as jstate
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.train import losses, state
from dcae_tpu_torch.train.step import (make_eval_step, make_loss_fn,
                                       make_train_step)
from dcae_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_codec import KW, _images

LMBDA = 0.0483
REAL_NOISE_QUANTIZE = tops.noise_quantize    # the fixture patches it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many small ops beside other
    test processes: one intra-op thread each, or the workers' thread pools
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _noise(shape) -> np.ndarray:
    """The fixed U(-0.5, 0.5) array both packages add for `shape`."""
    seed = int(np.prod(shape)) * 7 + len(shape)
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, shape).astype(np.float32)


def _close(got, want, rtol, what, floor=1e-12):
    """|got - want| <= rtol * max(max|want|, floor), elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bar = rtol * max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{what}: {err} > {bar}"


def _grads(model) -> dict:
    return {n: (None if p.grad is None else p.grad.detach().clone())
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def both():
    """{x, cfg, jcfg, params (Flax), model (port), the JAX loss, metrics,
    forward and gradients, and the port's}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jops, "noise_quantize",
               lambda x, rng: x + jnp.asarray(_noise(x.shape)))
    mp.setattr(tops, "noise_quantize",
               lambda x, generator: x + torch.from_numpy(
                   _noise(tuple(x.shape))))
    try:
        jcfg, cfg = JaxConfig.tiny(**KW), DCAEConfig.tiny(**KW)
        model = DCAE(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = convert_reference_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
        params = jax.tree.map(jnp.asarray, params)
        x = _images(2, 128, seed=3)
        jmodel = JaxDCAE(jcfg)
        key = jax.random.PRNGKey(0)

        def jloss(p):
            out = jmodel.apply({"params": p}, jnp.asarray(x), training=True,
                               rngs={"noise": key, "drift": key})
            rd = jlosses.rate_distortion_loss(out, jnp.asarray(x), LMBDA)
            aux = jmodel.apply({"params": p}, method=JaxDCAE.aux_loss)
            return rd["loss"] + aux, (rd, aux, out)

        (_, (jrd, jaux, jout)), jg = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(params)
        jg = jax.tree.map(np.asarray, jg)

        loss_fn = make_loss_fn(model, LMBDA)
        gen = torch.Generator().manual_seed(0)
        xt = torch.from_numpy(x)
        out = model(xt, training=True, generator=gen)
        loss, metrics = loss_fn(xt, gen)
        loss.backward()
        yield dict(x=x, cfg=cfg, jcfg=jcfg, params=params, model=model,
                   jrd=jrd, jaux=jaux, jout=jax.tree.map(np.asarray, jout),
                   jgrads=jg, jgrads_named=state_dict_from_flax(jg, jcfg),
                   out=out, metrics=metrics, grads=_grads(model))
    finally:
        mp.undo()


def test_training_forward_matches_flax(both):
    got, want = both["out"], both["jout"]
    _close(got["x_hat"].detach(), want["x_hat"], 1e-4, "x_hat")
    for k in ("y", "z"):
        _close(got["likelihoods"][k].detach(), want["likelihoods"][k], 1e-4,
               f"likelihoods {k}")
    assert set(got["para"]) == set(want["para"]) == {
        "means", "scales", "y", "y_hat", "z_hat"}
    for k in got["para"]:
        _close(got["para"][k].detach(), want["para"][k], 1e-4, f"para {k}")


def test_training_likelihoods_see_the_noise(both):
    """Training-mode likelihoods differ from eval-mode ones (noise, not
    rounding), while x_hat (straight-through rounding) does not."""
    model, x = both["model"], torch.from_numpy(both["x"])
    with torch.no_grad():
        ev = model(x)
    assert torch.equal(ev["x_hat"], both["out"]["x_hat"].detach())
    assert not torch.allclose(ev["likelihoods"]["y"],
                              both["out"]["likelihoods"]["y"].detach())


def test_rd_and_aux_loss_match_jax(both):
    m = both["metrics"]
    for k in ("loss", "mse_loss", "bpp_loss"):
        np.testing.assert_allclose(float(m[k].detach()),
                                   float(both["jrd"][k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["aux_loss"].detach()),
                               float(both["jaux"]), rtol=1e-5)
    assert float(m["aux_loss"]) > 0


def test_every_parameter_gradient_matches_jax(both):
    grads, want = both["grads"], both["jgrads_named"]
    assert set(grads) == set(want)
    for name in sorted(want):
        assert grads[name] is not None, name
        if name.endswith(".k.bias"):
            # the dictionary attention's key bias shifts every score of a
            # query alike: its true gradient is 0 and both sides hold
            # rounding noise, 1e-5 of the key weight's gradient at most
            w = float(np.abs(want[name[:-4] + "weight"]).max())
            assert float(grads[name].abs().max()) <= 1e-5 * w, name
            assert float(np.abs(want[name]).max()) <= 1e-5 * w, name
            continue
        assert float(np.abs(want[name]).max()) > 0, name
        _close(grads[name], want[name], 1e-4, name)


def test_gradient_groups_are_disjoint(both):
    """The quantiles get no RD gradient and nothing but the quantiles gets
    an aux gradient: what lets one backward serve both Adams."""
    model, x = both["model"], torch.from_numpy(both["x"])
    named = dict(model.named_parameters())
    out = model(x, training=True, generator=torch.Generator())
    rd = losses.rate_distortion_loss(out, x, LMBDA)["loss"]
    g_rd = torch.autograd.grad(rd, list(named.values()), allow_unused=True)
    g_aux = torch.autograd.grad(model.aux_loss(), list(named.values()),
                                allow_unused=True)
    for name, gr, ga in zip(named, g_rd, g_aux):
        if "quantiles" in name:
            assert gr is None or float(gr.abs().max()) == 0.0, name
            assert ga is not None and float(ga.abs().max()) > 0
        else:
            assert ga is None or float(ga.abs().max()) == 0.0, name
            assert gr is not None and float(gr.abs().max()) > 0, name


@pytest.mark.parametrize("metric", ["mse", "ms-ssim", "l1"])
def test_rate_distortion_loss_matches_jax(metric):
    """The loss function alone, on a made-up forward dict at 192x192 (the
    5-scale MS-SSIM needs more than 160 pixels a side)."""
    rng = np.random.default_rng(5)
    target = _images(2, 192, seed=6)
    out = {"x_hat": np.clip(target + rng.normal(0, 0.05, target.shape),
                            -0.1, 1.1).astype(np.float32),
           "likelihoods": {
               "y": rng.uniform(1e-3, 1, (2, 12, 12, 20)).astype(np.float32),
               "z": rng.uniform(1e-3, 1, (2, 3, 3, 16)).astype(np.float32)}}
    want = jlosses.rate_distortion_loss(
        jax.tree.map(jnp.asarray, out), jnp.asarray(target), 3.0, metric)
    tout = {"x_hat": torch.from_numpy(out["x_hat"]),
            "likelihoods": {k: torch.from_numpy(v)
                            for k, v in out["likelihoods"].items()}}
    got = losses.rate_distortion_loss(tout, torch.from_numpy(target), 3.0,
                                      metric)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    with pytest.raises(ValueError):
        losses.rate_distortion_loss(tout, torch.from_numpy(target), 1.0, "x")


@pytest.mark.parametrize("loss_type", ["mse", "l1", "ms-ssim", "mixed"])
def test_reconstruction_loss_matches_jax(loss_type):
    target = _images(1, 192, seed=8)
    x_hat = np.clip(target + np.random.default_rng(9).normal(
        0, 0.05, target.shape), 0, 1).astype(np.float32)
    want = jlosses.reconstruction_loss(jnp.asarray(x_hat),
                                       jnp.asarray(target), loss_type)
    got = losses.reconstruction_loss(torch.from_numpy(x_hat),
                                     torch.from_numpy(target), loss_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


# ------------------------------------------------- optimizer vs optax --

def _optax_steps(both, jtx, n_steps, scale):
    params = both["params"]
    grads = jax.tree.map(lambda g: jnp.asarray(g) * scale, both["jgrads"])
    opt_state = jtx.init(params)

    @jax.jit
    def step(params, opt_state):
        updates, opt_state = jtx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(n_steps):
        params, opt_state = step(params, opt_state)
    return state_dict_from_flax(jax.tree.map(np.asarray, params),
                                both["jcfg"])


def _port_steps(both, tx, n_steps, scale):
    """The port's optimizers on the JAX gradients (through the name map),
    so both sides step on the same numbers."""
    model = DCAE(both["cfg"])
    model.load_state_dict(both["model"].state_dict())
    st = state.create_train_state(model, tx, torch.Generator())
    named = dict(model.named_parameters())
    for _ in range(n_steps):
        for name, g in both["jgrads_named"].items():
            named[name].grad = torch.from_numpy(np.array(g)) * scale
        state.apply_updates(st, tx)
    return st, {k: v.detach().numpy() for k, v in named.items()}


@pytest.mark.parametrize("case", ["clipped", "milestone", "frozen",
                                  "unclipped"])
def test_optimizer_step_matches_optax(both, case):
    """Updated parameters of both groups equal optax's (rtol 1e-5 of each
    tensor's max): with the main group's norm above the clip, across a
    schedule milestone (two steps, the second at the decayed rate), with
    everything but g_a / h_a frozen, and with clipping off."""
    main_norm = np.sqrt(sum(
        float((g.astype(np.float64) ** 2).sum())
        for n, g in both["jgrads_named"].items() if "quantiles" not in n))
    scale = 10.0 / main_norm         # the main group's norm becomes 10
    keys = ("g_a", "h_a") if case == "frozen" else None
    clip = 0.0 if case == "unclipped" else 1.0
    n_steps = 2 if case == "milestone" else 1
    lr = (1e-4, [1]) if case == "milestone" else (1e-4, [100])
    jtx = jstate.make_optimizer(jstate.multistep_lr(*lr), 1e-3, clip,
                                trainable_keys=keys)
    tx = state.make_optimizer(state.multistep_lr(*lr), 1e-3, clip,
                              trainable_keys=keys)
    want = _optax_steps(both, jtx, n_steps, scale)
    st, got = _port_steps(both, tx, n_steps, scale)
    assert st.step == n_steps
    before = {k: v.numpy() for k, v in both["model"].state_dict().items()}
    moved = 0
    for name in sorted(want):
        _close(got[name], want[name], 1e-5, f"{case} {name}")
        top = name.split(".")[0]
        if keys is not None and top not in keys:
            assert np.array_equal(got[name], before[name]), name
        else:
            moved += not np.array_equal(got[name], before[name])
    assert moved > 0
    q = "entropy_bottleneck.quantiles"
    assert np.array_equal(got[q], before[q]) == (case == "frozen")
    if case == "clipped":
        # clipping acted: an Adam step on clipped and on raw gradients
        # differ only through eps, so compare against the unclipped run
        _, raw = _port_steps(both, state.make_optimizer(1e-4, 1e-3, 0.0),
                             1, scale)
        assert any(not np.array_equal(raw[n], got[n]) for n in got)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], optax.EmptyState())
        got = [torch.from_numpy(a.copy()) for a in arrays]
        norm = state.clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum((a ** 2).sum() for a in arrays)),
            rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_multistep_schedule_matches_optax():
    sched, jsched = (m.multistep_lr(1e-4, [100, 200])
                     for m in (state, jstate))
    for step in (0, 99, 100, 150, 199, 200, 250):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)


# --------------------------------------------------- the port's own step --

@pytest.fixture()
def fresh(both):
    model = DCAE(both["cfg"])
    model.load_state_dict(both["model"].state_dict())
    return model, torch.from_numpy(both["x"])


def test_train_step_is_backward_plus_apply_updates(both, fresh):
    """make_train_step = one backward of rd + aux, then apply_updates: the
    parameters after it equal a by-hand step on the same noise."""
    model, x = fresh
    tx = state.make_optimizer(1e-4, 1e-3)
    st = state.create_train_state(model, tx,
                                  torch.Generator().manual_seed(4))
    st, metrics = make_train_step(model, tx, LMBDA)(st, x)
    assert st.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert set(metrics) == {"loss", "mse_loss", "bpp_loss", "aux_loss"}

    hand = DCAE(both["cfg"])
    hand.load_state_dict(both["model"].state_dict())
    hst = state.create_train_state(hand, tx,
                                   torch.Generator().manual_seed(4))
    loss, _ = make_loss_fn(hand, LMBDA)(x, hst.generator)
    loss.backward()
    state.apply_updates(hst, tx)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              hand.named_parameters()):
        assert torch.equal(a, b), n
    before = both["model"].state_dict()
    assert not torch.equal(before["g_a.0.conv.weight"],
                           model.state_dict()["g_a.0.conv.weight"])
    assert not torch.equal(before["entropy_bottleneck.quantiles"],
                           model.entropy_bottleneck.quantiles)


def test_precision_regularization(both, fresh):
    """precision_reg > 0 adds a positive, finite precision_loss from two
    more decoder passes and changes the gradient."""
    model, x = fresh
    w = "g_s.0.weight"
    loss, metrics = make_loss_fn(model, LMBDA, precision_reg=1e3,
                                 precision_noise=1e-1)(
        x[:1], torch.Generator().manual_seed(1))
    p = float(metrics["precision_loss"])
    assert np.isfinite(p) and p > 0
    loss.backward()
    with_reg = _grads(model)[w]
    model.zero_grad()
    loss0, metrics0 = make_loss_fn(model, LMBDA)(
        x[:1], torch.Generator().manual_seed(1))
    assert "precision_loss" not in metrics0
    np.testing.assert_allclose(float(loss), float(loss0) + 1e3 * p,
                               rtol=1e-5)
    loss0.backward()
    assert not torch.allclose(with_reg, _grads(model)[w], rtol=1e-3)
    # decode_from_quantized on the forward's own latent re-applies the LRP
    # to already corrected slices: finite, of the image's shape
    with torch.no_grad():
        out = model(x[:1])
        again = model.decode_from_quantized(out["para"]["y_hat"],
                                            out["para"]["z_hat"])
    assert again.shape == out["x_hat"].shape
    assert bool(torch.isfinite(again).all())


def test_eval_step(fresh):
    model, x = fresh
    m = make_eval_step(model, LMBDA)(x)
    assert np.isfinite(float(m["loss"])) and float(m["psnr"]) > 0
    assert all(p.grad is None for p in model.parameters())


def test_drift_noise_draws_from_the_generator(both):
    """cfg.drift_noise > 0 perturbs the training forward from the explicit
    generator (same seed, same result; another seed, another) and leaves
    the eval forward alone."""
    cfg = DCAEConfig.tiny(drift_noise=0.05, **KW)
    model = DCAE(cfg)
    model.load_state_dict(both["model"].state_dict())
    x = torch.from_numpy(both["x"][:1])
    with torch.no_grad():
        run = lambda s: model(x, training=True,              # noqa: E731
                              generator=torch.Generator().manual_seed(s))
        a, b, c = run(1), run(1), run(2)
        assert torch.equal(a["x_hat"], b["x_hat"])
        assert not torch.equal(a["x_hat"], c["x_hat"])
        assert torch.equal(model(x)["x_hat"],
                           both["model"](x)["x_hat"])
        with pytest.raises(ValueError, match="generator"):
            model(x, training=True)


def test_noise_quantize_is_seeded_uniform_noise():
    x = torch.zeros(4, 8, 8, 16)
    draw = lambda s: REAL_NOISE_QUANTIZE(                    # noqa: E731
        x, torch.Generator().manual_seed(s))
    a, b, c = draw(1), draw(1), draw(2)
    assert a.device == x.device and a.dtype == x.dtype
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.02 and float(a.std()) > 0.25
    assert torch.equal(a, b) and not torch.equal(a, c)
    from dcae_tpu_torch.entropy import gaussian
    with pytest.raises(ValueError, match="generator"):
        gaussian.apply(x, torch.ones_like(x), training=True)
