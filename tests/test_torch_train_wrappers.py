"""The three kernels' gradient wrappers (torch.autograd.Function over the
hand kernel) on the CPU.

There is no card here, so each Function's launch is replaced by the plain
version (monkeypatch of the module's `launch`): what is held is the
Function's own work, the recompute backward: which operands get a gradient,
in which dtype, and that the gradients equal

  * autograd straight through the plain version (f32, rtol 1e-5: the same
    arithmetic, run twice), and
  * jax.grad of the JAX package's `*_trainable` wrapper in interpret mode on
    the same weights (rtol 1e-4 of each gradient's max: both differentiate
    an f32 restatement, with different summation orders).

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcae_tpu.ops.pallas.conv_glu import conv_glu_trainable
from dcae_tpu.ops.pallas.wmsa_v3 import wmsa_v3_trainable
from dcae_tpu.ops.pallas.wmsa_v4 import wmsa_block_v4_trainable
from dcae_tpu_torch.ops.kernels import conv_glu as cg
from dcae_tpu_torch.ops.kernels import wmsa_attention as wa
from dcae_tpu_torch.ops.kernels import wmsa_block as wm
from tests.test_torch_kernels import (_glu_params, _glu_torch_args,
                                      _wmsa_jax_args, _wmsa_params,
                                      _wmsa_torch_args)

C, HEADS, HID = 32, 4, 64
WMSA_NAMES = ("x", "ln_w", "ln_b", "rs", "wqkv", "bqkv", "wproj", "bproj",
              "rel")
GLU_NAMES = ("x", "ln_w", "ln_b", "w1", "b1", "dw_w", "dw_b", "w2", "b2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many small ops beside other
    test processes: one intra-op thread each, or the workers' thread pools
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def plain_launch(monkeypatch):
    """Replace every kernel launch by the plain version and count the
    Functions' forwards."""
    calls = {"wmsa_block": 0, "wmsa_attention": 0, "conv_glu": 0}

    def wmsa_launch(what, x, params, *, heads, shifted):
        calls[what] += 1
        ref = wm.wmsa_block_ref if what == "wmsa_block" \
            else wa.wmsa_attention_ref
        return ref(x.detach(), *(p.detach() for p in params), heads=heads,
                   shifted=shifted)

    def glu_launch(*operands, apply_ln):
        calls["conv_glu"] += 1
        return cg.conv_glu_ref(
            *(None if t is None else t.detach() for t in operands),
            apply_ln=apply_ln)

    monkeypatch.setattr(wm, "launch", wmsa_launch)
    monkeypatch.setattr(wa, "launch", wmsa_launch)
    monkeypatch.setattr(cg, "launch", glu_launch)
    return calls


def _leaf(t, dtype=torch.float32):
    return t.detach().to(dtype).clone().requires_grad_(True)


def _close(got, want, rtol, what):
    """|got - want| <= rtol * max|want|, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bar = rtol * max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{what}: {err} > {bar}"


def _case(kernel, shifted=True, apply_ln=True):
    """(Function, plain version, static kwargs, f32 torch operands, the
    cotangent, names, the JAX gradients of the trainable wrapper)."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    if kernel == "conv_glu":
        p = _glu_params(rng, C, HID)
        args = (torch.from_numpy(x), *_glu_torch_args(p))
        jargs = tuple(jnp.asarray(np.asarray(p[k], np.float32)) for k in (
            "ln_scale", "ln_bias", "w1", "b1", "dwk", "dwb", "w2", "b2"))

        def jloss(x_, *a):
            return jnp.sum(conv_glu_trainable(x_, *a, apply_ln=apply_ln,
                                              interpret=True) * jg)

        jgrads = list(jax.grad(jloss, argnums=tuple(range(9)))(jx, *jargs))
        # Flax layouts -> torch layouts
        jgrads[3] = jgrads[3].T
        jgrads[5] = jnp.transpose(jgrads[5], (2, 0, 1)).reshape(HID, 1, 3, 3)
        jgrads[7] = jgrads[7].T
        fn = lambda *a: cg.ConvGluFunction.apply(apply_ln, *a)  # noqa: E731
        return (fn, cg.conv_glu_ref, dict(apply_ln=apply_ln), args,
                torch.from_numpy(g), GLU_NAMES, jgrads)
    p = _wmsa_params(rng, C, HEADS)
    targs, jargs = _wmsa_torch_args(p), _wmsa_jax_args(p)
    kw = dict(heads=HEADS, shifted=shifted)
    if kernel == "wmsa_block":
        trainable, Fn, ref, names = (wmsa_block_v4_trainable,
                                     wm.WmsaBlockFunction, wm.wmsa_block_ref,
                                     WMSA_NAMES)
    else:
        trainable, Fn, ref = (wmsa_v3_trainable, wa.WmsaAttentionFunction,
                              wa.wmsa_attention_ref)
        targs, jargs = targs[3:], jargs[3:]
        names = WMSA_NAMES[:1] + WMSA_NAMES[4:]

    def jloss(x_, *a):
        return jnp.sum(trainable(x_, *a, window=8, interpret=True, **kw)
                       * jg)

    jgrads = list(jax.grad(jloss, argnums=tuple(range(len(names))))(
        jx, *jargs))
    for i, n in enumerate(names):
        if n in ("wqkv", "wproj"):
            jgrads[i] = jgrads[i].T
    fn = lambda *a: Fn.apply(HEADS, shifted, *a)  # noqa: E731
    return fn, ref, kw, (torch.from_numpy(x), *targs), \
        torch.from_numpy(g), names, jgrads


CASES = [("wmsa_block", False, True), ("wmsa_block", True, True),
         ("wmsa_attention", False, True), ("wmsa_attention", True, True),
         ("conv_glu", False, True), ("conv_glu", False, False)]


@pytest.mark.parametrize("kernel,shifted,apply_ln", CASES)
def test_function_gradients_match_plain_and_jax(plain_launch, kernel,
                                                shifted, apply_ln):
    fn, ref, kw, args, g, names, jgrads = _case(kernel, shifted, apply_ln)
    a_fn = [_leaf(t) for t in args]
    a_ref = [_leaf(t) for t in args]
    out = fn(*a_fn)
    assert plain_launch[kernel] == 1
    assert out.grad_fn is not None
    out.backward(g)
    ref(*a_ref, **kw).backward(g)
    for name, got, want, jwant in zip(names, a_fn, a_ref, jgrads):
        if kernel == "conv_glu" and not apply_ln and name in ("ln_w",
                                                              "ln_b"):
            assert got.grad is None, name     # not operands of the call
            continue
        assert got.grad is not None and got.grad.dtype == torch.float32
        assert float(got.grad.abs().max()) > 0, name
        _close(got.grad, want.grad, 1e-5, f"{kernel} {name} vs plain")
        _close(got.grad, jwant, 1e-4, f"{kernel} {name} vs jax.grad")


@pytest.mark.parametrize("kernel", ["wmsa_block", "wmsa_attention",
                                    "conv_glu"])
def test_bf16_operands_get_bf16_gradients(plain_launch, kernel):
    """The backward runs in f32 whatever the call's dtype and hands each
    gradient back in its operand's dtype; it differentiates the plain
    version without the bf16 rounding points, so it sits within bf16 noise
    (3e-2 of the max) of the f32 call's gradients."""
    fn, ref, kw, args, g, names, _ = _case(kernel)
    a16 = [_leaf(t, torch.bfloat16) for t in args]
    a32 = [_leaf(t) for t in args]
    out = fn(*a16)
    assert out.dtype == torch.bfloat16
    out.backward(g.bfloat16())
    ref(*a32, **kw).backward(g)
    for name, got, want in zip(names, a16, a32):
        assert got.grad.dtype == torch.bfloat16, name
        _close(got.grad.float(), want.grad, 3e-2, f"{kernel} {name}")


def test_apply_ln_false_sends_nothing_into_b2_but_its_own(plain_launch):
    """Without LN the launch passes b2's pointer in the LN slots; b2's
    gradient must be its own (the cotangent summed over positions), and
    the LN tensors, though given, get none."""
    fn, _, _, args, g, names, _ = _case("conv_glu", apply_ln=False)
    leaves = [_leaf(t) for t in args]
    fn(*leaves).backward(g)
    grads = dict(zip(names, (t.grad for t in leaves)))
    assert grads["ln_w"] is None and grads["ln_b"] is None
    _close(grads["b2"], g.sum(dim=(0, 1, 2)), 1e-5, "b2")


def test_only_operands_that_require_grad_get_one(plain_launch):
    fn, _, _, args, g, names, _ = _case("wmsa_block")
    leaves = [t.clone().requires_grad_(n in ("x", "rel"))
              for n, t in zip(names, args)]
    fn(*leaves).backward(g)
    for n, t in zip(names, leaves):
        assert (t.grad is not None) == (n in ("x", "rel")), n


def test_in_place_write_between_forward_and_backward_is_caught(
        plain_launch):
    """The operands are saved with save_for_backward, so autograd's version
    check sees a parameter written between the passes."""
    fn, _, _, args, g, _, _ = _case("wmsa_attention")
    leaves = [_leaf(t) for t in args]
    out = fn(*leaves)
    with torch.no_grad():
        leaves[1].add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        out.backward(g)


@pytest.mark.parametrize("kernel", ["wmsa_block", "wmsa_attention",
                                    "conv_glu"])
def test_public_wrapper_enters_function_only_for_gradients(monkeypatch,
                                                           kernel):
    """On a tensor that is not on the CPU the public wrapper goes through
    the Function when grad mode is on and an operand requires grad, and
    launches directly otherwise; either way it counts one forward launch.
    Meta tensors stand in for the card's, with a launch that only
    allocates."""
    _, _, kw, args, _, _, _ = _case(kernel)
    module, public, Fn = {
        "wmsa_block": (wm, wm.wmsa_block, wm.WmsaBlockFunction),
        "wmsa_attention": (wa, wa.wmsa_attention, wa.WmsaAttentionFunction),
        "conv_glu": (cg, cg.conv_glu, cg.ConvGluFunction)}[kernel]
    monkeypatch.setattr(module, "launch", lambda *a, **k: torch.empty_like(
        a[0] if kernel == "conv_glu" else a[1]))
    entered = []
    real_apply = Fn.apply
    monkeypatch.setattr(Fn, "apply", staticmethod(
        lambda *a: entered.append(1) or real_apply(*a)))

    def meta(grad):
        return [t.to("meta").requires_grad_(grad) for t in args]

    public.launches = 0
    try:
        with torch.no_grad():
            public(*meta(True), **kw)
        assert not entered and public.launches == 1
        public(*meta(False), **kw)
        assert not entered and public.launches == 2
        out = public(*meta(True), **kw)
        assert entered == [1] and public.launches == 3
        assert out.grad_fn is not None
    finally:
        public.launches = 0
