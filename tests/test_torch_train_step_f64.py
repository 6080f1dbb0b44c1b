"""Port train step in float64 vs the JAX package's network in float64.

The f32 comparisons (``test_torch_train_step.py``,
``test_torch_train_modes.py``) hold the gradients and moments to 5e-3 and
3e-2 of max|ref|, because the JAX package's own f32 gradients lie that far
from exact on these shapes. This file takes f32 rounding out of both sides
and holds the port to the JAX package at the tight tolerances, and it
measures how far each side's f32 gradients lie from the precise ones.

The reference is the JAX package's model (``jax.enable_x64``, parameters,
BN statistics and image in float64) and its v8 loss, composed with
``jax.vjp``: the maps go to the loss in f32, the loss's cotangent comes
back and the network's backward runs in float64. The loss stays f32 because
it is not x64-clean: under x64 its TAL scan carries an int32 index that
``jnp.arange`` makes int64, and without x64 its fallback ``lax.cond`` mixes
f32 and f64 branches. Then the JAX ``TrainState.apply_gradients`` (f32
state) applies the mean gradient, after the BN statistics of each
microbatch, in order. The port runs the whole step in float64 (the model
``.double()``, the batch's image f64).

Crater YOLO11n at 64 px, B=4, the JAX initial weights, the seeded batch of
``test_torch_train_step.py``. Stated tolerances, for one step from the
initial state, a second step from the reference state after one, and
``grad_accum=2`` (the strided split):

* the loss and its triplet ``rtol = 1e-6`` (the reference's loss is f32);
* gradients within ``1e-5 * max|ref|`` per tensor (at least 1e-4 of the
  largest tensor's max, for tensors that are 0 in exact arithmetic), and
  both Adam moments the same;
* BN running variances ``rtol = 1e-9``, running means within ``1e-10``
  (float64 on both sides; the reference's forward is not rounded to f32);
* parameters and EMA within ``1e-6`` and 4 f32 ulp of the reference value
  (the reference state and its EMA arithmetic are f32), except where
  ``|g_ref| < 1e-4 * max|g_ref|`` of the tensor: there Adam's step is about
  ±lr whatever the gradient's size, so a near-zero gradient of the other
  sign may move a parameter by up to ``2 * lr``;
* the step counter, the optimizer's count and the LR equal.

Measured (printed with ``-s``): gradients 3.3e-7 of max|ref|, moments
1.5e-6, the loss 1.5e-7, BN running variances 2.4e-13.

And the f32 gradients against the same reference, the bounds that the f32
comparisons rest on: with one batch the JAX package's within ``5e-3 *
max|ref|`` per tensor (the f32 step test's tolerance; measured 2.5e-3) and
the port's within ``1e-3`` (3.7e-4); with ``grad_accum=2``, 2 images a
microbatch, the JAX package's within ``3e-2`` (the f32 grad-accum test's
tolerance; 1.5e-2) and the port's within ``5e-3`` (2.5e-3). Both grow as
the batch shrinks: the P5 blocks' BN normalises 16 values a channel at 64
px and B=4, 8 with two images.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train_step import (
    G_TOL,
    LOSS_KEYS,
    _close_per_tensor,
    _port_state,
    jax_schedule_args,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    setup,  # noqa: F401 (fixture)
)
from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig as JLossConfig
from yolo_scratch_tpu.train.optim import cosine_epoch_schedule as jax_schedule
from yolo_scratch_tpu.train.steps import v8_loss_adapter as jax_adapter
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

TOL64 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), jax.device_get(tree))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _sd64(params=None, stats=None):
    """Port state-dict entries of a JAX params or batch_stats tree, f64."""
    return state_dict_from_jax({"params": params or {}, "batch_stats": stats or {}},
                               np.float64)


@pytest.fixture(scope="module")
def ref(setup):
    """(``grads(params, stats, batch) -> (total, metrics, grads,
    new_stats)`` in float64 numpy trees, the jitted JAX
    ``TrainState.apply_gradients``, the JAX package's f32 gradient at
    ``"highest"``)."""
    _, jm, _, _, _ = setup

    def net(p, s, img):
        return jm.apply({"params": p, "batch_stats": s}, img, train=True,
                        mutable=["batch_stats"])

    with jax.enable_x64(True):
        fwd = jax.jit(net)
        bwd = jax.jit(lambda p, s, img, ct: jax.vjp(lambda q: net(q, s, img)[0], p)[1](ct)[0])
    loss_fn = jax_adapter(JLossConfig(nc=5, strides=jm.strides))
    loss_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def grads(params, stats, batch):
        p, s = _f64(params), _f64(stats)
        img = np.asarray(batch["img"], np.float64)
        with jax.enable_x64(True):
            feats, mut = fwd(p, s, img)
            feats = [np.asarray(f, np.float32) for f in feats]
        (total, metrics), ct = loss_grad(feats, batch)
        with jax.enable_x64(True):
            g = bwd(p, s, img, [np.asarray(c, np.float64) for c in ct])
        return (float(total), {k: float(v) for k, v in metrics.items()}, jax.device_get(g),
                jax.device_get(mut["batch_stats"]))

    def loss32(params, stats, batch):
        feats, _ = net(params, stats, batch["img"])
        return loss_fn(feats, batch)[0]

    def grads32(params, stats, batch):
        with jax.default_matmul_precision("highest"):
            return jax.grad(loss32)(params, stats, batch)

    return grads, jax.jit(lambda st, g: st.apply_gradients(g)), jax.jit(grads32)


def _ref_step(ref, jstate, batch, k=1):
    """The reference step with the JAX step's strided split: (next JAX
    state, metrics, mean gradient f64, BN statistics f64)."""
    grads, apply, _ = ref
    stats, total, metrics, g_sum = jstate.batch_stats, 0.0, {}, None
    for i in range(k):
        t, m, g, stats = grads(jstate.params, stats, {key: v[i::k] for key, v in batch.items()})
        total += t
        metrics = {key: metrics.get(key, 0.0) + v for key, v in m.items()}
        g_sum = g if g_sum is None else jax.tree_util.tree_map(np.add, g_sum, g)
    g = jax.tree_util.tree_map(lambda x: x * (1.0 / k), g_sum)
    nxt = apply(jstate.replace(batch_stats=_f32(stats)), _f32(g))
    return nxt, {"loss": total / k, **{key: v / k for key, v in metrics.items()}}, g, stats


def _port_run(jstate, batch, dtype, k=1):
    tm, ts = _port_state(jstate, dtype)
    step = build_train_step_custom(
        tm, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides)), grad_accum=k,
        matmul_precision="highest")
    b = dict(batch, img=np.asarray(batch["img"], torch.empty((), dtype=dtype).numpy().dtype))
    lr = ts.tx.lr(ts.opt_state.count)
    ts, metrics = step(ts, b)
    return tm, ts, metrics, lr


def _check64(ref, jstate, batch, k=1):
    nxt, j_metrics, g, stats = _ref_step(ref, jstate, batch, k)
    tm, ts, metrics, lr = _port_run(jstate, batch, torch.float64, k)
    assert lr == float(jax_schedule(**jax_schedule_args())(jnp.int32(int(jstate.step))))
    adam = nxt.opt_state[1][0]  # chain: (clip, adamw = (scale_by_adam, wd, lr))
    assert (ts.step, ts.opt_state.count) == (int(nxt.step), int(adam.count))
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[key]), j_metrics[key], rtol=1e-6, err_msg=key)

    names = [n for n, _ in tm.named_parameters()]
    g_ref = _sd64(g)
    _close_per_tensor({n: p.grad for n, p in tm.named_parameters()}, g_ref, TOL64, "grad")
    _close_per_tensor(dict(zip(names, ts.opt_state.mu)), _sd64(adam.mu), TOL64, "mu")
    _close_per_tensor(dict(zip(names, ts.opt_state.nu)), _sd64(adam.nu), TOL64, "nu")

    sd = tm.state_dict()
    print("loss: worst {:.3g} relative; running_var: worst {:.3g} relative".format(
        max(abs(float(metrics[key]) / j_metrics[key] - 1) for key in LOSS_KEYS),
        max(float(((sd[key] - r) / r).abs().max())
            for key, r in _sd64(stats=stats).items() if key.endswith("running_var"))))
    for key, r in _sd64(stats=stats).items():
        if key.endswith("running_var"):
            np.testing.assert_allclose(sd[key].numpy(), r.numpy(), rtol=1e-9, err_msg=key)
        elif key.endswith("running_mean"):
            np.testing.assert_allclose(sd[key].numpy(), r.numpy(), rtol=0, atol=1e-10,
                                       err_msg=key)

    p_ref, ema_ref = _sd64(nxt.params), _sd64(nxt.ema_params)
    for n, p in tm.named_parameters():
        gr = g_ref[n].abs()
        bound = torch.where(gr < 1e-4 * gr.max(), 2 * lr + 1e-6, 1e-6)
        for got, want, what in ((p.detach(), p_ref[n], "param"), (ts.ema[n], ema_ref[n], "ema")):
            # the reference state is f32: its own rounding, 4 ulp
            assert bool(((got - want).abs() <= bound + 2.0 ** -21 * want.abs()).all()), \
                f"{what} {n}"
    return nxt


def test_one_step_f64_matches_jax_f64_network(setup, ref):
    _check64(ref, setup[2], setup[0])


def test_second_step_f64_matches_jax_f64_network(setup, ref):
    batch, _, state, _, _ = setup
    s1, _, _, _ = _ref_step(ref, state, batch)
    _check64(ref, s1, batch)


def test_grad_accum_f64_matches_jax_f64_network(setup, ref):
    _check64(ref, setup[2], setup[0], k=2)


@pytest.mark.parametrize("k", [1, 2])
def test_f32_gradients_against_the_f64_network(setup, ref, k):
    """How far each side's f32 gradients lie from the precise ones: the
    bound the f32 comparisons rest on."""
    batch, _, state, _, _ = setup
    micro = [{key: v[i::k] for key, v in batch.items()} for i in range(k)]
    j32 = [jax.device_get(ref[2](state.params, state.batch_stats, mb)) for mb in micro]
    j32 = jax.tree_util.tree_map(lambda *g: sum(g) / k, *j32)
    g_ref = _sd64(_ref_step(ref, state, batch, k)[2])
    tm, _, _, _ = _port_run(state, batch, torch.float32, k)
    _close_per_tensor(_sd64(j32), g_ref, G_TOL if k == 1 else 3e-2, "JAX f32 grad")
    _close_per_tensor({n: p.grad.double() for n, p in tm.named_parameters()}, g_ref,
                      1e-3 if k == 1 else 5e-3, "port f32 grad")
