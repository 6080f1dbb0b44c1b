"""Port train step with ``grad_accum=2`` vs the JAX package's, from the
same state. Crater YOLO11n at
64 px, B=4, the JAX initial weights carried across (as in
``test_torch_train_step.py``, whose helpers this file uses).

Stated tolerances:

* ``grad_accum=2`` (the strided split, BN statistics updated once per
  microbatch, gradients and metrics averaged): the loss and its triplet
  ``rtol = 1e-4``; Adam's first moment within ``3e-2 * max|ref|`` per
  tensor and the second within ``6e-2 * max|ref|``; BN running variances
  ``rtol = 5e-4``, running means within ``1e-4`` absolute; parameters
  and EMA within ``lr * |u_port - u_jax| + 1e-6`` (``u``: the Adam
  direction each side's moments give); the counts equal. Looser than the
  plain step's because each microbatch holds 2 images (8 values a channel
  in the P5 blocks' BN): the JAX package's f32 mean gradient lies 1.5e-2
  of max|ref| from the precise one, the port's 2.5e-3
  (``test_torch_train_step_f64.py`` measures both against the JAX network
  in float64, and holds the port's float64 ``grad_accum=2`` step to that
  reference at 1e-5 of max|g|); the loss agrees to 1.5e-5.

The bf16 step is held in ``test_torch_train_bf16.py``.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_train_step import (
    B,
    IMG,
    JAX_CFG,
    LOSS_KEYS,
    _params_sd,
    _port_state,
    _sd,
    jax_schedule_args,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)
from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig as JLossConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.train.optim import cosine_epoch_schedule as jax_schedule
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.train.steps import build_train_step_custom as jax_step
from yolo_scratch_tpu.train.steps import v8_loss_adapter as jax_adapter
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    tx = jax_optimizer(jax_schedule(**jax_schedule_args()))
    state = jax_state(jm, jax.random.PRNGKey(0), np.zeros((1, IMG, IMG, 1), np.float32), tx,
                      use_ema=True)
    batch = next(iter(Loader(SyntheticDataset(n=8, img_size=IMG), B, max_gt=8, prefetch=0)))
    return jm, state, batch, jax_adapter(JLossConfig(nc=5, strides=jm.strides))


def _port_run(state, batch, **kw):
    tm, ts = _port_state(state)
    step = build_train_step_custom(
        tm, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides)),
        matmul_precision="highest", **kw)
    lr = ts.tx.lr(ts.opt_state.count)
    ts, metrics = step(ts, batch)
    return tm, ts, metrics, lr


def _close_per_tensor(got, ref, tol, what):
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        scale = max(float(r.abs().max()), floor)
        err = float((got[k] - r).abs().max())
        assert err <= tol * scale, f"{what} {k}: {err:.3g} > {tol} * {scale:.3g}"


def test_grad_accum_two_matches_jax(setup):
    jm, state, batch, loss_fn = setup
    j_next, j_metrics = jax.jit(jax_step(jm, loss_fn, grad_accum=2,
                                         matmul_precision="highest"))(state, batch)
    tm, ts, metrics, lr = _port_run(state, batch, grad_accum=2)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)
    adam = j_next.opt_state[1][0]
    assert ts.step == int(j_next.step) == 1 and ts.opt_state.count == int(adam.count)
    names = [n for n, _ in tm.named_parameters()]
    mu, nu = dict(zip(names, ts.opt_state.mu)), dict(zip(names, ts.opt_state.nu))
    mu_ref, nu_ref = _params_sd(adam.mu), _params_sd(adam.nu)
    _close_per_tensor(mu, mu_ref, 3e-2, "mu")
    _close_per_tensor(nu, nu_ref, 6e-2, "nu")
    ref = _sd({"params": j_next.params, "batch_stats": j_next.batch_stats})
    sd = tm.state_dict()
    for k, r in ref.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=5e-4, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=0, atol=1e-4, err_msg=k)

    def direction(m, v, c=ts.opt_state.count):
        return (m / (1 - 0.9 ** c)) / ((v / (1 - 0.999 ** c)).sqrt() + 1e-8)

    ema_ref = _params_sd(j_next.ema_params)
    for n, p in tm.named_parameters():
        bound = lr * (direction(mu[n], nu[n]) - direction(mu_ref[n], nu_ref[n])).abs() + 1e-6
        assert bool(((p.detach() - ref[n]).abs() <= bound).all()), n
        assert bool(((ts.ema[n] - ema_ref[n]).abs() <= bound).all()), n


def test_grad_accum_splits_strided_and_updates_bn_per_microbatch(setup):
    """The step's own pieces: microbatch i is rows i, i+k, ...; two
    microbatch forwards move the BN statistics twice (momentum applied
    twice), and the gradient is the mean of the two microbatches'."""
    _, state, batch, _ = setup
    tm, ts = _port_state(state)
    step = build_train_step_custom(
        tm, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides)), grad_accum=2)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = step.grads(b)
    got = {n: p.grad.clone() for n, p in tm.named_parameters()}
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}

    tm2, _ = _port_state(state)
    one = build_train_step_custom(
        tm2, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm2.strides)))
    sums, losses = None, []
    for i in range(2):
        l_i, _ = one.grads({k: v[i::2] for k, v in b.items()})
        losses.append(l_i)
        g = {n: p.grad.clone() for n, p in tm2.named_parameters()}
        sums = g if sums is None else {n: sums[n] + g[n] for n in g}
    assert float(loss) == float((losses[0] + losses[1]) * 0.5)
    for n in got:
        assert torch.equal(got[n], sums[n] * 0.5), n
    for k, v in tm2.state_dict().items():
        if "running" in k:
            assert torch.equal(stats[k], v), k
