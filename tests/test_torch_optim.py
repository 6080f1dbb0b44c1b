"""Port optimizer and train state (yolo_scratch_tpu_torch.train.optim,
train.state) vs optax and the JAX package's ``TrainState``.

Stated tolerances:

* ``cosine_epoch_schedule``: every step's LR equal, bit for bit, to the JAX
  schedule's (jitted on the CPU), over a 10-epoch x 5-step run and two
  longer ones.
* ``clip_by_global_norm``: gradients under the norm pass through exactly;
  clipped ones equal optax's ``rtol = 1e-6`` (the norm's sum runs in
  another order).
* clip + AdamW: three updates of a random tree (the first clipped, the
  second not, the third clipped) against ``optax.chain(clip_by_global_norm,
  adamw)`` from ``make_optimizer`` with the LR schedule: parameters and
  both moments ``rtol = 1e-6`` with ``atol = 1e-6 * max|ref|`` per tensor
  (an entry near 0 moved by about ±lr is rounded 1 ulp apart, the two
  sides dividing by the bias corrections in other orders), the count equal;
  on this tree and on one with a leaf of YOLOX-s's 2.36M-element 3x3 conv,
  past the 2**20 elements above which ``global_norm`` norms in chunks (its
  norm within ``rtol = 1e-6`` of ``optax.global_norm``).
* EMA: three ``apply_gradients`` against the JAX ``TrainState``'s:
  parameters and EMA at the same tolerance, the step equal.
* Weight decay reaches BN scales and biases: with zero gradients an update
  is ``-lr * wd * p`` on every parameter, ``rtol = 1e-6``.
* Adam's bias corrections equal optax's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.train import optim as joptim
from yolo_scratch_tpu.train.state import TrainState as JTrainState
from yolo_scratch_tpu_torch.nn.modules import ConvBNAct
from yolo_scratch_tpu_torch.train import optim as toptim
from yolo_scratch_tpu_torch.train.state import create_train_state

SHAPES = {"conv": (8, 4, 3, 3), "bn_w": (8,), "bn_b": (8,), "head": (5, 8, 1, 1)}
LONG = {"conv": (512, 512, 3, 3), "bn_w": (512,), "head": (5, 512, 1, 1)}  # YOLOX-s's conv


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lr,epochs,spe", [(1e-3, 10, 5), (1e-3, 150, 4), (1e-2, 300, 7)])
def test_schedule_equals_jax_bit_for_bit(lr, epochs, spe):
    steps = np.arange(epochs * spe + 3)
    ref = np.asarray(jax.jit(jax.vmap(joptim.cosine_epoch_schedule(lr, epochs, spe)))(
        jnp.asarray(steps, jnp.int32)))
    sched = toptim.cosine_epoch_schedule(lr, epochs, spe)
    got = np.array([sched(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, ref)


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(), err_msg=what)


def _tree(rng, scale, shapes=SHAPES):
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


def _torch_list(tree):
    return [torch.from_numpy(v.copy()) for v in tree.values()]


@pytest.mark.parametrize("scale,clipped", [(0.01, False), (10.0, True)])
def test_clip_by_global_norm_matches_optax(scale, clipped):
    g = _tree(np.random.RandomState(1), scale)
    ref, _ = joptim.optax.clip_by_global_norm(10.0).update(g, None)
    got = toptim.clip_by_global_norm(_torch_list(g), 10.0)
    norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
    assert (norm > 10.0) == clipped
    for k, t in zip(SHAPES, got):
        if clipped:
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), rtol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), g[k])  # passed through untouched


GRAD_SCALES = (10.0, 0.01, 3.0)  # global norms ~ 185 (clipped), 0.19, 56 (clipped)


def _grads(i, shapes=SHAPES):
    return _tree(np.random.RandomState(10 + i), GRAD_SCALES[i], shapes)


def test_clip_adamw_matches_optax():
    _clip_adamw_against_optax(SHAPES)


def test_clip_adamw_matches_optax_with_a_long_leaf():
    _clip_adamw_against_optax(LONG)


def _clip_adamw_against_optax(shapes):
    sched_args = (1e-3, 4, 1)  # one step an epoch: warmup LRs that differ each update
    tx = joptim.make_optimizer(joptim.cosine_epoch_schedule(*sched_args))
    params = _tree(np.random.RandomState(0), 0.5, shapes)
    opt_state = tx.init(params)

    port = toptim.make_optimizer(toptim.cosine_epoch_schedule(*sched_args))
    tparams = _torch_list(params)
    state = port.init(tparams)
    update = jax.jit(tx.update)
    for i in range(3):
        g = _grads(i, shapes)
        np.testing.assert_allclose(float(toptim.global_norm(_torch_list(g))),
                                   float(joptim.optax.global_norm(g)), rtol=1e-6)
        upd, opt_state = update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, upd)
        port.update(_torch_list(g), state, tparams)
        adam = opt_state[1][0]
        assert state.count == int(adam.count) == i + 1
        for j, k in enumerate(shapes):
            _close(tparams[j].numpy(), params[k], k)
            _close(state.mu[j].numpy(), adam.mu[k], f"mu {k}")
            _close(state.nu[j].numpy(), adam.nu[k], f"nu {k}")


class _Params(torch.nn.Module):
    """A module whose parameters are the test tree, in ``SHAPES`` order."""

    def __init__(self, tree):
        super().__init__()
        for k in SHAPES:
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(tree[k].copy())))


def test_ema_matches_jax_train_state():
    tree = _tree(np.random.RandomState(0), 0.5)
    tx = joptim.make_optimizer(1e-2)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=tree, batch_stats={},
                         opt_state=tx.init(tree), tx=tx,
                         ema_params=jax.tree_util.tree_map(np.copy, tree), ema_tau=3.0)
    model = _Params(tree)
    state = create_train_state(model, toptim.make_optimizer(1e-2), use_ema=True, ema_tau=3.0)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for i in range(3):
        g = _grads(i)
        jstate = apply(jstate, g)
        state.apply_gradients(_torch_list(g))
        assert state.step == int(jstate.step) == i + 1
        for k in SHAPES:
            _close(getattr(model, k).detach().numpy(), jstate.params[k], k)
            _close(state.ema[k].numpy(), jstate.ema_params[k], f"ema {k}")


def test_weight_decay_reaches_bn_scale_and_bias():
    block = ConvBNAct(4, 8, 3)
    with torch.no_grad():
        block.bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        block.bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in block.named_parameters()}
    assert {"bn.weight", "bn.bias"} <= set(before)
    state = create_train_state(block, toptim.make_optimizer(1e-2, weight_decay=0.1))
    state.apply_gradients([torch.zeros_like(p) for p in block.parameters()])
    for n, p in block.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), (before[n] * (1 - 1e-2 * 0.1)).numpy(),
                                   rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_corrections_equal_optax_bit_for_bit(decay):
    """``1 - decay**count`` as optax's ``scale_by_adam`` takes it (f32
    throughout), over 20,000 counts. Rounding the f64 value once, as the
    port did before, lies up to 2e-5 from it at decay 0.999."""
    counts = np.arange(1, 20001, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(lambda c: 1 - decay ** c))(jnp.asarray(counts)))
    got = np.array([toptim.bias_correction(decay, int(c)) for c in counts], np.float32)
    np.testing.assert_array_equal(got, ref)
