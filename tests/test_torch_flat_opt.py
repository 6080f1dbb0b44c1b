"""The port's flat update vector (``create_train_state(..., flat_opt=True)``,
``make_optimizer(flatten=True)``) against its per-leaf form and the JAX
package's ``TrainState.flat_opt`` / ``optax.flatten``.

Crater YOLO11n (64 px, f32) unless a test says otherwise. Stated
tolerances:

* flat against per-leaf, three ``apply_gradients`` of the same seeded
  gradients (the second step clipped): parameters, EMA and both moments
  ``rtol = 1e-6``, ``atol = 1e-7``, as ``tests/test_flat_opt.py`` holds the
  JAX forms to each other (the only reorder is the global norm's sum).
* the port's flat state against JAX's ``flat_opt=True`` state from the same
  bridged weights and the same numpy-seeded gradients: parameters and EMA
  ``rtol = 1e-6`` with ``atol = 1e-6 * max|ref|`` per tensor, as
  ``test_torch_optim.py`` holds the per-leaf forms to optax.
* ``make_optimizer(flatten=True)``: (N,) moments; its update of a
  per-leaf tree against ``optax.flatten`` of the chain at the same
  tolerance.
* one ``TrainStep`` of a 64 px YOLO11n (B=4), flat against per-leaf, plain,
  ``grad_accum=2`` and bf16 autocast: the loss and BN statistics exactly
  equal (the forward and backward see the same values), parameters, EMA
  and moments ``rtol = 1e-6``, ``atol = 1e-7``.
* the layout: every parameter 256-byte aligned in the flat vectors, whose
  gaps stay 0 through the updates.
* the aliasing: a parameter changed in place through the model is the flat
  vector's change, bit for bit; a rebound parameter makes the next update
  raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.train import optim as joptim
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.train.state import ema_as_tree as jax_ema_as_tree
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train import optim as toptim
from yolo_scratch_tpu_torch.train.state import create_train_state, ema_as_tree
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

JAX_CFG = "yolo_scratch_tpu/configs/yolo11_crater.yaml"
IMG = 64
GRAD_SCALES = (1e-3, 1e-2, 3e-3)  # global norms ~ 1.8, 17.5 (clipped), 5.3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0):
    return build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=seed)


def _grads(model, step):
    rng = np.random.RandomState(step)
    return [torch.from_numpy((rng.randn(*p.shape) * GRAD_SCALES[step]).astype(np.float32))
            for p in model.parameters()]


def _close(a, b, what, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _state_dicts(state):
    """(params, EMA, mu, nu) by parameter name, as numpy."""
    names = [n for n, _ in state.model.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    ema = {n: t.numpy().copy() for n, t in ema_as_tree(state).items()}
    mu = dict(zip(names, (t.numpy().copy() for t in state.per_param(state.opt_state.mu))))
    nu = dict(zip(names, (t.numpy().copy() for t in state.per_param(state.opt_state.nu))))
    return params, ema, mu, nu


def test_flat_matches_per_leaf_after_three_steps():
    leaf, flat = _model(), _model()
    s_leaf = create_train_state(leaf, toptim.make_optimizer(1e-3), use_ema=True, ema_tau=3.0)
    s_flat = create_train_state(flat, toptim.make_optimizer(1e-3), use_ema=True, ema_tau=3.0,
                                flat_opt=True)
    vectors = (s_flat.flat, s_flat.opt_state.mu[0], s_flat.opt_state.nu[0], s_flat.ema)
    assert len({v.shape for v in vectors}) == 1 and vectors[0].dim() == 1
    assert all(o % 64 == 0 for o in s_flat._offsets)  # 256-byte aligned parameters
    for step in range(3):
        g = _grads(leaf, step)
        s_leaf.apply_gradients(g)
        s_flat.apply_gradients(g)
    assert s_leaf.step == s_flat.step == s_flat.opt_state.count == 3
    gaps = torch.ones_like(s_flat.flat, dtype=torch.bool)
    for v in s_flat.views(gaps):
        v.fill_(False)
    assert int(gaps.sum()) == s_flat.flat.numel() - sum(p.numel() for p in flat.parameters())
    for v in vectors:  # the alignment gaps stay 0
        assert not bool(v[gaps].any())
    for kind, a, b in zip(("param", "ema", "mu", "nu"), _state_dicts(s_leaf),
                          _state_dicts(s_flat)):
        for name in a:
            _close(b[name], a[name], f"{kind} {name}")


def test_flat_matches_jax_flat_opt_on_bridged_weights():
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    jstate = jax_state(jm, jax.random.PRNGKey(0), np.zeros((1, IMG, IMG, 1), np.float32),
                       joptim.make_optimizer(1e-3), use_ema=True, ema_tau=3.0, flat_opt=True)
    model = _model()
    model.load_state_dict(state_dict_from_jax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    state = create_train_state(model, toptim.make_optimizer(1e-3), use_ema=True, ema_tau=3.0,
                               flat_opt=True)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    leaves, treedef = jax.tree_util.tree_flatten(jstate.params)
    for step in range(3):
        rng = np.random.RandomState(100 + step)
        g = [(rng.randn(*leaf.shape) * GRAD_SCALES[step]).astype(np.float32)
             for leaf in leaves]
        jg = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in g])
        jstate = apply(jstate, jg)
        by_name = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(treedef, g)})
        state.apply_gradients([by_name[n] for n, _ in model.named_parameters()])
    assert state.step == int(jstate.step) == 3
    ref_p = state_dict_from_jax({"params": jax.device_get(jstate.params)})
    ref_e = state_dict_from_jax(
        {"params": jax.device_get(jax_ema_as_tree(jstate.ema_params, jstate.params))})
    ema = ema_as_tree(state)
    for name, p in model.named_parameters():
        for got, want, what in ((p.detach(), ref_p[name], "param"), (ema[name], ref_e[name],
                                                                      "ema")):
            want = want.numpy()
            _close(got.numpy(), want, f"{what} {name}", atol=1e-6 * np.abs(want).max())


SHAPES = {"conv": (8, 4, 3, 3), "bn_w": (8,), "bn_b": (8,), "head": (5, 8, 1, 1)}


def test_make_optimizer_flatten_state_and_update_match_optax_flatten():
    rng = np.random.RandomState(0)
    tree = {k: (rng.randn(*s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}
    n = sum(v.size for v in tree.values())
    tx = joptim.make_optimizer(1e-2, flatten=True)
    jst = tx.init(tree)
    port = toptim.make_optimizer(1e-2, flatten=True)
    params = [torch.from_numpy(tree[k].copy()) for k in SHAPES]
    st = port.init(params)
    assert [tuple(t.shape) for t in st.mu + st.nu] == [(n,), (n,)]
    assert np.asarray(jst[1][0].mu).shape == (n,)  # optax.flatten's moments
    update = jax.jit(tx.update)
    for i, scale in enumerate((10.0, 0.01, 3.0)):  # clipped, not, clipped
        g = {k: (np.random.RandomState(10 + i).randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        upd, jst = update(g, jst, tree)
        tree = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), tree, upd)
        port.update([torch.from_numpy(g[k]) for k in SHAPES], st, params)
        assert st.count == i + 1
        for j, k in enumerate(SHAPES):
            _close(params[j].numpy(), tree[k], k, atol=1e-6 * np.abs(tree[k]).max())
    # the JAX package's flat moments ravel in sorted-key order; ours in SHAPES order
    adam = jst[1][0]
    order = sorted(SHAPES)
    offsets = np.cumsum([0] + [tree[k].size for k in order])
    for j, k in enumerate(SHAPES):
        o = offsets[order.index(k)]
        ref = np.asarray(adam.mu)[o:o + tree[k].size]
        got = toptim.unravel(st.mu[0], params)[j].reshape(-1).numpy()
        _close(got, ref, f"mu {k}", atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("grad_accum,bf16", [(1, False), (2, False), (1, True)])
def test_train_step_flat_equals_per_leaf(grad_accum, bf16):
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=IMG), 4, max_gt=8, prefetch=0)))
    out = []
    for flat_opt in (False, True):
        model = _model()
        state = create_train_state(model, toptim.make_optimizer(1e-3), use_ema=True,
                                   ema_tau=3.0, flat_opt=flat_opt)
        step = build_train_step_custom(
            model, v8_loss_adapter(DetectionLossConfig(nc=5, strides=model.strides)),
            compute_dtype=torch.bfloat16 if bf16 else None, grad_accum=grad_accum,
            matmul_precision="highest")
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), {k: b.clone() for k, b in model.named_buffers()},
                    _state_dicts(state)))
    (loss_a, bufs_a, sd_a), (loss_b, bufs_b, sd_b) = out
    assert loss_a == loss_b
    for k in bufs_a:
        assert torch.equal(bufs_a[k], bufs_b[k]), k
    for kind, a, b in zip(("param", "ema", "mu", "nu"), sd_a, sd_b):
        for name in a:
            _close(b[name], a[name], f"{kind} {name}")


def test_flat_vector_sees_parameters_changed_through_the_model():
    model = _model()
    state = create_train_state(model, toptim.make_optimizer(1e-3), flat_opt=True)
    w = model.model[0].conv.weight
    with torch.no_grad():
        w.mul_(2.0)
    assert torch.equal(state.flat[:w.numel()], w.detach().reshape(-1))
    src = _model(seed=1)
    model.load_state_dict(src.state_dict())  # in place: the views hold
    for view, p in zip(state.views(state.flat), src.parameters()):
        assert torch.equal(view, p.detach())
    state.apply_gradients(_grads(model, 0))
    assert torch.equal(state.flat[:w.numel()], w.detach().reshape(-1))


def test_rebound_parameter_makes_the_update_raise():
    model = _model()
    state = create_train_state(model, toptim.make_optimizer(1e-3), flat_opt=True)
    model.model[0].conv.weight.data = model.model[0].conv.weight.detach().clone()
    with pytest.raises(RuntimeError, match="master vector"):
        state.apply_gradients(_grads(model, 0))
