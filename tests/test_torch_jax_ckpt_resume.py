"""A JAX run directory resumed and warm-started by the port, on the CPU: the
crater YOLO11n (full width) that the JAX package saved with ``save_epoch``
after one update (EMA on, moments non-zero), as per-leaf orbax, ``flat_opt``
orbax and the npz fallback.

Everything here is exact, after the layout permute (HWIO -> OIHW):

* ``CheckpointManager.try_resume`` restores the weights, BN statistics,
  EMA, both moments, the count, the step, the start epoch (the JAX epoch +
  1) and the bests (null in the meta: the "never set" sentinels), into a
  per-leaf or a ``flat_opt`` port state, from each form;
* ``Trainer(pretrained=<jax dir>)`` loads every parameter leaf (best, else
  last);
* ``Trainer.fit(resume=True)`` on a copy of the JAX run directory starts at
  the JAX epoch + 1 with the JAX state and early-stopping counters, trains
  the epochs left and writes the port's own ``last.pt`` beside the JAX
  files, which the next resume reads first.

One port train step from a resumed JAX state against one JAX step is
``tests/test_torch_train_step.py::test_step_after_resume_from_jax_matches_jax``.
"""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

from tests.test_torch_trainer import _make_trainer
from yolo_scratch_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state, ema_as_tree
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

EPOCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(seed=0):
    return build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=seed)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """{form: run dir} and the JAX state they hold ("flat" a ``flat_opt``
    state from the same weights and gradients), with patience counters in
    the meta, as the JAX Trainer writes them."""
    root = tmp_path_factory.mktemp("jax_resume")
    params, stats = convert_reference_state_dict(_port_model(seed=5).state_dict())
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32),
                                   params)
    states = {}
    for flat in (False, True):
        state = jax_state(SimpleNamespace(init=lambda *a, **k: variables), None, None,
                          jax_optimizer(1e-3), use_ema=True, flat_opt=flat)
        states[flat] = jax.device_get(jax.jit(type(state).apply_gradients)(state, grads))
    dirs = {"leaf": (root / "leaf", True, False), "npz": (root / "npz", False, False),
            "flat": (root / "flat", True, True)}
    for d, use_orbax, flat in dirs.values():
        mgr = JaxCheckpointManager(str(d), use_orbax=use_orbax, async_save=False)
        mgr.save_epoch(states[flat], EPOCH, {"loss": 2.0}, {"loss": 1.5, "mAP50": 0.375},
                       float("inf"), 0.0, extra_meta={"patience": {"since_improve": 2,
                                                                  "best": 0.5}})
        mgr.wait()
    return {k: v[0] for k, v in dirs.items()}, {k: states[v[2]] for k, v in dirs.items()}


def _expected(state):
    """The JAX state as port tensors by name (a ``flat_opt`` state's vectors
    split by the JAX package's own ``ravel_pytree``)."""
    adam = state.opt_state[1][0]
    trees = (state.ema_params, adam.mu, adam.nu)
    if not isinstance(state.ema_params, dict):
        unravel = ravel_pytree(state.params)[1]
        trees = [jax.device_get(unravel(t)) for t in trees]
    return (state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats}),
            *(state_dict_from_jax({"params": t}) for t in trees))


@pytest.mark.parametrize("form", ["leaf", "flat", "npz"])
@pytest.mark.parametrize("port_flat", [False, True], ids=["port_per_leaf", "port_flat"])
def test_try_resume_restores_the_jax_state_exactly(jax_run, form, port_flat):
    dirs, states = jax_run
    state = states[form]
    model = _port_model(seed=9)
    ts = create_train_state(model, make_optimizer(), use_ema=True, flat_opt=port_flat)
    ts, start, best_loss, best_map50 = CheckpointManager(str(dirs[form])).try_resume(ts)
    meta = json.loads((dirs[form] / "last.meta.json").read_text())
    assert meta["best_loss"] is None  # inf, written as null
    assert (start, best_loss, best_map50) == (EPOCH + 1, float("inf"), meta["best_mAP50"])
    assert ts.step == 1 and ts.opt_state.count == 1
    weights, ema, mu, nu = _expected(state)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in weights.items())
    names = [n for n, _ in model.named_parameters()]
    for n, m, v in zip(names, ts.per_param(ts.opt_state.mu), ts.per_param(ts.opt_state.nu)):
        assert torch.equal(m, mu[n]) and torch.equal(v, nu[n]), n
        assert torch.equal(ema_as_tree(ts)[n], ema[n]), n


@pytest.mark.parametrize("form", ["leaf", "npz"])
def test_pretrained_jax_dir_loads_every_parameter(jax_run, tmp_path, form, capsys):
    dirs, states = jax_run
    state = states[form]
    tr = _make_trainer(tmp_path, epochs=1, use_ckpt=False, pretrained=str(dirs[form]))
    weights = _expected(state)[0]
    sd = tr.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in weights.items() if "num_batches" not in k)
    n = sum(1 for _ in tr.model.named_parameters())
    assert f"(all {n} parameters)" in capsys.readouterr().out


def test_fit_resumes_a_copied_jax_run_directory(jax_run, tmp_path):
    dirs, states = jax_run
    state = states["leaf"]
    shutil.copytree(dirs["leaf"], tmp_path / "run")
    tr = _make_trainer(tmp_path, epochs=EPOCH + 2, use_ema=True, patience=5)
    assert tr.resume() and tr.start_epoch == EPOCH + 1
    assert (tr.since_improve, tr.patience_best) == (2, 0.5)
    assert tr.state.step == 1 and tr.state.opt_state.count == 1
    weights = _expected(state)[0]
    sd = tr.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in weights.items())
    result = tr.fit(resume=True)
    assert [h["epoch"] for h in result["history"]] == [EPOCH + 1]
    assert tr.state.step == 3  # 8 images at batch 4: two steps
    meta = json.loads((tmp_path / "run" / "last.meta.json").read_text())
    assert meta["epoch"] == EPOCH + 1 and (tmp_path / "run" / "last.pt").exists()
    again = _make_trainer(tmp_path, epochs=EPOCH + 3, use_ema=True)
    assert again.resume() and again.start_epoch == EPOCH + 2 and again.state.step == 3
