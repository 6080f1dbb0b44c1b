"""The port's reader on checkpoints that the JAX package writes at run time
at full width: the crater YOLO11n ``save_epoch`` tree (3.07M parameters, EMA
on, per-leaf and ``flat_opt``), its npz fallback, and a YOLOX-nano tree.

The states take one ``TrainState.apply_gradients`` of seeded gradients (the
JAX package's clip + AdamW + EMA update) before the save, so that the
moments, the count, the step and the EMA hold non-zero values. Everything
here is exact:

* ``read_orbax`` against ``orbax.checkpoint.StandardCheckpointer().restore``
  on the same directory: every leaf's dtype, shape and bytes, per-leaf and
  ``flat_opt``; the npz fallback (``CheckpointManager(use_orbax=False)``)
  gives the same tree as the orbax directory;
* ``port_tree_from_jax``: the weights and BN statistics are
  ``state_dict_from_jax`` of the JAX tree, the EMA and both moments the same
  map of theirs (a ``flat_opt`` vector split as ``ravel_pytree`` splits it),
  under the port model's parameter names; count and step as ints;
* a YOLOX tree maps with no unhandled leaf: the port builds the YOLOX the
  tree describes, loads every key, and resumes its EMA and moments;
* a corrupt data file or chunk raises an error that names the file and the
  array.
"""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp
from jax.flatten_util import ravel_pytree

from tests.test_torch_jax_ckpt import digests, normalise
from tests.test_torch_yolox import jax_variables
from yolo_scratch_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.jax_checkpoints import (
    port_tree_from_jax,
    read_jax_npz,
    read_orbax,
)
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state, ema_as_tree
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_saved_state(variables, save_dirs, flat=False, seed=0):
    """A JAX train state from ``variables`` after one update of seeded
    gradients, saved by the JAX package's ``save_epoch`` into each of
    ``save_dirs`` (``{dir: use_orbax}``). Returns the state."""
    initialised = SimpleNamespace(init=lambda *args, **kw: variables)
    state = jax_state(initialised, None, None, jax_optimizer(1e-3), use_ema=True, flat_opt=flat)
    rng = np.random.RandomState(seed)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32), state.params)
    state = jax.jit(type(state).apply_gradients)(state, grads)
    for d, use_orbax in save_dirs.items():
        mgr = JaxCheckpointManager(str(d), use_orbax=use_orbax, async_save=False)
        mgr.save_epoch(state, 2, {"loss": 1.5}, {"loss": 1.25, "mAP50": 0.5}, float("inf"), 0.0)
        mgr.wait()
    return jax.device_get(state)


def _port_model():
    return build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{form: (run dir, JAX state)} for the crater YOLO11n: "leaf" and "npz"
    hold one per-leaf state, "flat" a ``flat_opt`` one. The initial weights
    are the port's seeded init carried to the JAX tree (a flax init of the
    model compiles for ~15 s here)."""
    root = tmp_path_factory.mktemp("jax_full")
    params, stats = convert_reference_state_dict(_port_model().state_dict())
    variables = {"params": params, "batch_stats": stats}
    leaf = jax_saved_state(variables, {root / "leaf": True, root / "npz": False})
    flat = jax_saved_state(variables, {root / "flat": True}, flat=True, seed=1)
    return {"leaf": (root / "leaf", leaf), "npz": (root / "npz", leaf),
            "flat": (root / "flat", flat)}


@pytest.mark.parametrize("form", ["leaf", "flat"])
def test_read_orbax_equals_orbax_restore(runs, form):
    d, _ = runs[form]
    want = normalise(ocp.StandardCheckpointer().restore(d / "last"))
    got = read_orbax(d / "last")
    assert digests(got) == digests(want)
    # the same leaves in the same nesting, and non-zero where it matters
    adam = got["opt_state"][1][0]
    assert int(adam["count"]) == 1 and int(got["step"]) == 1
    assert got["opt_state"][0] is None and got["opt_state"][1][1] is None
    flat_mu = ravel_pytree(adam["mu"])[0]
    assert np.count_nonzero(flat_mu) > 0.99 * flat_mu.size
    assert got["params"]["model_0"]["conv"]["kernel"].shape == (3, 3, 1, 16)
    n = sum(x.size for x in jax.tree_util.tree_leaves(got["params"]))
    assert n > 2_500_000
    if form == "flat":
        assert got["ema_params"].shape == adam["mu"].shape == adam["nu"].shape == (n,)


def test_npz_fallback_gives_the_same_tree(runs):
    d_npz, _ = runs["npz"]
    d_leaf, _ = runs["leaf"]
    assert not (d_npz / "last").exists() and (d_npz / "last.treedef.json").exists()
    assert digests(read_jax_npz(d_npz / "last.npz")) == digests(read_orbax(d_leaf / "last"))


@pytest.mark.parametrize("form", ["leaf", "flat", "npz"])
def test_port_tree_maps_every_leaf(runs, form):
    d, state = runs[form]
    tree = CheckpointManager(str(d)).load_raw("last")
    model = _port_model()
    assert tree.keys() == {"model", "opt_state", "ema", "step"}
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in tree["model"].items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    want = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
    assert all(torch.equal(tree["model"][k], want[k]) for k in want)
    adam = state.opt_state[1][0]
    if form == "flat":  # the JAX package's own split of its flat vectors
        unravel = ravel_pytree(state.params)[1]
        mu, nu, ema = (jax.device_get(unravel(v)) for v in (adam.mu, adam.nu, state.ema_params))
    else:
        mu, nu, ema = adam.mu, adam.nu, state.ema_params
    names = [n for n, _ in model.named_parameters()]
    for key, got, ref in (("mu", tree["opt_state"]["mu"], mu),
                          ("nu", tree["opt_state"]["nu"], nu), ("ema", tree["ema"], ema)):
        ref = state_dict_from_jax({"params": ref})
        assert list(got) == list(ref) and sorted(got) == sorted(names), key
        assert all(torch.equal(got[k], ref[k]) for k in ref), key
    assert tree["opt_state"]["count"] == 1 and tree["step"] == 1
    assert port_tree_from_jax(read_orbax(d / "last") if form != "npz"
                              else read_jax_npz(d / "last.npz"))["step"] == 1


def test_flat_vector_of_another_model_raises(runs):
    other = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="s")
    ts = create_train_state(other, make_optimizer(), use_ema=True, flat_opt=True)
    with pytest.raises(ValueError, match="params do not match the model being restored"):
        CheckpointManager(str(runs["flat"][0])).try_resume(ts)
    raw = read_orbax(runs["flat"][0] / "last")
    raw["ema_params"] = raw["ema_params"][:-1]
    with pytest.raises(ValueError, match="ema_params: flat vector of shape"):
        port_tree_from_jax(raw)


def test_yolox_tree_maps_with_no_unhandled_leaf(tmp_path):
    state = jax_saved_state(jax_variables(build_yolox("nano", nc=3, ch=3).state_dict()),
                            {tmp_path / "yx": True})
    model = infer.load_deploy_model(ckpt=tmp_path / "yx", which="last", device="cpu")
    assert type(model).__name__ == "YOLOXModel" and (model.in_ch, model.nc) == (3, 3)
    want = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
    sd = model.state_dict()
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    ts = create_train_state(model, make_optimizer(), use_ema=True)
    ts, start, _, _ = CheckpointManager(str(tmp_path / "yx")).try_resume(ts)
    ema = state_dict_from_jax({"params": state.ema_params})
    nu = state_dict_from_jax({"params": state.opt_state[1][0].nu})
    assert start == 3 and ts.step == 1 and ts.opt_state.count == 1
    for (n, _), v in zip(model.named_parameters(), ts.opt_state.nu):
        assert torch.equal(v, nu[n]) and torch.equal(ema_as_tree(ts)[n], ema[n]), n


def test_corrupt_checkpoint_names_the_file_and_the_array(runs, tmp_path):
    d = tmp_path / "bad"
    shutil.copytree(runs["leaf"][0], d)
    data = sorted((d / "last" / "ocdbt.process_0" / "d").iterdir(),
                  key=lambda f: f.stat().st_size)[-1]
    raw = data.read_bytes()
    data.write_bytes(raw.replace(b"\x28\xb5\x2f\xfd", b"\x00\xb5\x2f\xfd"))  # every frame
    with pytest.raises(ValueError, match=r"array '[\w.]+': chunk '[\w.]+/[\d.]+': not a zstd"):
        CheckpointManager(str(d)).load_raw("last")
    data.write_bytes(raw[:100])
    with pytest.raises(ValueError, match=data.name + r".*\(value of '[\w.]+/[\d.]+'\)"):
        CheckpointManager(str(d)).load_raw("last")
