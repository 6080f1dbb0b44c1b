"""The port's checkpoints across the two optimizer forms, and their
background writes (``train/checkpoints.py``).

* A checkpoint of a ``flat_opt`` state resumes into a per-leaf state, and
  the reverse, and so does one of a per-leaf state under
  ``make_optimizer(flatten=True)`` (its (N,) moments), into either form and
  back: weights, BN buffers, EMA, both moments, the count and the step
  exactly equal. (The JAX package restores the weights and the EMA
  across forms but restarts the moments, with a warning:
  ``tests/test_checkpoint_guard.py::test_resume_opt_drift_salvages``.)
* The saved tree is the state at the ``save_epoch`` call even when the live
  tensors change before a slowed writer runs.
* ``wait()`` re-raises a failed write, once.
* ``load_meta``, ``load_raw`` and ``try_resume`` wait for a pending write,
  and so does another manager of the same directory.
* ``Trainer.fit`` leaves whole ``last``/``best`` files and no ``.tmp`` when it
  returns and when it raises.
* ``async_save=False`` writes before ``save_epoch`` returns, on the
  caller's thread.
"""

import threading
import time

import numpy as np
import pytest
import torch

from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state, ema_as_tree
from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(form, seed=0, steps=0):
    """A state of ``form``: "leaf" (per-leaf), "flat_opt" (one master vector)
    or "flatten" (per-leaf parameters, ``FlatAdamW``'s (N,) moments)."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=seed)
    state = create_train_state(model, make_optimizer(1e-3, flatten=form == "flatten"),
                               use_ema=True, ema_tau=3.0, flat_opt=form == "flat_opt")
    for i in range(steps):
        rng = np.random.RandomState(i)
        state.apply_gradients([torch.from_numpy((rng.randn(*p.shape) * 1e-3).astype(np.float32))
                               for p in model.parameters()])
    return state


def _tensors(state):
    """Every tensor a resume restores, by a key of its own."""
    names = [n for n, _ in state.model.named_parameters()]
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema/{k}": v for k, v in ema_as_tree(state).items()})
    for kind in ("mu", "nu"):
        vals = state.per_param(getattr(state.opt_state, kind))
        out.update({f"{kind}/{n}": v for n, v in zip(names, vals)})
    return out


@pytest.fixture
def slow_save(monkeypatch):
    """``torch.save`` that sleeps first, and records the thread it ran on."""
    real, threads = torch.save, []

    def slow(obj, f):
        threads.append(threading.current_thread())
        time.sleep(0.3)
        real(obj, f)

    monkeypatch.setattr(torch, "save", slow)
    return threads


@pytest.mark.parametrize("save_form,load_form", [
    ("flat_opt", "leaf"), ("leaf", "flat_opt"), ("flatten", "leaf"), ("flatten", "flat_opt"),
    ("leaf", "flatten")])
def test_resume_across_forms_restores_weights_ema_and_moments(tmp_path, save_form, load_form):
    src = _state(save_form, steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(src, 0, {}, {"loss": 1.0}, float("inf"), 0.0)
    raw = mgr.load_raw("last")
    for kind in ("mu", "nu"):  # one entry a parameter, of its shape, whatever the form
        assert {n: tuple(t.shape) for n, t in raw["opt_state"][kind].items()} == {
            n: tuple(p.shape) for n, p in src.model.named_parameters()}
    dst = _state(load_form, seed=1)
    dst, start, _, _ = CheckpointManager(str(tmp_path)).try_resume(dst)
    assert (start, dst.step, dst.opt_state.count) == (1, 2, 2)
    got, want = _tensors(dst), _tensors(src)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if load_form == "flat_opt":  # the restored values landed in the master vector
        for view, p in zip(dst.views(dst.flat), src.model.parameters()):
            assert torch.equal(view, p.detach())
        dst.apply_gradients([torch.zeros_like(p) for p in dst.model.parameters()])


def test_snapshot_is_the_state_at_the_call(tmp_path, slow_save):
    state = _state("flat_opt", steps=1)
    before = {k: v.clone() for k, v in _tensors(state).items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 0, {}, {"loss": 1.0}, float("inf"), 0.0)
    with torch.no_grad():  # the next step's in-place updates, before the write
        state.flat.mul_(2.0)
        state.ema.add_(1.0)
        state.opt_state.mu[0].add_(1.0)
    raw = mgr.load_raw("last")
    for k, v in before.items():
        kind, name = k.split("/", 1)
        saved = raw[kind][name] if kind in ("model", "ema") else raw["opt_state"][kind][name]
        assert torch.equal(saved, v), k
    assert not torch.equal(raw["ema"]["model.0.conv.weight"],
                           ema_as_tree(state)["model.0.conv.weight"])


def test_wait_reraises_a_failed_write(tmp_path, monkeypatch):
    def fail(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(_state("leaf"), 0, {}, {"loss": 1.0}, float("inf"), 0.0)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once; nothing pending after
    assert not list(tmp_path.glob("last.*"))


@pytest.mark.parametrize("reader", ["load_meta", "load_raw", "try_resume", "another manager"])
def test_readers_wait_for_the_pending_write(tmp_path, slow_save, reader):
    state = _state("leaf")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 4, {}, {"loss": 1.0}, float("inf"), 0.0)
    assert mgr._thread.is_alive()  # the slowed writer is still sleeping
    if reader == "load_meta":
        assert mgr.load_meta("last")["epoch"] == 4
    elif reader == "load_raw":
        assert mgr.load_raw("last")["step"] == 0
    elif reader == "another manager":  # a deploy CLI's own manager of the directory
        assert CheckpointManager(str(tmp_path)).load_raw("last")["step"] == 0
        mgr.wait()
    else:
        assert mgr.try_resume(_state("leaf", seed=1))[1] == 5
    assert mgr._thread is None and slow_save[0] is not threading.current_thread()


def _trainer(tmp_path, epochs):
    ds = SyntheticDataset(n=4, img_size=64)
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    cfg = TrainerConfig(epochs=epochs, save_dir=str(tmp_path), use_ema=True)
    trainer = Trainer(model, Loader(ds, 4, max_gt=8, prefetch=0), None, cfg)
    # the loop's own work is not under test here: only its checkpoint writes
    trainer.train_epoch = lambda epoch: {"loss": 1.0}
    trainer.validate = lambda: {"loss": 0.5}  # best in epoch 0 only
    return trainer


@pytest.mark.parametrize("raises", [False, True])
def test_fit_leaves_whole_files_and_no_tmp(tmp_path, slow_save, raises):
    trainer = _trainer(tmp_path, epochs=2)
    if raises:
        def train_epoch(epoch):
            if epoch == 1:  # epoch 0's write is still pending
                assert trainer.ckpt._thread.is_alive()
                raise RuntimeError("step failed")
            return {"loss": 1.0}

        trainer.train_epoch = train_epoch
        with pytest.raises(RuntimeError, match="step failed"):
            trainer.fit(resume=False)
    else:
        trainer.fit(resume=False)
    assert trainer.ckpt._thread is None
    assert not list(tmp_path.glob("*.tmp"))
    names = {"last.pt", "last.meta.json", "best.pt", "best.meta.json"}
    assert names <= {p.name for p in tmp_path.iterdir()}
    meta = CheckpointManager(str(tmp_path)).load_meta("last")
    assert meta["epoch"] == (0 if raises else 1)
    raw = CheckpointManager(str(tmp_path)).load_raw("last")
    assert set(raw) == {"model", "opt_state", "ema", "step"}


def test_async_save_false_writes_before_returning(tmp_path, slow_save):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save_epoch(_state("leaf"), 0, {}, {"loss": 1.0}, float("inf"), 0.0)
    assert (tmp_path / "last.pt").exists() and (tmp_path / "best.meta.json").exists()
    assert mgr._thread is None and mgr._pending is False
    assert all(t is threading.current_thread() for t in slow_save) and len(slow_save) == 2
