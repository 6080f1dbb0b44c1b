"""Checkpoints: the last/best policy with resume (port of
``train/checkpoints.py``).

``last`` is saved every epoch and ``best`` on improvement, gated on mAP50
when validation reports it, else on val loss. Each is ``<name>.pt``, a
``torch.save`` of tensors, ints and dicts that ``torch.load(...,
weights_only=True)`` reads:

  model      the model's ``state_dict`` (parameters and BN buffers)
  opt_state  ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``
  ema        ``{name: tensor}`` of the EMA parameters, ``{}`` without EMA
  step       the number of updates applied

beside ``<name>.meta.json``: epoch, metrics, bests and any ``extra_meta``,
with non-finite floats written as null (strict JSON). A ``flat_opt`` state
(``train/state.py``) is written in the same layout, its (N,) moments and
EMA as per-parameter slices, and either form resumes from either: weights,
EMA and moments. (The JAX package restarts the moments across forms, its
flat ``opt_state`` being another pytree.)

Writes run in the background by default, as the JAX package's orbax saves
do: ``save_epoch`` copies the state to host memory (on the current stream,
then one sync, so the next step cannot change what is saved) and a thread
writes it, so the write overlaps the next epoch. :meth:`CheckpointManager.wait`
joins it and re-raises its error; the next save, ``try_resume``,
``load_meta`` and ``load_raw`` wait first (for a write to the same directory
by any manager in the process), and ``Trainer.fit`` waits before it
returns or raises. ``async_save=False`` writes before ``save_epoch``
returns.

Under a mesh (``parallel/mesh.py``) rank 0 alone writes, as the JAX
package's ``_is_writer``; every rank meets at a barrier once rank 0's write
has landed (in ``wait``) and reads the same files on resume.

Where ``<name>.pt`` is absent, the JAX package's checkpoint of that name is
read instead (``train/jax_checkpoints.py``, in the port's own code): its
orbax directory ``<name>/`` or its npz fallback, in the layout above, beside
the ``<name>.meta.json`` the JAX package writes in the same form. So a JAX
run directory resumes (weights, EMA, moments, count, step, epoch and bests,
into a per-leaf or ``flat_opt`` state), deploys and evaluates wherever a
directory of the port's is taken. The port writes only ``<name>.pt``.
"""

from __future__ import annotations

import json
import math
import os
import threading
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from yolo_scratch_tpu_torch.parallel.distributed import barrier
from yolo_scratch_tpu_torch.train.jax_checkpoints import read_jax_checkpoint
from yolo_scratch_tpu_torch.train.state import ema_as_tree

def _meta_dumps(meta: Dict[str, Any]) -> str:
    """``json.dumps`` with non-finite floats as null. The stdlib emits
    ``Infinity``/``NaN`` (``best_loss`` is inf on every mAP-gated run),
    which strict JSON parsers reject. Readers treat null as "never set"
    (``try_resume``, the Trainer's patience restore)."""

    def clean(o):
        if isinstance(o, dict):
            return {k: clean(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [clean(v) for v in o]
        if isinstance(o, float) and not math.isfinite(o):
            return None
        return o

    return json.dumps(clean(meta))


def _mismatch(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]) -> Optional[str]:
    """The first key or shape difference between two tensor dicts, or None."""
    for k, v in want.items():
        if k not in got:
            return f"checkpoint lacks {k}"
        if tuple(got[k].shape) != tuple(v.shape):
            return f"{k}: checkpoint {tuple(got[k].shape)} vs model {tuple(v.shape)}"
    for k in got:
        if k not in want:
            return f"checkpoint has extra {k}"
    return None


def check_checkpoint(tree: Mapping[str, Any], model: torch.nn.Module, name: str,
                     ema: bool) -> None:
    """Raise unless the saved ``tree`` fits ``model``: its parameters and BN
    buffers by name and shape, and an EMA when ``ema`` asks for one."""
    buffers = dict(model.named_buffers())
    saved = tree["model"]
    for key, want, got in (
            ("params", dict(model.named_parameters()),
             {k: v for k, v in saved.items() if k not in buffers}),
            ("batch_stats", buffers, {k: v for k, v in saved.items() if k in buffers})):
        mismatch = _mismatch(got, want)
        if mismatch:
            raise ValueError(f"checkpoint '{name}': {key} do not match the model being "
                             f"restored into ({mismatch}). Wrong --model/--cfg/--scale/--nc/--ch "
                             "for this checkpoint?")
    if ema and not tree["ema"]:
        raise ValueError(f"checkpoint '{name}' stores no EMA parameters (trained without "
                         "EMA): drop --ema, or resume without requesting EMA weights.")


def _write_atomic(path: Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


# writes in flight by checkpoint directory, whichever manager started them:
# a reader or writer of a directory in this process joins its write first
_WRITES: Dict[Path, threading.Thread] = {}
_WRITES_LOCK = threading.Lock()


def _join_writes(d: Path) -> None:
    with _WRITES_LOCK:
        t = _WRITES.get(d)
    if t is not None:
        t.join()


def _to_host(tree):
    """A host copy of every tensor in ``tree`` (dicts of tensors, ints and
    floats). Device tensors are copied on the current stream without a sync
    each; the caller syncs once."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.to("cpu", non_blocking=True)
    return tree


class CheckpointManager:
    """Saves ``last`` every epoch and ``best`` on improvement, under
    ``save_dir``; under a ``mesh`` only its rank 0 writes. ``async_save``:
    the write runs in a background thread (the module docstring)."""

    def __init__(self, save_dir: str, mesh=None, async_save: bool = True):
        self.dir = Path(save_dir)
        self._key = self.dir.resolve()
        self.mesh = mesh
        self.async_save = async_save
        self.is_writer = mesh is None or mesh.is_writer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # a save since the last wait (every rank)
        if self.is_writer:
            self.dir.mkdir(parents=True, exist_ok=True)

    def _write(self, jobs) -> None:
        for name, tree, meta in jobs:
            _write_atomic(self.dir / f"{name}.pt", lambda p: torch.save(tree, p))
            _write_atomic(self.dir / f"{name}.meta.json",
                          lambda p: p.write_text(_meta_dumps(meta)))

    def _write_in_thread(self, jobs) -> None:
        try:
            self._write(jobs)
        except BaseException as err:  # re-raised by wait()
            self._error = err

    def wait(self) -> None:
        """Join the pending write and re-raise its error; under a mesh every
        rank then meets at a barrier, so the files are whole for all."""
        if not self._pending:
            return
        self._pending = False
        if self._thread is not None:
            self._thread.join()
            with _WRITES_LOCK:
                if _WRITES.get(self._key) is self._thread:
                    del _WRITES[self._key]
            self._thread = None
        barrier(self.mesh)
        err, self._error = self._error, None
        if err is not None:
            raise err

    @staticmethod
    def _tree(state) -> Dict[str, Any]:
        names = [n for n, _ in state.model.named_parameters()]
        ema = ema_as_tree(state)
        return {
            "model": state.model.state_dict(),
            "opt_state": {"count": state.opt_state.count,
                          "mu": dict(zip(names, state.per_param(state.opt_state.mu))),
                          "nu": dict(zip(names, state.per_param(state.opt_state.nu)))},
            "ema": dict(ema) if ema is not None else {},
            "step": state.step,
        }

    def save_epoch(self, state, epoch: int, train_metrics: Dict[str, float],
                   val_metrics: Dict[str, float], best_loss: float, best_map50: float,
                   extra_meta: Optional[Dict[str, Any]] = None) -> Tuple[float, float, bool]:
        """Save ``last``; maybe save ``best``. Returns (best_loss,
        best_map50, saved_best), decided at the call. ``extra_meta`` is
        merged into the meta json (the Trainer's early-stopping counters)."""
        self.wait()
        _join_writes(self._key)
        meta = {"epoch": epoch, "train_metrics": train_metrics, "val_metrics": val_metrics,
                "best_loss": best_loss, "best_mAP50": best_map50}
        if extra_meta:
            meta.update(extra_meta)
        saved_best = False
        if "mAP50" in val_metrics:
            if val_metrics["mAP50"] > best_map50:
                best_map50 = float(val_metrics["mAP50"])
                saved_best = True
        elif val_metrics.get("loss", float("inf")) < best_loss:
            best_loss = float(val_metrics["loss"])
            saved_best = True
        if self.is_writer:
            tree = _to_host(self._tree(state))
            dev = next(state.model.parameters()).device
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            jobs = [("last", tree, dict(meta))]
            if saved_best:
                jobs.append(("best", tree, {**meta, "best_loss": best_loss,
                                            "best_mAP50": best_map50}))
            if self.async_save:
                self._thread = threading.Thread(target=self._write_in_thread, args=(jobs,),
                                                name="checkpoint-write")
                with _WRITES_LOCK:
                    _WRITES[self._key] = self._thread
                self._thread.start()
            else:
                self._write(jobs)
        self._pending = True
        if not self.async_save:
            self.wait()
        return best_loss, best_map50, saved_best

    def load_meta(self, name: str = "last") -> Optional[Dict[str, Any]]:
        """The checkpoint's meta json, or None when absent."""
        self.wait()
        _join_writes(self._key)
        path = self.dir / f"{name}.meta.json"
        return json.loads(path.read_text()) if path.exists() else None

    def load_raw(self, name: str = "best") -> Optional[Dict[str, Any]]:
        """The saved tree (on the CPU): ``<name>.pt``, else the JAX package's
        checkpoint ``name`` in the same layout; None when there is neither."""
        self.wait()
        _join_writes(self._key)
        path = self.dir / f"{name}.pt"
        if not path.exists():
            return read_jax_checkpoint(self.dir, name)
        return torch.load(path, map_location="cpu", weights_only=True)

    def try_resume(self, state, name: str = "last"):
        """Restore ``state`` in place from checkpoint ``name`` and return
        (state, start_epoch, best_loss, best_map50); without one, (state, 0,
        inf, 0.0). A checkpoint of another architecture raises, and so does
        one without EMA when ``state`` keeps one."""
        meta = self.load_meta(name)
        if meta is None:
            return state, 0, float("inf"), 0.0
        tree = self.load_raw(name)
        if tree is None:
            raise FileNotFoundError(f"{self.dir / name}.meta.json has no {name}.pt, "
                                    f"{name}/ (orbax) or {name}.npz beside it")
        model = state.model
        check_checkpoint(tree, model, name, ema=state.ema is not None)
        with torch.no_grad():
            model.load_state_dict(tree["model"])
            opt = tree["opt_state"]
            names = [n for n, _ in model.named_parameters()]
            # per-parameter views under flat_opt: the copies land in the (N,) tensors
            for n, mu, nu in zip(names, state.per_param(state.opt_state.mu),
                                 state.per_param(state.opt_state.nu)):
                mu.copy_(opt["mu"][n])
                nu.copy_(opt["nu"][n])
            state.opt_state.count = int(opt["count"])
            for n, e in (ema_as_tree(state) or {}).items():
                e.copy_(tree["ema"][n])
        state.step = int(tree["step"])
        # null = non-finite at write time (_meta_dumps): the "never set" sentinels
        best_loss, best_map50 = meta.get("best_loss"), meta.get("best_mAP50")
        return (state, int(meta["epoch"]) + 1,
                float("inf") if best_loss is None else float(best_loss),
                0.0 if best_map50 is None else float(best_map50))
