"""Faults planted in the timed path, for the tests that see ``correct``
come out false and for ``control.py``'s readings of them at a cell's own
size. Each wraps what the program returns; none changes the program."""

from __future__ import annotations

import torch

from benchmark.drivers.train import build_step


def half_batch(pred):
    """Only the first half of each batch is computed; its rows stand for
    the rest."""
    inner = pred.predict_batch

    def predict(x):
        out = inner(x[: len(x) // 2])
        return torch.cat([out, out])[: len(x)]

    pred.predict_batch = predict
    return pred


def altered_answer(pred):
    """One box corner of each image's first detection moved by a pixel."""
    inner = pred.predict_batch

    def predict(x):
        out = inner(x).clone()
        out[:, 0, 0] += 1.0 / 640
        return out

    pred.predict_batch = predict
    return pred


def stale_answer(pred):
    """Each call returns the previous batch's answer."""
    inner, last = pred.predict_batch, []

    def predict(x):
        out = inner(x)
        prev = last[0] if last else out
        last[:] = [out]
        return prev

    pred.predict_batch = predict
    return pred


DEPLOY_FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer, "stale": stale_answer}


def unchanged_state(model, cfg, precision):
    """A step that computes everything but leaves the state as it was."""
    step, state = build_step(model, cfg, precision)
    state.apply_gradients = lambda grads: state
    return step, state


def half_batch_step(model, cfg, precision):
    """A step on the first half of each batch (the mean over those rows)."""
    step, state = build_step(model, cfg, precision)
    inner = step.__call__

    def call(st, batch, **kw):
        return inner(st, {k: v[: len(v) // 2] for k, v in batch.items()}, **kw)

    return _Wrapped(step, call), state


class _Wrapped:
    def __init__(self, step, call):
        self._step, self._call = step, call

    def __call__(self, *a, **kw):
        return self._call(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __setattr__(self, name, value):
        if name in ("_step", "_call"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._step, name, value)


TRAIN_FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch_step}
