"""Numerical-safety guards (port of ``utils/guards.py``).

* ``finite_or_raise``: host-side check that a metrics dict is finite;
* ``tree_all_finite``: one bool tensor, every floating tensor of a tree
  (nested dicts, lists, tuples, a ``state_dict``, a module's parameters)
  finite, computed on the tensors' device;
* ``checkify_fn``: JAX's ``checkify`` has no PyTorch counterpart, so it
  raises ``NotImplementedError`` (``torch.autograd.detect_anomaly`` checks
  backward passes only).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch


def tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tree: a tensor, a module's ``state_dict``, or
    nested dicts, lists and tuples of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def tree_all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating-point tensor of ``tree`` is finite
    (True when there is none)."""
    flags = [torch.isfinite(t).all() for t in tensor_leaves(tree) if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).all()


def finite_or_raise(metrics: Dict[str, Any], context: str = "train step") -> None:
    bad = {k: float(v) for k, v in metrics.items() if not np.isfinite(float(v))}
    if bad:
        raise FloatingPointError(f"non-finite metrics in {context}: {bad}")


def checkify_fn(fn: Callable, *, errors=None) -> Callable:
    """The JAX package wraps ``fn`` with ``jax.experimental.checkify``;
    PyTorch has no counterpart."""
    raise NotImplementedError(
        "checkify_fn: jax.experimental.checkify has no PyTorch counterpart; check outputs "
        "with tree_all_finite / finite_or_raise, or backward passes with "
        "torch.autograd.detect_anomaly")
