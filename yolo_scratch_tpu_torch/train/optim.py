"""Optimizer + LR schedule (port of ``train/optim.py``).

AdamW (lr 1e-3, wd 5e-4, betas 0.9/0.999, eps 1e-8) after a clip by global
norm 10.0, as the JAX package chains ``optax.clip_by_global_norm`` and
``optax.adamw``; a per-epoch warmup + cosine schedule: 3 linear-warmup
epochs from ``lr_min = 0.01 * lr_max``, then cosine down to ``lr_min``,
evaluated per step with ``epoch = step // steps_per_epoch``.

The update runs on the device with ``torch._foreach_*`` ops over every
parameter at once, and never syncs with the host: the step count lives on
the host, so the schedule, the bias corrections and the EMA decay are host
floats.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]

_F32 = np.float32


def _libm_cosf() -> Callable[[float], float]:
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_epoch_schedule(lr_max: float, epochs: int, steps_per_epoch: int,
                          warmup_epochs: int = 3, lr_min: float | None = None) -> Schedule:
    """``schedule(step) -> lr`` as a float32 value, the bits of the JAX
    schedule as XLA's CPU backend computes it: XLA folds each division by a
    constant into a multiply by its float32 reciprocal (and pi into it), and
    takes the C library's ``cosf``; both are mirrored here."""
    if lr_min is None:
        lr_min = lr_max * 0.01
    cosf = _libm_cosf()
    lo = _F32(lr_min)
    warm_slope = _F32((lr_max - lr_min) / warmup_epochs)
    phase = _F32(np.pi) * _F32(1.0 / max(epochs - warmup_epochs, 1))
    half = _F32((lr_max - lr_min) * 0.5)

    def schedule(step: int) -> float:
        epoch = _F32(int(step) // steps_per_epoch)
        if epoch < _F32(warmup_epochs):
            return float(epoch * warm_slope + lo)
        c = _F32(cosf(float((epoch + _F32(-warmup_epochs)) * phase)))
        return float((c + _F32(1.0)) * half + lo)

    return schedule


@dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: ``count`` updates applied so far, and
    the first and second moments, one tensor per parameter."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


# A tensor longer than _NORM_LONG is normed in chunks of _NORM_CHUNK: the
# CPU's f32 norm of one long vector drifts (1.2e-5 relative at 2**20
# elements, 6.2e-5 at YOLO11n's 3.07M flat vector; 1.8e-7 in 2**16 chunks),
# and so would a long leaf of a per-leaf tree (YOLOX-s's 2.36M-element 3x3
# convs) against optax
_NORM_LONG, _NORM_CHUNK = 2 ** 20, 2 ** 16


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor: the
    norm of the per-tensor norms (one multi-tensor launch)."""
    parts = [c for t in tensors
             for c in (t.reshape(-1).split(_NORM_CHUNK) if t.numel() > _NORM_LONG else (t,))]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts)))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's rule: the gradients unchanged when their global norm is
    below ``max_norm``, else ``g * max_norm / norm``. Decided on the device
    (no host sync). ``torch.nn.utils.clip_grad_norm_`` always scales, by
    ``min(1, max / (norm + 1e-6))``, which is another function."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(list(grads), factor)


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` as optax takes it: in f32 throughout (XLA's f32
    ``pow``), which for b2 = 0.999 lies up to 2e-5 from the f64 value
    rounded once."""
    return float(_F32(1.0) - _F32(decay) ** _F32(count))


class AdamW:
    """clip-by-global-norm -> AdamW, the JAX package's ``make_optimizer``
    chain. Decay reaches every parameter, BN scales and biases included, as
    optax's unmasked ``adamw`` does. ``learning_rate`` is a float or a
    :data:`Schedule`; the LR of an update is ``schedule(count)``, ``count``
    being the updates applied before it (optax's ``scale_by_learning_rate``
    count)."""

    def __init__(self, learning_rate: float | Schedule = 1e-3, weight_decay: float = 5e-4,
                 clip_norm: float = 10.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(_F32(lr(count) if callable(lr) else lr))

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor]) -> None:
        """One update, in place on ``params`` and ``state``."""
        b1, b2 = self.b1, self.b2
        g = clip_by_global_norm(grads, self.clip_norm)
        lr = self.lr(state.count)
        count = state.count + 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(state.mu, bias_correction(b1, count))
        denom = torch._foreach_div(state.nu, bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(mu_hat, params, alpha=self.weight_decay)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(list(params), mu_hat)
        state.count = count


class FlatAdamW(AdamW):
    """The same chain on one raveled vector, as ``optax.flatten`` wraps it:
    the moments are (N,) tensors over the parameters in order, the global
    norm is taken over their concatenation, and the update is unraveled onto
    the parameters. A single (N,) parameter (``create_train_state(...,
    flat_opt=True)``'s master vector) is updated in place with no copy."""

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        n = sum(p.numel() for p in params)
        p0 = params[0]
        return AdamWState(0, [p0.new_zeros(n)], [p0.new_zeros(n)])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor]) -> None:
        if len(params) == 1 and params[0].dim() == 1:
            return super().update([grads[0].reshape(-1)], state, params)
        flat = torch.cat([p.reshape(-1) for p in params])
        super().update([torch.cat([g.reshape(-1) for g in grads])], state, [flat])
        torch._foreach_copy_(list(params), unravel(flat, params))


def unravel(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of the (N,) ``flat`` shaped as ``like``, in order (the inverse
    of ``torch.cat([t.reshape(-1) for t in like])``)."""
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def make_optimizer(learning_rate: float | Schedule = 1e-3, weight_decay: float = 5e-4,
                   clip_norm: float = 10.0, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, flatten: bool = False) -> AdamW:
    """clip-by-global-norm -> AdamW (torch-default betas/eps).

    ``flatten=True`` (``optax.flatten`` of the chain in the JAX package):
    :class:`FlatAdamW`, the same math on one raveled (N,) vector."""
    return (FlatAdamW if flatten else AdamW)(learning_rate, weight_decay, clip_norm, b1, b2, eps)
