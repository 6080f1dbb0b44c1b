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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor: the
    norm of the per-tensor norms (one multi-tensor launch)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's rule: the gradients unchanged when their global norm is
    below ``max_norm``, else ``g * max_norm / norm``. Decided on the device
    (no host sync). ``torch.nn.utils.clip_grad_norm_`` always scales, by
    ``min(1, max / (norm + 1e-6))``, which is another function."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(list(grads), factor)


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
        # bias corrections as optax takes them: 1 - decay**count, in f32
        mu_hat = torch._foreach_div(state.mu, float(_F32(1.0 - b1 ** count)))
        denom = torch._foreach_div(state.nu, float(_F32(1.0 - b2 ** count)))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(mu_hat, params, alpha=self.weight_decay)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(list(params), mu_hat)
        state.count = count


def make_optimizer(learning_rate: float | Schedule = 1e-3, weight_decay: float = 5e-4,
                   clip_norm: float = 10.0, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, flatten: bool = False) -> AdamW:
    """clip-by-global-norm -> AdamW (torch-default betas/eps).

    ``flatten=True`` (the TPU build's A/B of one raveled update vector, which
    no CLI flag reaches) raises: it waits for ROADMAP C3's ``flat_opt``."""
    if flatten:
        raise NotImplementedError("flatten=True (one raveled update vector) is not ported "
                                  "(ROADMAP C3, flat_opt)")
    return AdamW(learning_rate, weight_decay, clip_norm, b1, b2, eps)
