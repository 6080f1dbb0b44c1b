"""Train state: the model, its optimizer state, the step count and the EMA
(port of ``train/state.py``).

The JAX package keeps these in one pytree that each jitted step replaces;
here the model's parameters and BN buffers are the live tensors, and
:meth:`TrainState.apply_gradients` updates them, the optimizer state and the
EMA in place.

The EMA averages the parameters only; BN running statistics are not
averaged (unlike Ultralytics' ``ModelEMA``), and an EMA evaluation runs on
the live ones (:func:`ema_state_dict`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from yolo_scratch_tpu_torch.train.optim import AdamW, AdamWState


@dataclass
class TrainState:
    model: nn.Module
    tx: AdamW
    opt_state: AdamWState
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> EMA tensor
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def ema_decay_at(self, step: int) -> float:
        """Ultralytics-style ramped decay ``decay * (1 - exp(-(step+1)/tau))``
        for the update that ``step`` counts before it, in f32."""
        f = np.float32
        return float(f(self.ema_decay) * (f(1.0) - f(math.exp(-(step + 1) / self.ema_tau))))

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """clip + AdamW on the parameters, then the EMA toward the updated
        parameters; ``step`` counts the update. Returns ``self``."""
        params = self.params
        self.tx.update(grads, self.opt_state, params)
        if self.ema is not None:
            d = self.ema_decay_at(self.step)
            ema = list(self.ema.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, params, alpha=1.0 - d)
        self.step += 1
        return self


def ema_state_dict(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The model's ``state_dict`` with the EMA in place of each parameter and
    the live BN buffers (what the JAX eval step evaluates with ``use_ema``),
    or None without an EMA."""
    if state.ema is None:
        return None
    sd = state.model.state_dict()
    sd.update(state.ema)
    return sd


def create_train_state(model: nn.Module, tx: AdamW, use_ema: bool = False,
                       ema_decay: float = 0.9999, ema_tau: float = 2000.0,
                       flat_opt: bool = False) -> TrainState:
    """The train state of ``model`` as it stands (its weights are the initial
    ones: the CLI builds it with the port's seeded init). ``flat_opt=True``
    (the TPU build's raveled update vector) raises: ROADMAP C3."""
    if flat_opt:
        raise NotImplementedError("flat_opt=True (one raveled update vector) is not ported "
                                  "(ROADMAP C3, flat_opt)")
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()} if use_ema else None
    return TrainState(model=model, tx=tx, opt_state=tx.init(list(params.values())), ema=ema,
                      ema_decay=ema_decay, ema_tau=ema_tau)
