"""Train state: the model, its optimizer state, the step count and the EMA
(port of ``train/state.py``).

The JAX package keeps these in one pytree that each jitted step replaces;
here the model's parameters and BN buffers are the live tensors, and
:meth:`TrainState.apply_gradients` updates them, the optimizer state and the
EMA in place.

The EMA averages the parameters only; BN running statistics are not
averaged (unlike Ultralytics' ``ModelEMA``), and an EMA evaluation runs on
the live ones (:func:`ema_state_dict`).

``flat_opt=True`` runs clip + AdamW + EMA on ONE (N,) f32 master vector:
every ``nn.Parameter`` becomes a view of it, so the update needs no ravel
or unravel copy of the parameters (the JAX package pays both); the
gradients are gathered into a flat buffer of the same layout by one
multi-tensor copy. The moments and the EMA are (N,) tensors too. Each
parameter starts on a 256-byte boundary: cuDNN's and PyTorch's vectorised
kernels fault ("misaligned address", on an H100) on weights at 4-byte
offsets. The gaps hold 0 in every vector and stay 0 (a zero gradient moves
neither moment, nor its parameter). Anything that rebinds a parameter's
storage after the state exists (``.to(device)``, ``channels_last``,
``p.data = ...``) breaks the views, and the next
:meth:`TrainState.apply_gradients` raises; ``load_state_dict`` copies in
place and keeps them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from yolo_scratch_tpu_torch.train.optim import AdamW, AdamWState, FlatAdamW, unravel

_ALIGN = 64  # f32 elements: each parameter's offset in the flat vector, 256 bytes


@dataclass
class TrainState:
    model: nn.Module
    tx: AdamW
    opt_state: AdamWState
    step: int = 0
    # parameter name -> EMA tensor; under flat_opt one (N,) tensor (ema_as_tree)
    ema: Optional[Dict[str, torch.Tensor] | torch.Tensor] = None
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    flat: Optional[torch.Tensor] = None  # the (N,) master vector under flat_opt
    _offsets: Optional[List[int]] = None  # each parameter's offset in ``flat``
    _ptrs: Optional[List[int]] = None  # each parameter's address inside ``flat``
    _grads: Optional[torch.Tensor] = None  # the flat gradient buffer
    _grad_views: Optional[List[torch.Tensor]] = None  # its per-parameter views

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def views(self, vec: torch.Tensor) -> List[torch.Tensor]:
        """Per-parameter views of an (N,) vector of the flat layout."""
        return [vec[o:o + p.numel()].view_as(p) for o, p in zip(self._offsets, self.params)]

    def per_param(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Optimizer-state tensors (``opt_state.mu`` or ``.nu``) one per
        parameter: as they are, or views of the (N,) one (under flat_opt in
        its aligned layout; under :class:`FlatAdamW` raveled in order)."""
        if self.flat is not None:
            return self.views(tensors[0])
        if isinstance(self.tx, FlatAdamW):
            return unravel(tensors[0], self.params)
        return list(tensors)

    def ema_decay_at(self, step: int) -> float:
        """Ultralytics-style ramped decay ``decay * (1 - exp(-(step+1)/tau))``
        for the update that ``step`` counts before it, in f32."""
        f = np.float32
        return float(f(self.ema_decay) * (f(1.0) - f(math.exp(-(step + 1) / self.ema_tau))))

    def _check_views(self, params: Sequence[torch.Tensor]) -> None:
        if [p.data_ptr() for p in params] != self._ptrs:
            raise RuntimeError("flat_opt: a parameter no longer lies in the state's master "
                               "vector (moved, made channels_last or rebound after "
                               "create_train_state); create the state after such changes")

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor] | torch.Tensor) -> "TrainState":
        """clip + AdamW on the parameters, then the EMA toward the updated
        parameters; ``step`` counts the update. Returns ``self``. Under
        flat_opt ``grads`` may also be one (N,) tensor of the flat layout."""
        params = self.params
        d = self.ema_decay_at(self.step) if self.ema is not None else None
        if self.flat is not None:
            self._check_views(params)
            g = grads
            if not torch.is_tensor(g):
                torch._foreach_copy_(self._grad_views, list(grads))
                g = self._grads
            self.tx.update([g], self.opt_state, [self.flat])
            if d is not None:
                self.ema.mul_(d).add_(self.flat, alpha=1.0 - d)
        else:
            self.tx.update(grads, self.opt_state, params)
            if d is not None:
                ema = list(self.ema.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, params, alpha=1.0 - d)
        self.step += 1
        return self


def ema_as_tree(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA by parameter name (under flat_opt, views of the (N,) EMA), or
    None without one: the JAX package's ``ema_as_tree``."""
    if state.ema is None or isinstance(state.ema, dict):
        return state.ema
    names = [n for n, _ in state.model.named_parameters()]
    return dict(zip(names, state.views(state.ema)))


def ema_state_dict(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The model's ``state_dict`` with the EMA in place of each parameter and
    the live BN buffers (what the JAX eval step evaluates with ``use_ema``),
    or None without an EMA."""
    ema = ema_as_tree(state)
    if ema is None:
        return None
    sd = state.model.state_dict()
    sd.update(ema)
    return sd


def create_train_state(model: nn.Module, tx: AdamW, use_ema: bool = False,
                       ema_decay: float = 0.9999, ema_tau: float = 2000.0,
                       flat_opt: bool = False) -> TrainState:
    """The train state of ``model`` as it stands (its weights are the initial
    ones: the CLI builds it with the port's seeded init). ``flat_opt=True``:
    the parameters become views of one (N,) master vector, and the moments
    and the EMA are (N,) tensors (the module docstring)."""
    params = list(model.parameters())
    if not flat_opt:
        named = dict(model.named_parameters())
        ema = {k: p.detach().clone() for k, p in named.items()} if use_ema else None
        return TrainState(model=model, tx=tx, opt_state=tx.init(params), ema=ema,
                          ema_decay=ema_decay, ema_tau=ema_tau)
    offsets, n = [], 0
    for p in params:
        offsets.append(n)
        n += -(-p.numel() // _ALIGN) * _ALIGN
    flat = params[0].new_zeros(n)
    state = TrainState(model=model, tx=tx, opt_state=tx.init([flat]), ema_decay=ema_decay,
                       ema_tau=ema_tau, flat=flat, _offsets=offsets, _grads=torch.zeros_like(flat))
    with torch.no_grad():
        for p, view in zip(params, state.views(flat)):
            view.copy_(p)
            p.data = view
    state._ptrs = [p.data_ptr() for p in params]
    state._grad_views = state.views(state._grads)
    state.ema = flat.clone() if use_ema else None
    return state
