"""Post-training int8 quantization for the deploy path (port of
``nn/quant.py``).

The JAX package's scheme, unchanged:

* symmetric, zero-point-free everywhere, so conv zero-padding and the
  residual identity stay exact and the dequant is one per-channel multiply;
* weights: per-output-channel absmax over the BN-folded kernel;
* activations: per-tensor absmax of each ``ConvBNAct``'s conv input over the
  calibration batches, or its q-quantile (outlier-robust);
* coverage: every ``ConvBNAct`` (YOLO11 builder family and YOLOX). The
  Detect / YOLOX-head 1x1 prediction convs are plain ``nn.Conv2d`` and stay
  in bf16/f32.

Where the JAX package mounts ``"calib"`` / ``"quant"`` collections, the port
sets each block's hooks (``nn/modules.py::ConvBNAct``): a calibration tree
is ``{module path: absmax}`` and :func:`build_quant_tree` attaches the int8
buffers to the blocks. The conv itself is ``ops/int8_conv.py``.

Usage::

    model_q = quantize_for_deploy(model, calib_batches)
    pred = Predictor(model_q, cfg)   # runs every quantized block in int8

``skip`` rejects blocks by module path, e.g. ``skip=lambda p: p == "model.0"``
keeps the stem in bf16.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.nn.modules import QUANT_BUFFERS, ConvBNAct

Calib = Dict[str, torch.Tensor]


def conv_blocks(model: nn.Module) -> Iterator[Tuple[str, ConvBNAct]]:
    """(module path, block) of every ``ConvBNAct`` in ``model``."""
    return ((name, m) for name, m in model.named_modules() if isinstance(m, ConvBNAct))


@contextlib.contextmanager
def _calibrating(model: nn.Module, mode: str):
    """Eval mode, no autograd, TF32 off (f32 statistics, as the JAX package
    calibrates), each block recording in ``mode``; all undone after."""
    from yolo_scratch_tpu_torch.train.steps import precision_scope

    blocks = dict(conv_blocks(model))
    was_training = model.training
    model.eval()
    for m in blocks.values():
        m.calib, m.calib_out = mode, None
    try:
        with torch.no_grad(), precision_scope("highest"):
            yield blocks
    finally:
        for m in blocks.values():
            m.calib = m.calib_out = None
        model.train(was_training)


def _as_input(model: nn.Module, x) -> torch.Tensor:
    p = next(model.parameters())
    return torch.as_tensor(np.asarray(x, np.float32)).to(p.device, p.dtype)


def calibrate_absmax(model: nn.Module, batches: Iterable) -> Calib:
    """Run calibration batches ((B, S, S, C) f32 in [0, 1]); return each
    block's input absmax, a running max over all batches, as 0-d f32
    tensors keyed by module path."""
    with _calibrating(model, "absmax") as blocks:
        n = 0
        for x in batches:
            model(_as_input(model, x))
            n += 1
        if n == 0:
            raise ValueError("calibrate_absmax: no calibration batches supplied")
        return {name: m.calib_out.cpu() for name, m in blocks.items()}


def _quantile(t: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(|t|, q)`` (method "linear") in f32, through a sort
    (``torch.quantile`` refuses inputs above 2^24 elements): position
    q * (n - 1) in f32, the two neighbours weighted by its fraction and
    summed as XLA's CPU code does, the upper term fused into one
    multiply-add (``fma(hi, w_hi, lo * w_lo)``; the f64 sum rounds once)."""
    a = torch.sort(t.abs().flatten()).values
    n = a.numel()
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1) - hw
    lo = a[int(np.clip(low, 0, n - 1))]
    hi = a[int(np.clip(high, 0, n - 1))]
    lo_term = lo * torch.tensor(lw, device=a.device)
    return (lo_term.double() + hi.double() * float(hw)).float()


def calibrate_quantile(model: nn.Module, batches: Iterable, q: float = 0.999) -> Calib:
    """Percentile calibration: each block's q-quantile of |conv input| per
    batch, the max over batches (conservative). The same tree as
    :func:`calibrate_absmax`, so :func:`build_quant_tree` takes either.
    Holds one block's whole input at a time: use small calibration batches."""
    acc: Calib = {}
    with _calibrating(model, "full") as blocks:
        for x in batches:
            model(_as_input(model, x))
            for name, m in blocks.items():
                v = _quantile(m.calib_out, q).cpu()
                acc[name] = v if name not in acc else torch.maximum(acc[name], v)
                m.calib_out = None
    if not acc:
        raise ValueError("calibrate_quantile: no calibration batches supplied")
    return acc


def _quantize_kernel(weight: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: OIHW ``weight`` -> (w_q int8,
    s_w f32 (O,)), ``s_w = max(absmax, 1e-12) / 127``, in numpy f32 as the
    JAX package computes it."""
    k = weight.detach().float().cpu().numpy()
    absmax = np.max(np.abs(k), axis=(1, 2, 3))
    s_w = np.maximum(absmax, 1e-12) / 127.0
    w_q = np.clip(np.round(k / s_w[:, None, None, None]), -127, 127).astype(np.int8)
    return w_q, s_w.astype(np.float32)


def build_quant_tree(model: nn.Module, calib: Calib,
                     skip: Optional[Callable[[str], bool]] = None) -> Dict[str, Dict]:
    """Attach int8 buffers to each (folded) block that ``calib`` covers and
    ``skip`` (module path -> bool) does not reject. Returns what it attached,
    ``{path: {"w_q", "s_w", "s_act"}}``."""
    out: Dict[str, Dict] = {}
    for name, m in conv_blocks(model):
        if name not in calib or (skip is not None and skip(name)):
            continue
        w_q, s_w = _quantize_kernel(m.conv.weight)
        s_act = np.float32(max(float(calib[name]), 1e-12) / 127.0)
        dev = m.conv.weight.device
        bufs = {"w_q": torch.from_numpy(w_q), "s_w": torch.from_numpy(s_w),
                "s_act": torch.tensor(s_act)}
        for key, t in bufs.items():
            m.register_buffer(key, t.to(dev))
        out[name] = bufs
    return out


def quantize_for_deploy(model: nn.Module, calib_batches: Sequence,
                        skip: Optional[Callable[[str], bool]] = None,
                        quantile: Optional[float] = None) -> nn.Module:
    """A BN-folded copy of ``model`` (folding is idempotent), calibrated on
    ``calib_batches`` and with every covered block quantized: ready for the
    ``Predictor``. ``quantile`` (e.g. 0.999) calibrates by percentile."""
    fused = fuse_conv_bn(model)
    if quantile is not None:
        calib = calibrate_quantile(fused, calib_batches, q=quantile)
    else:
        calib = calibrate_absmax(fused, calib_batches)
    build_quant_tree(fused, calib, skip=skip)
    return fused


def prepare_calib_batches(predictor, paths: Sequence[str], max_batches: int) -> list:
    """Host-prep calibration batches exactly as the Predictor serves them:
    its own ``_prepare`` (letterbox or stretch), then the device path's
    normalisation (uint8 -> /255). Shared by the infer, serve and export
    CLIs."""
    B = predictor.cfg.batch_size
    batches = []
    for i in range(0, min(len(paths), max_batches * B), B):
        chunk = list(paths[i:i + B])
        chunk = chunk + [chunk[-1]] * (B - len(chunk))
        imgs, _ = predictor._prepare(chunk)
        x = np.asarray(imgs, np.float32)
        batches.append(x / 255.0 if imgs.dtype == np.uint8 else x)
    return batches


def count_quantized(model: nn.Module) -> int:
    """Number of ``ConvBNAct`` blocks that run in int8."""
    return sum(m.w_q is not None for _, m in conv_blocks(model))


def cast_for_deploy(model: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """``model.to(device, dtype)``, except that the int8 scales ``s_w`` and
    ``s_act`` stay f32 (``w_q`` stays int8, as every integer tensor does)."""
    scales = {(m, key): getattr(m, key) for _, m in conv_blocks(model)
              for key in QUANT_BUFFERS[1:] if getattr(m, key) is not None}
    model = model.to(device, dtype)
    for (m, key), t in scales.items():
        m.register_buffer(key, t.to(device, torch.float32))
    return model
