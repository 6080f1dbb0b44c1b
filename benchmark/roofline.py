"""The yardstick's arithmetic: peaks of one H100, FLOPs of a forward, and
the operations and bytes of greedy NMS.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W,
dense: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM. A card set below 700 W reaches less; every traced run
prints the card's power limit beside its shares.

``forward_flops`` counts 2 FLOPs per multiply-add of every conv (every tap,
the zero padding's included), every ``Linear``, every
``MultiheadAttention`` and each attention block's q.k and attn.v products,
from the shapes one forward sees, on the plain reference: the count of the
port's ``bench/breakdown.py``, widened to the leaves a new family brings. A
module with work of its own (area attention, deformable sampling) counts it
in a ``flops(inputs, output)`` method.
"""

from __future__ import annotations

import torch

BF16_PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: f32 operations of one IoU test of greedy NMS: for x and y a min, a max,
#: a subtraction and a clamp (8), the intersection's product (1), the
#: union's two additions and one subtraction (3), the division (1) and the
#: comparison with the threshold (1)
NMS_OPS_PER_TEST = 14
#: bytes a box of the sweep takes in: four f32 corners and its valid flag;
#: the keep flag it gives out
NMS_BYTES_IN, NMS_BYTES_OUT = 17, 1


def _conv(m, args, kwargs, out) -> int:
    kh, kw = m.kernel_size
    return 2 * out.numel() * (m.in_channels // m.groups) * kh * kw


def _linear(m, args, kwargs, out) -> int:
    return 2 * out.numel() * m.in_features


def _attn(m, args, kwargs, out) -> int:
    B, _c, H, W = args[0].shape
    n = H * W
    return 2 * B * m.nh * n * n * (m.kd + m.hd)


def _mha(m, args, kwargs, out) -> int:
    """``nn.MultiheadAttention``: its four projections and its two products."""
    q, k = (args[i] if len(args) > i else kwargs[n] for i, n in enumerate(("query", "key")))
    seq = -2 if m.batch_first else 0
    E, L, S = m.embed_dim, q.shape[seq], k.shape[seq]
    N = q.numel() // (L * E)
    S_attn = S + (m.bias_k is not None) + bool(m.add_zero_attn)
    return 2 * N * (2 * L * E * E + S * (m.kdim + m.vdim) * E + 2 * L * S_attn * E)


def _own_flops(m, args, kwargs, out) -> int:
    return m.flops(args, out)


def _counter(m):
    """How a module's own work is counted, or None: its ``flops`` method
    first, then the rules for ``Conv2d``, ``Linear``,
    ``MultiheadAttention`` and attention blocks (any module with ``nh``,
    ``kd`` and ``hd``: heads, key and head widths, over all H x W
    positions)."""
    if callable(getattr(m, "flops", None)):
        return _own_flops
    for kind, count in ((torch.nn.Conv2d, _conv), (torch.nn.Linear, _linear),
                        (torch.nn.MultiheadAttention, _mha)):
        if isinstance(m, kind):
            return count
    if all(hasattr(m, a) for a in ("nh", "kd", "hd")):
        return _attn
    return None


def forward_flops(model: torch.nn.Module, x: torch.Tensor) -> int:
    """FLOPs of one ``model(x)``, 2 per multiply-add: each module's own work
    (``_counter``). A module's ``flops(inputs, output) -> int`` counts its
    own products, not those of its child modules, which count themselves."""
    total = 0

    def hook(count):
        def add(m, args, kwargs, out):
            nonlocal total
            total += int(count(m, args, kwargs, out))

        return add

    hooks = [m.register_forward_hook(hook(count), with_kwargs=True)
             for m in model.modules() if (count := _counter(m)) is not None]
    try:
        was = model.training
        model.eval()
        with torch.no_grad():
            model(x)
        model.train(was)
    finally:
        for h in hooks:
            h.remove()
    return total


def nms_tests(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """IoU tests greedy NMS needs for these inputs: each kept pivot against
    every valid box after it. ``keep``, ``valid`` (B, N) bool in sweep
    order (score-descending)."""
    after = valid.flip(-1).cumsum(-1).flip(-1) - valid.to(torch.int64)  # valid boxes after i
    return int((after * keep).sum())


def nms_least_seconds(tests: int, boxes: int) -> tuple[float, str]:
    """The least time greedy NMS could take on the card, and which bound it
    is: ``tests`` IoU tests and ``boxes`` boxes in and out."""
    t_ops = tests * NMS_OPS_PER_TEST / F32_PEAK_FLOPS
    t_bytes = boxes * (NMS_BYTES_IN + NMS_BYTES_OUT) / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
