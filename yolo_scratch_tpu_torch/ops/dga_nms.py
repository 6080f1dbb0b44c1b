"""Gaussian-angle (dGA) NMS on tensors, the CDA-aware suppressor (port of
``ops/dga_nms.py``).

The host version is ``utils/metrics.py::cda_nms`` (per-pair numpy). Here the
2x2 determinants and inverses are closed form over (N, N) tensors in f32,
as the JAX function computes them, then the greedy sweep of IoU-NMS keyed
on dGA < threshold, capped at ``max_det`` (the CDA scorer's top-10 rule).
Semimajor = the larger half-extent; the angle falls back to pi/2 wherever a
determinant is non-positive.

cos, sin, exp, arccos and sqrt are evaluated in f64 and rounded once to
f32 (:func:`_f32_of`: the correctly rounded f32 for sqrt, and for the
others on all but a vanishing share of inputs); every other operation is
f32 and correctly rounded on any device. On an H100 torch's f32 ``exp``,
``acos`` and ``sqrt`` differ from the CPU's by an ulp on some inputs, and
arccos's slope near 1 (near-duplicate boxes) blew that up to 5.74e-6;
rounded from f64 the card and the CPU compute the same matrix.
"""

from __future__ import annotations

import math

import torch


def _f32_of(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` evaluated in f64 and rounded once to ``x``'s dtype."""
    return fn(x.double()).to(x.dtype)


def _ellipse_params(boxes: torch.Tensor, angles: torch.Tensor | None):
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    a = torch.maximum(w, h) / 2.0
    b = torch.minimum(w, h) / 2.0
    xc = (boxes[:, 0] + boxes[:, 2]) / 2.0
    yc = (boxes[:, 1] + boxes[:, 3]) / 2.0
    phi = torch.zeros_like(a) if angles is None else angles
    return a, b, xc, yc, phi


def _y_components(a, b, phi, eps: float = 1e-12):
    """Y = R(phi) diag(1/a^2, 1/b^2) R(-phi) as (y00, y01, y11)."""
    c, s = _f32_of(torch.cos, phi), _f32_of(torch.sin, phi)
    ia2 = 1.0 / (a * a).clamp(min=eps)
    ib2 = 1.0 / (b * b).clamp(min=eps)
    y00 = c * c * ia2 + s * s * ib2
    y01 = c * (-s) * ia2 + s * c * ib2
    y11 = s * s * ia2 + c * c * ib2
    return y00, y01, y11


def pairwise_dga(boxes: torch.Tensor, angles: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs Gaussian angle between the ellipses the boxes imply: (N, 4)
    xyxy -> (N, N), with the pi/2 fallback on non-positive determinants."""
    a, b, xc, yc, phi = _ellipse_params(boxes, angles)
    y00, y01, y11 = _y_components(a, b, phi)
    det = y00 * y11 - y01 * y01  # (N,)

    s00 = y00[:, None] + y00[None, :]
    s01 = y01[:, None] + y01[None, :]
    s11 = y11[:, None] + y11[None, :]
    det_sum = s00 * s11 - s01 * s01  # (N, N)

    bad = (det_sum <= 0) | (det[:, None] <= 0) | (det[None, :] <= 0)
    safe_det_sum = torch.where(bad, 1.0, det_sum)

    mult = 4.0 * _f32_of(torch.sqrt, (det[:, None] * det[None, :]).clamp(min=0.0)) / safe_det_sum

    dx = xc[:, None] - xc[None, :]
    dy = yc[:, None] - yc[None, :]
    # d^T Yi inv(Yi + Yj) Yj d, with inv(S) = adj(S) / det(S): Yj d first
    jx = y00[None, :] * dx + y01[None, :] * dy
    jy = y01[None, :] * dx + y11[None, :] * dy
    ivx = (s11 * jx - s01 * jy) / safe_det_sum
    ivy = (-s01 * jx + s00 * jy) / safe_det_sum
    quad = dx * (y00[:, None] * ivx + y01[:, None] * ivy) + dy * (
        y01[:, None] * ivx + y11[:, None] * ivy)
    cos_term = (mult * _f32_of(torch.exp, -0.5 * quad)).clamp(-1.0, 1.0)
    return torch.where(bad, math.pi / 2.0, _f32_of(torch.arccos, cos_term))


def dga_nms_device(
    boxes: torch.Tensor,  # (N, 4) xyxy (normalized or pixel: scale-free)
    scores: torch.Tensor,  # (N,)
    valid: torch.Tensor | None = None,
    angles: torch.Tensor | None = None,
    max_det: int = 10,
    dga_thresh: float = 0.15,
) -> torch.Tensor:
    """Greedy dGA suppression -> keep (N,) bool, at most ``max_det`` kept,
    by descending score (a stable sort, as ``jnp.argsort``). The sweep is a
    loop over the sorted boxes on the tensors' device."""
    n = boxes.shape[0]
    dev = boxes.device
    valid = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid

    order = torch.argsort(-scores, stable=True)
    valid_s = valid[order]
    dga = pairwise_dga(boxes[order], None if angles is None else angles[order])
    idx = torch.arange(n, device=dev)
    thr = float(torch.tensor(dga_thresh, dtype=dga.dtype))

    suppressed = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(n):
        is_kept = valid_s[i] & ~suppressed[i]
        suppressed = suppressed | (is_kept & (dga[i] < thr) & (idx > i))
    keep_s = valid_s & ~suppressed
    keep_s = keep_s & (torch.cumsum(keep_s.to(torch.int32), 0) - 1 < max_det)
    return torch.zeros_like(keep_s).scatter_(0, order, keep_s)
