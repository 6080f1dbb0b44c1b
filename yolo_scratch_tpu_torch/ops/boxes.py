"""Box geometry on tensors (port of ``yolo_scratch_tpu/ops/boxes.py``).

Same operation order and eps placement as the JAX functions, so f32 results
agree with them to the rounding of each elementwise op.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-xywh -> corner-xyxy."""
    xy, wh = b[..., :2], b[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy2xywh(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner-xyxy -> center-xywh."""
    lo, hi = b[..., :2], b[..., 2:4]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def bbox_iou(
    box1: torch.Tensor,
    box2: torch.Tensor,
    xywh: bool = True,
    GIoU: bool = False,
    DIoU: bool = False,
    CIoU: bool = False,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Elementwise (broadcasting) IoU between box sets, last dim = 4, with
    the trailing size-1 axis kept.

    As in the JAX function: in the xyxy branch eps is added to the heights
    only; the union carries its own eps; CIoU's ``alpha`` is a constant for
    autograd (``torch.no_grad``, the counterpart of ``lax.stop_gradient``).
    """
    if xywh:
        x1, y1, w1, h1 = box1[..., 0], box1[..., 1], box1[..., 2], box1[..., 3]
        x2, y2, w2, h2 = box2[..., 0], box2[..., 1], box2[..., 2], box2[..., 3]
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1[..., 0], box1[..., 1], box1[..., 2], box1[..., 3]
        b2_x1, b2_y1, b2_x2, b2_y2 = box2[..., 0], box2[..., 1], box2[..., 2], box2[..., 3]
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if CIoU or DIoU:
            c2 = cw**2 + ch**2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
                with torch.no_grad():
                    alpha = v / (v - iou + (1 + eps))
                return (iou - (rho2 / c2 + v * alpha))[..., None]
            return (iou - rho2 / c2)[..., None]
        c_area = cw * ch + eps
        return (iou - (c_area - union) / c_area)[..., None]

    return iou[..., None]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """All-pairs plain IoU, xyxy. (..., N, 4) x (..., M, 4) -> (..., N, M);
    eps on the union."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter + eps)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True,
              dim: int = -1) -> torch.Tensor:
    """ltrb distances -> boxes (xywh or xyxy) around ``anchor_points``."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from ``anchor_points``, clamped to
    [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1).clamp(0, reg_max - 0.01)
