"""Batched greedy TP/FP marking for mAP evaluation, on the device (port of
``ops/matching.py``).

The reference marks TP/FP on the host with a per-image, per-IoU-threshold
Python greedy loop. Here one loop over the N score-sorted detections carries
a (B, T, G) matched mask and marks all B images and T thresholds at once,
with no host sync inside the loop. The host keeps only the AP accumulation
(``utils.metrics.metrics_from_marks``).

Semantics are the JAX package's: predictions in score-descending order each
grab their best *unmatched* GT; TP iff that best available IoU >= threshold;
matching ignores class labels unless ``pred_labels``/``gt_labels`` are given,
which restricts IoU to same-class pairs (per-class AP from one pass). Ties
go to the lowest GT index (``torch.argmax``'s rule, as ``jnp.argmax``'s),
also on rows that are all ``-inf``, where both return 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolo_scratch_tpu_torch.ops.boxes import pairwise_iou

# reference threshold grid 0.50:0.95:0.05 (utils/metrics.py:132-137)
DEFAULT_THRESHOLDS = tuple(0.5 + 0.05 * i for i in range(10))


def _thresholds(thresholds, device) -> torch.Tensor:
    """(1, T) f32, rounded from the Python floats once, as ``jnp.asarray``
    does."""
    return torch.tensor(thresholds, dtype=torch.float32, device=device)[None]


def _masked_iou(pred_boxes, gt_boxes, gt_mask):
    # (B, N, G); pairwise_iou's f32 operations, image by image
    iou = torch.vmap(pairwise_iou)(pred_boxes.to(torch.float32), gt_boxes.to(torch.float32))
    return iou.masked_fill(~gt_mask.to(torch.bool)[:, None, :], -1.0)


def batched_tp_marks(
    pred_boxes: torch.Tensor,   # (B, N, 4) xyxy, each row score-descending
    pred_valid: torch.Tensor,   # (B, N) bool
    gt_boxes: torch.Tensor,     # (B, G, 4) xyxy (same coord space as preds)
    gt_mask: torch.Tensor,      # (B, G) bool
    thresholds: tuple = DEFAULT_THRESHOLDS,
    pred_labels: Optional[torch.Tensor] = None,  # (B, N) int
    gt_labels: Optional[torch.Tensor] = None,    # (B, G) int
) -> torch.Tensor:
    """Batched greedy TP marks -> (B, T, N) bool. With labels supplied the
    marks are class-restricted (see the module docstring)."""
    iou = _masked_iou(pred_boxes, gt_boxes, gt_mask)  # (B, N, G)
    if pred_labels is not None and gt_labels is not None:
        same = pred_labels[:, :, None] == gt_labels[:, None, :]
        iou = iou.masked_fill(~same, -1.0)
    B, n, g = iou.shape
    th = _thresholds(thresholds, iou.device)  # (1, T)
    valid = pred_valid.to(torch.bool)
    gidx = torch.arange(g, device=iou.device)
    matched = torch.zeros((B, th.shape[1], g), dtype=torch.bool, device=iou.device)
    tp = torch.zeros((B, th.shape[1], n), dtype=torch.bool, device=iou.device)
    for i in range(n):
        vals = torch.where(matched, float("-inf"), iou[:, None, i, :])  # (B, T, G)
        best, j = vals.amax(dim=-1), vals.argmax(dim=-1)  # (B, T); -inf when none left
        tp_i = valid[:, i, None] & (best >= th)
        matched |= (gidx == j[..., None]) & tp_i[..., None]
        tp[:, :, i] = tp_i
    return tp


# -- COCO area-band matching (ignore semantics) ------------------------------
#
# GTs outside the band are IGNORED, not removed: a detection may still claim
# an ignored GT, and is then neither TP nor FP. An unmatched detection whose
# own area is outside the band is ignored too. Per detection in score order,
# the best still-unmatched NON-ignored GT with IoU >= t wins (TP); only if
# none qualifies may the best ignored GT be claimed (det ignored); otherwise
# FP unless the detection is out of band (pycocotools' evaluateImg logic,
# matched class-agnostically like the rest of the evaluator).


def _box_areas(boxes: torch.Tensor) -> torch.Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def batched_tp_marks_area(
    pred_boxes: torch.Tensor,  # (B, N, 4) xyxy, each row score-descending
    pred_valid: torch.Tensor,  # (B, N) bool
    gt_boxes: torch.Tensor,    # (B, G, 4) xyxy (same coord space as preds)
    gt_mask: torch.Tensor,     # (B, G) bool
    area_lo: float,
    area_hi: float,
    thresholds: tuple = DEFAULT_THRESHOLDS,
) -> tuple:
    """Area-band greedy marks -> (tp (B, T, N), ign (B, T, N), n_gt_band).

    ``area_lo <= area < area_hi`` defines the band, in squared units of the
    box coordinates. ``n_gt_band`` (int) is the band's recall denominator,
    counted from the same membership predicate the matcher uses."""
    pred_boxes, gt_boxes = pred_boxes.to(torch.float32), gt_boxes.to(torch.float32)
    gt_mask = gt_mask.to(torch.bool)
    g_area = _box_areas(gt_boxes)
    gt_in_band = (g_area >= area_lo) & (g_area < area_hi)  # (B, G)
    p_area = _box_areas(pred_boxes)
    pred_in_band = (p_area >= area_lo) & (p_area < area_hi)  # (B, N)

    iou = _masked_iou(pred_boxes, gt_boxes, gt_mask)  # (B, N, G)
    B, n, g = iou.shape
    th = _thresholds(thresholds, iou.device)  # (1, T)
    valid = pred_valid.to(torch.bool)
    gidx = torch.arange(g, device=iou.device)
    ignored = ~gt_in_band[:, None, :]  # (B, 1, G)
    matched = torch.zeros((B, th.shape[1], g), dtype=torch.bool, device=iou.device)
    tp = torch.zeros((B, th.shape[1], n), dtype=torch.bool, device=iou.device)
    ign = torch.zeros_like(tp)
    for i in range(n):
        cand = torch.where(matched, float("-inf"), iou[:, None, i, :])  # (B, T, G)
        cn = cand.masked_fill(ignored, float("-inf"))
        ci = cand.masked_fill(~ignored, float("-inf"))
        bn, jn = cn.amax(dim=-1), cn.argmax(dim=-1)  # (B, T)
        bi, ji = ci.amax(dim=-1), ci.argmax(dim=-1)
        valid_i = valid[:, i, None]
        tp_i = valid_i & (bn >= th)
        igm_i = valid_i & ~tp_i & (bi >= th)  # claimed an ignored GT
        j = torch.where(tp_i, jn, ji)
        matched |= (gidx == j[..., None]) & (tp_i | igm_i)[..., None]
        tp[:, :, i] = tp_i
        ign[:, :, i] = igm_i | (valid_i & ~tp_i & ~igm_i & ~pred_in_band[:, i, None])
    n_gt_band = int((gt_mask & gt_in_band).sum())
    return tp, ign, n_gt_band
