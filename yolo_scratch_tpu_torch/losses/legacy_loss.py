"""The legacy combined loss of the YOLOScratch family (port of
``losses/legacy_loss.py``).

Per-scale dict predictions (``models/legacy.py``): the bbox loss
(centre-weighted CIoU) on positive cells only, through the sigmoid/exp
decode; objectness BCE with -1 ignored; CE classification masked to the
positive cells; per-scale averages, then a weighted sum.
``build_legacy_targets`` assigns each ground truth to the grid cell that
holds its centre, at every scale.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from yolo_scratch_tpu_torch.losses.crater_aux import (
    center_weighted_ciou_loss,
    classification_loss,
    objectness_loss,
)
from yolo_scratch_tpu_torch.models.legacy import decode_legacy_bbox


class LegacyLossConfig(NamedTuple):
    bbox_weight: float = 5.0
    objectness_weight: float = 1.0
    class_weight: float = 0.5
    center_weight: float = 2.0
    size_weight: float = 1.0


def build_legacy_targets(
    gt_labels: torch.Tensor,  # (B, G) int
    gt_bboxes: torch.Tensor,  # (B, G, 4) normalized xyxy
    gt_mask: torch.Tensor,  # (B, G) bool
    feat_hw: Sequence[tuple],  # [(H_s, W_s), ...] per scale
) -> List[Dict[str, torch.Tensor]]:
    """Centre-cell assignment per scale: the cell holding a valid GT's
    centre gets objectness 1, the class id and the normalised cx-cy-w-h
    box (w, h at least 0.01); a later GT overwrites an earlier one at the
    same cell. Every other cell is negative (objectness 0, class -1)."""
    B, G = gt_mask.shape
    dev = gt_bboxes.device
    cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    w = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    h = gt_bboxes[..., 3] - gt_bboxes[..., 1]
    gts = torch.arange(G, device=dev)

    targets = []
    for (H, W) in feat_hw:
        gx = (cx * W).to(torch.int32).clamp(0, W - 1)
        gy = (cy * H).to(torch.int32).clamp(0, H - 1)
        cell = (gy * W + gx).long()  # (B, G)
        # last write wins: each cell takes its highest valid g
        match = (cell[:, None, :] == torch.arange(H * W, device=dev)[None, :, None]) \
            & gt_mask[:, None, :].bool()
        g_sel = torch.where(match, gts[None, None, :], -1).amax(dim=-1)  # (B, H*W)
        pos = g_sel >= 0
        gsafe = g_sel.clamp(min=0)

        def gather(src):
            return torch.gather(src, 1, gsafe)

        floor = gt_bboxes.new_tensor(0.01)
        obj = pos.to(torch.float32).reshape(B, H, W, 1)
        cls = torch.where(pos, gather(gt_labels), -1).reshape(B, H, W)
        bb = torch.stack([gather(cx), gather(cy), torch.maximum(gather(w), floor),
                          torch.maximum(gather(h), floor)], dim=-1)
        bb = torch.where(pos[..., None], bb, 0.0).reshape(B, H, W, 4)
        targets.append({"objectness": obj, "classes": cls, "bbox": bb})
    return targets


def legacy_yolo_loss(
    predictions: List[Dict[str, torch.Tensor]],
    targets: List[Dict[str, torch.Tensor]],
    cfg: LegacyLossConfig = LegacyLossConfig(),
) -> Dict[str, torch.Tensor]:
    """Combined loss over per-scale dict predictions (NHWC maps)."""
    n_scales = len(predictions)
    tb = to = tc = 0.0
    for pred, tgt in zip(predictions, targets):
        pos = tgt["objectness"][..., 0] > 0.5  # (B, H, W)
        pred_xyxy = decode_legacy_bbox(pred["bbox"])  # (B, H, W, 4)
        t = tgt["bbox"]
        tgt_xyxy = torch.stack([t[..., 0] - t[..., 2] / 2, t[..., 1] - t[..., 3] / 2,
                                t[..., 0] + t[..., 2] / 2, t[..., 1] + t[..., 3] / 2], dim=-1)
        # masked mean over the positive cells
        safe_t = torch.where(pos[..., None], tgt_xyxy, t.new_tensor([0.0, 0.0, 0.5, 0.5]))
        tb = tb + center_weighted_ciou_loss(
            pred_xyxy.reshape(-1, 4), safe_t.reshape(-1, 4), cfg.center_weight,
            cfg.size_weight, weights=pos.reshape(-1).to(torch.float32))
        to = to + objectness_loss(pred["objectness"][..., 0], tgt["objectness"][..., 0])
        tc = tc + classification_loss(pred["classes"], tgt["classes"], valid_mask=pos)

    tb, to, tc = tb / n_scales, to / n_scales, tc / n_scales
    total = cfg.bbox_weight * tb + cfg.objectness_weight * to + cfg.class_weight * tc
    return {"total_loss": total, "bbox_loss": tb, "objectness_loss": to, "class_loss": tc}
