"""Task-Aligned Assigner on tensors (port of ``losses/tal.py``).

Semantics are the JAX package's, quirks included:

* ``topk`` is never used for candidate selection (PARITY.md #4): the
  positive-candidate mask is "anchor centre strictly inside a valid GT";
* force pass 1: a valid GT with no candidate takes its best-IoU anchor among
  the in-box anchors (best overall if none is in its box);
* multi-GT anchors resolve to the max-IoU GT (:func:`_select_highest_overlaps`);
* force pass 2: a valid GT that no anchor maps to takes its best-IoU anchor,
  *sequentially in GT order* (a loop over G, so later GTs see earlier forced
  updates), then a final :func:`_select_highest_overlaps`.

The JAX package looks rows up with one-hot contractions (TPU gathers are
slow). After conflict resolution every foreground row of ``mask_pos`` is
one-hot at ``target_gt_idx`` and every background row is zero with index 0,
so plain gathers give the same values exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yolo_scratch_tpu_torch.ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int
    target_bboxes: torch.Tensor  # (B, A, 4)
    target_scores: torch.Tensor  # (B, A, nc)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def _candidates_in_gts(anc_points: torch.Tensor, gt_bboxes: torch.Tensor,
                       eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) x (B, G, 4) -> (B, A, G) float: centre strictly inside box."""
    ax = anc_points[None, :, None, 0]  # (1, A, 1)
    ay = anc_points[None, :, None, 1]
    x1 = gt_bboxes[:, None, :, 0]  # (B, 1, G)
    y1 = gt_bboxes[:, None, :, 1]
    x2 = gt_bboxes[:, None, :, 2]
    y2 = gt_bboxes[:, None, :, 3]
    m = torch.minimum(torch.minimum(ax - x1, ay - y1), torch.minimum(x2 - ax, y2 - ay))
    return (m > eps).to(torch.float32)


def _one_hot(idx: torch.Tensor, n: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, axis=dim)``: out-of-range indices give a
    zero row."""
    ar = torch.arange(n, device=idx.device)
    shape = [1] * (idx.dim() + 1)
    shape[dim] = n
    return (idx.unsqueeze(dim) == ar.view(shape)).to(dtype)


def _select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor):
    """Resolve anchors assigned to several GTs by max IoU. Returns
    (target_gt_idx (B, A), fg (B, A) float, mask_pos (B, A, G) float)."""
    G = mask_pos.shape[-1]
    fg = mask_pos.sum(-1)
    multi = fg[..., None] > 1
    is_max = _one_hot(overlaps.argmax(dim=-1), G, -1, mask_pos.dtype)
    mask_pos = torch.where(multi, is_max, mask_pos)
    fg = mask_pos.sum(-1)
    return mask_pos.argmax(dim=-1), fg, mask_pos


def task_aligned_assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoided
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    anc_points: torch.Tensor,  # (A, 2) pixels
    gt_labels: torch.Tensor,  # (B, G) int
    gt_bboxes: torch.Tensor,  # (B, G, 4) xyxy pixels, zero-padded
    mask_gt: torch.Tensor,  # (B, G) bool
    num_classes: int,
    alpha: float = 0.5,
    beta: float = 4.0,
    eps: float = 1e-9,
) -> AssignResult:
    """Assign GTs to anchors; all shapes static. Callers pass detached
    predictions (the reference runs the assigner under ``no_grad``)."""
    B, A, nc = pd_scores.shape
    G = gt_bboxes.shape[1]
    mask_gt = mask_gt.to(torch.bool)

    # --- metrics (reference get_box_metrics) ---
    overlaps = bbox_iou(pd_bboxes[:, :, None, :], gt_bboxes[:, None, :, :],
                        xywh=False, CIoU=False)[..., 0].clamp(min=0)  # (B, A, G)
    labels_idx = gt_labels.long().clamp(0, nc - 1)  # padded rows are 0
    cls_scores = pd_scores.gather(2, labels_idx[:, None, :].expand(B, A, G))  # (B, A, G)
    align_metric = cls_scores.pow(alpha) * overlaps.pow(beta)

    # --- candidate mask (reference get_pos_mask) ---
    mask_in_gts = _candidates_in_gts(anc_points, gt_bboxes)
    mask_pos = mask_in_gts * mask_gt.to(torch.float32)[:, None, :]  # (B, A, G)

    # --- force pass 1: per GT, order-independent ---
    assigned_any = mask_pos.sum(dim=1) > 0  # (B, G)
    has_in = mask_in_gts.sum(dim=1) > 0
    best_all = overlaps.argmax(dim=1)  # (B, G)
    best = torch.where(has_in, (overlaps * mask_in_gts).argmax(dim=1), best_all)
    need1 = mask_gt & ~assigned_any
    mask_pos = torch.where(need1[:, None, :], _one_hot(best, A, 1, mask_pos.dtype), mask_pos)

    # --- first conflict resolution ---
    tgi, fg, mask_pos = _select_highest_overlaps(mask_pos, overlaps)

    # --- force pass 2: sequential in GT order ---
    anchors = torch.arange(A, device=overlaps.device)
    forced_cols = []
    for g in range(G):
        assigned = ((fg > 0) & (tgi == g)).any(dim=1)  # (B,)
        need = mask_gt[:, g] & ~assigned
        forced = need[:, None] & (anchors[None, :] == best_all[:, g:g + 1])  # (B, A)
        tgi = torch.where(forced, g, tgi)
        fg = torch.where(forced, 1.0, fg)
        forced_cols.append(forced)
    mask_pos = torch.maximum(mask_pos, torch.stack(forced_cols, -1).to(mask_pos.dtype))

    # --- final recompute ---
    tgi, fg, mask_pos = _select_highest_overlaps(mask_pos, overlaps)

    # --- targets (reference get_targets) ---
    target_labels = gt_labels.gather(1, tgi).clamp(0, num_classes)
    target_bboxes = gt_bboxes.gather(1, tgi[..., None].expand(B, A, 4))
    target_scores = _one_hot(target_labels, num_classes, -1, torch.float32)
    target_scores = torch.where(fg[..., None] > 0, target_scores, 0.0)

    # --- align-metric renormalisation ---
    am = align_metric * mask_pos
    pos_align = am.amax(dim=-1, keepdim=True)  # (B, A, 1)
    pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (am * pos_overlaps / (pos_align + eps)).amax(dim=-1)  # (B, A)
    target_scores = target_scores * norm[..., None]

    return AssignResult(target_labels, target_bboxes, target_scores, fg > 0, tgi)
