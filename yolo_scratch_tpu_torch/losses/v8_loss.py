"""v8-style detection loss (CIoU + DFL + BCE) on tensors (port of
``losses/v8_loss.py``).

Constants as in the JAX package: assigner alpha 0.5 / beta 4.0, loss gains
box 7.5 / cls 0.5 / dfl 1.5, reg_max 16, total scaled by the batch size.

The reference's emergency all-IoU fallback, taken when the assigner returns
no foreground, is a ``lax.cond`` in the JAX package. Here both branches are
computed and :func:`torch.where` selects on a device flag, so a step never
waits for the host to read that flag.

Targets arrive padded to a static max-GT count (zero-padded boxes, a
validity mask).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from yolo_scratch_tpu_torch.losses.tal import task_aligned_assign
from yolo_scratch_tpu_torch.nn.modules import dfl_expectation
from yolo_scratch_tpu_torch.ops.anchors import make_anchors
from yolo_scratch_tpu_torch.ops.boxes import bbox2dist, bbox_iou, dist2bbox


class DetectionLossConfig(NamedTuple):
    nc: int
    strides: Sequence[float]
    reg_max: int = 16
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5
    tal_alpha: float = 0.5
    tal_beta: float = 4.0


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: pred (..., 4, reg_max) logits, target (..., 4)
    -> (...,), two-bin interpolated cross-entropy, mean over the 4 sides.
    A gather of the two bins equals the JAX package's masked sum exactly
    (one nonzero term)."""
    reg_max = pred_dist.shape[-1]
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, dim=-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(dim=-1)


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits in the JAX package's formula (not
    ``F.binary_cross_entropy_with_logits``, so the last bits agree)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _fallback_assign(pred_bboxes_px, gt_labels, gt_bboxes_px, mask_gt, nc):
    """The reference's emergency fallback: pure best-IoU per GT. Its
    sequential B x G loop lets later GTs overwrite earlier ones at the same
    anchor, so each anchor takes the highest valid GT index whose best-IoU
    anchor it is. Returns (labels, boxes, scores, fg)."""
    A = pred_bboxes_px.shape[1]
    G = gt_bboxes_px.shape[1]
    ious = bbox_iou(pred_bboxes_px[:, :, None, :], gt_bboxes_px[:, None, :, :],
                    xywh=False, CIoU=False)[..., 0]  # (B, A, G)
    best = ious.argmax(dim=1)  # (B, G)
    anchors = torch.arange(A, device=ious.device)
    match = (best[:, None, :] == anchors[None, :, None]) & mask_gt.to(torch.bool)[:, None, :]
    g_ids = torch.arange(G, device=ious.device)
    g_sel = torch.where(match, g_ids, -1).amax(dim=-1)  # (B, A), -1 = background
    fg = g_sel >= 0
    g_safe = g_sel.clamp(min=0)
    tb = gt_bboxes_px.gather(1, g_safe[..., None].expand(-1, -1, 4))
    tb = torch.where(fg[..., None], tb, 0.0)
    tl = torch.where(fg, gt_labels.long().gather(1, g_safe), nc)
    ts = (tl[..., None] == torch.arange(nc, device=tl.device)).to(torch.float32) * fg[..., None]
    return tl, tb, ts, fg


def v8_detection_loss(
    feats: Sequence[torch.Tensor],  # raw Detect maps, NHWC (B, Hi, Wi, 4*reg_max+nc)
    gt_labels: torch.Tensor,  # (B, G) int, zero-padded
    gt_bboxes: torch.Tensor,  # (B, G, 4) xyxy normalised [0, 1], zero-padded
    gt_mask: torch.Tensor,  # (B, G) bool
    cfg: DetectionLossConfig,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Returns (total loss scalar, loss_items (3,) = weighted box/cls/dfl,
    detached); total is ``loss_items.sum() * batch_size``.

    ``reduce`` (a sum over the ranks of a mesh, ``parallel/collectives.py``)
    makes the batch-wide quantities global: the fallback's fg and GT
    counts, ``target_scores_sum`` and the batch size. Each rank's total and
    items are then its share of the global batch's, and their sum over the
    ranks is the global value."""
    nc, reg_max = cfg.nc, cfg.reg_max
    no = nc + 4 * reg_max
    B = feats[0].shape[0]
    gt_mask = gt_mask.to(torch.bool)

    flat = torch.cat([f.reshape(B, -1, no) for f in feats], dim=1)  # (B, A, no)
    pred_distri, pred_scores = flat[..., : 4 * reg_max], flat[..., 4 * reg_max:]

    anchor_points, stride_tensor = make_anchors(
        [(f.shape[1], f.shape[2], s) for f, s in zip(feats, cfg.strides)], 0.5,
        dtype=flat.dtype, device=flat.device)
    # imgsz scaling of normalised targets (reference preprocess)
    img_h = feats[0].shape[1] * cfg.strides[0]
    img_w = feats[0].shape[2] * cfg.strides[0]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=flat.dtype, device=flat.device)
    gt_bboxes_px = gt_bboxes * scale * gt_mask[..., None]

    # decode (grid units, reference bbox_decode)
    pred_dist_exp = dfl_expectation(pred_distri, reg_max)  # (B, A, 4)
    pred_bboxes = dist2bbox(pred_dist_exp, anchor_points[None], xywh=False, dim=-1)
    pred_bboxes_px = pred_bboxes * stride_tensor[None]

    target_labels, target_bboxes, target_scores, fg_mask, _ = task_aligned_assign(
        pred_scores.detach().sigmoid(),
        pred_bboxes_px.detach(),
        anchor_points * stride_tensor,
        gt_labels,
        gt_bboxes_px,
        gt_mask,
        num_classes=nc,
        alpha=cfg.tal_alpha,
        beta=cfg.tal_beta,
    )

    # emergency fallback, both branches computed (see the module docstring)
    fb = _fallback_assign(pred_bboxes_px.detach(), gt_labels, gt_bboxes_px, gt_mask, nc)
    num_fg, num_gt = fg_mask.sum(), gt_mask.sum()
    scores_sum, fb_scores_sum = target_scores.sum(), fb[2].sum()
    nb = B
    if reduce is not None:
        num_fg, num_gt, scores_sum, fb_scores_sum, nb = reduce(torch.stack(
            [num_fg.to(flat.dtype), num_gt.to(flat.dtype), scores_sum, fb_scores_sum,
             torch.tensor(B, dtype=flat.dtype, device=flat.device)])).unbind()
    use_fallback = (num_fg == 0) & (num_gt > 0)
    target_labels, target_bboxes, target_scores, fg_mask = (
        torch.where(use_fallback, f, t) for f, t in zip(
            fb, (target_labels, target_bboxes, target_scores, fg_mask)))

    fg_f = fg_mask.to(flat.dtype)
    target_scores_sum = torch.where(use_fallback, fb_scores_sum, scores_sum).clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores, target_scores).sum() / target_scores_sum

    # box + dfl on foreground (reference BboxLoss)
    tb_grid = target_bboxes / stride_tensor[None]
    # safe substitute at masked positions: a unit box around the anchor
    # (avoids 0/0 -> NaN inside CIoU, which would poison the masked sum)
    safe_box = torch.cat([anchor_points - 0.5, anchor_points + 0.5], dim=-1)[None]
    tb_safe = torch.where(fg_mask[..., None], tb_grid, safe_box.expand_as(tb_grid))

    weight = target_scores.sum(-1) * fg_f  # (B, A)
    ciou = bbox_iou(pred_bboxes, tb_safe, xywh=False, CIoU=True)[..., 0]
    loss_box = ((1.0 - ciou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], tb_safe, reg_max - 1)
    dfl = _df_loss(pred_distri.reshape(B, -1, 4, reg_max), target_ltrb)  # (B, A)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    loss_items = torch.stack(
        [loss_box * cfg.box_weight, loss_cls * cfg.cls_weight, loss_dfl * cfg.dfl_weight])
    total = loss_items.sum() * nb
    return total, loss_items.detach()
