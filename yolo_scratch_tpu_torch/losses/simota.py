"""SimOTA label assignment and the YOLOX training loss (port of
``losses/simota.py``; the published recipe, arXiv 2107.08430). Per image:

1. candidates: anchors whose centre lies inside a GT box or inside the
   2.5-stride centre region of a GT;
2. cost(a, g) = BCE(sqrt(cls_sig * obj_sig), onehot_g) + 3 * (-log IoU)
   + big * not(in-box and in-centre);
3. dynamic k per GT: k_g = clamp(int(sum of its top-10 candidate IoUs), 1);
4. each GT takes its k_g cheapest anchors (a double stable argsort ranks
   them); an anchor claimed by several GTs keeps its cheapest (first index
   on ties).

The cost adds its 1e6 terms in the JAX order, so the f32 roundings, and the
exact ties they make among non-"both" anchors, are the JAX package's. The
assignment runs without autograd, a chunk of images at a time: its
(A, G, nc) class-cost temporaries take 269 MB an image at A=8400, G=100,
nc=80.

Loss: 5 * IoU loss (1 - iou^2) + obj BCE + cls BCE (targets onehot times
the matched IoU), each summed over the batch / num_fg; optional L1 on the
raw regression for the no-augmentation end phase.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from yolo_scratch_tpu_torch.models.yolox import WH_LOGIT_CAP
from yolo_scratch_tpu_torch.ops.anchors import make_anchors
from yolo_scratch_tpu_torch.ops.boxes import pairwise_iou

# elements of one (chunk, A, G, nc) class-cost temporary
ASSIGN_CHUNK_ELEMS = 1 << 26


class SimOTAResult(NamedTuple):
    fg_mask: torch.Tensor      # (..., A) bool
    matched_gt: torch.Tensor   # (..., A) int64
    matched_iou: torch.Tensor  # (..., A) float: IoU with the assigned GT (0 on bg)


def _bce_prob(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return -(t * torch.log(p + eps) + (1.0 - t) * torch.log(1.0 - p + eps))


@torch.no_grad()
def simota_assign(
    pred_boxes: torch.Tensor,  # (B, A, 4) xyxy pixels (decoded)
    obj_logits: torch.Tensor,  # (B, A)
    cls_logits: torch.Tensor,  # (B, A, nc)
    anchors: torch.Tensor,     # (A, 2) grid-cell corners, grid units per level
    strides: torch.Tensor,     # (A,)
    gt_boxes: torch.Tensor,    # (B, G, 4) xyxy pixels, zero-padded
    gt_labels: torch.Tensor,   # (B, G)
    gt_mask: torch.Tensor,     # (B, G) bool
    center_radius: float = 2.5,
    topk: int = 10,
) -> SimOTAResult:
    """SimOTA over a batch (the JAX function vmapped)."""
    B, A, nc = cls_logits.shape
    G = gt_boxes.shape[1]
    big = 1e6

    # anchor centres in pixels ((grid + 0.5) * stride, the YOLOX convention)
    ax = ((anchors[:, 0] + 0.5) * strides)[None, :, None]  # (1, A, 1)
    ay = ((anchors[:, 1] + 0.5) * strides)[None, :, None]
    gx1, gy1 = gt_boxes[..., 0][:, None], gt_boxes[..., 1][:, None]  # (B, 1, G)
    gx2, gy2 = gt_boxes[..., 2][:, None], gt_boxes[..., 3][:, None]
    gcx, gcy = (gx1 + gx2) / 2, (gy1 + gy2) / 2
    gm = gt_mask[:, None, :]

    in_box = (ax > gx1) & (ax < gx2) & (ay > gy1) & (ay < gy2)  # (B, A, G)
    r = center_radius * strides[None, :, None]
    in_center = ((ax - gcx).abs() < r) & ((ay - gcy).abs() < r)
    valid_pair = (in_box | in_center) & gm
    fg_cand = valid_pair.any(dim=2)  # (B, A)
    both = in_box & in_center & gm

    ious = torch.vmap(pairwise_iou)(pred_boxes, gt_boxes) * gm
    iou_cost = -torch.log(ious + 1e-8)

    joint = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[..., None])
    onehot = F.one_hot(gt_labels.long().clamp(0, nc - 1), nc).to(joint.dtype)  # (B, G, nc)
    cls_cost = _bce_prob(joint[:, :, None, :], onehot[:, None, :, :]).sum(-1)  # (B, A, G)

    cost = (cls_cost + 3.0 * iou_cost + big * (~both) + big * (~fg_cand[..., None])
            + big * (~gm))

    # dynamic k per GT from its top-k candidate IoUs
    cand_ious = torch.where(valid_pair, ious, torch.zeros((), dtype=ious.dtype,
                                                          device=ious.device))
    top_ious = cand_ious.transpose(1, 2).topk(min(topk, A), dim=-1).values  # (B, G, k)
    dynamic_k = top_ious.sum(-1).to(torch.int32).clamp(1, A)  # (B, G)

    # rank anchors per GT by ascending cost (double stable argsort)
    order = torch.argsort(cost, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)  # (B, A, G)
    matching = (ranks < dynamic_k[:, None, :]) & valid_pair

    # an anchor claimed by several GTs keeps its cheapest
    multi = matching.sum(dim=2) > 1
    only_best = F.one_hot(cost.argmin(dim=2), G).to(torch.bool)
    matching = torch.where(multi[..., None], matching & only_best, matching)

    fg = matching.any(dim=2)
    matched_gt = matching.to(torch.uint8).argmax(dim=2)
    matched_iou = (ious * matching).sum(dim=2) * fg
    return SimOTAResult(fg, matched_gt, matched_iou)


class YOLOXLossConfig(NamedTuple):
    nc: int
    strides: Sequence[float] = (8.0, 16.0, 32.0)
    iou_weight: float = 5.0
    use_l1: bool = False


def _assign_chunked(pred_boxes, obj_logits, cls_logits, anchors, strides, gt_px, gt_labels,
                    gt_mask) -> SimOTAResult:
    """``simota_assign`` on as many images at a time as keep one class-cost
    temporary under ``ASSIGN_CHUNK_ELEMS`` elements."""
    B, A, nc = cls_logits.shape
    step = max(1, ASSIGN_CHUNK_ELEMS // max(A * gt_px.shape[1] * nc, 1))
    parts = [simota_assign(pred_boxes[i:i + step], obj_logits[i:i + step],
                           cls_logits[i:i + step], anchors, strides, gt_px[i:i + step],
                           gt_labels[i:i + step], gt_mask[i:i + step])
             for i in range(0, B, step)]
    return SimOTAResult(*(torch.cat(t) for t in zip(*parts)))


def _bce_logits(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


def yolox_loss(
    outs: Sequence[torch.Tensor],  # raw head maps, NHWC (B, Hi, Wi, 4+1+nc)
    gt_labels: torch.Tensor,       # (B, G)
    gt_bboxes: torch.Tensor,       # (B, G, 4) normalized xyxy
    gt_mask: torch.Tensor,         # (B, G)
    cfg: YOLOXLossConfig,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Returns (total, dict(iou_loss, obj_loss, cls_loss, l1_loss, num_fg)),
    the dict detached. ``reduce`` (a sum over the ranks of a mesh) makes
    ``num_fg`` and the batch size global: each rank's total and items are
    then its share of the global batch's."""
    nc = cfg.nc
    no = 5 + nc
    B = outs[0].shape[0]
    flat = torch.cat([o.reshape(B, -1, no) for o in outs], 1)  # (B, A, no)
    dt, dev = flat.dtype, flat.device
    anchor_points, stride_t = make_anchors(
        [(o.shape[1], o.shape[2], s) for o, s in zip(outs, cfg.strides)], 0.0, dtype=dt,
        device=dev)
    strides1 = stride_t[:, 0]

    raw_reg = flat[..., :4]
    obj_logits = flat[..., 4]
    cls_logits = flat[..., 5:]

    xy = (raw_reg[..., :2] + anchor_points[None]) * stride_t[None]
    # Straight-through cap: exp sees the clipped logit (finite), while an
    # out-of-band finite logit still gets unit gradient. The forward value
    # is exactly clip(l) for any input: x - x.detach() is 0 on finite x, and
    # the where zeroes it for non-finite x (l - (l - clip(l)).detach() gives
    # inf - inf = NaN on an inf logit).
    wh_logit = raw_reg[..., 2:4]
    capped = wh_logit.clamp(-WH_LOGIT_CAP, WH_LOGIT_CAP)
    outside = torch.isfinite(wh_logit) & (wh_logit.abs() > WH_LOGIT_CAP)
    passthru = torch.where(outside, wh_logit, torch.zeros((), dtype=dt, device=dev))
    wh_logit = capped + (passthru - passthru.detach())
    wh = torch.exp(wh_logit) * stride_t[None]
    pred_boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)  # (B, A, 4) px

    img_h = outs[0].shape[1] * cfg.strides[0]
    img_w = outs[0].shape[2] * cfg.strides[0]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=dt, device=dev)
    gt_mask = gt_mask.to(torch.bool)
    gt_px = gt_bboxes.to(dt) * scale * gt_mask[..., None]

    assign = _assign_chunked(pred_boxes.detach(), obj_logits.detach(), cls_logits.detach(),
                             anchor_points, strides1, gt_px, gt_labels, gt_mask)
    fg = assign.fg_mask  # (B, A)
    fg_f = fg.to(dt)
    num_fg = fg_f.sum()
    nb = B
    if reduce is not None:
        num_fg, nb = reduce(torch.stack(
            [num_fg, torch.tensor(B, dtype=dt, device=dev)])).unbind()
    num_fg = num_fg.clamp(min=1.0)

    # the JAX package contracts a one-hot (exact); a gather gives the same
    idx = assign.matched_gt
    tgt_boxes = torch.gather(gt_px, 1, idx[..., None].expand(-1, -1, 4)) * fg_f[..., None]
    safe_tgt = torch.where(fg[..., None], tgt_boxes, pred_boxes)
    tgt_labels = torch.gather(gt_labels.long(), 1, idx) * fg.long()

    # IoU loss: 1 - iou^2 (the YOLOX IOUloss default)
    x1 = torch.maximum(pred_boxes[..., 0], safe_tgt[..., 0])
    y1 = torch.maximum(pred_boxes[..., 1], safe_tgt[..., 1])
    x2 = torch.minimum(pred_boxes[..., 2], safe_tgt[..., 2])
    y2 = torch.minimum(pred_boxes[..., 3], safe_tgt[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    pa = ((pred_boxes[..., 2] - pred_boxes[..., 0]).clamp(min=0)
          * (pred_boxes[..., 3] - pred_boxes[..., 1]).clamp(min=0))
    ta = (safe_tgt[..., 2] - safe_tgt[..., 0]) * (safe_tgt[..., 3] - safe_tgt[..., 1])
    iou = inter / (pa + ta - inter + 1e-16)
    loss_iou = ((1.0 - iou ** 2) * fg_f).sum() / num_fg

    loss_obj = _bce_logits(obj_logits, fg_f).sum() / num_fg

    cls_target = F.one_hot(tgt_labels, nc).to(dt) * assign.matched_iou[..., None]
    loss_cls = (_bce_logits(cls_logits, cls_target) * fg_f[..., None]).sum() / num_fg

    loss_l1 = torch.zeros((), dtype=dt, device=dev)
    if cfg.use_l1:
        # targets encoded back to raw-regression space
        t_cx = (safe_tgt[..., 0] + safe_tgt[..., 2]) / 2
        t_cy = (safe_tgt[..., 1] + safe_tgt[..., 3]) / 2
        t_w = (safe_tgt[..., 2] - safe_tgt[..., 0]).clamp(min=1e-3)
        t_h = (safe_tgt[..., 3] - safe_tgt[..., 1]).clamp(min=1e-3)
        l1_t = torch.stack([t_cx / strides1[None] - anchor_points[None, :, 0],
                            t_cy / strides1[None] - anchor_points[None, :, 1],
                            torch.log(t_w / strides1[None]),
                            torch.log(t_h / strides1[None])], -1)
        loss_l1 = ((raw_reg - l1_t).abs().sum(-1) * fg_f).sum() / num_fg

    total = cfg.iou_weight * loss_iou + loss_obj + loss_cls + loss_l1
    aux = {"iou_loss": loss_iou, "obj_loss": loss_obj, "cls_loss": loss_cls,
           "l1_loss": loss_l1, "num_fg": fg_f.sum() / nb}
    return total, {k: v.detach() for k, v in aux.items()}
