"""Plain postprocess of a detector's maps into the packed (B, max_det, 7)
rows [x1 y1 x2 y2 score label valid], boxes normalised by the image side and
clamped to [0, 1].

``postprocess`` dispatches on the configuration's ``family`` to
``reference/<family>.py``'s ``postprocess``, which returns (packed, keep
(B, K), valid (B, K)); K is 0 for a family without NMS. The NMS families
here draw candidates and hand them to ``nms_and_pack`` (greedy NMS, then
``pack``):

* YOLO11 (DFL head): candidates ranked on the largest class logit in the
  maps' own dtype, ties to the lower anchor (the floats' total order,
  -0.0 below +0.0); the selected rows decoded: softmax over each side's
  ``reg_max`` bins, the expectation, ``dist2bbox`` around the anchor
  centres (grid + 0.5) times the stride; score the sigmoid of the logit.
* YOLOX: every anchor decoded, xy = (raw + grid) * stride, wh =
  exp(clamp(raw, +-20)) * stride; per-class confidence obj * cls; the best
  class's; candidates ranked on it, ties to the lower anchor.

Greedy NMS: a box is kept when valid and not suppressed; it suppresses
every later box whose IoU, ``inter / (area_i + area_j - inter + 1e-6)``,
exceeds the threshold. The first ``max_det`` kept rows are packed in score
order, ties to the earlier candidate.

``dtype`` sets the precision of the decode and the IoU (float32 as the
configurations state; bfloat16 for the control).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

_KEYS = {torch.float32: (torch.int32, 31, 0x7FFFFFFF),
         torch.bfloat16: (torch.int16, 15, 0x7FFF),
         torch.float16: (torch.int16, 15, 0x7FFF)}


def order_key(x: torch.Tensor) -> torch.Tensor:
    """Integers in the floats' total order."""
    itype, shift, mask = _KEYS[x.dtype]
    bits = x.view(itype)
    return bits ^ ((bits >> shift) & mask)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, equal values lower index
    first."""
    idx = torch.sort(order_key(x), dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def anchors(hws: Sequence[Tuple[int, int]], strides: Sequence[float], offset: float, device):
    """(points (A, 2) x first, strides (A, 1)), levels in order, rows y-outer."""
    pts, st = [], []
    for (h, w), s in zip(hws, strides):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) + offset,
                                torch.arange(w, dtype=torch.float32, device=device) + offset,
                                indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        st.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(st)


def _flat(feats: List[torch.Tensor]) -> torch.Tensor:
    B = feats[0].shape[0]
    return torch.cat([f.reshape(B, -1, f.shape[-1]) for f in feats], 1)


def yolo11_candidates(feats, nc, strides, reg_max, conf, k, dtype=torch.float32):
    """-> boxes xyxy (B, K, 4), scores (B, K), labels (B, K), valid (B, K),
    in ``dtype``; K = min(k, A)."""
    x = _flat(feats)
    B, A, _ = x.shape
    pts, st = anchors([f.shape[1:3] for f in feats], strides, 0.5, x.device)
    logit = x[..., 4 * reg_max:].amax(-1)
    ok = torch.sigmoid(logit.float()) > conf
    top, idx = topk_stable(logit.masked_fill(~ok, float("-inf")), min(k, A))
    valid = torch.isfinite(top)
    scores = torch.sigmoid(top.float()).masked_fill(~valid, 0.0).to(dtype)
    sel = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1])).to(dtype)
    labels = sel[..., 4 * reg_max:].argmax(-1)
    bins = torch.arange(reg_max, dtype=dtype, device=x.device)
    dist = (sel[..., :4 * reg_max].unflatten(-1, (4, reg_max)).softmax(-1) * bins).sum(-1)
    p, s = pts[idx].to(dtype), st[idx].to(dtype)
    lo, hi = p - dist[..., :2], p + dist[..., 2:]
    c, wh = (lo + hi) / 2 * s, (hi - lo) * s
    boxes = torch.cat([c - wh * 0.5, c + wh * 0.5], -1)
    return boxes, scores, labels, valid


def yolox_candidates(feats, nc, strides, conf, k, dtype=torch.float32):
    """As :func:`yolo11_candidates`, for YOLOX maps [reg(4), obj, cls(nc)]."""
    x = _flat(feats).to(dtype)
    B, A, _ = x.shape
    pts, st = anchors([f.shape[1:3] for f in feats], strides, 0.0, x.device)
    pts, st = pts.to(dtype), st.to(dtype)
    xy = (x[..., :2] + pts) * st
    wh = torch.exp(x[..., 2:4].clamp(-20.0, 20.0)) * st
    conf_cls = torch.sigmoid(x[..., 4:5]) * torch.sigmoid(x[..., 5:])
    scores, labels = conf_cls.amax(-1), conf_cls.argmax(-1)
    ok = scores > conf
    top, idx = topk_stable(scores.masked_fill(~ok, float("-inf")), min(k, A))
    valid = torch.isfinite(top)
    c = torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2))
    w = torch.gather(wh, 1, idx[..., None].expand(-1, -1, 2))
    boxes = torch.cat([c - w * 0.5, c + w * 0.5], -1)
    return boxes, top.masked_fill(~valid, 0.0), torch.gather(labels, 1, idx), valid


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy NMS over score-sorted rows, batched over images: keep (B, N)."""
    thr = torch.tensor(float(np.float32(thr)), dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    n = boxes.shape[1]
    later = torch.arange(n, device=boxes.device)
    supp = torch.zeros_like(valid)
    for i in range(n):
        kept = valid[:, i:i + 1] & ~supp[:, i:i + 1]
        w = (torch.minimum(x2, x2[:, i:i + 1]) - torch.maximum(x1, x1[:, i:i + 1])).clamp(min=0)
        h = (torch.minimum(y2, y2[:, i:i + 1]) - torch.maximum(y1, y1[:, i:i + 1])).clamp(min=0)
        inter = w * h
        iou = inter / (area + area[:, i:i + 1] - inter + 1e-6)
        supp |= kept & (iou > thr) & (later > i)
    return valid & ~supp


def pack(boxes, scores, labels, keep, max_det: int, img_size: int) -> torch.Tensor:
    """The first ``max_det`` kept rows, score-descending -> (B, max_det, 7)."""
    B, n = scores.shape
    rank = keep.to(torch.int64).cumsum(-1) - 1
    keep = keep & (rank < max_det)
    s, order = topk_stable(scores.float().masked_fill(~keep, float("-inf")), min(max_det, n))
    v = torch.isfinite(s)
    b = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    out = torch.zeros((B, max_det, 7), dtype=torch.float32, device=boxes.device)
    m = v[..., None]
    out[:, :order.shape[1], :4] = torch.where(m, (b / img_size).clamp(0.0, 1.0), 0.0)
    out[:, :order.shape[1], 4] = torch.where(v, s, 0.0)
    out[:, :order.shape[1], 5] = torch.where(v, torch.gather(labels, 1, order).float(), 0.0)
    out[:, :order.shape[1], 6] = v.float()
    return out


def nms_and_pack(boxes, scores, labels, valid, traffic):
    """Greedy NMS over candidates in score order, then the packed rows:
    (packed (B, max_det, 7), keep before the cap (B, K), valid (B, K))."""
    keep = greedy_keep(boxes, valid, float(traffic["iou"]))
    return pack(boxes, scores, labels, keep, int(traffic["max_det"]),
                int(traffic["img_size"])), keep, valid


def postprocess(cfg, feats, traffic, dtype=torch.float32):
    """Maps -> (packed (B, max_det, 7), keep before the cap (B, K), valid
    (B, K)): the whole plain postprocess of the configuration's family."""
    from . import family

    return family(cfg).postprocess(cfg, feats, traffic, dtype)
