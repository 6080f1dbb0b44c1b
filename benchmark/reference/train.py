"""Plain float32 training of YOLOX: the loss with SimOTA assignment (arXiv
2107.08430), then clip-by-global-norm, AdamW and the EMA, written out in
plain PyTorch.

The loss (per batch, normalised by the number of foreground anchors):
5 * IoU loss (1 - IoU^2 of the decoded box with its assigned GT) + the
objectness BCE over every anchor + the class BCE over foreground anchors
against one-hot targets scaled by the matched IoU. No L1 term (the
recipe adds it in its last 15 epochs only with mosaic off; this cell's
configuration leaves it off).

SimOTA per image: candidates are anchors whose centre ((grid + 0.5) *
stride) lies inside a GT box or within 2.5 strides of its centre; cost =
BCE(sqrt(sig(cls) * sig(obj)), onehot) + 3 * -log(IoU + 1e-8) + 1e6 for
each of: not in box and centre, not a candidate, padded GT; each GT takes
its k cheapest candidates, k = int(sum of its top-10 candidate IoUs) >= 1;
an anchor claimed twice keeps its cheapest GT.

The update (optax's ``clip_by_global_norm`` then ``adamw``): g scaled by
``clip / |g|`` where ``|g| >= clip``; m = b1 m + (1 - b1) g, v = b2 v +
(1 - b2) g^2; p -= lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) +
wd * p). The EMA after each update: e = d e + (1 - d) p with d = decay *
(1 - exp(-(t + 1) / tau)), t the updates before this one.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

STRIDES = (8.0, 16.0, 32.0)
WH_CAP = 20.0


def _anchors(outs, offset: float = 0.0):
    pts, st = [], []
    for o, s in zip(outs, STRIDES):
        h, w = o.shape[1], o.shape[2]
        gy, gx = torch.meshgrid(torch.arange(h, device=o.device, dtype=torch.float32) + offset,
                                torch.arange(w, device=o.device, dtype=torch.float32) + offset,
                                indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        st.append(torch.full((h * w,), s, device=o.device))
    return torch.cat(pts), torch.cat(st)


def _iou_all(a, b, eps=1e-6):
    """(B, N, 4) x (B, M, 4) xyxy -> (B, N, M)."""
    a, b = a[:, :, None], b[:, None]
    w = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    h = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = w * h
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def _bce(p, t, eps=1e-8):
    return -(t * torch.log(p + eps) + (1.0 - t) * torch.log(1.0 - p + eps))


@torch.no_grad()
def simota(boxes, obj, cls, pts, strides, gt, labels, mask, nc):
    """One image at a time: (fg (A,), matched gt (A,), matched IoU (A,))."""
    A, G = boxes.shape[0], gt.shape[0]
    ax = ((pts[:, 0] + 0.5) * strides)[:, None]
    ay = ((pts[:, 1] + 0.5) * strides)[:, None]
    gx1, gy1, gx2, gy2 = (gt[:, i][None] for i in range(4))
    in_box = (ax > gx1) & (ax < gx2) & (ay > gy1) & (ay < gy2)
    r = 2.5 * strides[:, None]
    in_ctr = ((ax - (gx1 + gx2) / 2).abs() < r) & ((ay - (gy1 + gy2) / 2).abs() < r)
    gm = mask[None]
    cand = (in_box | in_ctr) & gm
    anyc = cand.any(1)
    both = in_box & in_ctr & gm
    ious = _iou_all(boxes[None], gt[None])[0] * gm
    joint = torch.sqrt(torch.sigmoid(cls) * torch.sigmoid(obj)[:, None])
    onehot = F.one_hot(labels.long().clamp(0, nc - 1), nc).to(joint.dtype)
    cost = _bce(joint[:, None, :], onehot[None]).sum(-1)
    cost = cost + 3.0 * -torch.log(ious + 1e-8) + 1e6 * (~both) + 1e6 * (~anyc[:, None]) \
        + 1e6 * (~gm)
    top = torch.where(cand, ious, torch.zeros_like(ious)).t().topk(min(10, A), dim=-1).values
    k = top.sum(-1).to(torch.int32).clamp(1, A)
    rank = torch.argsort(torch.argsort(cost, dim=0, stable=True), dim=0, stable=True)
    match = (rank < k[None]) & cand
    multi = match.sum(1) > 1
    best = F.one_hot(cost.argmin(1), G).bool()
    match = torch.where(multi[:, None], match & best, match)
    fg = match.any(1)
    return fg, match.to(torch.uint8).argmax(1), (ious * match).sum(1) * fg


def _bce_logits(z, t):
    return z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


def yolox_loss(outs: List[torch.Tensor], batch: Dict[str, torch.Tensor], nc: int):
    """(total loss, foreground anchors per image) of raw NHWC maps [reg(4),
    obj, cls(nc)] on a batch."""
    B = outs[0].shape[0]
    x = torch.cat([o.reshape(B, -1, 5 + nc) for o in outs], 1)
    pts, strides = _anchors(outs)
    xy = (x[..., :2] + pts) * strides[:, None]
    wl = x[..., 2:4]
    capped = wl.clamp(-WH_CAP, WH_CAP)
    out = torch.isfinite(wl) & (wl.abs() > WH_CAP)
    through = torch.where(out, wl, torch.zeros_like(wl))
    wh = torch.exp(capped + (through - through.detach())) * strides[:, None]
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    obj, cls = x[..., 4], x[..., 5:]
    S = outs[0].shape[1] * STRIDES[0]
    mask = batch["gt_mask"].bool()
    gt = batch["gt_bboxes"].float() * S * mask[..., None]
    labels = batch["gt_labels"]
    parts = [simota(boxes[i].detach(), obj[i].detach(), cls[i].detach(), pts, strides, gt[i],
                    labels[i], mask[i], nc) for i in range(B)]
    fg = torch.stack([p[0] for p in parts])
    idx = torch.stack([p[1] for p in parts])
    miou = torch.stack([p[2] for p in parts])
    fgf = fg.float()
    n_fg = fgf.sum().clamp(min=1.0)
    tgt = torch.gather(gt, 1, idx[..., None].expand(-1, -1, 4)) * fgf[..., None]
    tgt = torch.where(fg[..., None], tgt, boxes)
    tl = torch.gather(labels.long(), 1, idx) * fg.long()
    ix1 = torch.maximum(boxes[..., 0], tgt[..., 0])
    iy1 = torch.maximum(boxes[..., 1], tgt[..., 1])
    ix2 = torch.minimum(boxes[..., 2], tgt[..., 2])
    iy2 = torch.minimum(boxes[..., 3], tgt[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    pa = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
          * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    ta = (tgt[..., 2] - tgt[..., 0]) * (tgt[..., 3] - tgt[..., 1])
    iou = inter / (pa + ta - inter + 1e-16)
    l_iou = ((1.0 - iou ** 2) * fgf).sum() / n_fg
    l_obj = _bce_logits(obj, fgf).sum() / n_fg
    target = F.one_hot(tl, nc).float() * miou[..., None]
    l_cls = (_bce_logits(cls, target) * fgf[..., None]).sum() / n_fg
    return 5.0 * l_iou + l_obj + l_cls, float(fgf.sum()) / B


class Trainer:
    """The plain step: forward (train-mode BN), loss, backward, clip,
    AdamW, EMA; float32 with TF32 off (the caller's ``full_f32``)."""

    def __init__(self, model, hp: Dict, nc: int):
        self.model, self.hp, self.nc = model, hp, nc
        self.params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.ema = {k: p.detach().clone() for k, p in self.params.items()}
        self.t = 0

    def step(self, batch: Dict[str, torch.Tensor]):
        """One step; returns (loss, the clipped gradients by name,
        foreground anchors per image)."""
        hp = self.hp
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss, n_fg = yolox_loss(self.model(batch["img"]), batch, self.nc)
        loss.backward()
        with torch.no_grad():
            g = {k: p.grad for k, p in self.params.items()}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
            if norm >= hp["clip_norm"]:
                g = {k: x * (hp["clip_norm"] / norm) for k, x in g.items()}
            b1, b2 = hp["betas"]
            self.t += 1
            c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
            d = hp["ema_decay"] * (1.0 - math.exp(-self.t / hp["ema_tau"]))
            for k, p in self.params.items():
                self.m[k].mul_(b1).add_(g[k], alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g[k], g[k], value=1.0 - b2)
                upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + hp["eps"])
                p.add_(upd + hp["weight_decay"] * p, alpha=-hp["lr"])
                self.ema[k].mul_(d).add_(p, alpha=1.0 - d)
        return float(loss.detach()), g, n_fg
