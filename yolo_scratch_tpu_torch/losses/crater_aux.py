"""Crater-specific auxiliary losses on tensors (port of
``losses/crater_aux.py``), differentiable through autograd:

* centre-weighted CIoU;
* objectness BCE (target -1 ignored);
* masked classification CE (ignore index -1);
* angular coverage: the polar bins as a one-hot bin-matrix contraction;
* rim-weighted mask BCE + Dice: erode/dilate as min/max pooling;
* ellipse consistency: image moments as weighted sums, the covariance's
  eigen-decomposition in closed form (2x2).

Every clip and max/min is ``torch.maximum``/``torch.minimum`` against a
tensor bound, whose gradient at a tie splits in half as JAX's
``jnp.clip``/``jnp.maximum`` does (``clamp`` passes all of it); ``|x|``
has JAX's gradient 1 at 0 (``abs`` gives 0); and the ``where`` guards
around ``sqrt`` and division are JAX's, so gradients at degenerate inputs
match ``jax.grad``'s. The comparisons have a zero gradient in both
frameworks: the coverage penalty keeps it on the graph (so ``backward``
reaches its mask); the ellipse's thresholded mask has no path (a live
one would carry sqrt's infinite slope at 0 into NaN), so its loss reaches
autograd through the box.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _lo(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.clip(x, lo, None)``: the gradient at x == lo halves."""
    return torch.maximum(x, x.new_tensor(lo))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: its gradient at 0 is 1 (``abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _bce_logits(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _lo(logits, 0.0) - logits * t + torch.log1p(torch.exp(-_abs(logits)))


# ------------------------------------------------------- centre-weighted CIoU


def center_weighted_ciou_loss(
    pred_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    center_weight: float = 2.0,
    size_weight: float = 1.0,
    eps: float = 1e-7,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paired (N, 4) xyxy boxes -> scalar mean loss:
    (1 - IoU) + cw * rho^2 / c^2 + sw * ((dw / tw)^2 + (dh / th)^2)."""
    px1, py1, px2, py2 = pred_boxes.split(1, -1)
    tx1, ty1, tx2, ty2 = target_boxes.split(1, -1)

    ix1, iy1 = torch.maximum(px1, tx1), torch.maximum(py1, ty1)
    ix2, iy2 = torch.minimum(px2, tx2), torch.minimum(py2, ty2)
    inter = _lo(ix2 - ix1, 0.0) * _lo(iy2 - iy1, 0.0)
    pa = (px2 - px1) * (py2 - py1)
    ta = (tx2 - tx1) * (ty2 - ty1)
    iou = inter / (pa + ta - inter + eps)

    pcx, pcy = (px1 + px2) / 2, (py1 + py2) / 2
    tcx, tcy = (tx1 + tx2) / 2, (ty1 + ty2) / 2
    rho2 = (pcx - tcx) ** 2 + (pcy - tcy) ** 2
    cw_ = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch_ = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw_ ** 2 + ch_ ** 2 + eps

    pw, ph = px2 - px1, py2 - py1
    tw, th = tx2 - tx1, ty2 - ty1
    size_term = ((pw - tw) / (tw + eps)) ** 2 + ((ph - th) / (th + eps)) ** 2

    loss = ((1.0 - iou) + center_weight * (rho2 / c2) + size_weight * size_term)[..., 0]
    if weights is not None:
        return (loss * weights).sum() / _lo(weights.sum(), 1.0)
    return loss.mean()


# ------------------------------------------------------------ objectness/cls


def objectness_loss(pred_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Masked BCE; target -1 = ignore."""
    valid = (target >= 0).to(pred_logits.dtype)
    t = torch.minimum(_lo(target, 0.0), target.new_tensor(1.0))
    bce = _bce_logits(pred_logits, t)
    vs = valid.sum()
    return torch.where(vs > 0, (bce * valid).sum() / _lo(vs, 1.0), 0.0)


def classification_loss(pred_logits: torch.Tensor, target: torch.Tensor,
                        valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked CE with ignore index -1: pred (..., nc) logits, target (...)
    int in [-1, nc)."""
    nc = pred_logits.shape[-1]
    valid = (target != -1).to(pred_logits.dtype)
    if valid_mask is not None:
        valid = valid * valid_mask.to(pred_logits.dtype)
    t = target.clamp(0, nc - 1)
    logp = torch.log_softmax(pred_logits, dim=-1)
    onehot = t[..., None] == torch.arange(nc, dtype=t.dtype, device=t.device)
    ce = -torch.where(onehot, logp, 0.0).sum(dim=-1)
    vs = valid.sum()
    return torch.where(vs > 0, (ce * valid).sum() / _lo(vs, 1.0), 0.0)


# --------------------------------------------------------- angular coverage


def angular_coverage_loss(
    mask: torch.Tensor,  # (B, H, W) or (B, H, W, 1) probabilities
    centers: torch.Tensor,  # (B, 2) normalized (cx, cy)
    valid: torch.Tensor | None = None,  # (B,)
    num_bins: int = 36,
    min_activation: float = 0.1,
    penalty_weight: float = 1.0,
) -> torch.Tensor:
    """Fraction of under-activated polar bins around each centre: the bin
    of a pixel is its atan2 angle about the centre, a bin is penalised when
    its MEAN activation is below ``min_activation`` (a bin without pixels
    reads 0); penalty * the batch mean. A step function of the mask: its
    gradient is zero, as ``jax.grad``'s, and kept on the graph."""
    if mask.dim() == 4:
        mask = mask[..., 0]
    B, H, W = mask.shape
    dev = mask.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    cx = centers[:, 0, None, None] * W
    cy = centers[:, 1, None, None] * H
    ang = torch.atan2(ys[None] - cy, xs[None] - cx)  # (B, H, W)
    binf = (ang + math.pi) / (2 * math.pi) * num_bins
    bins = binf.detach().to(torch.int32).clamp(0, num_bins - 1)
    onehot = F.one_hot(bins.long(), num_bins).to(mask.dtype)  # (B, H, W, nb)
    sums = torch.einsum("bhw,bhwk->bk", mask, onehot)
    counts = onehot.sum(dim=(1, 2))
    means = sums / _lo(counts, 1.0)
    # the comparison's zero gradient, on the graph (so autograd reaches mask)
    under = (means < min_activation).to(mask.dtype) + 0.0 * means
    per_sample = under.sum(-1) / num_bins
    if valid is not None:
        v = valid.to(mask.dtype)
        return penalty_weight * (per_sample * v).sum() / _lo(v.sum(), 1.0)
    return penalty_weight * per_sample.mean()


# ------------------------------------------------------- rim-weighted mask


def _binary_erode(m: torch.Tensor, k: int = 3) -> torch.Tensor:
    """cv2.erode(k x k) of a {0, 1} (B, H, W) mask: a min-pool (the
    border padded with +inf, as ``reduce_window``'s)."""
    return -F.max_pool2d(-m[:, None], k, 1, k // 2)[:, 0]


def _binary_dilate(m: torch.Tensor, k: int = 3) -> torch.Tensor:
    return F.max_pool2d(m[:, None], k, 1, k // 2)[:, 0]


def rim_weighted_mask_loss(
    pred_logits: torch.Tensor,  # (B, H, W) or (B, H, W, 1)
    target_mask: torch.Tensor,  # same shape, {0, 1}
    rim_weight: float = 4.0,
    bg_weight: float = 0.5,
    rim_kernel: int = 3,
    use_dice: bool = True,
    dice_weight: float = 0.5,
) -> torch.Tensor:
    """BCE weighted rim (x4) / interior (x1) / background (x0.5) + Dice;
    the rim band is dilate(mask - erode(mask))."""
    if pred_logits.dim() == 4:
        pred_logits = pred_logits[..., 0]
        target_mask = target_mask[..., 0]
    tbin = (target_mask > 0.5).to(pred_logits.dtype)
    eroded = _binary_erode(tbin, 3)
    boundary = (tbin - eroded).clamp(0.0, 1.0)
    rim = (_binary_dilate(boundary, rim_kernel) > 0.5).to(pred_logits.dtype)

    weights = torch.full_like(tbin, bg_weight)
    weights = torch.where((tbin > 0.5) & (rim < 0.5), 1.0, weights)
    weights = torch.where(rim > 0.5, rim_weight, weights)

    weighted_bce = (_bce_logits(pred_logits, tbin) * weights).mean()
    if not use_dice:
        return weighted_bce
    p = torch.sigmoid(pred_logits)
    inter = (p * tbin).sum()
    union = p.sum() + tbin.sum()
    dice = (2.0 * inter + 1e-6) / (union + 1e-6)
    return (1.0 - dice_weight) * weighted_bce + dice_weight * (1.0 - dice)


# ---------------------------------------------------- ellipse consistency


def mask_to_ellipse(mask: torch.Tensor):
    """Image moments -> ellipse parameters per (B, H, W) mask, thresholded
    at 0.5: (cx, cy, a, b, angle_rad, valid), a >= b in pixels, axes =
    2 sqrt(eigenvalue)."""
    B, H, W = mask.shape
    dev = mask.device
    m = (mask > 0.5).to(torch.float32)  # no gradient path: jax.grad's is zero
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    m00 = m.sum(dim=(1, 2))
    valid = m00 >= 10.0
    denom = _lo(m00, 1e-6)
    cx = (m * xs).sum(dim=(1, 2)) / denom
    cy = (m * ys).sum(dim=(1, 2)) / denom
    dx = xs - cx[:, None, None]
    dy = ys - cy[:, None, None]
    mu20 = (m * dx * dx).sum(dim=(1, 2)) / denom
    mu02 = (m * dy * dy).sum(dim=(1, 2)) / denom
    mu11 = (m * dx * dy).sum(dim=(1, 2)) / denom
    tr = mu20 + mu02
    det = mu20 * mu02 - mu11 * mu11
    disc = torch.sqrt(_lo(tr * tr - 4 * det, 0.0))
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    valid = valid & (det >= 0) & (l2 >= 0)
    a = 2.0 * torch.sqrt(_lo(l1, 0.0))
    b = 2.0 * torch.sqrt(_lo(l2, 0.0))
    angle = torch.where((mu20 - mu02).abs() < 1e-6, 0.0,
                        0.5 * torch.atan2(2 * mu11, mu20 - mu02))
    return cx, cy, a, b, angle, valid


def ellipse_consistency_loss(
    mask: torch.Tensor,  # (B, H, W) probabilities
    bbox: torch.Tensor,  # (B, 4) normalized cx-cy-w-h
    center_weight: float = 1.0,
    axis_weight: float = 1.0,
    angle_weight: float = 0.5,
) -> torch.Tensor:
    """Mask-derived against box-implied ellipse: normalised centre L2 +
    axis-ratio absolute error + orientation penalty scaled by the mask
    ellipse's elongation. Masks with too few pixels contribute zero."""
    B, H, W = mask.shape
    mcx, mcy, ma, mb, mang, valid = mask_to_ellipse(mask)
    v = valid.to(mask.dtype)

    bcx, bcy = bbox[:, 0] * W, bbox[:, 1] * H
    bw, bh = bbox[:, 2] * W, bbox[:, 3] * H
    ba = torch.maximum(bw, bh) / 2.0
    bb_ = torch.minimum(bw, bh) / 2.0

    diag = math.sqrt(H * H + W * W)
    center_term = torch.sqrt((mcx - bcx) ** 2 + (mcy - bcy) ** 2 + 1e-12) / diag
    m_ratio = mb / _lo(ma, 1e-6)
    b_ratio = bb_ / _lo(ba, 1e-6)
    axis_term = _abs(m_ratio - b_ratio)
    ecc = 1.0 - m_ratio
    angle_term = ecc * _abs(torch.sin(mang))

    per = center_weight * center_term + axis_weight * axis_term + angle_weight * angle_term
    return (per * v).sum() / _lo(v.sum(), 1.0)
