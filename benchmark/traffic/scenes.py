"""The one scene generator: seeded images, and for training their boxes,
drawn on the device in a few large calls per object slot.

Two kinds of scene, named by a configuration's ``scene``:

* ``craters`` (gray): the crater tiles of the port's ``gen_crater_synth``,
  redrawn here: background ``U * 0.18 + 0.45`` mixed 0.8 / 0.2 with a
  16-pixel block texture, each crater a dark filled axis-aligned ellipse
  (floor ``0.10 + 0.12 * class``) inside a bright rim (``r2`` in (1, 1.45]).
* ``shapes`` (RGB): the COCO-shaped scenes of the port's ``gen_coco_synth``,
  redrawn here: a noisy background of random level with a sine texture,
  each object one of eight shapes (disk, square, triangle, ring, cross,
  diamond, hbar, vbar; ``class % 8``) in its class bucket's hue, radius
  ``U * S / 10 + S / 24``.

A traffic mix sets the counts and sizes: ``objects`` [lo, hi] per image,
and for craters ``semimajor`` [lo, hi] as a share of the image side. Every
seed draws the same shapes of arrays; only their contents differ.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

SHAPES = 8


def _grid(S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ax = torch.arange(S, device=device, dtype=torch.float32)
    return ax[None, None, :], ax[None, :, None]  # xx (1, 1, S), yy (1, S, 1)


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _counts(gen, B: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.randint(lo, hi + 1, (B,), generator=gen, device=device)


def craters(gen, B: int, S: int, nc: int, objects, semimajor, device):
    """-> (images (B, S, S, 1) f32 in [0, 1], boxes (B, K, 4) xyxy pixels,
    labels (B, K) int64, mask (B, K) bool)."""
    xx, yy = _grid(S, device)
    img = _u(gen, (B, S, S), 0.45, 0.63, device)
    coarse = torch.rand((B, S // 16, S // 16), generator=gen, device=device)
    tex = coarse.repeat_interleave(16, 1).repeat_interleave(16, 2)
    img[:, :tex.shape[1], :tex.shape[2]] = 0.8 * img[:, :tex.shape[1], :tex.shape[2]] + 0.2 * tex
    K = int(objects[1])
    n = _counts(gen, B, int(objects[0]), K, device)
    a = _u(gen, (B, K), S * semimajor[0], S * semimajor[1], device)
    b = a * _u(gen, (B, K), 0.6, 1.0, device)
    cx = (a + 2) + (S - 2 * a - 4) * torch.rand((B, K), generator=gen, device=device)
    cy = (b + 2) + (S - 2 * b - 4) * torch.rand((B, K), generator=gen, device=device)
    cls = torch.randint(0, nc, (B, K), generator=gen, device=device)
    mask = torch.arange(K, device=device)[None] < n[:, None]
    for k in range(K):
        r2 = (((xx - cx[:, k, None, None]) / a[:, k, None, None]) ** 2
              + ((yy - cy[:, k, None, None]) / b[:, k, None, None]) ** 2)
        on = mask[:, k, None, None]
        floor = (0.10 + 0.12 * cls[:, k]).to(torch.float32)[:, None, None]
        img = torch.where(on & (r2 <= 1.0), img * 0.25 + floor, img)
        img = torch.where(on & (r2 > 1.0) & (r2 <= 1.45),
                          torch.clamp(img * 1.35 + 0.15, max=1.0), img)
    boxes = torch.stack([cx - a, cy - b, cx + a, cy + b], -1)
    return img.clamp(0.0, 1.0)[..., None], boxes, cls, mask


def _hue(bucket: torch.Tensor, n_buckets: int) -> torch.Tensor:
    h = bucket.to(torch.float32)[..., None] / n_buckets
    base = torch.cat([(h * 6 - 3).abs() - 1, 2 - (h * 6 - 2).abs(), 2 - (h * 6 - 4).abs()], -1)
    return (base.clamp(0, 1) * 0.7 + 0.3) * 255


def shapes(gen, B: int, S: int, nc: int, objects, device):
    """-> (images (B, S, S, 3) f32 in [0, 1], boxes, labels, mask) as
    :func:`craters`."""
    xx, yy = _grid(S, device)
    level = _u(gen, (B, 1, 1, 1), 0.0, 120.0, device)
    img = torch.rand((B, S, S, 3), generator=gen, device=device) * 40 + level
    freq = _u(gen, (B, 1, 1, 1), 0.0, 6.0, device)
    img = img + torch.sin(xx[..., None] / max(S - 1, 1) * freq) * 15
    img = img.clamp(0, 255).floor()
    K = int(objects[1])
    n = _counts(gen, B, int(objects[0]), K, device)
    cls = torch.randint(0, nc, (B, K), generator=gen, device=device)
    r = _u(gen, (B, K), S / 24, S / 24 + S / 10, device)
    cx = 2 * r + (S - 4 * r) * torch.rand((B, K), generator=gen, device=device)
    cy = 2 * r + (S - 4 * r) * torch.rand((B, K), generator=gen, device=device)
    n_buckets = -(-nc // SHAPES)
    jitter = torch.randn((B, K, 3), generator=gen, device=device) * 10
    color = (_hue(cls // SHAPES, n_buckets) + jitter).clamp(30, 255).floor()
    mask = torch.arange(K, device=device)[None] < n[:, None]
    kind = cls % SHAPES
    for k in range(K):
        dx = xx - cx[:, k, None, None]
        dy = yy - cy[:, k, None, None]
        rr = r[:, k, None, None]
        d2 = dx * dx + dy * dy
        ax, ay = dx.abs(), dy.abs()
        masks = torch.stack([
            d2 <= rr * rr,
            (ax <= rr) & (ay <= rr),
            (dy >= -rr) & (dy <= rr) & (ax <= (rr - dy) / 2 + 1),
            (d2 <= rr * rr) & (d2 >= (0.55 * rr) ** 2),
            ((ax <= rr * 0.3) & (ay <= rr)) | ((ay <= rr * 0.3) & (ax <= rr)),
            ax + ay <= rr,
            (ax <= rr) & (ay <= rr * 0.35),
            (ay <= rr) & (ax <= rr * 0.35),
        ], 1)  # (B, 8, S, S)
        m = torch.gather(masks, 1, kind[:, k, None, None, None].expand(-1, 1, S, S))[:, 0]
        m = m & mask[:, k, None, None]
        img = torch.where(m[..., None], color[:, k, None, None, :], img)
    boxes = torch.stack([(cx - r).clamp(min=0), (cy - r).clamp(min=0),
                         (cx + r).clamp(max=S), (cy + r).clamp(max=S)], -1)
    return img / 255.0, boxes, cls, mask


def draw(cfg: Dict, traffic: Dict, gen, B: int, device):
    """One batch of the configuration's scene at the mix's sizes."""
    S, nc = int(traffic["img_size"]), int(cfg["nc"])
    if cfg["scene"] == "craters":
        return craters(gen, B, S, nc, traffic["objects"], traffic["semimajor"], device)
    if cfg["scene"] == "shapes":
        return shapes(gen, B, S, nc, traffic["objects"], device)
    raise ValueError(f"no scene {cfg['scene']!r}")


def image_pool(cfg: Dict, traffic: Dict, gen, device) -> np.ndarray:
    """(pool, B, S, S, C) uint8 on the host, pageable, as a deployment's
    host prep hands them over."""
    B = int(traffic["batch"])
    out = []
    for _ in range(int(traffic["pool"])):
        img = draw(cfg, traffic, gen, B, device)[0]
        out.append((img * 255.0 + 0.5).to(torch.uint8).cpu().numpy())
    return np.stack(out)


def train_pool(cfg: Dict, traffic: Dict, gen, device):
    """A list of the trainer's batches: ``img`` (B, S, S, C) f32 in [0, 1],
    ``gt_labels`` (B, G) int32, ``gt_bboxes`` (B, G, 4) f32 normalised xyxy,
    ``gt_mask`` (B, G) bool, G = ``max_gt``; numpy on the host, as the
    port's loader gives them."""
    B, S, G = int(traffic["batch"]), int(traffic["img_size"]), int(traffic["max_gt"])
    out = []
    for _ in range(int(traffic["pool"])):
        img, boxes, cls, mask = draw(cfg, traffic, gen, B, device)
        K = boxes.shape[1]
        if K > G:
            raise ValueError(f"objects up to {K} exceed max_gt {G}")
        bb = torch.zeros((B, G, 4), device=device)
        ll = torch.zeros((B, G), dtype=torch.int32, device=device)
        mm = torch.zeros((B, G), dtype=torch.bool, device=device)
        bb[:, :K] = torch.where(mask[..., None], boxes / S, 0.0)
        ll[:, :K] = torch.where(mask, cls, 0).to(torch.int32)
        mm[:, :K] = mask
        # the trainer's images are what the loader decodes: 8-bit levels
        img8 = (img * 255.0 + 0.5).floor() / 255.0
        out.append({"img": img8.cpu().numpy(), "gt_labels": ll.cpu().numpy(),
                    "gt_bboxes": bb.cpu().numpy(), "gt_mask": mm.cpu().numpy()})
    return out
