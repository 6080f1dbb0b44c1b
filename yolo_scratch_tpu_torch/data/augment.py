"""Device-side augmentation on padded batches (port of ``data/augment.py``).

Every op runs on the batch's device, on NHWC float images, with no loop
over images:

* ``hsv_jitter``    -- random HSV gains per image (RGB inputs);
* ``gray_jitter``   -- brightness/contrast for 1-channel imagery;
* ``random_hflip`` / ``random_vflip`` -- with the boxes remapped;
* ``mosaic4``       -- each image tiled with three batch partners into a
  2Sx2S canvas and an SxS window cropped from it, as one gather; boxes
  remapped, clipped, filtered by ``min_box`` and compacted back to G rows;
* ``mixup``         -- a Beta(alpha, alpha) blend with a batch partner that
  is never the image itself, the union of both box sets compacted to G;
* ``letterbox_batch`` -- aspect-preserving resize and centred pad.

Each random op is split into a draw (``draw_*``: the random numbers, from an
explicit ``torch.Generator`` on the batch's device) and an apply (``*_apply``:
a function of the batch and the draws). ``augment_batch`` chains them in the
JAX order: mosaic -> mixup -> hflip -> vflip -> colour. The JAX package draws
from threefry keys, which torch cannot reproduce; with the draws as inputs,
the tests replay the JAX draws into the applies and compare the results.

Batches are the train step's dicts: ``img`` (B, H, W, C) float in [0, 1],
``gt_bboxes`` (B, G, 4) normalised xyxy, ``gt_labels`` (B, G),
``gt_mask`` (B, G) bool; other keys pass through.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class AugmentConfig(NamedTuple):
    hflip_p: float = 0.5
    vflip_p: float = 0.0
    mosaic_p: float = 0.0
    mixup_p: float = 0.0
    mixup_alpha: float = 8.0  # Beta(a, a) blend ratio (YOLOX recipe value)
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    color_p: float = 1.0
    min_box_size: float = 2e-3  # drop boxes smaller than this (normalized)


# ------------------------------------------------------------------ draws


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def beta_draw(gen: torch.Generator, alpha: float, n: int) -> torch.Tensor:
    """(n,) f32 draws of Beta(alpha, alpha) from ``gen`` alone
    (``torch.distributions.Beta`` reads the global generator). An integer
    alpha takes the alpha-th smallest of 2*alpha - 1 uniforms, with no loop;
    any other alpha the ratio of two Marsaglia-Tsang gammas."""
    if alpha == int(alpha) and alpha >= 1:
        a = int(alpha)
        u = _uniform(gen, (n, 2 * a - 1))
        return u.sort(dim=1).values[:, a - 1]
    x, y = _gamma_draw(gen, alpha, n), _gamma_draw(gen, alpha, n)
    return x / (x + y)


def _gamma_draw(gen: torch.Generator, alpha: float, n: int) -> torch.Tensor:
    """(n,) Gamma(alpha, 1) by Marsaglia and Tsang; alpha < 1 through
    Gamma(alpha + 1) * U^(1/alpha)."""
    boost = alpha < 1
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(n, device=gen.device)
    todo = torch.ones(n, dtype=torch.bool, device=gen.device)
    while bool(todo.any()):
        x = torch.randn(n, generator=gen, device=gen.device)
        u = _uniform(gen, (n,))
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if boost:
        out = out * _uniform(gen, (n,)) ** (1.0 / alpha)
    return out


class MosaicDraw(NamedTuple):
    partners: torch.Tensor  # (B, 3) int64
    offsets: torch.Tensor   # (B, 2) f32 in [0, 1): crop offset (x, y) in units of S
    apply: torch.Tensor     # (B,) bool


class MixupDraw(NamedTuple):
    partner: torch.Tensor  # (B,) int64, never the image itself (B > 1)
    lam: torch.Tensor      # (B,) f32
    apply: torch.Tensor    # (B,) bool


class ColorDraw(NamedTuple):
    gains: torch.Tensor  # (B, 3): HSV (h shift, s gain, v gain), or gray (bright, contrast, 0)
    apply: torch.Tensor  # (B,) bool


class AugmentDraws(NamedTuple):
    """One batch's draws; None where the config turns an op off."""
    mosaic: Optional[MosaicDraw] = None
    mixup: Optional[MixupDraw] = None
    hflip: Optional[torch.Tensor] = None  # (B,) bool
    vflip: Optional[torch.Tensor] = None  # (B,) bool
    color: Optional[ColorDraw] = None

    def to(self, device) -> "AugmentDraws":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return type(x)(*(t.to(device) for t in x))
            return x.to(device)

        return AugmentDraws(*(move(x) for x in self))


def draw_mosaic(gen: torch.Generator, B: int, p: float) -> MosaicDraw:
    partners = torch.randint(0, B, (B, 3), generator=gen, device=gen.device)
    return MosaicDraw(partners, _uniform(gen, (B, 2)), _uniform(gen, (B,)) < p)


def draw_mixup(gen: torch.Generator, B: int, p: float, alpha: float = 8.0) -> MixupDraw:
    shift = (torch.randint(1, B, (B,), generator=gen, device=gen.device) if B > 1
             else torch.zeros(B, dtype=torch.long, device=gen.device))
    partner = (torch.arange(B, device=gen.device) + shift) % B
    return MixupDraw(partner, beta_draw(gen, alpha, B), _uniform(gen, (B,)) < p)


def draw_flip(gen: torch.Generator, B: int, p: float) -> torch.Tensor:
    return _uniform(gen, (B,)) < p


def draw_color(gen: torch.Generator, B: int, channels: int, cfg: AugmentConfig) -> ColorDraw:
    """HSV gains for C=3, else gray (brightness, contrast) gains."""
    if channels == 3:
        gains = torch.stack([_uniform(gen, (B,), -cfg.hsv_h, cfg.hsv_h),
                             1.0 + _uniform(gen, (B,), -cfg.hsv_s, cfg.hsv_s),
                             1.0 + _uniform(gen, (B,), -cfg.hsv_v, cfg.hsv_v)], -1)
    else:
        bright = 1.0 + _uniform(gen, (B,), -cfg.hsv_v, cfg.hsv_v)
        contrast = 1.0 + _uniform(gen, (B,), -cfg.hsv_s / 2, cfg.hsv_s / 2)
        gains = torch.stack([bright, contrast, torch.zeros_like(bright)], -1)
    return ColorDraw(gains, _uniform(gen, (B,)) < cfg.color_p)


def draw_augment(gen: torch.Generator, batch_size: int, channels: int,
                 cfg: AugmentConfig = AugmentConfig()) -> AugmentDraws:
    """Every draw ``augment_batch`` needs, in the pipeline's order."""
    B = batch_size
    return AugmentDraws(
        mosaic=draw_mosaic(gen, B, cfg.mosaic_p) if cfg.mosaic_p > 0 else None,
        mixup=draw_mixup(gen, B, cfg.mixup_p, cfg.mixup_alpha) if cfg.mixup_p > 0 else None,
        hflip=draw_flip(gen, B, cfg.hflip_p) if cfg.hflip_p > 0 else None,
        vflip=draw_flip(gen, B, cfg.vflip_p) if cfg.vflip_p > 0 else None,
        color=draw_color(gen, B, channels, cfg) if cfg.color_p > 0 else None)


def batch_generator(seed: int, epoch: int, batch_index: int,
                    device: str | torch.device = "cpu") -> torch.Generator:
    """The generator of one train batch, seeded from (seed, epoch, batch
    index) alone, so a resumed run draws what an uninterrupted one would."""
    state = np.random.SeedSequence([seed, epoch, batch_index]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


# --------------------------------------------------------------- colour ops


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: CUDA turns a division by
    a Python scalar into a multiply by its reciprocal, 1 ulp off the CPU's
    (and XLA's) quotient; a 0-d tensor on the same device divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _select(i: torch.Tensor, vals) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 5], vals)`` for i in 0..5."""
    return torch.stack(vals, -1).gather(-1, i[..., None]).squeeze(-1)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = mx - mn + 1e-12
    # jnp's % is floor-mod: torch.remainder, not fmod
    h = _div(torch.where(mx == r, torch.remainder((g - b) / diff, 6.0),
                         torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0)), 6.0)
    s = diff / (mx + 1e-12)
    return torch.stack([torch.remainder(h, 1.0), s, mx], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int64), 6)
    return torch.stack([_select(i, [v, q, p, p, t, v]), _select(i, [t, v, v, q, p, p]),
                        _select(i, [p, p, t, v, v, q])], -1)


def hsv_apply(img: torch.Tensor, draw: ColorDraw) -> torch.Tensor:
    """HSV gains per image on (B, H, W, 3) in [0, 1]."""
    gains = draw.gains.to(img.dtype)[:, None, None, :]
    hsv = _rgb_to_hsv(img)
    hsv = torch.stack([torch.remainder(hsv[..., 0] + gains[..., 0], 1.0),
                       (hsv[..., 1] * gains[..., 1]).clamp(0, 1),
                       (hsv[..., 2] * gains[..., 2]).clamp(0, 1)], -1)
    return torch.where(draw.apply[:, None, None, None], _hsv_to_rgb(hsv), img)


def gray_apply(img: torch.Tensor, draw: ColorDraw) -> torch.Tensor:
    """Brightness/contrast per image on single-channel imagery."""
    bright = draw.gains[:, 0].to(img.dtype)[:, None, None, None]
    contrast = draw.gains[:, 1].to(img.dtype)[:, None, None, None]
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    out = ((img - mean) * contrast + mean * bright).clamp(0, 1)
    return torch.where(draw.apply[:, None, None, None], out, img)


def hsv_jitter(img: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    return hsv_apply(img, draw_color(gen, img.shape[0], 3, cfg))


def gray_jitter(img: torch.Tensor, gen: torch.Generator, cfg: AugmentConfig) -> torch.Tensor:
    return gray_apply(img, draw_color(gen, img.shape[0], 1, cfg))


# ------------------------------------------------------------------ geometry


def hflip_apply(batch: dict, flip: torch.Tensor) -> dict:
    img, bb = batch["img"], batch["gt_bboxes"]
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    flipped = torch.stack([1.0 - bb[..., 2], bb[..., 1], 1.0 - bb[..., 0], bb[..., 3]], -1)
    return {**batch, "img": img, "gt_bboxes": torch.where(flip[:, None, None], flipped, bb)}


def vflip_apply(batch: dict, flip: torch.Tensor) -> dict:
    img, bb = batch["img"], batch["gt_bboxes"]
    img = torch.where(flip[:, None, None, None], img.flip(1), img)
    flipped = torch.stack([bb[..., 0], 1.0 - bb[..., 3], bb[..., 2], 1.0 - bb[..., 1]], -1)
    return {**batch, "img": img, "gt_bboxes": torch.where(flip[:, None, None], flipped, bb)}


def random_hflip(batch: dict, gen: torch.Generator, p: float) -> dict:
    return hflip_apply(batch, draw_flip(gen, batch["img"].shape[0], p))


def random_vflip(batch: dict, gen: torch.Generator, p: float) -> dict:
    return vflip_apply(batch, draw_flip(gen, batch["img"].shape[0], p))


# -------------------------------------------------------------------- mosaic


def _compact_boxes(bboxes, labels, valid, G: int):
    """Keep up to G valid rows per image, in their order:
    (B, A, 4), (B, A), (B, A) -> (B, G, ...)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :G]
    v = torch.gather(valid, 1, order)
    b = torch.gather(bboxes, 1, order[..., None].expand(-1, -1, 4))
    lbl = torch.gather(labels, 1, order)
    return (torch.where(v[..., None], b, torch.zeros((), dtype=b.dtype, device=b.device)),
            torch.where(v, lbl, torch.zeros((), dtype=lbl.dtype, device=lbl.device)), v)


def _select_rows(apply: torch.Tensor, new: dict, batch: dict) -> dict:
    out = dict(batch)
    for k, v in new.items():
        a = apply.reshape(-1, *([1] * (v.dim() - 1)))
        out[k] = torch.where(a, v, batch[k])
    return out


def mosaic_apply(batch: dict, draw: MosaicDraw, min_box: float = 2e-3) -> dict:
    """Each image i and its three partners tile a 2Hx2W canvas
    [[i, p0], [p1, p2]]; the HxW window at (oy, ox) = trunc(offset * (H, W))
    is cropped out of it. Equivalent to the classic mosaic at a fixed 0.5
    scale: objects shrink 2x and up to four images mix."""
    img, bb = batch["img"], batch["gt_bboxes"]
    lbl, msk = batch["gt_labels"], batch["gt_mask"]
    B, H, W, C = img.shape
    G = bb.shape[1]
    dev = img.device
    ids = torch.cat([torch.arange(B, device=dev)[:, None], draw.partners], 1)  # (B, 4)
    # dynamic_slice clamps the start into the canvas
    oy = (draw.offsets[:, 1] * H).to(torch.int64).clamp(0, H)
    ox = (draw.offsets[:, 0] * W).to(torch.int64).clamp(0, W)
    rows = oy[:, None] + torch.arange(H, device=dev)  # (B, H) canvas rows
    cols = ox[:, None] + torch.arange(W, device=dev)  # (B, W)
    quad = 2 * (rows >= H).to(torch.int64)[:, :, None] + (cols >= W).to(torch.int64)[:, None, :]
    src = torch.gather(ids, 1, quad.reshape(B, -1)).reshape(B, H, W)
    m_img = img[src, (rows % H)[:, :, None], (cols % W)[:, None, :]]

    qoff = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], device=dev,
                        dtype=bb.dtype)
    b4 = bb[ids]  # (B, 4, G, 4), normalized per tile
    fx = _div(ox.to(torch.float32), W).to(bb.dtype)[:, None, None]
    fy = _div(oy.to(torch.float32), H).to(bb.dtype)[:, None, None]
    qx, qy = qoff[None, :, None, 0], qoff[None, :, None, 1]
    boxes = torch.stack([(b4[..., 0] + qx - fx).clamp(0.0, 1.0),
                         (b4[..., 1] + qy - fy).clamp(0.0, 1.0),
                         (b4[..., 2] + qx - fx).clamp(0.0, 1.0),
                         (b4[..., 3] + qy - fy).clamp(0.0, 1.0)], -1).reshape(B, 4 * G, 4)
    valid = (msk[ids].reshape(B, 4 * G)
             & ((boxes[..., 2] - boxes[..., 0]) > min_box)
             & ((boxes[..., 3] - boxes[..., 1]) > min_box))
    cb, cl, cm = _compact_boxes(boxes, lbl[ids].reshape(B, 4 * G), valid, G)
    return _select_rows(draw.apply, {"img": m_img, "gt_bboxes": cb, "gt_labels": cl,
                                     "gt_mask": cm}, batch)


def mosaic4(batch: dict, gen: torch.Generator, p: float, min_box: float = 2e-3) -> dict:
    return mosaic_apply(batch, draw_mosaic(gen, batch["img"].shape[0], p), min_box)


# --------------------------------------------------------------------- mixup


def mixup_apply(batch: dict, draw: MixupDraw) -> dict:
    """Blend each image with its partner at ``lam``; the box sets take
    their union (detection mixup keeps both images' objects), the 2G rows
    compacted back to G."""
    img, bb = batch["img"], batch["gt_bboxes"]
    lbl, msk = batch["gt_labels"], batch["gt_mask"]
    G = bb.shape[1]
    p = draw.partner
    lam = draw.lam.to(img.dtype)[:, None, None, None]
    m_img = lam * img + (1 - lam) * img[p]
    cb, cl, cm = _compact_boxes(torch.cat([bb, bb[p]], 1), torch.cat([lbl, lbl[p]], 1),
                                torch.cat([msk, msk[p]], 1), G)
    return _select_rows(draw.apply, {"img": m_img, "gt_bboxes": cb, "gt_labels": cl,
                                     "gt_mask": cm}, batch)


def mixup(batch: dict, gen: torch.Generator, p: float, alpha: float = 8.0) -> dict:
    return mixup_apply(batch, draw_mixup(gen, batch["img"].shape[0], p, alpha))


# ---------------------------------------------------------------- letterbox


def letterbox_batch(imgs: torch.Tensor, out_size: int, pad_value: float = 114.0 / 255.0
                    ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Aspect-preserving resize of a uniform-size (B, H, W, C) float batch
    to fit ``out_size``, then a centred pad. Bilinear with antialiasing when
    it shrinks, as ``jax.image.resize`` does. Returns (out (B, S, S, C),
    scale, (pad_x, pad_y))."""
    B, H, W, C = imgs.shape
    r = min(out_size / W, out_size / H)
    nw, nh = int(round(W * r)), int(round(H * r))
    resized = F.interpolate(imgs.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=True).permute(0, 2, 3, 1)
    px, py = (out_size - nw) // 2, (out_size - nh) // 2
    out = torch.full((B, out_size, out_size, C), pad_value, dtype=imgs.dtype, device=imgs.device)
    out[:, py:py + nh, px:px + nw] = resized.to(imgs.dtype)
    return out, r, (px, py)


# ------------------------------------------------------------------ pipeline


def apply_augment(batch: dict, draws: AugmentDraws, cfg: AugmentConfig = AugmentConfig()
                  ) -> dict:
    """The pipeline on given draws: mosaic -> mixup -> flips -> colour
    (HSV for C=3, else gray)."""
    if draws.mosaic is not None:
        batch = mosaic_apply(batch, draws.mosaic, cfg.min_box_size)
    if draws.mixup is not None:
        batch = mixup_apply(batch, draws.mixup)
    if draws.hflip is not None:
        batch = hflip_apply(batch, draws.hflip)
    if draws.vflip is not None:
        batch = vflip_apply(batch, draws.vflip)
    if draws.color is not None:
        colour = hsv_apply if batch["img"].shape[-1] == 3 else gray_apply
        batch = {**batch, "img": colour(batch["img"], draws.color)}
    return batch


def augment_batch(batch: dict, gen: torch.Generator, cfg: AugmentConfig = AugmentConfig()
                  ) -> dict:
    """Draw from ``gen`` (on the batch's device) and apply the pipeline."""
    B, _, _, C = batch["img"].shape
    return apply_augment(batch, draw_augment(gen, B, C, cfg), cfg)
