"""YOLOX family: CSPDarknet backbone, PAFPN neck, decoupled head (port of
``models/yolox.py``; the published recipe, arXiv 2107.08430).

The blocks run NCHW inside, on the port's ``ConvBNAct`` (flax-style BN
statistics). :class:`YOLOXModel` takes NHWC images and returns one NHWC map
per level with 4+1+nc channels, [reg(4), obj(1), cls(nc)] as logits, as the
JAX model does. Submodule names are the flax tree's (``backbone.dark2_csp.
m_0_cv1``, ``head.cls_conv_0_1``, ``neck.C3_p4``), so a port ``state_dict``
key is the JAX variable path joined by dots
(``utils/weights.py::state_dict_from_jax``).

Anchor-free decode: xy = (raw + grid) * stride, wh = exp(raw) * stride, the
wh logit capped at ``WH_LOGIT_CAP``. Scales follow the paper: nano
(0.33/0.25), tiny (0.33/0.375), s (0.33/0.50), m (0.67/0.75), l (1.0/1.0),
x (1.33/1.25).
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolo_scratch_tpu_torch.nn.modules import ConvBNAct, upsample2x
from yolo_scratch_tpu_torch.ops.anchors import make_anchors

SCALES = {
    "nano": (0.33, 0.25),
    "tiny": (0.33, 0.375),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}


def scale_name(scale: str) -> str:
    """A CLI's ``--scale`` -> a ``SCALES`` key (``n`` is nano)."""
    return {"n": "nano"}.get(scale, scale)


# exp() guard for the anchor-free decode: |logit| <= 20 keeps a decoded box
# <= e^20 * stride, so IoU area products stay finite in f32
WH_LOGIT_CAP = 20.0


class Focus(nn.Module):
    """Space-to-depth stem: (B, C, H, W) -> (B, 4C, H/2, W/2) -> conv. The
    channel order is the NHWC model's [tl, bl, tr, br]."""

    def __init__(self, c1: int, c2: int, k: int = 3):
        super().__init__()
        self.conv = ConvBNAct(4 * c1, c2, k, 1)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], 1))


class CSPLayer(nn.Module):
    """C3 block: two 1x1 branches, n bottlenecks (1x1 -> 3x3) on one,
    concat, fuse."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", ConvBNAct(c_, c_, 1, 1))
            self.add_module(f"m_{i}_cv2", ConvBNAct(c_, c_, 3, 1))
        self.cv2 = ConvBNAct(c1, c_, 1, 1)
        self.cv3 = ConvBNAct(2 * c_, c2, 1, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}_cv2")(getattr(self, f"m_{i}_cv1")(a))
            a = a + y if self.shortcut else y
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling with max pools 5/9/13 (stride 1, -inf pad)."""

    def __init__(self, c1: int, c2: int, ks: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.ks = ks
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * (len(ks) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.ks], 1))


class CSPDarknet(nn.Module):
    def __init__(self, in_ch: int = 3, depth: float = 0.33, width: float = 0.50):
        super().__init__()
        base = int(64 * width)
        d = max(round(3 * depth), 1)
        self.stem = Focus(in_ch, base, 3)
        self.dark2_conv = ConvBNAct(base, base * 2, 3, 2)
        self.dark2_csp = CSPLayer(base * 2, base * 2, d)
        self.dark3_conv = ConvBNAct(base * 2, base * 4, 3, 2)
        self.dark3_csp = CSPLayer(base * 4, base * 4, d * 3)
        self.dark4_conv = ConvBNAct(base * 4, base * 8, 3, 2)
        self.dark4_csp = CSPLayer(base * 8, base * 8, d * 3)
        self.dark5_conv = ConvBNAct(base * 8, base * 16, 3, 2)
        self.dark5_spp = SPPBottleneck(base * 16, base * 16)
        self.dark5_csp = CSPLayer(base * 16, base * 16, d, shortcut=False)

    def forward(self, x):
        x = self.dark2_csp(self.dark2_conv(self.stem(x)))
        c3 = self.dark3_csp(self.dark3_conv(x))
        c4 = self.dark4_csp(self.dark4_conv(c3))
        c5 = self.dark5_csp(self.dark5_spp(self.dark5_conv(c4)))
        return c3, c4, c5


class YOLOPAFPN(nn.Module):
    def __init__(self, depth: float = 0.33, width: float = 0.50):
        super().__init__()
        d = max(round(3 * depth), 1)
        base = int(64 * width)
        c3, c4, c5 = base * 4, base * 8, base * 16  # the backbone's outputs
        ch4, ch8, ch16 = int(256 * width), int(512 * width), int(1024 * width)
        self.lateral_conv0 = ConvBNAct(c5, ch8, 1, 1)
        self.C3_p4 = CSPLayer(ch8 + c4, ch8, d, shortcut=False)
        self.reduce_conv1 = ConvBNAct(ch8, ch4, 1, 1)
        self.C3_p3 = CSPLayer(ch4 + c3, ch4, d, shortcut=False)
        self.bu_conv2 = ConvBNAct(ch4, ch4, 3, 2)
        self.C3_n3 = CSPLayer(ch4 + ch4, ch8, d, shortcut=False)
        self.bu_conv1 = ConvBNAct(ch8, ch8, 3, 2)
        self.C3_n4 = CSPLayer(ch8 + ch8, ch16, d, shortcut=False)

    def forward(self, feats):
        c3, c4, c5 = feats
        lat0 = self.lateral_conv0(c5)
        p4 = self.C3_p4(torch.cat([upsample2x(lat0), c4], 1))
        lat1 = self.reduce_conv1(p4)
        p3_out = self.C3_p3(torch.cat([upsample2x(lat1), c3], 1))
        p4_out = self.C3_n3(torch.cat([self.bu_conv2(p3_out), lat1], 1))
        p5_out = self.C3_n4(torch.cat([self.bu_conv1(p4_out), lat0], 1))
        return p3_out, p4_out, p5_out


class YOLOXHead(nn.Module):
    """Decoupled head; per level raw NCHW [reg(4), obj(1), cls(nc)]."""

    def __init__(self, nc: int, in_chs: Sequence[int], width: float = 0.50,
                 prior_prob: float = 0.01):
        super().__init__()
        self.nc, self.prior_prob, self.levels = nc, prior_prob, len(in_chs)
        ch = int(256 * width)
        for i, c in enumerate(in_chs):
            self.add_module(f"stem_{i}", ConvBNAct(c, ch, 1, 1))
            self.add_module(f"cls_conv_{i}_0", ConvBNAct(ch, ch, 3, 1))
            self.add_module(f"cls_conv_{i}_1", ConvBNAct(ch, ch, 3, 1))
            self.add_module(f"cls_pred_{i}", nn.Conv2d(ch, nc, 1))
            self.add_module(f"reg_conv_{i}_0", ConvBNAct(ch, ch, 3, 1))
            self.add_module(f"reg_conv_{i}_1", ConvBNAct(ch, ch, 3, 1))
            self.add_module(f"reg_pred_{i}", nn.Conv2d(ch, 4, 1))
            self.add_module(f"obj_pred_{i}", nn.Conv2d(ch, 1, 1))

    def preds(self) -> List[nn.Conv2d]:
        return [getattr(self, f"{k}_pred_{i}") for i in range(self.levels)
                for k in ("cls", "reg", "obj")]

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            s = getattr(self, f"stem_{i}")(f)
            c = getattr(self, f"cls_conv_{i}_1")(getattr(self, f"cls_conv_{i}_0")(s))
            r = getattr(self, f"reg_conv_{i}_1")(getattr(self, f"reg_conv_{i}_0")(s))
            outs.append(torch.cat([getattr(self, f"reg_pred_{i}")(r),
                                   getattr(self, f"obj_pred_{i}")(r),
                                   getattr(self, f"cls_pred_{i}")(c)], 1))
        return outs


class YOLOXModel(nn.Module):
    """The YOLOX detector. ``forward`` takes NHWC images and returns the raw
    per-level NHWC maps (B, H/s, W/s, 5+nc)."""

    def __init__(self, nc: int = 80, depth: float = 0.33, width: float = 0.50,
                 strides: Tuple[float, ...] = (8.0, 16.0, 32.0), in_ch: int = 3):
        super().__init__()
        self.nc, self.depth, self.width, self.in_ch = nc, depth, width, in_ch
        self.strides = tuple(strides)
        ch4, ch8, ch16 = int(256 * width), int(512 * width), int(1024 * width)
        self.backbone = CSPDarknet(in_ch, depth, width)
        self.neck = YOLOPAFPN(depth, width)
        self.head = YOLOXHead(nc, (ch4, ch8, ch16), width)

    @classmethod
    def from_scale(cls, scale: str = "s", nc: int = 80, in_ch: int = 3) -> "YOLOXModel":
        d, w = SCALES[scale]
        return cls(nc=nc, depth=d, width=w, in_ch=in_ch)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init as the JAX model's: ConvBNAct kernels kaiming-normal
        (fan_out), BN at identity; the head's 1x1 prediction convs at torch's
        Conv2d default (uniform, bound 1/sqrt(fan_in)), reg bias 0, obj and
        cls bias -log((1-p)/p). A fan_out init on the 4-channel reg conv
        gives wh logits of ~60 at s width, and exp() of those an infinite
        first gradient."""
        preds = set(self.head.preds())
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m not in preds:
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        prior = -math.log((1 - self.head.prior_prob) / self.head.prior_prob)
        for m in self.head.preds():
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            m.bias.zero_()
        for i in range(self.head.levels):
            getattr(self.head, f"cls_pred_{i}").bias.fill_(prior)
            getattr(self.head, f"obj_pred_{i}").bias.fill_(prior)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = self.head(self.neck(self.backbone(x.permute(0, 3, 1, 2))))
        return [o.permute(0, 2, 3, 1) for o in outs]

    def decode(self, outs: Sequence[torch.Tensor], xywh: bool = False) -> torch.Tensor:
        return yolox_decode(outs, self.nc, self.strides, xywh=xywh)


def build_yolox(scale: str = "s", nc: int = 80, ch: int = 3, seed: int = 0,
                device: str | torch.device = "cpu", depth: float | None = None,
                width: float | None = None) -> YOLOXModel:
    """A seeded-init YOLOX on ``device`` (``scale`` unless ``depth`` and
    ``width`` are given). Weights are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``: a seed gives the same weights
    on every device."""
    d, w = SCALES[scale] if depth is None or width is None else (depth, width)
    with torch.device("meta"):
        model = YOLOXModel(nc=nc, depth=d, width=w, in_ch=ch)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def yolox_decode(outs: Sequence[torch.Tensor], nc: int, strides: Sequence[float],
                 xywh: bool = False) -> torch.Tensor:
    """Raw head maps -> (B, A, 4+1+nc): pixel boxes (xyxy, or cxcywh), sigmoid
    obj, sigmoid cls."""
    B = outs[0].shape[0]
    no = 5 + nc
    flat = torch.cat([o.reshape(B, -1, no) for o in outs], 1)
    anchor_points, stride_t = make_anchors(
        [(o.shape[1], o.shape[2], s) for o, s in zip(outs, strides)], 0.0, dtype=flat.dtype,
        device=flat.device)
    xy = (flat[..., :2] + anchor_points[None]) * stride_t[None]
    wh = torch.exp(flat[..., 2:4].clamp(-WH_LOGIT_CAP, WH_LOGIT_CAP)) * stride_t[None]
    box = torch.cat([xy, wh], -1) if xywh else torch.cat([xy - wh / 2, xy + wh / 2], -1)
    return torch.cat([box, torch.sigmoid(flat[..., 4:5]), torch.sigmoid(flat[..., 5:])], -1)


def yolox_eval_decode(outs: Sequence[torch.Tensor], nc: int, strides: Sequence[float]
                      ) -> torch.Tensor:
    """The common postprocess input (B, A, 4+nc): xywh pixel boxes and
    per-class confidence obj * cls (the YOLOX convention)."""
    d = yolox_decode(outs, nc, strides, xywh=True)
    return torch.cat([d[..., :4], d[..., 4:5] * d[..., 5:]], -1)


def yolox_arch_from_params(state_dict: Mapping[str, torch.Tensor]
                           ) -> Tuple[int, int, float, float]:
    """(ch, nc, depth, width) off a port YOLOX ``state_dict``: ch from the
    Focus conv's 4*ch input channels, width from its output channels / 64,
    nc from the head's cls projection, depth from dark2's bottleneck count
    / 3 (any depth with the same round gives the same graph)."""
    stem = state_dict["backbone.stem.conv.conv.weight"]
    ch, base = int(stem.shape[1]) // 4, int(stem.shape[0])
    nc = int(state_dict["head.cls_pred_0.weight"].shape[0])
    n_dark2 = sum(1 for k in state_dict
                  if k.startswith("backbone.dark2_csp.m_") and k.endswith("_cv1.conv.weight"))
    return ch, nc, n_dark2 / 3.0, base / 64.0
