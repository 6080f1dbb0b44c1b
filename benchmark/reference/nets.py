"""Plain float32 detectors: YOLO11 (Ultralytics ``cfg/models/11/yolo11.yaml``
with a Detect head of ``reg_max`` DFL bins) and YOLOX (arXiv 2107.08430:
CSPDarknet, PAFPN, decoupled head), and the blocks they share.

Plain ``torch.nn`` blocks, written from the published descriptions, with the
submodule names of the program's state dict so that one set of seeded
weights loads into both. BatchNorm keeps its running statistics as flax
does (the biased batch variance, ``r = (1 - m) r + m stat``); in eval mode
it is the usual affine normalisation. Nothing is folded or fused here, and
nothing of the measured program is imported.

``build(cfg)`` dispatches on the configuration's ``family`` to
``reference/<family>.py``'s ``build`` (``yolo11.py`` and ``yolox.py`` build
the classes here); a new family's file may reuse these blocks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn


class BN(nn.BatchNorm2d):
    """Eval: affine normalisation on the running statistics. Train: the
    batch's mean and biased variance, and the running statistics moved
    toward them by ``momentum``."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Conv(nn.Module):
    """conv (no bias) -> BN (eps 1e-3, momentum 0.03) -> SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BN(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act else y


# ------------------------------------------------------------------ YOLO11

class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, e=1.0) for _ in range(n))

    def forward(self, x):
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C3k2(nn.Module):
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(C3k(c, c, 2, shortcut) if c3k else
                               Bottleneck(c, c, shortcut, e=1.0) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2)
        self.cv2 = Conv(c1 // 2 * 4, c2)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.nh, self.hd = num_heads, dim // num_heads
        self.kd = self.hd // 2
        self.qkv = Conv(dim, dim + 2 * self.kd * num_heads, act=False)
        self.proj = Conv(dim, dim, act=False)
        self.pe = Conv(dim, dim, 3, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.qkv(x).reshape(B, self.nh, 2 * self.kd + self.hd, H * W).split(
            [self.kd, self.kd, self.hd], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.kd ** -0.5).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSA(nn.Module):
    """Attention and a conv FFN on one half of its widened input."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.cv1 = Conv(c, 2 * c)
        self.attn = Attention(c, max(c // 64, 1))
        self.ffn = nn.Sequential(Conv(c, 2 * c), Conv(2 * c, c, act=False))
        self.cv2 = Conv(2 * c, c)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class C2PSA(nn.Module):
    def __init__(self, c1, n=1):
        super().__init__()
        self.c = c1 // 2
        self.cv1 = Conv(c1, c1)
        self.m = nn.ModuleList(PSA(self.c) for _ in range(n))
        self.cv2 = Conv(c1, c1)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        for m in self.m:
            b = m(b)
        return self.cv2(torch.cat([a, b], 1))


class Detect(nn.Module):
    def __init__(self, nc, ch, reg_max=16):
        super().__init__()
        c2, c3 = max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                                               nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3),
                                               nn.Conv2d(c3, nc, 1)) for x in ch)

    def forward(self, xs):
        return [torch.cat([b(x), c(x)], 1) for x, b, c in zip(xs, self.cv2, self.cv3)]


class Nothing(nn.Module):
    """Upsample and Concat rows hold no weights."""


class YOLO11(nn.Module):
    """NHWC images -> NHWC Detect maps (B, H, W, 4*reg_max+nc) per level."""

    def __init__(self, cfg: Mapping[str, Any], ch: int, nc: int, reg_max: int = 16):
        super().__init__()
        gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
        self.nc, self.reg_max = nc, reg_max
        self.strides: tuple = ()
        chs: List[int] = []
        strides: List[int] = []
        self.rows = []
        layers = []
        for i, (f, n, kind, args) in enumerate(list(cfg["backbone"]) + list(cfg["head"])):
            c_in = ([chs[j] for j in f] if isinstance(f, list)
                    else (chs[f] if chs else ch))
            s_in = (strides[f[0]] if isinstance(f, list) else (strides[f] if strides else 1))
            n = max(round(n * gd), 1) if n > 1 else n
            c2 = None
            if kind not in ("nn.Upsample", "Concat", "Detect"):
                c2 = args[0] if args[0] == nc else math.ceil(args[0] * gw / 8) * 8
            s_out = s_in
            if kind == "Conv":
                m = Conv(c_in, c2, args[1], args[2])
                s_out = s_in * args[2]
            elif kind == "C3k2":
                m = C3k2(c_in, c2, n, *(args[1:2]), *(args[2:3]))
            elif kind == "SPPF":
                m = SPPF(c_in, c2, args[1])
            elif kind == "C2PSA":
                m, c2 = C2PSA(c_in, n), c_in
            elif kind == "nn.Upsample":
                m, c2, s_out = Nothing(), c_in, s_in // 2
            elif kind == "Concat":
                m, c2 = Nothing(), sum(c_in)
            elif kind == "Detect":
                m, c2 = Detect(nc, c_in, reg_max), 0
                self.strides = tuple(float(strides[j]) for j in f)
            else:
                raise ValueError(f"row {i}: no plain block for {kind!r}")
            layers.append(m)
            self.rows.append((f, kind))
            chs.append(c2)
            strides.append(s_out)
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        out, y = x.permute(0, 3, 1, 2), []
        for (f, kind), m in zip(self.rows, self.model):
            inp = ([out if j == -1 else y[j] for j in f] if isinstance(f, list)
                   else (out if f == -1 else y[f]))
            if kind == "nn.Upsample":
                out = F.interpolate(inp, scale_factor=2, mode="nearest")
            elif kind == "Concat":
                out = torch.cat(inp, 1)
            else:
                out = m(inp)
            y.append(out)
        return [t.permute(0, 2, 3, 1) for t in out]


# ------------------------------------------------------------------- YOLOX

class CSPLayer(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True):
        super().__init__()
        c_ = c2 // 2
        self.n, self.shortcut = n, shortcut
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", Conv(c_, c_))
            self.add_module(f"m_{i}_cv2", Conv(c_, c_, 3))

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}_cv2")(getattr(self, f"m_{i}_cv1")(a))
            a = a + y if self.shortcut else y
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class Focus(nn.Module):
    """Space to depth, in the order [top-left, bottom-left, top-right,
    bottom-right], then a 3x3 conv."""

    def __init__(self, c1, c2):
        super().__init__()
        self.conv = Conv(4 * c1, c2, 3)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class SPPBottleneck(nn.Module):
    def __init__(self, c1, c2, ks=(5, 9, 13)):
        super().__init__()
        self.ks = ks
        self.cv1 = Conv(c1, c1 // 2)
        self.cv2 = Conv(c1 // 2 * (len(ks) + 1), c2)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.ks], 1))


class Backbone(nn.Module):
    def __init__(self, ch, depth, width):
        super().__init__()
        b, d = int(64 * width), max(round(3 * depth), 1)
        self.stem = Focus(ch, b)
        self.dark2_conv, self.dark2_csp = Conv(b, 2 * b, 3, 2), CSPLayer(2 * b, 2 * b, d)
        self.dark3_conv, self.dark3_csp = Conv(2 * b, 4 * b, 3, 2), CSPLayer(4 * b, 4 * b, 3 * d)
        self.dark4_conv, self.dark4_csp = Conv(4 * b, 8 * b, 3, 2), CSPLayer(8 * b, 8 * b, 3 * d)
        self.dark5_conv = Conv(8 * b, 16 * b, 3, 2)
        self.dark5_spp = SPPBottleneck(16 * b, 16 * b)
        self.dark5_csp = CSPLayer(16 * b, 16 * b, d, shortcut=False)

    def forward(self, x):
        x = self.dark2_csp(self.dark2_conv(self.stem(x)))
        c3 = self.dark3_csp(self.dark3_conv(x))
        c4 = self.dark4_csp(self.dark4_conv(c3))
        return c3, c4, self.dark5_csp(self.dark5_spp(self.dark5_conv(c4)))


class Neck(nn.Module):
    def __init__(self, depth, width):
        super().__init__()
        d = max(round(3 * depth), 1)
        c3, c4, c5 = (int(c * width) for c in (256, 512, 1024))
        self.lateral_conv0 = Conv(c5, c4)
        self.C3_p4 = CSPLayer(2 * c4, c4, d, False)
        self.reduce_conv1 = Conv(c4, c3)
        self.C3_p3 = CSPLayer(2 * c3, c3, d, False)
        self.bu_conv2 = Conv(c3, c3, 3, 2)
        self.C3_n3 = CSPLayer(2 * c3, c4, d, False)
        self.bu_conv1 = Conv(c4, c4, 3, 2)
        self.C3_n4 = CSPLayer(2 * c4, c5, d, False)

    def forward(self, feats):
        c3, c4, c5 = feats
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        lat0 = self.lateral_conv0(c5)
        p4 = self.C3_p4(torch.cat([up(lat0), c4], 1))
        lat1 = self.reduce_conv1(p4)
        p3 = self.C3_p3(torch.cat([up(lat1), c3], 1))
        n3 = self.C3_n3(torch.cat([self.bu_conv2(p3), lat1], 1))
        n4 = self.C3_n4(torch.cat([self.bu_conv1(n3), lat0], 1))
        return p3, n3, n4


class Head(nn.Module):
    """Per level [reg(4), obj(1), cls(nc)] logits."""

    def __init__(self, nc, width):
        super().__init__()
        ch = int(256 * width)
        self.levels = 3
        for i, c in enumerate(int(c * width) for c in (256, 512, 1024)):
            self.add_module(f"stem_{i}", Conv(c, ch))
            for br in ("cls", "reg"):
                self.add_module(f"{br}_conv_{i}_0", Conv(ch, ch, 3))
                self.add_module(f"{br}_conv_{i}_1", Conv(ch, ch, 3))
            self.add_module(f"cls_pred_{i}", nn.Conv2d(ch, nc, 1))
            self.add_module(f"reg_pred_{i}", nn.Conv2d(ch, 4, 1))
            self.add_module(f"obj_pred_{i}", nn.Conv2d(ch, 1, 1))

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


class YOLOX(nn.Module):
    """NHWC images -> NHWC maps (B, H, W, 5+nc) per level, strides 8/16/32."""

    def __init__(self, cfg: Mapping[str, Any], ch: int, nc: int):
        super().__init__()
        d, w = cfg["depth_multiple"], cfg["width_multiple"]
        self.nc, self.strides = nc, (8.0, 16.0, 32.0)
        self.backbone = Backbone(ch, d, w)
        self.neck = Neck(d, w)
        self.head = Head(nc, w)

    def forward(self, x):
        return [o.permute(0, 2, 3, 1) for o in self.head(self.neck(self.backbone(
            x.permute(0, 3, 1, 2))))]


def build(cfg: Mapping[str, Any]) -> nn.Module:
    """The plain model of a configuration file: its family's ``build``."""
    from . import family

    return family(cfg).build(cfg)


@contextlib.contextmanager
def full_f32(tf32: bool = False) -> Iterator[None]:
    """Inside, float32 matmuls and convs run in full float32 (TF32 off for
    cuBLAS and cuDNN), or in TF32 with ``tf32``; the flags are restored
    after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def feats_f32(model: nn.Module, imgs_u8: torch.Tensor, rows: int = 32) -> List[torch.Tensor]:
    """Eval-mode full-f32 Detect maps of uint8 NHWC images, ``rows`` images
    at a time."""
    model.eval()
    outs: List[List[torch.Tensor]] = []
    with torch.no_grad(), full_f32():
        for x in imgs_u8.split(rows):
            outs.append(model(x.to(torch.float32) / 255.0))
    return [torch.cat(level) for level in zip(*outs)]
