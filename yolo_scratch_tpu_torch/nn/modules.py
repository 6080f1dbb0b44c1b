"""YOLO11 building blocks as ``torch.nn`` modules (port of ``nn/modules.py``).

The blocks run NCHW inside (cuDNN's layout; on the GPU the Predictor puts
them in ``channels_last``). :class:`YOLOModel` takes NHWC input and returns
NHWC Detect maps, as the JAX package does. Submodule names follow the
reference's state-dict keys (``model.23.cv2.0.2.bias``), so
``yolo_scratch_tpu.utils.torch_import.convert_reference_state_dict`` maps a
port ``state_dict()`` onto the flax tree unchanged.

BatchNorm trains as flax's does (:class:`BatchNorm2d`): its running variance
follows the biased batch variance, where ``nn.BatchNorm2d`` follows the
unbiased one.

``ConvBNAct`` carries the JAX block's two deploy hooks, both inert unless
``nn/quant.py`` sets them: calibration (it records the conv input's absmax,
or the whole input for quantile calibration) and int8 inference (an exact
s8 x s8 -> s32 conv, ``ops/int8_conv.py``, dequantised into the epilogue).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolo_scratch_tpu_torch.ops.anchors import make_anchors
from yolo_scratch_tpu_torch.ops.boxes import dist2bbox
from yolo_scratch_tpu_torch.ops.int8_conv import int8_conv2d
from yolo_scratch_tpu_torch.parallel.collectives import all_reduce_sum


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same' padding."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update.

    In train mode the batch is normalised by its own mean and biased
    variance, as both frameworks do. The running statistics then move as
    flax moves them, ``r = keep * r + (1 - keep) * stat`` with ``keep = 1 -
    momentum``, where ``stat`` is the batch mean and the *biased* batch
    variance, reduced in f32 or wider (flax's ``_compute_stats``).
    ``nn.BatchNorm2d`` feeds the unbiased variance into ``running_var``,
    n/(n-1) times the JAX package's on every update.
    ``num_batches_tracked`` stays unused. With ``update_stats`` False a
    train-mode forward leaves the running statistics alone: the step's
    recompute of a checkpointed forward sets it (``train/steps.py``), so
    that remat updates them once, as ``jax.checkpoint`` does.

    With ``process_group`` set (the sync-BN train step of a mesh sets it
    for the step, ``train/steps.py``) a train-mode forward normalises over
    the global batch: the per-channel count, sum and sum of squares, in f32
    or wider, are summed over the ranks through
    ``parallel/collectives.py::all_reduce_sum``, so the backward sees the
    global statistics too. Mean and variance follow flax's
    ``_compute_stats`` (``E[x²] - E[x]²``, clamped at 0), and the running
    statistics move toward the global mean and biased variance."""

    update_stats = True
    process_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_batch_norm(x)
        if self.update_stats:
            with torch.no_grad():
                xs = x.to(torch.promote_types(x.dtype, torch.float32))
                var, mean = torch.var_mean(xs, dim=(0, 2, 3), unbiased=False)
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
                self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch_norm(self, x):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        C = xs.shape[1]
        count = torch.full((1,), xs.numel() // C, dtype=xs.dtype, device=xs.device)
        stats = all_reduce_sum(torch.cat([xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3)), count]),
                               self.process_group)
        mean = stats[:C] / stats[-1]
        var = (stats[C:2 * C] / stats[-1] - mean * mean).clamp(min=0.0)
        if self.update_stats:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean.detach(), alpha=1.0 - keep)
                self.running_var.mul_(keep).add_(var.detach(), alpha=1.0 - keep)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xs - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


#: the int8 buffers of a quantized ``ConvBNAct``
QUANT_BUFFERS = ("w_q", "s_w", "s_act")


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm (eps 1e-3, momentum 0.03) + SiLU.

    Two deploy-only hooks, set by ``nn/quant.py`` and inert otherwise:

    * ``calib`` ("absmax" or "full"): each forward records, in
      ``calib_out``, the running absmax of the f32 conv input (the JAX
      ``"calib"`` sow) or the whole f32 input (``"calib_full"``);
    * the int8 buffers ``w_q`` (OIHW int8), ``s_w`` ((c2,) f32) and
      ``s_act`` (0-d f32): in eval mode the conv then runs as
      ``int8_conv2d(clamp(round(x / s_act), -127, 127), w_q)``, exact in
      int32, dequantised by ``s_act * s_w`` into the input's dtype; the
      folded bias is added after that cast, in the working dtype, as the
      JAX package's neutralised BN adds it (mean 0, var + eps = 1 exactly),
      and an unfolded BN runs as usual. The quotient divides by the 0-d
      tensor ``s_act``: CUDA turns a division by a Python scalar into a
      multiply by its reciprocal, 1 ulp off. A ``state_dict`` holding the
      buffers loads them into a block that has none."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = nn.SiLU() if act else nn.Identity()
        for name in QUANT_BUFFERS:
            self.register_buffer(name, None)
        self.calib: str | None = None
        self.calib_out: torch.Tensor | None = None

    def forward(self, x):
        if self.calib is not None:
            self._observe(x.detach().float())
        if self.w_q is not None and not self.training:
            return self.act(self.bn(self._int8_conv(x)))
        return self.act(self.bn(self.conv(x)))

    def _observe(self, xf: torch.Tensor) -> None:
        if self.calib == "absmax":
            m = xf.abs().amax()
            self.calib_out = m if self.calib_out is None else torch.maximum(self.calib_out, m)
        else:
            self.calib_out = xf

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        xq = torch.clamp(torch.round(x.float() / self.s_act), -127, 127).to(torch.int8)
        y = int8_conv2d(xq, self.w_q, c.stride[0], c.padding[0], c.dilation[0], c.groups)
        y = (y.float() * (self.s_act * self.s_w)[:, None, None]).to(x.dtype)
        return y if c.bias is None else y + c.bias[:, None, None]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in QUANT_BUFFERS:
            if prefix + name in state_dict:
                self.register_buffer(name, state_dict[prefix + name].to(
                    self.conv.weight.device, copy=True))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Bottleneck(nn.Module):
    """Two convs with an optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Sequence[int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, k[0], 1)
        self.cv2 = ConvBNAct(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP block with n sequential bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0) for _ in range(n))
        self.cv2 = ConvBNAct(c1, c_, 1, 1)
        self.cv3 = ConvBNAct(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C2f(nn.Module):
    """Split-extend-concat CSP bottleneck."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.m = nn.ModuleList(
            Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3k2(C2f):
    """C2f whose inner blocks are C3k(n=2) when ``c3k``."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, g, e)
        if c3k:
            c = int(c2 * e)
            self.m = nn.ModuleList(C3k(c, c, 2, shortcut, g) for _ in range(n))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Spatial multi-head attention over H*W tokens; head h owns qkv
    channels [h*(2*key_dim+head_dim), (h+1)*(2*key_dim+head_dim))."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBNAct(dim, dim + self.key_dim * num_heads * 2, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x).reshape(B, nh, 2 * kd + hd, H * W)
        q, k, v = qkv.split([kd, kd, hd], dim=2)
        attn = (q.transpose(-2, -1) @ k) * self.scale  # (B, nh, N, N)
        attn = attn.softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSA(nn.Module):
    """Attention + conv-FFN residual block (output has ``c1`` channels)."""

    def __init__(self, c1: int, e: float = 0.5):
        super().__init__()
        self.c = c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.attn = Attention(c, num_heads=max(c // 64, 1), attn_ratio=0.5)
        self.ffn = nn.Sequential(ConvBNAct(c, 2 * c, 1), ConvBNAct(2 * c, c, 1, act=False))
        self.cv2 = ConvBNAct(2 * c, c1, 1)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class C2PSA(nn.Module):
    """CSP wrapper around n PSA blocks (output has ``c1`` channels, as in
    the JAX package)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.m = nn.ModuleList(PSA(c, e=1.0) for _ in range(n))
        self.cv2 = ConvBNAct(2 * c, c1, 1)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        for m in self.m:
            b = m(b)
        return self.cv2(torch.cat([a, b], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    def forward(self, x):
        return upsample2x(x)


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


def dfl_expectation(dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal integral: (..., 4*reg_max) -> (..., 4), softmax
    over each side's bins, expectation against arange(reg_max)."""
    p = dist.unflatten(-1, (4, reg_max)).softmax(dim=-1)
    return p @ torch.arange(reg_max, dtype=dist.dtype, device=dist.device)


def _cls_bias_prior(nc: int, stride: float) -> float:
    """Detect cls-branch bias prior."""
    v = 5.0 / nc / max((640.0 / stride) ** 2, 1.0)
    return math.log(max(v, 1e-6))


class Detect(nn.Module):
    """Anchor-free detect head: per scale a box branch cv2 (Conv, Conv,
    conv -> 4*reg_max) and a cls branch cv3 (Conv, Conv, conv -> nc).
    Returns raw NCHW maps with 4*reg_max+nc channels."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[float], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBNAct(x, c2, 3), ConvBNAct(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), nn.Conv2d(c3, nc, 1))
            for x in ch)

    @property
    def no(self) -> int:
        return self.nc + self.reg_max * 4

    @torch.no_grad()
    def reset_bias(self) -> None:
        """Box-branch bias 1.0; cls-branch bias prior per stride."""
        for box, cls, s in zip(self.cv2, self.cv3, self.strides):
            box[2].bias.fill_(1.0)
            cls[2].bias.fill_(_cls_bias_prior(self.nc, s))

    def forward(self, feats):
        return [torch.cat([b(x), c(x)], 1) for x, b, c in zip(feats, self.cv2, self.cv3)]


def detect_decode(feats: Sequence[torch.Tensor], nc: int, strides: Sequence[float],
                  reg_max: int = 16, xywh: bool = True) -> torch.Tensor:
    """Raw NHWC Detect maps -> (B, A, 4+nc): pixel boxes + sigmoid scores."""
    B = feats[0].shape[0]
    no = nc + 4 * reg_max
    x = torch.cat([f.reshape(B, -1, no) for f in feats], 1)
    anchor_points, stride_tensor = make_anchors(
        [(f.shape[1], f.shape[2], s) for f, s in zip(feats, strides)], 0.5,
        dtype=x.dtype, device=x.device)
    box, cls = x[..., : 4 * reg_max], x[..., 4 * reg_max:]
    dist = dfl_expectation(box, reg_max)
    dbox = dist2bbox(dist, anchor_points[None], xywh=xywh, dim=-1) * stride_tensor[None]
    return torch.cat([dbox, cls.sigmoid()], -1)
