"""The legacy hand-wired model family (port of ``models/legacy.py``): a CSP
backbone with P2-P5 outputs (strides 4/8/16/32, base widths
64/128/256/384 x ``width_mult``), a classic FPN (1x1 laterals to one width,
nearest-upsample top-down adds, 3x3 smoothing) and an anchor-free dict head
per scale (bbox 4 + objectness 1 + classes nc). ``YOLOScratchModel`` wires
them at ``width_mult`` 1.15 (~10 M parameters).

NHWC in, NHWC out, NCHW inside, as the other families. Submodules carry the
flax module names (``backbone.stage_p2.blocks_0_0``, ``head.bbox_0_1``), so
``utils/weights.py::state_dict_from_jax`` maps a JAX legacy variables tree
onto the port's ``state_dict`` as it does YOLOX's. The legacy CSPBlock
differs from YOLO11's C2f: conv1 then n x (two 3x3 convs) on the main path,
a 1x1 conv shortcut (identity where the width already matches), concat, a
1x1 fuse, then an EXTRA SiLU on top of the fused Conv-BN-SiLU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolo_scratch_tpu_torch.nn.modules import ConvBNAct, upsample2x


class CSPBlock(nn.Module):
    def __init__(self, c1: int, c2: int, num_blocks: int = 1, expansion: float = 0.5):
        super().__init__()
        hidden = int(c2 * expansion)
        self.num_blocks = num_blocks
        self.conv1 = ConvBNAct(c1, hidden, 1)
        for i in range(num_blocks):
            setattr(self, f"blocks_{i}_0", ConvBNAct(hidden, hidden, 3))
            setattr(self, f"blocks_{i}_1", ConvBNAct(hidden, hidden, 3))
        self.conv_shortcut = ConvBNAct(c1, hidden, 1) if c1 != hidden else None
        self.conv2 = ConvBNAct(2 * hidden, c2, 1)

    def forward(self, x):
        main = self.conv1(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"blocks_{i}_1")(getattr(self, f"blocks_{i}_0")(main))
        short = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return F.silu(self.conv2(torch.cat([main, short], 1)))  # the extra activation


class LegacyBackbone(nn.Module):
    """CSP backbone -> [P2, P3, P4, P5] at strides 4/8/16/32."""

    def __init__(self, ch: int = 1, width_mult: float = 1.0):
        super().__init__()
        wm = width_mult
        c2, c3, c4, c5 = int(64 * wm), int(128 * wm), int(256 * wm), int(384 * wm)
        self.widths = (c2, c3, c4, c5)
        self.stem_0 = ConvBNAct(ch, c2 // 2, 3, 2)
        self.stem_1 = ConvBNAct(c2 // 2, c2, 3, 2)
        self.stage_p2 = CSPBlock(c2, c2, 1)
        self.down_p2_p3 = ConvBNAct(c2, c3, 3, 2)
        self.stage_p3 = CSPBlock(c3, c3, 2)
        self.down_p3_p4 = ConvBNAct(c3, c4, 3, 2)
        self.stage_p4 = CSPBlock(c4, c4, 2)
        self.down_p4_p5 = ConvBNAct(c4, c5, 3, 2)
        self.stage_p5 = CSPBlock(c5, c5, 1)

    def forward(self, x):
        p2 = self.stage_p2(self.stem_1(self.stem_0(x)))
        p3 = self.stage_p3(self.down_p2_p3(p2))
        p4 = self.stage_p4(self.down_p3_p4(p3))
        p5 = self.stage_p5(self.down_p4_p5(p4))
        return [p2, p3, p4, p5]


class FPNNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 160):
        super().__init__()
        oc = out_channels
        for name, c in zip(("p2", "p3", "p4", "p5"), in_channels):
            setattr(self, f"lateral_{name}", ConvBNAct(c, oc, 1, p=0))
            setattr(self, f"smooth_{name}", ConvBNAct(oc, oc, 3))

    def forward(self, feats):
        p2, p3, p4, p5 = feats
        l5, l4 = self.lateral_p5(p5), self.lateral_p4(p4)
        l3, l2 = self.lateral_p3(p3), self.lateral_p2(p2)
        n5 = self.smooth_p5(l5)
        n4 = self.smooth_p4(l4 + upsample2x(l5))
        n3 = self.smooth_p3(l3 + upsample2x(n4))
        n2 = self.smooth_p2(l2 + upsample2x(n3))
        return [n2, n3, n4, n5]


class LegacyHead(nn.Module):
    """Per scale: {'bbox' raw (B, 4, H, W), 'objectness' (B, 1, H, W),
    'classes' (B, nc, H, W)}; its prediction convs carry a bias. Box decode
    contract: :func:`decode_legacy_bbox`."""

    def __init__(self, c: int, num_classes: int = 5, num_scales: int = 4):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            setattr(self, f"shared_{i}_0", ConvBNAct(c, c, 3))
            setattr(self, f"shared_{i}_1", ConvBNAct(c, c, 3))
            setattr(self, f"bbox_{i}_0", nn.Conv2d(c, c, 3, padding=1))
            setattr(self, f"bbox_{i}_1", nn.Conv2d(c, 4, 1))
            setattr(self, f"obj_{i}", nn.Conv2d(c, 1, 1))
            setattr(self, f"cls_{i}", nn.Conv2d(c, num_classes, 1))

    def forward(self, feats) -> List[Dict[str, torch.Tensor]]:
        outs = []
        for i, f in enumerate(feats[: self.num_scales]):
            x = getattr(self, f"shared_{i}_1")(getattr(self, f"shared_{i}_0")(f))
            b = getattr(self, f"bbox_{i}_1")(F.silu(getattr(self, f"bbox_{i}_0")(x)))
            outs.append({"bbox": b, "objectness": getattr(self, f"obj_{i}")(x),
                         "classes": getattr(self, f"cls_{i}")(x)})
        return outs


class YOLOScratchModel(nn.Module):
    """The complete legacy model: (B, S, S, ch) NHWC images (S a multiple
    of 32) -> a list of 4 per-scale dicts of NHWC maps, ``bbox`` (B, H, W,
    4), ``objectness`` (B, H, W, 1), ``classes`` (B, H, W, nc)."""

    def __init__(self, num_classes: int = 5, width_mult: float = 1.15, ch: int = 1):
        super().__init__()
        self.nc, self.in_ch = num_classes, ch
        self.backbone = LegacyBackbone(ch, width_mult)
        oc = int(160 * width_mult)
        self.neck = FPNNeck(self.backbone.widths, oc)
        self.head = LegacyHead(oc, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: the ``ConvBNAct`` kernels kaiming-normal (fan_out),
        BN at identity; the head's biased convs as flax's ``nn.Conv``
        default (LeCun normal: variance 1/fan_in, truncated at 2 std),
        biases 0, so the first boxes' exp(w, h) stay finite."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m.bias is None:
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        outs = self.head(self.neck(self.backbone(x.permute(0, 3, 1, 2))))
        return [{k: v.permute(0, 2, 3, 1) for k, v in o.items()} for o in outs]


def build_legacy(num_classes: int = 5, width_mult: float = 1.15, ch: int = 1, seed: int = 0,
                 device: str | torch.device = "cpu") -> YOLOScratchModel:
    """A seeded-init legacy model on ``device`` (weights drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``)."""
    with torch.device("meta"):
        model = YOLOScratchModel(num_classes, width_mult, ch)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def decode_legacy_bbox(raw_bbox: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) raw -> normalised xyxy: sigmoid centres, exp(w, h)
    clipped below at 0.01 (the tie's gradient halved, as ``jnp.clip``)."""
    cx = torch.sigmoid(raw_bbox[..., 0])
    cy = torch.sigmoid(raw_bbox[..., 1])
    floor = raw_bbox.new_tensor(0.01)
    w = torch.maximum(torch.exp(raw_bbox[..., 2]), floor)
    h = torch.maximum(torch.exp(raw_bbox[..., 3]), floor)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
