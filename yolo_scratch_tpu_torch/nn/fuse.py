"""Deploy-path weight transform: fold BatchNorm into conv kernels (port of
``nn/fuse.py``).

For every Conv(bias=False) -> BN pair,

    y = scale * (conv(x, K) - mean) / sqrt(var + eps) + bias
      = conv(x, K * g) + (bias - mean * g),  g = scale / sqrt(var + eps)

The JAX package keeps the BN node with neutral statistics; here the shifted
bias moves into the conv (cuDNN adds it in the conv's epilogue) and the BN
becomes ``nn.Identity``.

:func:`bottleneck_weights` reads a folded ``Bottleneck`` as the weights of
``ops/conv_kernels.fused_bottleneck`` (kernel #3).
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

from yolo_scratch_tpu_torch.nn.modules import Bottleneck, ConvBNAct


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> nn.Module:
    """Return a copy of ``model`` with every ConvBNAct's BN folded into its
    conv (inference only; the BN's eps, 1e-3, is used)."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if not (isinstance(m, ConvBNAct) and isinstance(m.bn, nn.BatchNorm2d)):
            continue
        conv, bn = m.conv, m.bn
        g = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                          conv.padding, conv.dilation, conv.groups, bias=True,
                          device=conv.weight.device, dtype=conv.weight.dtype)
        fused.weight.copy_(conv.weight * g[:, None, None, None])
        fused.bias.copy_(bn.bias - bn.running_mean * g)
        m.conv, m.bn = fused, nn.Identity()
    return model


def _conv3x3(cv: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    conv = cv.conv
    if (conv.kernel_size != (3, 3) or conv.stride != (1, 1) or conv.padding != (1, 1)
            or conv.dilation != (1, 1) or conv.groups != 1):
        raise ValueError(f"kernel #3 takes 3x3 stride-1 SAME convs with groups 1, got {conv}")
    if conv.bias is None or not isinstance(cv.bn, nn.Identity):
        raise ValueError("fold the block's BatchNorm first (fuse_conv_bn)")
    if not isinstance(cv.act, nn.SiLU):
        raise ValueError(f"kernel #3 applies SiLU, the block has {cv.act}")
    return conv.weight.detach().permute(2, 3, 1, 0).contiguous(), conv.bias.detach().float()


def bottleneck_weights(m: Bottleneck) -> Tuple[torch.Tensor, ...]:
    """(w1, b1, w2, b2) of a folded ``Bottleneck`` with its shortcut on, for
    ``ops/conv_kernels.fused_bottleneck``: weights HWIO in the module's type,
    biases f32."""
    if not isinstance(m, Bottleneck) or not m.add:
        raise ValueError("kernel #3 computes a Bottleneck with its shortcut on")
    return (*_conv3x3(m.cv1), *_conv3x3(m.cv2))
