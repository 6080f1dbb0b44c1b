"""Seeded weights, made on the device in a few large draws, then BatchNorm
statistics that fit them.

Every float of a model's ``state_dict`` comes from one normal draw of a
``torch.Generator`` on the device, cut into leaves and scaled:

* a conv followed by BatchNorm: kaiming-normal on fan-out (std
  sqrt(2 / fan_out)), as the program's own init;
* a prediction conv (a conv with a bias): std 1 / sqrt(3 fan_in), the
  variance of torch's default uniform, and its bias 0.1 z. No bias priors:
  they would put every logit near -10, where a bf16 map keeps ~0.06 of
  resolution and the maps' variation drowns in it;
* BatchNorm: scale ``BN_SCALE * (1 + 0.1 z)``, shift ``BN_SCALE * 0.05 z``.

``BN_SCALE`` puts the random network in its near-linear regime. At scale 1
a random 100-layer detector is chaotic: a 1e-3 change of the input moves
its maps by 12-27% and bf16 rounding by 28-49%, so no comparison with the
reference could tell bf16 from int8. At 0.07 the same input change moves
them by 2% and bf16 rounding by 4-6% on every seed tried, while the
program's int8 path reads 25-35% (one H100, four seeds each). The work is
the same: every shape, op and kernel.

Then the plain reference (``reference/nets.py``) runs once in train mode
over ``CALIB_IMAGES`` seeded images of the cell's own traffic with momentum
1, so every BN's running mean and variance are those of its input there, as
in a trained network. Without that, eval-mode BN at unit statistics lets the
signal fade through the depth and the maps come out nearly constant.

The same seed gives the same weights on the same device type.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

SEED_MASK = (1 << 63) - 1


#: one stream of draws a purpose, so that a seed's images do not move when
#: the weights take more draws
STREAMS = {"weights": 1, "traffic": 2, "calib": 3}
#: images of the BN statistics' calibration pass
CALIB_IMAGES = 4
#: the BatchNorm scales' size (see the module docstring)
BN_SCALE = 0.07


def generator(seed: int, device, purpose: str = "weights") -> torch.Generator:
    """A generator on ``device`` for one purpose of a run's ``--seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + STREAMS[purpose]) & SEED_MASK)


@torch.no_grad()
def seeded_(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters and BN buffers in place from ``seed``."""
    dev = next(model.parameters()).device
    gen = generator(seed, dev)
    convs = [(n, m) for n, m in model.named_modules() if isinstance(m, nn.Conv2d)]
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    n_conv = sum(m.weight.numel() for _, m in convs)
    n_bn = sum(m.num_features for m in bns)
    n_bias = sum(m.bias.numel() for _, m in convs if m.bias is not None)
    z = torch.randn(n_conv + 2 * n_bn + n_bias, generator=gen, device=dev)
    biases = []
    off = 0
    for _, m in convs:
        w = m.weight
        k = z[off:off + w.numel()].view_as(w)
        off += w.numel()
        if m.bias is None:
            w.copy_(k * math.sqrt(2.0 / (w.shape[0] * w[0, 0].numel())))
        else:
            w.copy_(k / math.sqrt(3.0 * w[0].numel()))
            biases.append(m.bias)
    for b in biases:
        b.copy_(0.1 * z[off:off + b.numel()])
        off += b.numel()
    for m in bns:
        c = m.num_features
        zz = z[off:off + 2 * c].view(2, c)
        off += 2 * c
        m.weight.copy_(BN_SCALE * (1.0 + 0.1 * zz[0]))
        m.bias.copy_(BN_SCALE * 0.05 * zz[1])
    return model


@torch.no_grad()
def calibrate_bn_(model: nn.Module, images: torch.Tensor) -> nn.Module:
    """Set every BN's running statistics to those of its input over
    ``images`` (NHWC f32): one train-mode pass with momentum 1."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    try:
        model(images)
    finally:
        for m, mom in zip(bns, saved):
            m.momentum = mom
        model.eval()
    return model


def make_weights(cfg, traffic, seed: int, device) -> Dict[str, torch.Tensor]:
    """A configuration's weights for ``seed``: drawn into the plain
    reference, BN calibrated on the cell's own kind of images; a
    ``state_dict`` that loads into the program's model as well."""
    from benchmark.reference import nets
    from benchmark.traffic import scenes

    ref = seeded_(nets.build(cfg).to(device), seed)
    imgs = scenes.draw(cfg, traffic, generator(seed, device, "calib"), CALIB_IMAGES, device)[0]
    with nets.full_f32():
        calibrate_bn_(ref, (imgs * 255.0 + 0.5).floor() / 255.0)
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}
