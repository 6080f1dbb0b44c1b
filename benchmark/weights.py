"""Seeded weights, made on the device in a few large draws, then BatchNorm
statistics that fit them.

Every float leaf of a model's ``state_dict`` is first set to NaN, then drawn
from ``torch.Generator`` streams on the device and scaled. The convs and
their BatchNorms take one normal draw of the ``weights`` stream, cut into
leaves:

* a conv followed by BatchNorm: kaiming-normal on fan-out (std
  sqrt(2 / fan_out)), as the program's own init;
* a prediction conv (a conv with a bias): std 1 / sqrt(3 fan_in), the
  variance of torch's default uniform, and its bias 0.1 z. No bias priors:
  they would put every logit near -10, where a bf16 map keeps ~0.06 of
  resolution and the maps' variation drowns in it;
* BatchNorm: scale ``BN_SCALE * (1 + 0.1 z)``, shift ``BN_SCALE * 0.05 z``;
  running mean 0 and variance 1 until the calibration below.

Every other parameter takes one normal draw of the ``leaves`` stream, in
module order, made only where such a parameter exists (so the draws above
stay those of a model without them):

* a norm's scale (``LayerNorm``, ``GroupNorm``, ``RMSNorm``, other batch
  and instance norms) ``1 + 0.1 z``, its shift ``0.05 z``;
* any other leaf of two or more dimensions (``Linear``,
  ``MultiheadAttention``'s ``in_proj_weight``, a query table): std
  1 / sqrt(fan_in), fan_in its size over its first dimension;
* any other leaf of one dimension or none (a ``Linear``'s bias, a bare
  ``nn.Parameter`` such as a residual scale): 0.1 z.

A family's reference file may define ``seed_leaves_(model, gen)``: it runs
after these rules, with a generator of the ``family`` stream, for leaves that
need a distribution of their own, and for persistent float buffers, which no
rule here draws. A leaf still NaN after seeding or after the calibration
makes ``make_weights`` raise and name it.

``BN_SCALE`` puts the random network in its near-linear regime. At scale 1
a random 100-layer detector is chaotic: a 1e-3 change of the input moves
its maps by 12-27% and bf16 rounding by 28-49%, so no comparison with the
reference could tell bf16 from int8. At 0.07 the same input change moves
them by 2% and bf16 rounding by 4-6% on every seed tried, while the
program's int8 path reads 25-35% (one H100, four seeds each). The work is
the same: every shape, op and kernel.

Then the plain reference (``reference/<family>.py``) runs once in train
mode over ``CALIB_IMAGES`` seeded images of the cell's own traffic with
momentum 1, so every BatchNorm's running mean and variance are those of its
input there, as in a trained network. Without that, eval-mode BN at unit
statistics lets the signal fade through the depth and the maps come out
nearly constant.

The same seed gives the same weights on the same device type (on a CPU,
at the same thread count: the calibration's sums follow it).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

SEED_MASK = (1 << 63) - 1


#: one stream of draws a purpose, so that a seed's images do not move when
#: the weights take more draws
STREAMS = {"weights": 1, "traffic": 2, "calib": 3, "leaves": 4, "family": 5}
#: images of the BN statistics' calibration pass
CALIB_IMAGES = 4
#: the BatchNorm scales' size (see the module docstring)
BN_SCALE = 0.07
#: modules whose ``weight`` and ``bias`` are a norm's scale and shift
NORMS = (nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm, nn.RMSNorm)


def generator(seed: int, device, purpose: str = "weights") -> torch.Generator:
    """A generator on ``device`` for one purpose of a run's ``--seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + STREAMS[purpose]) & SEED_MASK)


@torch.no_grad()
def seeded_(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters and norm statistics in place from
    ``seed`` by the rules of the module docstring."""
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
    done = {id(t) for _, m in convs for t in (m.weight, m.bias) if t is not None}
    done |= {id(t) for m in bns for t in (m.weight, m.bias)}
    _seed_other_leaves_(model, done, generator(seed, dev, "leaves"))
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._NormBase) and m.running_mean is not None:
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def _seed_other_leaves_(model: nn.Module, done, gen: torch.Generator) -> None:
    """Every parameter not in ``done`` (ids), from one draw of ``gen``."""
    leaves = []  # (parameter, scale of z, shift)
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            if id(p) in done:
                continue
            done.add(id(p))
            if isinstance(m, NORMS):
                leaves.append((p, 0.1, 1.0) if name == "weight" else (p, 0.05, 0.0))
            elif p.dim() >= 2:
                leaves.append((p, 1.0 / math.sqrt(p[0].numel()), 0.0))
            else:
                leaves.append((p, 0.1, 0.0))
    if not leaves:
        return
    z = torch.randn(sum(p.numel() for p, _, _ in leaves), generator=gen, device=gen.device)
    off = 0
    for p, scale, shift in leaves:
        p.copy_(z[off:off + p.numel()].view_as(p) * scale + shift)
        off += p.numel()


@torch.no_grad()
def calibrate_bn_(model: nn.Module, images: torch.Tensor) -> nn.Module:
    """Set every BN's running statistics to those of its input over
    ``images`` (NHWC f32): one train-mode pass with momentum 1."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
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


def _nan_leaves(model: nn.Module):
    """Names of the float leaves that hold a NaN (one sync for all)."""
    leaves = {k: v for k, v in model.state_dict().items() if v.is_floating_point()}
    bad = torch.stack([torch.isnan(v).any() for v in leaves.values()]).tolist()
    return [k for k, b in zip(leaves, bad) if b]


@torch.no_grad()
def make_weights(cfg, traffic, seed: int, device) -> Dict[str, torch.Tensor]:
    """A configuration's weights for ``seed``: drawn into the plain
    reference, BN calibrated on the cell's own kind of images; a
    ``state_dict`` that loads into the program's model as well."""
    from benchmark.reference import family, nets
    from benchmark.traffic import scenes

    fam = family(cfg)
    ref = fam.build(cfg).to(device)
    for v in ref.state_dict().values():
        if v.is_floating_point():
            v.fill_(float("nan"))
    seeded_(ref, seed)
    if hasattr(fam, "seed_leaves_"):
        fam.seed_leaves_(ref, generator(seed, device, "family"))
    if bad := _nan_leaves(ref):
        raise ValueError(f"{cfg['name']}: no rule of benchmark/weights.py seeds {bad}; "
                         f"draw them in seed_leaves_ of benchmark/reference/{cfg['family']}.py")
    imgs = scenes.draw(cfg, traffic, generator(seed, device, "calib"), CALIB_IMAGES, device)[0]
    with nets.full_f32():
        calibrate_bn_(ref, (imgs * 255.0 + 0.5).floor() / 255.0)
    if bad := _nan_leaves(ref):
        raise ValueError(f"{cfg['name']}: leaves {bad} are NaN after the BN calibration")
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}
