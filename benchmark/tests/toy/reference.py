"""A toy family for the harness's own tests, copied in as
``reference/toy.py``: an NMS-free detector with the kinds of leaf and work a
new family brings. Two strided conv blocks make tokens, a ``LayerNorm`` and
an area mix (``AreaMix``, counted by its own ``flops``) work on them,
learned queries (a bare ``nn.Parameter``) read them through
``nn.MultiheadAttention`` with a residual scale ``gamma``, and a ``Linear``
gives each query [cx, cy, w, h, class logits]."""

from __future__ import annotations

import torch
from torch import nn

from . import nets, post


class AreaMix(nn.Module):
    """Each of ``areas`` equal runs of tokens attends to itself:
    x + softmax(x_a x_a^T / sqrt(C)) x_a."""

    def __init__(self, areas: int):
        super().__init__()
        self.areas = areas

    def forward(self, x):
        B, N, C = x.shape
        a = x.reshape(B * self.areas, N // self.areas, C)
        w = (a @ a.transpose(1, 2) * C ** -0.5).softmax(-1)
        return x + (w @ a).reshape(B, N, C)

    def flops(self, inputs, output):
        B, N, C = inputs[0].shape
        return 2 * 2 * B * N * (N // self.areas) * C


class Toy(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        C = cfg["width"]
        self.stem = nn.Sequential(nets.Conv(cfg["ch"], C, 3, 2), nets.Conv(C, C, 3, 2))
        self.norm = nn.LayerNorm(C)
        self.mix = AreaMix(cfg["areas"])
        self.query = nn.Parameter(torch.empty(cfg["queries"], C))
        self.read = nn.MultiheadAttention(C, cfg["heads"])
        self.gamma = nn.Parameter(torch.empty(C))
        self.head = nn.Linear(C, 4 + cfg["nc"])

    def forward(self, x):
        t = self.stem(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        kv = self.mix(self.norm(t)).transpose(0, 1)
        q = self.query[:, None].expand(-1, x.shape[0], -1)
        r = q + self.gamma * self.read(q, kv, kv)[0]
        return [self.head(r.transpose(0, 1))]


def build(cfg):
    return Toy(cfg)


def postprocess(cfg, maps, traffic, dtype=torch.float32):
    """Every query a box (sigmoid of the centre and size, times the image
    side) scored by its best class; no NMS, so K = 0."""
    x = maps[0].to(dtype)
    S = int(traffic["img_size"])
    c, wh = x[..., :2].sigmoid() * S, x[..., 2:4].sigmoid() * S
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    prob = x[..., 4:].sigmoid()
    scores, labels = prob.amax(-1), prob.argmax(-1)
    packed = post.pack(boxes, scores, labels, scores > float(traffic["conf"]),
                       int(traffic["max_det"]), S)
    none = torch.zeros((x.shape[0], 0), dtype=torch.bool, device=x.device)
    return packed, none, none


def seed_leaves_(model, gen):
    """The queries at unit scale, as a DETR's query embedding."""
    model.query.normal_(generator=gen)
