"""The toy family's program side, copied in as ``programs/toy.py``: the
program's model is the reference's class (the test drives it through a
stand-in predictor)."""

from __future__ import annotations

import torch

from benchmark.reference import toy


def model(cfg, device):
    with torch.device("meta"):
        m = toy.Toy(cfg)
    return m.to_empty(device=device)
