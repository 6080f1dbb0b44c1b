"""Anchor points for the anchor-free head (port of ``ops/anchors.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(
    hw_strides: Sequence[Tuple[int, int, float]],
    grid_cell_offset: float = 0.5,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(anchor_points (A, 2), stride_tensor (A, 1)) from per-scale
    (feat_h, feat_w, stride); row-major y-outer, x-inner, x first.

    Built on ``device`` in f32, then cast: no host array and no copy, so a
    caller on the card never waits for its stream to drain. Small integers
    plus the offset are exact in f32, as in the JAX package's numpy grid."""
    pts, strides = [], []
    for h, w, s in hw_strides:
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(torch.full((h * w, 1), s, dtype=torch.float32, device=device))
    return torch.cat(pts).to(dtype), torch.cat(strides).to(dtype)


def feat_shapes_for(img_hw: Tuple[int, int], strides: Sequence[float]):
    """(img_h, img_w) + strides -> [(feat_h, feat_w, stride), ...]."""
    return [(int(img_hw[0] // s), int(img_hw[1] // s), float(s)) for s in strides]
