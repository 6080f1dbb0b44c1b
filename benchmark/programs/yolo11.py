"""YOLO11 in the program: ``models/builder.py::YOLOModel`` from the
configuration's rows."""

from __future__ import annotations

import torch


def model(cfg, device):
    from yolo_scratch_tpu_torch.models.builder import YOLOModel

    with torch.device("meta"):
        m = YOLOModel.from_config(cfg, ch=cfg["ch"], nc=cfg["nc"], scale=cfg["scale"])
    return m.to_empty(device=device)
