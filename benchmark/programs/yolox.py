"""YOLOX in the program: ``models/yolox.py::YOLOXModel``, and the train step
as ``train/trainer.py`` builds it (the YOLOX loss, clip + AdamW + EMA,
per-leaf state)."""

from __future__ import annotations

from typing import Any, Dict

import torch


def model(cfg, device):
    from yolo_scratch_tpu_torch.models.yolox import YOLOXModel

    with torch.device("meta"):
        m = YOLOXModel(nc=cfg["nc"], depth=cfg["depth_multiple"], width=cfg["width_multiple"],
                       in_ch=cfg["ch"])
    return m.to_empty(device=device)


def train_step(model, cfg: Dict[str, Any], precision: str | None = "highest"):
    """(step, state) as the trainer builds them for a YOLOX model."""
    from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
    from yolo_scratch_tpu_torch.train.optim import AdamW
    from yolo_scratch_tpu_torch.train.state import create_train_state
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, yolox_loss_adapter

    hp = cfg["train"]
    loss = yolox_loss_adapter(YOLOXLossConfig(nc=cfg["nc"], strides=tuple(cfg["strides"]),
                                              use_l1=bool(hp["l1_loss"])))
    step = build_train_step_custom(model, loss, matmul_precision=precision)
    tx = AdamW(learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
               clip_norm=hp["clip_norm"], b1=hp["betas"][0], b2=hp["betas"][1], eps=hp["eps"])
    state = create_train_state(model, tx, use_ema=hp["ema"], ema_decay=hp["ema_decay"],
                               ema_tau=hp["ema_tau"])
    return step, state
