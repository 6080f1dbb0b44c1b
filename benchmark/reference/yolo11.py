"""YOLO11's plain reference: ``nets.YOLO11`` and the DFL head's
select-then-decode (``post.yolo11_candidates``), then greedy NMS."""

from __future__ import annotations

import torch

from . import nets, post


def build(cfg):
    return nets.YOLO11(cfg, cfg["ch"], cfg["nc"], cfg.get("reg_max", 16))


def postprocess(cfg, maps, traffic, dtype=torch.float32):
    cands = post.yolo11_candidates(maps, cfg["nc"], cfg["strides"], cfg.get("reg_max", 16),
                                   float(traffic["conf"]), int(traffic["pre_nms_topk"]), dtype)
    return post.nms_and_pack(*cands, traffic)
