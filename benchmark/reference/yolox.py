"""YOLOX's plain reference: ``nets.YOLOX``, its every-anchor decode
(``post.yolox_candidates``), then greedy NMS; training by
``train.Trainer`` (SimOTA, clip, AdamW, EMA)."""

from __future__ import annotations

import torch

from . import nets, post, train


def build(cfg):
    return nets.YOLOX(cfg, cfg["ch"], cfg["nc"])


def postprocess(cfg, maps, traffic, dtype=torch.float32):
    cands = post.yolox_candidates(maps, cfg["nc"], cfg["strides"], float(traffic["conf"]),
                                  int(traffic["pre_nms_topk"]), dtype)
    return post.nms_and_pack(*cands, traffic)


def trainer(model, cfg):
    return train.Trainer(model, cfg["train"], cfg["nc"])
