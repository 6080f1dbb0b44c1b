"""Batched streaming inference, the deploy path (port of ``infer.py``).

Pipeline: native C++ host decode + letterbox (``csrc/yst_host.cpp``) ->
uint8 batch to the device -> BN-folded bf16 forward (cuDNN) -> decode ->
greedy NMS on the hand-written CUDA kernel -> (B, max_det, 7) packed
detections -> boxes mapped back to original-image pixels. The decode follows
the family: YOLO11 (DFL head) takes the fused select-then-decode, YOLOX
``yolox_eval_decode`` in f32 and the common ``postprocess``. Device work is
asynchronous, so host prep of the next batches overlaps it
(``PredictorConfig.inflight``).

CLI: ``python -m yolo_scratch_tpu_torch.infer --images <dir> [--weights
state_dict.pt] [--model auto|yolo11|yolox] --out preds.json``. Runs on
``cuda`` unless ``--device cpu``.

Not ported yet: ``shard_over``, int8 serving, orbax checkpoints.
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from yolo_scratch_tpu_torch.models.builder import CONFIGS, YOLOModel, build_yolo11, dims_from_params
from yolo_scratch_tpu_torch.models.yolox import (
    SCALES as YOLOX_SCALES,
    YOLOXModel,
    build_yolox,
    scale_name,
    yolox_arch_from_params,
    yolox_eval_decode,
)
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.ops.decode import postprocess, postprocess_from_feats
from yolo_scratch_tpu_torch.utils.device import resolve_device


@dataclass
class PredictorConfig:
    img_size: int = 640
    batch_size: int = 32
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_det: int = 300
    # Fixed-shape prefilter cap, the NMS sweep's length. A binding cap drops
    # the lowest-scoring real detections on dense scenes; raise it toward
    # 2048 when detections per image matter more than latency.
    pre_nms_topk: int = 512
    letterbox: bool = True
    bf16: bool = True
    fuse_bn: bool = True
    class_aware_nms: bool = False
    host_threads: int = 4
    u8_transfer: bool = True  # ship uint8 to the device; /255 runs there
    fast_jpeg: bool = True  # libjpeg M/8 decode-time downscale (see data/native.py)
    inflight: int = 3  # batches predict_paths keeps in flight
    nms_impl: str = "kernel"  # the CUDA sweep; "pairwise" for ops/nms.py


def pack_detections(boxes, scores, labels, valid) -> torch.Tensor:
    """(B, max_det, 7) f32 rows [x1 y1 x2 y2 score label valid]."""
    return torch.cat([
        boxes.to(torch.float32),
        scores.to(torch.float32)[..., None],
        labels.to(torch.float32)[..., None],
        valid.to(torch.float32)[..., None],
    ], dim=-1)


class Predictor:
    """Batched streaming predictor over a YOLO11 (builder) or YOLOX model.
    The model is copied, BN-folded (``fuse_bn``), cast (``bf16``) and moved
    to ``device`` (default ``cuda``; raises if there is no GPU)."""

    def __init__(self, model: YOLOModel | YOLOXModel, config: PredictorConfig = PredictorConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = config
        model = fuse_conv_bn(model) if config.fuse_bn else copy.deepcopy(model)
        self.dtype = torch.bfloat16 if config.bf16 else torch.float32
        model = model.to(self.device, self.dtype).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        # family dispatch: the YOLO11 builder family has a DFL head (reg_max)
        self.is_dfl = hasattr(model, "reg_max")
        # YOLOX reads its input channels off the stem (host prep decodes
        # gray or RGB by it)
        self.in_ch = (model.in_ch if self.is_dfl
                      else yolox_arch_from_params(model.state_dict())[0])

    @torch.inference_mode()
    def forward_feats(self, imgs) -> List[torch.Tensor]:
        """(B, S, S, C) uint8 (or float in [0, 1]) -> raw NHWC Detect maps
        in the working dtype."""
        x = torch.as_tensor(imgs).to(self.device)
        xx = x.to(self.dtype)
        if x.dtype == torch.uint8:
            xx = xx / 255.0
        return self.model(xx)

    @torch.inference_mode()
    def postprocess_feats(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Raw head maps -> (B, max_det, 7) packed detections."""
        cfg, m = self.cfg, self.model
        common = dict(img_size=cfg.img_size, conf_threshold=cfg.conf_threshold,
                      iou_threshold=cfg.iou_threshold, max_det=cfg.max_det,
                      pre_nms_topk=cfg.pre_nms_topk, class_aware=cfg.class_aware_nms,
                      nms_impl=cfg.nms_impl)
        if self.is_dfl:
            return pack_detections(*postprocess_from_feats(
                feats, nc=m.nc, strides=m.strides, reg_max=m.reg_max, **common))
        # YOLOX decodes in f32: bf16 box coordinates quantise to ~2.5 px at
        # 640 (exp(wh) * stride is the sensitive part)
        decoded = yolox_eval_decode([f.float() for f in feats], m.nc, m.strides)
        return pack_detections(*postprocess(decoded, **common))

    def predict_batch(self, imgs) -> torch.Tensor:
        """(B, S, S, C) images -> (B, max_det, 7) packed detections on the
        device (asynchronous: the caller's fetch synchronises)."""
        return self.postprocess_feats(self.forward_feats(imgs))

    # -- host prep ---------------------------------------------------------

    def _prepare(self, paths: Sequence[str]):
        """-> (imgs (B, S, S, C), meta (B, 5)) from the native host library."""
        from yolo_scratch_tpu_torch.data import native

        imgs, meta, status = native.prepare_batch(
            paths, self.cfg.img_size, channels=self.in_ch, letterbox=self.cfg.letterbox,
            threads=self.cfg.host_threads,
            dtype="uint8" if self.cfg.u8_transfer else "float32",
            fast_jpeg=self.cfg.fast_jpeg)
        if (status != 0).any():
            raise IOError(f"decode failed: {[p for p, s in zip(paths, status) if s != 0]}")
        return imgs, meta

    def _unmap_boxes(self, boxes_norm: np.ndarray, meta_row: np.ndarray) -> np.ndarray:
        """Normalized model-space xyxy -> original-image pixel xyxy."""
        S = self.cfg.img_size
        w0, h0, r, px, py = meta_row
        b = boxes_norm * S
        if r > 0:  # letterboxed
            b[:, [0, 2]] = (b[:, [0, 2]] - px) / r
            b[:, [1, 3]] = (b[:, [1, 3]] - py) / r
        else:  # stretch
            b[:, [0, 2]] *= w0 / S
            b[:, [1, 3]] *= h0 / S
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w0)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h0)
        return b

    # -- public API --------------------------------------------------------

    def predict_paths(self, paths: Sequence[str]) -> Iterator[Dict]:
        """Stream detections for image paths. Host prep of a batch overlaps
        device compute of up to ``cfg.inflight`` earlier batches; each batch
        is fetched once, packed."""
        B = self.cfg.batch_size
        depth = max(1, self.cfg.inflight)
        pending: List[tuple] = []  # (paths_chunk, meta, packed_device_out)

        def drain(entry):
            chunk, meta, out = entry
            packed = out.cpu().numpy()  # one blocking fetch per batch
            for j, p in enumerate(chunk):
                row = packed[j]
                v = row[:, 6] > 0.5
                yield {
                    "path": str(p),
                    "boxes": self._unmap_boxes(row[v, :4], meta[j]).tolist(),
                    "scores": row[v, 4].tolist(),
                    "labels": row[v, 5].astype(np.int64).tolist(),
                }

        for i in range(0, len(paths), B):
            chunk = list(paths[i: i + B])
            imgs, meta = self._prepare(chunk + [chunk[-1]] * (B - len(chunk)))
            pending.append((chunk, meta, self.predict_batch(imgs)))
            if len(pending) >= depth:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)


def load_deploy_model(
    cfg_path: str | Path = CONFIGS / "yolo11_crater.json",
    scale: str = "n",
    weights: str | Path | None = None,
    ch: int | None = None,
    nc: int | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
    model_kind: str = "auto",
) -> YOLOModel | YOLOXModel:
    """Build the model a deploy CLI serves: from a port ``state_dict`` file
    (``weights``; ch/nc read off it unless given) or a seeded init.
    Explicit ``ch``/``nc`` win. ``model_kind="auto"`` reads the family off
    the weights (a ``backbone.`` key means YOLOX, whose depth and width are
    read off too; ``yolox_arch_from_params``) and is YOLO11 without them.
    The defaults are the crater model's 1/5 for YOLO11 and COCO's 3/80 for
    YOLOX (``scale`` "n" means nano there)."""
    dev = resolve_device(device)
    state = None
    if weights:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        if model_kind == "auto":
            model_kind = "yolox" if any(k.startswith("backbone.") for k in state) else "yolo11"
    if model_kind == "yolox":
        if state is not None:
            d_ch, d_nc, depth, width = yolox_arch_from_params(state)
            model = build_yolox(nc=nc or d_nc, ch=ch or d_ch, seed=seed, depth=depth,
                                width=width)
        else:
            yx = scale_name(scale)
            if yx not in YOLOX_SCALES:
                raise ValueError(f"unknown YOLOX scale {scale!r}; choose from "
                                 f"{sorted(YOLOX_SCALES)} (or 'n' for nano)")
            model = build_yolox(yx, nc=nc or 80, ch=ch or 3, seed=seed)
    else:
        if state is not None:
            d_ch, d_nc = dims_from_params(state)
            ch, nc = ch or d_ch, nc or d_nc
        model = build_yolo11(cfg_path, ch=ch or 1, nc=nc or 5, scale=scale, seed=seed)
    if state is not None:
        model.load_state_dict(state)
    return model.to(dev)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Batched streaming inference (PyTorch/CUDA)")
    p.add_argument("--images", type=str, required=True, help="image dir or file")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    p.add_argument("--weights", type=str, default=None,
                   help="port state_dict (.pt); default: seeded init")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--out", type=str, default=None, help="write JSON here")
    p.add_argument("--stretch", action="store_true", help="stretch-resize (reference semantics)")
    p.add_argument("--nc", type=int, default=None, help="class count (default: from weights)")
    p.add_argument("--ch", type=int, default=None, help="input channels (default: from weights)")
    p.add_argument("--model", type=str, default="auto", choices=["auto", "yolo11", "yolox"],
                   help="model family (default: read from the weights)")
    p.add_argument("--class-aware", action="store_true", help="class-aware NMS")
    p.add_argument("--topk", type=int, default=PredictorConfig.pre_nms_topk,
                   help="prefilter cap (pre_nms_topk): the NMS sweep length")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)

    root = Path(args.images)
    exts = {".png", ".jpg", ".jpeg", ".bmp"}
    paths = ([str(root)] if root.is_file()
             else sorted(str(q) for q in root.rglob("*") if q.suffix.lower() in exts))
    if not paths:
        raise SystemExit(f"no images under {root}")

    model = load_deploy_model(args.cfg, scale=args.scale, weights=args.weights, ch=args.ch,
                              nc=args.nc, seed=args.seed, device=args.device,
                              model_kind=args.model)
    cfg = PredictorConfig(
        img_size=args.imgsz, batch_size=args.batch, conf_threshold=args.conf,
        iou_threshold=args.iou, letterbox=not args.stretch,
        class_aware_nms=args.class_aware, pre_nms_topk=args.topk)
    predictor = Predictor(model, cfg, device=args.device)

    t0 = time.perf_counter()
    results = list(predictor.predict_paths(paths))
    dt = time.perf_counter() - t0
    print(f"{len(paths)} images in {dt:.2f}s ({len(paths) / dt:.1f} img/s) on {predictor.device}")
    if args.out:
        Path(args.out).write_text(json.dumps(results))
        print(f"wrote {args.out}")
    else:
        for r in results[:5]:
            print(r["path"], len(r["scores"]), "detections")
    return results


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
