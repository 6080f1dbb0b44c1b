"""bf16 against int8 deploy-path accuracy on a trained checkpoint (port of
``scripts/eval_quant.py``, with its flags and its JSON line).

Measures the accuracy cost of the int8 PTQ tier (``nn/quant.py``) through
the deploy pipeline itself: the ``Predictor`` (BN folded, bf16, fused
select-then-decode, NMS kernel #1 class-aware at IoU 0.45, K=512, at most
300 detections), on the trainer's val split (the same seeded permutation)
and scored by the host greedy matcher. Calibration batches come from the
train split. Prints one JSON line with both variants and the deltas.

Run (a checkpoint of ``train.cli``):

    python -m yolo_scratch_tpu_torch.eval_quant --data synthetic --ckpt runs/t \\
        --which last --imgsz 320

Runs on ``cuda`` unless ``--device cpu``; ``--nms`` takes the port's sweeps
(``kernel``, the default, ``pairwise`` or ``tiled``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig, load_deploy_model
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.nn.quant import count_quantized, quantize_for_deploy
from yolo_scratch_tpu_torch.ops.decode import NMS_IMPLS
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.cli import make_datasets, split_indices
from yolo_scratch_tpu_torch.utils.metrics import (
    detections_to_lists,
    evaluate_detections,
    targets_to_lists,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="bf16 vs int8 deploy accuracy (PyTorch/CUDA)")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--dataset", type=str, default="auto")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--which", type=str, default="last", choices=["best", "last"])
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--no-ema", action="store_true",
                   help="serve raw params even if the checkpoint has EMA")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    p.add_argument("--nms", type=str, default="kernel", choices=list(NMS_IMPLS),
                   help="NMS sweep (keep sets equal); kernel = NMS kernel #1")
    return p


def score(pred: Predictor, ds, indices, batch_size: int, conf: float,
          max_batches: int | None = None) -> dict:
    """``pred``'s detections on ``ds[indices]`` scored by the host greedy
    matcher: the metrics, the eval's seconds (its first batch, which pays
    the variant's warm-up, apart) and the images scored."""
    loader = Loader(ds, batch_size, indices=indices, prefetch=2)
    all_preds, all_targets = [], []
    t0 = time.time()
    first_batch_s = None
    try:
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            packed = pred.predict_batch(batch["img"]).cpu().numpy()
            boxes, scores, labels, valid = (packed[..., :4], packed[..., 4],
                                            packed[..., 5].astype(np.int32),
                                            packed[..., 6] > 0)
            if first_batch_s is None:  # the fetch above synced
                first_batch_s = time.time() - t0
            sv = np.asarray(batch["sample_valid"])
            preds = detections_to_lists(boxes, scores, labels, valid)
            targets = targets_to_lists(batch["gt_labels"], batch["gt_bboxes"],
                                       batch["gt_mask"])
            all_preds.extend(pr for pr, ok in zip(preds, sv) if ok)
            all_targets.extend(t for t, ok in zip(targets, sv) if ok)
    finally:
        loader.close()
    total_s = time.time() - t0
    m = evaluate_detections(all_preds, all_targets, conf_threshold=conf)
    m["eval_s"] = round(total_s, 1)
    m["first_batch_s"] = round(first_batch_s or 0.0, 1)
    m["warm_eval_s"] = round(total_s - (first_batch_s or 0.0), 1)
    m["images"] = len(all_preds)
    return m


def evaluate(args) -> tuple:
    """(the JSON line's dict, the variants' Predictors by name) of parsed
    ``args``."""
    ds, _, _ = make_datasets(args)
    train_idx, val_idx = split_indices(len(ds), args.seed, args.val_split)

    model = load_deploy_model(args.cfg, scale=args.scale, ckpt=args.ckpt, which=args.which,
                              device=args.device)
    if not args.no_ema:
        raw = CheckpointManager(args.ckpt).load_raw(args.which)
        if raw is not None and raw.get("ema"):
            model.load_state_dict({**raw["model"], **raw["ema"]})
            print("using EMA params", file=sys.stderr)

    cfg = PredictorConfig(img_size=args.imgsz, batch_size=args.batch,
                          conf_threshold=args.conf, iou_threshold=args.iou, max_det=300,
                          pre_nms_topk=512, class_aware_nms=True, nms_impl=args.nms)
    # calibration batches come from the TRAIN split (deploy-realistic: no
    # peeking at val data)
    calib_loader = Loader(ds, args.batch, indices=train_idx[: args.calib_batches * args.batch],
                          prefetch=0)
    calib = [b["img"] for b in calib_loader][: args.calib_batches]
    t0 = time.time()
    model_q = quantize_for_deploy(model, calib)
    print(f"quantized {count_quantized(model_q)} blocks in {time.time() - t0:.1f}s",
          file=sys.stderr)

    variants = {"bf16": Predictor(model, cfg, device=args.device),
                "int8": Predictor(model_q, cfg, device=args.device)}
    results = {}
    for name, pred in variants.items():
        results[name] = score(pred, ds, val_idx, args.batch, args.conf, args.max_batches)
        print(f"{name}: {json.dumps(results[name])}", file=sys.stderr)

    out = {
        "which": args.which,
        "bf16": results["bf16"],
        "int8": results["int8"],
        "delta_mAP50": results["int8"]["mAP50"] - results["bf16"]["mAP50"],
        "delta_mAP50_95": results["int8"]["mAP50-95"] - results["bf16"]["mAP50-95"],
    }
    return out, variants


def main(argv=None) -> dict:
    out, _ = evaluate(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
