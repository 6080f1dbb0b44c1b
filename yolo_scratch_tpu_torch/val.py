"""Standalone evaluation CLI: weights + dataset -> metrics (port of
``val.py``, with the same flags and the same printed JSON keys).

COCO-style P/R/mAP50/mAP50-95, optionally per class (``--per-class``), the
COCO 12-metric table (``--coco-summary``) and the NASA-CDA suite
(``--cda``). TP/FP matching runs on the device inside the eval step
(``ops/matching.py``); the host keeps only the AP accumulation.
``--host-match`` takes the reference-style numpy greedy matcher instead.

Run: ``python -m yolo_scratch_tpu_torch.val --data synthetic --torch-ckpt
best.pt [--per-class] [--coco-summary]``. Runs on ``cuda`` unless
``--device cpu``; it never falls back to the CPU on its own.

``--ckpt <dir> [--which best|last]`` evaluates a checkpoint directory that
the port's trainer or the JAX package's wrote (``train/checkpoints.py``);
``--ema`` evaluates its EMA parameters with the live BN statistics.

``--model yolox --scale s`` evaluates a YOLOX (SimOTA loss for the val
loss, ``yolox_eval_decode`` into the common postprocess), as the JAX CLI
does; ``--data`` takes the synthetic set, a crater tree or a COCO directory
(``train/cli.py::make_datasets``). A JAX run directory is read by the
port's own code (``train/jax_checkpoints.py``: orbax's OCDBT, zarr v2 and
zstd, or the npz fallback).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from yolo_scratch_tpu_torch.models.builder import CONFIGS


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Evaluate a detector (PyTorch/CUDA)")
    p.add_argument("--data", type=str, default="synthetic")
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "crater", "coco", "synthetic"])
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    p.add_argument("--model", type=str, default="yolo11", choices=["yolo11", "yolox"],
                   help="model family (yolox: --scale n|tiny|s|m|l|x, n = nano)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir written by the port's or the JAX package's trainer")
    p.add_argument("--which", type=str, default="best", choices=["best", "last"])
    p.add_argument("--torch-ckpt", type=str, default=None,
                   help="reference-layout .pt checkpoint or state_dict")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-gt", type=int, default=100)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--cda", action="store_true", help="also compute the CDA scorer suite")
    p.add_argument("--per-class", action="store_true", help="per-class AP breakdown")
    p.add_argument("--coco-summary", action="store_true",
                   help="full COCO 12-metric table: AP/AP50/AP75, AP by area "
                        "band (small/medium/large, ignore semantics), AR@1/10/100")
    p.add_argument("--ema", action="store_true", help="evaluate EMA weights")
    p.add_argument("--host-match", action="store_true",
                   help="reference-style host greedy matcher instead of device marks")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)

    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.models.builder import build_yolo11
    from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS
    from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager, check_checkpoint
    from yolo_scratch_tpu_torch.train.cli import make_datasets
    from yolo_scratch_tpu_torch.train.steps import make_eval_step
    from yolo_scratch_tpu_torch.utils.device import resolve_device
    from yolo_scratch_tpu_torch.utils.metrics import (
        detections_to_lists,
        evaluate_cda_full,
        evaluate_detections,
        evaluate_per_class,
        metrics_from_marks,
        per_class_from_marks,
        targets_to_lists,
    )
    from yolo_scratch_tpu_torch.utils.weights import load_reference_checkpoint

    dev = resolve_device(args.device)
    ds, ch, nc = make_datasets(args)
    loss_fn = decode_fn = None
    if args.model == "yolox":
        # the Trainer's YOLOX wiring: SimOTA val loss, obj*cls decode
        from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
        from yolo_scratch_tpu_torch.models.yolox import (
            build_yolox,
            scale_name,
            yolox_eval_decode,
        )
        from yolo_scratch_tpu_torch.train.steps import yolox_loss_adapter

        model = build_yolox(scale_name(args.scale), nc=nc, ch=ch)
        loss_fn = yolox_loss_adapter(YOLOXLossConfig(nc=nc, strides=model.strides))
        decode_fn = lambda feats: yolox_eval_decode(feats, nc, model.strides)  # noqa: E731
    else:
        model = build_yolo11(args.cfg, ch=ch, nc=nc, scale=args.scale)
    if args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        tree = mgr.load_raw(args.which) if mgr.load_meta(args.which) is not None else None
        if tree is None:
            raise FileNotFoundError(f"no checkpoint '{args.which}' under {args.ckpt}")
        check_checkpoint(tree, model, args.which, ema=args.ema)
        # --ema: the EMA parameters with the live BN buffers (ema_state_dict)
        model.load_state_dict({**tree["model"], **(tree["ema"] if args.ema else {})})
    model = model.to(dev).eval()

    device_match = not args.host_match
    need_lists = args.cda or args.host_match
    step = make_eval_step(
        model, conf_threshold=args.conf, iou_threshold=args.iou, loss_fn=loss_fn,
        decode_fn=decode_fn,
        match_thresholds=DEFAULT_THRESHOLDS if device_match else None,
        per_class=(args.per_class or args.coco_summary) and device_match,
    )

    all_preds, all_targets = [], []
    marks, marks_cls, det_scores, det_labels, det_valid = [], [], [], [], []
    gt_label_list, gt_mask_list = [], []
    det_boxes, gt_box_list = [], []  # --coco-summary: raw boxes for band marks
    n_gt = 0
    losses = []
    loader = Loader(ds, args.batch, max_gt=args.max_gt, prefetch=2)
    try:
        for i, batch in enumerate(loader):
            if args.max_batches is not None and i >= args.max_batches:
                break
            out = step(batch)
            metrics = out[0]
            boxes, scores, labels, valid = (_np(t) for t in out[1])
            losses.append(float(metrics["loss"]))
            sv = np.asarray(batch.get("sample_valid", np.ones(batch["img"].shape[0], bool)))
            if device_match:
                marks.append(_np(out[2])[sv])
                if args.per_class or args.coco_summary:
                    marks_cls.append(_np(out[3])[sv])
                det_scores.append(scores[sv])
                det_labels.append(labels[sv])
                det_valid.append(valid[sv])
                gt_label_list.append(batch["gt_labels"][sv])
                gt_mask_list.append(batch["gt_mask"][sv])
                n_gt += int(batch["gt_mask"][sv].sum())
                if args.coco_summary:
                    det_boxes.append(boxes[sv])
                    gt_box_list.append(batch["gt_bboxes"][sv])
            if need_lists:
                preds = detections_to_lists(boxes, scores, labels, valid)
                targets = targets_to_lists(
                    batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"])
                all_preds.extend(pr for pr, ok in zip(preds, sv) if ok)
                all_targets.extend(t for t, ok in zip(targets, sv) if ok)
    finally:
        loader.close()

    out = {"loss": float(np.mean(losses)) if losses else float("nan")}
    class_names = getattr(ds, "class_names", None)
    if device_match:
        if marks:
            out.update(metrics_from_marks(
                np.concatenate(marks), np.concatenate(det_scores),
                np.concatenate(det_valid), n_gt))
        else:
            out.update({"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0})
        if args.per_class and marks_cls:
            per = per_class_from_marks(
                np.concatenate(marks_cls), np.concatenate(det_scores),
                np.concatenate(det_labels), np.concatenate(det_valid),
                np.concatenate(gt_label_list), np.concatenate(gt_mask_list),
                nc, class_names=class_names)
            out.update({f"class/{name}/{k}": v for name, d in per.items()
                        for k, v in d.items()})
        if args.coco_summary and marks:
            from yolo_scratch_tpu_torch.ops.matching import batched_tp_marks_area
            from yolo_scratch_tpu_torch.utils.metrics import (
                COCO_AREA_BANDS,
                coco_strict_ap_from_marks,
                coco_summary_from_marks,
            )

            # band membership is by PIXEL area at eval resolution (boxes are
            # normalised; COCO proper uses native-resolution areas)
            pb = np.concatenate(det_boxes) * float(args.imgsz)
            gbx = np.concatenate(gt_box_list) * float(args.imgsz)
            pv = np.concatenate(det_valid)
            gmk = np.concatenate(gt_mask_list)
            bands = {}
            chunk = 256  # bounds the (B, N, G) IoU working set on the device
            for name, (lo, hi) in COCO_AREA_BANDS.items():
                tp_parts, ign_parts = [], []
                n_gt_b = 0
                for s in range(0, pb.shape[0], chunk):
                    tp_c, ign_c, n_c = batched_tp_marks_area(
                        *(torch.from_numpy(a[s:s + chunk]).to(dev) for a in (pb, pv, gbx, gmk)),
                        lo, hi)
                    tp_parts.append(_np(tp_c))
                    ign_parts.append(_np(ign_c))
                    n_gt_b += n_c
                bands[name] = (
                    np.concatenate(tp_parts), np.concatenate(ign_parts), n_gt_b)
            summary = coco_summary_from_marks(
                np.concatenate(marks), np.concatenate(det_scores), pv, n_gt, bands)
            if marks_cls:
                # the pycocotools headline: per-class AP averaged over
                # classes with GTs (category-aware matching)
                summary.update(coco_strict_ap_from_marks(
                    np.concatenate(marks_cls), np.concatenate(det_scores),
                    np.concatenate(det_labels), pv,
                    np.concatenate(gt_label_list), gmk, nc))
            out.update({f"coco/{k}": v for k, v in summary.items()})
    else:
        out.update(evaluate_detections(
            all_preds, all_targets, conf_threshold=args.conf))
        if args.per_class:
            per = evaluate_per_class(
                all_preds, all_targets, nc, conf_threshold=args.conf,
                class_names=class_names)
            out.update({f"class/{name}/{k}": v for name, d in per.items()
                        for k, v in d.items()})
    if args.cda:
        out.update({f"cda/{k}": v for k, v in evaluate_cda_full(all_preds, all_targets).items()})
    print(json.dumps(out))
    return out


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
