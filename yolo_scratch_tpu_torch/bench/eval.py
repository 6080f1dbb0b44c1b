"""COCO-val-scale evaluation: device matching against the host matcher
(port of ``scripts/bench_eval.py``).

    python -m yolo_scratch_tpu_torch.bench.eval [--images 5000] [--batch 64] [--imgsz 640] \
        [--nc 80] [--max-gt 24] [--per-class-host 1]

The eval stack at COCO-val scale (5,000 images, nc=80, ch=3, 640, B=64),
on the seeded YOLO11n at conf 0.001:

* ``device_path``: the eval step (f32 forward with TF32 off, v8 loss,
  fused select-then-decode, kernel #1 over the top 2048, greedy TP marks on
  the device, ``ops/matching.py``, plain and per-class), then the host's AP
  accumulation from the marks (``metrics_from_marks``,
  ``per_class_from_marks``);
* ``host_path``: the numpy greedy matcher per image and threshold
  (``utils/metrics.py::evaluate_detections``) fed the same detections, and
  its per-class pass timed on 8 classes and scaled to ``nc``.

``agreement_mAP50_95{device, host}``: the two paths' mAP50-95. They are
equal unless a TP and an FP tie on score: the device path's accumulation
(``metrics_from_marks``) sorts all detections once, stably, where the
host's (``calculate_ap``) puts TPs first among equal scores, in the port as
in the JAX package. ``tp_fp_score_ties`` counts the detections whose score
some detection of the other kind shares (at any IoU threshold), and
``marks_host_ap`` is the device's marks accumulated as the host accumulates
its own: it equals ``host`` exactly whenever the device's TP marks equal
the host matcher's, ties or not. Images are random uint8 / 255 and the
ground truth synthetic, the same numpy draws as the JAX script's (4
distinct batches, cycled). Seeded
weights score every anchor below 0.001 (in the JAX package as well), so
the line's ``detections_per_image`` is 0 there and the two paths agree on
empty sets; :func:`run` takes any model and batches, and the tests and
``chip_smoke.py`` give it a model whose scores pass the gate and ground
truth near its detections.

Prints one JSON line, plus ``device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS
from yolo_scratch_tpu_torch.train.steps import make_eval_step
from yolo_scratch_tpu_torch.utils.device import resolve_device
from yolo_scratch_tpu_torch.utils.metrics import (
    calculate_ap,
    detections_to_lists,
    evaluate_detections,
    evaluate_per_class,
    metrics_from_marks,
    per_class_from_marks,
    targets_to_lists,
)


def make_batch(seed: int, B: int, S: int, nc: int, G: int) -> dict:
    """The JAX script's batch ``seed``: random images, synthetic GT."""
    r = np.random.RandomState(seed)
    img = r.randint(0, 256, (B, S, S, 3), np.uint8).astype(np.float32) / 255.0
    c = r.rand(B, G, 2).astype(np.float32) * 0.8 + 0.1
    wh = r.rand(B, G, 2).astype(np.float32) * 0.2 + 0.02
    gt = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    return {"img": img, "gt_bboxes": gt,
            "gt_labels": r.randint(0, nc, (B, G)).astype(np.int32),
            "gt_mask": np.arange(G)[None] < r.randint(4, G + 1, B)[:, None]}


def batches_near_detections(model, seeds, B: int, S: int, nc: int, G: int) -> list:
    """:func:`make_batch` of ``seeds`` with the ground truth moved near every
    other detection of ``model`` (at conf 0.001), jittered by up to 15% of
    the box's size, so that matches fall on both sides of the IoU thresholds
    and an agreement of the two paths is not one on an mAP of 0.
    A detection's jitter depends on its rank in its image only: a model of
    random weights scores some anchors alike in every image, and equal
    jitters give most such tied detections equal TP/FP flags."""
    step = make_eval_step(model, conf_threshold=0.001)
    jitters = np.random.RandomState(0).uniform(-0.15, 0.15, (G, 4))
    out = []
    for seed in seeds:
        b = make_batch(seed, B, S, nc, G)
        boxes, _, labels, valid = (t.cpu().numpy() for t in step(b)[1])
        b["gt_mask"][:] = False
        for i in range(B):
            near = np.flatnonzero(valid[i])[::2][:G]
            wh = boxes[i, near, 2:] - boxes[i, near, :2]
            b["gt_bboxes"][i, :len(near)] = np.clip(
                boxes[i, near] + jitters[:len(near)] * np.tile(wh, 2), 0, 1)
            b["gt_labels"][i, :len(near)] = labels[i, near]
            b["gt_mask"][i, :len(near)] = True
        out.append(b)
    return out


def marks_host_ap(marks: np.ndarray, scores: np.ndarray, valid: np.ndarray,
                  n_gt: int) -> tuple[float, int]:
    """(mAP50-95 of the device's TP marks (B, T, N) accumulated by
    ``calculate_ap``, TPs first among equal scores as the host path does;
    the number of detections whose score a detection of the other kind
    shares at some threshold)."""
    flags, s = marks.transpose(0, 2, 1)[valid], scores[valid]
    aps, tied = [], np.zeros(len(s), bool)
    for t in range(flags.shape[1]):
        f = flags[:, t]
        aps.append(calculate_ap(s[f].tolist(), s[~f].tolist(), n_gt))
        tied |= np.isin(s, s[f]) & np.isin(s, s[~f])
    return float(np.mean(aps)), int(tied.sum())


def _host_per_class(lists_pred, lists_tgt, nc: int) -> float:
    """Seconds of the host per-class matcher on the first 8 classes, scaled
    to ``nc`` (the full pass is nc runs of the whole matcher)."""
    k = min(8, nc)
    preds, tgts = [], []
    for p, t in zip(lists_pred, lists_tgt):
        pm = np.asarray(p["labels"]).reshape(-1) < k
        tm = np.asarray(t["labels"]).reshape(-1) < k
        preds.append({"boxes": np.asarray(p["boxes"]).reshape(-1, 4)[pm],
                      "scores": np.asarray(p["scores"]).reshape(-1)[pm],
                      "labels": np.asarray(p["labels"]).reshape(-1)[pm]})
        tgts.append({"boxes": np.asarray(t["boxes"]).reshape(-1, 4)[tm],
                     "labels": np.asarray(t["labels"]).reshape(-1)[tm]})
    t0 = time.perf_counter()
    evaluate_per_class(preds, tgts, k, conf_threshold=0.001)
    return (time.perf_counter() - t0) * (nc / k)


def run(model, images: int = 5000, batch: int = 64, imgsz: int = 640, nc: int = 80,
        max_gt: int = 24, per_class_host: bool = True, conf: float = 0.001,
        batches: list | None = None) -> dict:
    """The bench on ``model`` (on its device), cycling ``batches`` (default:
    :func:`make_batch` of seeds 0-3): the JSON line's dict."""
    S, B, G = imgsz, batch, max_gt
    dev = next(model.parameters()).device
    step = make_eval_step(model, conf_threshold=conf, match_thresholds=DEFAULT_THRESHOLDS,
                          per_class=True)
    n_batches = images // B
    if batches is None:
        batches = [make_batch(s, B, S, nc, G) for s in range(min(n_batches, 4))]
    C.fetch(step(batches[0])[1], dev)  # warm-up: cuDNN's search, the kernels' build

    with C.kernel1_launches() as k1:
        t0 = time.perf_counter()
        outs = [(batches[i % len(batches)], step(batches[i % len(batches)]))
                for i in range(n_batches)]
        t_dispatch = time.perf_counter() - t0
        fetched = [(b, C.fetch(list(out[1:]), dev)) for b, out in outs]
        t_device = time.perf_counter() - t0
    marks = np.concatenate([f[1].numpy() for _, f in fetched])
    marks_cls = np.concatenate([f[2].numpy() for _, f in fetched])
    boxes, scores, labels, valid = (np.concatenate([f[0][i].numpy() for _, f in fetched])
                                    for i in range(4))
    n_gt = sum(int(b["gt_mask"].sum()) for b, _ in fetched)

    t1 = time.perf_counter()
    agg = metrics_from_marks(marks, scores, valid, n_gt)
    t_host_agg = time.perf_counter() - t1
    by_host_ap, ties = marks_host_ap(marks, scores, valid, n_gt)
    t2 = time.perf_counter()
    per_class_from_marks(marks_cls, scores, labels, valid,
                         np.concatenate([b["gt_labels"] for b, _ in fetched]),
                         np.concatenate([b["gt_mask"] for b, _ in fetched]), nc)
    t_host_per_class = time.perf_counter() - t2

    t3 = time.perf_counter()
    lists_pred = detections_to_lists(boxes, scores, labels, valid)
    lists_tgt = [t for b, _ in fetched
                 for t in targets_to_lists(b["gt_labels"], b["gt_bboxes"], b["gt_mask"])]
    host = evaluate_detections(lists_pred, lists_tgt, conf_threshold=0.001)
    t_host_match = time.perf_counter() - t3
    t_host_pc = _host_per_class(lists_pred, lists_tgt, nc) if per_class_host else None

    n = n_batches * B
    host_s = t_host_agg + t_host_per_class
    return {
        "images": n, "nc": nc, "imgsz": S, "batch": B,
        "device_path": {
            "dispatch_s": round(t_dispatch, 3), "eval_total_s": round(t_device, 3),
            "host_ap_accumulation_s": round(t_host_agg, 4),
            "host_per_class_accumulation_s": round(t_host_per_class, 4),
            "images_per_sec": round(n / (t_device + host_s), 1),
            "host_fraction": round(host_s / (t_device + host_s), 4),
        },
        "host_path": {
            "greedy_match_s": round(t_host_match, 3),
            "per_class_s_extrapolated": None if t_host_pc is None else round(t_host_pc, 3),
        },
        "agreement_mAP50_95": {"device": round(agg["mAP50-95"], 6),
                               "host": round(host["mAP50-95"], 6),
                               "marks_host_ap": round(by_host_ap, 6)},
        "tp_fp_score_ties": ties,
        "detections_per_image": float(valid.sum()) / n,
        "nms_launches": k1["launches"],
        "device": C.device_block(dev),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="COCO-scale eval, device vs host matching "
                                             "(scripts/bench_eval.py)")
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--nc", type=int, default=80)
    ap.add_argument("--max-gt", type=int, default=24)
    ap.add_argument("--per-class-host", type=int, default=1,
                    help="also time the host per-class matcher (slow)")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=3, nc=args.nc, scale="n", seed=0,
                         device=dev)
    return C.emit(run(model, args.images, args.batch, args.imgsz, args.nc, args.max_gt,
                      bool(args.per_class_host)))


if __name__ == "__main__":
    main()
