"""Headline benchmark: YOLO11n 640x640 deploy inference throughput (port of
``bench.py``).

    python -m yolo_scratch_tpu_torch.bench [--device cpu]

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``pre_nms_topk``, ``batch``, ``nscan``, ``coco_shaped{...}`` as ``bench.py``
does, plus ``best``, ``median`` and ``windows`` (img/s of each timed
window), ``nms_launches`` (kernel #1), ``valid_per_image`` (mean valid
detections) and ``device``.

The timed step is the deploy path on uint8 batches already on the device:
/255 there, BN-folded bf16 forward (cuDNN), fused select-then-decode
(exact top-``pre_nms_topk`` selection) and greedy NMS on kernel #1 at every
batch size. Host prep and the H2D copy are not in it, as in ``bench.py``.
Each timed launch runs ``nscan`` distinct batches; a window is ``ITERS``
launches; ``value`` is the best of ``WINDOWS`` windows.

Two rows, one process: crater (ch=1, nc=5), the headline ``value``, and
COCO-shaped (ch=3, nc=80) under ``coco_shaped``. Knobs, as in ``bench.py``:
``BENCH_BATCH`` (128), ``BENCH_TOPK`` (512), ``BENCH_NSCAN`` (8),
``BENCH_INT8=1`` (int8 PTQ on random calibration), ``BENCH_COCO=0`` (crater
row only).

Seeded weights score every anchor below conf 0.25, so the sweep runs on
empty candidate sets: ``valid_per_image`` says so, and no NMS figure may be
read from this line.
"""

from __future__ import annotations

import argparse
import os

import torch

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.infer import Predictor
from yolo_scratch_tpu_torch.utils.device import resolve_device

IMG, ITERS, WINDOWS = 640, 8, 3
# img/s of this bench at its defaults on one NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, best of 3 windows (PERF.md §2); vs_baseline divides
# each row by its own
BASELINE = {"crater": 5547.60, "coco": 5134.94}


def deploy_program(model, batch: int, topk: int, device, dtype=torch.bfloat16,
                   conf: float = 0.25, img: int = IMG):
    """(Predictor, program): ``program(xs)`` runs each uint8 batch of ``xs``
    (nscan, B, S, S, C) through the Predictor's device program and returns
    its ``(boxes, scores, labels, valid)`` per batch. ``dtype`` and ``conf``
    are the bench's bf16 and 0.25; the tests run it at f32 and 0."""
    pred = Predictor(model, C.deploy_config(img, batch, topk, dtype, conf), device=device)
    return pred, C.scan_program(pred._infer)


def measure(ch: int, nc: int, batch: int, topk: int, nscan: int, int8: bool, device,
            windows: int = WINDOWS) -> dict:
    """Build the crater-config YOLO11n for (ch, nc) and time its deploy
    program: img/s of each window, best and median, kernel #1's launches
    over the warm-up and timed launches, the batches those swept, and the
    mean valid detections per image of the last launch."""
    model = C.deploy_model(ch, nc, "n", IMG, int8, device)
    _, program = deploy_program(model, batch, topk, device, img=IMG)
    xs = C.uint8_batches((nscan, batch, IMG, IMG, ch), device)
    rates, out, launches = C.scan_windows(program, xs, ITERS, device, windows)
    return {**C.spread(rates), "nms_launches": launches,
            "batches_swept": (2 + windows) * ITERS * nscan,
            "valid_per_image": C.valid_per_image(out)}


def _row(name: str, metric: str, m: dict) -> dict:
    return {"metric": metric, "value": round(m["best"], 2), "unit": "images/sec/chip",
            "vs_baseline": round(m["best"] / BASELINE[name], 4),
            "best": m["best"], "median": m["median"], "windows": m["windows"],
            "nms_launches": m["nms_launches"], "batches_swept": m["batches_swept"],
            "valid_per_image": m["valid_per_image"]}


def main(argv=None, windows: int = WINDOWS) -> dict:
    p = argparse.ArgumentParser(description="YOLO11n 640 deploy throughput (bench.py)")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    topk = int(os.environ.get("BENCH_TOPK", "512"))
    nscan = int(os.environ.get("BENCH_NSCAN", "8"))
    int8 = os.environ.get("BENCH_INT8") == "1"
    with_coco = os.environ.get("BENCH_COCO", "1") != "0"
    tag = "_int8" if int8 else ""

    crater = measure(1, 5, batch, topk, nscan, int8, dev, windows)
    row = {**_row("crater", "yolo11n_640_infer_images_per_sec_per_chip" + tag, crater),
           # knob keys are emitted unconditionally, as bench.py does
           "pre_nms_topk": topk, "batch": batch, "nscan": nscan}
    if with_coco:
        coco = measure(3, 80, batch, topk, nscan, int8, dev, windows)
        row["coco_shaped"] = _row("coco", "yolo11n_coco640_infer_images_per_sec_per_chip" + tag,
                                  coco)
    row["device"] = C.device_block(dev)
    return C.emit(row)


if __name__ == "__main__":
    main()
