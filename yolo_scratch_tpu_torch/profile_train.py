"""Trace the train step with ``torch.profiler`` (port of
``scripts/profile_train.py``, with its flags and its synthetic batch).

The crater YOLO11n (ch=1, nc=5), seeded init, the AdamW 1e-3 + EMA state,
and ``train/steps.py::build_train_step_custom`` with the v8 loss, bf16
(autocast; f32 master weights) unless the step is built otherwise, and
``--remat`` / ``--grad-accum``. The batch is the JAX script's, drawn from
``RandomState(0)`` in its order: images (B, S, S, 1) in [0, 1), G=24
labels, boxes and mask (the first box draw is overwritten by the pixel
boxes drawn after it, as in the JAX script, but still consumes draws). The
port's models take NHWC batches, as the JAX package's do. The batch is put
on the device once: the steps time the step, not the copy.

Prints the first step's loss; ``train step: N ms (img/s)`` over ``--iters``
steps back to back ending in one sync; with ``--scan K``, K more steps
launched back to back with one sync at the end (the counterpart of the JAX
script's in-jit ``lax.scan``: no host sync between steps). Unless
``--no-trace``, ``--iters`` steps under ``torch.profiler`` (CPU and CUDA,
``record_shapes``), one ``record_function("train_step")`` range a step, to
``yst_trace_train`` in the temporary directory, which ``train_roofline``
and ``parse_trace`` read. The last line is JSON with a ``device`` block.

    python -m yolo_scratch_tpu_torch.profile_train [--batch 64] [--imgsz 640] [--scan 5]
        [--remat] [--grad-accum K] [--no-trace] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from yolo_scratch_tpu_torch.bench.common import device_block, sync
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import (
    batch_to_device,
    build_train_step_custom,
    v8_loss_adapter,
)
from yolo_scratch_tpu_torch.utils.device import resolve_device
from yolo_scratch_tpu_torch.utils.profiling import export_trace, trace_dir

G = 24  # ground-truth slots an image


def synthetic_batch(B: int, img: int, ch: int = 1, nc: int = 5, seed: int = 0) -> dict:
    """The JAX script's batch, drawn in its order (numpy, NHWC)."""
    rng = np.random.RandomState(seed)
    batch = {
        "img": rng.rand(B, img, img, ch).astype(np.float32),
        "gt_labels": rng.randint(0, nc, (B, G)).astype(np.int32),
        "gt_bboxes": np.abs(rng.rand(B, G, 4).astype(np.float32)) * 0.4 + 0.1,
        "gt_mask": (rng.rand(B, G) > 0.5),
    }
    # xywh-ish sane boxes in pixels
    cx = rng.rand(B, G) * img
    cy = rng.rand(B, G) * img
    w = rng.rand(B, G) * 100 + 8
    h = rng.rand(B, G) * 100 + 8
    batch["gt_bboxes"] = np.stack(
        [np.clip(cx - w / 2, 0, img), np.clip(cy - h / 2, 0, img),
         np.clip(cx + w / 2, 0, img), np.clip(cy + h / 2, 0, img)], -1
    ).astype(np.float32)
    return batch


def build(model, bf16: bool = True, remat: bool = False, grad_accum: int = 1):
    """(the AdamW 1e-3 + EMA state of ``model``, its train step)."""
    state = create_train_state(model, make_optimizer(1e-3), use_ema=True)
    step = build_train_step_custom(
        model, v8_loss_adapter(DetectionLossConfig(nc=model.nc, strides=model.strides)),
        compute_dtype=torch.bfloat16 if bf16 else None, remat=remat, grad_accum=grad_accum)
    return state, step


def main(argv=None, out_dir=None) -> dict:
    """``out_dir``: the trace directory (default ``yst_trace_train`` under
    the temporary directory)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description="torch.profiler trace of the train step")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--scale", type=str, default="n")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--remat", action="store_true",
                    help="activation recompute (torch.utils.checkpoint) in backward")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--scan", type=int, default=0, metavar="K",
                    help="also time K train steps launched back to back, one sync at the end")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    img, B = args.imgsz, args.batch
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale=args.scale,
                         seed=0, device=dev)
    state, step = build(model, args.bf16, args.remat, args.grad_accum)
    batch = batch_to_device(synthetic_batch(B, img), dev)

    def sync_state():
        sync(dev)
        float(state.params[0].detach().flatten()[0])

    print("first step...", flush=True)
    _, m = step(state, batch)
    loss = float(m["loss"])
    print("loss:", loss, flush=True)
    result = dict(batch=B, imgsz=img, scale=args.scale, bf16=args.bf16, remat=args.remat,
                  grad_accum=args.grad_accum, loss=loss)

    sync_state()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step(state, batch)
    sync_state()
    dt = (time.perf_counter() - t0) / args.iters
    print(f"train step: {dt * 1e3:.1f} ms  ({B / dt:.1f} img/s)", flush=True)
    result.update(step_ms=dt * 1e3, imgs_per_sec=B / dt)

    if args.scan > 0:
        K = args.scan
        t0 = time.perf_counter()
        for _ in range(K):
            step(state, batch)
        sync_state()
        dt = (time.perf_counter() - t0) / K
        # images a step: B whatever grad_accum (the step splits the batch)
        print(f"train step (x{K} back to back, one sync): {dt * 1e3:.1f} ms  "
              f"({B / dt:.1f} img/s)", flush=True)
        result.update(scan=K, scan_step_ms=dt * 1e3, scan_imgs_per_sec=B / dt)

    if not args.no_trace:
        print("tracing...", flush=True)
        activities = ([ProfilerActivity.CPU]
                      + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        with profile(activities=activities, record_shapes=True) as prof:
            for _ in range(args.iters):
                with record_function("train_step"):
                    step(state, batch)
            sync_state()
            path = export_trace(prof, out_dir or trace_dir("yst_trace_train"), "profile_train",
                                yst_device=device_block(dev),
                                yst_run=dict(batch=B, imgsz=img, gt=G, iters=args.iters))
        print(f"trace written to {path}", flush=True)
        result["trace"] = str(path)
    result["device"] = device_block(dev)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
