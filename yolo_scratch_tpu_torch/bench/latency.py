"""Single-image (B=1) deploy latency (port of ``scripts/bench_latency.py``).

    python -m yolo_scratch_tpu_torch.bench.latency [--scale n] [--iters 100] [--launches 50]

The deploy contract at B=1: uint8 in -> /255 and the BN-folded bf16
forward -> fused select-then-decode -> kernel #1 (at B=1 too) -> detections.

1. ``device_latency_ms``: ``--iters`` single-image pipelines on distinct
   images, back to back, then one sync and fetch; the best of 3 windows
   over ``--iters``.
2. ``launch_p50_ms`` / ``launch_p99_ms``: ``--launches`` single calls, each
   timed on the host clock up to its own sync and fetch (0 skips part 2).

Prints one JSON line (part 1's windows under ``windows_ms``), with the
device it ran on.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.bench.headline import deploy_program
from yolo_scratch_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="B=1 deploy latency (scripts/bench_latency.py)")
    ap.add_argument("--scale", default="n")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--iters", type=int, default=100,
                    help="single-image pipelines a window for the device latency")
    ap.add_argument("--launches", type=int, default=50,
                    help="single synced calls for the host-visible distribution; 0 skips part 2")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img, ch, nc = args.imgsz, 1, 5

    model = C.deploy_model(ch, nc, args.scale, img, device=dev)
    _, program = deploy_program(model, 1, 512, dev, img=img)
    xs = C.uint8_batches((args.iters, 1, img, img, ch), dev)

    with C.kernel1_launches() as k1:
        secs, out = C.timed_windows(lambda: program(xs), dev)
        laps = []
        if args.launches > 0:
            x1 = xs[:1]
            for _ in range(2):
                C.fetch(program(x1), dev)
            for _ in range(args.launches):
                t0 = time.perf_counter()
                C.fetch(program(x1), dev)
                laps.append((time.perf_counter() - t0) * 1e3)
    per_ms = [s / args.iters * 1e3 for s in secs]
    result = {"scale": args.scale, "imgsz": img,
              "device_latency_ms": round(min(per_ms), 3),
              "median_ms": statistics.median(per_ms), "windows_ms": per_ms}
    if laps:
        result.update({"launch_p50_ms": round(float(np.percentile(laps, 50)), 3),
                       "launch_p99_ms": round(float(np.percentile(laps, 99)), 3)})
    result.update({"nms_launches": k1["launches"], "valid_per_image": C.valid_per_image(out),
                   "device": C.device_block(dev)})
    return C.emit(result)


if __name__ == "__main__":
    main()
