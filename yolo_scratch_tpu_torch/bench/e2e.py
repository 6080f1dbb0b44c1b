"""Disk files -> detections: streaming throughput of ``predict_paths`` (port
of ``scripts/bench_e2e.py``).

    python -m yolo_scratch_tpu_torch.bench.e2e [--n 256] [--src 1024] [--imgsz 640] \
        [--batch 32] [--scale n] [--ckpt DIR] [--inflight 1,3] [--out FILE]

What a user gets from a directory of encoded images through
``Predictor.predict_paths``: host decode + letterbox, the batch to the
device, the fused forward + decode + kernel #1, the fetch. It sweeps format
(PNG, JPEG) x ``fast_jpeg`` (JPEG decode-time downscale, native tier only)
x the in-flight depth, on smooth synthetic grayscale images. Host and card
are both timed, so run it on a quiet machine.

``host_tier`` says which host prep ran (``host.py``): ``native`` (the
port's own ``csrc/yst_host.cpp`` and codecs, which build wherever g++ does)
or ``cv2`` where that library does not build (no compiler). Each arm warms
up on one batch, then streams all ``--n`` files once (one window).

Prints one JSON line with ``rows`` (``fmt``, ``fast_jpeg``, ``inflight``,
``img_per_s``, ``wall_s``), as the JAX script's result, plus ``device``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.data import native
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig, load_deploy_model
from yolo_scratch_tpu_torch.utils.device import resolve_device


def make_images(d: Path, n: int, size: int, fmt: str) -> list:
    """``n`` smooth synthetic grayscale images of ``size``² as ``fmt`` files."""
    from PIL import Image

    paths = []
    y, x = np.mgrid[0:size, 0:size]
    for i in range(n):
        arr = ((np.sin(x / (40.0 + i % 7)) + np.cos(y / (31.0 + i % 5))) * 60
               + 128).clip(0, 255).astype(np.uint8)
        p = d / f"img_{i}.{fmt}"
        Image.fromarray(arr, "L").save(p)
        paths.append(str(p))
    return paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Disk -> detections throughput "
                                             "(scripts/bench_e2e.py)")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--src", type=int, default=1024)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--scale", type=str, default="n")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint dir of the port's trainer (its best); default: seeded init")
    ap.add_argument("--inflight", type=str, default=None,
                    help="in-flight depths to sweep, comma-separated (PredictorConfig.inflight)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = load_deploy_model(scale=args.scale, ckpt=args.ckpt, device=dev)
    depths = [None] if args.inflight is None else [int(s) for s in args.inflight.split(",")]
    tier = "native" if native.available() else "cv2"
    rows = []
    with C.kernel1_launches() as k1, tempfile.TemporaryDirectory() as td:
        for fmt in ("png", "jpeg"):
            paths = make_images(Path(td), args.n, args.src, fmt)
            for fast in ((False, True) if fmt == "jpeg" else (False,)):
                for depth in depths:
                    kw = {} if depth is None else {"inflight": depth}
                    pred = Predictor(model, PredictorConfig(
                        img_size=args.imgsz, batch_size=args.batch, conf_threshold=0.25,
                        fast_jpeg=fast, **kw), device=dev)
                    for _ in pred.predict_paths(paths[: args.batch]):  # warm-up
                        pass
                    t0 = time.perf_counter()
                    n_out = sum(1 for _ in pred.predict_paths(paths))
                    dt = time.perf_counter() - t0
                    if n_out != args.n:
                        raise RuntimeError(f"{n_out} results for {args.n} files")
                    rows.append({"fmt": fmt, "fast_jpeg": fast, "inflight": depth,
                                 "img_per_s": round(args.n / dt, 1), "wall_s": round(dt, 2)})
    result = {"n": args.n, "src": args.src, "imgsz": args.imgsz, "batch": args.batch,
              "scale": args.scale, "host_tier": tier,
              "note": "disk->detections via Predictor.predict_paths; smooth synthetic imagery",
              "rows": rows, "nms_launches": k1["launches"], "device": C.device_block(dev)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return C.emit(result)


if __name__ == "__main__":
    main()
