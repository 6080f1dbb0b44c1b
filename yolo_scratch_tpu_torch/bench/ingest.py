"""Host ingest: decode -> resize -> batch throughput of each host-prep tier
(port of ``scripts/bench_ingest.py``).

    python -m yolo_scratch_tpu_torch.bench.ingest [n_images] [src_size]   # 64 1024
    python -m yolo_scratch_tpu_torch.bench.ingest loader [n] [src] [dst]  # Loader vs workers

Host decode bounds streaming inference, so this measures it on its own:
img/s for synthetic grayscale PNGs and JPEGs (``noise``, the codecs' worst
case, and ``smooth``) resized to ``dst_size`` (stretch, as the JAX script),
best of 3, for each tier that runs here:

* ``native`` (``data/native.py``; the port's ``csrc/yst_host.cpp`` with
  its own PNG and JPEG decoders): uint8 and
  float32 batches, and for JPEGs the decode-time downscale (``_fastscale``);
  keys ``{content}_{fmt}_{dtype}[_fastscale]_img_per_s`` as the JAX
  script's;
* ``cv2`` (``host.py::prepare_images_cv2``, the tier a machine without a
  compiler takes): float32 only, keys prefixed ``cv2_``.

``loader`` times a ``Loader`` epoch (decode + resize + collate, cache off)
over a crater-layout tree per worker count. The work is the host's alone:
the line names the card it feeds (``device``, default ``cuda``, which
raises without one; ``--device cpu`` for a machine without) and the host's
CPU (``host``).
"""

from __future__ import annotations

import argparse
import csv
import os
import platform
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.data import native
from yolo_scratch_tpu_torch.host import PredictorConfig, prepare_images_cv2
from yolo_scratch_tpu_torch.utils.device import resolve_device


def host_block() -> dict:
    return {"cpu": platform.processor() or platform.machine(), "cores": os.cpu_count()}


def make_images(d: Path, n: int, size: int, fmt: str = "png", content: str = "noise") -> list:
    """``noise``: uniform random pixels; ``smooth``: a banded gradient
    closer to natural imagery."""
    from PIL import Image

    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        if content == "noise":
            arr = rng.randint(0, 256, (size, size), np.uint8)
        else:
            y, x = np.mgrid[0:size, 0:size]
            arr = ((np.sin(x / (40.0 + i)) + np.cos(y / (31.0 + i))) * 60 + 128
                   ).clip(0, 255).astype(np.uint8)
        p = d / f"img_{i}.{fmt}"
        Image.fromarray(arr, "L").save(p)
        paths.append(str(p))
    return paths


def best_rate(fn, n: int, repeats: int) -> float:
    """img/s of the fastest of ``repeats`` calls of ``fn`` (after one on two
    images' worth of warm-up, done by the caller)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return round(n / best, 1)


def main(n: int = 64, src: int = 1024, S: int = 640, repeats: int = 3,
         device: torch.device = torch.device("cpu")) -> dict:
    tiers = (["native"] if native.available() else []) + ["cv2"]
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for content in ("noise", "smooth"):
            for fmt in ("png", "jpeg"):
                paths = make_images(Path(td), n, src, fmt, content)
                if "native" in tiers:
                    variants = [("uint8", False), ("float32", False)]
                    if fmt == "jpeg":  # decode-time downscale applies to JPEG only
                        variants.insert(0, ("uint8", True))
                    for dtype, fast in variants:
                        def prep(p=paths, dtype=dtype, fast=fast):
                            _, _, status = native.prepare_batch(
                                p, img_size=S, channels=1, letterbox=False, dtype=dtype,
                                fast_jpeg=fast)
                            if (status != 0).any():
                                raise IOError("native decode failed")

                        prep(paths[:2])
                        key = f"{content}_{fmt}_{dtype}" + ("_fastscale" if fast else "")
                        out[f"{key}_img_per_s"] = best_rate(prep, n, repeats)
                cfg = PredictorConfig(img_size=S, letterbox=False)
                prepare_images_cv2(paths[:2], cfg, 1)
                out[f"cv2_{content}_{fmt}_float32_img_per_s"] = best_rate(
                    lambda p=paths: prepare_images_cv2(p, cfg, 1), n, repeats)
    out.update({"n": n, "src_size": src, "dst_size": S, "tiers": tiers,
                "note": "host decode + resize, 4 threads (native), 1 thread (cv2)",
                "host": host_block(), "device": C.device_block(device)})
    return C.emit(out)


def loader_scaling(n: int = 64, src: int = 1024, S: int = 640, workers=(0, 2, 4, 8),
                   repeats: int = 3, device: torch.device = torch.device("cpu")) -> dict:
    """img/s of a ``Loader`` epoch (decode + resize + pad/collate) over a
    crater-layout tree of smooth PNGs, cache off, per worker count."""
    from yolo_scratch_tpu_torch.data.crater import CraterDataset
    from yolo_scratch_tpu_torch.data.loader import Loader

    out = {}
    with tempfile.TemporaryDirectory() as td:
        site = Path(td) / "altitude10" / "longitude5"
        (site / "truth").mkdir(parents=True)
        paths = make_images(site, n, src, "png", "smooth")
        rows = [{"inputImage": Path(p).name,
                 "ellipseCenterX(px)": src / 2, "ellipseCenterY(px)": src / 2,
                 "ellipseSemimajor(px)": 20, "ellipseSemiminor(px)": 15,
                 "crater_classification": 1} for p in paths]
        with open(site / "truth" / "detections.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        ds = CraterDataset(str(td), img_size=S, cache_size=0)  # decode every epoch
        for nw in workers:
            loader = Loader(ds, batch_size=8, max_gt=4, prefetch=0, workers=nw)
            list(loader)  # warm-up: page cache, pool spin-up
            out[f"workers_{nw}_img_per_s"] = best_rate(lambda: list(loader), len(ds), repeats)
    out.update({"n": n, "src_size": src, "dst_size": S, "host": host_block(),
                "device": C.device_block(device)})
    return C.emit(out)


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Host ingest throughput (scripts/bench_ingest.py)")
    ap.add_argument("sizes", nargs="*", help="[loader] n_images src_size [dst_size]")
    ap.add_argument("--device", type=str, default=None, help="the card fed; default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.sizes and args.sizes[0] == "loader":
        return loader_scaling(*(int(a) for a in args.sizes[1:4]), device=dev)
    return main(*(int(a) for a in args.sizes[:2]), device=dev)


if __name__ == "__main__":
    cli()
