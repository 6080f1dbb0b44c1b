"""Generate a synthetic crater dataset in the reference on-disk layout
(port of ``scripts/gen_crater_synth.py``: the same flags, and for a seed the
same PNG files and ``truth/detections.csv``, byte for byte).

Layout (reference ``datasets/crater_dataset_cuda.py:82-97``):
    <root>/altitude*/longitude*/<image>.png
    <root>/altitude*/longitude*/truth/detections.csv
CSV columns: inputImage, ellipseCenterX(px), ellipseCenterY(px),
ellipseSemimajor(px), ellipseSemiminor(px), crater_classification.

Craters are dark filled axis-aligned ellipses with a bright rim; per-class
brightness makes classification learnable. Images are written at exactly
``img_size`` (no resize interpolation). ``data/crater.py::CraterDataset``
reads the tree. Host only (numpy and cv2).

    python -m yolo_scratch_tpu_torch.gen_crater_synth --out DIR --n 150 --img-size 320
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def draw_crater(img: np.ndarray, cx: float, cy: float, a: float, b: float, cls: int) -> None:
    """Dark ellipse interior + bright rim; class shifts interior brightness."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2
    interior = r2 <= 1.0
    rim = (r2 > 1.0) & (r2 <= 1.45)
    # class-dependent floor brightness: 0 -> darkest ... 4 -> lightest
    floor = 0.10 + 0.12 * cls
    img[interior] = img[interior] * 0.25 + floor
    img[rim] = np.minimum(img[rim] * 1.35 + 0.15, 1.0)


def make_image(rng: np.random.RandomState, size: int, n_craters: int, num_classes: int = 5):
    img = rng.rand(size, size).astype(np.float32) * 0.18 + 0.45
    # mild low-frequency texture
    coarse = rng.rand(size // 16, size // 16).astype(np.float32)
    texture = np.kron(coarse, np.ones((16, 16), np.float32))
    img = 0.8 * img + 0.2 * texture[:size, :size]
    rows = []
    for _ in range(n_craters):
        a = rng.uniform(size * 0.04, size * 0.13)  # semimajor
        b = rng.uniform(0.6 * a, a)  # semiminor
        cx = rng.uniform(a + 2, size - a - 2)
        cy = rng.uniform(b + 2, size - b - 2)
        cls = int(rng.randint(0, num_classes))
        draw_crater(img, cx, cy, a, b, cls)
        rows.append((cx, cy, a, b, cls))
    return np.clip(img, 0.0, 1.0), rows


def generate(out: str, n: int, img_size: int, seed: int = 0,
             sites: int = 3, max_craters: int = 5) -> int:
    """Write ``n`` images over ``sites`` site directories; returns ``n``."""
    if cv2 is None:
        raise RuntimeError("cv2 required to write PNGs for the reference layout")
    rng = np.random.RandomState(seed)
    per_site = (n + sites - 1) // sites
    written = 0
    for s in range(sites):
        site_dir = os.path.join(out, f"altitude{10 + 10 * s}", "longitude5")
        os.makedirs(os.path.join(site_dir, "truth"), exist_ok=True)
        csv_rows = []
        for i in range(per_site):
            if written >= n:
                break
            name = f"img{i:04d}.png"
            img, craters = make_image(rng, img_size, int(rng.randint(1, max_craters + 1)))
            cv2.imwrite(os.path.join(site_dir, name), (img * 255.0 + 0.5).astype(np.uint8))
            for (cx, cy, a, b, cls) in craters:
                csv_rows.append({
                    "inputImage": name,
                    "ellipseCenterX(px)": f"{cx:.3f}",
                    "ellipseCenterY(px)": f"{cy:.3f}",
                    "ellipseSemimajor(px)": f"{a:.3f}",
                    "ellipseSemiminor(px)": f"{b:.3f}",
                    "crater_classification": cls,
                })
            written += 1
        with open(os.path.join(site_dir, "truth", "detections.csv"), "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(csv_rows[0].keys()))
            w.writeheader()
            w.writerows(csv_rows)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="synthetic crater tree (reference layout)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = generate(args.out, args.n, args.img_size, args.seed)
    print(f"wrote {n} images under {args.out}")
    return n


if __name__ == "__main__":
    main()
