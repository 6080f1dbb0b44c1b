"""Generate a synthetic COCO-format dataset of ``nc`` classes (port of
``scripts/gen_coco_synth.py``: the same flags and summary line, and for a
seed the same PNG files and ``annotations/instances.json``, byte for byte).

Images are coloured geometric shapes on textured backgrounds; class =
(shape kind x colour bucket), so classes are visually separable and a small
model can learn them. Written with PIL, else cv2. Host only.

Layout (COCO128-style, read by ``data/coco.py::CocoDataset``):
    <out>/images/*.png
    <out>/annotations/instances.json

    python -m yolo_scratch_tpu_torch.gen_coco_synth --out DIR [--n 120] [--img-size 320]
        [--nc 80] [--seed 0] [--max-obj 6]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

SHAPES = ("disk", "square", "triangle", "ring", "cross", "diamond", "hbar", "vbar")


def _draw(img: np.ndarray, kind: str, cx, cy, r, color):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx, dy = xx - cx, yy - cy
    if kind == "disk":
        m = dx * dx + dy * dy <= r * r
    elif kind == "square":
        m = (np.abs(dx) <= r) & (np.abs(dy) <= r)
    elif kind == "triangle":
        m = (dy >= -r) & (dy <= r) & (np.abs(dx) <= (r - dy) / 2 + 1)
    elif kind == "ring":
        d2 = dx * dx + dy * dy
        m = (d2 <= r * r) & (d2 >= (0.55 * r) ** 2)
    elif kind == "cross":
        m = ((np.abs(dx) <= r * 0.3) & (np.abs(dy) <= r)) | (
            (np.abs(dy) <= r * 0.3) & (np.abs(dx) <= r))
    elif kind == "diamond":
        m = np.abs(dx) + np.abs(dy) <= r
    elif kind == "hbar":
        m = (np.abs(dx) <= r) & (np.abs(dy) <= r * 0.35)
    else:  # vbar
        m = (np.abs(dy) <= r) & (np.abs(dx) <= r * 0.35)
    img[m] = color
    return m


def class_color(bucket: int, n_buckets: int, rng) -> np.ndarray:
    """Distinct hue per bucket, jittered per instance."""
    hue = bucket / n_buckets
    base = np.array([
        abs(hue * 6 - 3) - 1, 2 - abs(hue * 6 - 2), 2 - abs(hue * 6 - 4)
    ]).clip(0, 1)
    c = (base * 0.7 + 0.3) * 255
    return np.clip(c + rng.randn(3) * 10, 30, 255).astype(np.uint8)


def generate(out: str, n: int = 120, img_size: int = 320, nc: int = 80, seed: int = 0,
             max_obj: int = 6) -> dict:
    """Write the tree; returns the summary line's dict."""
    try:
        from PIL import Image
    except ImportError:
        import cv2  # fallback writer
        Image = None

    n_buckets = (nc + len(SHAPES) - 1) // len(SHAPES)
    rng = np.random.RandomState(seed)
    out = Path(out)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "annotations").mkdir(parents=True, exist_ok=True)

    S = img_size
    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        img = (rng.rand(S, S, 3) * 40 + rng.rand() * 120).astype(np.uint8)
        # low-frequency texture
        gx = np.linspace(0, rng.rand() * 6, S)
        img = np.clip(img + (np.sin(gx)[None, :, None] * 15), 0, 255).astype(np.uint8)

        n_obj = rng.randint(1, max_obj + 1)
        for _ in range(n_obj):
            cls = int(rng.randint(0, nc))
            kind = SHAPES[cls % len(SHAPES)]
            bucket = cls // len(SHAPES)
            r = float(rng.rand() * (S / 10) + S / 24)
            cx = float(rng.rand() * (S - 4 * r) + 2 * r)
            cy = float(rng.rand() * (S - 4 * r) + 2 * r)
            color = class_color(bucket, n_buckets, rng)
            _draw(img, kind, cx, cy, r, color)
            x1, y1 = max(cx - r, 0.0), max(cy - r, 0.0)
            bw = min(cx + r, S) - x1
            bh = min(cy + r, S) - y1
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": cls + 1,
                "bbox": [round(x1, 2), round(y1, 2), round(bw, 2), round(bh, 2)],
                "area": round(bw * bh, 2), "iscrowd": 0,
            })
            ann_id += 1

        fname = f"synth_{i:05d}.png"
        if Image is not None:
            Image.fromarray(img).save(out / "images" / fname)
        else:
            cv2.imwrite(str(out / "images" / fname), img[..., ::-1])
        images.append({"id": i, "file_name": fname, "width": S, "height": S})

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": c + 1, "name": f"{SHAPES[c % len(SHAPES)]}_{c // len(SHAPES)}"}
            for c in range(nc)
        ],
    }
    with open(out / "annotations" / "instances.json", "w") as fh:
        json.dump(coco, fh)
    return {"out": str(out), "images": len(images), "annotations": len(annotations), "nc": nc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="synthetic COCO-format tree")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("--nc", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-obj", type=int, default=6)
    args = ap.parse_args(argv)
    summary = generate(args.out, args.n, args.img_size, args.nc, args.seed, args.max_obj)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
