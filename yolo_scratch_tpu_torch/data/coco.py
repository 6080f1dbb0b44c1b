"""COCO-format dataset reader (stdlib json; no pycocotools dependency), a
copy of ``yolo_scratch_tpu/data/coco.py``: the same samples, contiguous
class ids and stretch/letterbox geometry.

Supports the COCO128-style layout used by BASELINE.json's configs: an
``instances*.json`` annotation file plus an image directory. Returns the
same sample format as :class:`CraterDataset` (normalized cx-cy-w-h boxes),
so the loader/augment/train stack is dataset-agnostic.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np


def _imread_rgb(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1]  # BGR -> RGB
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


class CocoDataset:
    """``__getitem__`` -> (img (S, S, 3) float32 [0,1] stretch-resized,
    boxes (n, 4) normalized cx-cy-w-h, labels (n,) int32 contiguous ids)."""

    def __init__(self, ann_file: str, img_dir: str, img_size: int = 640,
                 letterbox: bool = False):
        self.img_dir = Path(img_dir)
        self.img_size = img_size
        self.letterbox = letterbox

        with open(ann_file) as fh:
            coco = json.load(fh)
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_to_contig = {c: i for i, c in enumerate(cat_ids)}
        self.class_names = [
            c["name"] for c in sorted(coco.get("categories", []), key=lambda c: c["id"])
        ]

        images = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict[int, List] = {i: [] for i in images}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["image_id"] in anns_by_img:
                anns_by_img[a["image_id"]].append(a)

        self.samples = []
        for img_id, im in sorted(images.items()):
            path = self.img_dir / im["file_name"]
            if not path.exists():
                continue
            self.samples.append(
                {
                    "path": str(path),
                    "w": im["width"],
                    "h": im["height"],
                    "anns": anns_by_img.get(img_id, []),
                }
            )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        img = _imread_rgb(s["path"])
        h0, w0 = img.shape[:2]

        boxes, labels = [], []
        for a in s["anns"]:
            x, y, w, h = a["bbox"]  # COCO xywh, top-left origin, pixels
            cx, cy = (x + w / 2) / w0, (y + h / 2) / h0
            bw, bh = w / w0, h / h0
            if bw <= 0 or bh <= 0:
                continue
            boxes.append([min(max(cx, 0.0), 1.0), min(max(cy, 0.0), 1.0),
                          min(bw, 1.0), min(bh, 1.0)])
            labels.append(self.cat_to_contig[a["category_id"]])

        S = self.img_size
        if self.letterbox:
            r = min(S / w0, S / h0)
            nw, nh = int(round(w0 * r)), int(round(h0 * r))
            px, py = (S - nw) // 2, (S - nh) // 2
            try:
                import cv2

                resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
            except ImportError:
                from PIL import Image

                resized = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
            canvas = np.full((S, S, 3), 114, np.uint8)
            canvas[py : py + nh, px : px + nw] = resized
            img = canvas
            out = []
            for (cx, cy, bw, bh) in boxes:
                out.append(
                    [
                        (cx * w0 * r + px) / S,
                        (cy * h0 * r + py) / S,
                        bw * w0 * r / S,
                        bh * h0 * r / S,
                    ]
                )
            boxes = out
        else:
            try:
                import cv2

                img = cv2.resize(img, (S, S), interpolation=cv2.INTER_LINEAR)
            except ImportError:
                from PIL import Image

                img = np.asarray(Image.fromarray(img).resize((S, S), Image.BILINEAR))

        return (
            img.astype(np.float32) / 255.0,
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
        )
