"""Lunar-crater dataset: CSV ellipse annotations -> normalized boxes (a
copy of ``yolo_scratch_tpu/data/crater.py``: the same samples, classes,
clamps and stretch geometry).

Parity target: reference ``datasets/crater_dataset_cuda.py``:
  * walks ``altitude*/longitude*/truth/detections.csv`` (``:82-84``),
  * groups rows by ``inputImage`` (``:94``), skips missing files (``:97``),
  * class from ``crater_classification`` with NaN/-1 -> 2 ("B") (``:104-108``),
  * box = (center, 2*semimajor, 2*semiminor) in original pixels (``:110-116``),
  * normalizes by ORIGINAL size, clamps cx,cy to [0,1] and w,h to
    [0.01, 1] (``:262-275``),
  * grayscale decode + stretch-resize to (img_size, img_size) (``:169-184``,
    aspect NOT preserved — reference semantics).

The FIFO image buffer + gc machinery (``:192-215``) exists only to fight
Python RAM pressure in Colab; here an optional plain LRU cache serves the
same purpose without per-item gc calls.
"""

from __future__ import annotations

import csv
import glob
import math
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

CLASS_MAP = {"A": 0, "AB": 1, "B": 2, "BC": 3, "C": 4}  # reference ``:61``


def _imread_gray(path: str) -> np.ndarray:
    from yolo_scratch_tpu_torch.data import native

    if native.available():
        try:
            return native.decode_file(path, channels=1)[..., 0]
        except IOError:
            pass  # fall through to cv2/PIL for exotic formats
    try:
        import cv2

        img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:  # cv2-free fallback
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def _resize_stretch(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == img.shape[1] == size:
        return img
    try:
        import cv2

        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))


class CraterDataset:
    """Lazy-loading crater dataset. ``__getitem__`` returns
    (img (H, W, 1) float32 in [0,1], boxes (n, 4) normalized cx-cy-w-h,
    labels (n,) int32)."""

    def __init__(self, data_dir: str, img_size: int = 640, cache_size: int = 50):
        self.data_dir = Path(data_dir)
        self.img_size = img_size
        self.samples = self._load_annotations()
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        # Loader(workers=N) fetches samples from a thread pool; the LRU's
        # OrderedDict mutations need a lock (decode itself runs unlocked).
        self._cache_lock = threading.Lock()

    def _load_annotations(self) -> List[Dict]:
        samples = []
        for csv_path in sorted(
            glob.glob(str(self.data_dir / "altitude*/longitude*/truth/detections.csv"))
        ):
            parent = Path(csv_path).parent.parent
            by_image: Dict[str, List[Dict]] = {}
            with open(csv_path, newline="") as fh:
                for row in csv.DictReader(fh):
                    by_image.setdefault(row["inputImage"], []).append(row)
            for img_name, rows in by_image.items():
                img_path = parent / img_name
                if not img_path.exists():
                    continue
                anns = []
                for row in rows:
                    raw_cls = row.get("crater_classification", "")
                    try:
                        cls = int(float(raw_cls))
                        if cls == -1 or math.isnan(float(raw_cls)):
                            cls = 2
                    except (TypeError, ValueError):
                        cls = 2  # reference default "B" (:104-108)
                    anns.append(
                        {
                            "cx": float(row["ellipseCenterX(px)"]),
                            "cy": float(row["ellipseCenterY(px)"]),
                            "w": 2.0 * float(row["ellipseSemimajor(px)"]),
                            "h": 2.0 * float(row["ellipseSemiminor(px)"]),
                            "cls": cls,
                        }
                    )
                if anns:
                    samples.append({"img_path": str(img_path), "annotations": anns})
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def _load_image(self, idx: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        with self._cache_lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
        raw = _imread_gray(self.samples[idx]["img_path"])
        hw0 = raw.shape[:2]
        img = _resize_stretch(raw, self.img_size)
        if self._cache_size > 0:
            with self._cache_lock:
                self._cache[idx] = (img, hw0)
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        return img, hw0

    def __getitem__(self, idx: int):
        sample = self.samples[idx]
        img, (h0, w0) = self._load_image(idx)
        img = (img.astype(np.float32) / 255.0)[..., None]  # (H, W, 1)

        boxes, labels = [], []
        for ann in sample["annotations"]:
            cx = min(max(ann["cx"] / w0, 0.0), 1.0)
            cy = min(max(ann["cy"] / h0, 0.0), 1.0)
            w = min(max(ann["w"] / w0, 0.01), 1.0)
            h = min(max(ann["h"] / h0, 0.01), 1.0)
            boxes.append([cx, cy, w, h])
            labels.append(ann["cls"])
        return (
            img,
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
        )
