"""Synthetic crater-like dataset — deterministic, dependency-free (a copy of
``yolo_scratch_tpu/data/synthetic.py``: the same ``np.random.RandomState``
draws, so the same images bit for bit).

Used by the test suite and smoke benchmarks: images contain dark filled
disks on a textured background; boxes are their exact bounds. A model that
learns anything will overfit a handful of these quickly, which gives a
self-contained end-to-end training signal without real data.
"""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    def __init__(self, n: int = 32, img_size: int = 160, channels: int = 1,
                 num_classes: int = 5, max_objects: int = 4, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.channels = channels
        self.num_classes = num_classes
        self.max_objects = max_objects
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        S = self.img_size
        img = rng.rand(S, S).astype(np.float32) * 0.15 + 0.55
        n_obj = rng.randint(1, self.max_objects + 1)
        yy, xx = np.mgrid[0:S, 0:S]
        boxes, labels = [], []
        for _ in range(n_obj):
            r = rng.randint(S // 16, S // 5)
            cx = rng.randint(r + 1, S - r - 1)
            cy = rng.randint(r + 1, S - r - 1)
            cls = rng.randint(0, self.num_classes)
            disk = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            img[disk] *= 0.25 + 0.1 * cls / max(self.num_classes - 1, 1)
            boxes.append([cx / S, cy / S, 2 * r / S, 2 * r / S])
            labels.append(cls)
        img = np.clip(img, 0, 1)[..., None]
        if self.channels == 3:
            img = np.repeat(img, 3, axis=-1)
        return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)
