"""Host batch loader: dataset -> fixed-shape padded batches, prefetched
(a copy of ``yolo_scratch_tpu/data/loader.py``, plus :meth:`Loader.close`).

Replaces the reference's torch DataLoader stack (worker processes,
pin_memory, prefetch_factor — ``train_yolo11_cuda.py:509-543``) with a
double-buffered background-thread pipeline feeding fixed-shape numpy
batches. Device placement happens in the caller (``train/steps.py``), so
the loader stays framework-free and testable.

``workers=N`` decodes a batch's samples concurrently on a thread pool —
the analog of the reference's ``num_workers`` DataLoader processes. Threads
(not processes) suffice here because the per-sample hot path releases the
GIL: the native decoder (``data/native.py``, a ctypes foreign call) and
cv2's resize both drop it, so N threads drive N cores of decode. Unlike a
whole-batch handoff to the native ``prepare_batch`` pool (used by the
*infer* path), per-item threading keeps batches **bit-exact** vs the serial
path — it runs the identical ``dataset[i]`` code per sample, so cache
semantics, cv2-exact resize, and annotation math are untouched.

Boxes leave the loader as normalized **xyxy** (the reference collate's
convert+clamp, ``datasets/crater_dataset_cuda.py:311-324``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from yolo_scratch_tpu_torch.data.batch import pad_targets


def _xywh2xyxy_np(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[..., 0] = b[..., 0] - b[..., 2] / 2
    out[..., 1] = b[..., 1] - b[..., 3] / 2
    out[..., 2] = b[..., 0] + b[..., 2] / 2
    out[..., 3] = b[..., 1] + b[..., 3] / 2
    return np.clip(out, 0.0, 1.0)  # reference collate clamp (:319-322)


class Loader:
    """Iterates fixed-shape batches over a map-style dataset.

    Batch dict: img (B,H,W,C) f32, gt_labels (B,G) i32,
    gt_bboxes (B,G,4) f32 xyxy-normalized, gt_mask (B,G) bool,
    sample_valid (B,) bool.
    The final short batch is padded by wrapping (drop_last=False semantics
    with static shapes); ``sample_valid`` is False on the wrap-padding
    duplicates so eval paths score each image exactly once (the reference
    evaluates every val image once, ``train_yolo11_cuda.py:101-262``).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        max_gt: int = 100,
        shuffle: bool = False,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
        prefetch: int = 2,
        multiscale_sizes: Optional[Sequence[int]] = None,
        multiscale_interval: int = 10,
        workers: int = 0,
    ):
        """``multiscale_sizes``: optional bucket list (e.g. [480, 576, 640,
        736]); every ``multiscale_interval`` batches a new bucket is drawn
        (seeded) and the batch is resized to it on the host. Shapes stay
        static per bucket, so jit compiles once per size (YOLO-style
        multi-scale training with XLA-friendly bucketing). Boxes are
        normalized and unaffected."""
        self.ds = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.seed = seed
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.prefetch = prefetch
        self.epoch = 0
        self.multiscale_sizes = list(multiscale_sizes) if multiscale_sizes else None
        self.multiscale_interval = max(multiscale_interval, 1)
        # workers<=1 -> serial in-thread decode (the round-4 behavior);
        # workers>1 -> per-sample thread pool (see module docstring).
        self.workers = max(int(workers), 0)
        self._pool: Optional[ThreadPoolExecutor] = None

    def _sample_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="yst-loader"
            )
        return self._pool

    def close(self) -> None:
        """Shut the per-sample thread pool down (``workers > 1``). The
        loader stays usable: the next batch starts a new pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __len__(self) -> int:
        return int(np.ceil(len(self.indices) / self.batch_size))

    def _batch_size_for(self, batch_index: int) -> Optional[int]:
        if not self.multiscale_sizes:
            return None
        bucket = batch_index // self.multiscale_interval
        rng = np.random.RandomState(self.seed * 7919 + self.epoch * 131 + bucket)
        return int(rng.choice(self.multiscale_sizes))

    @staticmethod
    def _resize_imgs(imgs: np.ndarray, size: int) -> np.ndarray:
        if imgs.shape[1] == size:
            return imgs
        try:
            import cv2

            out = np.empty((imgs.shape[0], size, size, imgs.shape[3]), np.float32)
            for i in range(imgs.shape[0]):
                r = cv2.resize(imgs[i], (size, size), interpolation=cv2.INTER_LINEAR)
                out[i] = r.reshape(size, size, imgs.shape[3])
            return out
        except ImportError:
            from PIL import Image

            out = np.empty((imgs.shape[0], size, size, imgs.shape[3]), np.float32)
            for i in range(imgs.shape[0]):
                for c in range(imgs.shape[3]):
                    out[i, ..., c] = np.asarray(
                        Image.fromarray((imgs[i, ..., c] * 255).astype(np.uint8)).resize(
                            (size, size), Image.BILINEAR
                        ),
                        np.float32,
                    ) / 255.0
            return out

    def _make_batch(
        self, idxs: np.ndarray, batch_index: int = 0, valid: Optional[np.ndarray] = None
    ) -> Dict[str, np.ndarray]:
        imgs, boxes_list, labels_list = [], [], []
        if self.workers > 1:
            # executor.map preserves input order, so the batch layout is
            # identical to the serial loop below (bit-exactness contract).
            items = list(self._sample_pool().map(self.ds.__getitem__, [int(i) for i in idxs]))
        else:
            items = [self.ds[int(i)] for i in idxs]
        for img, boxes, labels in items:
            imgs.append(img)
            boxes_list.append(_xywh2xyxy_np(boxes) if len(boxes) else boxes.reshape(0, 4))
            labels_list.append(labels)
        gl, gb, gm = pad_targets(boxes_list, labels_list, self.max_gt)
        batch_imgs = np.stack(imgs).astype(np.float32)
        size = self._batch_size_for(batch_index)
        if size is not None:
            batch_imgs = self._resize_imgs(batch_imgs, size)
        return {
            "img": batch_imgs,
            "gt_labels": gl,
            "gt_bboxes": gb,
            "gt_mask": gm,
            "sample_valid": (
                valid.copy() if valid is not None else np.ones(len(idxs), dtype=bool)
            ),
        }

    def _epoch_indices(self) -> "tuple[np.ndarray, np.ndarray]":
        """Epoch index order plus a per-position validity flag (False on the
        wrap-padding duplicates of the final short batch). The padding cycles
        through the order, so a split shorter than the padding (6 images at
        B=16) still fills its batch; the JAX loader's ``idxs[:pad]`` (the
        same indices wherever it works) raises there."""
        idxs = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idxs)
        n = len(idxs)
        B = self.batch_size
        pad = (-n) % B
        valid = np.ones(n + pad, dtype=bool)
        if pad:
            idxs = np.concatenate([idxs, np.resize(idxs, pad)])
            valid[n:] = False
        return idxs, valid

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs, valid = self._epoch_indices()
        self.epoch += 1
        chunks = idxs.reshape(-1, self.batch_size)
        valid_chunks = valid.reshape(-1, self.batch_size)

        if self.prefetch <= 0:
            for bi, chunk in enumerate(chunks):
                yield self._make_batch(chunk, bi, valid_chunks[bi])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        stop = threading.Event()

        def worker():
            try:
                for bi, chunk in enumerate(chunks):
                    if stop.is_set():
                        return
                    q.put(self._make_batch(chunk, bi, valid_chunks[bi]))
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                yield item
        finally:
            # a consumer that stops early (``break``) closes this generator:
            # end the prefetch thread before the pool it may be using goes
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
