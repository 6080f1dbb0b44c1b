"""The host side of the deploy path, shared by the live Predictor
(``infer.py``) and the exported-artifact one (``export.py``): the config,
the packed output layout, image decode + letterbox, the unmapping of boxes
to original pixels, and the streaming loop. It imports no model code, so a
process that serves an artifact never builds a model.

Host prep takes the port's native library (``csrc/yst_host.cpp`` and its own
PNG/JPEG decoders, no codec library) where it builds, and cv2 where it does
not (no compiler): the JAX package's own two tiers, chosen by the same test
(``data/native.py::available``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch


@dataclass
class PredictorConfig:
    img_size: int = 640
    batch_size: int = 32
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_det: int = 300
    # Fixed-shape prefilter cap, the NMS sweep's length. A binding cap drops
    # the lowest-scoring real detections on dense scenes; raise it toward
    # 2048 when detections per image matter more than latency.
    pre_nms_topk: int = 512
    letterbox: bool = True
    bf16: bool = True
    fuse_bn: bool = True
    class_aware_nms: bool = False
    host_threads: int = 4
    u8_transfer: bool = True  # ship uint8 to the device; /255 runs there
    fast_jpeg: bool = True  # M/8 decode-time JPEG downscale, scaled IDCT (data/native.py)
    inflight: int = 3  # batches predict_paths keeps in flight
    nms_impl: str = "kernel"  # the CUDA sweep; "pairwise" or "tiled" for ops/nms.py
    # Two-stage blocked candidate selection (ops/decode.py::topk_scores),
    # YOLO11 only. Exact unless one 128-anchor block holds more than this
    # many of the top-k, which dense crater scenes do: opt in only where
    # that was checked. 0 = exact.
    blocked_topk: int = 0


def pack_detections(boxes, scores, labels, valid) -> torch.Tensor:
    """(B, max_det, 7) f32 rows [x1 y1 x2 y2 score label valid]."""
    return torch.cat([
        boxes.to(torch.float32),
        scores.to(torch.float32)[..., None],
        labels.to(torch.float32)[..., None],
        valid.to(torch.float32)[..., None],
    ], dim=-1)


def prepare_images(paths: Sequence[str], cfg: PredictorConfig, in_ch: int):
    """-> (imgs (B, S, S, C), meta (B, 5) [w0, h0, r, px, py]). The native
    tier gives uint8 (``u8_transfer``) or float32 in [0, 1]; the cv2 tier
    always float32 / 255, with ``r = 0`` for stretch. An undecodable file
    raises ``IOError``."""
    from yolo_scratch_tpu_torch.data import native

    S, ch = cfg.img_size, in_ch
    if native.available():
        imgs, meta, status = native.prepare_batch(
            paths, S, channels=ch, letterbox=cfg.letterbox, threads=cfg.host_threads,
            dtype="uint8" if cfg.u8_transfer else "float32", fast_jpeg=cfg.fast_jpeg)
        if (status != 0).any():
            raise IOError(f"decode failed: {[p for p, s in zip(paths, status) if s != 0]}")
        return imgs, meta
    return prepare_images_cv2(paths, cfg, in_ch)


def prepare_images_cv2(paths: Sequence[str], cfg: PredictorConfig, in_ch: int):
    """The cv2 tier of :func:`prepare_images`: float32 / 255 images."""
    import cv2

    S, ch = cfg.img_size, in_ch
    imgs = np.zeros((len(paths), S, S, ch), np.float32)
    meta = np.zeros((len(paths), 5), np.float32)
    flag = cv2.IMREAD_GRAYSCALE if ch == 1 else cv2.IMREAD_COLOR
    for i, p in enumerate(paths):
        im = cv2.imdecode(np.fromfile(p, np.uint8), flag)
        if im is None:
            raise IOError(p)
        if ch == 3:
            im = im[..., ::-1]
        h0, w0 = im.shape[:2]
        if cfg.letterbox:
            r = min(S / w0, S / h0)
            nw, nh = int(round(w0 * r)), int(round(h0 * r))
            px, py = (S - nw) // 2, (S - nh) // 2
            resized = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
            canvas = np.full((S, S, ch), 114, np.uint8)
            canvas[py: py + nh, px: px + nw] = resized.reshape(nh, nw, ch)
            imgs[i] = canvas.astype(np.float32) / 255
            meta[i] = [w0, h0, r, px, py]
        else:
            imgs[i] = (cv2.resize(im, (S, S), interpolation=cv2.INTER_LINEAR)
                       .reshape(S, S, ch).astype(np.float32) / 255)
            meta[i] = [w0, h0, 0.0, 0, 0]
    return imgs, meta


def unmap_boxes(boxes_norm: np.ndarray, meta_row: np.ndarray, img_size: int) -> np.ndarray:
    """Normalized model-space xyxy -> original-image pixel xyxy."""
    S = img_size
    w0, h0, r, px, py = meta_row
    b = boxes_norm * S
    if r > 0:  # letterboxed
        b[:, [0, 2]] = (b[:, [0, 2]] - px) / r
        b[:, [1, 3]] = (b[:, [1, 3]] - py) / r
    else:  # stretch
        b[:, [0, 2]] *= w0 / S
        b[:, [1, 3]] *= h0 / S
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, w0)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, h0)
    return b


def detections(packed_row: np.ndarray, meta_row: np.ndarray, img_size: int) -> Dict:
    """One image's (max_det, 7) packed row -> the response dict: original
    pixel boxes, scores and integer labels of the valid rows."""
    v = packed_row[:, 6] > 0.5
    return {
        "boxes": unmap_boxes(packed_row[v, :4], meta_row, img_size).tolist(),
        "scores": packed_row[v, 4].tolist(),
        "labels": packed_row[v, 5].astype(np.int64).tolist(),
    }


class HostPredictor:
    """Host prep and streaming over a subclass's ``predict_batch`` (image
    batch -> (B, max_det, 7) packed detections on the device, returned
    without a sync). Subclasses set ``cfg`` and ``in_ch``."""

    cfg: PredictorConfig
    in_ch: int

    def _prepare(self, paths: Sequence[str]):
        return prepare_images(paths, self.cfg, self.in_ch)

    def predict_batch(self, imgs) -> torch.Tensor:
        raise NotImplementedError

    def predict_paths(self, paths: Sequence[str]) -> Iterator[Dict]:
        """Stream detections for image paths. Host prep of a batch overlaps
        device compute of up to ``cfg.inflight`` earlier batches; each batch
        is fetched once, packed."""
        B = self.cfg.batch_size
        depth = max(1, self.cfg.inflight)
        pending: List[tuple] = []  # (paths_chunk, meta, packed_device_out)

        def drain(entry):
            chunk, meta, out = entry
            packed = out.cpu().numpy()  # one blocking fetch per batch
            for j, p in enumerate(chunk):
                yield {"path": str(p), **detections(packed[j], meta[j], self.cfg.img_size)}

        for i in range(0, len(paths), B):
            chunk = list(paths[i: i + B])
            imgs, meta = self._prepare(chunk + [chunk[-1]] * (B - len(chunk)))
            pending.append((chunk, meta, self.predict_batch(imgs)))
            if len(pending) >= depth:
                yield from drain(pending.pop(0))
        for entry in pending:
            yield from drain(entry)
