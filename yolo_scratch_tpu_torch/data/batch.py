"""Batch formats and converters (a copy of ``yolo_scratch_tpu/data/batch.py``,
numpy only).

Internal (step-facing) batch format — everything fixed-shape:
  img        (B, H, W, C) float32 in [0, 1]
  gt_labels  (B, G) int32           zero-padded
  gt_bboxes  (B, G, 4) float32      normalized xyxy in [0, 1], zero-padded
  gt_mask    (B, G) bool

The reference's collate emits a *flat* format — ``batch_idx (N,), cls
(N, 1), bboxes (N, 4)`` (``datasets/crater_dataset_cuda.py:289-346``) with
dynamic N; converters below give API parity at the host edge.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pad_targets(
    boxes_list: Sequence[np.ndarray],  # per-image (n_i, 4) normalized xyxy
    labels_list: Sequence[np.ndarray],  # per-image (n_i,)
    max_gt: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image box lists -> (gt_labels (B,G), gt_bboxes (B,G,4), gt_mask (B,G)).

    Overflow beyond ``max_gt`` is truncated (highest-index boxes dropped).
    """
    B = len(boxes_list)
    gl = np.zeros((B, max_gt), np.int32)
    gb = np.zeros((B, max_gt, 4), np.float32)
    gm = np.zeros((B, max_gt), bool)
    for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
        n = min(len(bx), max_gt)
        if n:
            gb[i, :n] = bx[:n]
            gl[i, :n] = lb[:n]
            gm[i, :n] = True
    return gl, gb, gm


def flat_to_padded(
    batch_idx: np.ndarray, cls: np.ndarray, bboxes: np.ndarray, batch_size: int, max_gt: int
):
    """Reference flat format -> padded. ``cls`` may be (N,) or (N, 1)."""
    cls = np.asarray(cls).reshape(-1)
    boxes_list, labels_list = [], []
    for b in range(batch_size):
        m = np.asarray(batch_idx) == b
        boxes_list.append(np.asarray(bboxes)[m])
        labels_list.append(cls[m])
    return pad_targets(boxes_list, labels_list, max_gt)


def padded_to_flat(gt_labels, gt_bboxes, gt_mask) -> Dict[str, np.ndarray]:
    """Padded -> reference flat collate format (for API-parity surfaces)."""
    bi, cl, bx = [], [], []
    for b in range(gt_mask.shape[0]):
        for g in range(gt_mask.shape[1]):
            if gt_mask[b, g]:
                bi.append(b)
                cl.append(gt_labels[b, g])
                bx.append(gt_bboxes[b, g])
    return {
        "batch_idx": np.asarray(bi, np.int64),
        "cls": np.asarray(cl, np.int64).reshape(-1, 1),
        "bboxes": np.asarray(bx, np.float32).reshape(-1, 4) if bx else np.zeros((0, 4), np.float32),
    }
