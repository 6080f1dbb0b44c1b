"""Fixed-shape greedy NMS on tensors (port of ``ops/nms.py``).

:func:`nms` is the pairwise-matrix sweep (the JAX package's
``nms_impl="xla"`` path), independent of the CUDA kernels in
``ops/nms_kernels.py``. :func:`batched_nms_tiled` is the tiled sweep (the
JAX package's ``nms_impl="tiled"``, opt-in), plain PyTorch ops as the JAX
one is XLA: N/128 tile steps against the pairwise sweep's N steps per
image. Kernel #1 takes any N and is the fast route at every N. Outputs are
padded to ``max_det`` with a validity mask so shapes stay static.
"""

from __future__ import annotations

import torch

from yolo_scratch_tpu_torch.ops.boxes import pairwise_iou
from yolo_scratch_tpu_torch.ops.nms_kernels import _cap, _f32


_SIGN_FREE = {torch.float32: (torch.int32, 31, 0x7FFFFFFF),
              torch.bfloat16: (torch.int16, 15, 0x7FFF),
              torch.float16: (torch.int16, 15, 0x7FFF)}


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Integer keys in the floats' total order, the order XLA's ``top_k``
    compares in: -0.0 sorts below +0.0 (IEEE and ``torch.sort`` call them
    equal). A negative float's magnitude bits are flipped, so its key falls
    as its value does."""
    if x.dtype not in _SIGN_FREE:
        return x
    itype, shift, mask = _SIGN_FREE[x.dtype]
    bits = x.view(itype)
    return bits ^ ((bits >> shift) & mask)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with XLA ``top_k``'s order: the floats'
    total order (-0.0 below +0.0), equal values lower index first.
    (``torch.topk`` promises no order among equal values, and the deploy
    path ranks bf16 logits, where ties are common.)"""
    _, idx = torch.sort(_total_order_key(x), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    valid: torch.Tensor | None = None,
    class_ids: torch.Tensor | None = None,
    class_aware: bool = False,
    presorted: bool = False,
) -> torch.Tensor:
    """Greedy NMS over (N, 4) xyxy boxes -> keep (N,) bool (at most
    ``max_det`` survivors, by descending score). Invalid boxes neither
    suppress nor survive; ``presorted`` skips the sort."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    if class_aware and class_ids is not None:
        span = boxes.abs().max() + 1.0
        boxes = boxes + (class_ids.to(boxes.dtype) * span * 2.0)[:, None]

    if presorted:
        boxes_s, valid_s = boxes, valid
    else:
        order = torch.argsort(-scores, stable=True)
        boxes_s, valid_s = boxes[order], valid[order]

    thr = _f32(iou_threshold)
    iou = pairwise_iou(boxes_s, boxes_s)
    idx = torch.arange(n, device=boxes.device)
    suppressed = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        is_kept = valid_s[i] & ~suppressed[i]
        suppressed = suppressed | (is_kept & (iou[i] > thr) & (idx > i))
    keep_s = _cap(valid_s & ~suppressed, max_det)
    if presorted:
        return keep_s
    return torch.zeros_like(keep_s).scatter_(0, order, keep_s)


def _self_suppress_tile(iou: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy suppression within one score-sorted tile: ``iou`` (B, T,
    T), masked to the strict upper triangle and to alive boxes -> suppressed
    (B, T) bool.

    The row-zeroing fixpoint of the JAX function: a box suppressed by a
    currently unsuppressed box has its row zeroed, so it suppresses no
    more; boxes it wrongly suppressed revive on the next pass. The stop test
    is its integer count of non-zero rows (a float sum can miss a small
    row's removal to rounding), read on the host each pass."""
    thr = _f32(iou_threshold)
    nonzero = int((iou > 0.0).any(dim=2).sum())
    while True:
        suppressed_1 = iou.amax(dim=1) > thr  # suppressed by anyone
        can_suppress = torch.where(suppressed_1, 0.0, 1.0)[:, :, None]
        # suppressed by a currently UNsuppressed box: zero those rows
        suppressed_2 = (can_suppress * iou).amax(dim=1) > thr
        iou = torch.where(suppressed_2[:, :, None], 0.0, iou)
        nz = int((iou > 0.0).any(dim=2).sum())
        if nz >= nonzero:
            return iou.amax(dim=1) > thr
        nonzero = nz


def batched_nms_tiled(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    class_ids: torch.Tensor | None = None,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    class_aware: bool = False,
    tile: int = 128,
) -> torch.Tensor:
    """Exact greedy NMS in score-descending tiles: boxes (B, N, 4), scores
    (B, N), valid (B, N) -> keep (B, N) bool, the keep sets of
    :func:`nms` and the kernels. Each tile is first suppressed by the kept
    boxes of earlier tiles (one batched (B, N, T) IoU), then resolved
    inside by :func:`_self_suppress_tile`. The sort is stable, as
    ``jnp.argsort`` is; a class-aware offset spans the whole batch, as in
    the JAX function."""
    B, n0 = scores.shape
    dev = boxes.device
    thr = _f32(iou_threshold)
    if class_aware and class_ids is not None:
        span = boxes.abs().max() + 1.0
        boxes = boxes + (class_ids.to(boxes.dtype) * span * 2.0)[..., None]

    n = -(-n0 // tile) * tile
    pad = n - n0
    if pad:
        boxes = torch.cat([boxes, boxes.new_zeros(B, pad, 4)], 1)
        scores = torch.cat([scores, scores.new_full((B, pad), float("-inf"))], 1)
        valid = torch.cat([valid, valid.new_zeros(B, pad)], 1)

    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)

    pos = torch.arange(n, device=dev)
    tri = torch.triu(torch.ones(tile, tile, dtype=torch.bool, device=dev), diagonal=1)[None]
    keep_s = torch.zeros(B, n, dtype=torch.bool, device=dev)
    for start in range(0, n, tile):
        tb = boxes_s[:, start:start + tile]
        tv = valid_s[:, start:start + tile]
        # suppression by kept boxes of earlier tiles
        iou_prev = pairwise_iou(boxes_s, tb)  # (B, N, T)
        prev_mask = (pos < start)[None, :, None] & keep_s[:, :, None]
        hit = torch.where(prev_mask, iou_prev, 0.0).amax(dim=1) > thr
        alive = tv & ~hit
        # the greedy resolve inside the tile among the alive candidates
        af = alive.to(boxes_s.dtype)
        iou_tt = (torch.where(tri, pairwise_iou(tb, tb), 0.0)
                  * af[:, :, None] * af[:, None, :])
        keep_s[:, start:start + tile] = alive & ~_self_suppress_tile(iou_tt, iou_threshold)

    keep_s = _cap(keep_s, max_det)
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)[:, :n0]


def gather_topk_detections_batched(boxes, scores, labels, keep, max_det: int):
    """(B, N, ...) candidates + keep mask -> fixed (B, max_det, ...) outputs,
    score-descending: (boxes f32, scores, labels, valid). Padding rows are
    zeros."""
    B, n = scores.shape
    masked = scores.masked_fill(~keep, float("-inf"))
    top_scores, order = stable_topk(masked, min(max_det, n))
    v = torch.isfinite(top_scores)
    sel_boxes = torch.gather(boxes.to(torch.float32), 1, order[..., None].expand(-1, -1, 4))
    sel_labels = torch.gather(labels, 1, order)

    pad = max_det - order.shape[1]
    if pad > 0:  # n < max_det: pad out to the fixed shape
        sel_boxes = torch.nn.functional.pad(sel_boxes, (0, 0, 0, pad))
        sel_labels = torch.nn.functional.pad(sel_labels, (0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=float("-inf"))
        v = torch.nn.functional.pad(v, (0, pad))

    return (
        sel_boxes.masked_fill(~v[..., None], 0.0),
        top_scores.masked_fill(~v, 0.0),
        sel_labels.masked_fill(~v, 0),
        v,
    )


def gather_topk_detections(boxes, scores, labels, keep, max_det: int):
    """Single-image :func:`gather_topk_detections_batched`."""
    b, s, l, v = gather_topk_detections_batched(
        boxes[None], scores[None], labels[None], keep[None], max_det)
    return b[0], s[0], l[0], v[0]
