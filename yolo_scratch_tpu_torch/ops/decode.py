"""Inference postprocess: head output -> final detections, on the device
(port of ``ops/decode.py``).

Per image: max class score, confidence gate, exact top-k prefilter, greedy
class-agnostic NMS, boxes normalised by the image size and clamped to
[0, 1]. Fixed shapes throughout: (B, max_det, ...) outputs with a validity
mask.

``nms_impl``: ``"kernel"`` runs the hand-written CUDA sweeps of
``ops/nms_kernels.py`` (their plain versions on CPU tensors); ``"pairwise"``
runs ``ops/nms.py::nms`` (the JAX package's ``"xla"`` path); ``"tiled"``
runs ``ops/nms.py::batched_nms_tiled`` (PyTorch ops, the JAX package's
``"tiled"``).

Spans (``utils/profiling.py``, recorded only under a profiler): ``yst.select``
around candidate selection and decode, ``yst.nms`` around the sweep, the
class offset and the ``max_det`` cap, ``yst.pack`` around the gather and
normalisation; on the kernel path ``yst.count`` after ``yst.nms`` around the
``nms.pairs_needed`` counter.

The JAX package selects rows with one-hot contractions (TPU gathers are
slow); they are exact, so plain gathers give the same values here. Every
top-k orders as XLA's ``top_k`` does: the floats' total order (-0.0 below
+0.0), ties lower index first (``ops/nms.py::stable_topk``).
"""

from __future__ import annotations

import torch

from yolo_scratch_tpu_torch.ops.anchors import make_anchors
from yolo_scratch_tpu_torch.ops.boxes import dist2bbox, xywh2xyxy
from yolo_scratch_tpu_torch.ops.nms import (
    batched_nms_tiled,
    gather_topk_detections_batched,
    nms,
    stable_topk,
)
from yolo_scratch_tpu_torch.ops.nms_kernels import (
    _cap,
    _class_offset,
    nms_sweep,
    nms_sweep_batched,
    pairs_needed,
)
from yolo_scratch_tpu_torch.nn.modules import dfl_expectation
from yolo_scratch_tpu_torch.utils import profiling
from yolo_scratch_tpu_torch.utils.profiling import annotate

NMS_IMPLS = ("kernel", "pairwise", "tiled")
LANES = 128  # the block width of the blocked top-k


def topk_scores(scores: torch.Tensor, k: int, blocked: int = 0):
    """(B, A) -> (top_scores (B, k), top_idx (B, k)), score-descending,
    ties lower index first.

    ``blocked=0``: the exact top-k. ``blocked=kb>0``: two stages, as the
    JAX function: the top-kb of each 128-anchor block (the scores padded
    to whole blocks with -inf), then the exact top-k over those survivors,
    their positions mapped back to anchor indices with a gather. It equals
    the exact top-k unless one block holds more than kb of it (dense
    scenes do: the JAX package ships the exact path). Past the survivor
    count the result is padded with -inf at index 0. A padded lane can be
    selected among -inf rows; its index is then >= A."""
    B, A = scores.shape
    k = min(k, A)
    if not blocked:
        return stable_topk(scores, k)
    nblk = -(-A // LANES)
    kb = min(blocked, LANES)
    padded = torch.cat([scores, scores.new_full((B, nblk * LANES - A), float("-inf"))], 1)
    loc_scores, loc_idx = stable_topk(padded.reshape(B, nblk, LANES), kb)  # (B, nblk, kb)
    base = torch.arange(nblk, device=scores.device)[None, :, None] * LANES
    glob_idx = (base + loc_idx).reshape(B, nblk * kb)
    top_scores, pos = stable_topk(loc_scores.reshape(B, nblk * kb), min(k, nblk * kb))
    top_idx = torch.gather(glob_idx, 1, pos)
    pad = k - top_scores.shape[1]
    if pad > 0:  # k above the survivor count
        top_scores = torch.cat([top_scores, top_scores.new_full((B, pad), float("-inf"))], 1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(B, pad)], 1)
    return top_scores, top_idx


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, C), idx (B, K) -> x[b, idx[b, k], :] (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _prefilter_batched(decoded: torch.Tensor, conf_threshold: float, pre_nms_topk: int):
    """(B, A, 4+nc) -> score-sorted top-k candidates per image:
    (boxes xyxy f32, scores, labels int32, valid)."""
    cls_scores = decoded[..., 4:]
    scores = cls_scores.amax(dim=-1)
    labels = cls_scores.argmax(dim=-1)
    conf_ok = scores > conf_threshold
    top_scores, top_idx = stable_topk(scores.masked_fill(~conf_ok, float("-inf")),
                                      min(pre_nms_topk, decoded.shape[1]))
    top_valid = torch.isfinite(top_scores)
    top_boxes = xywh2xyxy(_gather_rows(decoded[..., :4], top_idx).to(torch.float32))
    top_labels = torch.gather(labels, 1, top_idx).to(torch.int32)
    return top_boxes, top_scores.masked_fill(~top_valid, 0.0), top_labels, top_valid


def _check_impl(nms_impl: str) -> None:
    if nms_impl not in NMS_IMPLS:
        raise ValueError(f"nms_impl {nms_impl!r}: choose from {NMS_IMPLS}")


def _keep_batched(boxes, scores, valid, labels, *, iou_threshold, max_det, class_aware,
                  nms_impl, single: bool = False):
    """Keep mask (B, K) over score-sorted candidates, at most ``max_det``
    an image. The kernel path sweeps on kernel #1, or on kernel #2 where
    ``single`` (B = 1)."""
    with annotate("yst.nms"):
        if nms_impl == "tiled":
            return batched_nms_tiled(boxes, scores, valid, class_ids=labels,
                                     iou_threshold=iou_threshold, max_det=max_det,
                                     class_aware=class_aware)
        if nms_impl != "kernel":
            return torch.stack([
                nms(b, s, iou_threshold=iou_threshold, max_det=max_det, valid=v, class_ids=c,
                    class_aware=class_aware, presorted=True)
                for b, s, v, c in zip(boxes, scores, valid, labels)
            ])
        nms_boxes = _class_offset(boxes, labels) if class_aware else boxes
        if single:
            swept = nms_sweep(nms_boxes[0], valid[0], iou_threshold)[None]
        else:
            swept = nms_sweep_batched(nms_boxes, valid, iou_threshold)
        keep = _cap(swept, max_det)
    if profiling.enabled():
        with annotate("yst.count"):
            profiling.count("nms.pairs_needed", pairs_needed(swept, valid))
    return keep


def _finish(boxes, scores, labels, keep, max_det: int, img_size: int):
    with annotate("yst.pack"):
        out_b, out_s, out_l, out_v = gather_topk_detections_batched(
            boxes, scores, labels, keep, max_det=max_det)
        return (out_b / img_size).clamp(0.0, 1.0), out_s, out_l, out_v


def postprocess(
    decoded: torch.Tensor,  # (B, A, 4+nc)
    img_size: int,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 1000,
    class_aware: bool = False,
    nms_impl: str = "pairwise",
):
    """Batched postprocess -> (boxes (B, max_det, 4) normalised xyxy,
    scores (B, max_det), labels (B, max_det), valid (B, max_det)).
    With ``nms_impl="kernel"`` a batch of one goes through the
    single-image kernel (#2), larger batches through the batched one (#1)."""
    _check_impl(nms_impl)
    with annotate("yst.select"):
        boxes, scores, labels, valid = _prefilter_batched(decoded, conf_threshold, pre_nms_topk)
    keep = _keep_batched(boxes, scores, valid, labels, iou_threshold=iou_threshold,
                         max_det=max_det, class_aware=class_aware, nms_impl=nms_impl,
                         single=boxes.shape[0] == 1)
    return _finish(boxes, scores, labels, keep, max_det, img_size)


def select_candidates(feats, nc: int, strides, reg_max: int = 16,
                      conf_threshold: float = 0.25, pre_nms_topk: int = 1000,
                      blocked_topk: int = 0):
    """Raw NHWC Detect maps -> the top-``pre_nms_topk`` candidates per
    image, ranked on the raw max class logit in the maps' own dtype (ties
    lower anchor first; ``blocked_topk`` selects by :func:`topk_scores`'s
    two stages), decoded AFTER selection: (boxes xyxy f32 (B, K, 4), scores
    f32 (B, K), labels int32 (B, K), valid (B, K), conf_ok (B, A)).

    Only the K selected rows go to f32; the DFL integral and dist2bbox run
    on them instead of on all anchors."""
    B = feats[0].shape[0]
    no = nc + 4 * reg_max
    x = torch.cat([f.reshape(B, -1, no) for f in feats], 1)  # (B, A, no)
    anchor_points, stride_tensor = make_anchors(
        [(f.shape[1], f.shape[2], s) for f, s in zip(feats, strides)], 0.5,
        dtype=torch.float32, device=x.device)

    max_logit = x[..., 4 * reg_max:].amax(dim=-1)  # (B, A), maps' dtype
    # the conf gate in f32, exactly as the unfused path computes it
    conf_ok = torch.sigmoid(max_logit.to(torch.float32)) > conf_threshold
    top_logits, top_idx = topk_scores(max_logit.masked_fill(~conf_ok, float("-inf")),
                                      pre_nms_topk, blocked=blocked_topk)
    if blocked_topk:  # a pad lane (index >= A) marks an invalid row: read row A-1 there
        top_idx = top_idx.clamp(max=x.shape[1] - 1)
    top_logits = top_logits.to(torch.float32)
    top_valid = torch.isfinite(top_logits)
    top_scores = torch.sigmoid(top_logits).masked_fill(~top_valid, 0.0)

    sel = _gather_rows(x, top_idx).to(torch.float32)  # (B, K, no)
    top_labels = sel[..., 4 * reg_max:].argmax(dim=-1).to(torch.int32)
    dist = dfl_expectation(sel[..., : 4 * reg_max], reg_max)  # (B, K, 4)
    boxes_xywh = dist2bbox(dist, anchor_points[top_idx], xywh=True, dim=-1) * stride_tensor[top_idx]
    return xywh2xyxy(boxes_xywh), top_scores, top_labels, top_valid, conf_ok


def postprocess_from_feats(
    feats,  # list of raw Detect maps, (B, H, W, 4*reg_max+nc) each
    nc: int,
    strides,
    img_size: int,
    reg_max: int = 16,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 1000,
    class_aware: bool = False,
    nms_impl: str = "pairwise",
    blocked_topk: int = 0,
    with_cand_count: bool = False,
):
    """Fused select-then-decode + NMS from raw head maps: the same results
    as ``postprocess(detect_decode(feats))`` except among candidates whose
    f32 scores collide (|logit| >~ 14), which this path orders by the finer
    logit. The batched NMS runs at every batch size."""
    _check_impl(nms_impl)
    with annotate("yst.select"):
        boxes, scores, labels, valid, conf_ok = select_candidates(
            feats, nc, strides, reg_max, conf_threshold, pre_nms_topk, blocked_topk)
        if with_cand_count:  # (B,) above-conf candidate count
            cand = conf_ok.sum(dim=-1, dtype=torch.int32)
    keep = _keep_batched(boxes, scores, valid, labels, iou_threshold=iou_threshold,
                         max_det=max_det, class_aware=class_aware, nms_impl=nms_impl)
    out = _finish(boxes, scores, labels, keep, max_det, img_size)
    return (*out, cand) if with_cand_count else out
