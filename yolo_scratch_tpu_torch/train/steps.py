"""The evaluation step (port of ``train/steps.py``: ``v8_loss_adapter`` and
``make_eval_step``; the train step is not ported yet, ROADMAP C4).

Batches are the loader's dicts of fixed-shape numpy arrays:
  img        (B, H, W, C) float32 in [0, 1], NHWC
  gt_labels  (B, G) int32
  gt_bboxes  (B, G, 4) float32, normalised xyxy, zero-padded
  gt_mask    (B, G) bool
  sample_valid (B,) bool, optional

One step: the batch to the model's device, the forward in eval mode, the v8
loss (TAL assignment included), fused select-then-decode with the top
``pre_nms_topk`` candidates through NMS kernel #1
(``ops/nms_kernels.py::nms_sweep_batched``; its plain version on a CPU
model), and optionally greedy TP marks against the batch GT on the device
(``ops/matching.py``). Every result stays on the device; the caller fetches.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Mapping

import torch

from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig, v8_detection_loss
from yolo_scratch_tpu_torch.ops.decode import postprocess_from_feats
from yolo_scratch_tpu_torch.ops.matching import batched_tp_marks


def v8_loss_adapter(loss_cfg: DetectionLossConfig):
    """feats + batch -> (total, metrics dict) for the v8 (YOLO11) loss."""

    def fn(feats, batch):
        total, items = v8_detection_loss(
            feats, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"], loss_cfg)
        return total, {"box_loss": items[0], "cls_loss": items[1], "dfl_loss": items[2]}

    return fn


@contextlib.contextmanager
def precision_scope(name: str | None) -> Iterator[None]:
    """The JAX package's ``jax.default_matmul_precision`` for one step.
    ``"highest"`` turns TF32 off for both cuBLAS matmuls and cuDNN
    convolutions (cuDNN's is on by default) and restores both flags
    afterwards; ``None`` leaves them as they are. JAX ``"high"`` (bf16x3
    passes) has no torch counterpart: torch's ``"high"`` is TF32, other
    numerics (ROADMAP C4), so any other name raises."""
    if name is None:
        yield
        return
    if name != "highest":
        raise NotImplementedError(
            f"matmul_precision={name!r}: only 'highest' (TF32 off) and None are ported; "
            "JAX 'high' is not torch 'high' (ROADMAP C4)")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def batch_to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The loader's numpy batch -> tensors on ``device``, layouts unchanged."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class EvalStep:
    """``step(batch) -> (metrics, (boxes, scores, labels, valid)[, marks[,
    marks_cls]])``, built by :func:`make_eval_step`.

    ``metrics`` holds 0-d tensors: loss, box_loss, cls_loss, dfl_loss and
    prefilter_saturated (the share of real images, ``sample_valid``, whose
    above-conf candidates exceed ``pre_nms_topk``). Detections are
    (B, max_det, ...) rows in normalised xyxy, score-descending, with a
    validity mask. Marks are (B, T, max_det) bool."""

    def __init__(self, model, loss_fn, conf_threshold, iou_threshold, max_det, pre_nms_topk,
                 match_thresholds, per_class, matmul_precision):
        self.model = model
        self.loss_fn = loss_fn
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.max_det = max_det
        self.pre_nms_topk = pre_nms_topk
        self.match_thresholds = match_thresholds
        self.per_class = per_class
        self.precision = matmul_precision

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def forward(self, batch: Mapping[str, torch.Tensor]):
        """Raw NHWC Detect maps of a device batch, BN on its running
        statistics (the module is put in eval mode for the call)."""
        was_training = self.model.training
        self.model.eval()
        try:
            with precision_scope(self.precision), torch.inference_mode():
                return self.model(batch["img"])
        finally:
            self.model.train(was_training)

    def from_feats(self, feats, batch: Mapping[str, torch.Tensor]):
        """Loss, detections and marks from the maps of a device batch."""
        with precision_scope(self.precision), torch.inference_mode():
            return self._outputs(feats, batch)

    def _outputs(self, feats, batch):
        total, items = self.loss_fn(feats, batch)
        m = self.model
        boxes, scores, labels, valid, cand = postprocess_from_feats(
            feats, nc=m.nc, strides=tuple(float(s) for s in m.strides), reg_max=m.reg_max,
            img_size=batch["img"].shape[1], conf_threshold=self.conf_threshold,
            iou_threshold=self.iou_threshold, max_det=self.max_det,
            pre_nms_topk=self.pre_nms_topk, with_cand_count=True, nms_impl="kernel")
        # share of REAL images whose candidates exceed the cap: the loader
        # wrap-pads the final short batch with duplicates, which must not count
        sat = (cand > self.pre_nms_topk).to(torch.float32)
        sv = batch.get("sample_valid")
        if sv is not None:
            svf = sv.to(torch.float32)
            sat_frac = (sat * svf).sum() / svf.sum().clamp(min=1.0)
        else:
            sat_frac = sat.mean()
        metrics = {"loss": total, **items, "prefilter_saturated": sat_frac}
        dets = (boxes, scores, labels, valid)
        if self.match_thresholds is None:
            return metrics, dets
        # boxes are normalised xyxy, the GT's space
        th = tuple(self.match_thresholds)
        marks = batched_tp_marks(boxes, valid, batch["gt_bboxes"], batch["gt_mask"],
                                 thresholds=th)
        if not self.per_class:
            return metrics, dets, marks
        marks_cls = batched_tp_marks(boxes, valid, batch["gt_bboxes"], batch["gt_mask"],
                                     thresholds=th, pred_labels=labels,
                                     gt_labels=batch["gt_labels"])
        return metrics, dets, marks, marks_cls

    def __call__(self, batch: Mapping[str, Any]):
        b = batch_to_device(batch, self.device)
        return self.from_feats(self.forward(b), b)


def make_eval_step(model, loss_cfg: DetectionLossConfig | None = None,
                   conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                   max_det: int = 300, pre_nms_topk: int = 2048, use_ema: bool = False,
                   loss_fn=None, decode_fn=None, match_thresholds=None,
                   per_class: bool = False, matmul_precision: str | None = "highest") -> EvalStep:
    """The eval step of a YOLO11 ``model`` on the model's device.

    The reference NMSes every above-conf anchor; fixed shapes force a
    ``pre_nms_topk`` cap, 2048 so that it does not bind at conf 0.25 on
    trained weights. ``match_thresholds`` (an IoU tuple) adds greedy TP
    marks; ``per_class`` adds class-restricted marks. ``matmul_precision``
    defaults to ``"highest"``: TF32 off, because validation measures
    accuracy (see :func:`precision_scope`).

    ``use_ema`` waits for the EMA state (ROADMAP C3); ``loss_fn`` and
    ``decode_fn`` serve YOLOX (ROADMAP E). Passing them raises."""
    if use_ema:
        raise NotImplementedError("use_ema: the EMA train state is not ported yet (ROADMAP C3)")
    if loss_fn is not None or decode_fn is not None:
        raise NotImplementedError("loss_fn / decode_fn: the YOLOX family is not ported yet "
                                  "(ROADMAP E)")
    if loss_cfg is None:
        loss_cfg = DetectionLossConfig(nc=model.nc, strides=model.strides,
                                       reg_max=model.reg_max)
    return EvalStep(model, v8_loss_adapter(loss_cfg), conf_threshold, iou_threshold, max_det,
                    pre_nms_topk, match_thresholds, per_class, matmul_precision)
