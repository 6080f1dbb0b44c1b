"""The train and eval steps (port of ``train/steps.py``).

Batches are the loader's dicts of fixed-shape numpy arrays:
  img        (B, H, W, C) float32 in [0, 1], NHWC
  gt_labels  (B, G) int32
  gt_bboxes  (B, G, 4) float32, normalised xyxy, zero-padded
  gt_mask    (B, G) bool
  sample_valid (B,) bool, optional

A train step: the batch to the model's device, the forward in train mode (BN
on batch statistics, its running statistics updated as flax updates them),
the maps cast to f32, the v8 loss (TAL assignment included), backward, clip,
AdamW and the EMA (``train/state.py``). Its metrics are 0-d device tensors:
no host sync.

An eval step: the batch to the model's device, the forward in eval mode, the
loss, and the top ``pre_nms_topk`` candidates through NMS kernel #1
(``ops/nms_kernels.py::nms_sweep_batched``; its plain version on a CPU
model): for YOLO11 by the fused select-then-decode, for YOLOX by a
``decode_fn`` (``models/yolox.py::yolox_eval_decode``) and the common
``postprocess``. Optionally greedy TP marks against the batch GT on the
device (``ops/matching.py``). Every result stays on the device; the caller
fetches.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig, v8_detection_loss
from yolo_scratch_tpu_torch.nn.modules import BatchNorm2d
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig, yolox_loss
from yolo_scratch_tpu_torch.ops.decode import postprocess, postprocess_from_feats
from yolo_scratch_tpu_torch.ops.matching import batched_tp_marks
from yolo_scratch_tpu_torch.parallel.collectives import (
    all_reduce_flat,
    all_reduce_grads,
    all_reduce_sum,
    broadcast_flat,
)
from yolo_scratch_tpu_torch.train.state import ema_state_dict
from yolo_scratch_tpu_torch.utils.profiling import annotate


def v8_loss_adapter(loss_cfg: DetectionLossConfig):
    """feats + batch -> (total, metrics dict) for the v8 (YOLO11) loss;
    ``reduce`` as in ``v8_detection_loss`` (the steps of a mesh pass it)."""

    def fn(feats, batch, reduce=None):
        total, items = v8_detection_loss(
            feats, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"], loss_cfg, reduce)
        return total, {"box_loss": items[0], "cls_loss": items[1], "dfl_loss": items[2]}

    return fn


def yolox_loss_adapter(loss_cfg: YOLOXLossConfig):
    """feats + batch -> (total, metrics dict) for the YOLOX (SimOTA) loss;
    ``reduce`` as in ``yolox_loss``."""

    def fn(feats, batch, reduce=None):
        return yolox_loss(feats, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"],
                          loss_cfg, reduce)

    return fn


@contextlib.contextmanager
def precision_scope(name: str | None) -> Iterator[None]:
    """The JAX package's ``jax.default_matmul_precision`` for one step.
    ``"highest"`` and ``"high"`` both turn TF32 off for cuBLAS matmuls and
    cuDNN convolutions (cuDNN's is on by default) and restore both flags
    afterwards; ``None`` leaves them as they are.

    JAX ``"high"``, the training default, means bf16x3 MXU passes, about
    16 mantissa bits. torch's ``"high"`` means TF32 on Hopper, 10 mantissa
    bits: other numerics, with no measured accuracy behind them. So it maps
    to full f32 until a TF32 arm has been measured (ROADMAP C4). Any other
    name raises."""
    if name is None:
        yield
        return
    if name not in ("high", "highest"):
        raise ValueError(f"matmul_precision={name!r}: want 'high', 'highest' or None")
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


@contextlib.contextmanager
def _bn_setting(model: torch.nn.Module, name: str, value) -> Iterator[None]:
    """Every ``BatchNorm2d`` of ``model`` with ``name`` set to ``value``
    inside; its class default again after."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m in bns:
            delattr(m, name)


def frozen_bn_stats(model: torch.nn.Module):
    """Train-mode forwards inside leave every BN's running statistics alone
    (the recompute of a checkpointed forward)."""
    return _bn_setting(model, "update_stats", False)


def bn_buffers(model: torch.nn.Module) -> list:
    """Every BN's running mean and variance."""
    return [t for m in model.modules() if isinstance(m, BatchNorm2d)
            for t in (m.running_mean, m.running_var)]


class TrainStep:
    """``step(state, batch) -> (state, metrics)``, built by
    :func:`build_train_step_custom`. The state is updated in place and
    returned; ``metrics`` holds ``loss`` and the loss function's items as
    0-d device tensors (no host sync).

    With a ``mesh`` (``parallel/mesh.py``) each rank calls the step with its
    own rows of the global batch. ``bn_mode="sync"``: BN normalises over
    the global batch (the mesh's group on every ``BatchNorm2d`` for the
    step), the loss takes ``reduce=`` (the batch-wide normalisers summed
    over the ranks) and the gradients, loss and metrics are summed over the
    ranks: the one-process step on the global batch. ``bn_mode="local"``:
    BN and the loss on the rank's own rows; gradients, loss and metrics
    averaged over the ranks; the BN running statistics averaged
    (``sync_bn_stats``) or rank 0's.

    The step runs in phases, each inside :meth:`_phase`: ``"h2d"``,
    ``"augment"`` when the call augments, then ``"forward"``, ``"loss"``
    and ``"backward"`` for each microbatch, then ``"all_reduce"`` on a
    mesh, then ``"clip_adamw_ema"``. Under a profiler each is a span
    ``yst.train.<phase>`` (``utils/profiling.py``). ``on_phase``, when
    set, is called with the phase's name as the phase ends, in that order;
    a profiler records a CUDA event there to time the step's own phases."""

    on_phase: Optional[Callable[[str], None]] = None

    def __init__(self, model, loss_fn, compute_dtype=None, remat=False, grad_accum=1,
                 matmul_precision=None, mesh=None, bn_mode="sync", sync_bn_stats=True):
        if bn_mode not in ("sync", "local"):
            raise ValueError(f"bn_mode={bn_mode!r}: 'sync' or 'local'")
        if mesh is not None and mesh.group is None:
            raise ValueError("a train step's mesh needs a process group: one process a rank "
                             "(parallel/distributed.py::make_global_mesh)")
        if mesh is not None and bn_mode == "local" and grad_accum > 1:
            raise ValueError("grad_accum>1 is supported on the sync-BN mesh step, not the "
                             "DDP (bn_mode='local') step")
        self.model = model
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.grad_accum = grad_accum
        self.precision = matmul_precision
        self.mesh = mesh
        self.bn_mode = bn_mode
        self.sync_bn_stats = sync_bn_stats
        sync = mesh is not None and bn_mode == "sync"
        # a one-rank group normalises over its own batch: plain BN is that
        self.bn_group = mesh.group if sync and mesh.size > 1 else None
        self.loss_kwargs = ({"reduce": functools.partial(all_reduce_sum, group=mesh.group)}
                            if sync else {})

    def forward(self, img: torch.Tensor):
        """Train-mode forward of an NHWC device batch -> raw maps in the
        model's dtype. bf16 runs under autocast (f32 master weights; BN
        statistics stay f32) and its maps are cast back to f32; remat
        recomputes the forward in backward, with the BN statistics updated
        once, in the first pass."""
        self.model.train()
        autocast = (torch.autocast(img.device.type, dtype=self.compute_dtype)
                    if self.compute_dtype is not None else contextlib.nullcontext())
        with autocast:
            if self.remat:
                feats = checkpoint(self.model, img, use_reentrant=False,
                                   context_fn=lambda: (contextlib.nullcontext(),
                                                       frozen_bn_stats(self.model)))
            else:
                feats = self.model(img)
        if self.compute_dtype is not None:
            feats = [f.float() for f in feats]
        return feats

    @contextlib.contextmanager
    def _phase(self, name: str) -> Iterator[None]:
        """One phase of the step: the span ``yst.train.<name>`` around it,
        then ``on_phase(name)`` as it ends."""
        with annotate(f"yst.train.{name}"):
            yield
        if self.on_phase is not None:
            self.on_phase(name)

    def _micro(self, batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Forward, loss and backward of one (micro)batch; the gradients
        add into ``.grad``."""
        with self._phase("forward"):
            feats = self.forward(batch["img"])
        with self._phase("loss"):
            total, metrics = self.loss_fn(feats, batch, **self.loss_kwargs)
        with self._phase("backward"):
            total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def grads(self, batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """The mean gradient of a device batch in ``.grad``, and its loss and
        metrics. ``grad_accum = k > 1`` splits the batch STRIDED, as the JAX
        step does (microbatch i is rows i, i+k, i+2k, ...): each
        microbatch's loss normalises over its own targets, BN statistics
        update once per microbatch in order, and gradients and metrics are
        summed, then scaled by 1/k."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        k = self.grad_accum
        with (contextlib.nullcontext() if self.bn_group is None
              else _bn_setting(self.model, "process_group", self.bn_group)):
            if k == 1:
                return self._micro(batch)
            loss, metrics = None, None
            for i in range(k):
                l_i, m_i = self._micro({key: v[i::k] for key, v in batch.items()})
                if loss is None:
                    loss, metrics = l_i, m_i
                else:
                    loss = loss + l_i
                    metrics = {key: metrics[key] + m_i[key] for key in metrics}
        with torch.no_grad():
            torch._foreach_mul_([p.grad for p in params], 1.0 / k)
        return loss * (1.0 / k), {key: v * (1.0 / k) for key, v in metrics.items()}

    def reduce_across(self, loss: torch.Tensor, metrics: Dict) -> Tuple[torch.Tensor, Dict]:
        """The mesh's reductions after :meth:`grads`: gradients, loss and
        metrics summed (sync) or averaged (local) over the ranks, and in
        local mode the BN running statistics averaged or rank 0's."""
        mesh, group = self.mesh, self.mesh.group
        n = mesh.size if self.bn_mode == "local" else 1
        all_reduce_grads(list(self.model.parameters()), group, divide=n)
        vals = all_reduce_sum(torch.stack([loss, *metrics.values()]), group)
        if n != 1:
            vals = vals / n
            if self.sync_bn_stats:
                all_reduce_flat(bn_buffers(self.model), group, divide=n)
            else:
                broadcast_flat(bn_buffers(self.model), group)
        return vals[0], dict(zip(metrics, vals[1:]))

    def __call__(self, state, batch: Mapping[str, Any],
                 augment: Optional[Callable[[Dict[str, torch.Tensor]], Dict]] = None,
                 rows: Optional[slice] = None):
        """One step. ``augment``, when given, maps the device batch before
        the forward (``data/augment.py::augment_batch``); ``rows`` then
        takes this rank's rows of the augmented global batch."""
        device = next(self.model.parameters()).device
        with self._phase("h2d"):
            b = batch_to_device(batch, device)
        if augment is not None:
            with self._phase("augment"):
                b = augment(b)
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        with precision_scope(self.precision):
            loss, metrics = self.grads(b)
            if self.mesh is not None:
                with self._phase("all_reduce"):
                    loss, metrics = self.reduce_across(loss, metrics)
            with self._phase("clip_adamw_ema"):
                state.apply_gradients([p.grad for p in self.model.parameters()])
        return state, {"loss": loss, **metrics}


def build_train_step_custom(model, loss_fn, compute_dtype=None, remat: bool = False,
                            grad_accum: int = 1, matmul_precision=None, mesh=None,
                            bn_mode: str = "sync", sync_bn_stats: bool = True) -> TrainStep:
    """The train step of ``model`` with ``loss_fn(feats, batch) -> (total,
    metrics)``.

    ``compute_dtype=torch.bfloat16``: the forward and backward under bf16
    autocast; the f32 master weights, optimizer state, BN statistics and the
    loss stay f32 (the maps are cast back before the loss).
    ``remat=True``: ``torch.utils.checkpoint`` (non-reentrant) of the whole
    forward, activations recomputed in backward. ``grad_accum=k``: see
    :meth:`TrainStep.grads`. ``matmul_precision``: :func:`precision_scope`
    for the whole step. ``mesh``, ``bn_mode``, ``sync_bn_stats``: the
    data-parallel step of :class:`TrainStep` (``parallel/mesh.py`` builds
    it)."""
    return TrainStep(model, loss_fn, compute_dtype, remat, grad_accum, matmul_precision, mesh,
                     bn_mode, sync_bn_stats)


class EvalStep:
    """``step(batch, state=None) -> (metrics, (boxes, scores, labels,
    valid)[, marks[, marks_cls]])``, built by :func:`make_eval_step`. With
    ``use_ema`` and a ``state`` that holds an EMA, the forward runs on the
    EMA parameters and the live BN buffers (``train/state.py::ema_state_dict``);
    otherwise on the model as it stands.

    ``metrics`` holds 0-d tensors: loss, the loss function's items (YOLO11:
    box_loss, cls_loss, dfl_loss; YOLOX: iou_loss, obj_loss, cls_loss,
    l1_loss, num_fg) and prefilter_saturated (the share of real images,
    ``sample_valid``, whose above-conf candidates exceed
    ``pre_nms_topk``). Detections are
    (B, max_det, ...) rows in normalised xyxy, score-descending, with a
    validity mask. Marks are (B, T, max_det) bool.

    With a ``mesh`` each rank calls the step with its own rows: detections
    and marks are the rank's (kernel #1 sweeps on every rank), and the
    metrics are the global batch's on every rank (the loss's batch-wide
    normalisers and the metrics summed over the ranks)."""

    def __init__(self, model, loss_fn, conf_threshold, iou_threshold, max_det, pre_nms_topk,
                 match_thresholds, per_class, matmul_precision, use_ema=False, decode_fn=None,
                 mesh=None):
        self.model = model
        self.reduce = (None if mesh is None
                       else functools.partial(all_reduce_sum, group=mesh.group))
        self.use_ema = use_ema
        self.loss_fn = loss_fn
        self.decode_fn = decode_fn
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

    def forward(self, batch: Mapping[str, torch.Tensor], state=None):
        """Raw NHWC Detect maps of a device batch, BN on its running
        statistics (the module is put in eval mode for the call)."""
        ema = ema_state_dict(state) if self.use_ema and state is not None else None
        was_training = self.model.training
        self.model.eval()
        try:
            with precision_scope(self.precision), torch.inference_mode():
                if ema is not None:
                    return functional_call(self.model, ema, (batch["img"],))
                return self.model(batch["img"])
        finally:
            self.model.train(was_training)

    def from_feats(self, feats, batch: Mapping[str, torch.Tensor]):
        """Loss, detections and marks from the maps of a device batch."""
        with precision_scope(self.precision), torch.inference_mode():
            return self._outputs(feats, batch)

    def detections(self, feats, img_size: int):
        """(boxes, scores, labels, valid, above-conf count per image) of the
        maps; kernel #1 sweeps at B > 1 (kernel #2 at B = 1 on the YOLOX
        path)."""
        if self.decode_fn is None:
            m = self.model
            return postprocess_from_feats(
                feats, nc=m.nc, strides=tuple(float(s) for s in m.strides), reg_max=m.reg_max,
                img_size=img_size, conf_threshold=self.conf_threshold,
                iou_threshold=self.iou_threshold, max_det=self.max_det,
                pre_nms_topk=self.pre_nms_topk, with_cand_count=True, nms_impl="kernel")
        decoded = self.decode_fn(feats)
        dets = postprocess(decoded, img_size=img_size, conf_threshold=self.conf_threshold,
                           iou_threshold=self.iou_threshold, max_det=self.max_det,
                           pre_nms_topk=self.pre_nms_topk, nms_impl="kernel")
        return (*dets, (decoded[..., 4:].amax(dim=-1) > self.conf_threshold).sum(dim=-1))

    def _outputs(self, feats, batch):
        if self.reduce is None:
            total, items = self.loss_fn(feats, batch)
        else:
            total, items = self.loss_fn(feats, batch, reduce=self.reduce)
        boxes, scores, labels, valid, cand = self.detections(feats, batch["img"].shape[1])
        # share of REAL images whose candidates exceed the cap: the loader
        # wrap-pads the final short batch with duplicates, which must not count
        sat = (cand > self.pre_nms_topk).to(torch.float32)
        sv = batch.get("sample_valid")
        metrics = {"loss": total, **items}
        if self.reduce is not None:
            svf = torch.ones_like(sat) if sv is None else sv.to(torch.float32)
            vals = self.reduce(torch.stack([*metrics.values(), (sat * svf).sum().to(total.dtype),
                                            svf.sum().to(total.dtype)]))
            metrics = dict(zip(metrics, vals[:-2]))
            sat_frac = vals[-2] / vals[-1].clamp(min=1.0)
        elif sv is not None:
            svf = sv.to(torch.float32)
            sat_frac = (sat * svf).sum() / svf.sum().clamp(min=1.0)
        else:
            sat_frac = sat.mean()
        metrics["prefilter_saturated"] = sat_frac
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

    def __call__(self, batch: Mapping[str, Any], state=None):
        b = batch_to_device(batch, self.device)
        return self.from_feats(self.forward(b, state), b)


def make_eval_step(model, loss_cfg: DetectionLossConfig | None = None,
                   conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                   max_det: int = 300, pre_nms_topk: int = 2048, use_ema: bool = False,
                   loss_fn=None, decode_fn=None, match_thresholds=None,
                   per_class: bool = False, matmul_precision: str | None = "highest",
                   mesh=None) -> EvalStep:
    """The eval step of ``model`` on the model's device.

    The reference NMSes every above-conf anchor; fixed shapes force a
    ``pre_nms_topk`` cap, 2048 so that it does not bind at conf 0.25 on
    trained weights. ``match_thresholds`` (an IoU tuple) adds greedy TP
    marks; ``per_class`` adds class-restricted marks. ``matmul_precision``
    defaults to ``"highest"``: TF32 off, because validation measures
    accuracy (see :func:`precision_scope`). ``use_ema``: evaluate the EMA
    of the state passed to each call.

    ``loss_fn`` (feats + batch -> (total, items)) replaces the v8 loss of
    ``loss_cfg``; ``decode_fn`` (maps -> (B, A, 4+nc) xywh pixels and
    scores) replaces the fused select-then-decode with itself and the
    common ``postprocess``. YOLOX passes both (``yolox_loss_adapter``,
    ``yolox_eval_decode``). ``mesh``: the data-parallel eval step of
    :class:`EvalStep`."""
    if loss_fn is None:
        if loss_cfg is None:
            loss_cfg = DetectionLossConfig(nc=model.nc, strides=model.strides,
                                           reg_max=model.reg_max)
        loss_fn = v8_loss_adapter(loss_cfg)
    return EvalStep(model, loss_fn, conf_threshold, iou_threshold, max_det, pre_nms_topk,
                    match_thresholds, per_class, matmul_precision, use_ema, decode_fn, mesh)
