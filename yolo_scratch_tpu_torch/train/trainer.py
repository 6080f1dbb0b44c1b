"""Trainer: the epoch loop, validation and checkpoints (port of
``train/trainer.py``).

The train step keeps its metrics on the device; an epoch's are stacked and
fetched once at its end. With ``augment`` set, each batch is augmented on
the device after H2D and before the forward (``data/augment.py``), from a
generator seeded by (seed + 1, epoch, batch index), except in the final
``final_epochs`` (the YOLOX no-aug end phase, which also turns the YOLOX L1
loss on). Validation runs the eval step with device TP marks and NMS kernel
#1 (``train/steps.py::EvalStep``), deferring its fetches in chunks of
``val_fetch_chunk`` batches; only the AP accumulation runs on the host.

``model_kind``: ``"yolo11"`` (v8 loss, fused DFL decode) or ``"yolox"``
(SimOTA loss, ``yolox_eval_decode``).

With a ``mesh`` (``parallel/``: one process a rank, the model on the rank's
device) every rank runs this loop. At start rank 0's parameters, BN
buffers, EMA and optimiser state are broadcast. Each train batch is the
global batch (augmented whole, with the shared generator, so a mosaic may
draw another rank's rows) of which the rank trains its contiguous rows; on
a ``process_local`` mesh (``--multihost``) each process loads its own rows,
and the global batch is gathered only to augment it. ``bn_mode="sync"``
trains as one process on the global batch would; ``"local"`` is the DDP
step (``train/steps.py::TrainStep``). Validation runs the eval step on the
rank's rows (kernel #1 sweeps on every rank) and gathers the marks, scores
and valid flags (the detections too with host matching) in rank order, so
every rank computes the one-process metrics. Rank 0 alone writes
checkpoints and logs and prints; every rank reads a checkpoint on resume.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from yolo_scratch_tpu_torch.data.augment import augment_batch, batch_generator
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.yolox import yolox_eval_decode
from yolo_scratch_tpu_torch.parallel.collectives import all_gather_cat
from yolo_scratch_tpu_torch.parallel.distributed import barrier
from yolo_scratch_tpu_torch.parallel.mesh import replicate, shard_batch, state_tensors
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import cosine_epoch_schedule, make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import (
    batch_to_device,
    build_train_step_custom,
    make_eval_step,
    v8_loss_adapter,
    yolox_loss_adapter,
)
from yolo_scratch_tpu_torch.utils.metrics import (
    detections_to_lists,
    evaluate_detections,
    metrics_from_marks,
    targets_to_lists,
)


@dataclass
class TrainerConfig:
    epochs: int = 150
    lr: float = 1e-3
    weight_decay: float = 5e-4
    warmup_epochs: int = 3
    clip_norm: float = 10.0
    val_conf: float = 0.25
    nms_iou: float = 0.45
    max_det: int = 300
    # prefilter cap of the fixed-shape NMS (the reference's eval NMS is
    # uncapped); the per-epoch `prefilter_saturated` val metric reports
    # when it binds
    pre_nms_topk: int = 2048
    # precision of the EVAL step (train/steps.py::precision_scope):
    # validation measures accuracy, so TF32 off
    val_matmul_precision: Optional[str] = "highest"
    max_val_batches: Optional[int] = None
    # validate() defers device->host fetches and stacks them, flushing every
    # K batches: the live footprint is K x B x max_det rows, not the val set
    val_fetch_chunk: int = 128
    save_dir: Optional[str] = None
    use_ema: bool = False
    eval_with_ema: bool = False
    log_interval: int = 50
    augment: Optional[Any] = None  # data.augment.AugmentConfig; applied on the device
    mixed_precision: bool = False  # bf16 autocast fwd/bwd, f32 master weights + loss
    remat: bool = False  # activation recompute (torch.utils.checkpoint) in backward
    # k>1: k microbatches, mean gradient applied once (steps.TrainStep.grads)
    grad_accum: int = 1
    # TRAIN-step precision: the JAX default "high" (bf16x3 passes) maps to
    # TF32 off here, as "highest" does (train/steps.py::precision_scope);
    # None leaves the backend flags alone
    train_matmul_precision: Optional[str] = "high"
    bn_mode: str = "sync"  # 'sync' (global-batch BN) | 'local' (DDP per-replica)
    # final no-aug phase (the YOLOX recipe): the last N epochs train with
    # augmentation off, and for YOLOX with the L1 loss on. 0 disables it.
    final_epochs: int = 0
    # TP/FP matching on the device inside the eval step (ops/matching.py);
    # False takes the numpy greedy matcher (utils/metrics.py)
    device_matching: bool = True
    # warm-start weights: a checkpoint dir of the port or of the JAX package
    # (best, else last) or a reference .pt file; missing keys and shape mismatches
    # keep their init (the reference's strict=False load)
    pretrained: Optional[str] = None
    # early stopping after N epochs of val fitness (mAP50, else -val loss)
    # below its running best; the gate is >=, so an exact plateau refreshes
    # the clock. 0 disables. The counters persist in the checkpoint meta.
    patience: int = 0


class Trainer:
    def __init__(self, model, train_loader, val_loader=None,
                 config: TrainerConfig = TrainerConfig(), mesh=None, seed: int = 0,
                 model_kind: str = "yolo11"):
        """Trains ``model`` in place, on the model's device. The model comes
        initialised (the CLI seeds it) and the loaders carry their own
        seeds; ``seed`` + 1 seeds the augmentation, as in the JAX package.
        ``mesh``: data-parallel training, this process one rank of it."""
        if model_kind not in ("yolo11", "yolox"):
            raise ValueError(f"model_kind={model_kind!r}: 'yolo11' or 'yolox'")
        if config.bn_mode not in ("sync", "local"):
            raise ValueError(f"bn_mode={config.bn_mode!r}: 'sync' or 'local'")
        if mesh is None and config.bn_mode == "local":
            warnings.warn("bn_mode='local' has no effect without a mesh — training uses "
                          "single-device BN (identical to 'sync' at mesh size 1)", stacklevel=2)
        if mesh is not None:
            if next(model.parameters()).device != mesh.device:
                raise ValueError(f"the model is on {next(model.parameters()).device}, this "
                                 f"rank's device is {mesh.device}")
            if mesh.process_local and not config.device_matching:
                raise ValueError("multi-process meshes require device_matching=True (host-side "
                                 "greedy matching cannot see other processes' targets)")
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.cfg = config
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.is_writer
        self.aug_seed = seed + 1
        self.loss_cfg = DetectionLossConfig(nc=model.nc, strides=model.strides)
        loss_fn = v8_loss_adapter(self.loss_cfg)
        self._loss_fn_final = None  # the final phase's loss (YOLOX: use_l1=True)
        decode_fn = eval_loss_fn = None
        if model_kind == "yolox":
            strides = tuple(model.strides)
            loss_fn = eval_loss_fn = yolox_loss_adapter(YOLOXLossConfig(nc=model.nc,
                                                                        strides=strides))
            if config.final_epochs > 0:
                self._loss_fn_final = yolox_loss_adapter(
                    YOLOXLossConfig(nc=model.nc, strides=strides, use_l1=True))
            decode_fn = lambda feats: yolox_eval_decode(feats, model.nc, strides)  # noqa: E731

        steps_per_epoch = max(len(train_loader), 1)
        self.schedule = cosine_epoch_schedule(config.lr, config.epochs, steps_per_epoch,
                                              config.warmup_epochs)
        tx = make_optimizer(self.schedule, config.weight_decay, config.clip_norm)
        # the JAX Trainer draws one batch for its init shape, which moves the
        # loader's epoch counter; drawn here too, so the shuffles line up
        draw = iter(train_loader)
        next(draw)
        draw.close()
        # the state first, then the overlay (the JAX order): the EMA starts
        # from the init, the live parameters from the pretrained weights
        self.state = create_train_state(model, tx, use_ema=config.use_ema)
        if config.pretrained:
            self._apply_pretrained(config.pretrained)
        if mesh is not None:
            replicate(state_tensors(self.state), mesh)
        self._train_step = self._build_step(loss_fn)
        # built at the phase change, so a run that never reaches it pays nothing
        self._train_step_final = None
        if config.device_matching:
            from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS

            self._match_thresholds = DEFAULT_THRESHOLDS
        else:
            self._match_thresholds = None
        self._eval_step = make_eval_step(
            model, self.loss_cfg, conf_threshold=config.val_conf,
            iou_threshold=config.nms_iou, max_det=config.max_det,
            pre_nms_topk=config.pre_nms_topk, use_ema=config.eval_with_ema,
            loss_fn=eval_loss_fn, decode_fn=decode_fn,
            match_thresholds=self._match_thresholds,
            matmul_precision=config.val_matmul_precision, mesh=mesh)

        # checkpoint writes run in the background, overlapping the next epoch
        self.ckpt = CheckpointManager(config.save_dir, mesh) if config.save_dir else None
        self.logger = None
        if config.save_dir and self.is_writer:
            from yolo_scratch_tpu_torch.utils.logging import JsonlWriter, MetricsLogger

            self.logger = MetricsLogger(
                [JsonlWriter(str(Path(config.save_dir) / "metrics.jsonl"))])
        self.best_loss = float("inf")
        self.best_map50 = 0.0
        self.start_epoch = 0
        # early-stopping state; persisted in the meta json, restored by resume()
        self.since_improve = 0
        self.patience_best = -float("inf")

    def _build_step(self, loss_fn):
        cfg = self.cfg
        return build_train_step_custom(
            self.model, loss_fn, compute_dtype=torch.bfloat16 if cfg.mixed_precision else None,
            remat=cfg.remat, grad_accum=cfg.grad_accum,
            matmul_precision=cfg.train_matmul_precision, mesh=self.mesh, bn_mode=cfg.bn_mode)

    def _say(self, msg: str) -> None:
        if self.is_writer:
            print(msg)

    def _apply_pretrained(self, path: str) -> None:
        """Overlay pretrained weights onto the state's live model (the
        reference's strict=False partial load), in place, leaving the EMA
        and the optimizer state as created: a checkpoint dir of the port or
        of the JAX package (best, else last) or a reference ``.pt`` file."""
        from yolo_scratch_tpu_torch.utils.weights import merge_pretrained, reference_state_dict

        p = Path(path)
        if p.is_dir():
            mgr = CheckpointManager(str(p))
            raw = mgr.load_raw("best") or mgr.load_raw("last")
            if raw is None:
                raise FileNotFoundError(f"no checkpoint under {p}")
            loaded = raw["model"]
        else:
            loaded = reference_state_dict(p)
        init = self.model.state_dict()
        merged, skipped = merge_pretrained(init, loaded)
        self.model.load_state_dict(merged)
        names = {n for n, _ in self.model.named_parameters()}
        skipped_p = [k for k in skipped if k in names]
        total = len(names)
        self._say(f"pretrained: loaded {path} ({total - len(skipped_p)}/{total} parameters; "
                  f"{len(skipped)} kept init: {', '.join(skipped[:4])}"
                  f"{'...' if len(skipped) > 4 else ''})"
                  if skipped else f"pretrained: loaded {path} (all {total} parameters)")

    # ------------------------------------------------------------------

    def resume(self) -> bool:
        if self.ckpt is None:
            return False
        barrier(self.mesh)  # every rank reads what rank 0 wrote
        self.state, self.start_epoch, self.best_loss, self.best_map50 = self.ckpt.try_resume(
            self.state)
        if self.start_epoch > 0:
            pat = (self.ckpt.load_meta("last") or {}).get("patience")
            if pat is not None:
                self.since_improve = int(pat["since_improve"])
                # null = no val fitness before the save: the fresh-run sentinel
                self.patience_best = (-float("inf") if pat["best"] is None
                                      else float(pat["best"]))
        return self.start_epoch > 0

    def _in_final_phase(self, epoch: int) -> bool:
        """The last ``final_epochs`` epochs: augmentation off (and the L1
        loss on for YOLOX), the YOLOX paper's no-aug end phase."""
        return self.cfg.final_epochs > 0 and epoch >= self.cfg.epochs - self.cfg.final_epochs

    def _place(self, batch, augmented: bool):
        """(batch, rows) for the train step: without a mesh the batch as it
        is. On a mesh, unaugmented, this rank's rows of the global batch
        (a process-local batch is those rows already). Augmented, the global
        batch (gathered on the device from every process when each loads
        its own rows) and the slice of this rank's rows, to take after the
        augmentation."""
        mesh = self.mesh
        if mesh is None:
            return batch, None
        if not augmented:
            return shard_batch(batch, mesh), None
        if mesh.process_local:
            local = batch_to_device(batch, mesh.device)
            batch = {k: all_gather_cat(v, mesh.group, mesh.size) for k, v in local.items()}
        b = len(batch["img"]) // mesh.size
        return batch, slice(mesh.rank * b, (mesh.rank + 1) * b)

    def augmenter(self, epoch: int, batch_index: int):
        """The device-batch augmentation of one train batch, or None (no
        ``augment`` config, or the final phase)."""
        cfg = self.cfg.augment
        if cfg is None or self._in_final_phase(epoch):
            return None
        return lambda b: augment_batch(
            b, batch_generator(self.aug_seed, epoch, batch_index, b["img"].device), cfg)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.perf_counter()
        images = 0
        step_fn = self._train_step
        if self._in_final_phase(epoch) and self._loss_fn_final is not None:
            if self._train_step_final is None:
                self._train_step_final = self._build_step(self._loss_fn_final)
            step_fn = self._train_step_final
        collected = []  # device tensors; fetched once at epoch end (no per-step sync)
        for bi, batch in enumerate(self.train_loader):
            images += len(batch["img"]) * (self.mesh.size if self.mesh is not None
                                           and self.mesh.process_local else 1)
            augment = self.augmenter(epoch, bi)
            batch, rows = self._place(batch, augment is not None)
            self.state, metrics = (
                step_fn(self.state, batch, augment=augment) if rows is None
                else step_fn(self.state, batch, augment=augment, rows=rows))
            collected.append(metrics)
        out: Dict[str, float] = {}
        if collected:
            keys = sorted(collected[0])  # the JAX package's order: jit returns dicts sorted
            stacked = torch.stack([torch.stack([m[k] for m in collected]) for k in keys])
            vals = stacked.cpu().numpy().mean(axis=1)
            out = {k: float(v) for k, v in zip(keys, vals)}
        dt = time.perf_counter() - t0
        out["imgs_per_sec"] = images / dt if dt > 0 else 0.0
        out["epoch_time_s"] = dt
        return out

    def validate(self) -> Dict[str, float]:
        if self.val_loader is None:
            return {}
        n = 0
        all_preds, all_targets = [], []                # host-matching path
        all_marks, all_scores, all_valid = [], [], []  # device-matching path
        n_gt = 0
        metric_accum = []  # device scalar dicts, fetched stacked at the end
        # per batch, this rank's rows: (marks, scores, valid, sample_valid,
        # gt_mask) with device matching, else (boxes, scores, labels, valid,
        # sample_valid, gt_labels, gt_bboxes, gt_mask)
        deferred = []
        mesh = self.mesh

        def fetch(items):
            """Per-batch tensors or arrays -> (batches, B, ...) numpy; on a
            mesh every rank's rows, in rank order, on every rank."""
            x = torch.stack([torch.as_tensor(t) for t in items])
            if mesh is not None:
                x = all_gather_cat(x.to(mesh.device), mesh.group, mesh.size, dim=1)
            return x.cpu().numpy()

        def flush_deferred():
            """Stacked fetch of the deferred batches, one transfer per kind."""
            nonlocal n_gt
            if not deferred:
                return
            cols = [fetch([d[i] for d in deferred]) for i in range(len(deferred[0]))]
            for i in range(len(deferred)):
                # score each val image once: drop the loader's wrap-padding duplicates
                if self._match_thresholds is not None:
                    marks, scores, valid, sv, gt_mask = (c[i] for c in cols)
                    sv = sv.astype(bool)
                    all_marks.append(marks[sv])
                    all_scores.append(scores[sv])
                    all_valid.append(valid[sv])
                    n_gt += int(gt_mask[sv].sum())
                else:
                    boxes, scores, labels, valid, sv, gt_labels, gt_bboxes, gt_mask = (
                        c[i] for c in cols)
                    preds = detections_to_lists(boxes, scores, labels, valid)
                    targets = targets_to_lists(gt_labels, gt_bboxes, gt_mask)
                    all_preds.extend(p for p, ok in zip(preds, sv) if ok)
                    all_targets.extend(t for t, ok in zip(targets, sv) if ok)
            deferred.clear()

        for batch in self.val_loader:
            if self.cfg.max_val_batches is not None and n >= self.cfg.max_val_batches:
                break
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            out_step = self._eval_step(batch, self.state)
            metrics, (boxes, scores, labels, valid) = out_step[0], out_step[1]
            metric_accum.append(metrics)
            sv = np.asarray(batch.get("sample_valid", np.ones(len(batch["img"]), bool)))
            if self._match_thresholds is not None:
                deferred.append((out_step[2], scores, valid, sv, batch["gt_mask"]))
            else:
                deferred.append((boxes, scores, labels, valid, sv, batch["gt_labels"],
                                 batch["gt_bboxes"], batch["gt_mask"]))
            if len(deferred) >= max(self.cfg.val_fetch_chunk, 1):
                flush_deferred()
            n += 1
        flush_deferred()
        loss_sums: Dict[str, float] = {}
        if metric_accum:
            keys = sorted(metric_accum[0])  # the JAX package's order, as in train_epoch
            stacked = torch.stack([torch.stack([m[k] for m in metric_accum]) for k in keys])
            vals = stacked.cpu().numpy().sum(axis=1)
            loss_sums = {k: float(v) for k, v in zip(keys, vals)}
        out = {k: v / max(n, 1) for k, v in loss_sums.items()}
        if self._match_thresholds is not None:
            if all_marks:
                out.update(metrics_from_marks(
                    np.concatenate(all_marks), np.concatenate(all_scores),
                    np.concatenate(all_valid), n_gt))
            else:
                out.update({"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0})
        else:
            out.update(evaluate_detections(all_preds, all_targets,
                                           conf_threshold=self.cfg.val_conf, iou_threshold=0.5))
        if out.get("prefilter_saturated", 0.0) > 0:
            # the cap dropped real candidates on some images: the mAP is an
            # under-estimate against an uncapped evaluator
            self._say(f"  ! prefilter cap (pre_nms_topk={self.cfg.pre_nms_topk}) "
                      f"bound on ~{out['prefilter_saturated']:.0%} of val images "
                      "— raise it for exact eval")
        return out

    def fit(self, resume: bool = True) -> Dict[str, Any]:
        """Train from the start (or, with ``resume``, from the checkpoint's
        next epoch). The last background checkpoint write has landed when
        this returns or raises."""
        try:
            return self._fit(resume)
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()

    def _fit(self, resume: bool) -> Dict[str, Any]:
        # fresh-run defaults first: a reused Trainer must not carry a stale
        # plateau clock, best-so-far gates or start epoch into this run;
        # resume() then restores the persisted values
        self.best_loss = float("inf")
        self.best_map50 = 0.0
        self.start_epoch = 0
        self.since_improve = 0
        self.patience_best = -float("inf")
        if resume:
            self.resume()
        history = []
        for epoch in range(self.start_epoch, self.cfg.epochs):
            lr = float(self.schedule(epoch * max(len(self.train_loader), 1)))
            if self._in_final_phase(epoch) and not self._in_final_phase(epoch - 1):
                extra = " + L1 loss on" if self._loss_fn_final is not None else ""
                self._say(f"--> final phase: augmentation off{extra} (last "
                          f"{self.cfg.final_epochs} epochs)")
            train_metrics = self.train_epoch(epoch)
            val_metrics = self.validate()

            # v8: box/cls/dfl; YOLOX: iou/obj/cls/l1
            parts = " ".join(f"{label} {train_metrics[key]:.4f}"
                             for label, key in (("box", "box_loss"), ("iou", "iou_loss"),
                                                ("obj", "obj_loss"), ("cls", "cls_loss"),
                                                ("dfl", "dfl_loss"), ("l1", "l1_loss"))
                             if key in train_metrics)
            self._say(f"Epoch {epoch + 1}/{self.cfg.epochs} | lr {lr:.6f} | "
                      f"train loss {train_metrics.get('loss', float('nan')):.4f} ({parts}) | "
                      f"{train_metrics.get('imgs_per_sec', 0):.1f} img/s")
            if val_metrics:
                self._say(f"  val loss {val_metrics.get('loss', float('nan')):.4f} | "
                          f"P {val_metrics.get('precision', 0):.4f} "
                          f"R {val_metrics.get('recall', 0):.4f} "
                          f"mAP50 {val_metrics.get('mAP50', 0):.4f} "
                          f"mAP50-95 {val_metrics.get('mAP50-95', 0):.4f}")

            if self.logger is not None:
                self.logger.log(epoch, lr=lr,
                                **{f"train/{k}": v for k, v in train_metrics.items()},
                                **{f"val/{k}": v for k, v in val_metrics.items()})
            # the early-stopping counters move BEFORE the save, so a relaunch
            # stops at the same epoch as an uninterrupted run
            if self.cfg.patience > 0 and val_metrics:
                fitness = val_metrics.get("mAP50", -val_metrics.get("loss", float("inf")))
                if fitness >= self.patience_best:  # a plateau refreshes the clock
                    self.patience_best, self.since_improve = fitness, 0
                else:
                    self.since_improve += 1
            if self.ckpt is not None:
                extra = None
                if self.cfg.patience > 0:
                    # -inf (no val fitness yet) lands as null in the meta json
                    extra = {"patience": {"since_improve": self.since_improve,
                                          "best": self.patience_best}}
                self.best_loss, self.best_map50, saved = self.ckpt.save_epoch(
                    self.state, epoch, train_metrics, val_metrics,
                    self.best_loss, self.best_map50, extra_meta=extra)
                if saved:
                    self._say(f"  ✓ saved best (mAP50 {self.best_map50:.4f})")
            history.append({"epoch": epoch, "train": train_metrics, "val": val_metrics})
            if self.cfg.patience > 0 and self.since_improve >= self.cfg.patience:
                self._say(f"--> early stop at epoch {epoch + 1}: val fitness below its best "
                          f"({self.patience_best:.4f}) for {self.cfg.patience} epochs")
                break
        return {"history": history, "best_mAP50": self.best_map50,
                "best_loss": self.best_loss}
