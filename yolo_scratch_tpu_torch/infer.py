"""Batched streaming inference, the deploy path (port of ``infer.py``).

Pipeline: host decode + letterbox (``host.py``: the native C++ library,
``csrc/yst_host.cpp``, or cv2 where it does not build) -> image batch to the
device -> BN-folded bf16 forward (cuDNN) -> decode ->
greedy NMS on the hand-written CUDA kernel -> (B, max_det, 7) packed
detections -> boxes mapped back to original-image pixels. The decode follows
the family: YOLO11 (DFL head) takes the fused select-then-decode, YOLOX
``yolox_eval_decode`` in f32 and the common ``postprocess``. Device work is
asynchronous, so host prep of the next batches overlaps it
(``PredictorConfig.inflight``).

An int8 model (``nn/quant.py::quantize_for_deploy``) serves through the
same Predictor: its quantized blocks run ``ops/int8_conv.py``.

A host batch (numpy or a CPU tensor) reaches a card without a host wait:
``PinnedRing`` copies it into one of ``inflight + 1`` pinned buffers and
enqueues the copy on a side stream, so the host never waits for the stream
and the copy runs beside the device work queued before it. A batch already
on the device, a CPU Predictor and ``shard_over``'s replicas take a plain
``.to(device)``.

Under a profiler a batch records the spans ``yst.h2d``, ``yst.normalize``,
``yst.model``, then ``ops/decode.py``'s ``yst.select``, ``yst.nms`` and
``yst.pack``, and ``yst.pack`` again around ``pack_detections``
(``utils/profiling.py`` lists them with the metrics that read them).

``Predictor.shard_over(mesh)`` serves batch-parallel over the devices of a
one-process mesh (``parallel/mesh.py``): one replica a device, each running
the whole per-image program on its contiguous rows, the outputs gathered in
order on the first device.

CLI: ``python -m yolo_scratch_tpu_torch.infer --images <dir> [--weights
state_dict.pt | --ckpt <dir> [--which best|last] | --torch-ckpt ref.pt]
[--model auto|yolo11|yolox] [--int8-calib N] [--blocked-topk N] [--save-viz
DIR [--names FILE]] --out preds.json``. Runs on ``cuda`` unless ``--device
cpu``.

A ``--ckpt`` directory may also be a run directory of the JAX package: its
orbax (OCDBT, zarr v2, zstd) or npz checkpoints are read by the port's own
code (``train/jax_checkpoints.py``), with nothing of JAX or orbax installed.
"""

from __future__ import annotations

import copy
import json
import threading
import time
from pathlib import Path
from typing import List, Sequence

import torch

from yolo_scratch_tpu_torch.host import HostPredictor, PredictorConfig, pack_detections
from yolo_scratch_tpu_torch.models.builder import CONFIGS, YOLOModel, build_yolo11, dims_from_params
from yolo_scratch_tpu_torch.models.yolox import (
    SCALES as YOLOX_SCALES,
    YOLOXModel,
    build_yolox,
    scale_name,
    yolox_arch_from_params,
    yolox_eval_decode,
)
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.nn.quant import (
    cast_for_deploy,
    count_quantized,
    prepare_calib_batches,
    quantize_for_deploy,
)
from yolo_scratch_tpu_torch.ops.decode import postprocess, postprocess_from_feats
from yolo_scratch_tpu_torch.utils.device import resolve_device
from yolo_scratch_tpu_torch.utils.profiling import annotate, count


class PinnedRing:
    """Host batches to one card with no stream sync: ``slots`` pinned host
    buffers used in turn (allocated at the first batch and again only when
    the shape or dtype changes), each copied on one side stream.

    A batch waits for its slot's previous copy (counted as
    ``h2d.slot_waits``; with more slots than batches in flight it has
    ended), is copied into the slot on the host, so the caller may reuse its
    array at once, and is enqueued as a non-blocking copy into a fresh
    device tensor on the side stream; the current stream waits on the
    copy's event. The device tensor is allocated on the side stream and
    marked used by the current one (``record_stream``), so the caching
    allocator hands its block out again only after the reader's work. A
    lock keeps threads that share a Predictor off each other's slots."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.done = [torch.cuda.Event() for _ in range(slots)]
        self.bufs: List[torch.Tensor] = []
        self.next = 0
        self.lock = threading.Lock()

    def put(self, src: torch.Tensor) -> torch.Tensor:
        """``src`` (host) -> the same values on the card, ordered before the
        current stream's next work."""
        with self.lock:
            if (not self.bufs or self.bufs[0].shape != src.shape
                    or self.bufs[0].dtype != src.dtype):
                # normal tensors, so a caller outside inference mode may write them
                with torch.inference_mode(False):
                    self.bufs = [torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                                 for _ in self.done]
            i, self.next = self.next, (self.next + 1) % len(self.done)
            done = self.done[i]
            if not done.query():
                count("h2d.slot_waits", 1)
                done.synchronize()
            self.bufs[i].copy_(src)
            with torch.cuda.stream(self.stream):
                dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dst.copy_(self.bufs[i], non_blocking=True)
                done.record(self.stream)
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            dst.record_stream(current)
        count("h2d.staged", 1)
        return dst


class Predictor(HostPredictor):
    """Batched streaming predictor over a YOLO11 (builder) or YOLOX model.
    The model is copied, BN-folded (``fuse_bn``), cast (``bf16``; the int8
    scales of a quantized model stay f32) and moved to ``device`` (default
    ``cuda``; raises if there is no GPU)."""

    def __init__(self, model: YOLOModel | YOLOXModel, config: PredictorConfig = PredictorConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = config
        model = fuse_conv_bn(model) if config.fuse_bn else copy.deepcopy(model)
        self.dtype = torch.bfloat16 if config.bf16 else torch.float32
        model = cast_for_deploy(model, self.device, self.dtype).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        # family dispatch: the YOLO11 builder family has a DFL head (reg_max)
        self.is_dfl = hasattr(model, "reg_max")
        # YOLOX reads its input channels off the stem (host prep decodes
        # gray or RGB by it)
        self.in_ch = (model.in_ch if self.is_dfl
                      else yolox_arch_from_params(model.state_dict())[0])
        self.replicas: List["Predictor"] | None = None  # set by shard_over
        self._ring = (PinnedRing(self.device, max(1, config.inflight) + 1)
                      if self.device.type == "cuda" else None)

    def shard_over(self, mesh) -> "Predictor":
        """Batch-parallel serving over ``mesh.devices`` (in place; returns
        self): one replica of the folded, cast model on each device (two
        replicas may share a card), the batch split contiguously, each
        shard's whole program (forward, decode, NMS kernel #1) on its
        device with no collective, the outputs concatenated in order on
        the first device. ``batch_size`` must divide by the mesh size."""
        if mesh.group is not None:
            raise ValueError("shard_over takes a one-process mesh (parallel/mesh.py::make_mesh "
                             "or Mesh(devices)), not a distributed one")
        n = mesh.size
        if self.cfg.batch_size % n:
            raise ValueError(f"batch_size {self.cfg.batch_size} not divisible by mesh size {n}")
        replicas = []
        for dev in mesh.devices:
            r = copy.copy(self)
            r.device = torch.device(dev)
            r.model = copy.deepcopy(self.model).to(r.device)
            r._ring = None
            replicas.append(r)
        self.replicas, self.device, self.model = replicas, replicas[0].device, replicas[0].model
        self._ring = None
        return self

    # The device program, in pieces that hold no host sync and no branch on
    # a value, so that torch.export traces it whole (export.py).

    def _forward(self, imgs) -> List[torch.Tensor]:
        with annotate("yst.h2d"):
            x = torch.as_tensor(imgs)
            x = (self._ring.put(x) if self._ring is not None and x.device.type == "cpu"
                 else x.to(self.device))
        with annotate("yst.normalize"):
            xx = x.to(self.dtype)
            if x.dtype == torch.uint8:
                xx = xx / 255.0
        with annotate("yst.model"):
            return self.model(xx)

    def _postprocess(self, feats: Sequence[torch.Tensor]):
        cfg, m = self.cfg, self.model
        common = dict(img_size=cfg.img_size, conf_threshold=cfg.conf_threshold,
                      iou_threshold=cfg.iou_threshold, max_det=cfg.max_det,
                      pre_nms_topk=cfg.pre_nms_topk, class_aware=cfg.class_aware_nms,
                      nms_impl=cfg.nms_impl)
        if self.is_dfl:
            return postprocess_from_feats(feats, nc=m.nc, strides=m.strides,
                                          reg_max=m.reg_max, blocked_topk=cfg.blocked_topk,
                                          **common)
        # YOLOX decodes in f32: bf16 box coordinates quantise to ~2.5 px at
        # 640 (exp(wh) * stride is the sensitive part)
        with annotate("yst.select"):
            decoded = yolox_eval_decode([f.float() for f in feats], m.nc, m.strides)
        return postprocess(decoded, **common)

    def _infer(self, imgs):
        """(B, S, S, C) images -> (boxes (B, max_det, 4) normalised xyxy f32,
        scores f32, labels int32, valid bool), the exported program's
        outputs."""
        if self.replicas is None:
            return self._postprocess(self._forward(imgs))
        x = torch.as_tensor(imgs)
        n = len(self.replicas)
        if len(x) % n:
            raise ValueError(f"batch {len(x)} not divisible by mesh size {n}")
        parts = [r._infer(shard) for r, shard in zip(self.replicas, x.chunk(n))]
        with annotate("yst.pack"):
            return tuple(torch.cat([p[i].to(self.device) for p in parts]) for i in range(4))

    @torch.inference_mode()
    def forward_feats(self, imgs) -> List[torch.Tensor]:
        """(B, S, S, C) uint8 (or float in [0, 1]) -> raw NHWC Detect maps
        in the working dtype."""
        return self._forward(imgs)

    @torch.inference_mode()
    def postprocess_feats(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Raw head maps -> (B, max_det, 7) packed detections."""
        dets = self._postprocess(feats)
        with annotate("yst.pack"):
            return pack_detections(*dets)

    @torch.inference_mode()
    def predict_batch(self, imgs) -> torch.Tensor:
        """(B, S, S, C) images -> (B, max_det, 7) packed detections on the
        device (asynchronous: the caller's fetch synchronises)."""
        dets = self._infer(imgs)
        with annotate("yst.pack"):
            return pack_detections(*dets)


def load_deploy_model(
    cfg_path: str | Path = CONFIGS / "yolo11_crater.json",
    scale: str = "n",
    weights: str | Path | None = None,
    ch: int | None = None,
    nc: int | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
    model_kind: str = "auto",
    ckpt: str | Path | None = None,
    which: str = "best",
    torch_ckpt: str | Path | None = None,
) -> YOLOModel | YOLOXModel:
    """Build the model a deploy CLI serves, from the first source given of:

    * ``torch_ckpt``: a reference-layout ``.pt`` (``utils/weights.py``);
      always YOLO11, as the reference has no YOLOX;
    * ``ckpt``: a checkpoint directory of the port's trainer or of the JAX
      package's (``train/checkpoints.py``), its ``which`` ("best" or "last")
      checkpoint. It serves the raw weights and BN buffers, not the EMA,
      as the JAX CLIs do, and a model that does not fit the checkpoint
      (a forced ``--nc``/``--ch``) raises a ``ValueError`` naming it;
    * ``weights``: a port ``state_dict`` file;
    * else a seeded init.

    ch/nc are read off the weights unless given (explicit values win).
    ``model_kind="auto"`` reads the family off them too (a ``backbone.`` key
    means YOLOX, whose depth and width are read off as well;
    ``yolox_arch_from_params``) and is YOLO11 without weights. The defaults
    are the crater model's 1/5 for YOLO11 and COCO's 3/80 for YOLOX
    (``scale`` "n" means nano there)."""
    from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager, check_checkpoint
    from yolo_scratch_tpu_torch.utils.weights import (
        load_reference_checkpoint,
        reference_state_dict,
    )

    dev = resolve_device(device)
    state = tree = None
    if torch_ckpt:
        model_kind = "yolo11"
        state = reference_state_dict(torch_ckpt)
    elif ckpt:
        mgr = CheckpointManager(str(ckpt))
        tree = mgr.load_raw(which) if mgr.load_meta(which) is not None else None
        if tree is None:
            raise FileNotFoundError(f"no checkpoint '{which}' under {ckpt}")
        state = tree["model"]
    elif weights:
        state = torch.load(weights, map_location="cpu", weights_only=True)
    if state is not None and model_kind == "auto":
        model_kind = "yolox" if any(k.startswith("backbone.") for k in state) else "yolo11"
    if model_kind == "yolox":
        if state is not None:
            d_ch, d_nc, depth, width = yolox_arch_from_params(state)
            model = build_yolox(nc=nc or d_nc, ch=ch or d_ch, seed=seed, depth=depth,
                                width=width)
        else:
            yx = scale_name(scale)
            if yx not in YOLOX_SCALES:
                raise ValueError(f"unknown YOLOX scale {scale!r}; choose from "
                                 f"{sorted(YOLOX_SCALES)} (or 'n' for nano)")
            model = build_yolox(yx, nc=nc or 80, ch=ch or 3, seed=seed)
    else:
        if state is not None:
            d_ch, d_nc = dims_from_params(state)
            ch, nc = ch or d_ch, nc or d_nc
        model = build_yolo11(cfg_path, ch=ch or 1, nc=nc or 5, scale=scale, seed=seed)
    if tree is not None:
        check_checkpoint(tree, model, which, ema=False)
    if torch_ckpt:
        load_reference_checkpoint(model, torch_ckpt, state)
    elif state is not None:
        model.load_state_dict(state)
    return model.to(dev)


def add_source_args(p) -> None:
    """The deploy CLIs' weight sources (:func:`load_deploy_model`)."""
    p.add_argument("--weights", type=str, default=None,
                   help="port state_dict (.pt); default: seeded init")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir of the port's or the JAX package's trainer (its raw "
                        "weights, not the EMA)")
    p.add_argument("--which", type=str, default="best", choices=["best", "last"])
    p.add_argument("--torch-ckpt", type=str, default=None, help="reference .pt checkpoint")


def load_from_args(args):
    """:func:`load_deploy_model` on a deploy CLI's parsed arguments."""
    return load_deploy_model(args.cfg, scale=args.scale, weights=args.weights, ch=args.ch,
                             nc=args.nc, seed=args.seed, device=args.device,
                             model_kind=args.model, ckpt=args.ckpt, which=args.which,
                             torch_ckpt=args.torch_ckpt)


def quantize_from_paths(model, cfg: PredictorConfig, paths: Sequence[str], max_batches: int,
                        device: str | torch.device | None = None):
    """The int8 model of the deploy CLIs: calibrate on the first
    ``max_batches`` batches of ``paths``, host-prepped as the Predictor
    serves them, and quantize every ``ConvBNAct``."""
    batches = prepare_calib_batches(Predictor(model, cfg, device=device), paths, max_batches)
    model = quantize_for_deploy(model, batches)
    print(f"int8: quantized {count_quantized(model)} conv blocks "
          f"(calibrated on {len(batches)} batches)")
    return model


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Batched streaming inference (PyTorch/CUDA)")
    p.add_argument("--images", type=str, required=True, help="image dir or file")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    add_source_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--out", type=str, default=None, help="write JSON here")
    p.add_argument("--stretch", action="store_true", help="stretch-resize (reference semantics)")
    p.add_argument("--nc", type=int, default=None, help="class count (default: from weights)")
    p.add_argument("--ch", type=int, default=None, help="input channels (default: from weights)")
    p.add_argument("--model", type=str, default="auto", choices=["auto", "yolo11", "yolox"],
                   help="model family (default: read from the weights)")
    p.add_argument("--class-aware", action="store_true", help="class-aware NMS")
    p.add_argument("--topk", type=int, default=PredictorConfig.pre_nms_topk,
                   help="prefilter cap (pre_nms_topk): the NMS sweep length")
    p.add_argument("--blocked-topk", type=int, default=0,
                   help="opt-in two-stage candidate selection: the top N of each 128-anchor "
                        "block, then the exact top-k of those (YOLO11); 0 = exact (default)")
    p.add_argument("--int8-calib", type=int, default=0, metavar="N",
                   help="serve int8 (nn/quant.py): calibrate activation scales on the first "
                        "N input batches, then quantize every ConvBNAct (0 = off)")
    p.add_argument("--save-viz", type=str, default=None, metavar="DIR",
                   help="write annotated PNGs (class-coloured boxes + scores on the original "
                        "images) to DIR")
    p.add_argument("--names", type=str, default=None,
                   help="class-name file for --save-viz: one name per line, a JSON array, or "
                        "a COCO annotations json")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)

    root = Path(args.images)
    exts = {".png", ".jpg", ".jpeg", ".bmp"}
    paths = ([str(root)] if root.is_file()
             else sorted(str(q) for q in root.rglob("*") if q.suffix.lower() in exts))
    if not paths:
        raise SystemExit(f"no images under {root}")

    model = load_from_args(args)
    cfg = PredictorConfig(
        img_size=args.imgsz, batch_size=args.batch, conf_threshold=args.conf,
        iou_threshold=args.iou, letterbox=not args.stretch,
        class_aware_nms=args.class_aware, pre_nms_topk=args.topk,
        blocked_topk=args.blocked_topk)
    if args.int8_calib:
        model = quantize_from_paths(model, cfg, paths, args.int8_calib, args.device)
    predictor = Predictor(model, cfg, device=args.device)

    t0 = time.perf_counter()
    results = list(predictor.predict_paths(paths))
    dt = time.perf_counter() - t0
    print(f"{len(paths)} images in {dt:.2f}s ({len(paths) / dt:.1f} img/s) on {predictor.device}")
    if args.save_viz:
        from yolo_scratch_tpu_torch.utils.viz import load_class_names, save_annotated

        written = save_annotated(results, args.save_viz,
                                 class_names=load_class_names(args.names))
        print(f"wrote {len(written)} annotated images to {args.save_viz}")
    elif args.names:
        print("warning: --names only labels --save-viz renderings; the JSON output keeps "
              "integer labels. Pass --save-viz DIR to use it.")
    if args.out:
        Path(args.out).write_text(json.dumps(results))
        print(f"wrote {args.out}")
    else:
        for r in results[:5]:
            print(r["path"], len(r["scores"]), "detections")
    return results


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
