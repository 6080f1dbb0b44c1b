"""Ahead-of-time export of the deploy program: ``torch.export`` serving
artifacts (port of ``export.py``).

``export_predictor`` traces the Predictor's device program (image batch ->
forward -> decode -> NMS) with the weights baked in and returns an
``ExportedProgram``; ``save_artifact`` / ``load_artifact`` round-trip it
through ``torch.export.save`` / ``load`` as a ``.pt2`` file. The NMS is the
``yst::nms_sweep_batched`` custom op (``ops/nms_kernels.py``), so on the
card the artifact launches kernel #1 as the live Predictor does; loading one
imports that op registration and nothing of the model or builder code.

The artifact is a serialized program that the PyTorch runtime runs, as a
JAX artifact is; it is not compiled further (AOTInductor would generate
kernels in place of the graph's ops). It keeps the device it was exported
on, as a JAX artifact keeps its platform, and its batch is fixed: callers
pad the tail batch (``predict_paths`` does).

CLI: ``python -m yolo_scratch_tpu_torch.export --weights w.pt --out
model.pt2 --check`` (or ``--ckpt <dir> [--which best|last]``, or
``--torch-ckpt ref.pt``; ``--device cpu`` to export for the CPU).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
from torch import nn

from yolo_scratch_tpu_torch.host import HostPredictor, PredictorConfig, pack_detections

ARTIFACT_SUFFIX = ".pt2"


class _Program(nn.Module):
    """The Predictor's device program as a module, for ``torch.export``:
    its model is a submodule, so the weights become the program's state."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.model
        self.predictor = predictor

    def forward(self, x):
        return self.predictor._infer(x)


def export_predictor(predictor, batch_size: Optional[int] = None):
    """Export a ``Predictor``'s device program as an ``ExportedProgram``.

    The program takes ONE argument, the image batch ``(B, S, S, ch)`` uint8
    (or f32 in [0, 1] with ``u8_transfer=False``) on the predictor's device,
    and returns ``(boxes (B, max_det, 4) f32, scores (B, max_det) f32,
    labels (B, max_det) int32, valid (B, max_det) bool)``, boxes normalised
    to [0, 1] model space (unmapping to pixels stays on the host)."""
    cfg = predictor.cfg
    B = batch_size or cfg.batch_size
    dtype = torch.uint8 if cfg.u8_transfer else torch.float32
    x = torch.zeros((B, cfg.img_size, cfg.img_size, predictor.in_ch), dtype=dtype,
                    device=predictor.device)
    with torch.no_grad():
        return torch.export.export(_Program(predictor), (x,), strict=False)


def _sidecar_path(path: str) -> str:
    return str(path) + ".meta.json"


def save_artifact(exported, path: str, host_prep: Optional[dict] = None) -> int:
    """Write ``exported`` to ``path``; returns the byte count. ``host_prep``
    (letterbox vs stretch, fast_jpeg: the host prep the program was built
    against) goes to a ``<path>.meta.json`` sidecar that
    :func:`load_host_prep` reads, so a server holding only the artifact
    reproduces it."""
    torch.export.save(exported, path)
    if host_prep is not None:
        with open(_sidecar_path(path), "w") as f:
            json.dump(host_prep, f, indent=2)
    return os.path.getsize(path)


def load_artifact(path: str):
    """Load a serving artifact (an ``ExportedProgram``; ``.module()`` runs
    it). Needs the ``yst`` op registration and no model code."""
    import yolo_scratch_tpu_torch.ops.int8_conv  # noqa: F401  (registers yst::int8_conv2d)
    import yolo_scratch_tpu_torch.ops.nms_kernels  # noqa: F401  (registers yst::nms_sweep*)

    return torch.export.load(path)


def load_host_prep(path: str) -> Optional[dict]:
    """The host-prep sidecar next to an artifact, or None where there is
    none (callers then assume the PredictorConfig defaults and say so)."""
    p = _sidecar_path(path)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _io_specs(exported):
    """(the image input's fake tensor, the four outputs' fake tensors)."""
    sig = exported.graph_signature
    vals = {n.name: n.meta["val"] for n in exported.graph.nodes if "val" in n.meta}
    (x,) = [vals[name] for name in sig.user_inputs]
    return x, [vals[name] for name in sig.user_outputs]


class ArtifactPredictor(HostPredictor):
    """The Predictor's host surface (``_prepare``, ``predict_batch``,
    ``predict_paths``) over a loaded artifact, with no model code in the
    process.

    Geometry (batch, image size, channels, input dtype, max_det) and device
    are read off the program's input and output specs and override the
    passed config; compute-side knobs were baked in at export and are inert
    here. ``config`` carries only host-side behaviour (letterbox, fast_jpeg,
    host_threads, inflight); the sidecar's ``host_prep`` wins over it. A
    uint8 program fed host prep's float32 / 255 (the cv2 tier) gets the
    exact uint8 back, ``round(x * 255)``."""

    def __init__(self, exported, config: Optional[PredictorConfig] = None,
                 host_prep: Optional[dict] = None):
        x, outs = _io_specs(exported)
        B, S, S2, ch = x.shape
        if S != S2:
            raise ValueError(f"non-square artifact input: {tuple(x.shape)}")
        base = config or PredictorConfig()
        if host_prep:
            base = replace(base, **{k: host_prep[k] for k in ("letterbox", "fast_jpeg")
                                    if k in host_prep})
        self.cfg = replace(base, img_size=int(S), batch_size=int(B),
                           u8_transfer=x.dtype == torch.uint8, max_det=int(outs[0].shape[1]))
        self.in_ch = int(ch)
        self.device = x.device
        self.input_dtype = x.dtype
        self.program = exported.module()

    def _infer(self, imgs):
        x = torch.as_tensor(imgs).to(self.device)
        if self.input_dtype == torch.uint8 and x.dtype != torch.uint8:
            x = (x * 255).round().to(torch.uint8)
        return self.program(x)

    @torch.inference_mode()
    def predict_batch(self, imgs) -> torch.Tensor:
        return pack_detections(*self._infer(imgs))


def main(argv=None):
    import argparse
    from pathlib import Path

    from yolo_scratch_tpu_torch.infer import (
        Predictor,
        add_source_args,
        load_from_args,
        quantize_from_paths,
    )
    from yolo_scratch_tpu_torch.models.builder import CONFIGS

    p = argparse.ArgumentParser(description="Export the deploy program to a torch.export "
                                            "artifact")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    add_source_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="auto", choices=["auto", "yolo11", "yolox"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--topk", type=int, default=PredictorConfig.pre_nms_topk,
                   help="prefilter cap (pre_nms_topk), baked into the artifact")
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--ch", type=int, default=None)
    p.add_argument("--class-aware", action="store_true")
    p.add_argument("--stretch", action="store_true",
                   help="export for stretch-resize host prep instead of letterbox (recorded "
                        "in the .meta.json sidecar and honoured by the serve CLI)")
    p.add_argument("--nms-impl", type=str, default="kernel", choices=["kernel", "pairwise"],
                   help="'kernel': the yst::nms_sweep_batched op (kernel #1 on the card)")
    p.add_argument("--out", type=str, required=True, help=f"artifact path ({ARTIFACT_SUFFIX})")
    p.add_argument("--check", action="store_true",
                   help="load the written artifact and run a zeros batch through it")
    p.add_argument("--int8-calib-dir", type=str, default=None, metavar="DIR",
                   help="export the int8 program (nn/quant.py): calibrate activation scales "
                        "on the images under DIR")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)

    model = load_from_args(args)
    cfg = PredictorConfig(
        img_size=args.imgsz, batch_size=args.batch, conf_threshold=args.conf,
        iou_threshold=args.iou, max_det=args.max_det, class_aware_nms=args.class_aware,
        nms_impl=args.nms_impl, pre_nms_topk=args.topk, letterbox=not args.stretch)
    if args.int8_calib_dir:
        exts = {".png", ".jpg", ".jpeg", ".bmp"}
        paths = sorted(str(q) for q in Path(args.int8_calib_dir).rglob("*")
                       if q.suffix.lower() in exts)
        if not paths:
            raise SystemExit(f"--int8-calib-dir: no images under {args.int8_calib_dir}")
        model = quantize_from_paths(model, cfg, paths, -(-len(paths) // args.batch),
                                    args.device)
    predictor = Predictor(model, cfg, device=args.device)
    t0 = time.perf_counter()
    exported = export_predictor(predictor)
    export_s = time.perf_counter() - t0
    # host-prep semantics (+ the baked compute knobs, informational)
    host_prep = {
        "letterbox": cfg.letterbox,
        "fast_jpeg": cfg.fast_jpeg,
        "baked": {"conf_threshold": cfg.conf_threshold, "iou_threshold": cfg.iou_threshold,
                  "class_aware_nms": cfg.class_aware_nms, "pre_nms_topk": cfg.pre_nms_topk,
                  "nms_impl": cfg.nms_impl},
    }
    nbytes = save_artifact(exported, args.out, host_prep=host_prep)
    x, outs = _io_specs(exported)
    print(f"wrote {args.out}: {nbytes / 1e6:.2f} MB in {export_s:.1f} s, device {x.device}, "
          f"in {tuple(x.shape)} {x.dtype}, out {len(outs)} tensors")

    if args.check:
        art = ArtifactPredictor(load_artifact(args.out))
        zeros = np.zeros((art.cfg.batch_size, art.cfg.img_size, art.cfg.img_size, art.in_ch),
                         np.uint8 if art.cfg.u8_transfer else np.float32)
        packed = art.predict_batch(zeros).cpu()
        print(f"check ok: packed {tuple(packed.shape)}, "
              f"{int(packed[..., 6].sum())} detections on zeros")
    return exported


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
