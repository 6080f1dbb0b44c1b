"""Per-block SQNR of the int8 PTQ tier (port of ``scripts/quant_sqnr.py``:
its flags, its worst-first rows on stderr and its JSON keys).

Runs one probe batch through the BN-folded f32 model and through its int8
variant (``nn/quant.py::quantize_for_deploy``, calibrated on the first
``--calib-batches`` batches of the loader), captures every ``ConvBNAct``
block's output with forward hooks, and reports each block's
signal-to-quantization-noise ratio

    SQNR = 10 log10( sum(y_f32^2) / sum((y_f32 - y_int8)^2) )  [dB]

sorted worst-first, the sums taken in float64 on the host. Blocks are named
by their module path (``model.2.cv1``; the JAX script's ``model_2/cv1``).
On the card the int8 blocks run ``yst::int8_conv2d``; the f32 model runs
with TF32 off. ~40 dB: visually lossless; <20 dB: suspect. The last line is
the JSON summary with a ``device`` block.

    python -m yolo_scratch_tpu_torch.quant_sqnr --data DIR --ckpt runs/t --which last \\
        --imgsz 320 [--quantile 0.999] [--cpu]

Runs on ``cuda`` unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yolo_scratch_tpu_torch.bench.common import device_block
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.nn.quant import conv_blocks, quantize_for_deploy
from yolo_scratch_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="per-block int8 SQNR (PyTorch/CUDA)")
    p.add_argument("--data", type=str, default="synthetic")
    p.add_argument("--dataset", type=str, default="auto")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--which", type=str, default="last", choices=["best", "last"])
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--quantile", type=float, default=None,
                   help="percentile activation calibration (e.g. 0.999); default absmax")
    p.add_argument("--worst", type=int, default=12, help="rows to print")
    p.add_argument("--cpu", action="store_true")
    return p


def block_outputs(model: torch.nn.Module, x: torch.Tensor) -> Dict[str, np.ndarray]:
    """Each ``ConvBNAct``'s output on ``x`` (eval mode, no autograd, TF32
    off), as float64 host arrays keyed by module path."""
    from yolo_scratch_tpu_torch.train.steps import precision_scope

    out: Dict[str, torch.Tensor] = {}
    hooks = [m.register_forward_hook(lambda _m, _i, y, name=name: out.__setitem__(name, y))
             for name, m in conv_blocks(model)]
    model.eval()
    try:
        with torch.no_grad(), precision_scope("highest"):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().cpu().double().numpy() for k, v in out.items()}


def sqnr_rows(model: torch.nn.Module, calib: Sequence[np.ndarray], probe: np.ndarray,
              quantile: Optional[float] = None) -> List[dict]:
    """``[{"block", "sqnr_db"}]`` of every ``ConvBNAct`` of ``model`` (on
    its device), worst first: the folded f32 model against its int8 variant
    calibrated on ``calib``, on the (B, S, S, C) batch ``probe`` in [0, 1]."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(probe, np.float32), device=dev)
    ys_f = block_outputs(fuse_conv_bn(model), x)
    ys_q = block_outputs(quantize_for_deploy(model, calib, quantile=quantile), x)
    rows = []
    for name, yf in ys_f.items():
        sig = float(np.sum(yf * yf))
        err = float(np.sum((yf - ys_q[name]) ** 2))
        sqnr = 10.0 * np.log10(sig / err) if err > 0 else float("inf")
        rows.append({"block": name, "sqnr_db": round(sqnr, 1)})
    rows.sort(key=lambda r: r["sqnr_db"])
    return rows


def summarise(rows: List[dict], quantile: Optional[float], worst: int) -> dict:
    """The JSON summary; the worst rows go to stderr."""
    mode = f"quantile={quantile}" if quantile else "absmax"
    print(f"calibration: {mode}; {len(rows)} ConvBNAct blocks; "
          f"worst {min(worst, len(rows))}:", file=sys.stderr)
    for r in rows[:worst]:
        print(f"  {r['sqnr_db']:7.1f} dB  {r['block']}", file=sys.stderr)
    return {
        "mode": mode,
        "blocks": len(rows),
        "sqnr_min_db": rows[0]["sqnr_db"] if rows else None,
        "sqnr_median_db": rows[len(rows) // 2]["sqnr_db"] if rows else None,
        "worst": rows[:worst],
    }


def main(argv=None) -> dict:
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.infer import load_deploy_model
    from yolo_scratch_tpu_torch.train.cli import make_datasets

    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    ds, _, _ = make_datasets(args)
    loader = Loader(ds, args.batch, prefetch=0)
    it = iter(loader)
    calib = [next(it)["img"] for _ in range(args.calib_batches)]
    probe = next(it)["img"]
    loader.close()
    model = load_deploy_model(args.cfg, scale=args.scale, ckpt=args.ckpt, which=args.which,
                              device=dev)
    summary = summarise(sqnr_rows(model, calib, probe, args.quantile), args.quantile,
                        args.worst)
    summary["device"] = device_block(dev)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
